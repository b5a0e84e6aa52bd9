"""The encoder's chunk program ("model") in PyTorch: `pipeline.py`."""
