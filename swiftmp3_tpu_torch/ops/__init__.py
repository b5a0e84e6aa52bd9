"""Device-side numeric core of the port: the compat granule DSP as PyTorch
functions on tensors (`dsp`) and the hand-written CUDA kernels with their
plain PyTorch versions (`kernels`)."""
