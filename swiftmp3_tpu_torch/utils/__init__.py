"""Utilities: WAV I/O for the command line and the tests (a verbatim copy of
`swiftmp3_tpu/utils/wav.py`), and profiling helpers (`profiling`: the
throughput meter, torch.profiler traces and named spans)."""

from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
