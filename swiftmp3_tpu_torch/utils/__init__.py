"""Utilities: WAV I/O for the command line and the tests (a verbatim copy of
`swiftmp3_tpu/utils/wav.py`), profiling helpers (`profiling`: the
throughput meter, torch.profiler traces and named spans), and the quality
measures (`quality`) and the ctypes bindings of libmpg123 and libmp3lame
(`external`), verbatim copies of the reference's."""

from .wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
