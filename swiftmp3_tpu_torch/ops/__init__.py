"""Numeric core of the port: the compat granule DSP as PyTorch functions on
tensors (`dsp`), the hand-written CUDA kernels with their plain PyTorch
versions (`kernels`), and the numpy golden implementation (`reference`, a
verbatim copy of the reference package's: the algorithmic spec the golden
backend runs, frame at a time)."""
