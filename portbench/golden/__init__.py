"""The plain reference the benchmark holds the port to: a frozen numpy copy
of the golden encoder (`encoder.GoldenBackend` and `EncoderSession` with
`ops.reference`, `options`, `tables` and `io`), with its imports pointing at
these copies. It imports numpy alone, never the port or JAX, and takes
nothing the port made: it is given the PCM the benchmark handed the port."""
