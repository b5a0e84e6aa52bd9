"""The benchmark of the PyTorch/CUDA port (`swiftmp3_tpu_torch`).

One run encodes one cell of `BENCHMARK.json` on the card:

    python3 -m portbench.run --workload compat128.corpus --seed 7 --seconds 30 --trace 0

A cell names a configuration (`configs/<name>.json`: the encoder options),
a traffic mix (`traffic/<name>.json`: the parameters of the load loop it
names, `loops/<name>.py`) and its metrics (`metrics/<name>.py`: one reader
a metric). Adding any of these is adding files and entries; no file here
needs an edit for it.

The yardstick lives here and nowhere else: the traffic, the audio made from
the seed, the reduction from spans, counters and the profiler's trace to
metrics (`tracing.py`, `readers.py`), the card's peaks and the kernels'
bounds (`bounds.py`), and the comparison that decides `correct`
(`check.py`) against a frozen numpy copy of the golden encoder
(`golden/`). From the port the benchmark takes only the system under test
(`encode_corpus`, `StreamPool`), its kernel names and the public methods it
wraps for spans. Nothing here imports JAX or the JAX package.
"""
