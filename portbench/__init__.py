"""The benchmark of ``rwrt_tpu_torch``, the PyTorch and CUDA port: one cell
of ``BENCHMARK.json`` run once by ``run.py``, its inputs made from a seed,
its results held against the plain reference in ``reference/``."""
