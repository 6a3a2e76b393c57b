"""The benchmark of the PyTorch / CUDA port (``repro_torch``); see
``bench/README.md`` and ``BENCHMARK.json``."""
