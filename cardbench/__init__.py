"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell a
run, driven by the files named in ``BENCHMARK.json`` (see ``run.py``)."""
