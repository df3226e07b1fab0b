"""The benchmark of ``repro_torch`` (HEP-BNN on PyTorch and CUDA).

``run.py`` is the command; ``BENCHMARK.json`` at the repository root
names its cells.  Nothing here imports JAX or the JAX package.
"""
