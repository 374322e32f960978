"""The PyTorch port's benchmark: cells named in ``BENCHMARK.json``, run by
``portbench/run.py``.  Nothing here imports JAX or the JAX package."""
