"""The benchmark of the PyTorch and CUDA port (nenbody_tpu_torch).

One cell runs once per call: python3 bench_port/run.py --workload NAME
--seed N --seconds S --trace 0|1. The cells, configurations and metrics
are listed in BENCHMARK.json at the root of the checkout; each piece of a
cell lives in a file of its own here, found by its name (lib/cells.py).
Nothing here imports jax, jaxlib, flax or the JAX package.
"""
