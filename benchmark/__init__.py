"""The benchmark of gcslam_torch (BENCHMARK.json at the repository's root):
run.py runs one cell once. It measures the program and takes nothing of the
JAX package."""
