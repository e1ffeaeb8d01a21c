"""A frozen copy of the port's step, frontend and loop detector (the
modules of gcslam_torch that they import, as the benchmark was defined),
with its imports rewritten to this package and its CUDA kernels replaced by
their plain PyTorch versions: ops/sinkhorn.py the plain Sinkhorn loop,
ops/eigh.py the plain 3 x 3 Jacobi chain and torch.linalg.eigh,
frontend/native.py the native corner stage in numpy, ops/collectives.py
the unsharded step only, utils/dtypes.py the float64 belief alone. The
generators under benchmark/gen/ use its frontend/synthetic.py and
frontend/bag_synth.py. A later change to gcslam_torch does not move it."""
