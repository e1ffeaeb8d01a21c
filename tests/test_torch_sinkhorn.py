"""The port's unbalanced Sinkhorn against the JAX package's: its plain
PyTorch loop against the XLA loop (association._sinkhorn_unbalanced) and
the Pallas kernel run interpreted (as tests/test_sinkhorn_pallas.py runs
it). The CUDA kernel is held against the plain loop on the card in
tests/test_torch_cuda.py.

Tolerances: float32 rtol 2e-5 / atol 1e-7 (the Pallas test's own: the
kernel and the loop sum in other orders); float64 rtol 1e-10. Zero-mass
rows must be exactly 0."""

import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.ops.association import _sinkhorn_unbalanced
from gcslam_tpu.ops.sinkhorn_pallas import sinkhorn_unbalanced_pallas
from gcslam_torch.ops import sinkhorn

ARGS = (0.05, 1.0, 1.0, 50)
TOL32 = dict(rtol=2e-5, atol=1e-7)
TOL64 = dict(rtol=1e-10, atol=1e-30)


def _case(N, K, seed, dtype=np.float32, B=None):
    """As tests/test_sinkhorn_pallas.py: costs in [0, 5), a third of the
    rows at zero mass, uniform column marginals."""
    rng = np.random.default_rng(seed)
    shape = (N,) if B is None else (B, N)
    C = rng.uniform(0.0, 5.0, size=shape + (K,)).astype(dtype)
    valid = rng.uniform(size=shape) > 0.33
    a = valid.astype(dtype)
    a = a / np.maximum(a.sum(-1, keepdims=True), 1e-9)
    b = np.full(shape[:-1] + (K,), 1.0 / K, dtype=dtype)
    return C, a, b, ~valid


SHAPES = [(128, 8), (257, 8), (1024, 8)]


@pytest.mark.parametrize("N,K", SHAPES)
def test_plain_matches_xla_loop_and_interpreted_pallas_f32(N, K):
    C, a, b, _ = _case(N, K, seed=N)
    ref = np.asarray(_sinkhorn_unbalanced(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), *ARGS))
    pal = np.asarray(sinkhorn_unbalanced_pallas(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), *ARGS,
                                                interpret=True))
    out = sinkhorn.sinkhorn_unbalanced_reference(torch.as_tensor(C), torch.as_tensor(a),
                                                 torch.as_tensor(b), *ARGS).numpy()
    np.testing.assert_allclose(out, ref, **TOL32)
    np.testing.assert_allclose(out, pal, **TOL32)


@pytest.mark.parametrize("N,K", SHAPES)
def test_plain_matches_xla_loop_f64(N, K):
    C, a, b, _ = _case(N, K, seed=N + 1, dtype=np.float64)
    ref = np.asarray(_sinkhorn_unbalanced(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), *ARGS))
    out = sinkhorn.sinkhorn_unbalanced_reference(torch.as_tensor(C), torch.as_tensor(a),
                                                 torch.as_tensor(b), *ARGS).numpy()
    np.testing.assert_allclose(out, ref, **TOL64)


def test_zero_mass_rows_stay_zero():
    C, a, b, zero = _case(256, 8, seed=7)
    out = sinkhorn.sinkhorn_unbalanced_reference(torch.as_tensor(C), torch.as_tensor(a),
                                                 torch.as_tensor(b), *ARGS)
    assert torch.all(out[torch.as_tensor(zero)] == 0)
    assert torch.isfinite(out).all()


def test_batch_axis_equals_per_problem():
    C, a, b, _ = _case(300, 8, seed=3, dtype=np.float64, B=3)
    out = sinkhorn.sinkhorn_unbalanced_reference(torch.as_tensor(C), torch.as_tensor(a),
                                                 torch.as_tensor(b), *ARGS)
    for i in range(3):
        one = sinkhorn.sinkhorn_unbalanced_reference(torch.as_tensor(C[i]), torch.as_tensor(a[i]),
                                                     torch.as_tensor(b[i]), *ARGS)
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), rtol=1e-12, atol=0)


def test_cpu_tensors_take_the_plain_loop_without_a_launch():
    C, a, b, _ = _case(64, 8, seed=5, dtype=np.float64)
    t = [torch.as_tensor(x) for x in (C, a, b)]
    before = sinkhorn.COUNTER.launches
    out = sinkhorn.sinkhorn_unbalanced(*t, *ARGS)
    assert torch.equal(out, sinkhorn.sinkhorn_unbalanced_reference(*t, *ARGS))
    assert sinkhorn.COUNTER.launches == before


@pytest.mark.parametrize("bad,match", [("shape", "shape mismatch"), ("dtype", "float32 or float64"),
                                       ("k", "K <= 32"), ("n", "N <= 2048"), ("layout", "contiguous"),
                                       ("device", "CUDA device")])
def test_wrapper_checks_refuse_bad_inputs(bad, match):
    C, a, b, _ = _case(64, 8, seed=6, dtype=np.float64)
    C, a, b = (torch.as_tensor(x) for x in (C, a, b))
    if bad == "shape":
        a = a[:-1]
    elif bad == "dtype":
        b = b.float()
    elif bad == "k":
        C, b = torch.zeros(64, 33, dtype=torch.float64), torch.full((33,), 1.0 / 33, dtype=torch.float64)
    elif bad == "n":
        C, a = torch.zeros(4096, 8, dtype=torch.float64), torch.zeros(4096, dtype=torch.float64)
    elif bad == "layout":
        C = torch.zeros(8, 64, dtype=torch.float64).T
    with pytest.raises((ValueError, TypeError), match=match):
        sinkhorn._check(C, a, b)


@pytest.mark.parametrize("N,expected", [(1, (1, 1, 32)), (129, (2, 65, 96)), (257, (4, 65, 96)),
                                        (1024, (8, 128, 128)), (1025, (8, 129, 160)), (1536, (8, 192, 192)),
                                        (2048, (8, 256, 256))])
def test_cluster_layout(N, expected):
    """Blocks per cluster, rows per block, threads per block: every row has
    its thread, a power-of-two cluster of at most 8, whole warps."""
    cl, rows, threads = sinkhorn.cluster_layout(N)
    assert (cl, rows, threads) == expected
    assert cl * rows >= N and rows <= threads <= 256 and threads % 32 == 0


def cluster_schedule(C, a, b, epsilon, tau_a, tau_b, n_iters):
    """The CUDA kernel's schedule in plain PyTorch, one problem: the rows
    split over the cluster's blocks (sinkhorn.cluster_layout), one per
    thread; each warp's column partials; the cluster's (rank, warp) partials
    summed in the kernel's order (lane group g over ranks g, g + 32/KMAX, ...,
    warps in order, then a pairwise tree over the groups); the exp/log row
    and column updates, zero masses flagged to exactly 0."""
    N, K = C.shape
    eps, ua, vb = sinkhorn._scalars(epsilon, tau_a, tau_b)
    cl, rows, threads = sinkhorn.cluster_layout(N)
    warps, groups = threads // 32, 32 // (8 if K <= 8 else 32)
    t = torch.arange(threads)
    row = torch.arange(cl)[:, None] * rows + t  # (cl, threads): block rank, thread
    ok = (t < rows) & (row < N)
    Kmat = torch.exp(-C / eps)
    Kp = torch.where(ok[..., None], Kmat[row.clamp(max=N - 1)], 0.0)
    ap = torch.where(ok, a[row.clamp(max=N - 1)], 0.0)
    log_a, log_b = torch.log(ap), torch.log(b)
    u, v = torch.ones_like(ap), torch.ones_like(b)
    for _ in range(n_iters):
        kv = (Kp * v).sum(-1)
        u = torch.where(ap == 0, 0.0, torch.exp(ua * (log_a - torch.log(kv + 1e-12))))
        part = (Kp * u[..., None]).view(cl, warps, 32, K).sum(2)
        sums = []
        for g in range(groups):
            s = torch.zeros_like(b)
            for r in range(g, cl, groups):
                for w in range(warps):
                    s = s + part[r, w]
            sums.append(s)
        while len(sums) > 1:
            sums = [sums[j] + sums[j + 1] for j in range(0, len(sums), 2)]
        v = torch.where(b == 0, 0.0, torch.exp(vb * (log_b - torch.log(sums[0] + 1e-12))))
    u_rows = torch.zeros_like(a).index_put_((row[ok],), u[ok])
    return u_rows[:, None] * Kmat * v[None, :]


@pytest.mark.parametrize("K", [8, 20])
@pytest.mark.parametrize("N", [1, 129, 257, 1025])
def test_cluster_schedule_matches_plain_and_xla_loop_f64(N, K):
    """The kernel's cluster split, rank-order sums and exp/log updates hold
    the plain loop and the JAX package's f64 XLA loop at rtol 1e-10."""
    C, a, b, zero = _case(N, K, seed=N + K, dtype=np.float64)
    if N == 1:
        a = np.ones(1)  # one row with mass
    t = [torch.as_tensor(x) for x in (C, a, b)]
    out = cluster_schedule(*t, *ARGS)
    ref = sinkhorn.sinkhorn_unbalanced_reference(*t, *ARGS)
    xla = np.asarray(_sinkhorn_unbalanced(jnp.asarray(C), jnp.asarray(a), jnp.asarray(b), *ARGS))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL64)
    np.testing.assert_allclose(out.numpy(), xla, **TOL64)
    if N > 1:
        assert zero.any() and torch.all(out[torch.as_tensor(zero)] == 0)
