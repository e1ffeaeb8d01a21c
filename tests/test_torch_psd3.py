"""The fused 3 x 3 PSD projection (gcslam_torch/ops/eigh.psd3) and the
redesigned eigh3 kernel's arithmetic, on the CPU: psd3's CPU registration
against the composition linalg.domain_projection_psd made before it (bit
for bit), against the JAX package's domain_projection_psd, its vmap rule
against a loop; plain-torch models of csrc/eigh.cu's eigh3_kernel (the
sparse rotation, the fused epilogue) and of its chain floor against the
plain versions; and the step's merged calls (the three IW modes, the
odometry's St and Sr, the pose's two blocks) against the separate calls.

Tolerances: against the JAX package those of
tests/test_torch_eigh.py (RECON_RTOL of |M| for M_psd, LAM_RTOL of
max|lambda| for the eigenvalue fields); the kernel's model against the
plain versions to the bit except for the sign of a zero where the two
perform the same IEEE operations (batched inputs: the CPU's batched 3 x 3
product sums over k in order, as the kernel does), and EIGH_RTOL of
max|lambda| or of |M| where they sum in other orders (the Frobenius
norms, a 2-D product, which MKL computes with its own order and fused
multiply-adds)."""

from pathlib import Path
import re

import jax
import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.ops import linalg as jlin
from gcslam_torch import constants as C
from gcslam_torch.ops import eigh as E
from gcslam_torch.ops import evidence_odom as todo
from gcslam_torch.ops import evidence_pose as tpose
from gcslam_torch.ops import iw
from gcslam_torch.ops import linalg as tlin
from gcslam_torch.utils.tree import tree_leaves
from test_torch_eigh import KINDS, LAM_RTOL, RECON_RTOL, _matrices, one_torch_thread  # noqa: F401 (autouse fixture)

EIGH_RTOL = {torch.float64: 1e-14, torch.float32: 1e-6}
SHAPES = [(), (4,), (3,), (2, 4)]  # batches of the step's psd3 calls: (3, 3), (4, 3, 3), (3, 3, 3), (2, 4, 3, 3)
EPS = C.EPS_PSD
_jax_projection = jax.jit(jlin.domain_projection_psd)  # one compile a shape


def _inputs(kind, batch, dtype, seed=0):
    """(..., 3, 3) of a _matrices kind, or zeros, or a batch with a NaN
    entry in its first matrix (asymmetric, so the symmetrization spreads
    it to both triangles)."""
    if kind == "zero":
        return torch.zeros(batch + (3, 3), dtype=dtype)
    M = torch.as_tensor(_matrices(seed + len(batch), 3, batch, "indefinite" if kind == "nan" else kind),
                        dtype=dtype)
    if kind == "nan":
        M.reshape(-1, 3, 3)[0, 2, 1] = float("nan")
    return M


def _composition(M, eps_psd):
    """linalg.domain_projection_psd as it was composed before psd3 (for
    3 x 3: linalg.sym, the Frobenius norm, ops/eigh.eigh, the floor, the
    reconstruction and the certificate), in the PsdCert order."""
    M_sym = 0.5 * (M + M.transpose(-1, -2))
    sym_delta = torch.linalg.matrix_norm(M_sym - M, ord="fro")
    eigvals, eigvecs = E.eigh(M_sym)
    vals = torch.clamp(eigvals, min=eps_psd)
    M_psd = (eigvecs * vals[..., None, :]) @ eigvecs.transpose(-1, -2)
    projection_delta = torch.linalg.matrix_norm(M_psd - M_sym, ord="fro")
    eig_min, eig_max = vals.amin(-1), vals.amax(-1)
    return M_psd, [projection_delta, sym_delta, eig_min, eig_max, eig_max / eig_min,
                   torch.sum(vals < 10.0 * eps_psd, dim=-1).to(M.dtype)]


def _bits(x):
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def _same(a, b) -> bool:
    """Equal to the bit, NaN payloads and signs of zero included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _same_but_zero_sign(a, b) -> bool:
    """Equal values (NaN where NaN, -0 == +0)."""
    try:
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch", SHAPES)
@pytest.mark.parametrize("kind", KINDS + ["zero", "nan"])
def test_psd3_on_the_cpu_is_the_composition(kind, batch, dtype):
    """psd3's CPU registration, and domain_projection_psd through it, give
    the earlier composition's M_psd and six certificate fields bit for bit."""
    M = _inputs(kind, batch, dtype)
    want_psd, want = _composition(M, EPS)
    got_psd, cert = E.psd3(M, EPS)
    assert cert.shape == batch + (6,)
    assert _same(got_psd, want_psd) and all(_same(cert[..., k], w) for k, w in enumerate(want))
    lin_psd, lin_cert = tlin.domain_projection_psd(M, EPS)
    assert _same(lin_psd, want_psd) and all(_same(g, w) for g, w in zip(lin_cert, want))
    if kind == "zero":
        assert torch.all(lin_cert.cond == 1.0) and torch.all(lin_cert.near_null_count == 3.0)
    if kind == "nan":
        first = [f.reshape(-1)[0] for f in lin_cert]
        assert torch.isnan(lin_psd.reshape(-1, 3, 3)[0]).all()
        assert all(torch.isnan(f) for f in first[:5]) and first[5] == 0.0  # NaN < x is false


@pytest.mark.parametrize("batch", [(), (4,), (2, 4)])
@pytest.mark.parametrize("kind", KINDS + ["zero"])
def test_psd3_matches_jax(kind, batch):
    """domain_projection_psd for 3 x 3 (psd3) against the JAX package's
    (its eigh_3x3 route): M_psd within RECON_RTOL x |M|, the two deltas
    within RECON_RTOL x |M|, eig_min / eig_max within LAM_RTOL of
    max|lambda|, near_null_count equal."""
    M = _inputs(kind, batch, torch.float64, seed=200).numpy()
    M_psd, cert = tlin.domain_projection_psd(torch.as_tensor(M))
    M_j, cert_j = _jax_projection(jnp.asarray(M))
    norm = np.linalg.norm(M, axis=(-2, -1)) + 1e-300
    lam_scale = np.abs(np.linalg.eigvalsh(M)).max(-1) + EPS
    err = np.linalg.norm(M_psd.numpy() - np.asarray(M_j), axis=(-2, -1)) / norm
    assert np.all(err <= RECON_RTOL)
    for f in ("sym_delta", "projection_delta"):
        assert np.all(np.abs(getattr(cert, f).numpy() - np.asarray(getattr(cert_j, f))) <= RECON_RTOL * norm)
    for f in ("eig_min", "eig_max"):
        assert np.all(np.abs(getattr(cert, f).numpy() - np.asarray(getattr(cert_j, f))) <= LAM_RTOL * lam_scale)
    assert np.array_equal(cert.near_null_count.numpy(), np.asarray(cert_j.near_null_count))


def test_psd3_vmap_rule_equals_a_loop():
    """A vmapped dim folds into psd3's batch (on CUDA one launch): a loop
    of per-run calls to the bit; an unbatched input under vmap is computed
    once."""
    M = torch.as_tensor(_matrices(31, 3, (3, 2), "near_eps_psd"))
    op = lambda m: E.psd3(m, EPS)  # noqa: E731
    got = torch.func.vmap(op)(M)
    want = [torch.stack(x) for x in zip(*[op(M[r]) for r in range(3)])]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    inner = torch.func.vmap(torch.func.vmap(op), in_dims=1)(M)
    assert all(torch.equal(g, w.transpose(0, 1)) for g, w in zip(inner, want))
    shared = torch.func.vmap(lambda x, m: op(m), in_dims=(0, None))(torch.zeros(4), M[0])
    assert all(torch.equal(g, w[0].expand(g.shape)) for g, w in zip(shared, want))
    lin = torch.func.vmap(lambda m: tlin.domain_projection_psd(m))(M)
    assert torch.equal(lin[0], want[0]) and torch.equal(lin[1].cond, want[1][..., 4])


def test_3x3_projection_dispatches_psd3_alone():
    """domain_projection_psd of a (..., 3, 3) batch dispatches one psd3 and
    a view of its certificate, nothing else (on the card: one launch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    M = _inputs("indefinite", (2, 4), torch.float64)
    with Ops() as rec:
        tlin.domain_projection_psd(M)
    assert rec.ops == ["gcslam.psd3.default", "aten.unbind.int"]


# --- plain-torch models of csrc/eigh.cu's eigh3_kernel ----------------------

def _model_eigh3(M):
    """eigh3_kernel in plain torch: A's six entries in registers, each
    rotation's (c, s) from ops/eigh._rotation (the kernel skips the square
    roots and divisions of a `small` rotation, whose (c, s) = (1, 0) is
    _rotation's exactly), the sparse update of A (ops/eigh._rotate_a) and
    of columns p, q of V, the rescaling, the rank ordering."""
    A, scale_safe = E._scaled(M)
    a00, a11, a22, a01, a02, a12 = (A[..., i, j] for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)))
    one, zero = torch.ones_like(a00), torch.zeros_like(a00)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def rotate_v(p, q, c, s):
        for row in V:
            x, y = row[p], row[q]
            row[p], row[q] = c * x - s * y, s * x + c * y

    for _ in range(E.EIGH3_SWEEPS):
        c, s, _ = E._rotation(a00, a11, a01)
        a00, a11, a01, a02, a12 = E._rotate_a(a00, a11, a01, a02, a12, c, s)
        rotate_v(0, 1, c, s)
        c, s, _ = E._rotation(a00, a22, a02)
        a00, a22, a02, a01, a12 = E._rotate_a(a00, a22, a02, a01, a12, c, s)
        rotate_v(0, 2, c, s)
        c, s, _ = E._rotation(a11, a22, a12)
        a11, a22, a12, a01, a02 = E._rotate_a(a11, a22, a12, a01, a02, c, s)
        rotate_v(1, 2, c, s)
    lam = torch.stack([a00, a11, a22], -1) * scale_safe[..., 0]
    return E._ascending(lam, torch.stack([torch.stack(row, -1) for row in V], -2))


def _model_psd3(M, eps_psd):
    """eigh3_kernel<T, kPsd = true> in plain torch: M_sym, the model eigh3
    of M_sym, vals = max(lambda, eps) with NaN kept, M_psd summed over k in
    order, the Frobenius norms as in-order sums of the nine squares, the
    extremes, cond and the count below 10 eps."""
    M_sym = E._sym(M)
    lam, U = _model_eigh3(M_sym)
    vals = torch.where(torch.isnan(lam), lam, torch.clamp(lam, min=eps_psd))
    W = U * vals[..., None, :]
    M_psd = (W[..., :, None, 0] * U[..., None, :, 0] + W[..., :, None, 1] * U[..., None, :, 1]) \
        + W[..., :, None, 2] * U[..., None, :, 2]

    def fro(D):
        d = D.flatten(-2)
        acc = d[..., 0] * d[..., 0]
        for k in range(1, 9):
            acc = acc + d[..., k] * d[..., k]
        return torch.sqrt(acc)

    lo, hi = vals.amin(-1), vals.amax(-1)
    return M_psd, torch.stack([fro(M_psd - M_sym), fro(M_sym - M), lo, hi, hi / lo,
                               (vals < 10.0 * eps_psd).sum(-1).to(M.dtype)], -1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch", [(1,), (4,), (2, 3)])
@pytest.mark.parametrize("kind", KINDS + ["zero", "nan"])
def test_sparse_rotation_is_the_full_product_chain(kind, batch, dtype):
    """The kernel's rotation touches rows and columns p, q of A and columns
    p, q of V alone, with the non-zero terms of the full 3 x 3 products
    in their order: the terms left out add exact zeros (x * 0, x * 1), and
    0.5 (y + y) == y for the entries where Y is symmetric. So the model
    equals eigh3_reference (whose batched 3 x 3 products sum in order on
    the CPU) up to the sign of a zero, NaN where NaN."""
    M = _inputs(kind, batch, dtype, seed=60)
    got, want = _model_eigh3(M), E.eigh3_reference(M)
    assert all(_same_but_zero_sign(g, w) for g, w in zip(got, want))
    if kind == "nan":
        assert torch.isnan(got[0].reshape(-1, 3)[0]).all() and torch.isnan(got[1].reshape(-1, 3, 3)[0]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", KINDS + ["zero", "nan"])
def test_fused_epilogue_is_the_plain_projection(kind, dtype):
    """The kernel's psd3 (modelled) against psd3_reference: M_psd within
    EIGH_RTOL of the item's max|lambda| (the reconstruction's sums agree,
    the eigenvectors to the sign of a zero); the two deltas within
    EIGH_RTOL x |M| (the Frobenius sums in another order); eig_min, eig_max
    and cond bit-equal (the model's eigenvalues are eigh3_reference's);
    near_null_count equal."""
    M = _inputs(kind, (2, 4), dtype, seed=80)
    (got_psd, got), (want_psd, want) = _model_psd3(M, EPS), E.psd3_reference(M, EPS)
    tol = EIGH_RTOL[dtype]
    scale = want[..., 3:4].abs()  # eig_max: max |lambda| of the floored spectrum
    norm = torch.linalg.matrix_norm(M)
    ok = torch.isnan(want_psd).flatten(-2).any(-1)
    assert torch.equal(torch.isnan(got_psd), torch.isnan(want_psd)) and torch.equal(torch.isnan(got), torch.isnan(want))
    d_psd = (got_psd - want_psd).abs().amax((-2, -1))
    assert torch.all((d_psd <= tol * scale[..., 0]) | ok)
    for k in (0, 1):
        assert torch.all(((got[..., k] - want[..., k]).abs() <= tol * norm) | ok)
    for k in (2, 3, 4, 5):
        assert _same_but_zero_sign(got[..., k], want[..., k])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", KINDS + ["zero", "nan"])
def test_eigh3_chain_is_the_chain_of_the_plain_version(kind, dtype):
    """eigh3's latency probe runs the plain chain's 18 rotations on A: its
    plain version gives the scaled diagonal of the full-product chain
    (eigh3_reference's _jacobi_rot_3x3 on a batch of one) up to the sign of
    a zero, and the CPU entry (3, 3) is the plain version."""
    M = _inputs(kind, (1,), dtype, seed=90)
    A, _ = E._scaled(M)
    V = torch.eye(3, dtype=dtype).expand(M.shape)
    for _ in range(E.EIGH3_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            A, V = E._jacobi_rot_3x3(A, V, p, q)
    want = torch.diagonal(A, dim1=-2, dim2=-1)
    assert _same_but_zero_sign(E.eigh3_chain_reference(M), want)
    assert _same(E.eigh3_chain(M[0]), E.eigh3_chain_reference(M[0]))
    with pytest.raises(ValueError):
        E.eigh3_chain(M)


def test_kernel_sweeps_are_eigh3_sweeps():
    """csrc/eigh.cu's eigh3 sweep count (kSweeps3) is EIGH3_SWEEPS, the plain
    version's."""
    src = (Path(E.__file__).resolve().parents[1] / "csrc" / "eigh.cu").read_text()
    assert re.findall(r"constexpr int kSweeps3 = (\d+);", src) == [str(E.EIGH3_SWEEPS)]


# --- the step's merged calls against the separate calls --------------------

def _iw_state(dtype):
    rng = np.random.default_rng(7)
    A = rng.normal(size=(3, 3, 3))
    return iw.MeasurementNoiseIW(nu=torch.as_tensor(rng.uniform(5.0, 10.0, 3), dtype=dtype),
                                 Psi=torch.as_tensor(A @ A.transpose(0, 2, 1), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_measurement_noise_modes_are_the_separate_modes(dtype):
    """iw.measurement_noise_modes (one (3, 3, 3) projection) gives each
    block's measurement_noise_mode: to the bit where that call is a batch
    of one (the same batched arithmetic), within EIGH_RTOL of max|Sigma| of
    the separate 2-D calls (MKL's 2-D product sums in its own order)."""
    st = _iw_state(dtype)
    merged = iw.measurement_noise_modes(st)
    one = iw.MeasurementNoiseIW(nu=st.nu[:, None, None, None], Psi=st.Psi[:, None])
    assert all(torch.equal(merged[i], iw.measurement_noise_mode(one, i)[0]) for i in range(3))
    sep = torch.stack([iw.measurement_noise_mode(st, i) for i in range(3)])
    assert torch.all((merged - sep).abs() <= EIGH_RTOL[dtype] * sep.abs().amax())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_odometry_projects_st_and_sr_in_one_call(monkeypatch, dtype):
    """pose_twist_kinematic_consistency projects St and Sr in one (2, K, 3, 3)
    call; splitting that call into the two separate ones gives every output
    to the bit (both are batches of K)."""
    rng = np.random.default_rng(11)
    K = 4
    pose = np.concatenate([rng.normal(size=(K, 3)), rng.normal(size=(K, 3)) * 0.2], 1)
    Sv = rng.normal(size=(2, 3, 3))
    T = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    args = (T(pose + rng.normal(size=(K, 6)) * 0.02), T(pose), T(rng.normal(size=3)), T(rng.normal(size=3)),
            T(0.1), T(Sv[0] @ Sv[0].T), T(Sv[1] @ Sv[1].T), T(np.tile(np.eye(3) * 1e-3, (K, 1, 1))),
            T(np.tile(np.eye(3) * 2e-3, (K, 1, 1))))
    orig = tlin.domain_projection_psd
    shapes = []

    def split(M, eps_psd=EPS):
        shapes.append(tuple(M.shape))
        if M.shape == (2, K, 3, 3):
            parts = [orig(M[i], eps_psd) for i in range(2)]
            return torch.stack([p[0] for p in parts]), tlin.PsdCert(*[torch.stack(f) for f in zip(*[p[1] for p in parts])])
        return orig(M, eps_psd)

    merged = todo.pose_twist_kinematic_consistency(*args)
    monkeypatch.setattr(tlin, "domain_projection_psd", split)
    separate = todo.pose_twist_kinematic_consistency(*args)
    assert shapes == [(2, K, 3, 3)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(merged), tree_leaves(separate)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batch", [(), (4,)])
def test_pose_block_eigvals_are_the_separate_calls(batch, dtype):
    """evidence_pose.block_eigvals (one (..., 2, 3, 3) eigendecomposition)
    gives the separate eigh_3x3 calls' eigenvalues of the two blocks: to
    the bit for a batch of hypotheses (both batched), within EIGH_RTOL of
    max|lambda| for one (6, 6) (the separate 2-D calls' products are MKL's)."""
    A = np.random.default_rng(13).normal(size=batch + (6, 6))
    L6 = torch.as_tensor(A @ np.swapaxes(A, -1, -2), dtype=dtype)
    eig_t, eig_r = tpose.block_eigvals(L6)
    want_t = tlin.eigh_3x3(tlin.sym(L6[..., 0:3, 0:3]))[0]
    want_r = tlin.eigh_3x3(tlin.sym(L6[..., 3:6, 3:6]))[0]
    if batch:
        assert torch.equal(eig_t, want_t) and torch.equal(eig_r, want_r)
    for got, want in ((eig_t, want_t), (eig_r, want_r)):
        assert torch.all((got - want).abs() <= EIGH_RTOL[dtype] * want.abs().amax(-1, keepdim=True))
