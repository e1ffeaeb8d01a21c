"""The step's symmetric eigendecompositions (gcslam_torch/ops/eigh.py) on
the CPU: the fixed-sweep Jacobi's plain version against the JAX package's
jnp.linalg.eigh, the custom operators' CPU registrations against the plain
versions, and their vmap rules against loops over the batch.

Tolerances: eigenvalues within 1e-12 of max|lambda| of jnp.linalg.eigh's
(LAPACK; both backward stable, so they differ by rounding of order n x
1e-16 relative to |M|); the domain_projection_psd reconstruction within
1e-12 x |M| in the Frobenius norm of the JAX package's (|M| is the scale
of either side's rounding; the eigenvectors of clustered eigenvalues are
not unique, so they are not compared entry by entry); the CPU
registrations and the vmap rules exactly (the same operations on the same
values)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gcslam_tpu.utils.xla import jnp
from gcslam_tpu.ops import linalg as jlin
from gcslam_torch import constants as C
from gcslam_torch.ops import eigh as E
from gcslam_torch.ops import linalg as tlin

LAM_RTOL = 1e-12
RECON_RTOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spectrum(rng, n, kind):
    if kind == "clustered":  # two tight clusters
        lam = np.concatenate([np.full(n // 2, 1.0), np.full(n - n // 2, 1e-3)])
        return lam * (1.0 + 1e-13 * rng.normal(size=n))
    if kind == "near_eps_psd":  # eigenvalues around the PSD floor, some below it
        lam = np.logspace(0, -8, n)
        lam[: n // 3] = C.EPS_PSD * rng.uniform(0.1, 10.0, n // 3)
        return lam
    if kind == "cond_1e12":
        return np.logspace(0, -12, n)
    return 10 ** rng.uniform(-6, 2, n) * rng.choice([-1.0, 1.0], n)  # indefinite


def _matrices(seed, n, batch, kind):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(np.prod(batch, dtype=int))):
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        M = (Q * _spectrum(rng, n, kind)) @ Q.T
        out.append(0.5 * (M + M.T))
    return np.stack(out).reshape(batch + (n, n))


KINDS = ["clustered", "near_eps_psd", "cond_1e12", "indefinite"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,batch", [(6, ()), (6, (7,)), (22, ()), (22, (4,))])
def test_eigh_sym_reference_matches_jax_eigh(n, batch, kind):
    M = _matrices(n + len(batch), n, batch, kind)
    lam, _ = E.eigh_sym_reference(torch.as_tensor(M))
    lam_j = np.asarray(jnp.linalg.eigh(jnp.asarray(M))[0])
    scale = np.abs(lam_j).max(-1, keepdims=True)
    assert np.all(np.abs(lam.numpy() - lam_j) <= LAM_RTOL * scale)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,batch", [(6, ()), (22, (4,))])
def test_domain_projection_through_the_jacobi_matches_jax(monkeypatch, n, batch, kind):
    """linalg.domain_projection_psd with its eigendecomposition on the
    fixed-sweep Jacobi (the route of a CUDA tensor), against the JAX
    package's (jnp.linalg.eigh)."""
    M = _matrices(100 + n, n, batch, kind)
    monkeypatch.setattr(E, "eigh", E.eigh_sym)
    M_psd, cert = tlin.domain_projection_psd(torch.as_tensor(M))
    M_j, cert_j = jlin.domain_projection_psd(jnp.asarray(M))
    M_j = np.asarray(M_j)
    err = np.linalg.norm(M_psd.numpy() - M_j, axis=(-2, -1)) / np.linalg.norm(M, axis=(-2, -1))
    assert np.all(err <= RECON_RTOL)
    assert np.array_equal(cert.near_null_count.numpy(), np.asarray(cert_j.near_null_count))


def _worst_convergence(M, n_sweeps):
    """max over the batch of |V diag(lam) V^T - M| and of the off-diagonal
    part of V^T M V, relative to |M| (Frobenius), after n_sweeps sweeps."""
    lam, V = E.eigh_sym_reference(M, n_sweeps)
    assert torch.all(lam[..., 1:] >= lam[..., :-1])
    norm = torch.linalg.matrix_norm(M)
    rec = torch.linalg.matrix_norm((V * lam[..., None, :]) @ V.transpose(-1, -2) - M) / norm
    D = V.transpose(-1, -2) @ M @ V
    off = torch.linalg.matrix_norm(D - torch.diag_embed(torch.diagonal(D, dim1=-2, dim2=-1))) / norm
    return float(rec.max()), float(off.max())


def test_sweeps_converge():
    """EIGH_SYM_SWEEPS at 22 x 22 is the least count that converges on the
    slowest cases met in the convergence check (two clusters of 11
    eigenvalues 1e-13 apart inside each, spectra rotated at random; the
    last of them, seed 26's sixth matrix, the slowest found; condition
    1e12): after it the reconstruction and the off-diagonal part of
    V^T M V are at the rounding floor (1e-13 of |M|), one sweep fewer they
    are not."""
    M = torch.as_tensor(np.concatenate(
        [_matrices(s, 22, (2,), "clustered") for s in range(3)] + [_matrices(9, 22, (2,), "cond_1e12")]
        + [_matrices(26, 22, (8,), "clustered")[5:6]]))
    assert max(_worst_convergence(M, E.EIGH_SYM_SWEEPS)) <= 1e-13
    assert max(_worst_convergence(M, E.EIGH_SYM_SWEEPS - 1)) > 1e-13


def test_kernel_sweeps_are_the_plain_versions():
    """The kernel's compiled-in sweep count (csrc/eigh.cu kSymSweeps) is
    EIGH_SYM_SWEEPS, the plain version's."""
    src = (Path(E.__file__).resolve().parents[1] / "csrc" / "eigh.cu").read_text()
    found = re.findall(r"constexpr int kSymSweeps = (\d+);", src)
    assert found == [str(E.EIGH_SYM_SWEEPS)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_registrations_are_the_plain_versions(dtype):
    rng = np.random.default_rng(3)
    A3 = torch.as_tensor(rng.normal(size=(5, 2, 3, 3)), dtype=dtype)
    A22 = torch.as_tensor(_matrices(4, 22, (2,), "cond_1e12"), dtype=dtype)
    A6 = torch.as_tensor(_matrices(5, 6, (3,), "indefinite"), dtype=dtype)
    for got, want in [(E.eigh3(A3), E.eigh3_reference(A3)), (E.eigh_sym(A22), E.eigh_sym_reference(A22)),
                      (E.eigh_sym(A6), E.eigh_sym_reference(A6))]:
        assert all(g.dtype == dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("op,n", [(E.eigh3, 3), (E.eigh_sym, 6), (E.eigh_sym, 22)])
def test_vmap_rule_equals_a_loop(op, n):
    """A vmapped dim folds into the operator's batch (on CUDA one launch);
    the result is a loop of per-run calls, bit for bit, and an unbatched
    input under vmap is computed once."""
    M = torch.as_tensor(_matrices(n, n, (3, 2), "indefinite"))
    got = torch.func.vmap(op)(M)
    want = [torch.stack(x) for x in zip(*[op(M[r]) for r in range(3)])]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    inner = torch.func.vmap(torch.func.vmap(op), in_dims=1)(M)
    assert all(torch.equal(g, w.transpose(0, 1)) for g, w in zip(inner, want))
    shared = torch.func.vmap(lambda x, m: op(m), in_dims=(0, None))(torch.zeros(4), M[0])
    assert all(torch.equal(g, w[0].expand(g.shape)) for g, w in zip(shared, want))


def test_order_ties_nan_and_zero():
    """Ties keep index order (a stable argsort); a zero matrix gives zero
    eigenvalues and the identity; a NaN entry gives NaN eigenvalues and
    no error."""
    for n, ref in [(3, E.eigh3_reference), (6, E.eigh_sym_reference), (22, E.eigh_sym_reference)]:
        d = torch.tensor([2.0, 1.0, 2.0] + [3.0] * (n - 3), dtype=torch.float64)
        lam, V = ref(torch.diag(d))
        assert torch.equal(lam, torch.sort(d, stable=True).values)
        assert torch.equal(V, torch.eye(n, dtype=torch.float64)[:, torch.sort(d, stable=True).indices])
        lam0, V0 = ref(torch.zeros(n, n, dtype=torch.float64))
        assert torch.equal(lam0, torch.zeros(n, dtype=torch.float64)) and torch.equal(V0, torch.eye(n).double())
        bad = torch.eye(n, dtype=torch.float64)
        bad[0, 1] = bad[1, 0] = float("nan")
        assert torch.isnan(ref(bad)[0]).all()


def test_round_robin_pairs_every_index_pair_once_a_sweep():
    for n in (1, 2, 3, 6, 7, 22, 32):
        pairs = [(int(p), int(q)) for P, Q in E.round_robin(n) for p, q in zip(P, Q)]
        assert sorted(pairs) == [(p, q) for p in range(n) for q in range(p + 1, n)]
        for P, Q in E.round_robin(n):  # disjoint within a round
            assert len(set(P.tolist()) | set(Q.tolist())) == 2 * len(P)


def test_step_routes_the_cpu_to_lapack_and_3x3_to_eigh3():
    """ops/eigh.eigh on CPU tensors: 3 x 3 to eigh3, other sizes to
    torch.linalg.eigh (the routine the JAX package reaches on the CPU)."""
    M = torch.as_tensor(_matrices(8, 22, (2,), "cond_1e12"))
    assert all(torch.equal(g, w) for g, w in zip(E.eigh(M), torch.linalg.eigh(M)))
    assert torch.equal(E.eigvalsh(M), torch.linalg.eigvalsh(M))
    M3 = torch.as_tensor(_matrices(9, 3, (4,), "indefinite"))
    assert all(torch.equal(g, w) for g, w in zip(E.eigh(M3), E.eigh3_reference(M3)))
    assert torch.equal(E.eigvalsh(M3), E.eigh3_reference(M3)[0])
