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
    EIGH_SYM_SWEEPS, the plain version's, and its pair tables for the
    step's n = 6 and 22 (kRounds6, kRounds22) are round_robin(n), pair for
    pair and round for round."""
    src = (Path(E.__file__).resolve().parents[1] / "csrc" / "eigh.cu").read_text()
    found = re.findall(r"constexpr int kSymSweeps = (\d+);", src)
    assert found == [str(E.EIGH_SYM_SWEEPS)]
    tables = re.findall(r"unsigned char kRounds(\d+)\[(\d+)\]\[(\d+)\]\[2\] = \{(.*?)\};", src, re.S)
    assert [int(t[0]) for t in tables] == [6, 22]
    for n, rounds, pairs, body in tables:
        table = np.array([int(x) for x in re.findall(r"\d+", body)]).reshape(int(rounds), int(pairs), 2)
        want = np.stack([np.stack([P, Q], -1) for P, Q in E.round_robin(int(n))])
        assert np.array_equal(table, want)


def _slots(P, Q, n):
    """(pair, side) of each index in a round: side 0 for p, 1 for q."""
    k, side = np.empty(n, np.int64), np.empty(n, np.int64)
    k[P], k[Q] = np.arange(len(P)), np.arange(len(Q))
    side[P], side[Q] = 0, 1
    return k, side


def _model_entry(A, c, s, rot, P, Q, slots, i, j):
    """Entries (i[m], j[m]) of the next round's A from this round's A and
    (c, s) (csrc/eigh.cu block_entry): row i of J^T A at the columns of j's
    pair, with (u, v) = (c, -s) or (s, c) by i's side, then the column
    rotation of j's pair by j's side; the rotated pair's own off-diagonal
    is 0."""
    k, side = slots
    ki, si, kj, sj = (torch.as_tensor(x) for x in (k[i], side[i], k[j], side[j]))
    pi, qi, pj, qj = P[ki], Q[ki], P[kj], Q[kj]
    ui = torch.where(si == 1, s[..., ki], c[..., ki])
    vi = torch.where(si == 1, c[..., ki], -s[..., ki])
    x = ui * A[..., pi, pj] + vi * A[..., qi, pj]
    y = ui * A[..., pi, qj] + vi * A[..., qi, qj]
    uj = torch.where(sj == 1, s[..., kj], c[..., kj])
    vj = torch.where(sj == 1, c[..., kj], -s[..., kj])
    zero = (ki == kj) & (si != sj) & rot[..., ki]
    return torch.where(zero, 0.0, uj * x + vj * y)


def _model_blocks(A, c, s, rot, P, Q):
    """The next round's A in 2 x 2 blocks (csrc/eigh.cu's block warps): the
    block of rows {P[k], Q[k]} and columns {P[l], Q[l]} from the same block
    and the (c, s) of k and l, rows first, then columns, written into a new
    buffer."""
    Pr, Qr, Pc, Qc = P[:, None], Q[:, None], P[None, :], Q[None, :]
    a, b, cq, d = A[..., Pr, Pc], A[..., Pr, Qc], A[..., Qr, Pc], A[..., Qr, Qc]
    ck, sk, cl, sl = c[..., :, None], s[..., :, None], c[..., None, :], s[..., None, :]
    a1, c1, b1, d1 = ck * a - sk * cq, sk * a + ck * cq, ck * b - sk * d, sk * b + ck * d
    a2, b2, c2, d2 = cl * a1 - sl * b1, sl * a1 + cl * b1, cl * c1 - sl * d1, sl * c1 + cl * d1
    own = torch.diag_embed(rot)
    out = torch.empty_like(A)
    out[..., Pr, Pc], out[..., Qr, Qc] = a2, d2
    out[..., Pr, Qc], out[..., Qr, Pc] = torch.where(own, 0.0, b2), torch.where(own, 0.0, c2)
    return out


def _fused_block_jacobi(M):
    """csrc/eigh.cu's round in plain torch, for even n: two buffers of A and
    of (c, s); in round g the block update writes A_{g+1} from A_g and
    (c, s)_g, the next round's rotations come from three entries of A_{g+1}
    recomputed from A_g and (c, s)_g (not read from A_{g+1}), and V takes
    (c, s)_g."""
    n = M.shape[-1]
    rounds = [tuple(torch.as_tensor(x) for x in pq) for pq in E.round_robin(n)]
    slots = [_slots(P.numpy(), Q.numpy(), n) for P, Q in rounds]
    A, scale_safe = E._scaled(M)
    V = torch.eye(n, dtype=M.dtype).expand(M.shape)
    P, Q = rounds[0]
    c, s, small = E._rotation(A[..., P, P], A[..., Q, Q], A[..., P, Q])
    rot = ~small
    total = E.EIGH_SYM_SWEEPS * len(rounds)
    for g in range(total):
        r = g % len(rounds)
        P, Q = rounds[r]
        if g + 1 < total:
            Pn, Qn = rounds[(r + 1) % len(rounds)]
            entry = lambda i, j: _model_entry(A, c, s, rot, P, Q, slots[r], i.numpy(), j.numpy())
            c_n, s_n, small_n = E._rotation(entry(Pn, Pn), entry(Qn, Qn), entry(Pn, Qn))
        A = _model_blocks(A, c, s, rot, P, Q)
        cc, sc = c[..., None, :], s[..., None, :]
        Vp, Vq = V[..., :, P], V[..., :, Q]
        V = V.index_copy(-1, P, cc * Vp - sc * Vq).index_copy(-1, Q, sc * Vp + cc * Vq)
        if g + 1 < total:
            c, s, rot = c_n, s_n, ~small_n
    return E._ascending(torch.diagonal(A, dim1=-2, dim2=-1) * scale_safe[..., 0], V)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,batch,kind", [(6, (3,), "indefinite"), (22, (2,), "cond_1e12"), (22, (1,), "clustered")])
def test_fused_block_round_is_the_plain_version(n, batch, kind, dtype):
    """The kernel's design, modelled in plain torch (_fused_block_jacobi),
    performs the plain version's operations: equal to the bit. That holds
    because each entry of a 2 x 2 block sees the row rotation and then the
    column rotation of the plain version's two passes, c x - s y is
    c x + (-s) y exactly, and the recomputed entries repeat the block
    update's operations."""
    M = torch.as_tensor(_matrices(40 + n, n, batch, kind), dtype=dtype)
    got = _fused_block_jacobi(M)
    want = E.eigh_sym_reference(M)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_sym_chain_is_its_plain_version_and_the_rotation():
    """eigh_sym's latency probe on a CPU block is its plain version, whose
    first round is the rotation of the block's (0, 0), (3, 3), (0, 3)
    entries (the last (c, s) starts as the identity)."""
    blk = torch.as_tensor(_matrices(11, 4, (), "indefinite"))
    assert torch.equal(E.sym_chain(blk, E.sym_rounds(6)), E.sym_chain_reference(blk, E.sym_rounds(6)))
    c, s, _ = E._rotation(blk[0, 0], blk[3, 3], blk[0, 3])
    assert torch.equal(E.sym_chain(blk, 1), torch.stack([c, s]))
    assert E.sym_rounds(22) == 315 and E.sym_rounds(6) == 75 and E.sym_rounds(5) == 75


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
