"""The Lie-group maps and the 3 x 3 inverse as the custom operators
`gcslam::lie` (gcslam_torch/ops/se3.py) and `gcslam::inv3x3`
(gcslam_torch/ops/linalg.py), one kernel csrc/se3.cu, on the CPU:
each op's public function equals its plain version (`<name>_reference`,
the code the CPU path ran before the operator) bit for bit on the edge
cases of each branch (theta = 0, theta < 1e-7, 1e-7 < theta < 1e-4, near
pi with sin(theta) < 1e-5, theta = pi), on broadcast operands and in both
dtypes; torch.func.vmap of each op equals a loop over the vmapped dim; the
launch counter stays 0 on the CPU; and the launch's layout (the meta array
of csrc/se3.cu), read by a Python model of the kernel's addressing, finds
every element of the broadcast operands. The kernel against the plain
versions on the card: tests/test_torch_cuda.py."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gcslam_torch.ops import linalg, se3

DTYPES = [torch.float64, torch.float32]
SOURCE = Path(se3.__file__).resolve().parent.parent / "csrc" / "se3.cu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rotvecs(dtype, seed=0):
    """(9, 3) rotation vectors: theta = 0, < 1e-7, in (1e-7, 1e-4), two
    generic, near pi (sin(theta) ~ 1e-6), pi exactly, and pi about a
    coordinate axis and about a diagonal axis."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    v = np.stack([np.zeros(3), 3e-8 * axis, 2e-5 * axis, rng.normal(size=3), 2.5 * axis,
                  (math.pi - 1e-6) * axis, math.pi * axis, [math.pi, 0.0, 0.0],
                  math.pi * np.ones(3) / math.sqrt(3.0)])
    return torch.as_tensor(v, dtype=dtype)


def rotations(dtype, seed=0):
    """so3_log's inputs: the plain so3_exp of rotvecs, and diag(1, -1, -1)
    (pi exactly)."""
    R = se3.so3_exp_reference(rotvecs(dtype, seed))
    return torch.cat([R, torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=dtype))[None]])


def poses(dtype, seed=0):
    """(9, 6): random translations beside rotvecs."""
    t = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(9, 3)), dtype=dtype)
    return torch.cat([t, rotvecs(dtype, seed)], -1)


def matrices(dtype, seed=0):
    """inv3x3's inputs: random, symmetric positive definite, rank 2, zero,
    negative determinant, badly scaled."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(3, 3))
    u, w = rng.normal(size=3), rng.normal(size=3)
    M = np.stack([A, A @ A.T + 0.1 * np.eye(3), np.outer(u, w) + np.outer(w, u), np.zeros((3, 3)),
                  np.diag([1.0, 2.0, -3.0]), 1e-12 * A, 1e9 * A])
    return torch.as_tensor(M, dtype=dtype)


def operands(op, dtype, seed=0):
    """An op's operands (two for the two-pose ops: the second reversed)."""
    if op in ("so3_exp", "skew"):
        return (rotvecs(dtype, seed),)
    if op == "so3_log":
        return (rotations(dtype, seed),)
    if op == "inv3x3":
        return (matrices(dtype, seed),)
    p = poses(dtype, seed)
    return (p, p.flip(0)) if OPS_ARITY[op] == 2 else (p,)


OPS_ARITY = {op: 1 if tails[1] is None else 2 for op, tails in se3.OPS.items()}
PUBLIC = {op: getattr(se3, op) for op in se3.OPS if op != "inv3x3"} | {"inv3x3": linalg.inv3x3}
PLAIN = {op: getattr(se3, f"{op}_reference") for op in se3.OPS if op != "inv3x3"} | {
    "inv3x3": linalg.inv3x3_reference}


def call(fns, op, *args):
    return fns[op](*args, 1e-6) if op == "inv3x3" else fns[op](*args)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", list(se3.OPS))
def test_op_is_its_plain_version_on_the_cpu(op, dtype):
    """Every branch's edge cases: the operator's CPU kernel runs the plain
    version, to the bit, and nothing is launched."""
    before = se3.LIE_COUNTER.launches
    args = operands(op, dtype)
    got = call(PUBLIC, op, *args)
    want = call(PLAIN, op, *args)
    assert got.dtype == dtype and torch.equal(got, want)
    if op == "inv3x3":
        assert torch.equal(linalg.inv3x3(args[0]), linalg.inv3x3_reference(args[0]))
    assert se3.LIE_COUNTER.launches == before == 0


def test_the_edge_cases_take_each_branch():
    """The inputs reach so3_log's three branches (the step's thresholds:
    theta < 1e-7 small, cos < 0 and sin < 1e-5 near pi) and so3_exp's
    Taylor branch, so the operator is held on each."""
    R = rotations(torch.float64)
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos_t = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    vex = 0.5 * torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0], R[:, 1, 0] - R[:, 0, 1]], -1)
    sin_t = torch.linalg.vector_norm(vex, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < se3.SMALL_ANGLE
    near_pi = (cos_t < 0.0) & (sin_t < 1e-5)
    assert small.sum() == 2 and near_pi.sum() >= 4 and (~small & ~near_pi).sum() >= 3
    th = torch.linalg.vector_norm(rotvecs(torch.float64), dim=-1)
    assert ((th > 0) & (th < 1e-7)).any() and ((th > 1e-7) & (th < 1e-4)).any()
    # the near-pi results are rotations by pi about the axis, up to its sign
    w = se3.so3_log(R[near_pi])
    assert torch.allclose(torch.linalg.vector_norm(w, dim=-1), theta[near_pi], rtol=1e-12)


@pytest.mark.parametrize("op,shapes", [
    ("se3_compose", ((4, 6), (6,))), ("se3_compose", ((6,), (4, 6))), ("se3_compose", ((2, 1, 6), (3, 6))),
    ("se3_relative", ((4, 6), (6,))), ("se3_relative", ((1, 4, 6), (7, 1, 6))),
    ("so3_exp", ((2, 4, 512, 3),)), ("so3_log", ((7, 128, 3, 3),)), ("inv3x3", ((7, 128, 3, 3),)),
    ("se3_exp", ((8192, 6),)), ("skew", ((128, 3),)),
])
def test_broadcast_operands(op, shapes):
    """The operator broadcasts as the plain version does, to its bits."""
    rng = np.random.default_rng(len(shapes) + sum(map(len, shapes)))
    args = [torch.as_tensor(rng.normal(size=s)) for s in shapes]
    if op == "so3_log":
        args = [se3.so3_exp_reference(args[0][..., 0, :])]
    got, want = call(PUBLIC, op, *args), call(PLAIN, op, *args)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("op", list(se3.OPS))
def test_vmap_equals_a_loop(op):
    """torch.func.vmap over the run axis (at dim 0 and at dim 1, and with an
    unbatched operand) folds the axis into one call: it equals the call on
    the stacked operands to the bit, runs nothing per sample, and equals a
    loop over the runs within LOOP_ULPS of the output's largest entry (the
    CPU's batched 3 x 3 product sums by a kernel that depends on the batch's
    size; on the card each element is one thread's arithmetic and vmap
    equals the loop to the bit, tests/test_torch_cuda.py)."""
    R = 3
    per_run = [operands(op, torch.float64, seed=r) for r in range(R)]
    stacked = [torch.stack([p[i] for p in per_run]) for i in range(OPS_ARITY[op])]
    fn = lambda *x: call(PUBLIC, op, *x)  # noqa: E731
    with _no_fallback():
        got = torch.func.vmap(fn)(*stacked)
        got1 = torch.func.vmap(fn, in_dims=1)(*[x.movedim(0, 1) for x in stacked])
    assert torch.equal(got, call(PLAIN, op, *stacked)) and torch.equal(got1, got)
    _near(got, torch.stack([fn(*p) for p in per_run]))
    if OPS_ARITY[op] == 2:
        b0, a0 = per_run[0][1][0], per_run[0][0][:2]
        with _no_fallback():
            got2 = torch.func.vmap(fn, in_dims=(0, None))(stacked[0], b0)
            got3 = torch.func.vmap(fn, in_dims=(None, 0))(a0, stacked[1][:, :1])
        assert torch.equal(got2, call(PLAIN, op, stacked[0], b0))
        assert torch.equal(got3, call(PLAIN, op, a0, stacked[1][:, :1]))
        _near(got2, torch.stack([fn(p[0], b0) for p in per_run]))
        _near(got3, torch.stack([fn(a0, p[1][:1]) for p in per_run]))


LOOP_ULPS = 4


def _near(got, want):
    assert got.shape == want.shape
    scale = want.abs().max() * torch.finfo(want.dtype).eps
    assert (got - want).abs().max() <= LOOP_ULPS * scale


class _no_fallback:
    """vmap's per-sample fallback warns; the rule must leave it unused."""

    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.filterwarnings("error", message=".*performance drop.*")

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def _kernel_offsets(meta, ndim, n):
    """csrc/se3.cu's addressing in Python: each element's offsets into a
    and into b, from the meta array."""
    D = se3.MAX_DIMS
    out = []
    for idx in range(n):
        rest, off_a, off_b = idx, 0, 0
        for d in reversed(range(ndim)):
            q, k = divmod(rest, meta[d])
            off_a += k * meta[D + d]
            off_b += k * meta[2 * D + d]
            rest = q
        out.append((off_a, off_b))
    return out


def test_the_launch_layout_addresses_every_element():
    """The meta array the launch passes (the broadcast batch's sizes, the
    operands' strides over it and over their trailing dims), read as the
    kernel reads it: a strided view and a broadcast operand (stride 0)
    give each element's own entries, with no copy."""
    rng = np.random.default_rng(3)
    base = torch.as_tensor(rng.normal(size=(4, 1, 12)))
    a = base[..., 3:9]  # (4, 1, 6), strided
    b = torch.as_tensor(rng.normal(size=(3, 6)))
    batch = (4, 3)
    a_e, b_e = a.expand(batch + (6,)), b.expand(batch + (6,))
    meta = se3._layout(batch, a_e, b_e)
    D = se3.MAX_DIMS
    assert list(meta[:2]) == [4, 3] and list(meta[D:D + 2]) == [12, 0] and list(meta[2 * D:2 * D + 2]) == [0, 6]
    assert list(meta[3 * D:]) == [1, 0, 1, 0]
    flat_a, flat_b = base.reshape(-1), b.reshape(-1)
    for idx, (off_a, off_b) in enumerate(_kernel_offsets(meta, 2, math.prod(batch))):
        i, j = divmod(idx, 3)
        got_a = flat_a[a.storage_offset() + off_a + meta[3 * D] * torch.arange(6)]
        got_b = flat_b[off_b + meta[3 * D + 2] * torch.arange(6)]
        assert torch.equal(got_a, a_e[i, j]) and torch.equal(got_b, b_e[i, j])
    M = torch.as_tensor(rng.normal(size=(3, 3, 5)))[:, :, 1:4].transpose(-1, -2)  # (3, 3, 3), strided
    meta = se3._layout((3,), M, None)
    assert list(meta[3 * D:3 * D + 2]) == list(M.stride()[1:]) and list(meta[3 * D + 2:]) == [0, 0]


def test_the_source_mirrors_the_module():
    """csrc/se3.cu's op codes are OPS in order, and its constants are the
    module's."""
    src = SOURCE.read_text()
    enum = re.search(r"enum Op : int \{([^}]*)\}", src).group(1)
    codes = [c.strip() for c in enum.split(",")]
    camel = ["k" + "".join(w.capitalize() for w in op.split("_")) for op in se3.OPS]
    assert codes == camel
    assert int(re.search(r"constexpr int kMaxDims = (\d+);", src).group(1)) == se3.MAX_DIMS
    assert float(re.search(r"constexpr double kSmallAngle = ([0-9.e-]+);", src).group(1)) == se3.SMALL_ANGLE
