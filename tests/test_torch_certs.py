"""The certificate layer (ops/certs.py) held to a plain field-by-field
version written here: make_cert, aggregate, scrub, total_trigger_magnitude
and the step's NaN check (certs.finite) on batch shapes (), (K,) and 0-d
mixed with (K,); NaN and +-inf in each float field of one certificate,
planted through make_cert and through _replace after it; trigger bits 0
and 35; the cached constants left unwritten by a scan; and the count of
aten ops the certificate layer dispatches in a scan."""

import collections
import inspect
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gcslam_torch.ops import certs as CT
from gcslam_torch.utils.dtypes import BELIEF_DTYPE

K = 4
SMALL = dict(with_map=True, atlas_max_tiles=16, m_tile=128, m_tile_view=64, n_surfel=128, surfel_voxel_size_m=0.5)
MIN = ("exact", "eig_min", "dt_scale", "ex_scale", "trust_alpha", "power_beta")
MAX = ("frobenius_applied", "eig_max", "cond", "anchor_drift_rho")
MEAN = ("ess_total", "support_frac", "directional_score")
# the most the certificate layer may dispatch in one scan (~2,900 when it
# went field by field)
MAX_CERT_OPS_PER_SCAN = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the plain field-by-field version


DEFAULTS = {f: p.default for f, p in inspect.signature(CT.make_cert).parameters.items()}


def plain_make_cert(triggers=0, **kw):
    out = {}
    for f in CT.FLOAT_FIELDS:
        v = bin(int(triggers)).count("1") if f == "n_triggers" else kw.get(f, DEFAULTS[f])
        out[f] = v.to(BELIEF_DTYPE) if isinstance(v, torch.Tensor) else torch.full((), float(v), dtype=BELIEF_DTYPE)
    return CT.Cert(triggers=torch.full((), int(triggers), dtype=torch.int64), **out)


def plain_aggregate(certs):
    def stk(f):
        return torch.stack(torch.broadcast_tensors(*[getattr(c, f) for c in certs]))

    out = {}
    for f in CT.FLOAT_FIELDS:
        s = stk(f)
        out[f] = (s.amin(0) if f in MIN else s.amax(0) if f in MAX
                  else s.sum(0) / float(len(certs)) if f in MEAN else s.sum(0))
    mask = stk("triggers")
    m = mask[0]
    for x in mask[1:]:
        m = m | x
    return CT.Cert(triggers=m, **out)


def plain_scrub(c):
    return c._replace(**{f: torch.nan_to_num(getattr(c, f), nan=0.0, posinf=0.0, neginf=0.0)
                         for f in CT.FLOAT_FIELDS})


def plain_total(certs):
    def mag(c):
        return (c.lift_strength + c.psd_projection_delta + c.nu_projection_delta + c.mass_epsilon_ratio
                + c.anchor_drift_rho + (1.0 - c.dt_scale).abs() + (1.0 - c.ex_scale).abs()
                + (1.0 - c.trust_alpha).abs() + (1.0 - c.power_beta).abs())

    out = mag(certs[0])
    for c in certs[1:]:
        out = out + mag(c)
    return out


def plain_finite(certs):
    ok = torch.ones((), dtype=torch.bool)
    for c in certs:
        for f in CT.FLOAT_FIELDS:
            ok = ok & ~torch.isnan(getattr(c, f))
    return ok


# --- cases


def _value(rng, shape, lo=0.1, hi=3.0):
    return torch.empty(shape, dtype=BELIEF_DTYPE).uniform_(lo, hi, generator=rng)


def _kwargs(rng, layout, i):
    """make_cert's arguments for certificate i: Python numbers and 0-d
    tensors ("scalar"), (K,) tensors ("batched"), or both ("mixed")."""
    bits = [CT.TRIGGERS["linearization"], CT.TRIGGERS["approx_selection"], CT.TRIGGERS["MomentToInfo"], 0][i % 4]
    kw = dict(exact=bool(i % 2), triggers=bits)
    fields = [f for f in CT.FLOAT_FIELDS if f != "n_triggers"]
    for j, f in enumerate(fields):
        if layout != "batched" and (i + j) % 3 == 0:
            continue  # the default
        shape = {"scalar": (), "batched": (K,), "mixed": (K,) if (i + j) % 2 else ()}[layout]
        if layout != "batched" and (i + j) % 5 == 1:
            kw[f] = float(_value(rng, ()))  # a Python number
        else:
            kw[f] = _value(rng, shape)
    return kw


def _certs(layout, n=6, seed=0):
    rng = torch.Generator().manual_seed(seed)
    kws = [_kwargs(rng, layout, i) for i in range(n)]
    return [CT.make_cert(**kw) for kw in kws], [plain_make_cert(**kw) for kw in kws]


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert torch.equal(a, b) or (torch.isnan(a) == torch.isnan(b)).all() and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b)), (a, b)


def _ulps(a, b, n=4):
    """a within n ulps of b (b's magnitude), NaN and inf where b has them."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    fin = torch.isfinite(b)
    assert torch.equal(a[~fin].nan_to_num(), b[~fin].nan_to_num())
    assert torch.all((a[fin] - b[fin]).abs() <= n * torch.finfo(b.dtype).eps * b[fin].abs()), (a, b)


def _held(got, want):
    for f in CT.Cert._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f in MIN + MAX + ("triggers",):
            _same(a, b)
        else:
            _ulps(a, b)


LAYOUTS = ["scalar", "batched", "mixed"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_cert_is_the_plain_certificate(layout):
    for got, want in zip(*_certs(layout)):
        for f in CT.Cert._fields:
            _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_aggregate_is_the_plain_aggregate(layout):
    certs, plain = _certs(layout)
    want = plain_aggregate(plain)
    _held(CT.aggregate(certs), want)
    _held(CT.aggregate(CT.stack(certs)), want)
    # a stack joined from pieces aggregates as the whole list
    _held(CT.aggregate(CT.cat([CT.stack(certs[:2]), CT.stack(certs[2:5]), CT.stack(certs[5:])])), want)
    _held(CT.scrub(CT.aggregate(certs)), plain_scrub(want))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_total_trigger_magnitude_is_the_plain_fold(layout):
    certs, plain = _certs(layout)
    want = plain_total(plain)
    _same(CT.total_trigger_magnitude(certs), want)
    _same(CT.total_trigger_magnitude(CT.stack(certs)), want)
    # a fold continued over the rest is the fold over the whole list
    head = CT.total_trigger_magnitude(certs[:4])
    _same(CT.total_trigger_magnitude(CT.stack(certs[4:]), start=head), want)
    _same(CT.trigger_magnitude(certs[1]), plain_total(plain[1:2]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_finite_is_the_plain_check(layout):
    certs, plain = _certs(layout)
    got = CT.finite(CT.stack(certs))
    want = plain_finite(plain)
    assert torch.equal(got, want.expand(got.shape)) and got.all()


# n_triggers is no argument of make_cert (it counts the mask's bits): _replace alone plants it
PLANTED = [(f, how) for f in CT.FLOAT_FIELDS for how in ("make_cert", "replace")
           if not (f == "n_triggers" and how == "make_cert")]


@pytest.mark.parametrize("value", [float("nan"), float("inf"), -float("inf")], ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("field,how", PLANTED)
def test_a_nonfinite_field_is_caught_and_scrubbed(field, how, value):
    """One certificate of a mixed list carries the value in one field: the
    NaN check flags NaN alone, scrub zeroes it, the reductions keep it where
    the plain version does."""
    rng = torch.Generator().manual_seed(3)
    kws = [_kwargs(rng, "mixed", i) for i in range(5)]
    if how == "make_cert":
        kws[2][field] = value
    certs = [CT.make_cert(**kw) for kw in kws]
    plain = [plain_make_cert(**kw) for kw in kws]
    if how == "replace":
        bad = torch.full((K,), value, dtype=BELIEF_DTYPE)
        certs[2] = certs[2]._replace(**{field: bad})
        plain[2] = plain[2]._replace(**{field: bad})
    st = CT.stack(certs)
    got = CT.finite(st)
    want = plain_finite(plain)
    assert torch.equal(got, want.expand(got.shape))
    assert bool(got.any()) is not (value != value)  # NaN alone is caught
    _held(CT.aggregate(st), plain_aggregate(plain))
    _held(CT.scrub(CT.aggregate(st)), plain_scrub(plain_aggregate(plain)))
    _held(CT.scrub(certs[2]), plain_scrub(plain[2]))
    _same(CT.total_trigger_magnitude(st), plain_total(plain))


@pytest.mark.parametrize("bit", [0, 35])
def test_trigger_bits_round_trip(bit):
    """Bit 0 and bit 35 (approx_selection, above float32's 2^24) through
    make_cert, with_triggers, a (K,) mask set by _replace, aggregate and
    scrub: int64 all the way, every bit kept."""
    name = CT.TRIGGER_NAMES[bit]
    c = CT.make_cert(triggers=1 << bit)
    assert c.triggers.dtype == torch.int64 and int(c.triggers) == 1 << bit and float(c.n_triggers) == 1.0
    assert CT.decode_triggers(int(c.triggers)) == [name]
    other = CT.with_triggers(CT.make_cert(), CT.TRIGGERS["mass_drop"])
    per_hyp = CT.make_cert(eig_min=torch.zeros(K, dtype=BELIEF_DTYPE))._replace(
        triggers=torch.tensor([0, 1 << bit, 0, 1 << bit], dtype=torch.int64))
    st = CT.stack([c, other, per_hyp])
    assert st.triggers.dtype == torch.int64
    agg = CT.scrub(CT.aggregate(st))
    assert agg.triggers.dtype == torch.int64 and agg.triggers.shape == (K,)
    assert all(CT.decode_triggers(int(m)) == sorted({name, "mass_drop"}, key=CT.TRIGGER_NAMES.index)
               for m in agg.triggers)
    _same(agg.triggers, plain_aggregate([c, other, per_hyp]).triggers)


def test_shapes_follow_the_plain_rule():
    """Each reduction has the shape of the field-by-field rule: a field that
    is 0-d in every certificate stays 0-d beside (K,) fields, (1, K) and
    (K, 1) broadcast as they do."""
    a = CT.make_cert(eig_min=torch.ones(1, K, dtype=BELIEF_DTYPE), cond=torch.ones(K, 1, dtype=BELIEF_DTYPE))
    b = CT.make_cert(lift_strength=torch.ones(K, dtype=BELIEF_DTYPE))
    agg, want = CT.aggregate([a, b]), plain_aggregate([a, b])
    for f in CT.Cert._fields:
        assert getattr(agg, f).shape == getattr(want, f).shape, f
    assert CT.total_trigger_magnitude([a, b]).shape == plain_total([a, b]).shape == (K,)
    assert CT.total_trigger_magnitude([CT.make_cert(), a]).shape == ()


def test_aggregate_refuses_an_empty_list():
    with pytest.raises(ValueError):
        CT.aggregate([])


class _Writes(TorchDispatchMode):
    """Records the storages that in-place or out= ops write into."""

    def __init__(self):
        super().__init__()
        self.written = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a, x in zip(func._schema.arguments, list(args) + [kwargs.get(a.name) for a in
                                                              func._schema.arguments[len(args):]]):
            if a.alias_info is not None and a.alias_info.is_write and isinstance(x, torch.Tensor):
                self.written.add(x.untyped_storage().data_ptr())
        return func(*args, **kwargs)


def test_a_scan_writes_into_no_cached_constant(monkeypatch):
    """Every constant make_cert hands out in a scan (the default row, the
    numbers and masks by value) still holds its value after the scan, and
    no op of the scan wrote into its storage."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import scan_step

    handed = []
    for name in ("_default_fields", "_number", "_mask"):
        real = getattr(CT, name)

        def spy(*a, _real=real, _name=name):
            out = _real(*a)
            handed.append((_name, a[0], out))
            return out

        monkeypatch.setattr(CT, name, spy)
    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=3, n_points=512), device="cpu")
    with torch.no_grad():
        state, _ = runner.run_bag(run.batches[:2], cfg, device="cpu")
        handed.clear()
        with _Writes() as w:
            scan_step(state, run.batches[2], cfg)
    assert {name for name, _, _ in handed} == {"_default_fields", "_number", "_mask"}
    cached = [x for _, _, out in handed for x in (out if isinstance(out, tuple) else (out,))]
    assert not {x.untyped_storage().data_ptr() for x in cached} & w.written
    plain = plain_make_cert()
    for name, key, out in handed:
        if name == "_default_fields":
            assert all(torch.equal(x, getattr(plain, f)) for f, x in zip(CT.FLOAT_FIELDS, out))
        elif name == "_mask":
            assert int(out) == key
        else:
            assert torch.equal(out, torch.tensor(float.fromhex(key), dtype=BELIEF_DTYPE)) or key == "nan"


def test_the_certificate_layer_dispatches_few_ops_a_scan():
    """The aten ops dispatched from ops/certs.py (make_cert, the stacks,
    the NaN check, aggregate, scrub, the trigger magnitudes) and the isnan
    ops of scan_step.py (a NaN check written there) in one scan of the
    flagship path at test budgets: at most MAX_CERT_OPS_PER_SCAN, so that
    no field-by-field loop comes back unseen."""
    from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
    from gcslam_torch.models import runner
    from gcslam_torch.models.config import PipelineConfig
    from gcslam_torch.models.scan_step import scan_step
    from gcslam_torch.tools.kernel_census import _caller

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_caller = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            where = _caller().split(":")[0]
            if where == "gcslam_torch/ops/certs.py" or (
                    where == "gcslam_torch/models/scan_step.py" and func is torch.ops.aten.isnan.default):
                self.by_caller[where] += 1
            return func(*args, **(kwargs or {}))

    cfg = PipelineConfig(**SMALL)
    run = generate(SyntheticConfig(n_scans=3, n_points=512), device="cpu")
    with torch.no_grad():
        state, _ = runner.run_bag(run.batches[:2], cfg, device="cpu")
        with Ops() as ops:
            scan_step(state, run.batches[2], cfg)
    n = sum(ops.by_caller.values())
    assert 0 < n <= MAX_CERT_OPS_PER_SCAN, ops.by_caller


_F32 = r"""
import torch
from gcslam_torch.utils.dtypes import BELIEF_DTYPE
from gcslam_torch.ops import certs as CT
from gcslam_torch.frontend.synthetic import SyntheticConfig, generate
from gcslam_torch.models import runner
from gcslam_torch.models.config import PipelineConfig
assert BELIEF_DTYPE == torch.float32
top = CT.TRIGGERS["approx_selection"] | CT.TRIGGERS["MomentToInfo"]
c = CT.make_cert(triggers=top, cond=torch.ones(4))
st = CT.stack([c, CT.make_cert(triggers=CT.TRIGGERS["mass_drop"])])
agg = CT.scrub(CT.aggregate(st))
assert st.values.dtype == torch.float32 and st.triggers.dtype == torch.int64
assert agg.triggers.dtype == torch.int64 and int(agg.triggers) == top | CT.TRIGGERS["mass_drop"]
cfg = PipelineConfig(with_map=False)
_, out = runner.run_bag(generate(SyntheticConfig(n_scans=3, n_points=256), device="cpu").batches, cfg,
                        device="cpu")
assert out.tape.cert_triggers.dtype == torch.int64 and out.tape.cert_n_triggers.dtype == torch.float32
print("ok")
"""


def test_the_mask_stays_int64_in_the_float32_belief_mode():
    out = subprocess.run([sys.executable, "-c", _F32], capture_output=True, text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, GCSLAM_BELIEF_DTYPE="float32"))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-3000:]
