"""The port's measurement tools and library tail against the JAX package's.

  - profile_step, kernel_census, warm_cache and cold_start: the report
    keys of the JAX tool less its XLA-only keys (listed here) are in the
    port's report, with values of the port's own measurement on the CPU.
    The JAX profile_step runs here with a stand-in step (its report's
    structure, not the pipeline, is compared: compiling the JAX step takes
    ~20 s); the JAX hlo_census's keys come from its census() on a small
    compiled program; warm_cache and cold_start compile the production
    programs for minutes (warm_cache also re-executes its process), so
    their keys are read from their sources;
  - microbench_scatter: every strategy at the production shapes against
    ops/binned.scatter_accumulate (rtol 1e-6 on its sums, elementwise for
    the scatters), and the checksums against the JAX tool's run on the
    CPU;
  - the library tail (ops/se3, ops/linalg, models/belief.from_moments,
    frontend/rosbag.cdrless_rotvec) against the JAX functions at 1e-12 in
    float64 on seeded inputs.
"""

import contextlib
import io
import json
import pathlib
import re
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcslam_tpu.frontend import rosbag as jrosbag
from gcslam_tpu.models import belief as jbelief
from gcslam_tpu.ops import linalg as jlinalg, se3 as jse3
from gcslam_tpu.tools import hlo_census as jhlo, microbench_scatter as jmicro, profile_step as jprofile
from gcslam_torch.frontend import rosbag
from gcslam_torch.models import belief
from gcslam_torch.models.config import PipelineConfig
from gcslam_torch.ops import binned, linalg, se3
from gcslam_torch.tools import cold_start, kernel_census, microbench_scatter, profile_step, warm_cache
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_TOOLS = ROOT / "gcslam_tpu" / "tools"
SMALL = dict(with_map=True, atlas_max_tiles=8, m_tile=64, m_tile_view=32, n_surfel=64, surfel_voxel_size_m=0.5)
# the JAX tools' keys that read XLA's compiled program or its cache, with
# no counterpart for an eager step
XLA_ONLY = {
    "profile_step": {"lower_s", "compile_s", "cost_analysis", "memory_analysis", "hlo_top_ops"},
    "hlo_census": {"computations", "total_instructions", "body", "body_instructions", "body_opcodes_top20",
                   "body_fusions", "body_copies", "body_copy_bytes", "body_scalar_ops", "body_called_computations",
                   "fusion_sizes_top10", "fusion_size_median", "hlo_path"},
    "warm_cache": {"cache_dir", "cache_entries", "scans", "replay_s", "camera_replay_s"},
    "cold_start": set(),
}
# the port's counterparts of those keys
PORT_FOR_XLA = {
    "profile_step": {"first_scan_s", "compute", "top_kernels"},
    "hlo_census": {"launch_calls_per_scan", "device_kernels_per_scan", "kernel_families_top20", "d2d_copies",
                   "d2d_copy_bytes", "scalar_output_launches", "top_functions"},
    "warm_cache": {"libraries", "native_builds"},
    "cold_start": {"native_builds"},
}
SCATTER_RTOL = 1e-6
F64_TOL = 1e-12


def _source_keys(name: str, pattern: str) -> set:
    return set(re.findall(pattern, (JAX_TOOLS / f"{name}.py").read_text(), re.S))


class _Out(NamedTuple):
    pose: jnp.ndarray


def test_profile_step_report(monkeypatch):
    from gcslam_tpu.models import scan_step as jscan_step

    monkeypatch.setattr(jscan_step, "scan_step", lambda s, b, cfg: (s, _Out(pose=b.odom_pose)))
    with contextlib.redirect_stdout(io.StringIO()):
        jrep = jprofile.main(["--cpu", "--no-map", "--steps", "1", "--points", "64"])
        rep = profile_step.main(["--cpu", "--no-map", "--steps", "1", "--points", "256"])
    assert set(jrep) - XLA_ONLY["profile_step"] <= set(rep)
    assert PORT_FOR_XLA["profile_step"] <= set(rep)
    assert rep["device"] == "cpu" and rep["finite"] is True and rep["timing"]["n"] == 1
    assert set(rep["compute"]) == {"matmul_flops", "argument_bytes", "output_bytes", "peak_allocated_bytes",
                                   "peak_above_start_bytes"}
    assert rep["compute"]["matmul_flops"] > 0 and rep["compute"]["peak_allocated_bytes"] is None
    assert len(rep["top_kernels"]) == profile_step.TOP_KERNELS and rep["first_scan_s"] > 0
    assert rep["lie_launches_per_scan"] == {"eager": {}, "graph": None}


def test_kernel_census_report():
    hlo = jax.jit(lambda x: jnp.sin(x) @ x.T).lower(jnp.ones((4, 4))).compile().as_text()
    jkeys = set(jhlo.census(hlo)) | _source_keys("hlo_census", r'rep\["(\w+)"\]')
    with contextlib.redirect_stdout(io.StringIO()):
        rep = kernel_census.main(["--cpu", "--scans", "2", "--points", "256"]
                                 + [f"--set={k}={json.dumps(v)}" for k, v in SMALL.items()])
    assert jkeys - XLA_ONLY["hlo_census"] <= set(rep)
    assert PORT_FOR_XLA["hlo_census"] <= set(rep)
    assert rep["backend"] == "cpu" and rep["program"] == "step" and rep["profiled_scans"] == 1
    assert rep["launch_calls_per_scan"] is None and rep["device_kernels_per_scan"] is None
    assert rep["lie_launches_by_op"] == {}
    assert 0 < rep["scalar_output_ops"] < rep["aten_ops"]
    top = rep["top_functions"]
    assert len(top) == kernel_census.TOP_FUNCTIONS
    assert [r["aten_ops"] for r in top] == sorted((r["aten_ops"] for r in top), reverse=True)
    assert all(re.fullmatch(r"gcslam_torch/\S+\.py:\w+", r["function"]) and r["launches"] is None for r in top)
    assert not any(r["function"].startswith(kernel_census.OWN_FRAMES) for r in top)
    assert sum(r["aten_ops"] for r in top) <= rep["aten_ops"]


class _Event:
    """A raw profiler event with the accessors the census reads."""

    def __init__(self, name, cuda, start, dur, corr, linked=0):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if cuda else DeviceType.CPU, start, dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[0].startswith(kernel_census.MARK)


def test_kernel_census_joins_the_card_trace_to_ops():
    """The census's device columns on a trace of two marked ops: a launch
    is its op's whose range holds it, device activity the op it links to;
    a launch outside every range is counted but not attributed, the
    ranges' device-side annotations are no activity, and the copy's bytes
    are its op's outputs'."""
    import collections
    from types import SimpleNamespace

    M = kernel_census.MARK
    events = [
        _Event(f"{M}0", False, 0, 100, 1), _Event("aten::mul", False, 10, 50, 10),
        _Event("cudaLaunchKernel", False, 20, 5, 500, 10), _Event("void at::k<float>(int)", True, 1000, 5000, 500, 10),
        _Event(f"{M}0", True, 1000, 5000, 2),
        _Event(f"{M}1", False, 200, 100, 3), _Event("aten::copy_", False, 210, 50, 11),
        _Event("cudaMemcpyAsync", False, 220, 5, 501, 11), _Event("cuLaunchKernel", False, 230, 5, 502, 11),
        _Event("Memcpy DtoD (Device -> Device)", True, 7000, 1000, 501, 11),
        _Event("cudaLaunchKernel", False, 500, 5, 503, 0),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))
    marks = SimpleNamespace(caller=["gcslam_torch/a.py:f", "gcslam_torch/b.py:g"], scalar=[False, True],
                            out_bytes=[400, 8])
    rows = collections.defaultdict(lambda: {"aten_ops": 0, "launches": 0, "device_us": 0.0})
    got = kernel_census._device_columns(prof, marks, rows)
    assert got == dict(launch_calls_per_scan=3, scalar_output_launches=1, device_kernels_per_scan=1,
                       kernel_families_top20={"k": 1}, d2d_copies=1, d2d_copy_bytes=8, device_us=6.0,
                       attributed_launches=2)
    assert rows["gcslam_torch/a.py:f"] == {"aten_ops": 0, "launches": 1, "device_us": 5.0}
    assert rows["gcslam_torch/b.py:g"] == {"aten_ops": 0, "launches": 1, "device_us": 1.0}
    assert rows["(outside the step's ops)"]["launches"] == 1


def test_profile_record_counts_the_raw_trace():
    """profile_record's fields from a trace's raw events: the host's launch
    calls (a cluster launch among them) and graph launches, the device's
    kernels (copies and sets left out, and no record_function annotation)
    and its busy time, the union of its records (the copy that overlaps a
    kernel counts once)."""
    from gcslam_torch.utils import cuda_profile

    events = [_Event("cudaLaunchKernel", False, 0, 5, 1), _Event("cudaLaunchKernelExC", False, 10, 5, 2),
              _Event("cudaMemcpyAsync", False, 20, 5, 3), _Event("aten::add", False, 0, 50, 4),
              _Event("cudaGraphLaunch", False, 30, 5, 6),
              _Event("void k<float>()", True, 100, 2000, 1, 4), _Event("sinkhorn_kernel<double, 8>", True, 3000, 6000, 2),
              _Event("Memcpy DtoD (Device -> Device)", True, 8000, 1000, 3),
              _Event(f"{kernel_census.MARK}0", True, 100, 9000, 5)]
    got = cuda_profile.record(events, span_ms=20.0, n=2)
    assert got == dict(launch_calls_per_scan=1.0, graph_launches_per_scan=0.5, device_kernels_per_scan=1.0,
                       device_busy_ms_per_scan=0.004, profiled_span_ms_per_scan=10.0,
                       device_busy_share=0.008 / 20.0)


def test_kernel_census_family():
    assert kernel_census.family("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<double>, "
                                "at::detail::Array<char*, 3> >(int, AddFunctor<double>, Array<char*, 3>)") \
        == "vectorized_elementwise_kernel"
    assert kernel_census.family("sinkhorn_kernel<double, 8>") == "sinkhorn_kernel"
    assert kernel_census.family(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(anonymous "
        "namespace)::OpaqueType<8u>, unsigned int, 1, 128, 1, 16>(at::native::(anonymous namespace)::OpaqueType<8u>*, "
        "int, unsigned int)") == "CatArrayBatchedCopy_alignedK_contig"
    assert kernel_census.family("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, double>"
                                "(internal::gemvx::Params<int, double>)") == "kernel"
    assert kernel_census.family("sm90_xmma_gemm_f64f64_cublas") == "sm90_xmma_gemm_f64f64_cublas"


def test_warm_cache_cpu():
    report_literal = _source_keys("warm_cache", r"report = \{(.*?)\}").pop()
    jkeys = ({f"{k}_s" for k in _source_keys("warm_cache", r'warm\("(\w+)"')}
             | set(re.findall(r'"(\w+)":', report_literal)) | _source_keys("warm_cache", r'report\["(\w+)"\]'))
    assert {"step_s", "chunked_s", "camera_step_s", "device", "chunk"} <= jkeys
    rep = warm_cache.warm(PipelineConfig(**SMALL), torch.device("cpu"), chunk=3, camera=True, n_points=256)
    assert jkeys - XLA_ONLY["warm_cache"] <= set(rep)
    assert PORT_FOR_XLA["warm_cache"] <= set(rep)
    assert set(rep["libraries"]) == {"bag_decode"}  # --cpu builds the host library alone
    lib = rep["libraries"]["bag_decode"]
    assert isinstance(lib["already_built"], bool) and lib["s"] >= 0 and lib["path"].startswith("libbag_decode_")
    assert rep["step_s"] > 0 and rep["chunked_s"] > 0 and rep["native_builds"] >= 0


def test_warm_cache_needs_the_card():
    """Without --cpu the tool builds the kernels for the card: where there is
    none it raises."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        warm_cache.main([])


def test_cold_start_cpu_child():
    """One fresh child on the CPU: milestones in increasing order, nothing
    built before its first pose."""
    jkeys = _source_keys("cold_start", r'(?:m|report)\["(\w+)"\]') - {"warm_cache_s", "warm_cache_rc", "stderr_tail"}
    rep = cold_start.measure(cpu=True, skip_warm=True, config=SMALL, n_points=256, n_scans=3)
    assert rep["rc"] == 0, rep.get("stderr_tail")
    assert jkeys - XLA_ONLY["cold_start"] <= set(rep)
    milestones = [rep[k] for k in ("import_done", "data_ready", "first_pose_s", "chunk_pose_s")]
    assert milestones == sorted(milestones) and milestones[0] > 0
    assert rep["fresh_process_wall_s"] >= rep["chunk_pose_s"]
    assert rep["native_builds"] == 0 and rep["device"] == "cpu"


def test_cold_start_writes_only_its_json(monkeypatch, tmp_path):
    """The report goes to --json PATH alone: no file in the repository root
    (the JAX tool writes COLDSTART_r05.json there by default)."""
    monkeypatch.setattr(cold_start, "measure", lambda cpu, skip_warm: {"rc": 0, "first_pose_s": 1.0})
    before = set(p.name for p in ROOT.iterdir())
    with contextlib.redirect_stdout(io.StringIO()):
        assert cold_start.main(["--skip-warm"]) == 0
        assert cold_start.main(["--skip-warm", "--json", str(tmp_path / "c.json")]) == 0
    assert json.load(open(tmp_path / "c.json")) == {"rc": 0, "first_pose_s": 1.0}
    assert set(p.name for p in ROOT.iterdir()) == before


@pytest.fixture(scope="module")
def scatter():
    return {r["name"]: r for r in microbench_scatter.run(torch.device("cpu"), reps=1)}


def test_microbench_scatter_against_scatter_accumulate(scatter):
    """Every strategy against the production route on the same draws, at
    rtol 1e-6: its checksum, and its output elementwise; the strategies
    that sum a bin's rows in another order (the unstable argsort, the
    matmuls) elementwise at 1e-6 of the output's scale, since a bin whose
    rows nearly cancel has no relative precision."""
    sh = microbench_scatter.SHAPES
    xs = microbench_scatter.inputs(torch.device("cpu"), **sh)
    ref = {"TM": binned.scatter_accumulate(xs["idx_tm"], xs["payload"], sh["TM"]),
           "pool": binned.scatter_accumulate(xs["idx_p"], xs["payload"], sh["P"]),
           "surfel": binned.scatter_accumulate(xs["idx_s"], xs["pay_s"], sh["CS"])}
    target = {"nine_narrow_scatters_TM": "TM", "one_packed_scatter_TM": "TM", "one_packed_scatter_pool": "pool",
              "binned_matmul_pool": "pool", "sorted_packed_scatter_TM": "TM", "surfel_moment_scatter": "surfel",
              "surfel_moment_matmul": "surfel", "binned_scatter_accumulate_TM": "TM",
              "binned_scatter_accumulate_surfel": "surfel"}
    assert set(scatter) == set(target)
    for name, r in scatter.items():
        want = ref[target[name]]
        np.testing.assert_allclose(r["checksum"], float(want.double().sum()), rtol=SCATTER_RTOL, err_msg=name)
        if name != "nine_narrow_scatters_TM":  # its output is the sum of its nine outputs' sums
            reordered = "matmul" in name or "sorted" in name
            atol = SCATTER_RTOL * float(want.abs().max()) if reordered else 0.0
            np.testing.assert_allclose(r["out"].numpy(), want.numpy(), rtol=SCATTER_RTOL, atol=atol, err_msg=name)
        assert r["ms"] > 0


def test_microbench_scatter_checksums_match_jax(scatter):
    """The JAX tool on the CPU at the same shapes (~3 s): the same seven
    names, checksums equal to the three decimals it prints."""
    buf = io.StringIO()
    cache = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        with contextlib.redirect_stdout(buf):
            jmicro.main(["--cpu", "--reps", "1"])
    finally:  # the JAX tool points the compile cache at the repository's
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    jrows = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
    jchk = {r["name"]: r["checksum"] for r in jrows if "name" in r}
    assert len(jchk) == 7 and set(jchk) <= set(scatter)
    for name, chk in jchk.items():
        assert abs(scatter[name]["checksum"] - chk) <= 1e-3, (name, scatter[name]["checksum"], chk)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _near(ref, got, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=F64_TOL, atol=F64_TOL, err_msg=name)


def _tail_inputs():
    rng = np.random.default_rng(7)
    phi = rng.normal(size=(32, 3))
    phi[0] = 0.0
    phi[1] *= 1e-6  # under the Taylor thresholds
    phi[2] *= 3e-5
    phi[3] = np.pi * phi[3] / np.linalg.norm(phi[3])
    poses = np.concatenate([rng.normal(size=(32, 3)), phi], axis=1)
    deltas = np.concatenate([rng.normal(size=(32, 3)), 0.3 * rng.normal(size=(32, 3))], axis=1)
    A = rng.normal(size=(32, 6, 6))
    covs = A @ np.swapaxes(A, -1, -2) + 1e-3 * np.eye(6)
    return rng, phi, poses, deltas, covs


def test_se3_tail_matches_jax():
    rng, phi, poses, deltas, covs = _tail_inputs()
    W = rng.normal(size=(32, 3, 3))
    pts = rng.normal(size=(32, 50, 3))
    cases = {
        "vee": (jse3.vee(W), se3.vee(_t(W))),
        "so3_right_jacobian": (jse3.so3_right_jacobian(phi), se3.so3_right_jacobian(_t(phi))),
        "so3_right_jacobian_inv": (jse3.so3_right_jacobian_inv(phi), se3.so3_right_jacobian_inv(_t(phi))),
        "se3_plus": (jse3.se3_plus(poses, deltas), se3.se3_plus(_t(poses), _t(deltas))),
        "se3_minus": (jse3.se3_minus(poses, deltas), se3.se3_minus(_t(poses), _t(deltas))),
        "se3_adjoint": (jse3.se3_adjoint(poses), se3.se3_adjoint(_t(poses))),
        "se3_cov_compose": (jse3.se3_cov_compose(covs, covs[::-1], poses),
                            se3.se3_cov_compose(_t(covs), _t(covs[::-1].copy()), _t(poses))),
        "apply_pose_to_points": (jse3.apply_pose_to_points(poses, pts), se3.apply_pose_to_points(_t(poses), _t(pts))),
    }
    for name, (ref, got) in cases.items():
        _near(ref, got, name)
    ident = se3.se3_identity()
    assert ident.dtype == torch.float64 and torch.equal(ident, torch.zeros(6, dtype=torch.float64))
    _near(jse3.se3_identity(), ident, "se3_identity")
    assert se3.se3_identity(torch.float32).dtype == torch.float32


def test_linalg_tail_matches_jax():
    rng = np.random.default_rng(11)
    m = np.concatenate([rng.normal(size=20), [0.0, -1e-9, -3.0]])
    for got, ref in zip(linalg.inv_mass(_t(m)), jlinalg.inv_mass(jnp.asarray(m))):
        _near(ref, got, "inv_mass")
    for got, ref in zip(linalg.clamp(_t(m), -0.5, 0.7), jlinalg.clamp(jnp.asarray(m), -0.5, 0.7)):
        _near(ref, got, "clamp")


def test_from_moments_matches_jax():
    rng = np.random.default_rng(13)
    for k in range(3):
        A = rng.normal(size=(22, 22))
        cov = A @ A.T / 22 + (1e-3 if k < 2 else 1.0) * np.eye(22)
        if k == 2:
            cov[0, 1] += 0.5  # asymmetric: the projection symmetrizes
        mean, X = rng.normal(size=22), rng.normal(size=6)
        ref = jbelief.from_moments(X, mean, cov, 1.5)
        got = belief.from_moments(_t(X), _t(mean), _t(cov), torch.tensor(1.5, dtype=torch.float64))
        for f in belief.Belief._fields:
            r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            scale = max(1.0, np.abs(r).max())
            np.testing.assert_allclose(g, r, rtol=0, atol=F64_TOL * scale, err_msg=f)


def test_cdrless_rotvec_matches_jax():
    rng = np.random.default_rng(17)
    for rv in list(rng.normal(size=(20, 3))) + [np.zeros(3), np.array([1e-11, 0, 0])]:
        R = jrosbag._rotvec_R(rv)
        np.testing.assert_array_equal(rosbag.cdrless_rotvec(R), jrosbag.cdrless_rotvec(R))
