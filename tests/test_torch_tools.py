"""The port's tools and the outputs tail against the JAX package's:
tools/make_synth_bag (the same rows, byte for byte), outputs/rerun_export
(quaternions; the SDK-less behaviour), ops/bev (the BEV15 pushforward and
the vMF rotation) and tools/view_splats' 3-D overview (the SVG's points,
colours and sizes against what the JAX viewer hands matplotlib's
scatter)."""

import pathlib
import re
import sqlite3

import numpy as np
import pytest
import torch

from gcslam_tpu.ops import bev as jbev
from gcslam_tpu.outputs import rerun_export as jrerun
from gcslam_tpu.tools import make_synth_bag as jmake, view_splats as jview
from gcslam_torch.ops import bev
from gcslam_torch.outputs import rerun_export
from gcslam_torch.tools import make_synth_bag, view_splats
from test_torch_modes import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KIMERA = str(ROOT / "configs" / "gc_kimera.yaml")


def rows(db):
    conn = sqlite3.connect(db)
    out = (list(conn.execute("SELECT * FROM topics ORDER BY id")),
           list(conn.execute("SELECT topic_id, timestamp, data FROM messages ORDER BY id")))
    conn.close()
    return out


@pytest.mark.parametrize("extra", [[], ["--no-camera", "--trajectory", "ramp", "--odom-model", "additive"]],
                         ids=["rehearsal", "ramp_no_camera"])
def test_make_synth_bag_rows_are_byte_equal(tmp_path, extra):
    """Both tools on the rehearsal's arguments (and the other choices) at
    3 scans: the same summary, topics, message rows and ground truth."""
    args = ["--config", KIMERA, "--scans", "3", "--points", "1024", "--cam-w", "160", "--cam-h", "120"] + extra
    out = {}
    for name, tool in (("torch", make_synth_bag), ("jax", jmake)):
        db, gt = str(tmp_path / f"{name}.db3"), str(tmp_path / f"{name}.tum")
        summary = tool.main(["--out", db, "--gt", gt] + args)
        out[name] = ({k: v for k, v in summary.items() if k not in ("bag", "gt")}, rows(db), open(gt).read())
    assert out["torch"] == out["jax"]
    assert len(out["jax"][1][1]) > 3 * 10


@pytest.mark.parametrize("seed", [0, 1])
def test_rotmats_to_quats_matches_jax(seed):
    """eigh eigenvector frames (a third of them improper) to quaternions."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(64, 3, 3))
    _, R = np.linalg.eigh(A @ A.transpose(0, 2, 1))
    R[::3, :, 0] *= -1.0
    np.testing.assert_allclose(rerun_export._rotmats_to_quats(R), jrerun._rotmats_to_quats(R), rtol=0, atol=1e-12)


def test_export_rrd_without_the_sdk(tmp_path):
    try:
        import rerun  # noqa: F401
        pytest.skip("the rerun SDK is installed")
    except ImportError:
        pass
    assert rerun_export.export_rrd("unused.npz", str(tmp_path / "a.rrd"), require=False) is False
    with pytest.raises(ImportError, match="rerun"):
        rerun_export.export_rrd("unused.npz", str(tmp_path / "a.rrd"))


def test_bev_matches_jax():
    rng = np.random.default_rng(0)
    P = bev.view_projections()
    np.testing.assert_array_equal(P, jbev.view_projections())
    assert P.shape == (bev.N_VIEWS, 2, 3)
    mu = rng.normal(size=(40, 3))
    A = rng.normal(size=(40, 3, 3))
    Sigma = A @ A.transpose(0, 2, 1)
    got = bev.pushforward_gaussians(*(torch.as_tensor(x) for x in (mu, Sigma, P)))
    ref = jbev.pushforward_gaussians(mu, Sigma, P)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-12)
    etas, rotvec = rng.normal(size=(40, 3, 3)), np.array([0.3, -1.2, 0.7])
    np.testing.assert_allclose(bev.rotate_vmf_etas(torch.as_tensor(etas), torch.as_tensor(rotvec)).numpy(),
                               np.asarray(jbev.rotate_vmf_etas(etas, rotvec)), rtol=0, atol=1e-12)


def test_overview_svg_draws_what_the_jax_viewer_scatters(tmp_path, monkeypatch):
    """The JAX viewer (its render stubbed: only the scatter is compared) and
    the port's viewer on one splat export of 60 primitives, the top 40 by
    mass kept: the same points, colours and marker areas, one SVG circle
    each."""
    from mpl_toolkits.mplot3d import Axes3D

    from gcslam_tpu.outputs import rendering as jrendering

    rng = np.random.default_rng(3)
    n, keep = 60, 40
    A = rng.normal(0, 0.1, (n, 3, 3))
    npz = tmp_path / "splat_export.npz"
    np.savez(npz, mu_world=rng.uniform(-4, 4, (n, 3)), Sigma_world=A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3),
             etas=rng.normal(0, 1, (n, 3, 3)), colors=rng.uniform(-0.2, 1.2, (n, 3)),
             masses=rng.permutation(np.linspace(0.5, 5.0, n)))

    scattered = []
    scatter = Axes3D.scatter

    def recording(self, xs, ys, zs, *args, c=None, s=None, **kw):
        scattered.append((np.stack([xs, ys, zs], 1), np.asarray(c), np.asarray(s)))
        return scatter(self, xs, ys, zs, *args, c=c, s=s, **kw)

    monkeypatch.setattr(Axes3D, "scatter", recording)
    monkeypatch.setattr(jrendering, "render_splats",
                        lambda *a, **k: (np.zeros((360, 480, 3), np.float32), np.zeros((360, 480), np.float32)))
    jview.main([str(npz), "--cpu", "--out", str(tmp_path / "jax"), "--max-splats", str(keep)])
    (xyz, c, s), = scattered

    paths = view_splats.main([str(npz), "--cpu", "--out", str(tmp_path / "torch"), "--max-splats", str(keep)])
    sp = np.load(npz)
    top = np.argsort(-sp["masses"], kind="stable")[:keep]
    got = view_splats.overview_points(sp["mu_world"][top], sp["colors"][top], sp["masses"][top])
    for g, r in zip(got, (xyz, c, s)):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)
    svg = open(paths["map_3d.svg"]).read()
    assert f"splat map ({n} primitives)" in svg
    fills = re.findall(r'<circle [^>]*r="([0-9.]+)" fill="#([0-9a-f]{6})"', svg)
    assert len(fills) == keep
    want = sorted("%02x%02x%02x" % tuple(int(round(255 * x)) for x in col) for col in c)
    assert sorted(f for _, f in fills) == want
    np.testing.assert_allclose(sorted(float(r) for r, _ in fills), np.sort(np.sqrt(s) / 2), rtol=0, atol=1e-3)
