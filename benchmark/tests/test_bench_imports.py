"""The import rule, by whole top-level module names."""

from benchmark import guard


def test_sources_import_no_jax_and_the_reference_none_of_the_program():
    assert guard.source_violations() == []


def test_names_are_compared_whole():
    mods = ["gcslam_torch", "gcslam_torch.models.runner", "jaxtyping", "flaxen", "numpy"]
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(mods + ["jax.numpy", "gcslam_tpu.ops", "jaxlib"]) == ["gcslam_tpu.ops", "jax.numpy",
                                                                                      "jaxlib"]
    assert guard.forbidden_loaded(["gcslam_torch.ops"], guard.REFERENCE_FORBIDDEN) == ["gcslam_torch.ops"]


def test_a_planted_import_is_found(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "a.py").write_text("import gcslam_torch.models\nimport jaxtyping\n")
    (tmp_path / "reference" / "b.py").write_text("from gcslam_torch.ops import se3\n")
    (tmp_path / "c.py").write_text("import importlib\nimportlib.import_module('jax.numpy')\n")
    assert sorted(guard.source_violations(str(tmp_path))) == ["c.py: jax.numpy", "reference/b.py: gcslam_torch.ops"]


def test_the_harness_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness, benchmark.reference.check, "
            "benchmark.drivers.live, benchmark.drivers.bag, benchmark.drivers.replay; "
            "from benchmark import guard; print(guard.forbidden_loaded(sys.modules))") % guard.BENCH_DIR.rsplit("/", 1)[0]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
