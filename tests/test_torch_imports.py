"""The port must run where JAX is absent: its modules import neither jax
nor the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import gcslam_torch.models.runner, gcslam_torch.frontend.synthetic, gcslam_torch.eval.ate_rpe\n"
        "import gcslam_torch.ops.sinkhorn\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'gcslam_tpu')) and sys.modules[m]]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_do_not_reference_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcslam_tpu)\b|gcslam_tpu", re.M)
    offenders = [str(p) for p in (ROOT / "gcslam_torch").rglob("*") if p.suffix in (".py", ".cu")
                 and pattern.search(p.read_text())]
    assert not offenders, offenders
