"""The import rule: nothing the benchmark loads is JAX or the JAX package,
and the plain reference loads nothing of the program either. Modules are
compared by their whole top-level name (the part before the first dot):
the program's name, gcslam_torch, begins with the JAX package's."""

from __future__ import annotations

import ast
import os
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gcslam_tpu"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"gcslam_torch"}
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str], forbidden=FORBIDDEN) -> List[str]:
    """The names among `modules` (e.g. sys.modules) whose top-level name is forbidden."""
    return sorted(m for m in modules if top(m) in forbidden)


def imported_names(path: str) -> List[str]:
    """Every module a source file imports (absolute imports; a relative
    import stays inside the benchmark)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            out.append(node.args[0].value)
    return out


def source_violations(bench_dir: str = BENCH_DIR) -> List[str]:
    """`file: module` for each forbidden import in the benchmark's sources."""
    bad = []
    for dirpath, dirnames, filenames in os.walk(bench_dir):
        dirnames[:] = [d for d in dirnames if not d.startswith(".") and d != "__pycache__"]
        rel_dir = os.path.relpath(dirpath, bench_dir)
        in_ref = rel_dir == "reference" or rel_dir.startswith("reference" + os.sep)
        forbidden = REFERENCE_FORBIDDEN if in_ref else FORBIDDEN
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                bad += [f"{os.path.relpath(path, bench_dir)}: {m}" for m in imported_names(path)
                        if top(m) in forbidden]
    return bad
