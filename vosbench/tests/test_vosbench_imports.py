"""Nothing under vosbench/ loads JAX or the JAX package, and the plain
reference loads nothing of the port: import statements by top-level name,
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "semi_supervised_vos_tpu"}
PORT = "semi_supervised_vos_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    found = {(str(f.relative_to(BENCH)), name) for f in files for name in top_level_imports(f) if name in JAX_SIDE}
    assert not found


def test_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    found = {(str(f.relative_to(BENCH)), name) for f in files for name in top_level_imports(f)
             if name not in ("vosbench", "numpy", "torch", "typing", "contextlib", "__future__")}
    assert not found


def test_top_level_comparison_is_whole():
    from vosbench.run import FORBIDDEN, forbidden_modules

    assert PORT.split(".")[0] not in FORBIDDEN
    assert "semi_supervised_vos_tpu" in FORBIDDEN
    assert all(name != "semi_supervised_vos_tpu" for name in forbidden_modules() if name.startswith(PORT))
