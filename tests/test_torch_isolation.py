"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` never import
JAX or the JAX package ``repro`` (the machine with the card has no JAX)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(
        ".__init__") for p in PORT.rglob("*.py"))

_BLOCKER = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
for m in sys.argv[1:]:
    importlib.import_module(m)
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k in sys.modules)
print("ok", len(sys.argv) - 1)
"""


def test_every_port_module_imports_without_jax_or_repro():
    r = subprocess.run([sys.executable, "-c", _BLOCKER, *MODULES],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", str(len(MODULES))]


def _imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    assert path.exists(), path
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_cost_model_autotuner_and_dry_run_are_covered():
    """The cost model, the autotuner and the dry run are among the
    modules imported above with JAX and the JAX package blocked."""
    assert {"repro_torch.kernels.roofline", "repro_torch.kernels.autotune",
            "repro_torch.configs.shapes", "repro_torch.launch.op_cost",
            "repro_torch.launch.analysis",
            "repro_torch.launch.dryrun"} <= set(MODULES)


def test_tools_are_covered():
    """The dry run's tools are among the modules imported above with JAX
    and the JAX package blocked."""
    assert {"repro_torch.tools", "repro_torch.tools.hillclimb",
            "repro_torch.tools.make_tables",
            "repro_torch.tools.op_profile"} <= set(MODULES)
