"""Import hygiene of the PyTorch port: ``paddle_tpu_torch`` imports torch,
never jax and nothing of the JAX package ``paddle_tpu``."""
import ast
import pathlib
import subprocess
import sys

import paddle_tpu_torch

PKG = pathlib.Path(paddle_tpu_torch.__file__).parent
MODULES = sorted(
    "paddle_tpu_torch" + "".join(
        f".{p}" for p in path.relative_to(PKG).with_suffix("").parts
        if p != "__init__")
    for path in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=PKG.parent).stdout.split()
    assert "torch" in out and "paddle_tpu_torch.serving.engine" in out
    assert [m for m in out if _forbidden(m)] == []


def test_no_source_file_names_jax_or_the_jax_package():
    bad = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert bad == []
    assert len(MODULES) >= 15
