"""The port stands alone: no module of ``tdnet_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the JAX package
``tdnet_tpu``, at the top or lazily inside a function.

The check reads each file's syntax tree, so an import that runs only on
some path (a CLI branch, a function body) is caught without running it.
"""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "tdnet_tpu"}
FILES = sorted(os.path.relpath(p, REPO) for p in
               glob.glob(os.path.join(REPO, "tdnet_tpu_torch", "**", "*.py"), recursive=True))
FILES.append("chip_smoke.py")


def import_roots(source: str) -> set[str]:
    """The top-level package of every absolute import in ``source``."""
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    with open(os.path.join(REPO, path)) as f:
        roots = import_roots(f.read())
    assert not roots & FORBIDDEN, f"{path} imports {sorted(roots & FORBIDDEN)}"


def test_walk_catches_lazy_imports():
    src = ("import torch\n"
           "def main():\n"
           "    from tdnet_tpu.data.streaming import FrameSource\n"
           "    import jax.numpy as jnp\n")
    assert import_roots(src) == {"torch", "tdnet_tpu", "jax"}


def test_files_cover_the_package():
    assert "tdnet_tpu_torch/cli/test.py" in FILES
    assert "tdnet_tpu_torch/train/trainer.py" in FILES
    for path in ("kernels/fused_stem.py", "kernels/dilated_conv.py", "models/pspnet.py"):
        assert f"tdnet_tpu_torch/{path}" in FILES
    assert len(FILES) >= 30
