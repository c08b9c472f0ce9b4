"""What the benchmark may import: no JAX, none of its libraries and not
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's), nothing of the root ``bench.py``,
``chip_smoke.py`` or ``tools/``; and the reference nothing of the port."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", _sources(), ids=os.path.basename)
def test_no_forbidden_import(path):
    banned = set(harness.FORBIDDEN) | {"bench", "chip_smoke", "tools"}
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & banned, (path, tops & banned)


# what the reference and the families may import of the benchmark: each
# other, and the arithmetic of FLOPs and peaks
REFERENCE_SIDE = ("perfbench.reference", "perfbench.families",
                  "perfbench.flops", "perfbench.peaks")


@pytest.mark.parametrize(
    "path", _sources("reference") + _sources("families")
    + [os.path.join(BENCH, "flops.py"), os.path.join(BENCH, "peaks.py")],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "gzip", "struct", "itertools", "math",
                    "typing", "numpy", "torch", "perfbench", "functools",
                    "importlib", "os"}, tops
    assert all(n.startswith(REFERENCE_SIDE) for n in _imports(path)
               if n.startswith("perfbench")), list(_imports(path))


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fetal_mri_segmentation_tpu_torch_x",
                        sys)
    assert "fetal_mri_segmentation_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "fetal_mri_segmentation_tpu.config",
                        sys)
    assert harness.forbidden_loaded() == ["fetal_mri_segmentation_tpu"]


def test_reference_runs_with_the_port_blocked():
    """The reference runs in a process where importing the port fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('fetal_mri_segmentation_tpu_torch',"
        " 'fetal_mri_segmentation_tpu', 'jax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import torch\n"
        "from perfbench.reference import ingest, models, train, window\n"
        "cfg = {'model_name': 'isensee', 'n_labels': 1, 'n_base_filters': 4,"
        " 'initial_learning_rate': 5e-4}\n"
        "from perfbench import inputs\n"
        "w = inputs.make_weights(cfg, 1, 'cpu')\n"
        "x = torch.randn(1, 1, 16, 16, 16)\n"
        "p = window.probabilities(x[0], lambda v: models.forward(w, v, cfg),"
        " (16, 16, 16), 4)\n"
        "print(tuple(p.shape))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(1, 16, 16, 16)"
