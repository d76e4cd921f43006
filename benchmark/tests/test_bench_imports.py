"""What the benchmark may import: never JAX or the JAX package, and the reference nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import manifest as mf
from benchmark import run

HERE = mf.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "alg_tpu"}


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(os.path.relpath(p, HERE) for p in _sources(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = _top_level_imports(os.path.join(HERE, path))
    assert not names & FORBIDDEN, f"{path} imports {sorted(names & FORBIDDEN)}"
    if path.startswith("reference" + os.sep):
        assert not {n for n in names if n.startswith("alg_tpu")}, f"the reference imports the program: {path}"


def test_reference_imports_only_torch_numpy_and_itself():
    for p in _sources(os.path.join(HERE, "reference")):
        assert _top_level_imports(p) <= {"torch", "numpy", "math", "__future__", "benchmark"}, p


def test_forbidden_names_compare_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["alg_tpu_torch_probe"] = sys
        sys.modules["jaxlike"] = sys
        assert run.forbidden_modules() == [m for m in run.forbidden_modules() if m.split(".")[0] in FORBIDDEN]
        assert "alg_tpu_torch_probe" not in run.forbidden_modules() and "jaxlike" not in run.forbidden_modules()
        sys.modules["alg_tpu.probe"] = sys
        assert "alg_tpu.probe" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_modules_import_with_jax_blocked_and_leave_it_unloaded():
    mods = ["benchmark.run", "benchmark.calibrate", "benchmark.drivers.sample", "benchmark.reference.sampler",
            "benchmark.trace", "benchmark.flops"]
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'flax', 'alg_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from benchmark import manifest as mf\n"
            "for m in mf.load_manifest()['per_layer']:\n"
            "    mf.metric_reader(m['name'])\n"
            "import alg_tpu_torch.pipelines.cogvideox\n"
            "from benchmark import run\n"
            "assert run.forbidden_modules() == [], run.forbidden_modules()\n")
    subprocess.run([sys.executable, "-c", code], cwd=mf.ROOT, check=True)
