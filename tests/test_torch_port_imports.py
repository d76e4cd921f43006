"""The port stands apart from JAX, and its GPU entry points refuse to run
without a GPU instead of falling back."""

import os
import pkgutil
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import alg_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(alg_tpu_torch.__path__, "alg_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert "alg_tpu_torch.ops._build" in mods and "alg_tpu_torch.pipelines.cogvideox" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['PIL'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'alg_tpu' or k.startswith('alg_tpu.') for k in sys.modules), 'imported alg_tpu'\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_cuda():
    """No CUDA device: nonzero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
