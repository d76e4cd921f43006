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
    assert {"alg_tpu_torch.ops.rope", "alg_tpu_torch.schedulers.unipc", "alg_tpu_torch.models.clip",
            "alg_tpu_torch.models.wan.transformer", "alg_tpu_torch.models.wan.vae",
            "alg_tpu_torch.pipelines.wan", "alg_tpu_torch.alg.hunyuan_size", "alg_tpu_torch.models.llama",
            "alg_tpu_torch.schedulers.flow_match_euler", "alg_tpu_torch.models.hunyuan.transformer",
            "alg_tpu_torch.models.hunyuan.vae", "alg_tpu_torch.pipelines.hunyuan",
            "alg_tpu_torch.ops.flash_attention_bwd", "alg_tpu_torch.core.remat", "alg_tpu_torch.io.lora",
            "alg_tpu_torch.training.losses", "alg_tpu_torch.training.lora", "alg_tpu_torch.training.train",
            "alg_tpu_torch.training.checkpoint", "alg_tpu_torch.training.data",
            "alg_tpu_torch.ops.flash_attention_int8", "alg_tpu_torch.ops.attention",
            "alg_tpu_torch.ops.flash_attention", "alg_tpu_torch.cli", "alg_tpu_torch.io.safetensors",
            "alg_tpu_torch.io.weights", "alg_tpu_torch.io.hf_tokenizer", "alg_tpu_torch.io.model_zoo",
            "alg_tpu_torch.io.video", "alg_tpu_torch.io.hf_checkpoint", "alg_tpu_torch.alg.filters",
            "alg_tpu_torch.schedulers.dpm_cogvideox", "alg_tpu_torch.io.runstate",
            "alg_tpu_torch.pipelines.denoise", "alg_tpu_torch.prepare_cli", "alg_tpu_torch.utils.profiling",
            "alg_tpu_torch.train_cli", "alg_tpu_torch.models.cogvideox.transformer",
            "alg_tpu_torch.models.cogvideox.vae", "alg_tpu_torch.serving", "alg_tpu_torch.serve_cli",
            "alg_tpu_torch.http_serving", "alg_tpu_torch.ops.quant", "alg_tpu_torch.sharding",
            "alg_tpu_torch.sharding.mesh", "alg_tpu_torch.sharding.collectives", "alg_tpu_torch.sharding.partition",
            "alg_tpu_torch.sharding.pipeline", "alg_tpu_torch.sharding.multihost"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['yaml'] = None\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['ftfy'] = None\n"
        "sys.modules['regex'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['tokenizers'] = None\n"
        "sys.modules['alg_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, 'tests')\n"
        "importlib.import_module('quant_feed')  # chip_smoke.py's Q5 imports it\n"
        "importlib.import_module('torch_dist_workers')  # the sharding tests' ranks\n"
        "from alg_tpu_torch.ops.flash_attention import route\n"
        "from alg_tpu_torch.ops.flash_attention_bwd import dkv_route\n"
        "assert not any((k == 'alg_tpu' or k.startswith('alg_tpu.')) and m is not None\n"
        "               for k, m in sys.modules.items()), 'imported alg_tpu'\n"
        "assert sys.modules.get('optax') is None, 'imported optax'\n"
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
