"""The port's boundaries: it imports without JAX and nothing of the JAX
package, its entry points refuse to run without a card unless asked for the
CPU, and chip_smoke.py fails without a card."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "madtp_tpu_torch"


def _port_modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'madtp_tpu' or m.startswith('madtp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_port_sources_do_not_name_the_jax_package():
    pattern = re.compile(r"^\s*(import\s+madtp_tpu|from\s+madtp_tpu)(?!_torch)\b", re.M)
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_gpu(no_gpu):
    from madtp_tpu_torch.ckpt.convert import load_nlvr_state_dict, nlvr_from_jax_params
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
    from madtp_tpu_torch.core.device import resolve_device
    from madtp_tpu_torch.models.blip import init_nlvr_model

    vit = ViTConfig(image_size=32, embed_dim=64, depth=1, num_heads=1)
    cfg = BlipConfig(vit, MedConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                                    intermediate_size=64, twin_cross=True, encoder_width=64,
                                    vocab_size=10, max_position_embeddings=8),
                     sd_num=4, sd_dim=64)
    for call in (lambda: resolve_device(), lambda: init_nlvr_model(cfg),
                 lambda: nlvr_from_jax_params({}, cfg), lambda: load_nlvr_state_dict({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    model = init_nlvr_model(cfg, device="cpu")
    assert model.space_dict.device.type == "cpu"


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"  # without the rest of the repository
    alone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_train_step_refuses_without_gpu(no_gpu):
    """make_nlvr_train_step defaults to the card and raises without one; given
    device="cpu" it builds the step for a model on the CPU."""
    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw

    vit = ViTConfig(image_size=32, embed_dim=64, depth=1, num_heads=1)
    cfg = BlipConfig(vit, MedConfig(hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                                    intermediate_size=64, twin_cross=True, encoder_width=64,
                                    vocab_size=10, max_position_embeddings=8),
                     sd_num=4, sd_dim=64)
    model = init_nlvr_model(cfg, device="cpu")
    opt = make_adamw(model.parameters(), lr=1e-5, weight_decay=0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_nlvr_train_step(model, opt)
    assert callable(make_nlvr_train_step(model, opt, device="cpu"))
