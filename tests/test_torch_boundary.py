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
    assert {"madtp_tpu_torch.tasks.vqa", "madtp_tpu_torch.models.med",
            "madtp_tpu_torch.tasks.caption", "madtp_tpu_torch.prune.sparsemax",
            "madtp_tpu_torch.utils.profiling", "madtp_tpu_torch.ckpt.convert",
            "madtp_tpu_torch.parallel.mesh", "madtp_tpu_torch.native"} <= \
        set(_port_modules())
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


def test_port_runs_its_png_path_without_jax_pil_or_yaml(tmp_path):
    """Every port module imports with ``jax``, ``PIL`` and ``yaml`` blocked,
    and a PNG goes through ``data/image.py`` and the eval transform there."""
    import zlib

    row = b"\x00" + bytes(range(24))  # 8 RGB pixels, filter None
    png = tmp_path / "a.png"
    png.write_bytes(b"\x89PNG\r\n\x1a\n" + b"".join(
        len(body).to_bytes(4, "big") + kind + body
        + zlib.crc32(kind + body).to_bytes(4, "big")
        for kind, body in ((b"IHDR", (8).to_bytes(4, "big") + (2).to_bytes(4, "big")
                            + bytes([8, 2, 0, 0, 0])),
                           (b"IDAT", zlib.compress(row * 2)), (b"IEND", b""))))
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from madtp_tpu_torch.data.image import open_image\n"
        "from madtp_tpu_torch.data.transforms import eval_transform\n"
        f"img = open_image({str(png)!r})\n"
        "assert img.shape == (2, 8, 3) and img[1, 7].tolist() == [21, 22, 23], img\n"
        "assert eval_transform(img, 16).shape == (3, 16, 16)\n"
        "bad = [m for m in sys.modules if m == 'madtp_tpu' or m.startswith('madtp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_serving_imports_without_jax_or_ml_dtypes():
    """The serving package and both serving CLIs import with ``jax`` and
    ``ml_dtypes`` blocked, and the wire codec round-trips bfloat16 there."""
    code = (
        "import sys\n"
        "for m in ('jax', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "import madtp_tpu_torch.serve, madtp_tpu_torch.cli.export_serving, "
        "madtp_tpu_torch.cli.serve\n"
        "from madtp_tpu_torch.serve.server import decode_tensors, encode_arrays\n"
        "x = torch.linspace(-3, 3, 12).to(torch.bfloat16).reshape(3, 4)\n"
        "y, = decode_tensors(encode_arrays([x]))\n"
        "assert y.dtype == torch.bfloat16 and torch.equal(x.view(torch.int16), "
        "y.view(torch.int16))\n"
        "bad = [m for m in sys.modules if m == 'madtp_tpu' or m.startswith('madtp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_pattern_check_covers_drivers_data_and_utils():
    checked = {p.relative_to(PORT).parts[0] for p in PORT.rglob("*.py")}
    assert {"cli", "data", "utils"} <= checked
    assert {"compress_nlvr.py", "compress_caption.py", "compress_vqa.py", "common.py"} <= \
        {p.name for p in (PORT / "cli").glob("*.py")}


def test_port_sources_do_not_name_the_jax_package():
    pattern = re.compile(r"^\s*(import\s+madtp_tpu|from\s+madtp_tpu)(?!_torch)\b", re.M)
    for path in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_port_sources_import_no_jax():
    """No port module imports JAX, at its top or inside a function (where the
    import check above would not see it): the profiling module's ``trace``
    is a ``torch.profiler`` context, and the Flax ``.npz`` loader reads
    with numpy.  Both run with ``jax`` blocked."""
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    paths = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert {"sparsemax.py", "profiling.py", "convert.py"} <= {p.name for p in paths}
    for path in paths:
        assert not pattern.search(path.read_text()), path
    code = (
        "import sys, tempfile\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from madtp_tpu_torch.utils import profiling\n"
        "from madtp_tpu_torch.ckpt.convert import load_flax_vit_npz\n"
        "from madtp_tpu_torch.prune import sparsemax\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    with profiling.trace(d):\n"
        "        torch.ones(4).sum()\n"
        "assert sparsemax(torch.tensor([0.0, 5.0])).tolist() == [0.0, 1.0]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


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


def _code_strings(path):
    """The string constants of a module's code: every string literal but the
    docstrings."""
    import ast

    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_reads_no_file_of_the_jax_package():
    """No port module builds a path into ``madtp_tpu/``: no string of its
    code names the JAX package's directory.  The CLIP merge table the port
    reads is its own copy, byte for byte the JAX package's."""
    import hashlib

    for path in PORT.rglob("*.py"):
        for s in _code_strings(path):
            assert not re.search(r"(^|[/\\])madtp_tpu([/\\]|$)", s), (path, s)
    from madtp_tpu_torch.data.tokenizer_clip import DEFAULT_BPE

    ours = pathlib.Path(DEFAULT_BPE)
    assert ours.resolve().is_relative_to(PORT.resolve())
    theirs = REPO / "madtp_tpu" / "data" / "assets" / ours.name
    assert hashlib.sha256(ours.read_bytes()).hexdigest() == \
        hashlib.sha256(theirs.read_bytes()).hexdigest()
