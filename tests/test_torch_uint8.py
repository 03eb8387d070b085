"""The port's BLIP ViT on the uint8 feed (uint8 [B, H, W, 3], normalized on
the device) against ``madtp_tpu.models.vit.vit_forward`` on the same batch
and weights, in mask and gather mode (CPU, fp32, a 64-px, 2-layer ViT):
equal kept counts and alive masks, states and space-dictionary features
within the model tests' 1e-5.  A float [B, 3, H, W] batch takes the path it
took before the uint8 feed was added."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from __graft_entry__ import _nlvr_setup
from madtp_tpu.models.vit import vit_forward
from madtp_tpu_torch.ckpt.convert import nlvr_from_jax_params
from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
from madtp_tpu_torch.ops.layers import normalize_images

TEMPERATURE = 20.0
CAPS = {"mask": None, "gather": (12, 8)}


@pytest.fixture(scope="module")
def setup():
    jcfg, params, _, _, _, _ = _nlvr_setup(
        image_size=64, B=2, text_len=8,
        vit_kw=dict(embed_dim=64, depth=2, num_heads=4),
        med_kw=dict(hidden_size=64, num_hidden_layers=1, num_attention_heads=4,
                    intermediate_size=128, merge_start_layer=1, vocab_size=100,
                    max_position_embeddings=16))
    tcfg = BlipConfig(ViTConfig(**dataclasses.asdict(jcfg.vit)),
                      MedConfig(**dataclasses.asdict(jcfg.med)), jcfg.sd_num, jcfg.sd_dim)
    model = nlvr_from_jax_params(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    u8 = np.random.RandomState(3).randint(0, 256, size=(4, 64, 64, 3)).astype(np.uint8)
    return dict(jcfg=jcfg, params=params, vit=model.visual_encoder,
                space_dict=model.space_dict, u8=u8)


def _jax_vit(setup, images, caps):
    state, sd, kept = jax.jit(
        lambda p, im: vit_forward(p["visual_encoder"], im, cfg=setup["jcfg"].vit,
                                  space_dict=p["space_dict"], temperature=TEMPERATURE,
                                  prune_active=True, capacities=caps))(setup["params"], images)
    return jax.tree.map(np.asarray, (state, sd, kept))


def _port_vit(setup, images, caps):
    with torch.no_grad():
        return setup["vit"](images, space_dict=setup["space_dict"], temperature=TEMPERATURE,
                            prune_active=True, capacities=caps)


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vit_uint8_feed_matches_jax(setup, mode):
    caps = CAPS[mode]
    j_state, j_sd, j_kept = _jax_vit(setup, setup["u8"], caps)
    t = _port_vit(setup, torch.from_numpy(setup["u8"]), caps)
    np.testing.assert_array_equal(t.kept_counts.numpy(), j_kept)
    np.testing.assert_array_equal(t.state.alive.numpy(), j_state.alive)
    np.testing.assert_allclose(t.state.x.numpy(), j_state.x, atol=1e-5)
    np.testing.assert_allclose(t.sd_ft.numpy(), j_sd, atol=1e-5)
    assert j_kept[-1] < 16  # the temperature prunes


@pytest.mark.parametrize("mode", ["mask", "gather"])
def test_vit_float_input_unchanged(setup, mode):
    """A float batch goes to the patch embedding as it is: the normalized
    uint8 batch given as floats equals the uint8 feed bit for bit, and
    agrees with ``vit_forward`` on the same floats."""
    caps = CAPS[mode]
    floats = normalize_images(torch.from_numpy(setup["u8"]))
    t_float = _port_vit(setup, floats, caps)
    t_u8 = _port_vit(setup, torch.from_numpy(setup["u8"]), caps)
    assert torch.equal(t_float.state.x, t_u8.state.x)
    assert torch.equal(t_float.kept_counts, t_u8.kept_counts)
    j_state, j_sd, j_kept = _jax_vit(setup, floats.numpy(), caps)
    np.testing.assert_array_equal(t_float.kept_counts.numpy(), j_kept)
    np.testing.assert_allclose(t_float.state.x.numpy(), j_state.x, atol=1e-5)
    np.testing.assert_allclose(t_float.sd_ft.numpy(), j_sd, atol=1e-5)
