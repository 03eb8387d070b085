"""The port's nucleus (top-p) caption decode against the JAX package's
``nucleus_generate`` on the CPU (fp32, the tiny captioner of
tests/test_torch_caption.py with its sharpened decoder and toy vocabulary):
given the Gumbel noise ``jax.random.categorical`` adds at each step (the same
split chain of the same key), the sequences must be equal, at three decode
configurations (lengths, ``top_p``, repetition penalty) and two keys each; the
captured encode-and-decode step against the JAX encode and decode; the
``min_length`` rule, padding after EOS and determinism as
tests/test_generate.py:165-185 holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madtp_tpu.models.blip import blip_caption_encode_image
from madtp_tpu.tasks.caption import nucleus_generate as j_nucleus_generate
from madtp_tpu_torch.tasks import caption as TC
from tests.test_torch_caption import (BOS, EOS, JCFG, TEMPERATURE, V, _jstate, _state, _t,
                                      setup)  # noqa: F401  (the module fixture)

# (max_length, min_length, top_p, repetition_penalty)
CONFIGS = [(12, 3, 0.9, 1.1), (10, 6, 0.5, 1.0), (14, 1, 0.99, 1.3)]
_j_nucleus = jax.jit(j_nucleus_generate, static_argnames=(
    "cfg", "max_length", "min_length", "top_p", "eos_token_id", "pad_token_id",
    "repetition_penalty"))


def _jax_noise(key, steps, batch):
    """The Gumbel draws of the JAX decode: ``rng, sub = split(rng)`` a step,
    ``categorical`` adding ``gumbel(sub, [B, V])``."""
    rng, out = key, []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        out.append(np.asarray(jax.random.gumbel(sub, (batch, V), jnp.float32)))
    return np.stack(out)


def _prompt(batch):
    prompt = np.full((batch, 2), 7, np.int32)
    prompt[:, 0] = BOS
    return prompt


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"T{c[0]}-min{c[1]}-p{c[2]}-r{c[3]}"
                                              for c in CONFIGS])
def test_nucleus_matches_jax(setup, cfg, seed):  # noqa: F811
    max_length, min_length, top_p, rp = cfg
    mem, prompt = setup["mem"], _prompt(2)
    key = jax.random.PRNGKey(seed)
    kw = dict(max_length=max_length, min_length=min_length, top_p=top_p, eos_token_id=EOS,
              pad_token_id=0, repetition_penalty=rp)
    want = np.asarray(_j_nucleus(setup["params"]["text_decoder"], _jstate(mem),
                                 jnp.asarray(prompt), JCFG, key, **kw))
    noise = _jax_noise(key, max_length - prompt.shape[1], 2)
    got = TC.nucleus_generate(setup["model"].text_decoder, _state(mem), _t(prompt).long(),
                              noise=_t(noise), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, :2].numpy() == prompt).all()


def test_nucleus_step_matches_jax_encode_and_decode(setup):  # noqa: F811
    """The captured step (eagerly on the CPU) in gather mode: the JAX image
    encode at the same capacities, then the JAX decode with the same
    noise."""
    images = setup["batches"][0][0]
    caps = (16, 16)
    max_length, min_length = 12, 3
    step = TC.make_nucleus_step(setup["model"], True, caps, max_length=max_length,
                                min_length=min_length, eos_token_id=EOS, pad_token_id=0)
    key = jax.random.PRNGKey(3)
    noise = _jax_noise(key, max_length - 2, 2)
    got, kept = step(_t(images), _t(_prompt(2)), TEMPERATURE, _t(noise))
    encode = jax.jit(blip_caption_encode_image,
                     static_argnames=("cfg", "prune_active", "capacities"))
    state, _, j_kept = encode(setup["params"], jnp.asarray(images), JCFG,
                              temperature=TEMPERATURE, prune_active=True, capacities=caps)
    want = _j_nucleus(setup["params"]["text_decoder"], state, jnp.asarray(_prompt(2)), JCFG,
                      key, max_length=max_length, min_length=min_length, top_p=0.9,
                      eos_token_id=EOS, pad_token_id=0, repetition_penalty=1.1)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(j_kept))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nucleus_min_length_padding_and_determinism(setup):  # noqa: F811
    """No EOS before ``min_length``, padding after the first EOS, the same
    generator seed the same sequences, another seed others."""
    mem, prompt = _state(setup["mem"]), _t(_prompt(2)).long()
    decoder = setup["model"].text_decoder

    def run(seed, min_length=4):
        return TC.nucleus_generate(decoder, mem, prompt, max_length=14, min_length=min_length,
                                   eos_token_id=EOS, pad_token_id=0,
                                   generator=torch.Generator().manual_seed(seed)).numpy()

    outs = [run(s) for s in range(6)]
    assert all(o.shape == (2, 14) for o in outs)
    np.testing.assert_array_equal(run(0), outs[0])
    assert any(not np.array_equal(outs[0], o) for o in outs[1:])
    ended = 0
    for o in outs:
        for row in o:
            eos = np.where(row == EOS)[0]
            if len(eos):
                ended += 1
                assert eos[0] >= 4
                assert (row[eos[0] + 1:] == 0).all()
    assert ended > 0  # the rule was exercised
    noise = TC.nucleus_noise(12, 2, V, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    assert noise.shape == (12, 2, V) and noise.dtype == torch.float32
