"""BLIP COCO caption evaluation and compression training (counterpart of
``madtp_tpu/tasks/caption.py:28-188`` and of ``madtp_tpu/cli/compress_caption.py``),
single process.

* :func:`beam_generate`: HF-style beam search with the beams folded into the
  batch and a fixed-capacity KV cache (:class:`~madtp_tpu_torch.models.med.
  DecodeCache`).  Every step runs on the device with no read-back to the
  host, its position a 0-d device tensor, so the whole search is captured.
* :func:`generate_captions` and :func:`finish_captions`: the pruned image
  encode and the decode from the prompt ``"a picture of "`` as one captured
  step, then the captions as text.
* :func:`probe_capacities` is ``--fast_eval``'s calibration (and
  ``--fast_train``'s), and :func:`evaluate` the whole eval with the
  analytic GFLOPs.
* Compression training (the train half of ``madtp_tpu/cli/compress_caption.py:
  280-440``): :func:`presearch` finds the starting temperature,
  :func:`train_batch` tokenizes a batch of captions, :func:`train_epoch`
  runs one epoch of a step from
  :func:`madtp_tpu_torch.train.loops.make_caption_train_step`.

Batches are ``(images, image_ids)`` numpy arrays, ``images`` float
[b, 3, H, W] or the uint8 feed [b, H, W, 3].
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.models.blip import CaptionModel
from madtp_tpu_torch.models.med import DecodeCache, MedDecoder, init_decode_cache
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.dtp import TokenState
from madtp_tpu_torch.prune.flops import caption_gflops
from madtp_tpu_torch.train.controller import presearch_temperature
from madtp_tpu_torch.train.epoch import run_epoch
from madtp_tpu_torch.utils.graph import CapturedStep

NEG = -1e9
PROMPT = "a picture of "
N_TEXT0 = 14  # the decoder's token count in the caption driver's GFLOPs
MAX_LENGTH = 40  # the training captions' token limit (compress_caption.py:406)


def _expand_state(state: TokenState, nb: int) -> TokenState:
    """Each row repeated ``nb`` times in place (the beams of one image side
    by side)."""
    return TokenState(*(None if a is None else a.repeat_interleave(nb, dim=0) for a in state))


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row with their indices, the lower index
    first among equal values, as ``jax.lax.top_k`` orders them
    (``torch.topk`` does not promise an order among ties): a stable
    descending sort."""
    s = torch.sort(x, dim=1, descending=True, stable=True)
    return s.values[:, :k], s.indices[:, :k]


def _write(seqs: torch.Tensor, pos: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """``seqs`` [B, n, T] with ``tok`` [B, n] written at ``pos`` (in place)."""
    return seqs.index_copy_(2, pos.view(1), tok[:, :, None])


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a`` [B, n, T] gathered along dim 1 by ``idx`` [B, m] -> [B, m, T]."""
    return a.gather(1, idx[:, :, None].expand(-1, -1, a.shape[2]))


@torch.inference_mode()
def beam_generate(decoder: MedDecoder, enc_state: TokenState, prompt_ids: torch.Tensor, *,
                  num_beams: int = 3, max_length: int = 30, min_length: int = 10,
                  eos_token_id: int = 102, pad_token_id: int = 0, length_penalty: float = 1.0,
                  repetition_penalty: float = 1.0) -> torch.Tensor:
    """Beam search over the memory ``enc_state`` [B, S, D] from
    ``prompt_ids`` [B, Lp] (BOS first, on the model's device), with the
    semantics of the JAX ``beam_generate``: additive log-prob beam scores
    starting at ``[0, NEG, ...]``, EOS suppressed while the position is below
    ``min_length``, the top ``2 num_beams`` candidates over all beams' tokens,
    EOS candidates banked as finished hypotheses at score /
    length^``length_penalty``, the next live beams the first ``num_beams``
    other candidates in order, HF's ``repetition_penalty``, the final pick
    among finished and live beams, padding after the first EOS.  Ties break
    as in ``jax.lax.top_k``, lower index first.

    The cache is primed on the prompt one token at a time; the last step's
    decoder pass, whose logits nothing reads, is not run.  Returns the
    sequences [B, max_length] (prompt included)."""
    B, Lp = prompt_ids.shape
    nb, T = num_beams, max_length
    V = decoder.cfg.vocab_size
    dev = prompt_ids.device
    enc = decoder._memory(_expand_state(enc_state, nb), decoder.dtype)
    memory = decoder.memory_kv(enc)
    cache = init_decode_cache(decoder.cfg, B * nb, T, decoder.dtype, dev)
    positions = torch.arange(T, device=dev)
    vocab = torch.arange(V, device=dev)
    row_base = torch.arange(B, device=dev)[:, None] * nb

    seqs = torch.full((B, nb, T), pad_token_id, dtype=prompt_ids.dtype, device=dev)
    seqs[:, :, :Lp] = prompt_ids[:, None, :]
    for t in range(Lp):  # prime the cache on the prompt (teacher forcing)
        pos = positions[t]
        tok = seqs.index_select(2, pos.view(1)).view(B * nb, 1)
        h, cache = decoder.step(tok, pos, cache, enc, memory)
    logits = decoder.lm_head(h)[:, 0, :]

    beam_scores = torch.full((B, nb), NEG, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    fin_seqs = torch.full_like(seqs, pad_token_id)
    fin_scores = torch.full((B, nb), NEG, dtype=torch.float32, device=dev)
    for t in range(Lp, T):
        pos = positions[t]
        logp = torch.log_softmax(logits.float(), dim=-1)  # [B nb, V]
        if repetition_penalty != 1.0:
            # HF: divide positive scores, multiply negative ones, of tokens seen so far
            seen = torch.zeros_like(logp).scatter_add_(
                1, seqs.view(B * nb, T), (positions < pos).float().expand(B * nb, T)) > 0
            pen = torch.where(logp > 0, logp / repetition_penalty, logp * repetition_penalty)
            logp = torch.where(seen, pen, logp)
        logp = torch.where((pos < min_length) & (vocab == eos_token_id), NEG, logp)
        cand = (beam_scores[:, :, None] + logp.view(B, nb, V)).view(B, nb * V)
        top_scores, top_idx = _top(cand, 2 * nb)
        top_beam = torch.div(top_idx, V, rounding_mode="floor")
        top_tok = (top_idx % V).to(seqs.dtype)

        # the next live beams: the first nb candidates that are not EOS, in order
        is_eos = top_tok == eos_token_id
        live_rank = torch.cumsum((~is_eos).int(), dim=1) - 1
        pick = ~is_eos & (live_rank < nb)
        order = torch.sort((~pick).int(), dim=1, stable=True).indices[:, :nb]  # picked first
        ok = pick.gather(1, order)
        new_scores = torch.where(ok, top_scores.gather(1, order), NEG)
        new_src = torch.where(ok, top_beam.gather(1, order), 0)
        new_tok = torch.where(ok, top_tok.gather(1, order), pad_token_id)

        # bank the EOS candidates as finished hypotheses, normalized by length
        hyp_len = (pos + 1).float()
        eos_norm = torch.where(is_eos, top_scores / hyp_len ** length_penalty, NEG)
        eos_seqs = _write(_rows(seqs, top_beam), pos, top_tok)
        fin_scores, best = _top(torch.cat([fin_scores, eos_norm], dim=1), nb)
        fin_seqs = _rows(torch.cat([fin_seqs, eos_seqs], dim=1), best)

        seqs = _write(_rows(seqs, new_src), pos, new_tok)
        beam_scores = new_scores
        if t + 1 < T:
            # a new cache of reordered rows; the step then writes into it in place
            src = (row_base + new_src).view(B * nb)
            cache = DecodeCache(cache.k.index_select(1, src), cache.v.index_select(1, src))
            h, cache = decoder.step(new_tok.view(B * nb, 1), pos, cache, enc, memory)
            logits = decoder.lm_head(h)[:, 0, :]

    # finished hypotheses compete with the live beams (HF's finalize)
    live_norm = beam_scores / (positions[-1] + 1).float() ** length_penalty
    best = _top(torch.cat([fin_scores, live_norm], dim=1), 1)[1]  # the first of equals
    out = _rows(torch.cat([fin_seqs, seqs], dim=1), best)[:, 0]
    # pad everything after the first EOS past the prompt
    is_eos_out = (out == eos_token_id) & (positions >= Lp)
    first_eos = torch.where(is_eos_out.any(dim=1), torch.argmax(is_eos_out.int(), dim=1), T)
    return torch.where(positions > first_eos[:, None], pad_token_id, out)


def prompt_ids(tokenizer, batch: int) -> np.ndarray:
    """The prompt's ids [batch, Lp]: ``"a picture of "`` tokenized, its
    [SEP] dropped and [DEC] as BOS in place of [CLS]
    (``madtp_tpu/cli/compress_caption.py:72-74``)."""
    ids = tokenizer([PROMPT] * batch, padding="longest")["input_ids"][:, :-1]
    ids[:, 0] = tokenizer.bos_token_id
    return ids.astype(np.int64)


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card through pinned memory without
    waiting, so the copy does not wait for the work queued before it."""
    t = torch.from_numpy(np.asarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def generate_captions(model: CaptionModel, tokenizer, images, temperature: float, *,
                      num_beams: int = 3, max_length: int = 20, min_length: int = 5,
                      capacities: Optional[Sequence[int]] = None, graph: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The image encode, pruned when ``temperature > 0`` (gather mode with
    ``capacities``), and the beam decode from the prompt
    (``generate_captions(defer=True)``).  Returns the device tensors
    ``(sequences [b, max_length], v_kept [L])`` without waiting for them;
    :func:`finish_captions` makes the text.

    The encode and the whole decode are one captured step, the counterpart
    of the JAX package's single ``fori_loop``: one CUDA graph per batch
    shape, prune mode, capacities and beam settings, the temperature an
    input of it.  ``graph=False`` runs them eagerly."""
    dev = model.space_dict.device
    prune = temperature > 0
    eos, pad = tokenizer.sep_token_id, tokenizer.pad_token_id

    @torch.inference_mode()
    def step(images, prompt, t):
        state, _, v_kept = model.encode_image(images, temperature=t, prune_active=prune,
                                              capacities=capacities)
        out = beam_generate(model.text_decoder, state, prompt, num_beams=num_beams,
                            max_length=max_length, min_length=min_length,
                            eos_token_id=eos, pad_token_id=pad)
        return out, v_kept

    if graph:
        step = CapturedStep(step, "caption", model, static=(
            prune, capacities, num_beams, max_length, min_length, eos, pad))
    prompt = _to_device(prompt_ids(tokenizer, np.shape(images)[0]), dev)
    return step(_to_device(images, dev), prompt, temperature)


def finish_captions(tokenizer, out: torch.Tensor) -> List[str]:
    """The captions of :func:`generate_captions`' sequences, the prompt's
    text stripped (``finish_captions``); the only read-back."""
    caps = []
    for row in out.cpu().numpy():
        text = tokenizer.decode(row)
        caps.append(text[len(PROMPT):].strip() if text.startswith(PROMPT) else text)
    return caps


@torch.inference_mode()
def probe_capacities(model: CaptionModel, batches: Iterable, temperature: float,
                     cap_mode: str = "ceil") -> Tuple[int, ...]:
    """``--fast_eval``'s calibration (``madtp_tpu/cli/compress_caption.py:
    161-177``): the mask-mode image tower on the first 4 batches at
    ``temperature``, then :func:`fast_capacity_schedule` over its kept
    counts.  Returns the vision capacities."""
    dev = model.space_dict.device
    vks = [model.encode_image(_to_device(images, dev), temperature=temperature,
                              prune_active=True)[2].cpu().numpy()
           for images, _ in itertools.islice(batches, 4)]
    return fast_capacity_schedule(np.stack(vks), None, cap_mode)[0]


def evaluate(model: CaptionModel, tokenizer, batches: Iterable, *, temperature: float,
             capacities: Optional[Sequence[int]] = None, num_beams: int = 3,
             max_length: int = 20, min_length: int = 5, graph: bool = True
             ) -> Tuple[List[dict], float]:
    """The caption eval of ``compress_caption`` (``eval_epoch``, single
    process): each batch's captions from :func:`generate_captions` and the
    mean ``caption_gflops`` over the batches (the decoder at 14 tokens).
    Batch ``i+1`` is dispatched before batch ``i`` is read back.  Returns
    ``(results, Cur_Gflops)``, ``results`` ``[{"image_id", "caption"}]`` in
    order.  It runs where the model lives; ``graph=False`` runs the batches
    eagerly."""
    cfg = model.cfg
    results: List[dict] = []
    g_sum, n = 0.0, 0

    def consume(pend):
        nonlocal g_sum, n
        out, v_kept, img_ids = pend
        for c, i in zip(finish_captions(tokenizer, out), img_ids):
            results.append({"image_id": int(i), "caption": c})
        g_sum += caption_gflops(cfg.vit, cfg.med, v_kept.cpu().numpy(), N_TEXT0)
        n += 1

    pending = None
    for images, img_ids in batches:
        out, v_kept = generate_captions(model, tokenizer, images, temperature,
                                        num_beams=num_beams, max_length=max_length,
                                        min_length=min_length, capacities=capacities,
                                        graph=graph)
        if pending is not None:
            consume(pending)
        pending = (out, v_kept, img_ids)
    if pending is not None:
        consume(pending)
    return results, g_sum / max(n, 1)


@torch.inference_mode()
def presearch(model: CaptionModel, images, target_gflops: float, *, t0: float = 1.0,
              tol: float = 1.0, max_iters: int = 25) -> float:
    """The temperature a compression run starts from
    (``madtp_tpu/cli/compress_caption.py:311-324``): the mask-mode image tower
    on one probe batch, ``caption_gflops`` of its kept counts (the decoder at
    14 tokens), stepped by the controller's ladder until within ``tol``
    GFLOPs of the target."""
    cfg = model.cfg
    x = _to_device(images, model.space_dict.device)

    def measure(t):
        kept = model.encode_image(x, temperature=t, prune_active=True)[2]
        return caption_gflops(cfg.vit, cfg.med, kept.cpu().numpy(), N_TEXT0)

    return presearch_temperature(measure, target_gflops, t0=t0, max_iters=max_iters, tol=tol)


def train_batch(tokenizer, captions: Sequence[str], prompt_length: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batch of training captions (``compress_caption.py:400-409``): ids and
    mask padded to the longest caption (at most ``MAX_LENGTH``), BOS in slot
    0, labels -100 at padding and over the first ``prompt_length`` tokens
    (``len(tokenizer.encode(PROMPT)) - 1``).  int64 numpy arrays."""
    tok = tokenizer(list(captions), padding="longest", max_length=MAX_LENGTH)
    ids = np.array(tok["input_ids"], np.int64)
    mask = np.array(tok["attention_mask"], np.int64)
    ids[:, 0] = tokenizer.bos_token_id
    labels = np.where(ids == tokenizer.pad_token_id, -100, ids)
    labels[:, :prompt_length] = -100
    return ids, mask, labels


def train_epoch(model: CaptionModel, train_step, loader_fn: Callable[[], Iterable], tokenizer,
                temperature: float, *, print_fn=print, print_freq: int = 50,
                lr: float = 0.0, stop=None) -> dict:
    """One compression-training epoch (single process) of ``train_step``
    (:func:`~madtp_tpu_torch.train.loops.make_caption_train_step`'s step)
    over ``loader_fn()``'s ``(images, captions, image_ids)`` batches, each
    tokenized by :func:`train_batch`.  Returns the stats of
    :func:`~madtp_tpu_torch.train.epoch.run_epoch`: the means of
    ``temperature``, ``lr``, ``loss``, ``loss_lm`` and ``loss_fdt``, and
    ``batches_done``."""
    dev = model.space_dict.device
    prompt_length = len(tokenizer.encode(PROMPT)) - 1

    def run_step(_, batch):
        images, captions = batch[0], batch[1]
        ids, mask, labels = train_batch(tokenizer, captions, prompt_length)
        return train_step(_to_device(images, dev), *(_to_device(a, dev) for a in
                                                     (ids, mask, labels)), temperature)

    return run_epoch(loader_fn(), run_step, temperature, lr=lr, print_fn=print_fn,
                     print_freq=print_freq, stop=stop)
