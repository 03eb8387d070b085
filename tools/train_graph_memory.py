"""The captured NLVR train step over a run of ``compress_nlvr --fast_train``
epochs: how many graphs it captures, what the captures cost and how much
memory their pool holds.

One BLIP-NLVR model at full width (ViT-B/16 @ 384, the twin-cross MED),
random weights, one AdamW, 16 pairs a step.  Each "epoch" is one step made
over that optimizer: the mask-mode step first (the epochs at temperature 0),
then gather-mode steps at the capacity schedules of rising temperatures
(``--fast_train``'s per-epoch probe), each run over every text width that an
epoch of NLVR2 batches pads to (``padding="longest"`` over 16 sentences of
about 19 wordpieces, spread 6.5, in [6, 64]: 86,373 pairs, 5,398 batches),
each width once (its capture) and then again (a replay).  After each epoch it
prints one JSON line: the graphs held, the captures and their seconds, the
card's reserved and allocated memory and the reserve of the graphs' pool.

    python tools/train_graph_memory.py --epochs 4 --out chiprun_out/graph_memory.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def epoch_widths(seed: int, pairs: int = 16, batches: int = 86373 // 16) -> list:
    """The text widths of one epoch's batches, each batch padded to its
    longest sentence, with how many batches take each."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.normal(19.0, 6.5, size=(batches, pairs))), 6, 64)
    widths, counts = np.unique(lengths.max(axis=1).astype(np.int64), return_counts=True)
    return list(zip(widths.tolist(), counts.tolist()))


def pool_reserved(pools) -> int:
    """Bytes the card holds in the segments of the memory pools ``pools``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--temperatures", type=float, nargs="+", default=[1.0, 2.0, 4.0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from madtp_tpu_torch.core.config import BlipConfig, MedConfig, ViTConfig
    from madtp_tpu_torch.models.blip import init_nlvr_model
    from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
    from madtp_tpu_torch.train.loops import make_nlvr_train_step
    from madtp_tpu_torch.train.optim import make_adamw
    from madtp_tpu_torch.utils.graph import CapturedStep, graph_count

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    vit = ViTConfig()
    med = MedConfig(twin_cross=True, encoder_width=vit.embed_dim, sd_dim=vit.embed_dim)
    cfg = BlipConfig(vit=vit, med=med, sd_dim=vit.embed_dim)
    model = init_nlvr_model(cfg, seed=0, device=device)
    opt = make_adamw(model.parameters(), lr=3e-6, weight_decay=0.05)
    B, s = args.pairs, vit.image_size
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn(2 * B, 3, s, s, generator=gen, device=device)
    targets = torch.randint(0, 2, (B,), generator=gen, device=device)

    def text(width):
        ids = torch.randint(1000, med.vocab_size, (B, width), generator=gen, device=device)
        ids[:, 0] = 2
        mask = torch.ones(B, width, dtype=torch.int64, device=device)
        mask[-1, width // 2:] = 0
        return ids, mask

    out = open(args.out, "w") if args.out else None
    name = torch.cuda.get_device_name(0)
    held = []
    for epoch in range(args.epochs):
        if epoch == 0:
            temperature, caps = 0.0, (None, None)
        else:
            temperature = args.temperatures[(epoch - 1) % len(args.temperatures)]
            ids, mask = text(26)
            with torch.no_grad():
                ref = model(images, ids, mask, temperature=temperature, prune_active=True)
            caps = fast_capacity_schedule(ref.v_kept.cpu().numpy(), ref.t_kept.cpu().numpy(),
                                          "ceil")
        step = make_nlvr_train_step(model, opt, capacities_v=caps[0], capacities_t=caps[1])
        widths = epoch_widths(epoch)
        captures, seconds = CapturedStep.captures, CapturedStep.capture_seconds
        t0 = time.perf_counter()
        replays = []
        for width, _ in widths:
            batch = (images,) + text(width) + (targets,)
            loss = step(*batch, temperature)["loss"]
            torch.cuda.synchronize()
            r0 = time.perf_counter()
            loss = step(*batch, temperature)["loss"]
            torch.cuda.synchronize()
            replays.append((width, (time.perf_counter() - r0) * 1e3))
        wall = time.perf_counter() - t0
        pools = {st.pool for st in step.graphs.values() if st.pool is not None}
        line = dict(card=name, epoch=epoch, temperature=temperature,
                    capacities=[None if c is None else list(map(int, c)) for c in caps],
                    widths=[w for w, _ in widths], keys=len(step.graphs),
                    graphs=graph_count(step.graphs), pools=len(pools),
                    captures=CapturedStep.captures - captures,
                    capture_s=round(CapturedStep.capture_seconds - seconds, 3),
                    epoch_wall_s=round(wall, 3),
                    replay_ms={w: round(ms, 2) for w, ms in replays[::4]},
                    loss=float(loss),
                    reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                    allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
                    max_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30,
                    pool_reserved_gib=pool_reserved(pools) / 2 ** 30)
        held.append(line)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
