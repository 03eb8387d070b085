"""One rank of ``tests/test_torch_multiprocess.py``'s train-step and
collective cases, on the CPU over gloo:

    python tests/torch_mp_worker.py RANK WORLD HOST:PORT JOB.pt OUT_DIR

``JOB.pt`` (written by the test) holds, per family, the port's model, this
rank's half of the global batch, the temperature and the optimizer's
settings; the rank runs the family's train step once inside
``parallel.data.global_batch`` (and NLVR's once more with the cross-rank
count max taken out, the control), the local mask-mode forward of its half
outside it, and every helper of ``parallel/dist.py``, and writes what it saw
to ``OUT_DIR/rank{RANK}.pt``.  It imports the port only."""

import sys
import types
from unittest import mock

import numpy as np
import torch

from madtp_tpu_torch.parallel import data, dist
from madtp_tpu_torch.train.loops import (make_caption_train_step, make_nlvr_train_step,
                                         make_vqa_train_step)
from madtp_tpu_torch.train.optim import make_adamw

MAKERS = {"nlvr": make_nlvr_train_step, "caption": make_caption_train_step,
          "vqa": make_vqa_train_step}


def local_counts(family, model, batch, t):
    """This rank's own mask-mode kept counts per layer (no scope: its local
    batch max)."""
    with torch.no_grad():
        if family == "nlvr":
            out = model(*batch[:3], temperature=t, prune_active=True)
            return torch.cat([out.v_kept, out.t_kept])
        if family == "caption":
            return model.encode_image(batch[0], temperature=t, prune_active=True)[2]
        out, _, v_kept = model.encode(*batch[:3], temperature=t, prune_active=True)
        return torch.cat([v_kept, out.kept_counts])


def train(job, batch):
    model = job["model"]
    opt = make_adamw(model.parameters(), lr=job["lr"], weight_decay=job["wd"])
    step = MAKERS[job["family"]](model, opt, device="cpu")
    with data.global_batch():
        metrics = step(*batch, job["temperature"])
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.state_dict().items()})


def helpers(rank, world):
    """Every helper of parallel/dist.py on this rank's values."""
    out = {"row_shard": dist.reference_row_shard(10), "main": dist.is_main_process(),
           "index": dist.process_index(), "count": dist.process_count()}
    out["allgather"] = dist.host_allgather(np.arange(3, dtype=np.float32) + 10 * rank)
    out["allgather_bool"] = dist.host_allgather(np.array([rank % 2 == 0, True]))
    out["sum"] = dist.host_sum(np.array([rank + 1.5, 2.0 ** -30], np.float64))
    scores = np.full((world + 1, 3), -100.0, np.float32)
    scores[rank] = [-250.0 - rank, 0.5, rank]  # below the sentinel too
    out["merge"] = dist.merge_scores(scores)
    out["rows"] = dist.all_gather_rows(torch.arange(rank + 1, dtype=torch.float32)[:, None]
                                       .expand(rank + 1, 2) + rank)
    out["concat"] = dist.concat_all_gather(torch.full((2,), float(rank), requires_grad=True))
    out["max"] = dist.all_reduce(torch.tensor([rank, 5 - rank]), "max")
    dist.barrier("helpers")
    return out


def main():
    rank, world, coord, job_path, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    dist.init_from_args(types.SimpleNamespace(num_processes=world, process_id=rank,
                                              coordinator=coord, dist_backend="gloo"),
                        torch.device("cpu"))
    torch.manual_seed(0)
    jobs = torch.load(job_path, weights_only=False)
    out = {"helpers": helpers(rank, world)}
    g = jobs["gather"]
    x = g["x"][rank].clone().requires_grad_(True)
    y = dist.all_gather_with_grad(x)
    (y * g["w"][rank]).sum().backward()
    out["gather"] = (y.detach(), x.grad)
    for family in ("nlvr", "caption", "vqa"):
        job = jobs[family]
        batch = [torch.from_numpy(np.asarray(a).copy()) for a in job["batches"][rank]]
        counts = local_counts(family, job["model"], batch, job["temperature"])
        control = None
        if family == "nlvr":  # the same step with each rank's own count max
            fresh = dict(job, model=torch.load(job_path, weights_only=False)[family]["model"])
            with mock.patch.object(data, "batch_max", lambda *c: c):
                control = train(fresh, batch)
        out[family] = dict(zip(("metrics", "grads", "state"), train(job, batch)),
                           counts=counts, control=control)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main()
