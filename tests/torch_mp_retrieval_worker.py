"""One rank of ``tests/test_torch_multiprocess_retrieval.py``, on the CPU over
gloo.  Two uses:

    python tests/torch_mp_retrieval_worker.py step RANK WORLD HOST:PORT JOB.pt OUT_DIR
    python tests/torch_mp_retrieval_worker.py driver MODULE STATE_DIR ARGV...

``step``: ``JOB.pt`` (written by the test) holds, per case, the port's
retrieval or CLIP train state, each rank's block of the global batch, the
global Gumbel noise, the temperature, alpha and the optimizer's settings.
The rank runs the case's train step once inside ``parallel.data.
global_batch``, then once more from a fresh copy of the state with the
cross-rank rows taken out (each rank's ITC and mining over its own rows
alone, a plain data-parallel port: the control), and asks ``batch_rows``
for unequal counts; it writes what it saw to ``OUT_DIR/rank{RANK}.pt``.

``driver``: runs ``madtp_tpu_torch.cli.MODULE.main(ARGV)``; every rank
saves its model, optimizer, momentum towers, queue and generator state to
``STATE_DIR/rank{r}.pt`` wherever rank 0 writes its resume file.  It
imports the port only."""

import importlib
import sys
import types
from unittest import mock

import numpy as np
import torch

from madtp_tpu_torch.parallel import data, dist
from madtp_tpu_torch.train.loops import make_clip_train_step, make_retrieval_train_step
from madtp_tpu_torch.train.optim import make_adamw


def _tensors(x):
    return torch.from_numpy(np.asarray(x).copy())


def run_case(job, batch, control=False):
    state = job["state"]
    opt = make_adamw(state.model.parameters(), lr=job["lr"], weight_decay=job["wd"])
    if job["family"] == "retrieval":
        step = make_retrieval_train_step(state, opt, enc_token_id=job["enc"],
                                         negative_all_rank=job["negative_all_rank"],
                                         device="cpu")
        kw = dict(noise=job["noise"])
    else:
        step = make_clip_train_step(state, opt, device="cpu")
        kw = {}
    with data.global_batch():
        if control:  # the cross-rank rows taken out
            with mock.patch.object(data, "world_rows", lambda t, grad=False: t), \
                    mock.patch.object(data, "batch_rows", lambda n: (0, n)):
                metrics = step(*batch, job["temperature"], job["alpha"], **kw)
        else:
            metrics = step(*batch, job["temperature"], job["alpha"], **kw)
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads={n: p.grad.clone() for n, p in state.model.named_parameters()})
    if not control:
        out.update(params={n: p.detach().clone() for n, p in state.model.state_dict().items()},
                   params_m={n: t.clone() for n, t in state.params_m.items()},
                   queue=[t.clone() for t in state.queue])
        if job["family"] == "retrieval":
            out["temp"] = state.temp.clone()
    return out


def step_main(rank, world, coord, job_path, out_dir):
    dist.init_from_args(types.SimpleNamespace(num_processes=world, process_id=rank,
                                              coordinator=coord, dist_backend="gloo"),
                        torch.device("cpu"))
    jobs = torch.load(job_path, weights_only=False)
    out = {}
    for name, job in jobs.items():
        batch = [_tensors(a) for a in job["batches"][rank]]
        out[name] = run_case(job, batch)
        fresh = torch.load(job_path, weights_only=False)[name]
        out[name]["control"] = run_case(fresh, batch, control=True)
    with data.global_batch():
        try:
            data.batch_rows(rank + 1)
            out["unequal"] = None
        except ValueError as e:
            out["unequal"] = str(e)
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def driver_main(module, state_dir, argv):
    driver = importlib.import_module(f"madtp_tpu_torch.cli.{module}")
    real = driver.save_resume

    def save_resume(output_dir, model, optimizer, meta, *, extra=None):
        mine = {k: v.get_state() if isinstance(v, torch.Generator) else v.clone()
                for k, v in (extra or {}).items()}
        torch.save(dict(model=model.state_dict(), optimizer=optimizer.state_dict(), meta=meta,
                        extra=mine), f"{state_dir}/rank{dist.process_index()}.pt")
        return real(output_dir, model, optimizer, meta, extra=extra)

    with mock.patch.object(driver, "save_resume", save_resume):
        driver.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "step":
        step_main(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        driver_main(sys.argv[2], sys.argv[3], sys.argv[4:])
