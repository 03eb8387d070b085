"""One rank of ``tests/test_torch_tp.py``'s tensor-parallel and mesh
serving cases, on the CPU over gloo:

    python tests/torch_tp_worker.py RANK WORLD HOST:PORT JOB.pt OUT_DIR

``JOB.pt`` (written by the test) holds ``{"tp": [...]}`` (each entry a
whole model, its inputs and the mesh shape: the rank shards the model over
the mesh and runs the forward) or ``{"serve": ...}`` (a mesh artifact's
directory, its inputs and optionally rebind weights, or a list of such:
every rank loads it, rank 0 calls it and the other ranks follow).  The rank writes what it saw to
``OUT_DIR/rank{RANK}.pt``.  It imports the port only."""

import copy
import sys
import types

import torch

from madtp_tpu_torch.parallel import dist
from madtp_tpu_torch.parallel.mesh import data_scope, make_mesh, shard_model


def run_tp(job):
    mesh = make_mesh(*job["mesh"])
    model = shard_model(copy.deepcopy(job["model"]).eval(), mesh)  # jobs may share a model
    with torch.no_grad(), data_scope(mesh):
        out = model(*job["args"], **job["kwargs"])
    return {"x": out.state.x, "kept": out.kept_counts,
            "shapes": {n: tuple(p.shape) for n, p in model.named_parameters()}}


def run_serve(job):
    from madtp_tpu_torch.serve.artifact import load_artifact, save_artifact

    model = load_artifact(job["dir"], "cpu")
    if not dist.is_main_process():
        model.follow()
        out = {"shapes": {n: tuple(p.shape) for n, p in model.model.named_parameters()}}
    else:
        out = {"first": model(*job["inputs"])}
        if "rebind" in job:
            out["rebound"] = model.rebind(job["rebind"])(*job["inputs"])
            out["back"] = model.rebind(job["weights"])(*job["inputs"])
        model.close()
    if "resave" in job:  # every rank: the shards gathered back, rank 0 writes
        meta = {k: model.meta[k] for k in ("task", "mode")}
        save_artifact(job["resave"], model.model, model.meta["model"], model.meta["unit"],
                      job["inputs"], meta=meta, mesh=model.mesh)
    return out


def main():
    rank, world, coord, job_path, out_dir = sys.argv[1:6]
    dist.init_from_args(types.SimpleNamespace(num_processes=int(world), process_id=int(rank),
                                              coordinator=coord, dist_backend="gloo"),
                        torch.device("cpu"))
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    if "tp" in job:
        out = [run_tp(j) for j in job["tp"]]
    elif isinstance(job["serve"], list):
        out = [run_serve(j) for j in job["serve"]]
    else:
        out = run_serve(job["serve"])
    torch.save(out, f"{out_dir}/rank{rank}.pt")


if __name__ == "__main__":
    main()
