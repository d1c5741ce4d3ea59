"""Data parallelism end to end over N ranks: one train step, then eval
sharded over the reference views. Counterpart of the JAX package's
``__graft_entry__.py dryrun N``.

    python -m cds_mvsnet_tpu_torch.tools.dryrun_multichip N [--device cuda|cpu]

Each rank is a process with a device of its own (``nccl`` on the cards,
``gloo`` on the CPU; the process group is made even at N = 1, so that one
card runs the collectives). The step is the full fp32 train step of the
refined cascade on a synthetic batch of N at 64x64 (V = 3, D = 48), each
rank its slice, and its loss must be finite. The eval runs N + 1 views (the
padding path) through ``parallel.make_sharded_eval`` on every rank, and
each view's depth must match its own B = 1 forward at the JAX dryrun's
``rtol=2e-4, atol=2e-3``. Prints ``dryrun_multichip ok`` when every rank
passed; a rank's failure fails the run.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch
import torch.distributed as dist

SIZE = dict(V=3, H=64, W=64, D=48)
TIMEOUT_S = 600


def rank_main(rank: int, world: int, device: str, init_method: str) -> None:
    from ..config import ModelConfig, TrainConfig
    from ..models import build_model, to_tensors
    from ..parallel import data_mesh, make_sharded_eval, replicate, shard_batch
    from ..training import TrainStep
    from ..utils.synthetic import synthetic_batch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(2)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method, world_size=world, rank=rank)
    group = dist.group.WORLD
    try:
        dev = data_mesh(group, "cuda" if cuda else "cpu")
        model = replicate(build_model(ModelConfig(refine=True), seed=0, device=dev), group)
        step = TrainStep(model, TrainConfig(), group=group)
        batch = synthetic_batch(B=world, refine=True, with_gt=True, **SIZE)
        loss = float(step(to_tensors(shard_batch(batch, group), dev), 0.01)["loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"rank {rank}: non-finite loss {loss}")

        eval_model = build_model(ModelConfig(refine=False), seed=1, device=dev)
        views = [to_tensors(synthetic_batch(B=1, refine=False, seed=s, **SIZE), dev)
                 for s in range(world + 1)]
        imgs = torch.cat([v["imgs"] for v in views])
        proj = {k: torch.cat([v["proj_matrices"][k] for v in views]) for k in views[0]["proj_matrices"]}
        dv = torch.cat([v["depth_values"] for v in views])
        depth, conf = make_sharded_eval(eval_model, group)(imgs, proj, dv)
        if depth.shape[0] != world + 1 or conf.shape[0] != world + 1:
            raise RuntimeError(f"rank {rank}: sharded eval gave {tuple(depth.shape)}, {tuple(conf.shape)}")
        for c, v in enumerate(views):
            want = eval_model(v["imgs"], v["proj_matrices"], v["depth_values"], temperature=0.01)["refined_depth"]
            torch.testing.assert_close(depth[c], want[0].float(), rtol=2e-4, atol=2e-3,
                                       msg=lambda m: f"rank {rank}, view {c}: {m}")
        dist.barrier(group)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    from ..parallel.distributed import spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    spawn(rank_main, args.n_devices, (), args.device, timeout=TIMEOUT_S)
    print("dryrun_multichip ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
