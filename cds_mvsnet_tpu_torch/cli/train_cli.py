"""Training: config-driven, over the DTU and BlendedMVS readers, with
``--lr``/``--bs``/``--epochs`` overrides, ``--resume`` and data parallelism.

Counterpart of ``cds_mvsnet_tpu/cli/train_cli.py``, with the same flags. It
runs on the card unless the caller asks for the CPU (``main(argv,
device="cpu")``):

    python -m cds_mvsnet_tpu_torch.cli.train_cli -c configs/config_dtu.json [--n_devices N]

The weights start from ``build_model``'s seeded init at ``train.seed`` (the
JAX package's ``init_cds_mvsnet`` draws other weights from the same seed).
``--n_devices N > 1`` starts one process a device (``nccl`` on the cards,
``gloo`` on the CPU), each reading its rank's slice of every global batch
of ``--bs``; the step and the validation are the global batch's
(``training/trainer.py``). It raises where fewer than N cards are visible,
and the run fails when a rank fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train CDS-MVSNet")
    p.add_argument("-c", "--config", required=True, help="JSON config path")
    p.add_argument("-r", "--resume", default=None, help="checkpoint to resume from")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--bs", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--n_devices", type=int, default=None, help="data-parallel width")
    return p


def build_loaders(cfg, batch_override=None, *, device="cuda", group=None):
    """``(train_loaders, val_loaders)``, one each per entry of ``cfg.data``:
    shuffled train batches without the ragged last one, and, where a
    ``val.txt`` (DTU) or ``validation_list.txt`` (BlendedMVS) lies beside
    the listfile, validation batches of 2 (DTU) or 5 views of 5
    (BlendedMVS). Under ``group`` each loader yields its rank's slice of
    every global batch (a train batch must split evenly); a validation
    batch the ranks cannot split evenly goes whole to every rank (the
    global means are the same)."""
    from ..data.blended import BlendedMVSDataset
    from ..data.dtu import DTUDataset
    from ..data.loader import DataLoader
    from ..parallel.distributed import process_local_batch_slice

    world = 1 if group is None else torch.distributed.get_world_size(group)

    def shard(bs):
        return process_local_batch_slice(bs, group) if group is not None and bs % world == 0 else None

    train_loaders, val_loaders = [], []
    for d in cfg.data:
        cls = {"dtu": DTUDataset, "blended": BlendedMVSDataset}[d.dataset]
        bs = batch_override or d.batch_size
        if bs % world:
            raise ValueError(f"a train batch of {bs} does not split over {world} ranks")
        train_ds = cls(d.datapath, d.listfile, mode="train", nviews=d.nviews, ndepths=d.ndepths,
                       interval_scale=d.interval_scale)
        train_loaders.append(DataLoader(train_ds, batch_size=bs, shuffle=True, drop_last=True, device=device,
                                        shard=shard(bs)))
        val_list = Path(d.listfile).with_name("val.txt" if d.dataset == "dtu" else "validation_list.txt")
        if val_list.exists():
            val_ds = cls(d.datapath, str(val_list), mode="val", nviews=5 if d.dataset != "dtu" else d.nviews,
                         ndepths=d.ndepths, interval_scale=d.interval_scale)
            val_bs = 2 if d.dataset == "dtu" else 5
            val_loaders.append(DataLoader(val_ds, batch_size=val_bs, drop_last=True, device=device,
                                          shard=shard(val_bs)))
    return train_loaders, val_loaders


def train(argv, device="cuda", group=None):
    """One rank's run (the only one without ``group``): the Trainer, after
    its epochs."""
    from ..config import Config
    from ..training.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = Config.load(args.config)
    if args.lr is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr=args.lr))
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, epochs=args.epochs))
    rank0 = group is None or torch.distributed.get_rank(group) == 0
    train_loaders, val_loaders = build_loaders(cfg, args.bs, device=device, group=group)
    trainer = Trainer(cfg, None, train_loaders, val_loaders, save_dir=args.save_dir, device=device, group=group,
                      log=print if rank0 else (lambda *a: None))
    if args.resume:
        trainer.resume(args.resume)
    trainer.train()
    return trainer


def _rank_main(rank: int, world: int, argv, device: str, init_method: str) -> None:
    from ..parallel.distributed import initialize_distributed

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    group = initialize_distributed("nccl" if cuda else "gloo", init_method, world, rank)
    try:
        train(argv, device=f"cuda:{rank}" if cuda else device, group=group)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None, device="cuda"):
    """Train; returns the Trainer (None under ``--n_devices N > 1``, whose
    ranks run in processes of their own). Raises without a card unless
    ``device="cpu"``."""
    from ..models.cds_mvsnet import resolve_device
    from ..parallel.distributed import spawn

    args = build_parser().parse_args(argv)
    world = args.n_devices or 1
    if world == 1:
        resolve_device(device)
        return train(argv, device=device)
    spawn(_rank_main, world, (sys.argv[1:] if argv is None else list(argv),), device)
    return None


if __name__ == "__main__":
    main()
