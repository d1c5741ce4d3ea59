"""The operations on the port's default paths that PyTorch knows to be
nondeterministic on the card.

    python -m cds_mvsnet_tpu_torch.tools.nondeterministic_ops [--device cuda|cpu] [--serve HxW] [--train HxW]

Runs four workloads with seeded random weights: a default fp32 request and a
default bf16 request at ``chip_smoke.py``'s serve point (1152x864, V=5,
D=192, ndepths 48/32/8, no refinement), and a bf16 train step on the kernel
path and an fp32 train step at its train point (512x640, B=2, V=5,
refinement, FeatureNet recomputed in the backward). Each runs twice:

1. under ``torch.use_deterministic_algorithms(True, warn_only=True)``, which
   warns at each operation that has no deterministic form (and at cuBLAS
   calls without ``CUBLAS_WORKSPACE_CONFIG``): the distinct messages;
2. without that switch, as the port runs, under a dispatch mode that
   records every ATen operation, backward included: those whose CUDA form
   PyTorch lists as nondeterministic unless the switch is set
   (``NONDETERMINISTIC``: adds with atomics, or switches to another
   algorithm under it), with their counts; ``index_put_`` is recorded with
   its ``accumulate`` flag, since its accumulating form sorts and repeats;
   the convolutions, which follow ``torch.backends.cudnn.deterministic``,
   with that flag.

One JSON line per workload, after the card's ``nvidia-smi`` name and power
limit. ``--device cpu`` with small ``--serve``/``--train`` sizes runs the
same recording on the CPU (the operations, not their CUDA forms, run).
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ATen operations (by overload packet) that PyTorch's
# torch.use_deterministic_algorithms documents as nondeterministic on CUDA
# tensors without the switch: the ones it makes deterministic under it, and
# the ones for which it then raises
NONDETERMINISTIC = frozenset({
    "scatter_add", "scatter_add_", "index_add", "index_add_", "index_put", "index_put_", "_index_put_impl_",
    "index_copy", "index_copy_", "scatter", "scatter_", "scatter_reduce", "scatter_reduce_", "put", "put_",
    "index_reduce", "index_reduce_", "embedding_dense_backward", "_embedding_bag_dense_backward",
    "_embedding_bag_backward", "max_pool3d_with_indices_backward", "replication_pad1d_backward",
    "replication_pad2d_backward", "replication_pad3d_backward", "reflection_pad1d_backward",
    "reflection_pad2d_backward", "reflection_pad3d_backward", "avg_pool3d_backward",
    "_adaptive_avg_pool2d_backward", "_adaptive_avg_pool3d_backward", "adaptive_max_pool2d_backward",
    "adaptive_max_pool3d_backward", "fractional_max_pool2d_backward", "fractional_max_pool3d_backward",
    "max_unpool2d", "max_unpool3d", "upsample_linear1d_backward", "upsample_bilinear2d_backward",
    "upsample_bicubic2d_backward", "upsample_trilinear3d_backward", "grid_sampler_2d_backward",
    "grid_sampler_3d_backward", "nll_loss2d_forward", "_ctc_loss_backward", "histc", "bincount", "median",
    "cumsum", "cumsum_", "kthvalue",
})
CONVOLUTIONS = frozenset({"convolution", "convolution_backward", "cudnn_convolution", "cudnn_convolution_transpose"})


class Recorder(TorchDispatchMode):
    """Counts the ATen operations of NONDETERMINISTIC and CONVOLUTIONS that
    run under it, and all operations."""

    def __init__(self):
        super().__init__()
        self.found, self.total = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.total += 1
        if name in NONDETERMINISTIC or name in CONVOLUTIONS:
            if name in ("index_put", "index_put_", "_index_put_impl_"):
                acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
                name = f"{name}(accumulate={bool(acc)})"
            self.found[name] = self.found.get(name, 0) + 1
        return func(*args, **kwargs)


def workloads(device: str, serve: tuple[int, int], train: tuple[int, int]) -> dict:
    """Closures of the four workloads, each building what it needs."""
    from ..config import ModelConfig, TrainConfig
    from ..models import build_model, to_tensors
    from ..training import TrainStep
    from ..utils.synthetic import synthetic_batch, textured_plane_batch

    model = build_model(ModelConfig(refine=False, ndepths=(48, 32, 8)), seed=0, device=device)
    b = to_tensors(textured_plane_batch(V=5, H=serve[0], W=serve[1], D=192, seed=0), device)
    tmodel = build_model(ModelConfig(refine=True, ndepths=(48, 32, 8)), seed=0, device=device)
    tb = to_tensors(synthetic_batch(B=2, V=5, H=train[0], W=train[1], D=192, refine=True, with_gt=True, seed=0),
                    device)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}

    def request(dtype):
        return lambda: model(b["imgs"], b["proj_matrices"], b["depth_values"], compute_dtype=dtype)

    def step(dtype):
        def run():
            tmodel.load_state_dict(start)
            TrainStep(tmodel, TrainConfig(compute_dtype=dtype, remat_features=True))(tb, 0.01)
        return run

    return {"request_fp32": request(torch.float32), "request_bf16": request(torch.bfloat16),
            "train_step_bf16": step("bf16"), "train_step_fp32": step("fp32")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--serve", default="864x1152", help="HxW of the requests")
    ap.add_argument("--train", default="512x640", help="HxW of the train batch")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("nondeterministic_ops: needs the card (or --device cpu)", file=sys.stderr)
        return 2
    if args.device == "cuda":
        from ._timing import card

        where = card()
    else:
        where = "cpu"
    size = {k: tuple(int(x) for x in getattr(args, k).split("x")) for k in ("serve", "train")}
    print(json.dumps({"card": where, **{k: list(v) for k, v in size.items()}}), flush=True)
    runs = workloads(args.device, size["serve"], size["train"])
    for name, run in runs.items():
        run()  # warm-up
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                run()
                if args.device == "cuda":
                    torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        messages = sorted({str(w.message).splitlines()[0] for w in caught
                           if "deterministic" in str(w.message) or "CuBLAS" in str(w.message)})
        rec = Recorder()
        with rec:
            run()
        print(json.dumps({"workload": name, "warn_only_warnings": messages, "recorded": rec.found,
                          "operations": rec.total,
                          "cudnn_deterministic": torch.backends.cudnn.deterministic}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
