"""The system under test, ``cds_mvsnet_tpu_torch``, as the benchmark drives
it: the model built from a configuration with the benchmark's weights, the
train step, the port's launch counters, and the hooks the benchmark hangs
on the port's modules (spans for the trace, and the capture of what the
timed path produced for the correctness check). Nothing of the program is
edited: hooks are ``torch.nn.Module`` forward hooks.
"""

from __future__ import annotations

import torch

from .reference.model import FEATURE_BLOCKS

__all__ = ["Capture", "build_model", "launch_counts", "span_hooks", "train_step"]

REFINE_PIECES = ("conv0", "conv1", "conv2", "bn", "conv3")


def _model_config(cfg: dict):
    from cds_mvsnet_tpu_torch.config import ModelConfig

    m = cfg["model"]
    return ModelConfig(refine=m["refine"], ndepths=tuple(m["ndepths"]),
                       depth_intervals_ratio=tuple(m["depth_intervals_ratio"]), share_cr=m["share_cr"],
                       cr_base_chs=tuple(m["cr_base_chs"]), grad_method=m["grad_method"])


def parameter_shapes(cfg: dict) -> dict:
    """``{state_dict key: shape}`` of the configuration's model, built on
    the meta device."""
    from cds_mvsnet_tpu_torch.models.cds_mvsnet import CDSMVSNet

    with torch.device("meta"):
        model = CDSMVSNet(_model_config(cfg))
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def build_model(cfg: dict, state: dict, device):
    """The port's model with the benchmark's weights, in eval mode, with
    the port's own card set-up (``strict_fp32``: TF32 off, deterministic
    cuDNN) on a card."""
    from cds_mvsnet_tpu_torch.models.cds_mvsnet import CDSMVSNet, strict_fp32

    dev = torch.device(device)
    if dev.type == "cuda":
        strict_fp32()
    model = CDSMVSNet(_model_config(cfg)).to(dev)
    model.load_state_dict(state)
    return model.eval()


def train_step(model, cfg: dict, group=None):
    """The port's ``TrainStep`` with the configuration's train settings."""
    from cds_mvsnet_tpu_torch.config import TrainConfig
    from cds_mvsnet_tpu_torch.training.train_step import TrainStep

    t = cfg["train"]
    tc = TrainConfig(lr=t["lr"], weight_decay=t["weight_decay"], momentum=t["momentum"], dlossw=tuple(t["dlossw"]),
                     compute_dtype=t["compute_dtype"], remat_features=t["remat_features"])
    return TrainStep(model, tc, kernels=True, group=group)


def launch_counts() -> dict:
    """The port's hand-written kernels' launch counters, by wrapper name."""
    from cds_mvsnet_tpu_torch.tools._common import all_kernels

    return {name: k.launches for name, k in all_kernels().items()}


def span_hooks(model) -> list:
    """``record_function`` ranges around the port's layers, from forward
    pre- and post-hooks: ``feature`` (the FeatureNet), ``vis.s<i>`` (each
    stage's vis head), ``cost_reg.s<i>`` (each CostRegNet), ``refine``.
    Returns the hook handles."""
    mods = [("feature", model.feature), ("refine", getattr(model, "refine_network", None))]
    for i in range(model.cfg.num_stages):
        mods.append((f"vis.s{i + 1}", model.stage_net.vis[str(i)]))
        if not model.cfg.share_cr:
            mods.append((f"cost_reg.s{i + 1}", model.cost_regularization[str(i)]))
    handles = []
    for name, mod in mods:
        if mod is None:
            continue
        stack = []

        def pre(m, args, name=name, stack=stack):
            rf = torch.profiler.record_function(f"mvsbench.{name}")
            rf.__enter__()
            stack.append(rf)

        def post(m, args, out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


class Capture:
    """Keeps what the FeatureNet and each of its blocks, and the
    refinement's blocks and the refinement itself, took and returned, for
    the forwards run while ``active``: references to the program's own
    tensors, no copy and no launch."""

    def __init__(self, model):
        self.active = False
        self.calls: list = []
        self._current = None
        self.handles = [model.feature.register_forward_pre_hook(self._begin),
                        model.feature.register_forward_hook(self._end)]
        for name in FEATURE_BLOCKS:
            self.handles.append(getattr(model.feature, name).register_forward_hook(
                lambda m, a, o, name=name: self._block(name, a, o)))
        refine = getattr(model, "refine_network", None)
        if refine is not None:
            for name in REFINE_PIECES:
                self.handles.append(getattr(refine, name).register_forward_hook(
                    lambda m, a, o, name=name: self._refine(name, a, o)))
            self.handles.append(refine.register_forward_hook(lambda m, a, o: self._refine("out", a, o)))

    def _begin(self, m, args):
        self._current = {"blocks": {}} if self.active else None

    def _block(self, name, args, out):
        if self._current is not None:
            self._current["blocks"][name] = (args[0], args[1] if len(args) > 1 and torch.is_tensor(args[1]) else None,
                                             out)

    def _refine(self, name, args, out):
        if self.active and self.calls:
            self.calls[-1].setdefault("refine", {})[name] = (args, out)

    def _end(self, m, args, out):
        if self._current is not None:
            self._current["epipole"] = args[1]
            self._current["features"] = out
            self.calls.append(self._current)
            self._current = None
