"""The port's spans (``utils/profiling.py::span``): the shared null context
while no profiler records, a ``record_function`` range while one does, and
the tree of ``cds.*`` ranges that an eval forward and a train step leave in
the profiler's Chrome trace, each inside its parent on the same thread."""

from __future__ import annotations

import contextlib
import inspect
import json
import threading
from collections import Counter

import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.training import TrainStep
from cds_mvsnet_tpu_torch.utils import profiling
from cds_mvsnet_tpu_torch.utils.profiling import span
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch

torch.set_num_threads(2)

SIZE = dict(B=2, V=3, H=64, W=64, D=48, refine=True, with_gt=True, seed=1)
STAGES = ("cds.stage1", "cds.stage2", "cds.stage3")
# each span and the span it lies in
EVAL_TREE = {"cds.inputs": "cds.forward", "cds.feature": "cds.forward", "cds.refine": "cds.forward",
             **{s: "cds.forward" for s in STAGES}, **{f"{s}.volume": s for s in STAGES},
             **{f"{s}.cost_reg": s for s in STAGES}}
# the FeatureNet's blocks, in call order (``FeatureNet.__init__``'s names)
BLOCKS = tuple(f"cds.feature.{b}" for b in ("conv00", "conv01", "downsample1", "conv10", "conv11", "downsample2",
                                            "conv20", "conv21", "out1", "inner1", "out2", "inner2", "out3"))
EVAL_TREE.update(dict.fromkeys(BLOCKS, "cds.feature"))
PHASES = ("cds.step.forward", "cds.step.loss", "cds.step.backward", "cds.step.optimizer", "cds.step.bn_apply")


@pytest.fixture(scope="module")
def batch():
    return to_tensors(synthetic_batch(**SIZE), "cpu")


def recorded(run, tmp_path) -> list:
    """The ``cds.*`` ranges ``run()`` leaves in the Chrome trace of a
    ``torch.profiler`` session: ``[(name, start, end, tid)]`` in start
    order, each a ``user_annotation`` as the trace's readers expect."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("cds.")]
    assert {e["cat"] for e in ranges} == {"user_annotation"}
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in ranges]
    return sorted(spans, key=lambda r: (r[1], -r[2]))


def parents(ranges, name, parent) -> list:
    """For each range named ``name``, the ranges named ``parent`` that hold
    it on its thread."""
    return [[p for p in ranges if p[0] == parent and p[3] == r[3] and p[1] <= r[1] and r[2] <= p[2]]
            for r in ranges if r[0] == name]


def assert_tree(ranges, tree) -> None:
    for name, parent in tree.items():
        held = parents(ranges, name, parent)
        assert held and all(len(p) == 1 for p in held), (name, parent, held)


def test_span_outside_a_profiler_is_the_shared_null_context(monkeypatch):
    """With no session recording, every name gives the same null context
    and ``record_function`` is never built."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = span("cds.forward"), span("cds.step.backward")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with span("cds.stage1"):
        with span("cds.stage1.volume"):
            pass


def test_span_records_on_the_profiling_thread_only(tmp_path):
    """Under a session, a span is a ``record_function`` range on the thread
    that started it; another thread, which the session does not record,
    gets the null context."""
    others = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("cds.test") as here:
            torch.ones(8, 8) @ torch.ones(8, 8)
        t = threading.Thread(target=lambda: others.append(span("cds.other")))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert isinstance(span("cds.test"), contextlib.nullcontext)
    assert not isinstance(here, contextlib.nullcontext)
    assert others and isinstance(others[0], contextlib.nullcontext)
    assert [e.name for e in prof.events() if e.name.startswith("cds.")] == ["cds.test"]


def test_profiling_holds_span_and_device_trace_only():
    """The module has no clock of its own and never waits on the device:
    no ``perf_counter``, no ``synchronize``, no environment switch."""
    assert sorted(profiling.__all__) == ["device_trace", "span"]
    src = inspect.getsource(profiling)
    for word in ("perf_counter", "synchronize", "environ", "getenv"):
        assert word not in src, word


@pytest.mark.parametrize("compute_dtype, kernels", [(torch.float32, True), (torch.bfloat16, False)])
def test_eval_forward_records_the_span_tree(batch, tmp_path, compute_dtype, kernels):
    """One eval forward (B = 2, V = 3, refinement): one ``cds.forward``
    holding the inputs, the FeatureNet, the three stages and the
    refinement; in the FeatureNet one span a block, in call order; in each
    stage one volume span (the volume is built over the whole batch) and a
    cost-reg span per batch element."""
    model = build_model(ModelConfig(refine=True), seed=0, device="cpu")
    ranges = recorded(lambda: model(batch["imgs"], batch["proj_matrices"], batch["depth_values"],
                                    compute_dtype=compute_dtype, kernels=kernels), tmp_path)
    B = SIZE["B"]
    want = {"cds.forward": 1, "cds.inputs": 1, "cds.feature": 1, "cds.refine": 1,
            **{s: 1 for s in STAGES}, **{f"{s}.volume": 1 for s in STAGES}, **{f"{s}.cost_reg": B for s in STAGES},
            **dict.fromkeys(BLOCKS, 1)}
    assert Counter(r[0] for r in ranges) == want
    assert_tree(ranges, EVAL_TREE)
    assert [r[0] for r in ranges if r[0] in BLOCKS] == list(BLOCKS)
    order = [r[0] for r in ranges if r[0].count(".") == 1]
    assert order == ["cds.forward", "cds.inputs", "cds.feature", *STAGES, "cds.refine"]


def test_spans_leave_the_forward_unchanged(batch):
    """A forward under the profiler gives the same outputs, bit for bit, as
    one without it."""
    model = build_model(ModelConfig(refine=True), seed=0, device="cpu")

    def run():
        return model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])

    plain = run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = run()
    assert torch.equal(plain["refined_depth"], traced["refined_depth"])
    for s in ("stage1", "stage2", "stage3"):
        for k in ("depth", "photometric_confidence"):
            assert torch.equal(plain[s][k], traced[s][k]), (s, k)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_records_its_phases(batch, tmp_path, remat):
    """One ``TrainStep`` call: ``cds.step`` holding its five phases in
    order, the cascade's spans inside ``cds.step.forward`` (one volume and
    one cost-reg span a stage); with ``remat_features`` the FeatureNet's
    recompute records a second ``cds.feature``, inside the backward (on the
    CPU autograd runs on the calling thread)."""
    model = build_model(ModelConfig(refine=True), seed=0, device="cpu")
    step = TrainStep(model, TrainConfig(remat_features=remat))
    ranges = recorded(lambda: step(batch, 1.0, epoch=1), tmp_path)
    counts = Counter(r[0] for r in ranges)
    assert counts["cds.step"] == 1
    assert all(counts[p] == 1 for p in PHASES)
    assert [r[0] for r in ranges if r[0] in PHASES] == list(PHASES)
    assert_tree(ranges, {**{p: "cds.step" for p in PHASES}, "cds.forward": "cds.step.forward"})
    tree = {k: v for k, v in EVAL_TREE.items() if k != "cds.feature"}
    assert_tree(ranges, tree)
    assert all(counts[f"{s}.volume"] == counts[f"{s}.cost_reg"] == 1 for s in STAGES)
    assert counts["cds.feature"] == (2 if remat else 1)
    assert all(counts[b] == counts["cds.feature"] for b in BLOCKS)
    assert_tree(ranges, dict.fromkeys(BLOCKS, "cds.feature"))
    assert len(parents(ranges, "cds.feature", "cds.forward")[0]) == 1
    if remat:
        assert [len(p) for p in parents(ranges, "cds.feature", "cds.step.backward")] == [0, 1]
