"""Data parallelism over ``torch.distributed`` on the CPU: two ``gloo``
processes (an ``init_method`` file under ``tmp_path``, joined with a
timeout, a child's failure re-raised with its output).

(a) A fp32 train step on a batch of 2 split 1 + 1 equals one process's
    step on the same batch: the loss, every BN running statistic and the
    update of every trainable leaf. The two halves differ in mask counts and
    image statistics, so a per-rank loss mean or per-rank BN statistics
    would not pass by accident.
(b) The same step with the per-rank loss mean, and with per-rank BN
    statistics, fails (a).
(c) Eval sharded over 2 ranks on 3 views (padded to 4) against each view's
    own B = 1 forward, at the JAX package's tolerance.
(d) The ranks' loaders (``process_local_batch_slice``) together cover the
    one-process batch order.
(e) ``tools/dryrun_multichip.py``'s rank body (a train step, then eval
    sharded over 3 views) passes at 2 ranks.
The same two processes run (a) to (e), one after another: each costs about
a second once a process is warm, and its first train step several. A rank
that fails, or ranks past their time, fail the run; ``spawn`` itself, which
the tool's ``main`` calls, is tested on its own.

Every process of (a) and (b) runs the shipped
``epipolar_direction_quadratic``, whose root is correctly rounded to fp32
(taken in fp64, rounded once) and so the same in every process; the CPU's
fp32 ``torch.sqrt`` was neither (``tools/cpu_sqrt_repeat.py --root fp32``),
and this step turned its differences into a change of the update of 1.4e-3
to 5.9e-2 relative L2. So the processes differ by the split of the step
alone.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.data.loader import DataLoader
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.parallel import pad_to_multiple, process_local_batch_slice
from cds_mvsnet_tpu_torch.parallel.distributed import spawn
from cds_mvsnet_tpu_torch.training import TrainStep
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch, textured_plane_batch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TEMPERATURE = 1.0
TIMEOUT_S = 240
# (a)'s limits against one process: the loss and the running statistics
# (fp32 sums over the ranks in another order) to 1e-5 relative; the update of
# the trainable leaves, which inherits the gradients' ill-conditioning, to
# 1e-3 relative L2 over all leaves
LOSS_RTOL = STATS_RTOL = 1e-5
UPDATE_RTOL = 1e-3
# against the control: one process taking the group's arithmetic (two-pass
# BN statistics with autograd through them, where one process takes
# F.batch_norm) on the unsplit batch
CONTROL_RTOL = {"loss": 1e-6, "stats": 1e-5, "update": 1e-4}
GROUPS = {"feature": "FeatureNet", "stage_net": "vis heads", "cost_regularization": "cost reg",
          "refine_network": "refinement"}


def train_batch() -> dict:
    """``synthetic_batch`` at the train-step tests' smallest shape, B = 2;
    the second half's images darkened and most of its masks cut."""
    b = synthetic_batch(B=2, V=3, H=64, W=64, D=48, refine=True, with_gt=True, seed=1)
    b["imgs"][1] = 0.3 + 0.5 * b["imgs"][1]
    for m in b["mask"].values():
        m[1, :, : m.shape[2] * 2 // 3] = 0.0
    return b


def eval_views() -> list[dict]:
    return [textured_plane_batch(V=3, H=64, W=96, D=16, seed=s, plane_depth=550.0 + 20 * s) for s in range(3)]


class Indices:
    def __len__(self):
        return 13

    def __getitem__(self, i):
        return {"i": np.array([i])}


CHILD = textwrap.dedent('''
    import sys
    sys.path[:0] = [{repo!r}, {tests!r}]
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    rank, out, init, init_dryrun = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    from cds_mvsnet_tpu_torch.models import layers
    from cds_mvsnet_tpu_torch.parallel import data_mesh, initialize_distributed, make_sharded_eval, shard_batch
    from cds_mvsnet_tpu_torch.parallel import process_local_batch_slice
    from cds_mvsnet_tpu_torch.training import train_step
    from cds_mvsnet_tpu_torch.tools import dryrun_multichip
    import test_torch_distributed as T

    # (e): the tool's rank body, with a process group of its own
    dryrun_multichip.rank_main(rank, T.WORLD, "cpu", init_dryrun)
    group = initialize_distributed("gloo", init, T.WORLD, rank)
    local = T.to_tensors(shard_batch(T.train_batch(), group), data_mesh(group, "cpu"))
    results = {{}}
    final_loss, bn_train = train_step.final_loss, layers.batch_norm_train
    variants = {{
        "global": (final_loss, bn_train),
        # each rank's own masked means, averaged over the ranks
        "rank_loss": (lambda *a, group=None, **k: tuple(t / T.WORLD for t in final_loss(*a, **k)), bn_train),
        # each rank's own batch statistics
        "rank_bn": (final_loss, lambda *a, group=None, **k: bn_train(*a, **k)),
    }}
    for name, (loss_fn, bn_fn) in variants.items():
        train_step.final_loss, layers.batch_norm_train = loss_fn, bn_fn
        results.update({{f"{{name}}/{{k}}": v for k, v in T.run_step(local, group).items()}})
    train_step.final_loss, layers.batch_norm_train = final_loss, bn_train
    # the control: rank 0 alone, the whole batch through the group's arithmetic
    solo = dist.new_group([0])
    if rank == 0:
        results.update({{f"solo/{{k}}": v for k, v in T.run_step(T.to_tensors(T.train_batch(), "cpu"), solo).items()}})

    model = T.build_model(T.ModelConfig(refine=False), seed=1, device="cpu")
    views = [T.to_tensors(v, "cpu") for v in T.eval_views()]
    depth, conf = make_sharded_eval(model, group)(*T.stack_views(views))
    results["eval/depth"], results["eval/conf"] = depth.numpy(), conf.numpy()
    loader = T.DataLoader(T.Indices(), batch_size=4, device="cpu", shuffle=True, drop_last=True, seed=3,
                          shard=process_local_batch_slice(4, group))
    for e in range(2):
        results[f"loader/{{e}}"] = np.array([b["host"]["i"].ravel() for b in loader])
    results["dryrun/ok"] = np.array(True)
    np.savez(out, **results)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {{rank}} ok", flush=True)
''')


def run_step(batch: dict, group=None) -> dict:
    """One fp32 step from the seeded weights: the loss, each trainable
    leaf's update and each running statistic afterwards."""
    model = build_model(ModelConfig(refine=True), seed=0, device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    loss = float(TrainStep(model, TrainConfig(), group=group)(batch, TEMPERATURE)["loss"])
    out = {"loss": np.float64(loss)}
    out.update({f"update/{k}": (p.detach() - before[k]).numpy() for k, p in model.named_parameters()})
    out.update({f"stat/{k}": b.numpy().copy() for k, b in model.named_buffers()})
    return out


def stack_views(views):
    imgs = torch.cat([v["imgs"] for v in views])
    proj = {k: torch.cat([v["proj_matrices"][k] for v in views]) for k in views[0]["proj_matrices"]}
    return imgs, proj, torch.cat([v["depth_values"] for v in views])


def run_ranks(tmp_path: Path, script: str, argv=(), timeout: float = TIMEOUT_S) -> list[str]:
    """``script`` as ``WORLD`` processes ``script rank out init``: their
    outputs, each child's failure re-raised with its output."""
    path = tmp_path / "child.py"
    path.write_text(script)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(tmp_path / f"rank{r}.npz"), init, *argv],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    run_ranks(tmp, CHILD.format(repo=str(REPO), tests=str(REPO / "tests")),
              argv=(f"file://{tmp / 'rendezvous_dryrun'}",))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def one_process():
    return run_step(to_tensors(train_batch(), "cpu"))


def compare(got: dict, want: dict, prefix: str) -> dict:
    """(a)'s numbers for the variant ``prefix`` against one process."""
    loss_rel = abs(float(got[f"{prefix}/loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    stats = [k for k in want if k.startswith("stat/")]
    stat_rel = max(float(np.abs(got[f"{prefix}/{k}"] - want[k]).max() / max(np.abs(want[k]).max(), 1e-12))
                   for k in stats)
    updates = [k for k in want if k.startswith("update/")]

    def rel_l2(keys):
        num = sum(float(np.square(got[f"{prefix}/{k}"] - want[k]).sum()) for k in keys)
        return (num / sum(float(np.square(want[k]).sum()) for k in keys)) ** 0.5

    groups = {g: rel_l2([k for k in updates if k.split("/")[1].startswith(g)]) for g in GROUPS}
    return {"loss": loss_rel, "stats": stat_rel, "update": rel_l2(updates), **groups}


def test_epipolar_root_is_numpys_correctly_rounded_root():
    """The root inside ``epipolar_direction_quadratic`` at the 2-rank test's
    shape (the refined cascade's 32x32 FeatureNet input of the 64x64
    ``synthetic_batch``, its epipoles, at the FeatureNet's three scales)
    equals numpy's fp32 root bit for bit, as does the function's output the
    same formula on numpy's root."""
    from cds_mvsnet_tpu_torch.models.cds_mvsnet import pairwise_epipoles
    from cds_mvsnet_tpu_torch.models.dynamic_conv import (epipolar_direction_quadratic, epipolar_norm,
                                                          epipolar_offsets)

    b = to_tensors(train_batch(), "cpu")
    cams = b["proj_matrices"]["stage3"].float()
    ref_epi, src_epi = pairwise_epipoles(cams[:, 0], cams[:, 1:])
    epis = torch.cat([ref_epi.transpose(0, 1), src_epi.transpose(0, 1)]).reshape(-1, 2)
    for scale in (1, 2, 4):
        h = w = 32 // scale
        u, v = epipolar_offsets(epis / scale, h, w)
        root = epipolar_norm(u, v)
        want = np.sqrt((u * u + v * v).numpy())
        assert root.dtype == torch.float32 and np.array_equal(root.numpy().view(np.int32), want.view(np.int32))
        un, vn = u / (torch.from_numpy(want) + 1e-6), v / (torch.from_numpy(want) + 1e-6)
        assert torch.equal(epipolar_direction_quadratic(epis / scale, h, w),
                           torch.stack([un * un, 2 * un * vn, vn * vn], dim=1))


def test_the_halves_differ():
    b = train_batch()
    counts = [float(b["mask"]["stage3"][i].sum()) for i in range(2)]
    assert counts[0] > 2 * counts[1] > 0
    assert abs(b["imgs"][0].mean() - b["imgs"][1].mean()) > 0.05


def test_ranks_hold_the_same_weights(ranks):
    """Every rank applied the same update: the step is one global step."""
    for k in ranks[0]:
        if k.startswith(("global/update", "global/stat", "global/loss")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def control(ranks) -> dict:
    return {k.removeprefix("solo/"): v for k, v in ranks[0].items() if k.startswith("solo/")}


def test_two_rank_step_equals_one_process(ranks, one_process):
    got = compare(ranks[0], one_process, "global")
    print({"a": got})
    assert got["loss"] <= LOSS_RTOL, got
    assert got["stats"] <= STATS_RTOL, got
    assert got["update"] <= UPDATE_RTOL, got
    assert len([k for k in one_process if k.startswith("stat/")]) > 60


def test_two_rank_step_equals_the_control(ranks):
    """Against one process taking the same arithmetic on the unsplit batch,
    the two ranks' step agrees far more tightly: what remains is the order
    of the sums over the ranks."""
    got = compare(ranks[0], control(ranks), "global")
    print({"against the control": got})
    assert all(got[k] <= CONTROL_RTOL[k] for k in CONTROL_RTOL), got


@pytest.mark.parametrize("variant,misses", [("rank_loss", ("loss", "update")),
                                            ("rank_bn", ("loss", "stats", "update"))])
def test_per_rank_variants_fail(ranks, one_process, variant, misses):
    """Each rank's own masked means (averaged over the ranks), or each
    rank's own BN statistics: (a) fails, against one process and against
    the control."""
    limits = {"loss": LOSS_RTOL, "stats": STATS_RTOL, "update": UPDATE_RTOL}
    for want, lim in ((one_process, limits), (control(ranks), CONTROL_RTOL)):
        got = compare(ranks[0], want, variant)
        print({variant: got})
        assert [k for k in limits if got[k] > lim[k]] == list(misses), got


def test_sharded_eval_matches_per_view_forwards(ranks):
    model = build_model(ModelConfig(refine=False), seed=1, device="cpu")
    views = [to_tensors(v, "cpu") for v in eval_views()]
    for r in range(WORLD):
        assert ranks[r]["eval/depth"].shape[0] == len(views) == ranks[r]["eval/conf"].shape[0]
    for i, v in enumerate(views):
        with torch.no_grad():
            out = model(v["imgs"], v["proj_matrices"], v["depth_values"], temperature=0.01)
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r]["eval/depth"][i], out["refined_depth"][0].numpy(), rtol=2e-4,
                                       atol=2e-3)
            np.testing.assert_allclose(ranks[r]["eval/conf"][i], out["stage3"]["photometric_confidence"][0].numpy(),
                                       rtol=2e-4, atol=2e-3)


def test_pad_to_multiple_repeats_the_last_view():
    b = {"a": torch.arange(3.0), "d": {"b": torch.arange(6.0).reshape(3, 2)}}
    padded, n = pad_to_multiple(b, 2)
    assert n == 3 and padded["a"].tolist() == [0, 1, 2, 2] and padded["d"]["b"][-1].tolist() == [4, 5]
    assert pad_to_multiple(b, 3)[0] is b


def test_rank_loaders_cover_the_one_process_order(ranks):
    whole = DataLoader(Indices(), batch_size=4, device="cpu", shuffle=True, drop_last=True, seed=3)
    for e in range(2):
        want = [b["host"]["i"].ravel().tolist() for b in whole]
        got = np.concatenate([ranks[r][f"loader/{e}"] for r in range(WORLD)], axis=1).tolist()
        assert got == want


def test_process_local_batch_slice_without_a_group():
    assert process_local_batch_slice(8) == (0, 8)


def test_dryrun_multichip_prints_ok(ranks):
    """(e): ``dryrun_multichip.rank_main`` (a finite-loss step over the
    group, sharded eval on world + 1 views against per-view forwards) ran
    on both ranks of ``ranks`` before their own checks; its ``main`` adds
    the ``spawn`` of the ranks and the ``dryrun_multichip ok`` line
    (``chip_smoke.py`` runs it on the card)."""
    assert [bool(r["dryrun/ok"]) for r in ranks] == [True] * WORLD


def failing_rank(rank, world, device, init_method):
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(120)  # as a rank waiting on the failed one would


def test_a_failed_rank_fails_the_run():
    from torch.multiprocessing import ProcessRaisedException

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        spawn(failing_rank, WORLD, (), "cpu")
    assert time.monotonic() - t0 < 60  # the waiting rank was stopped


def test_ranks_past_the_timeout_are_stopped():
    with pytest.raises(TimeoutError):
        spawn(failing_rank, 1, (), "cpu", timeout=1)
