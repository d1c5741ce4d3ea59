"""One fp32 train step of the port against ``make_train_step`` of the JAX
package, on the same bridged weights and the same synthetic batch
(``tests/test_trainer.py``'s size: B=1, V=3, 64x64, D=48, refine, T=1)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.config import TrainConfig as JaxTrainConfig
from cds_mvsnet_tpu.models.cds_mvsnet import init_cds_mvsnet
from cds_mvsnet_tpu.models.convert import flatten_params
from cds_mvsnet_tpu.training import train_step as jts
from cds_mvsnet_tpu.utils.synthetic import synthetic_batch as jax_synthetic_batch
from cds_mvsnet_tpu_torch.config import ModelConfig, TrainConfig
from cds_mvsnet_tpu_torch.models import build_model, to_tensors
from cds_mvsnet_tpu_torch.models.convert import _to_jax_layout, params_to_jax
from cds_mvsnet_tpu_torch.models.layers import StatsCollector
from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.training import TrainStep, learning_rate, temperature_schedule
from cds_mvsnet_tpu_torch.utils.synthetic import synthetic_batch
from test_torch_ops import jax_highest

torch.set_num_threads(2)

SIZE = dict(B=1, V=3, H=64, W=64, D=48, refine=True, with_gt=True, seed=1)
TEMPERATURE = 1.0
MOMENTUM = 0.1


def is_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def is_vis(key: str) -> bool:
    return key.startswith("stage_net.vis.")


def capture_gradients(tx: optax.GradientTransformation) -> optax.GradientTransformation:
    """``tx`` that also keeps the raw gradients it was given in its state,
    so that the jitted JAX step hands them out unchanged."""

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, jax.jit(init_cds_mvsnet, static_argnums=1)(
        jax.random.PRNGKey(0), JaxModelConfig(refine=True)))
    jbatch = jax.tree.map(jnp.asarray, jax_synthetic_batch(**SIZE))
    cfg = JaxTrainConfig()
    tx, sched = jts.make_optimizer(cfg, params)
    tx = capture_gradients(tx)
    state = jts.TrainState(params, tx.init(params), jnp.int32(1))
    with jax_highest():
        step = jts.make_train_step(JaxModelConfig(refine=True), cfg, tx, sched, donate=False)
        new_state, metrics = step(state, jbatch, jnp.float32(TEMPERATURE))
    want = flatten_params(jax.tree.map(np.asarray, new_state.params))
    all_grads = flatten_params(jax.tree.map(np.asarray, new_state.opt_state[1]))
    batch = to_tensors(synthetic_batch(**SIZE), "cpu")

    # the port: the batch statistics of one forward (for the vis heads),
    # then the step from the same weights
    model = build_model(ModelConfig(refine=True), params=params, device="cpu")
    stats = StatsCollector()
    model.forward_train(batch["imgs"], batch["proj_matrices"], batch["depth_values"], batch["depth"], stats,
                        temperature=TEMPERATURE)
    names = {id(m): n for n, m in model.named_modules()}
    calls = [(names[id(bn)], mean, var) for bn, mean, var, _ in stats.calls]
    got_metrics = TrainStep(model, TrainConfig())(batch, TEMPERATURE, epoch=1)
    # the step leaves each leaf's gradient in .grad
    got_grads = {k: _to_jax_layout(k, p.grad.numpy()) for k, p in model.named_parameters()}
    want_grads = {k: all_grads[k] for k in got_grads}
    return {"params": params, "want": want, "want_metrics": metrics, "model": model, "calls": calls,
            "got": flatten_params(params_to_jax(model)), "got_metrics": got_metrics, "batch": batch,
            "want_grads": want_grads, "got_grads": got_grads}


def test_synthetic_batch_is_the_jax_one():
    a, b = synthetic_batch(**SIZE), jax_synthetic_batch(**SIZE)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_loss_matches_jax(setup):
    # fp32 on both sides, sums in other orders
    for key in ("loss", "depth_loss"):
        np.testing.assert_allclose(float(setup["got_metrics"][key]), float(setup["want_metrics"][key]), rtol=1e-4)


# Tolerance of a leaf's gradient against JAX's, relative L2. Measured on
# this step: the worst leaf (the stage-3 vis head's first BN bias) differs by
# 6.9e-3, and the port's own gradient of that leaf moves by as much when the
# images change by 1e-6 relative (test_gradients_are_ill_conditioned_in_the_
# inputs: BNs normalise nearly constant maps, GT-window targets flip); 191 of
# the 228 leaves agree within 1e-4.
GRAD_RTOL = 1e-2


def gradient_mismatches(got: dict, want: dict) -> list[str]:
    """The leaves whose gradient is not within GRAD_RTOL of JAX's."""
    assert got.keys() == want.keys()
    return [k for k in want
            if np.linalg.norm(got[k] - want[k]) > GRAD_RTOL * np.linalg.norm(want[k])]


def test_gradients_match_jax(setup):
    got, want = setup["got_grads"], setup["want_grads"]
    trainable = [k for k in flatten_params(setup["params"]) if not is_stat(k)]
    assert sorted(got) == sorted(trainable) and len(trainable) > 200
    assert all(np.linalg.norm(want[k]) > 0 for k in trainable)  # the loss reaches every leaf
    assert gradient_mismatches(got, want) == []
    close = sum(np.linalg.norm(got[k] - want[k]) <= 1e-4 * np.linalg.norm(want[k]) for k in trainable)
    assert close >= 0.8 * len(trainable), close


@pytest.mark.parametrize("fault", ["zeroed", "scaled by 1.05"])
def test_gradient_check_catches_a_faulty_leaf(setup, fault):
    """Planted faults: any one leaf's gradient missing, or 5 % off, fails
    the comparison above."""
    got, want = setup["got_grads"], setup["want_grads"]
    for k in got:
        bad = got[k] * (0.0 if fault == "zeroed" else 1.05)
        assert gradient_mismatches({**got, k: bad}, want) == [k], k


def test_updated_trainable_leaves_match_jax(setup):
    """The step's change of every trainable leaf, ``-lr (g + wd p)``, against
    JAX's. It inherits the gradient's tolerance; reading the change back as
    ``p_after - p_before`` in fp32 adds at most 6e-4 relative here."""
    want, got, before = setup["want"], setup["got"], flatten_params(setup["params"])
    assert want.keys() == got.keys()
    trainable = [k for k in want if not is_stat(k)]
    for k in trainable:
        d_got, d_want = got[k] - before[k], want[k] - before[k]
        assert np.linalg.norm(d_got - d_want) <= GRAD_RTOL * np.linalg.norm(d_want), k


def test_running_statistics_match_jax(setup):
    """Every BN running statistic except the vis heads' (see below) equals
    JAX's, including the FeatureNet's per-call sequential EMA."""
    want, got, before = setup["want"], setup["got"], flatten_params(setup["params"])
    keys = [k for k in want if is_stat(k) and not is_vis(k)]
    assert len(keys) > 60
    for k in keys:
        assert not np.array_equal(got[k], before[k]), k
        # fp32 batch statistics summed in another order
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _vis_calls(setup, module: str, stat: int):
    """The per-view batch statistics (index 1 mean, 2 unbiased var) the
    port recorded for one vis-head BN, in call order."""
    return [c[stat][0].numpy() for c in setup["calls"] if c[0] == module]


@pytest.mark.parametrize("which,stat", [("running_mean", 1), ("running_var", 2)])
def test_vis_head_statistics_follow_the_sequential_ema(setup, which, stat):
    """The port moves a vis head's statistics once per source view, as
    upstream torch does: r <- 0.9 r + 0.1 m_v for v = 1 .. V-1."""
    before, got = flatten_params(setup["params"]), setup["got"]
    keys = [k for k in got if is_vis(k) and k.endswith(which)]
    assert len(keys) == 9  # 3 stages x 3 ConvBnReLU
    for k in keys:
        per_view = _vis_calls(setup, k.rsplit(".", 1)[0], stat)
        assert len(per_view) == SIZE["V"] - 1
        r = before[k]
        for m in per_view:
            r = (1 - MOMENTUM) * r + MOMENTUM * m
        np.testing.assert_allclose(got[k], r, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("which,stat", [("running_mean", 1), ("running_var", 2)])
def test_jax_keeps_only_the_last_views_vis_statistics(setup, which, stat):
    """The JAX package's collector keeps one update per path, so its vis
    heads end at 0.9 r + 0.1 m_{V-1}: the last view's update alone. The
    port's last-view statistics reproduce that value, and the port's own
    running statistics differ from it."""
    before, want, got = flatten_params(setup["params"]), setup["want"], setup["got"]
    for k in [k for k in want if is_vis(k) and k.endswith(which)]:
        last = _vis_calls(setup, k.rsplit(".", 1)[0], stat)[-1]
        np.testing.assert_allclose(want[k], (1 - MOMENTUM) * before[k] + MOMENTUM * last, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert np.abs(got[k] - want[k]).max() > 1e-4, k


def test_gradients_are_ill_conditioned_in_the_inputs(setup):
    """Why the gradients above and the card's kernel-vs-plain gradient gate
    need a looser tolerance than the loss: a 1e-6 relative
    change of the input images moves this step's loss by far less than 1e-4
    but some leaves' gradients by more than 1e-2."""
    model = build_model(ModelConfig(refine=True), params=setup["params"], device="cpu")
    step = TrainStep(model, TrainConfig())
    batch = setup["batch"]
    noise = torch.randn(batch["imgs"].shape, generator=torch.Generator().manual_seed(5))
    runs = []
    for eps in (0.0, 1e-6):
        metrics, _ = step.gradients({**batch, "imgs": batch["imgs"] * (1 + eps * noise)}, TEMPERATURE)
        runs.append((float(metrics["loss"]), [p.grad.clone() for p in step.params]))
    (loss0, g0), (loss1, g1) = runs
    assert abs(loss1 - loss0) / abs(loss0) < 1e-4
    worst = max(float((a - b).norm() / a.norm()) for a, b in zip(g0, g1) if a.norm() > 0)
    assert worst > 1e-2, worst


def test_remat_changes_nothing(setup):
    """Recomputing the FeatureNet in the backward gives the same parameters
    and running statistics, bit for bit: the recompute's BN records are
    dropped, so no statistic moves twice."""
    states = []
    for remat in (False, True):
        model = build_model(ModelConfig(refine=True), params=setup["params"], device="cpu")
        TrainStep(model, TrainConfig(remat_features=remat))(setup["batch"], TEMPERATURE, epoch=1)
        states.append(model.state_dict())
    for k, v in setup["model"].state_dict().items():
        assert torch.equal(states[0][k], states[1][k]), k
        assert torch.equal(states[1][k], v), k  # and the same as the first run


def test_bf16_on_the_cpu_takes_the_plain_warp(setup):
    """On CPU tensors the K5 route runs its plain version: the same step as
    kernels=False, no launch counted; the loss stays near the fp32 one."""
    losses = []
    for kernels in (True, False):
        for k in K.TRAIN_KERNELS:
            k.launches = 0
        model = build_model(ModelConfig(refine=True), params=setup["params"], device="cpu")
        out = TrainStep(model, TrainConfig(compute_dtype="bf16"), kernels=kernels)(setup["batch"], TEMPERATURE)
        assert [k.launches for k in K.TRAIN_KERNELS] == [0, 0]
        losses.append(float(out["loss"]))
    assert losses[0] == losses[1]
    # bf16 features, volumes and convolutions: a few percent of the loss
    np.testing.assert_allclose(losses[0], float(setup["got_metrics"]["loss"]), rtol=0.05)


@pytest.mark.parametrize("epoch", [1, 2, 3, 4, 5, 7, 30])
def test_schedules_match_jax(epoch):
    cfg = TrainConfig()
    _, lr_schedule = jts.make_optimizer(JaxTrainConfig(), {"w": np.zeros(1)})
    assert learning_rate(cfg, epoch) == pytest.approx(float(lr_schedule(epoch - 1)), rel=1e-12)
    assert temperature_schedule(epoch) == jts.temperature_schedule(epoch)
