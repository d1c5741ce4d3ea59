"""The weight bridge: every leaf of the JAX param tree lands in the port."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.config import ModelConfig as JaxModelConfig
from cds_mvsnet_tpu.models.cds_mvsnet import init_cds_mvsnet
from cds_mvsnet_tpu.models.convert import flatten_params as jax_flatten
from cds_mvsnet_tpu.models.convert import save_params as jax_save_params
from cds_mvsnet_tpu_torch.config import ModelConfig
from cds_mvsnet_tpu_torch.models.cds_mvsnet import CDSMVSNet
from cds_mvsnet_tpu_torch.models.convert import load_into, params_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_tree():
    tree = jax.jit(init_cds_mvsnet, static_argnums=1)(jax.random.PRNGKey(0), JaxModelConfig(refine=True))
    return jax.tree.map(np.asarray, tree)


def _expected_torch_shape(key, shape):
    if key.endswith(("conv7.conv.weight", "conv9.conv.weight", "conv11.conv.weight")):
        return (shape[3], shape[4], *shape[:3])  # (I, O, k, k, k)
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])  # OIHW
    if len(shape) == 5:
        return (shape[4], shape[3], *shape[:3])  # OIDHW
    return tuple(shape)


def test_every_leaf_lands_except_refinement(jax_tree):
    flat = jax_flatten(jax_tree)
    model = CDSMVSNet(ModelConfig(refine=False))
    own = model.state_dict()
    placed = {k for k in flat if not k.startswith("refine_network.")}
    assert any(k.startswith("refine_network.") for k in flat)
    assert placed == set(own)
    for k in placed:
        assert tuple(own[k].shape) == _expected_torch_shape(k, flat[k].shape), k
    load_into(model, jax_tree)
    state = model.state_dict()
    bridged = params_from_jax(jax_tree)
    for k in placed:
        assert torch.equal(state[k], bridged[k]), k
    # values moved with their layout map
    w = flat["feature.conv00.conv.convs.2.weight"]  # (11, 11, 3, 8) HWIO
    np.testing.assert_array_equal(state["feature.conv00.conv.convs.2.weight"].numpy(), w.transpose(3, 2, 0, 1))
    wd = flat["cost_regularization.1.conv9.conv.weight"]  # flipped (k, k, k, I, O)
    np.testing.assert_array_equal(
        state["cost_regularization.1.conv9.conv.weight"].numpy(),
        np.flip(wd, (0, 1, 2)).transpose(3, 4, 0, 1, 2),
    )
    np.testing.assert_array_equal(
        state["stage_net.vis.2.1.bn.running_var"].numpy(), flat["stage_net.vis.2.1.bn.running_var"]
    )


def test_deconv_layout_inverts_the_jax_flip(jax_tree):
    """conv_transpose3d with the bridged weight equals the JAX package's
    input-dilated direct conv with the stored (flipped) weight."""
    from cds_mvsnet_tpu.models.layers import deconv3d as jax_deconv3d
    from cds_mvsnet_tpu_torch.models.layers import deconv3d

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 3, 4, 5, 32)).astype(np.float32)  # NDHWC
    p = jax_tree["cost_regularization"]["0"]["conv9"]["conv"]
    want = np.asarray(jax_deconv3d(x, p, precision=jax.lax.Precision.HIGHEST))
    w = params_from_jax({"cost_regularization": {"0": {"conv9": {"conv": p}}}})
    got = deconv3d(torch.tensor(x).permute(0, 4, 1, 2, 3), w["cost_regularization.0.conv9.conv.weight"])
    # fp32 sums of 27*32 products
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-5)


def test_unplaced_leaf_raises(jax_tree):
    tree = {**jax_tree, "feature": {**jax_tree["feature"], "bogus": {"weight": np.zeros((3,), np.float32)}}}
    with pytest.raises(KeyError, match="no place"):
        load_into(CDSMVSNet(ModelConfig(refine=False)), tree)


def test_missing_leaf_raises(jax_tree):
    tree = {k: v for k, v in jax_tree.items() if k != "stage_net"}
    with pytest.raises(KeyError, match="no leaf"):
        load_into(CDSMVSNet(ModelConfig(refine=False)), tree)


def test_npz_round_trip(jax_tree, tmp_path):
    path = tmp_path / "params.npz"
    jax_save_params(path, jax_tree)
    a, b = params_from_jax(path), params_from_jax(jax_tree)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
