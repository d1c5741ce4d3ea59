"""P1's and P2's plain versions (what the wrappers run on CPU tensors)
against the JAX package's probe kernels, ``tools/probe_lane_slice.py::
_kernel`` and ``tools/probe_gather16.py::_gather_kernel`` /
``_i16_arith_kernel``, run through ``pl.pallas_call(..., interpret=True)``
on the CPU; the probes' entry points on the CPU; and the wrappers' checks.

``tools/`` is no package: the probes are loaded by file path. Both sides sum
and gather the same fp32 values in the same order, so they agree bit for
bit.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cds_mvsnet_tpu_torch.ops import kernels as K
from cds_mvsnet_tpu_torch.tools import probe_gather16, probe_lane_slice

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_P1 = load_tool("probe_lane_slice")
JAX_P2 = load_tool("probe_gather16")


def jax_lane_slice(x: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """The probe's ``pallas_call`` (:44) at any band width, interpreted."""
    nseg = offs.shape[0]
    out = pl.pallas_call(
        functools.partial(JAX_P1._kernel, nseg=nseg),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, 128 * nseg), jnp.float32), pltpu.SemaphoreType.DMA],
        interpret=True,
    )(jnp.asarray(offs.reshape(1, nseg)), jnp.asarray(x))
    return np.asarray(out)


def port_lane_slice(x: np.ndarray, offs: np.ndarray) -> np.ndarray:
    return K.lane_slice_sum(torch.from_numpy(x), torch.from_numpy(offs)).numpy()


@pytest.mark.parametrize("case", ["probe", "unaligned", "same", "wide"])
def test_lane_slice_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(3)
    nseg = 48 if case == "wide" else 4
    if case == "probe":  # the probe's own input
        x = np.arange(8 * 128 * nseg, dtype=np.float32).reshape(8, 128 * nseg)
    else:
        x = rng.standard_normal((8, 128 * nseg)).astype(np.float32)
    offs = {"probe": np.arange(nseg) * 128, "unaligned": np.array([0, 130, 300, 511]),
            "same": np.array([3, 3, 3, 3]), "wide": rng.integers(0, 128 * nseg, nseg)}[case].astype(np.int32)
    np.testing.assert_array_equal(port_lane_slice(x, offs), jax_lane_slice(x, offs))


def test_lane_slice_clamps_offsets_outside_the_band():
    """The JAX kernel leaves these undefined; the port clamps each start to
    [0, 128·(nseg−1)] after flooring."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    offs = np.array([-5, 700, 384, -129], np.int32)
    want = np.zeros((8, 128), np.float32)
    for start in (0, 384, 384, 0):
        want = want + x[:, start:start + 128]
    np.testing.assert_array_equal(port_lane_slice(x, offs), want)


def test_lane_slice_rows_and_checks():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    got = port_lane_slice(x, np.array([128, 5], np.int32))
    np.testing.assert_array_equal(got, x[:, 128:] + x[:, :128])
    with pytest.raises(ValueError, match="rows"):
        K.lane_slice_sum(torch.zeros(9, 128), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="shared memory"):  # 8 rows x 57 slices: 228 KB of band
        K.lane_slice_sum(torch.zeros(8, 128 * 57), torch.zeros(57, dtype=torch.int32))
    K.lane_slice_sum(torch.zeros(8, 128 * 56), torch.zeros(56, dtype=torch.int32))  # the largest band
    with pytest.raises(ValueError, match="offsets"):
        K.lane_slice_sum(torch.zeros(8, 500), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="offs"):
        K.lane_slice_sum(torch.zeros(8, 512), torch.zeros(4, dtype=torch.int64))


def gather_inputs():
    """The probe's seeded inputs, with indices the probe never sends: from
    the row's end, outside [-L, L), and wrapping in int16."""
    src, idx = probe_gather16.inputs()
    idx = idx.copy()
    idx[0, :4] = [-1, -128, 128, 1000]
    idx[1, :3] = [-129, 65536 + 5, -65536 + 3]
    return src, idx


def jax_gather(src, idx, vdt, idt):
    kern = functools.partial(JAX_P2._gather_kernel, vdt=vdt, idt=idt)
    out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(src.shape, jnp.float32), interpret=True)(
        jnp.asarray(src).astype(vdt), jnp.asarray(idx))
    return np.asarray(out)


@pytest.mark.parametrize("form", list(probe_gather16.FORMS))
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
def test_row_gather_plain_matches_jax_kernel(form, src_dtype):
    vdt, idt = probe_gather16.FORMS[form]
    src, idx = gather_inputs()
    want = jax_gather(src, idx, {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[vdt],
                      {torch.int32: jnp.int32, torch.int16: jnp.int16}[idt])
    src_t = torch.from_numpy(src).to(src_dtype)
    if src_dtype == torch.bfloat16 and vdt == torch.float32:  # the JAX form takes the rounded values
        want = jax_gather(src_t.float().numpy(), idx, jnp.float32, jnp.int32 if idt == torch.int32 else jnp.int16)
    got = K.row_gather(src_t, torch.from_numpy(idx), vdt, idt).numpy()
    assert np.isnan(got[0, 2]) and np.isnan(got[1, 0])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_int16_arith_plain_matches_jax_kernel():
    src, _ = probe_gather16.inputs()
    want = np.asarray(pl.pallas_call(JAX_P2._i16_arith_kernel, out_shape=jax.ShapeDtypeStruct(src.shape, jnp.float32),
                                     interpret=True)(jnp.asarray(src)))
    np.testing.assert_array_equal(K.int16_arith(torch.from_numpy(src)).numpy(), want)


def test_int16_arith_wraps_past_32767_lanes():
    """Lanes beyond int16 wrap, and so does the +3; % floors (numpy's int16)."""
    n = 40000
    src = np.zeros((1, n), np.float32)
    lane = np.arange(n).astype(np.int16)
    j = np.remainder((lane + np.int16(3)).astype(np.int16), np.int16(7))
    np.testing.assert_array_equal(K.int16_arith(torch.from_numpy(src)).numpy(), (j == 2).astype(np.float32)[None])


def test_row_gather_checks():
    src, idx = torch.zeros(4, 128), torch.zeros(4, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx"):
        K.row_gather(src, idx.long())
    with pytest.raises(ValueError, match="index type"):
        K.row_gather(src, idx, torch.float16)
    with pytest.raises(ValueError, match="shared memory"):  # 12289 fp32 values: over 48 KB
        K.row_gather(torch.zeros(1, 12289), torch.zeros(1, 12289, dtype=torch.int32))
    K.row_gather(torch.zeros(1, 12289), torch.zeros(1, 12289, dtype=torch.int32), torch.bfloat16)
    with pytest.raises(ValueError, match="int16_arith"):
        K.int16_arith(src.double())


def test_probe_entry_points_on_the_cpu(capsys):
    out = probe_lane_slice.main([], device="cpu")
    assert out == {"ok": True, "max_abs_err": 0.0, "nseg": 4}
    assert "dynamic 128-aligned lane slice: OK" in capsys.readouterr().out
    results = probe_gather16.main([], device="cpu")
    src, idx = probe_gather16.inputs()
    for name, (vdt, idt) in probe_gather16.FORMS.items():
        want = jax_gather(src, idx, {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[vdt],
                          {torch.int32: jnp.int32, torch.int16: jnp.int16}[idt])
        assert results[name] == {"ok": True, "checksum": float(want.sum())}
    assert results["i16_arith"]["ok"]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[1:]] == [[n, "OK"] for n in (*probe_gather16.FORMS, "i16_arith")]
    if not torch.cuda.is_available():  # an entry point raises without a card unless told the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_lane_slice.main([])
