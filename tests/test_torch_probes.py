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
    # bands past one block's shared memory (57 slices: 228 KB; 64: 256 KB),
    # which the port once refused, against the JAX kernel, with repeated
    # starts and starts past the band (the JAX kernel clamps those too)
    for nseg in (57, 64):
        x = rng.standard_normal((8, 128 * nseg)).astype(np.float32)
        offs = rng.integers(0, 128 * nseg, nseg).astype(np.int32)
        offs[:6] = [offs[7], offs[7], 128 * nseg, 128 * nseg + 300, 128 * (nseg - 1) + 5, 0]
        np.testing.assert_array_equal(port_lane_slice(x, offs), jax_lane_slice(x, offs))
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


JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32, torch.int16: jnp.int16}


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
    want = jax_gather(src, idx, JNP[vdt], JNP[idt])
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
    # rows past 48 KB, which the port once refused, against the JAX kernel:
    # (1, 12289) in fp32 values, (2, 16384) in each form
    rng = np.random.default_rng(6)
    for (R, n), forms in (((1, 12289), ["ctrl_fp32_i32"]), ((2, 16384), list(probe_gather16.FORMS))):
        values = rng.standard_normal((R, n)).astype(np.float32)
        at = rng.integers(-n - 40, n + 40, (R, n)).astype(np.int32)
        at[0, :3] = [-1, n, 65536 + 7]
        for form in forms:
            vdt, idt = probe_gather16.FORMS[form]
            want = jax_gather(values, at, JNP[vdt], JNP[idt])
            got = K.row_gather(torch.from_numpy(values), torch.from_numpy(at), vdt, idt).numpy()
            assert np.isnan(got[0, 1])
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="int16_arith"):
        K.int16_arith(src.double())


def _bad_calls():
    """One bad call for each check of the three wrappers: (id, call, the
    message it must raise)."""
    f, i32 = torch.zeros, torch.int32
    offs4 = f(4, dtype=i32)
    src, idx = f(4, 128), f(4, 128, dtype=i32)
    return [
        ("lane_offs_2d", lambda: K.lane_slice_sum(f(8, 512), f(1, 4, dtype=i32)), r"lane_slice_sum: offs \(1, 4\) torch.int32"),
        ("lane_offs_dtype", lambda: K.lane_slice_sum(f(8, 512), f(4, dtype=torch.int64)), r"offs \(4,\) torch.int64"),
        ("lane_x_dtype", lambda: K.lane_slice_sum(f(8, 512, dtype=torch.float64), offs4), r"x \(8, 512\) torch.float64"),
        ("lane_x_1d", lambda: K.lane_slice_sum(f(512), offs4), r"lane_slice_sum: x \(512,\)"),
        ("lane_width", lambda: K.lane_slice_sum(f(8, 500), offs4), r"x \(8, 500\) for 4 offsets"),
        ("lane_no_offsets", lambda: K.lane_slice_sum(f(8, 0), f(0, dtype=i32)), r"x \(8, 0\) for 0 offsets"),
        ("lane_rows", lambda: K.lane_slice_sum(f(9, 512), offs4), r"9 rows, the kernel takes 1 to 8"),
        ("lane_no_rows", lambda: K.lane_slice_sum(f(0, 512), offs4), r"0 rows"),
        ("lane_contiguous", lambda: K.lane_slice_sum(f(512, 8).t(), offs4), r"inputs must be contiguous"),
        ("gather_shape", lambda: K.row_gather(src, idx[:, :64]), r"row_gather: src \(4, 128\), idx \(4, 64\)"),
        ("gather_1d", lambda: K.row_gather(src[0], idx[0]), r"row_gather: src \(128,\)"),
        ("gather_src_dtype", lambda: K.row_gather(src.half(), idx), r"src torch.float16 must be fp32 or bf16"),
        ("gather_idx_dtype", lambda: K.row_gather(src, idx.long()), r"idx torch.int64 int32"),
        ("gather_value_type", lambda: K.row_gather(src, idx, torch.float16), r"value type torch.float16"),
        ("gather_index_type", lambda: K.row_gather(src, idx, torch.float32, torch.int64), r"index type torch.int64"),
        ("gather_empty", lambda: K.row_gather(f(0, 128), f(0, 128, dtype=i32)), r"row_gather: empty input"),
        ("gather_contiguous", lambda: K.row_gather(f(128, 4).t(), idx), r"row_gather: inputs must be contiguous"),
        ("arith_dtype", lambda: K.int16_arith(src.double()), r"int16_arith: src \(4, 128\) torch.float64"),
        ("arith_1d", lambda: K.int16_arith(src[0]), r"int16_arith: src \(128,\)"),
        ("arith_empty", lambda: K.int16_arith(f(0, 128)), r"src must be non-empty and contiguous"),
        ("arith_contiguous", lambda: K.int16_arith(f(128, 4).t()), r"src must be non-empty and contiguous"),
    ]


@pytest.mark.parametrize("case", [c[0] for c in _bad_calls()])
def test_probe_wrapper_checks_raise_with_their_message(case):
    """Every check of ``lane_slice_sum``, ``row_gather`` and ``int16_arith``
    raises ``ValueError`` with its message on a bad input, on the CPU as on
    the card (the checks come before the device test)."""
    call, message = {c[0]: c[1:] for c in _bad_calls()}[case]
    with pytest.raises(ValueError, match=message):
        call()


def test_probe_entry_points_on_the_cpu(capsys):
    out = probe_lane_slice.main([], device="cpu")
    assert out == {"ok": True, "max_abs_err": 0.0, "nseg": 4}
    assert "dynamic 128-aligned lane slice: OK" in capsys.readouterr().out
    results = probe_gather16.main([], device="cpu")
    src, idx = probe_gather16.inputs()
    for name, (vdt, idt) in probe_gather16.FORMS.items():
        want = jax_gather(src, idx, JNP[vdt], JNP[idt])
        assert results[name] == {"ok": True, "checksum": float(want.sum())}
    assert results["i16_arith"]["ok"]
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[1:]] == [[n, "OK"] for n in (*probe_gather16.FORMS, "i16_arith")]
    if not torch.cuda.is_available():  # an entry point raises without a card unless told the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_lane_slice.main([])
