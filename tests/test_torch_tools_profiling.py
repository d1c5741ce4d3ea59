"""``cds_mvsnet_tpu_torch/utils/{profiling,logging}.py`` against the JAX
package's modules: the section timer's summary under the same clock, the
same logging handlers, and a trace written on the CPU."""

from __future__ import annotations

import logging
import logging.handlers
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cds_mvsnet_tpu.utils import logging as jax_logging
from cds_mvsnet_tpu.utils import profiling as jax_profiling
from cds_mvsnet_tpu_torch.utils import logging as port_logging
from cds_mvsnet_tpu_torch.utils import profiling as port_profiling


def run_sections(timer, result):
    """The same sequence of sections, one of them waiting on a result."""
    for name in ("load", "infer", "load", "fuse", "infer", "infer"):
        with timer.section(name, result=result if name == "infer" else None):
            pass


def test_section_timer_summary_matches_jax(monkeypatch):
    """Under one patched ``time.perf_counter`` (each read 0.25 s, then 0.5 s,
    ... after the last) both timers give the same summary."""
    def clock():
        ticks = iter(np.cumsum(np.arange(1, 100) * 0.25))
        return lambda: float(next(ticks))

    result = jnp.ones((2, 3))
    jax_profiling.sync(result)  # compiled before the clock is patched
    monkeypatch.setattr(time, "perf_counter", clock())
    jax_timer = jax_profiling.SectionTimer()
    run_sections(jax_timer, result)
    monkeypatch.setattr(time, "perf_counter", clock())
    port_timer = port_profiling.SectionTimer()
    run_sections(port_timer, {"depth": [torch.ones(2, 3)]})
    want, got = jax_timer.summary(), port_timer.summary()
    assert list(got) == list(want) == ["load", "infer", "fuse"]
    assert got == want
    assert got["infer"]["n"] == 3


def test_sync_finds_no_card_tensor_on_the_cpu():
    """``sync`` walks dicts, lists and tuples and does nothing where no
    tensor lies on the card."""
    assert port_profiling._first_cuda_tensor({"a": [torch.ones(1), (torch.zeros(2),)], "b": 3}) is None
    port_profiling.sync({"a": [torch.ones(1)]})
    port_profiling.sync(None)


def test_device_trace_writes_a_trace(tmp_path):
    """A trace of the CPU work inside the block, as a ``*.pt.trace.json``."""
    with port_profiling.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "aten::mm" in traces[0].read_text()


@pytest.fixture
def root_logger():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield root
    for h in root.handlers[len(handlers):]:
        h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def added_handlers(root, setup, save_dir, verbosity):
    before = list(root.handlers)
    assert setup(save_dir=save_dir, verbosity=verbosity) is root
    return [h for h in root.handlers if h not in before]


def describe(handler) -> dict:
    out = {"type": type(handler), "level": handler.level, "format": handler.formatter._fmt}
    if isinstance(handler, logging.handlers.RotatingFileHandler):
        out.update(maxBytes=handler.maxBytes, backupCount=handler.backupCount, file=handler.baseFilename)
    return out


@pytest.mark.parametrize("verbosity", [0, 1, 2, 7])
@pytest.mark.parametrize("with_dir", [False, True])
def test_setup_logging_matches_jax(root_logger, tmp_path, verbosity, with_dir):
    """The same handlers, levels, formats, 10 MB x 20 rotation and file, and
    the root at DEBUG; ``get_logger`` the same level."""
    save_dir = str(tmp_path / "logs") if with_dir else None
    want = [describe(h) for h in added_handlers(root_logger, jax_logging.setup_logging, save_dir, verbosity)]
    got = [describe(h) for h in added_handlers(root_logger, port_logging.setup_logging, save_dir, verbosity)]
    assert got == want
    assert len(got) == (2 if with_dir else 1)
    assert root_logger.level == logging.DEBUG
    if with_dir:
        assert got[1]["maxBytes"] == 10 * 1024 * 1024 and got[1]["backupCount"] == 20
    assert (port_logging.get_logger("cds.port", verbosity).level
            == jax_logging.get_logger("cds.jax", verbosity).level)
