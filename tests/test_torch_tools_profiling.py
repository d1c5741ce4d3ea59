"""``cds_mvsnet_tpu_torch/utils/{profiling,logging}.py``: a trace written
on the CPU, and the same logging handlers as the JAX package's module."""

from __future__ import annotations

import json
import logging
import logging.handlers

import pytest
import torch

from cds_mvsnet_tpu.utils import logging as jax_logging
from cds_mvsnet_tpu_torch.utils import logging as port_logging
from cds_mvsnet_tpu_torch.utils import profiling as port_profiling


def test_device_trace_writes_a_trace(tmp_path):
    """A trace of the CPU work inside the block, as a ``*.pt.trace.json``,
    in which a span holds the operators run inside it."""
    with port_profiling.device_trace(str(tmp_path)):
        with port_profiling.span("cds.test"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = [e for e in json.loads(traces[0].read_text())["traceEvents"] if e.get("ph") == "X"]
    (outer,) = [e for e in events if e["name"] == "cds.test" and e.get("cat") == "user_annotation"]
    mm = [e for e in events if e["name"] == "aten::mm"]
    assert mm and all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] for e in mm)


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
