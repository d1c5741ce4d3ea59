"""Logging setup: console + rotating file handler.

Own copy of ``cds_mvsnet_tpu/utils/logging.py`` (behavioral reference:
logger/logger.py + logger/logger_config.json in TruongKhang/cds-mvsnet,
a dictConfig with a DEBUG console and a rotating 10 MB x 20 ``info.log``),
with the same handlers, levels and formats.
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

__all__ = ["setup_logging", "get_logger"]

_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}


def setup_logging(save_dir=None, verbosity: int = 2) -> logging.Logger:
    """Add a console handler (level by ``verbosity``: 0 WARNING, 1 INFO, 2
    DEBUG) and, with ``save_dir``, a rotating ``info.log`` at INFO to the
    root logger; returns it."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")

    console = logging.StreamHandler()
    console.setLevel(_LEVELS.get(verbosity, logging.DEBUG))
    console.setFormatter(logging.Formatter("%(message)s"))
    root.addHandler(console)

    if save_dir is not None:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(save_dir) / "info.log", maxBytes=10 * 1024 * 1024, backupCount=20
        )
        fh.setLevel(logging.INFO)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    return root


def get_logger(name: str, verbosity: int = 2) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(_LEVELS.get(verbosity, logging.DEBUG))
    return logger
