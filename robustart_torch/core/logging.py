"""Logging utilities (counterpart of ``robustart_tpu/core/logging.py``).

Rank-aware: only rank 0 logs at INFO by default so multi-process runs don't
interleave a copy of every line per process.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname)s [%(name)s] %(message)s"


def get_logger(
    name: str = "robustart",
    log_file: str | None = None,
    level: int | None = None,
    rank: int | None = None,
) -> logging.Logger:
    """Create (or fetch) a configured logger.

    Args:
        name: logger name.
        log_file: optional path to also append logs to.
        level: explicit level; defaults to INFO on rank 0, WARNING elsewhere.
        rank: process rank; defaults to the ``RANK`` env var or 0.
    """
    logger = logging.getLogger(name)
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if level is None:
        level = logging.INFO if rank == 0 else logging.WARNING
    logger.setLevel(level)
    logger.propagate = False

    formatter = logging.Formatter(_FORMAT)
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(formatter)
        logger.addHandler(stream)
    if log_file and not any(
        isinstance(h, logging.FileHandler)
        and h.baseFilename == os.path.abspath(log_file)
        for h in logger.handlers
    ):
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fileh = logging.FileHandler(log_file)
        fileh.setFormatter(formatter)
        logger.addHandler(fileh)
    return logger
