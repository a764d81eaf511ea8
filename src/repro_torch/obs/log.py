"""Leveled logging for the launchers, with a ``REPRO_LOG`` env knob.

The launch scripts used to ``print`` unconditionally; this routes them
through stdlib logging so verbosity is one environment variable:

  REPRO_LOG=debug    everything (incl. per-cell memory analyses)
  REPRO_LOG=info     the default — same lines the prints used to emit
  REPRO_LOG=warning  only warnings/errors
  REPRO_LOG=error    only errors
  REPRO_LOG=silent   nothing

Output format stays the launchers' established ``[tag] message`` style on
stdout, so existing example transcripts and subprocess-capturing tests read
identically at the default level.
"""

from __future__ import annotations

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "silent": logging.CRITICAL + 10,
}


def log_level() -> int:
    """Resolve the ``REPRO_LOG`` knob (default ``info``)."""
    env = os.environ.get("REPRO_LOG", "").strip().lower()
    if env and env not in LOG_LEVELS:
        raise ValueError(
            f"REPRO_LOG must be one of {sorted(LOG_LEVELS)}, got {env!r}")
    return LOG_LEVELS[env or "info"]


class _TagFormatter(logging.Formatter):
    """``[tag] message`` — the launchers' print prefix, preserved."""

    def format(self, record: logging.LogRecord) -> str:
        tag = record.name
        if tag.startswith("repro_torch."):
            tag = tag[len("repro_torch."):]
        return f"[{tag}] {record.getMessage()}"


def get_logger(name: str) -> logging.Logger:
    """Logger printing ``[name] ...`` to stdout at the ``REPRO_LOG`` level.

    The level is re-read from the environment on every call, so a launcher
    invoked with ``REPRO_LOG=silent`` quiets loggers created at import time
    too.
    """
    logger = logging.getLogger(f"repro_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_TagFormatter())
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(log_level())
    return logger
