"""Colored, leveled logging.

The port's copy of ``areal_tpu/base/logging.py``: ``getLogger(name)`` hands
out a logger under the package's root logger ``areal_tpu_torch``, which gets
one stderr handler (colored on a terminal) at the level named by
``AREAL_LOG_LEVEL`` (default INFO). Unlike the reference, records still
propagate to the root logger, so pytest's log capture sees them.
"""

from __future__ import annotations

import logging
import os
import sys

ROOT = "areal_tpu_torch"
_FORMAT = "%(asctime)s.%(msecs)03d %(name)s %(levelname)s: %(message)s"
_DATE = "%Y%m%d-%H:%M:%S"

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelname, '')}{msg}{_RESET}"
        return msg


_configured = False


def getLogger(name: str = ROOT, subname: str | None = None) -> logging.Logger:
    global _configured
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ColorFormatter(_FORMAT, _DATE))
        root = logging.getLogger(ROOT)
        root.addHandler(h)
        root.setLevel(os.environ.get("AREAL_LOG_LEVEL", "INFO").upper())
        _configured = True
    if subname:
        name = f"{name}.{subname}"
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
