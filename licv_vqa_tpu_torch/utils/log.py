"""Stdlib-backed logger with loguru-like formatting (loguru not in image)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s:%(lineno)d - %(message)s"
_configured = False


def get_logger(name: str = "licv") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("licv")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        root.propagate = False
        _configured = True
    if name != "licv" and not name.startswith("licv."):
        name = f"licv.{name}"
    return logging.getLogger(name)
