"""Structured host logging.

Counterpart of yabpe_tpu/utils/logging.py without its JAX import: this
slice of the port runs in one process, so there is no host-0 gate.
"""

from __future__ import annotations

import logging
import os


def get_logger(name: str) -> logging.Logger:
    """Logger with one stream handler; level via YABPE_LOG_LEVEL."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
        )
        logger.addHandler(handler)
        level = os.environ.get("YABPE_LOG_LEVEL", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
        logger.propagate = False
    return logger


__all__ = ["get_logger"]
