"""Structured host logging.

Counterpart of yabpe_tpu/utils/logging.py without its JAX import: under
``torch.distributed`` only process 0 logs below ERROR (every process runs
the same replicated loop, so the others would repeat its lines).
"""

from __future__ import annotations

import logging
import os


class _ProcessZero(logging.Filter):
    """Passes process 0's records, and every process's errors; the rank is
    read when a record is made, since loggers exist before the process
    group does."""

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.ERROR:
            return True
        import torch.distributed as dist

        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def get_logger(name: str) -> logging.Logger:
    """Logger with one stream handler; level via YABPE_LOG_LEVEL."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s")
        )
        handler.addFilter(_ProcessZero())
        logger.addHandler(handler)
        level = os.environ.get("YABPE_LOG_LEVEL", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
        logger.propagate = False
    return logger


__all__ = ["get_logger"]
