"""Per-process logging with rank-zero summaries.

The reference prints with bare ``print()`` on every rank (loss every 20
batches, average batch time, eval summary: ``master/part1/part1.py:40,44,
60-62``). Here, as in the JAX package's ``utils/logging.py``: a logger
whose records carry a ``[proc i/n]`` prefix when more than one process
runs, and ``rank_zero_only`` for summaries printed once.
"""

from __future__ import annotations

import logging
import sys
from functools import wraps

import torch.distributed as dist


def _rank_and_world() -> tuple[int, int]:
    """This process's rank and the world size from ``torch.distributed``
    when a group is initialized, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _RankPrefixFilter(logging.Filter):
    """Stamp each record with the current ``[proc i/n]`` prefix. It is
    computed a record at a time, not when the handler is made: loggers
    are made at import, before the process group exists."""

    def filter(self, record: logging.LogRecord) -> bool:
        rank, world = _rank_and_world()
        record.rank_prefix = f"[proc {rank}/{world}] " if world > 1 else ""
        return True


def get_logger(name: str = "cs744_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.addFilter(_RankPrefixFilter())
        handler.setFormatter(logging.Formatter("%(rank_prefix)s%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def rank_zero_only(fn):
    """Run ``fn`` on rank 0 only; other ranks get None."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        if _rank_and_world()[0] == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper
