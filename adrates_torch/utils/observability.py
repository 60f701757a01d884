"""Structured logging + timing instrumentation.

The reference has only bare prints (reference engine.py:1896 debug
prints / PrettyTable __repr__s). This module provides:

 - a package-level `logging` hierarchy (``adrates_torch.*``) with an opt-in
   ``configure()`` that installs a structured key=value formatter;
 - ``timed(event, **fields)``: context manager / decorator that logs a
   DEBUG record with wall-clock duration and arbitrary fields, and feeds
   an in-process metrics registry;
 - ``metrics``: a process-wide counter/timer registry (``snapshot()`` for
   tests and dashboards).

Hot paths are instrumented at their Python boundaries only (curve builds,
book compiles) — nothing here runs inside a torch.func transform.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

logger = logging.getLogger("adrates_torch")


class _Metrics:
    """In-process counters and duration accumulators."""

    def __init__(self):
        self._counts: Dict[str, int] = defaultdict(int)
        self._seconds: Dict[str, float] = defaultdict(float)

    def record(self, event: str, seconds: float):
        self._counts[event] += 1
        self._seconds[event] += seconds

    def count(self, event: str) -> int:
        return self._counts[event]

    def snapshot(self) -> Dict[str, dict]:
        return {k: {"count": self._counts[k],
                    "total_seconds": self._seconds[k]}
                for k in self._counts}

    def reset(self):
        self._counts.clear()
        self._seconds.clear()


metrics = _Metrics()


@contextmanager
def timed(event: str, **fields):
    """Log + record the wall-clock duration of a block.

    >>> with timed("curve.build", name="GBP_OIS_SONIA", pillars=32):
    ...     ...
    emits ``event=curve.build name=GBP_OIS_SONIA pillars=32 ms=12.3``.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        metrics.record(event, dt)
        if logger.isEnabledFor(logging.DEBUG):
            kv = " ".join(f"{k}={v}" for k, v in fields.items())
            logger.debug("event=%s %s ms=%.3f", event, kv, dt * 1e3)


def configure(level=logging.INFO, stream=None) -> logging.Logger:
    """Attach a structured handler to the package logger (idempotent)."""
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    for h in list(logger.handlers):
        logger.removeHandler(h)
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger
