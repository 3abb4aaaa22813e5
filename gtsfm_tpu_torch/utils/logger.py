"""Logging and stage timing.

Port of gtsfm_tpu/utils/logger.py: loggers whose lines carry a worker tag,
the host name, the process id and the torch device type the process runs
on (``cuda`` when a card is visible, else ``cpu``), where the reference
names JAX's backend; and ``StageTimer``, named wall-clock stage timings,
each a span of utils/tracing.py.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket

from gtsfm_tpu_torch.utils.tracing import Span

_CACHED_TAG = None


def _worker_tag() -> str:
    global _CACHED_TAG
    if _CACHED_TAG is None:
        import torch

        device = "cuda" if torch.cuda.is_available() else "cpu"
        _CACHED_TAG = f"{socket.gethostname()}({os.getpid()}/{device})"
    return _CACHED_TAG


def get_logger(name: str = "gtsfm_tpu_torch") -> logging.Logger:
    """A logger at INFO with one stream handler whose lines carry the
    worker tag; the same object on every call with ``name``."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(f"%(asctime)s [{_worker_tag()}] %(levelname)s %(name)s: %(message)s",
                                         datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class StageTimer:
    """Named wall-clock stage timings; a name timed twice adds up. Each
    timing is a span (utils/tracing.py), recorded while a profiler
    records."""

    def __init__(self):
        self.timings: dict = {}

    @contextlib.contextmanager
    def time(self, name: str):
        clock = Span(name)
        try:
            with clock:
                yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + clock.seconds

    def as_metrics(self):
        from gtsfm_tpu_torch.evaluation.metrics import Metric

        return [Metric(f"{k}_sec", v) for k, v in self.timings.items()]
