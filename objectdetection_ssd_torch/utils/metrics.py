"""Logging and running metrics — the part of
`objectdetection_ssd_tpu/utils/metrics.py` that the Trainer uses: the
package logger, `setup_logging` and `MetricsLogger`.

Step metrics may be device scalars (tensors on the card).  They are held
as they are and summed on the device when an average is read (a log step,
the end of a phase), so a step adds no host sync of its own.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict

logger = logging.getLogger("objectdetection_ssd_torch")


def setup_logging(level: int = logging.INFO) -> None:
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                              "%H:%M:%S"))
        logger.addHandler(handler)
    logger.propagate = False  # avoid double lines via the root logger
    logger.setLevel(level)


def _weighted(value, weight: float):
    """``value * weight`` in float64: a tensor stays on its device."""
    if hasattr(value, "double"):
        return value.detach().double() * weight
    return float(value) * weight


class RunningAverage:
    """Weighted running average (the reference weights by batch size,
    `train_function.py:98`), read in float64."""

    # Bound on retained device scalars: with no log cadence nothing else
    # reads them until the end of the phase.
    _MAX_PENDING = 256

    def __init__(self):
        self.total = 0.0
        self.weight = 0.0
        self._pending = []

    def update(self, value, weight: float = 1.0) -> None:
        self._pending.append((value, weight))
        self.weight += weight
        if len(self._pending) >= self._MAX_PENDING:
            self._flush()

    def _flush(self) -> None:
        if self._pending:
            # One sum on the device, one host pull.
            self.total += float(sum(_weighted(v, w)
                                    for v, w in self._pending))
            self._pending.clear()

    @property
    def average(self) -> float:
        self._flush()
        return self.total / self.weight if self.weight else float("nan")


class MetricsLogger:
    """Accumulates per-step metric dicts; logs every ``log_every`` steps."""

    def __init__(self, log_every: int = 20, prefix: str = "train"):
        self.log_every = log_every
        self.prefix = prefix
        self.averages: Dict[str, RunningAverage] = {}
        self._step = 0
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, metrics: Dict[str, Any], batch_size: int) -> None:
        for k, v in metrics.items():
            self.averages.setdefault(k, RunningAverage()).update(
                v, batch_size)
        self._images += batch_size
        self._step += 1
        if self.log_every and self._step % self.log_every == 0:
            dt = time.perf_counter() - self._t0
            ips = self._images / dt if dt > 0 else 0.0
            parts = " ".join(
                f"{k}={a.average:.4f}" for k, a in self.averages.items())
            logger.info("[%s] step=%d %s img/s=%.1f",
                        self.prefix, self._step, parts, ips)

    def summary(self) -> Dict[str, float]:
        return {k: a.average for k, a in self.averages.items()}
