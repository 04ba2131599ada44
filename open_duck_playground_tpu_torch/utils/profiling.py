"""Profiling and step-timing utilities on ``torch.profiler``.

Counterpart of the JAX package's ``utils/profiling.py``:

- `trace(log_dir, device)`: context manager around
  ``torch.profiler.profile`` that records host activity, and the card's
  kernels and copies when `device` is a CUDA device, and writes a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) into `log_dir`
  on exit. It yields the ``profile`` object, so the caller can read
  ``key_averages()`` or ``events()``.
- `annotate(name)`: ``torch.profiler.record_function`` passthrough, a named
  span of host time inside a capture.
- `StepTimer`: wall-clock steps/sec with exponential smoothing.

Nothing in the package calls these; a harness wraps the calls it wants to
see (``chip_smoke.py`` phase 9).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device] = "cuda"
          ) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the body into `log_dir`/trace.json.
    With a CUDA `device` the card's activity is recorded too, and a missing
    card raises rather than tracing the host alone."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: trace records the card's activity unless given "
                               "device='cpu'")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named host-side annotation visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock steps/sec with exponential smoothing."""

    def __init__(self, smoothing: float = 0.9):
        self._smoothing = smoothing
        self._last: Optional[float] = None
        self._rate: Optional[float] = None

    def tick(self, units: float = 1.0) -> Optional[float]:
        """Record one step of `units` work; returns smoothed units/sec."""
        now = time.monotonic()
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            rate = units / dt
            if self._rate is None:
                self._rate = rate
            else:
                self._rate = self._smoothing * self._rate + (1 - self._smoothing) * rate
        self._last = now
        return self._rate

    @property
    def rate(self) -> Optional[float]:
        return self._rate
