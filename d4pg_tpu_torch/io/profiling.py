"""Step-rate tracking.

Counterpart of ``StepTimer`` in ``d4pg_tpu/io/profiling.py``: an EWMA of
grad steps per second over explicitly bracketed spans, so eval, collect
and checkpoint time between brackets do not dilute it. Work on the card
is asynchronous: the host returns from a chunk once its kernels are
queued. So with a CUDA ``device`` both ends of the span synchronize it:
the start so earlier queued work is not counted, the end so the rate
covers the kernels and not only their queueing. The reference's XLA
trace capture and its compile/transfer sentinels are not ported.
"""

from __future__ import annotations

import time

import torch


class StepTimer:
    def __init__(self, alpha: float = 0.9,
                 device: str | torch.device | None = None):
        self._alpha = alpha
        self._device = None if device is None else torch.device(device)
        self._t0: float | None = None
        self.rate: float | None = None

    def _sync(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> float | None:
        if self._t0 is None:
            return self.rate
        self._sync()
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if dt > 0 and n_steps > 0:
            inst = n_steps / dt
            self.rate = (inst if self.rate is None
                         else self._alpha * self.rate
                         + (1 - self._alpha) * inst)
        return self.rate
