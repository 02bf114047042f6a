"""Running observation normalization (the HER recipe's other half).

Counterpart of ``RunningMeanStd`` and ``FrozenNormalizer`` in
``d4pg_tpu/envs/normalizer.py``. Goal-conditioned manipulation mixes
positions, velocities and object poses whose scales differ by orders of
magnitude; the HER paper standardizes observations and goals per
dimension.

The statistics stay numpy float64 on the host, as in the reference:
``normalize`` computes in float64, clips, then casts to float32, so the
rows it writes are bitwise the reference's (a float32 torch version
would differ in the last bits). The ``ReplayService`` commit thread is
the single writer: every actor streams raw rows, the commit thread folds
their ``obs`` into the statistics and inserts them normalized, so the
learner, the fused device path and the kernels see standardized rows
and never the estimator. In-process actors and the evaluator read the
live ``RunningMeanStd``; remote and spawned actors hold a
``FrozenNormalizer`` refreshed from the ``(mean, std, clip)`` that rides
the weight frames. The estimator's state rides the checkpoint.

Thread safety: the commit thread updates while actors and the evaluator
read. ``stats`` copies the pair under the lock, so a reader sees one
consistent (mean, std) however a fold interleaves.

With several ranks (``parallel/``), ``SyncedRunningMeanStd`` keeps one
set of statistics on every rank: each rank folds its own rows into a
delta, and a collective ``sync`` merges every rank's delta in rank
order.
"""

from __future__ import annotations

import threading

import numpy as np


class RunningMeanStd:
    """Streaming mean and variance (Chan et al.'s parallel Welford
    merge), vectorized over feature dimensions."""

    def __init__(self, dim: int, clip: float = 5.0, eps: float = 1e-2):
        self.dim = int(dim)
        self.clip = float(clip)
        self.eps = float(eps)
        self._lock = threading.Lock()
        self._count = 0.0
        self._mean = np.zeros(dim, np.float64)
        self._m2 = np.zeros(dim, np.float64)

    def update(self, batch: np.ndarray) -> None:
        """Fold a [B, dim] batch into the statistics."""
        batch = np.asarray(batch, np.float64).reshape(-1, self.dim)
        n = batch.shape[0]
        if n == 0:
            return
        b_mean = batch.mean(axis=0)
        b_m2 = ((batch - b_mean) ** 2).sum(axis=0)
        self.merge(n, b_mean, b_m2)

    def merge(self, count: float, mean: np.ndarray, m2: np.ndarray) -> None:
        """Chan-merge another estimator's (count, mean, M2) into this
        one: the combine ``update`` applies to a batch."""
        if count <= 0:
            return
        with self._lock:
            total = self._count + count
            delta = np.asarray(mean, np.float64) - self._mean
            self._mean = self._mean + delta * (count / total)
            self._m2 = (self._m2 + np.asarray(m2, np.float64)
                        + delta**2 * (self._count * count / total))
            self._count = total

    def stats(self) -> tuple[np.ndarray, np.ndarray]:
        """A (mean, std) snapshot; std is floored at ``eps`` (the HER
        paper's floor) so constant dimensions stay finite."""
        with self._lock:
            mean = self._mean.copy()
            var = ((self._m2 / self._count) if self._count > 0
                   else np.ones_like(self._m2))
        return mean, np.sqrt(np.maximum(var, self.eps**2))

    def normalize(self, x: np.ndarray) -> np.ndarray:
        """Standardize in float64, clip to +-clip, return float32."""
        mean, std = self.stats()
        out = (np.asarray(x, np.float64) - mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    # -- checkpoint payload -------------------------------------------------
    def state_dict(self) -> dict:
        with self._lock:
            return {
                "count": float(self._count),
                "mean": self._mean.copy(),
                "m2": self._m2.copy(),
                "clip": self.clip,
                "eps": self.eps,
            }

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self._count = float(d["count"])
            self._mean = np.asarray(d["mean"], np.float64).copy()
            self._m2 = np.asarray(d["m2"], np.float64).copy()
            self.clip = float(d.get("clip", self.clip))
            self.eps = float(d.get("eps", self.eps))



class SyncedRunningMeanStd(RunningMeanStd):
    """The multi-rank variant (the HER paper's MPI-averaged
    normalization): each rank's replay folds ONLY into a local delta
    estimator, and :meth:`sync`, called at a point every rank reaches in
    lockstep (the cycle boundary), gathers every rank's ``[count, mean,
    m2]`` delta in float64 over the host group and merges them in rank
    order, so every rank ends with bitwise-identical statistics.
    ``normalize``, ``stats`` and the checkpoint payload read the merged
    estimator (at most one cycle stale)."""

    def __init__(self, dim: int, mesh, clip: float = 5.0, eps: float = 1e-2):
        super().__init__(dim, clip, eps)
        self._mesh = mesh
        self._delta = RunningMeanStd(dim, clip, eps)

    def update(self, batch: np.ndarray) -> None:
        self._delta.update(batch)

    def sync(self) -> None:
        """Collective: every rank calls it at the same point."""
        d = self._delta
        with d._lock:
            payload = np.concatenate(
                [[d._count], d._mean, d._m2]).astype(np.float64)
            d._count = 0.0
            d._mean = np.zeros(self.dim, np.float64)
            d._m2 = np.zeros(self.dim, np.float64)
        for row in self._mesh.gather_host(payload):  # rank order
            self.merge(row[0], row[1:1 + self.dim], row[1 + self.dim:])

class FrozenNormalizer:
    """Read-only (mean, std) view for actors that get the statistics over
    the weight channel; refreshed by ``set`` on each weight pull."""

    def __init__(self, mean: np.ndarray, std: np.ndarray, clip: float = 5.0):
        self.clip = float(clip)
        self.set(mean, std)

    def set(self, mean: np.ndarray, std: np.ndarray,
            clip: float | None = None) -> None:
        self._mean = np.asarray(mean, np.float64)
        self._std = np.maximum(np.asarray(std, np.float64), 1e-8)
        if clip is not None:
            self.clip = float(clip)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        out = (np.asarray(x, np.float64) - self._mean) / self._std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)
