"""Prioritized replay's sum and min trees, in plain PyTorch.

A tree is a flat float32 array of ``2 * cap`` nodes (``cap`` a power of
two), root at 1, leaf ``i`` at ``cap + i``, every parent the sum (or the
min) of its two children, summed level by level in float32. A full ring
of ``size`` rows enters with priority 1 (``1 ** alpha``); leaves past
``size`` hold 0 in the sum tree and +inf in the min tree.

Sampling is stratified: stratum ``i`` of ``B`` draws the prefix mass
``(i + u_i) * (total / B)`` and descends the sum tree (``mass >=
left_sum`` goes right and subtracts); the slot is clipped to ``size -
1``. A slot drawn elsewhere is judged by how far its mass lies outside
the slot's stretch of the cumulative priorities. IS weights are ``(p *
N) ** -beta`` over their largest possible value, from the min tree; the data-parallel form divides every shard's
per-draw probability by the number of shards and takes one minimum over
all of them. The write-back stores ``(|td| + 1e-6) ** alpha``; of
duplicate slots in one write the last wins.
"""

from __future__ import annotations

import numpy as np
import torch


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _rebuild(leaves: torch.Tensor, op) -> torch.Tensor:
    cap = leaves.shape[0]
    tree = torch.empty(2 * cap, dtype=torch.float32, device=leaves.device)
    tree[cap:] = leaves
    lo = cap
    while lo > 1:
        kids = tree[lo:2 * lo].view(-1, 2)
        tree[lo // 2:lo] = op(kids[:, 0], kids[:, 1])
        lo //= 2
    tree[0] = 0.0
    return tree


class Trees:
    """A sum tree and a min tree over ``cap`` leaves, ``size`` of them
    live, and the running maximum of the raw priorities."""

    def __init__(self, capacity: int, size: int, device):
        self.cap = next_pow2(capacity)
        self.size = int(size)
        live = torch.arange(self.cap, device=device) < self.size
        self.leaves = torch.where(live, 1.0, 0.0).to(torch.float32)
        self.live = live
        self.max_priority = 1.0
        self._build()

    def _build(self) -> None:
        self.sum_tree = _rebuild(self.leaves, torch.add)
        self.min_tree = _rebuild(
            torch.where(self.live, self.leaves, float("inf")), torch.minimum)

    def descend(self, mass: torch.Tensor) -> torch.Tensor:
        node = torch.ones(mass.shape, dtype=torch.int64, device=mass.device)
        p = mass
        for _ in range(self.cap.bit_length() - 1):
            left = node * 2
            left_sum = self.sum_tree[left]
            right = p >= left_sum
            p = torch.where(right, p - left_sum, p)
            node = torch.where(right, left + 1, left)
        return node - self.cap

    def masses(self, u: torch.Tensor) -> torch.Tensor:
        """The stratified prefix masses of the draws ``u`` [B]."""
        b = u.shape[0]
        i = torch.arange(b, dtype=torch.float32, device=u.device)
        return (i + u) * (self.sum_tree[1] / torch.full(
            (), float(b), dtype=torch.float32, device=u.device))

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Slots [B] (int64) of the stratified draws ``u`` [B]."""
        return torch.clamp(self.descend(self.masses(u)),
                           max=max(self.size - 1, 0))

    def outside(self, slots: torch.Tensor,
                mass: torch.Tensor) -> torch.Tensor:
        """How far each mass lies outside its slot's stretch of the
        cumulative priorities, in units of that slot's priority (0 when
        the slot is the one the mass falls in)."""
        leaves = self.leaves.double()
        hi = torch.cumsum(leaves, 0)[slots]
        lo = hi - leaves[slots]
        m = mass.double()
        return (torch.clamp(lo - m, min=0) + torch.clamp(m - hi, min=0)) \
            / leaves[slots]

    def write_back(self, idx: torch.Tensor, td: torch.Tensor,
                   alpha: float) -> None:
        p = torch.abs(td) + 1e-6
        vals = p ** alpha
        pos = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full((self.cap,), -1, dtype=torch.int64,
                          device=idx.device)
        last.scatter_reduce_(0, idx, pos, "amax")
        slots = torch.unique(idx)
        self.leaves[slots] = vals[last[slots]]
        self.max_priority = max(self.max_priority, float(p.max()))
        self._build()


def beta_schedule(step: int, beta0: float, beta_steps: int) -> float:
    """beta0 -> 1 over ``beta_steps`` grad steps, rounded in float32."""
    f32 = np.float32
    frac = min(max(f32(step) / f32(beta_steps), f32(0.0)), f32(1.0))
    return float(f32(beta0) + frac * f32(1.0 - beta0))


def is_weights(t: Trees, idx: torch.Tensor, beta: float) -> torch.Tensor:
    """One ring's IS weights of the slots ``idx``."""
    total = t.sum_tree[1]
    n = float(t.size)
    max_weight = (t.min_tree[1] / total * n) ** (-beta)
    p = t.sum_tree[t.cap + idx] / total
    return (p * n) ** (-beta) / max_weight


def sharded_is_weights(shards: list[Trees], idx: list[torch.Tensor],
                       beta: float) -> list[torch.Tensor]:
    """IS weights of each shard's slots over one normalizer: shard s's
    per-draw probability is ``p_i / total_s / n_shards`` and every
    weight is ``(q / q_min) ** -beta`` with ``q_min`` the least over all
    shards."""
    dev = idx[0].device
    n = torch.tensor(float(len(shards)), dtype=torch.float32, device=dev)
    q_min = torch.stack([t.min_tree[1] / t.sum_tree[1] / n
                         for t in shards]).min()
    neg_beta = torch.tensor(-beta, dtype=torch.float32, device=dev)
    out = []
    for t, i in zip(shards, idx):
        q = t.sum_tree[t.cap + i] / t.sum_tree[1] / n
        out.append(torch.pow(q / q_min, neg_beta))
    return out
