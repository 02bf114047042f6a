"""Device-resident PER sum/min trees.

Counterpart of ``d4pg_tpu/replay/device_per.py``. One flat array of
``2 * capacity`` (power of two) float32 nodes per tree, root at 1, leaf
``i`` at ``capacity + i``; node 0 is unused. All ops are batched tensor
ops with no host sync, so they run inside the fused chunk:

  - ``set_leaves`` scatters B leaves, then repairs ancestors level by
    level; every touched parent is recomputed from its children, so
    duplicate parents write identical values;
  - ``sample`` draws B stratified inverse-CDF queries and descends them in
    lock-step (``descend``: the plain version on the CPU, the CUDA kernel
    of ``ops/sampler_descent.py`` on the card).

Duplicate leaf indices in one ``set_leaves`` call: the last occurrence
wins, as with XLA's scatter-set and torch's CPU ``index_put_``. CUDA's
``index_put_`` picks an arbitrary writer among duplicates, so the values
are deduplicated explicitly first: every duplicate writes the value of
its index's last occurrence, which makes the scatter's outcome the same
whichever writer lands.

Indices ``>= capacity`` are pads and are dropped: they are parked on the
unused node 0 through every level, which is restored afterwards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from d4pg_tpu_torch.ops.sampler_descent import descend
from d4pg_tpu_torch.replay.segment_tree import next_pow2


class PerTrees(NamedTuple):
    sum_tree: torch.Tensor  # [2 * capacity] float32, node 1 is the root
    min_tree: torch.Tensor  # [2 * capacity] float32
    max_priority: torch.Tensor  # [] float32, running max of RAW priorities

    @property
    def capacity(self) -> int:
        return self.sum_tree.shape[0] // 2


def init(capacity: int, device: str | torch.device) -> PerTrees:
    """Fresh trees for ``capacity`` (rounded up to a power of two) slots."""
    cap = next_pow2(int(capacity))
    return PerTrees(
        sum_tree=torch.zeros(2 * cap, dtype=torch.float32, device=device),
        min_tree=torch.full((2 * cap,), float("inf"), dtype=torch.float32,
                            device=device),
        max_priority=torch.ones((), dtype=torch.float32, device=device),
    )


def _last_occurrence_values(idx: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """``values`` with each entry replaced by the value at the LAST
    position holding the same index (stable sort, then each sorted run
    takes its final element's value)."""
    n = idx.shape[0]
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    pos = torch.arange(n, device=idx.device)
    run_end = torch.ones(n, dtype=torch.bool, device=idx.device)
    run_end[:-1] = s[:-1] != s[1:]
    # for each sorted position, the first run end at or after it
    end = torch.where(run_end, pos, n).flip(0).cummin(0).values.flip(0)
    out = torch.empty_like(values)
    out[order] = values[order][end]
    return out


def set_leaves(trees: PerTrees, idx: torch.Tensor,
               p_alpha: torch.Tensor) -> PerTrees:
    """Write ``p_alpha`` ([B], already ``priority ** alpha``) at leaves
    ``idx`` ([B] int) and repair both trees' ancestors. Returns new trees;
    the input trees are left untouched."""
    cap = trees.capacity
    idx = idx.to(torch.int64)
    valid = idx < cap
    node = torch.where(valid, idx + cap, 0)
    vals = _last_occurrence_values(idx, p_alpha.to(torch.float32))
    s = trees.sum_tree.clone()
    m = trees.min_tree.clone()
    s[node] = vals
    # the min tree copies the sum tree's post-scatter leaves, so both
    # trees agree on one winner per slot
    m[node] = s[node]
    for _ in range(cap.bit_length() - 1):
        node = node >> 1
        # row p of the [cap, 2] view holds node p's children 2p and 2p + 1
        kids = s.view(cap, 2)[node]
        s[node] = kids[:, 0] + kids[:, 1]
        kids = m.view(cap, 2)[node]
        m[node] = torch.minimum(kids[:, 0], kids[:, 1])
    # pads parked on node 0 wrote there; node 0 is not part of the tree
    s[0] = trees.sum_tree[0]
    m[0] = trees.min_tree[0]
    return PerTrees(s, m, trees.max_priority)


def insert(trees: PerTrees, idx: torch.Tensor, alpha: float) -> PerTrees:
    """New transitions enter with ``max_priority ** alpha``."""
    p = (trees.max_priority ** alpha).expand(idx.shape)
    return set_leaves(trees, idx, p)


def update_from_td(trees: PerTrees, idx: torch.Tensor,
                   td_error: torch.Tensor, alpha: float,
                   eps: float = 1e-6) -> PerTrees:
    """Priority write-back: priority = |td| + eps, stored as ``p ** alpha``;
    the running max tracks the raw priority."""
    p = torch.abs(td_error) + eps
    trees = set_leaves(trees, idx, p ** alpha)
    return trees._replace(
        max_priority=torch.maximum(trees.max_priority, p.max()))


def strata_mass(u: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Stratified prefix masses: stratum ``i`` draws
    ``(i + u_i) * (total / B)``, in float32. ``B`` is a 0-dim tensor on
    ``u``'s device: CUDA multiplies by the reciprocal of a CPU scalar
    divisor, an ulp off the quotient the CPU and numpy compute."""
    b = u.shape[-1]
    i = torch.arange(b, dtype=torch.float32, device=u.device)
    return (i + u) * (total / torch.full((), float(b), dtype=torch.float32,
                                         device=u.device))


def sample_from_uniforms(trees: PerTrees, u: torch.Tensor,
                         limit: int) -> torch.Tensor:
    """Stratified proportional sampling from unit uniforms ``u`` ([B]).
    ``limit`` (the live row count) clips prefix overshoot onto written
    leaves. Returns int32 slots."""
    idx = descend(trees.sum_tree, strata_mass(u, trees.sum_tree[1]))
    return torch.clamp(idx, max=max(int(limit) - 1, 0))


def sample(trees: PerTrees, generator: torch.Generator, batch_size: int,
           limit: int) -> torch.Tensor:
    """Stratified proportional sampling with uniforms from ``generator``
    (which must live on the trees' device)."""
    u = torch.rand(batch_size, generator=generator,
                   device=trees.sum_tree.device)
    return sample_from_uniforms(trees, u, limit)


def is_weights(trees: PerTrees, idx: torch.Tensor, beta: float,
               size: int) -> torch.Tensor:
    """``(p_i * N) ** -beta`` normalized by the max weight (from the min
    tree). ``beta`` comes from :func:`beta_schedule`."""
    total = trees.sum_tree[1]
    n = float(size)
    p_min = trees.min_tree[1] / total
    max_weight = (p_min * n) ** (-beta)
    p = trees.sum_tree[trees.capacity + idx.to(torch.int64)] / total
    return (p * n) ** (-beta) / max_weight


def block_weights(total: torch.Tensor, min_root: torch.Tensor,
                  leaf_p: torch.Tensor, beta: float,
                  size: int) -> torch.Tensor:
    """IS weights of a dealt block from its tree scalars (0-dim float32
    tensors ``total`` and ``min_root``) and its gathered leaf priorities
    ``leaf_p`` ([K, B] float32): ``z = min_root / total * N``, then
    ``(p / total * N) ** -beta / z ** -beta``, all in float32 on
    ``leaf_p``'s device.

    One function for the device dealer and its float32 host twin
    (``replay/sampler.SampleDealer(scheme='device')``): float32 ``**`` is
    not bitwise portable between libraries, so both call this one on
    the same device and compare exactly. ``beta`` and ``N`` enter as
    0-dim float32 tensors made on that device (a Python scalar exponent
    would send a few betas to special-cased kernels, and a CPU scalar
    divisor is a multiply by its reciprocal on CUDA)."""
    dev = leaf_p.device
    n = torch.full((), float(size), dtype=torch.float32, device=dev)
    neg_beta = torch.full((), -float(np.float32(beta)), dtype=torch.float32,
                          device=dev)
    z = min_root / total * n
    max_weight = torch.pow(z, neg_beta)
    p = leaf_p / total
    return torch.pow(p * n, neg_beta) / max_weight


def beta_schedule(step: int, beta0: float, beta_steps: int) -> float:
    """PER beta annealing (beta0 -> 1 over ``beta_steps``, then clamped),
    computed on the host in float32 as the reference rounds it:
    ``step / beta_steps`` clipped to [0, 1], then
    ``beta0 + frac * (1 - beta0)``.
    A host float keeps the chunk free of transfers."""
    f32 = np.float32
    frac = min(max(f32(step) / f32(beta_steps), f32(0.0)), f32(1.0))
    return float(f32(beta0) + frac * f32(1.0 - beta0))
