"""Priority classes and the per-class admission policy.

Counterpart of ``d4pg_tpu/elastic/admission.py``. Every producer identity
(an actor id on the ingest plane, a lane id on the serving plane) maps to
a priority class, class 0 the most protected. The class comes from the
identity on the server side (a trailing integer, else ``zlib.crc32`` of
the id), so a client cannot promote itself and no wire format changes.
Under pressure the lowest class is shed first (oldest within it), and an
incoming item that ranks below everything queued is itself rejected:
no priority inversion. Every shed and reject is attributed to its class
by its owner (``sheds_by_class`` in ``ReplayService.ingest_stats``,
``admission_rejects_by_class`` in ``PolicyInferenceServer.serving_stats``).

The policy is frozen and stateless: sharing it across every shard
condition and the serving condition adds no lock edge.
"""

from __future__ import annotations

import dataclasses
import re
import zlib

_TRAILING_INT = re.compile(r"(\d+)\s*$")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Class table and per-class queue budgets: ``classes`` most
    protected first; class c is admitted only while the queue stands
    below ``depth_fracs[c] * bound``, a strict-priority admission curve
    without reordering the queue."""

    classes: tuple[str, ...] = ("rt", "bulk")
    depth_fracs: tuple[float, ...] = (1.0, 0.5)

    def __post_init__(self):
        if len(self.classes) != len(self.depth_fracs) or not self.classes:
            raise ValueError("classes and depth_fracs must align, non-empty")
        if any(not (0.0 < f <= 1.0) for f in self.depth_fracs):
            raise ValueError("depth_fracs must be in (0, 1]")

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def classify_index(self, index: int) -> int:
        """Lane or actor index -> class, interleaved (index % n_classes),
        so every class is populated at any fleet size."""
        return int(index) % self.n_classes

    def classify_actor(self, actor_id: str) -> int:
        """Actor id -> class: a trailing integer (``actor-<i>``,
        ``proc-<i>``) classifies by index, anything else by a crc32 of the
        id (not ``hash()``, which is salted per process)."""
        m = _TRAILING_INT.search(actor_id)
        if m is not None:
            return self.classify_index(int(m.group(1)))
        return zlib.crc32(actor_id.encode()) % self.n_classes

    def class_name(self, cls: int) -> str:
        return self.classes[min(max(cls, 0), self.n_classes - 1)]

    def depth_for(self, cls: int, depth_bound: int) -> int:
        """Queue-depth budget of ``cls`` under ``depth_bound`` (at least 1)."""
        frac = self.depth_fracs[min(max(cls, 0), self.n_classes - 1)]
        return max(1, int(frac * depth_bound))

    def shed_victim(self, queued_classes: list[int],
                    incoming_cls: int) -> int | None:
        """The queue index of the shed victim among ``queued_classes``
        (queue order, oldest first): the oldest item of the worst class
        queued. None when the incoming item ranks below everything queued
        (the caller rejects it instead of evicting better-class work)."""
        if not queued_classes:
            return None
        worst = max(queued_classes)
        if incoming_cls > worst:
            return None
        return queued_classes.index(worst)
