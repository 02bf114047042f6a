"""Scaling-decision ledger: the autoscaler's observation -> decision ->
actuation records, in order.

Counterpart of ``d4pg_tpu/elastic/ledger.py``. Each record holds the
tick, the signals the decision saw, the decisions, the targets after them,
the actuators that fired and the actuator errors. The decision core
(``autoscaler.ControlPolicy``) is a pure function of (config, signals,
state), so re-running it over the recorded signals must give the recorded
decisions (``autoscaler.replay_matches``). ``digest`` is a sha256 over the
replay-covered fields only (``canonical_record``: no wall time, no
actuation outcome), as a sorted, compact ``json.dumps``: the same stream
gives the same digest in either package, and a ledger written by one
replays under the other.

Locking: one terminal ``_mu`` (the obs-plane rule: nothing is acquired
while it is held), so appending adds no lock edge.
"""

from __future__ import annotations

import hashlib
import json
import threading


def canonical_record(rec: dict) -> dict:
    """The replay-covered projection of a record: tick, signals,
    decisions and targets (wall time and actuation outcomes excluded:
    an actuator error is a fact of the environment, not of the
    decision)."""
    return {
        "tick": rec["tick"],
        "signals": dict(sorted(rec["signals"].items())),
        "decisions": dict(sorted(rec["decisions"].items())),
        "targets": dict(sorted(rec["targets"].items())),
    }


class ScalingLedger:
    """Append-only, bounded decision journal: past ``capacity`` records
    the oldest is dropped and counted (the digest covers what is kept and
    the count of what is not)."""

    def __init__(self, capacity: int = 8192):
        self._mu = threading.Lock()
        self._records: list[dict] = []
        self._dropped = 0
        self._capacity = max(1, int(capacity))

    def append(self, rec: dict) -> None:
        with self._mu:
            self._records.append(rec)
            if len(self._records) > self._capacity:
                self._records.pop(0)
                self._dropped += 1

    def records(self) -> list[dict]:
        with self._mu:
            return list(self._records)

    def __len__(self) -> int:
        with self._mu:
            return len(self._records)

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._dropped

    def digest(self) -> str:
        """sha256 over the canonical stream: the decision-stream equality
        oracle compares two of these."""
        with self._mu:
            recs = list(self._records)
            dropped = self._dropped
        doc = {"dropped": dropped,
               "records": [canonical_record(r) for r in recs]}
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_jsonable(self, tail: int | None = None) -> dict:
        """Artifact form: the digest and the (optionally last ``tail``)
        records."""
        with self._mu:
            recs = list(self._records)
            dropped = self._dropped
        if tail is not None:
            recs = recs[-tail:]
        return {"digest": self.digest(), "dropped": dropped,
                "n_records": len(self), "records": recs}
