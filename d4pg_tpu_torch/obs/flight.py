"""Flight recorder: the last N structured events, dumped on demand.

Counterpart of ``d4pg_tpu/obs/flight.py``: a bounded in-memory ring of
recent structured events (contained thread crashes, lock-hierarchy
violations, ...) that a harness or a test dumps as a JSON postmortem,
so a failure comes with what the planes were doing just before it.
``record`` is one lock round trip and a deque append; the ring drops its
oldest event when full.

Lock discipline: one terminal ``_mu`` (see ``obs/__init__``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque


class FlightRecorder:
    # dumps kept per directory: ``dump`` prunes its own ``flight_*.json``
    # files to the newest ``keep_dumps`` after each write
    keep_dumps = 32

    def __init__(self, maxlen: int = 2048, keep_dumps: int | None = None):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=int(maxlen))
        self._seq = 0
        self._dump_seq = 0
        if keep_dumps is not None:
            self.keep_dumps = int(keep_dumps)
        self.enabled = True

    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        t = time.monotonic()
        with self._mu:
            self._seq += 1
            self._ring.append({"seq": self._seq, "t": round(t, 6),
                               "kind": kind, **fields})

    def events(self) -> list[dict]:
        with self._mu:
            return list(self._ring)

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    def reset(self) -> None:
        with self._mu:
            self._ring.clear()
            self._seq = 0

    def dump(self, directory: str, reason: str,
             extra: dict | None = None, keep: int | None = None) -> str:
        """Write the ring as a JSON postmortem and return its path. The
        name carries a wall-clock stamp, the pid, a per-process sequence
        and the reason, so a directory of dumps sorts chronologically and
        two dumps in one second do not collide. Then the directory is
        pruned to the newest ``keep`` (default ``keep_dumps``)
        ``flight_*.json`` files."""
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        with self._mu:
            self._dump_seq += 1
            seq = self._dump_seq
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)[:40]
        path = os.path.join(
            directory,
            f"flight_{stamp}_{os.getpid():07d}-{seq:04d}_{safe}.json")
        payload = {
            "reason": reason,
            "dumped_at": stamp,
            "n_events": len(self),
            "events": self.events(),
        }
        if extra:
            payload["context"] = extra
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        prune_artifacts(directory, "flight_",
                        self.keep_dumps if keep is None else keep)
        return path


def prune_artifacts(directory: str, prefix: str, keep: int) -> list[str]:
    """Keep the newest ``keep`` ``{prefix}*.json`` files in ``directory``
    (newest = lexically greatest: the names start with a
    ``%Y%m%d-%H%M%S`` stamp), delete the rest, and return the deleted
    paths. ``keep <= 0`` keeps everything. A file removed under us by
    another pruner is skipped."""
    if keep <= 0:
        return []
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(prefix) and n.endswith(".json"))
    except OSError:
        return []
    doomed = []
    for name in names[:-keep] if len(names) > keep else []:
        path = os.path.join(directory, name)
        try:
            os.remove(path)
            doomed.append(path)
        except OSError:
            pass
    return doomed


# The elastic plane's event kinds: the autoscaler records one per scaling
# decision, the admission-controlled replay service and policy server one
# per class-attributed rejection (free-form kinds stay legal)
EVENT_SCALE_UP = "scale_up"
EVENT_SCALE_DOWN = "scale_down"
EVENT_ADMISSION_REJECT = "admission_reject"

# THE process-wide recorder: the replay service, the evaluator and the
# lock hierarchy record here
RECORDER = FlightRecorder()


def record_event(kind: str, **fields) -> None:
    """Record one event on the process recorder."""
    RECORDER.record(kind, **fields)
