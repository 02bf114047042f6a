"""Structured run logger with persistence.

Parity: the notebook ``Logger`` (``plotUtil.ipynb`` cell 0): named-series
logs keyed by a run name, a wall-clock timestamp per point, persistence on
every ``log()`` call, and cross-run comparison loading. JSONL instead of
pickle: append-only (a crash can't truncate the whole history, unlike the
original's rewrite-the-pickle-per-log), diffable, and readable without
unpickling arbitrary code.

A ``RunLogger`` is also a sink of ``io.metrics.MetricsBus``
(``bus.add_sink(RunLogger(path, run))``): each metric of a step is a
point of the series of its name.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from collections.abc import Mapping


class RunLogger:
    def __init__(self, path: str, run_name: str):
        self.run_name = run_name
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.series: dict[str, list] = defaultdict(list)
        self._file = open(path, "a")

    def log(self, series: str, step: int, value: float) -> None:
        """Append one point and persist it immediately (the original
        implementation persists per log() call too, cell 0)."""
        point = {"run": self.run_name, "series": series, "step": int(step),
                 "value": float(value), "time": time.time()}
        self.series[series].append((int(step), float(value)))
        self._file.write(json.dumps(point) + "\n")
        self._file.flush()

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        """The ``MetricsSink`` call: one point per metric."""
        for series, value in metrics.items():
            self.log(series, step, value)

    def close(self) -> None:
        self._file.close()

    @staticmethod
    def load(path: str) -> dict[str, dict[str, list]]:
        """Load a JSONL log into {run: {series: [(step, value), ...]}}."""
        runs: dict[str, dict[str, list]] = defaultdict(lambda: defaultdict(list))
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                p = json.loads(line)
                runs[p["run"]][p["series"]].append((p["step"], p["value"]))
        return {r: dict(s) for r, s in runs.items()}
