"""Structured metrics bus with pluggable sinks.

Counterpart of ``d4pg_tpu/io/metrics.py``: one ``log(step, {...})`` call
fans out to every sink: TensorBoard scalars (``torch.utils.tensorboard``,
imported when the sink is built; the driver prints ``tensorboard
disabled`` and carries on when it is missing), CSV rows of ``step`` and
the named columns, and stdout. A sink that raises is reported once,
dropped for the rest of the run and counted in the unified registry
(``metrics_bus.sink_failures``), so a full disk under the CSV logger
never kills the learner and the lost telemetry is itself telemetered.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping, Protocol

from d4pg_tpu_torch.obs.registry import REGISTRY


class MetricsSink(Protocol):
    def write(self, step: int, metrics: Mapping[str, float]) -> None: ...
    def close(self) -> None: ...


class TensorBoardSink:
    """TensorBoard scalars through ``torch.utils.tensorboard``."""

    def __init__(self, log_dir: str):
        # the writer needs only tensorboard's protobuf stub, but its compat
        # layer imports the whole tensorflow package when one is
        # installed; this marker module makes it take its stub instead
        import sys
        import types

        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir)

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        for name, value in metrics.items():
            self._writer.add_scalar(name, float(value), int(step))

    def close(self) -> None:
        self._writer.close()


class CsvLogger:
    """CSV rows ``step, <fieldnames...>`` (empty where a metric is
    absent)."""

    def __init__(self, path: str, fieldnames: list[str]):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a", newline="")
        self._writer = csv.writer(self._file)
        self._fields = fieldnames

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        row = [step] + [metrics.get(f, "") for f in self._fields]
        self._writer.writerow(row)
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class _StdoutSink:
    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        parts = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
        print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        pass


class MetricsBus:
    """Sink fan-out with crash containment (see the module docstring);
    ``sink_failures`` counts this bus's failures, the registry's
    ``metrics_bus.sink_failures`` those of every bus."""

    def __init__(self, sinks: list | None = None, echo: bool = False):
        self._sinks: list = list(sinks or [])
        if echo:
            self._sinks.append(_StdoutSink())
        self._dead: list = []
        self.sink_failures = 0

    def add_sink(self, sink) -> None:
        self._sinks.append(sink)

    def _disable(self, sink, op: str, err: Exception) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)
            self._dead.append(sink)
        self.sink_failures += 1
        REGISTRY.counter("metrics_bus.sink_failures").inc()
        print(f"metrics sink {type(sink).__name__} disabled after "
              f"{op}() raised {type(err).__name__}: {err}", flush=True)

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        for sink in list(self._sinks):
            try:
                sink.write(step, metrics)
            except Exception as e:  # noqa: BLE001 — containment is the point
                self._disable(sink, "write", e)

    def close(self) -> None:
        for sink in list(self._sinks) + list(self._dead):
            try:
                sink.close()
            except Exception as e:  # noqa: BLE001
                self._disable(sink, "close", e)
        self._sinks = []
        self._dead = []
