"""Obs-driven autoscaler: sense -> decide -> actuate, ledgered.

Counterpart of ``d4pg_tpu/elastic/autoscaler.py``. The autoscaler polls
the obs registry's providers (``serving``, ``ingest``), runs a pure
hysteresis controller over the signals they export, and applies bounded
actuations through each owner's live setter, journaling every
observation -> decision -> actuation record in a ``ScalingLedger``.

- ``ControlPolicy``: the decision core, pure: the next decisions are a
  function of (config, signals, control state) only (no clock, no
  randomness, no I/O), so ``replay_decisions`` re-runs it over a ledger's
  recorded signals and must give the recorded decisions. Scale-up and
  scale-down have separate thresholds, each knob moves at most one step a
  decision, and a per-knob cooldown separates two moves.
- ``Autoscaler``: the thread. A tick senses (the registry export, with
  nothing held), decides (pure), actuates (each setter takes its owner's
  locks at top level) and journals. Its own state sits under
  ``_elastic_cond``, tier 60, above every data-plane tier; no lock is
  held across sense, decide or actuate, so the loop adds no lock edge.
  An actuator that raises is degraded and counted; an exception that
  escapes the thread goes through ``obs.containment.contained_crash``,
  leaving the planes at their last knobs.

``extract_signals`` reads plain numbers: a value it cannot turn into a
float reads as 0.0, a calm plane, so every provider it reads exports
Python scalars (a tensor or a numpy scalar would also break the ledger's
``json.dumps``).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from d4pg_tpu_torch.core.locking import TieredCondition
from d4pg_tpu_torch.elastic.ledger import ScalingLedger, canonical_record
from d4pg_tpu_torch.obs.containment import contained_crash
from d4pg_tpu_torch.obs.flight import (
    EVENT_SCALE_DOWN,
    EVENT_SCALE_UP,
    record_event,
)
from d4pg_tpu_torch.obs.registry import REGISTRY

# The knob vocabulary. Every knob the controller may move appears here;
# actuator dicts are validated against it so a typo'd wiring fails at
# construction, not silently at the first scale event.
KNOBS = ("serving_rows", "serving_window_s", "dealer_deals",
         "ingest_capacity", "replicas")


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Controller constants. Frozen: (config, signals) -> decisions is
    the replay contract, so the config is part of the stream identity."""

    interval_s: float = 0.25
    # -- serving batcher ----------------------------------------------------
    serving_rows_init: int = 32
    serving_rows_min: int = 16
    serving_rows_max: int = 512
    # two-point window schedule: hot traffic wants the batcher to close
    # windows fast (rows budget dominates), calm traffic wants wider
    # windows for occupancy
    serving_window_hot_s: float = 0.0005
    serving_window_cold_s: float = 0.004
    queue_high: int = 8          # pending requests: scale-up threshold
    queue_low: int = 2           # scale-down threshold (hysteresis gap)
    latency_high_ms: float = 50.0
    latency_low_ms: float = 10.0
    # -- ingest plane -------------------------------------------------------
    ingest_capacity_init: int = 64
    ingest_capacity_min: int = 32
    ingest_capacity_max: int = 512
    ingest_high: float = 0.5     # max shard depth / capacity
    ingest_low: float = 0.1
    # -- dealer pacing ------------------------------------------------------
    dealer_deals_init: int = 1
    dealer_deals_min: int = 1
    dealer_deals_max: int = 4
    # -- learner replicas ---------------------------------------------------
    replicas_init: int = 1
    replicas_min: int = 1
    replicas_max: int = 1
    # -- anti-flap ----------------------------------------------------------
    cooldown_ticks: int = 4


# Initial control state: current target per knob, last-move tick per
# knob, previous cumulative counters for delta signals.
def initial_state(cfg: AutoscalerConfig) -> dict:
    return {
        "targets": {
            "serving_rows": int(cfg.serving_rows_init),
            "serving_window_s": float(cfg.serving_window_cold_s),
            "dealer_deals": int(cfg.dealer_deals_init),
            "ingest_capacity": int(cfg.ingest_capacity_init),
            "replicas": int(cfg.replicas_init),
        },
        "last_move": {k: -10**9 for k in KNOBS},
        "prev_sheds": 0.0,
        "tick": 0,
    }


def extract_signals(snapshot: dict) -> dict:
    """Project a registry export (or any dict shaped like one) onto the
    controller's signal vector. Total: a missing provider or a
    provider_error section reads as a calm plane (zeros), never a
    crash — a dead component must degrade the controller to
    do-nothing, not kill its thread."""

    def _num(v, default=0.0):
        try:
            return float(v) if v is not None else float(default)
        except (TypeError, ValueError):
            return float(default)

    serving = snapshot.get("serving") or {}
    ingest = snapshot.get("ingest") or {}
    if not isinstance(serving, dict) or "provider_error" in serving:
        serving = {}
    if not isinstance(ingest, dict) or "provider_error" in ingest:
        ingest = {}
    lat = serving.get("latency_ms") or {}
    p95 = lat.get("p95") if isinstance(lat, dict) else None
    per_shard = ingest.get("per_shard") or []
    depth_frac = 0.0
    for sh in per_shard:
        cap = _num(sh.get("capacity"), 0.0)
        if cap > 0:
            depth_frac = max(depth_frac,
                             _num(sh.get("queue_depth")) / cap)
    return {
        "serving_queue": _num(serving.get("queue_depth")),
        "serving_p95_ms": _num(p95),
        "ingest_depth_frac": depth_frac,
        "ingest_sheds": (_num(ingest.get("sheds"))
                         + _num(ingest.get("admit_fails"))),
    }


class ControlPolicy:
    """The pure hysteresis controller. ``decide`` never mutates its
    inputs and touches no ambient state — the replay oracle depends on
    exactly this."""

    def __init__(self, cfg: AutoscalerConfig):
        self.cfg = cfg

    def initial_state(self) -> dict:
        return initial_state(self.cfg)

    def decide(self, signals: dict, state: dict) -> tuple[dict, dict]:
        """One control step: (signals, state) -> (decisions, state').
        ``decisions`` holds ONLY the knobs that move this tick, mapped
        to their new targets."""
        cfg = self.cfg
        tick = state["tick"]
        targets = dict(state["targets"])
        last = dict(state["last_move"])
        shed_delta = signals["ingest_sheds"] - state["prev_sheds"]

        hot_serving = (signals["serving_queue"] > cfg.queue_high
                       or signals["serving_p95_ms"] > cfg.latency_high_ms)
        cold_serving = (signals["serving_queue"] < cfg.queue_low
                        and signals["serving_p95_ms"] < cfg.latency_low_ms)
        hot_ingest = (signals["ingest_depth_frac"] > cfg.ingest_high
                      or shed_delta > 0)
        cold_ingest = (signals["ingest_depth_frac"] < cfg.ingest_low
                       and shed_delta == 0)

        def ready(knob: str) -> bool:
            return tick - last[knob] >= cfg.cooldown_ticks

        decisions: dict = {}

        def move(knob: str, value) -> None:
            if value != targets[knob]:
                decisions[knob] = value
                targets[knob] = value
                last[knob] = tick

        # serving batcher: one doubling/halving per move, window snaps
        # between its two set points alongside the row budget
        if hot_serving and ready("serving_rows"):
            move("serving_rows",
                 min(cfg.serving_rows_max, targets["serving_rows"] * 2))
            move("serving_window_s", cfg.serving_window_hot_s)
        elif cold_serving and ready("serving_rows"):
            move("serving_rows",
                 max(cfg.serving_rows_min, targets["serving_rows"] // 2))
            move("serving_window_s", cfg.serving_window_cold_s)

        # ingest depth: absorb a transient crowd by deepening the shard
        # deques (bounded), give the memory back when calm
        if hot_ingest and ready("ingest_capacity"):
            move("ingest_capacity",
                 min(cfg.ingest_capacity_max,
                     targets["ingest_capacity"] * 2))
        elif cold_ingest and ready("ingest_capacity"):
            move("ingest_capacity",
                 max(cfg.ingest_capacity_min,
                     targets["ingest_capacity"] // 2))

        # dealer pacing: a backlogged ingest plane needs the commit
        # thread's buffer-lock windows for DRAINING, not dealing — pace
        # the dealer down under pressure, back up when calm
        if hot_ingest and ready("dealer_deals"):
            move("dealer_deals",
                 max(cfg.dealer_deals_min, targets["dealer_deals"] // 2))
        elif cold_ingest and ready("dealer_deals"):
            move("dealer_deals",
                 min(cfg.dealer_deals_max, targets["dealer_deals"] * 2))

        # learner replicas: scale the training side with sustained load
        # (either plane hot), one replica per move through the
        # respawn + generation-fencing path
        if (hot_serving or hot_ingest) and ready("replicas"):
            move("replicas", min(cfg.replicas_max, targets["replicas"] + 1))
        elif cold_serving and cold_ingest and ready("replicas"):
            move("replicas", max(cfg.replicas_min, targets["replicas"] - 1))

        new_state = {
            "targets": targets,
            "last_move": last,
            "prev_sheds": signals["ingest_sheds"],
            "tick": tick + 1,
        }
        return decisions, new_state


def replay_decisions(cfg: AutoscalerConfig, records: list[dict]) -> list[dict]:
    """Re-run the pure controller over a ledger's recorded signal
    stream; returns the reproduced decision stream (one dict per
    record, same order)."""
    policy = ControlPolicy(cfg)
    state = policy.initial_state()
    out = []
    for rec in records:
        decisions, state = policy.decide(rec["signals"], state)
        out.append(decisions)
    return out


def replay_matches(cfg: AutoscalerConfig, ledger: ScalingLedger) -> bool:
    """The decision-stream replay oracle: True iff re-running the
    controller over the recorded signals reproduces every recorded
    decision (and the canonical digest therefore pins across runs of
    the same seed)."""
    records = ledger.records()
    replayed = replay_decisions(cfg, records)
    return all(
        canonical_record(rec)["decisions"]
        == dict(sorted(dec.items()))
        for rec, dec in zip(records, replayed)
    ) and len(replayed) == len(records)


class Autoscaler:
    """The control-loop thread. ``actuators`` maps knob names (see
    ``KNOBS``) to setter callables; absent knobs are decided and
    journaled but not actuated (the fleet may wire any subset).
    ``sensor`` defaults to the process registry's ``export`` — pass a
    callable for isolated tests."""

    def __init__(
        self,
        cfg: AutoscalerConfig | None = None,
        actuators: dict | None = None,
        sensor=None,
        ledger: ScalingLedger | None = None,
        register_provider: bool = True,
    ):
        self.cfg = cfg or AutoscalerConfig()
        self.actuators = dict(actuators or {})
        unknown = set(self.actuators) - set(KNOBS)
        if unknown:
            raise ValueError(f"unknown autoscaler knobs: {sorted(unknown)}")
        self._sensor = sensor if sensor is not None else REGISTRY.export
        self.ledger = ledger if ledger is not None else ScalingLedger()
        self._policy = ControlPolicy(self.cfg)
        # controller state + counters, all under the elastic condition
        self._elastic_cond = TieredCondition("elastic")
        self._state = self._policy.initial_state()
        self.stats = {
            "ticks": 0, "decisions": 0, "actuations": 0,
            "actuator_errors": 0, "sense_errors": 0,
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._registered = bool(register_provider)
        if self._registered:
            REGISTRY.register_provider("elastic", self.autoscaler_stats)

    # -- one control step ---------------------------------------------------
    def tick_once(self) -> dict:
        """Sense -> decide -> actuate -> journal, holding NO lock across
        any of the three phases (the zero-new-lock-edges contract).
        Returns the appended ledger record."""
        t_wall = time.monotonic()
        try:
            snapshot = self._sensor()
        except Exception:
            # a crashed sensor is a calm-plane read, counted
            snapshot = {}
            with self._elastic_cond:
                self.stats["sense_errors"] += 1
        signals = extract_signals(snapshot)
        with self._elastic_cond:
            state = self._state
        decisions, new_state = self._policy.decide(signals, state)
        actuated, errors = [], []
        for knob, value in decisions.items():
            fn = self.actuators.get(knob)
            if fn is None:
                continue
            try:
                fn(value)
                actuated.append(knob)
            except Exception as e:  # degrade-and-count, never wedge
                errors.append(f"{knob}: {type(e).__name__}: {e}")
        for knob, value in decisions.items():
            old = state["targets"][knob]
            record_event(EVENT_SCALE_UP if value > old else EVENT_SCALE_DOWN,
                         knob=knob, frm=old, to=value,
                         tick=state["tick"],
                         actuated=knob in actuated)
        rec = {
            "tick": state["tick"],
            "t_wall": round(t_wall, 6),
            "signals": signals,
            "decisions": decisions,
            "targets": dict(new_state["targets"]),
            "actuated": actuated,
            "errors": errors,
        }
        self.ledger.append(rec)
        with self._elastic_cond:
            self._state = new_state
            self.stats["ticks"] += 1
            self.stats["decisions"] += len(decisions)
            self.stats["actuations"] += len(actuated)
            self.stats["actuator_errors"] += len(errors)
        return rec

    # -- the thread ---------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="elastic-autoscaler")
            self._thread.start()
        return self

    def _run(self) -> None:
        try:
            self._loop()
        except Exception as e:  # noqa: BLE001 — top frame of the loop
            contained_crash("elastic.autoscaler", e)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.tick_once()
            self._stop.wait(self.cfg.interval_s)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._registered:
            REGISTRY.unregister_provider("elastic", self.autoscaler_stats)
            self._registered = False

    # -- observability ------------------------------------------------------
    def targets(self) -> dict:
        with self._elastic_cond:
            return dict(self._state["targets"])

    def autoscaler_stats(self) -> dict:
        """The ``elastic`` obs-registry provider: counters + live
        targets, one consistent snapshot under the elastic condition."""
        with self._elastic_cond:
            out = dict(self.stats)
            out["targets"] = dict(self._state["targets"])
            out["tick"] = self._state["tick"]
        out["ledger_digest"] = self.ledger.digest()
        out["ledger_records"] = len(self.ledger)
        return out
