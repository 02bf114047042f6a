"""One learner replica: its own training state, merged through an
aggregator.

Counterpart of ``d4pg_tpu/learner/replica.py``. A ``LearnerReplica``
holds a full ``D4PGState`` (networks, its own Adam states, its own
generator); its networks are a working copy of the aggregator's tree.
Each round it

    1. pulls a basis from the aggregator (params arrive only when another
       replica advanced the aggregate: a replica never re-adopts its own
       round trip),
    2. runs ``n`` grad steps against replay,
    3. submits its params stamped with the basis version, so the
       aggregator can weight the update by its staleness
       (``learner/aggregator.py``).

Adam states and generators do not go through the aggregator: the
correction is defined on parameters, and each replica's moments follow
its own trajectory.

Three sampling modes, chosen by what the replica is given:

- **fused** (``buffer=`` a ``FusedDeviceReplay``, with the PER
  ``generator=``; ``service=`` optionally adds the ingest overlap):
  ``learner/loop.FusedLoop``, single consumer by construction. The
  driver never builds one (its fused path has no replicas); the N = 1
  oracle does.
- **host** (``service=`` alone): ``ReplayService.sample_chunk`` under the
  service's buffer lock (safe for N replicas), ``multi_update_step`` and
  the write-back with the generation guard.
- **dealt** (``dealt_ring=`` with ``service=``): the sample-on-ingest
  plane. The replica pops dealt blocks from its ring and writes TD
  priorities back through ``service.queue_writeback``: the ring's leaf
  lock and the ``sampler`` tier, never the buffer lock
  (``learner/loop.DealtLoop``). Host blocks and device blocks ride the
  same ring and loop.

Submitting over TCP (``updates=`` a ``distributed/update_plane.
UpdateClient``): registration, fencing and basis pulls stay with the
in-process aggregator ``agg``, and each round's submission travels as an
update frame to the ``AggregatorServer`` in front of it, stamped with the
store's generation. Either way a round copies the networks to the host
once (``params_of``; the frame reads those CPU tensors without another
copy) and copies an adopted basis to the device once.

PER beta: pass one shared ``replay/schedule.SharedBetaSchedule`` so every
replica reads the same global clock; without it a private clock gives
one replica the plain loop's anneal.

Replica states (``replica_state``): every replica gets its own copy of
each tensor of the state (networks and Adam moments cloned together, so
no two replicas alias a tensor that an update writes in place). A torch
generator cannot ``fold_in`` a key as the reference's replicas do:
replica 0 continues the state's own generator (so one replica draws the
plain loop's stream), and replica ``i > 0`` seeds a fresh one from
``(seed, i)`` through ``numpy.random.SeedSequence``.

Locking: ``_replica_lock`` (tier ``replica`` 36) guards the counters
only; it is never held across sampling, the grad steps or ``submit``
(the buffer lock, 40, sits above it).
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch.core.locking import TieredLock
from d4pg_tpu_torch.distributed.weights import copy_params
from d4pg_tpu_torch.learner.loop import DealtLoop, FusedLoop
from d4pg_tpu_torch.learner.state import (
    D4PGConfig,
    D4PGState,
    refuse_contrastive,
)
from d4pg_tpu_torch.learner.update import multi_update_step
from d4pg_tpu_torch.replay.schedule import SharedBetaSchedule
from d4pg_tpu_torch.replay.uniform import TransitionBatch

# the aggregation tree's fields (the reference's names) and the modules
# that hold them; targets are included, or the distributional bootstrap
# would tear apart across replicas
PARAM_FIELDS = ("actor_params", "critic_params",
                "target_actor_params", "target_critic_params")
_MODULES = dict(zip(PARAM_FIELDS, ("actor", "critic", "target_actor",
                                   "target_critic")))


def params_of(state: D4PGState, to_host: bool = True) -> dict:
    """The aggregation tree: each field a dict of name -> a copy of the
    module's tensor (on the CPU, or on the state's device with
    ``to_host=False``)."""
    return {f: copy_params(getattr(state, m), to_host)
            for f, m in _MODULES.items()}


def adopt_params(state: D4PGState, params: dict) -> None:
    """Load an aggregate into ``state``'s networks in place, keeping its
    Adam states, generator and step."""
    with torch.no_grad():
        for f, m in _MODULES.items():
            getattr(state, m).load_state_dict(params[f])
    state.targets_tied = False  # an aggregate's targets may be untied


def replica_generator_seed(seed: int, replica: int) -> int:
    """The generator seed of replica ``replica > 0`` (see the module
    docstring)."""
    ss = np.random.SeedSequence([int(seed), int(replica)])
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def replica_state(state: D4PGState, replica: int, seed: int,
                  device: torch.device | None = None) -> D4PGState:
    """Replica ``replica``'s own copy of ``state`` (see the module
    docstring), on ``device`` (the state's own by default; another card
    of the same type takes the networks, the Adam moments and the
    generator's state across)."""
    nets = copy.deepcopy((state.actor, state.critic, state.target_actor,
                          state.target_critic, state.actor_opt,
                          state.critic_opt))
    device = state.device if device is None else torch.device(device)
    if device != state.device:
        if device.type != state.device.type:
            raise ValueError(f"a replica of a {state.device} state goes on "
                             f"a {state.device.type} device, not {device}")
        for module in nets[:4]:
            module.to(device)  # in place: the optimizers keep their params
        for opt in nets[4:]:
            for st in opt.state.values():
                for key, v in st.items():
                    if torch.is_tensor(v) and v.device.type != "cpu":
                        st[key] = v.to(device)
    gen = torch.Generator(device=device)
    if replica == 0 and state.generator is not None:
        gen.set_state(state.generator.get_state())
    else:
        gen.manual_seed(replica_generator_seed(seed, replica))
    return D4PGState(*nets, step=state.step, generator=gen,
                     targets_tied=state.targets_tied)


class LearnerReplica:
    """See the module docstring. ``agg`` has the ``Aggregator`` duck type
    (register, basis, submit, fence_replica, generation); ``updates``,
    when given, submits in its place."""

    def __init__(
        self,
        replica_id: int,
        config: D4PGConfig,
        agg,
        state: D4PGState,
        *,
        k: int,
        batch_size: int,
        prioritized: bool = True,
        alpha: float = 0.6,
        beta0: float = 0.4,
        beta_steps: int = 100_000,
        buffer=None,
        service=None,
        dealt_ring=None,
        beta_schedule: SharedBetaSchedule | None = None,
        generator: torch.Generator | None = None,
        updates=None,
    ):
        refuse_contrastive(config, "a learner replica")
        if buffer is None and service is None:
            raise ValueError(
                "need buffer= (fused mode, sole consumer; service= "
                "optionally adds the ingest overlap) or service= alone "
                "(host-sampled mode, N-replica safe; add dealt_ring= "
                "for the sample-on-ingest dealt mode)")
        if dealt_ring is not None and (buffer is not None or service is None):
            raise ValueError("dealt mode needs service= (for the priority "
                             "write-back) and no fused buffer=")
        if dealt_ring is not None and not prioritized:
            raise ValueError(
                "dealt mode is PER-only: dealt blocks carry IS weights")
        if buffer is not None and generator is None:
            raise ValueError("fused mode needs generator= (the PER draws)")
        self.replica_id = int(replica_id)
        self._config = config
        self._agg = agg
        self._updates = updates
        self._state = state
        self._device = state.device
        if buffer is not None:
            self.mode = "fused"
        elif dealt_ring is not None:
            self.mode = "dealt"
        else:
            self.mode = "host"
        self.k = max(1, int(k))
        self._batch_size = int(batch_size)
        self._prioritized = bool(prioritized)
        self._service = service
        self._beta_sched = beta_schedule or SharedBetaSchedule(
            beta0=beta0, beta_steps=beta_steps)
        self._stop = threading.Event()
        self._loop = None
        self._dealt_loop = None
        if self.mode == "fused":
            self._loop = FusedLoop(
                config, buffer, k=self.k, batch_size=batch_size,
                generator=generator, prioritized=prioritized, alpha=alpha,
                beta0=beta0, beta_steps=beta_steps, service=service)
        elif self.mode == "dealt":
            self._dealt_loop = DealtLoop(self._update, dealt_ring, service,
                                         device=self._device,
                                         stop=self._stop)
        # the counters only (see the module docstring)
        self._replica_lock = TieredLock("replica")
        self.epoch = agg.register(self.replica_id,
                                  params=params_of(state), step=0)
        self.steps_done = 0
        self.last_metrics = None  # the last chunk's stacked-[K] metrics
        self.rounds = 0
        self.applied = 0
        self.fenced = 0
        self.last_lag: Optional[int] = None
        self.last_status = "idle"

    def _update(self, state: D4PGState, batches: TransitionBatch,
                weights=None) -> dict:
        return multi_update_step(self._config, state, batches, weights)

    # -- the sampling paths --------------------------------------------------
    def _host_steps(self, n: int) -> None:
        svc = self._service
        dev = self._device
        done = 0
        # one clock read per call: beta is constant over the call's chunks
        beta = self._beta_sched.beta_at(self._beta_sched.current_step())
        while done < n and not self._stop.is_set():
            k = min(self.k, n - done)
            if self._prioritized:
                batches, w, idx, gen = svc.sample_chunk(
                    k, self._batch_size, beta=beta,
                    weight_base=svc.weight_base())
                metrics = self._update(
                    self._state, _to_device(batches, dev),
                    torch.as_tensor(w, device=dev))
                td = np.abs(metrics["td_error"].cpu().numpy()) + 1e-6
                svc.update_priorities(idx, td, generation=gen)
            else:
                batches, _w, _idx, _gen = svc.sample_chunk(
                    k, self._batch_size)
                metrics = self._update(self._state,
                                       _to_device(batches, dev))
            self.last_metrics = metrics
            done += k
        if done:
            self._beta_sched.advance(done)
        self.steps_done += done

    def _dealt_steps(self, n: int) -> None:
        """Pop, K-step update, queued write-back (``DealtLoop``); beta
        came with the block, from the dealer's shared clock."""
        before = self._dealt_loop.steps_done
        metrics = self._dealt_loop.run(self._state, n)
        if metrics is not None:
            self.last_metrics = metrics
        self.steps_done += self._dealt_loop.steps_done - before

    def _fused_steps(self, n: int) -> None:
        metrics = self._loop.run(self._state, n)
        if metrics is not None:
            self.last_metrics = metrics
        self.steps_done += n

    # -- the round -----------------------------------------------------------
    def run_round(self, n: int, generation: int | None = None) -> dict:
        """Basis adoption, ``n`` grad steps, a version-stamped submit;
        returns the aggregator's verdict. No replica lock is held across
        any of it."""
        basis_version, basis = self._agg.basis(self.replica_id)
        if basis is not None:
            adopt_params(self._state, basis)
        if self.mode == "fused":
            self._fused_steps(n)
        elif self.mode == "dealt":
            self._dealt_steps(n)
        else:
            self._host_steps(n)
        submit = self._agg.submit
        if self._updates is not None:
            # a frame always carries a generation: the store's by default
            submit = self._updates.submit
            if generation is None:
                generation = self._agg.generation
        result = submit(self.replica_id, self.epoch, params_of(self._state),
                        basis_version, step=self.steps_done,
                        generation=generation)
        with self._replica_lock:
            self.rounds += 1
            self.last_status = result["status"]
            self.last_lag = result.get("lag")
            if result["status"] == "applied":
                self.applied += 1
            elif result["status"] == "fenced":
                self.fenced += 1
        return result

    def respawn(self) -> int:
        """After a crash: fence the dead epoch (its in-flight submission
        bounces), then register at the next one. The state stays: the
        thread died, not the params."""
        self._agg.fence_replica(self.replica_id)
        self.epoch = self._agg.register(self.replica_id)
        self._stop.clear()
        return self.epoch

    @property
    def state(self) -> D4PGState:
        return self._state

    def stats(self) -> dict:
        with self._replica_lock:
            return {"replica": self.replica_id, "mode": self.mode,
                    "epoch": self.epoch, "steps": self.steps_done,
                    "rounds": self.rounds, "applied": self.applied,
                    "fenced": self.fenced, "lag": self.last_lag,
                    "status": self.last_status}

    def close(self) -> None:
        self._stop.set()
        if self._loop is not None:
            self._loop.close()


def _to_device(batches, device) -> TransitionBatch:
    return TransitionBatch(*[torch.as_tensor(f, device=device)
                             for f in batches])
