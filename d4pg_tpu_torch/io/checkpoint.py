"""Full learner-state checkpoints with exact resume, saved with
``torch.save``.

Counterpart of ``CheckpointManager`` in ``d4pg_tpu/io/checkpoint.py``,
with its method names (``save(state, extra)``, ``wait``, ``latest_step``,
``restore(template)``, ``close``) and ``max_to_keep``. A checkpoint holds
everything a learner needs to go on exactly where it stopped: the actor,
the critic and both targets, both Adam states, the step (it also drives
the PER beta schedule), the state's own generator (the DrQ offsets and
MoG draws; the reference keeps a PRNG key in its state), the learner's
``torch.Generator`` state (it draws the PER uniforms) and the caller's
``extra`` (the driver's ``env_steps``). A CURL state adds its ``curl``
module (``W``, and the critic's encoder again) and its two Adams,
``encoder_opt`` and ``curl_opt``; a CURL checkpoint restores into a CURL
template only, and a plain one into a plain one.

Layout: ``<directory>/<step>.pt``, written to a temporary name and
renamed, so a crash mid-save leaves the previous checkpoint whole; the
oldest beyond ``max_to_keep`` are deleted after each save. Saves are
synchronous, so ``wait`` has nothing to wait for. Reading the reference's
Orbax checkpoints is not ported.

Replay sidecars (``--checkpoint_replay``): the replay service's snapshot
travels next to the checkpoint, not inside it, in the reference's frame
(``core/wire.py``'s ``sidecar`` row): ``[b"D4RS"][u8 version][u32
crc32]`` then a pickle of ``{"step", "snap"}``, the CRC over the pickle,
written to a temporary name and renamed. A torn or rotted file is refused
with ``SnapshotCorruptError``; a bare pickle (a sidecar from before the
frame) still loads. The snapshot holds numpy arrays and Python scalars
only, never torch tensors (a pickled tensor would tie the file to torch
and to a device), so either package reads the other's sidecars.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Any

import torch

from d4pg_tpu_torch.core.wire import SIDECAR_HEAD, SIDECAR_MAGIC, SIDECAR_VERSION
from d4pg_tpu_torch.learner.state import D4PGState

_MODULES = ("actor", "critic", "target_actor", "target_critic")
_OPTIMIZERS = ("actor_opt", "critic_opt")
_CURL = ("curl", "encoder_opt", "curl_opt")


def _entries(state: D4PGState) -> tuple[str, ...]:
    """The state's modules and optimizers a checkpoint holds."""
    return _MODULES + _OPTIMIZERS + (_CURL if state.curl is not None
                                     else ())


class SnapshotCorruptError(RuntimeError):
    """A replay sidecar that fails the integrity check (bad magic, unknown
    version, CRC mismatch, an undecodable body). Callers treat it as a
    missing sidecar, loudly: a torn snapshot must never reach the
    buffer."""


def replay_sidecar_path(run_dir: str, process_index: int) -> str:
    return os.path.join(run_dir, f"replay_p{process_index}.pkl")


def _numpy_only(node, where: str = "snap") -> None:
    """Refuse a torch tensor anywhere in a snapshot (see the module
    docstring)."""
    if isinstance(node, torch.Tensor):
        raise TypeError(f"{where} is a torch tensor; a replay snapshot "
                        "holds numpy arrays and Python scalars only")
    if isinstance(node, dict):
        for k, v in node.items():
            _numpy_only(v, f"{where}[{k!r}]")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _numpy_only(v, f"{where}[{i}]")


def save_replay_sidecar(run_dir: str, process_index: int, step: int,
                        snap: dict) -> str:
    """Write one host's replay snapshot, stamped with the learner step of
    its cut, in the CRC frame (write, then rename). Returns the path."""
    _numpy_only(snap)
    payload = pickle.dumps({"step": int(step), "snap": snap},
                           protocol=pickle.HIGHEST_PROTOCOL)
    head = SIDECAR_HEAD.pack(SIDECAR_MAGIC, SIDECAR_VERSION,
                             zlib.crc32(payload) & 0xFFFFFFFF)
    path = replay_sidecar_path(run_dir, process_index)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(head + payload)
    os.replace(tmp, path)
    return path


def load_replay_sidecar(run_dir: str,
                        process_index: int) -> tuple[dict, int] | None:
    """``(snap, snap_step)`` of one host's sidecar, or None when there is
    none. Raises ``SnapshotCorruptError`` on any integrity failure; a bare
    pickle without the frame loads as it is."""
    path = replay_sidecar_path(run_dir, process_index)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] == SIDECAR_MAGIC:
        if len(blob) < SIDECAR_HEAD.size:
            raise SnapshotCorruptError(f"{path}: truncated sidecar header")
        _magic, version, crc = SIDECAR_HEAD.unpack_from(blob, 0)
        if version != SIDECAR_VERSION:
            raise SnapshotCorruptError(
                f"{path}: unknown sidecar version {version}")
        payload = blob[SIDECAR_HEAD.size:]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise SnapshotCorruptError(
                f"{path}: CRC mismatch (a torn write or bit rot); refusing "
                "the snapshot")
    else:
        payload = blob  # a sidecar from before the frame: a bare pickle
    try:
        d = pickle.loads(payload)
        snap, step = d["snap"], int(d.get("step", -1))
    except Exception as e:  # noqa: BLE001 — any undecodable body is corrupt
        raise SnapshotCorruptError(f"{path}: undecodable sidecar ({e})")
    return snap, step


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{int(step)}.pt")

    def steps(self) -> list[int]:
        """Steps of the checkpoints on disk, oldest first."""
        return sorted(int(name[:-3]) for name in os.listdir(self._dir)
                      if name.endswith(".pt") and name[:-3].isdigit())

    def save(self, state: D4PGState, extra: dict[str, Any] | None = None,
             generator: torch.Generator | None = None) -> None:
        """Checkpoint at the state's own learner step."""
        payload = {name: getattr(state, name).state_dict()
                   for name in _entries(state)}
        payload["step"] = int(state.step)
        payload["state_generator"] = state.generator.get_state()
        payload["generator"] = (None if generator is None
                                else generator.get_state())
        payload["extra"] = dict(extra or {})
        path = self._path(state.step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: D4PGState,
                generator: torch.Generator | None = None,
                ) -> tuple[D4PGState, dict[str, Any]]:
        """Load the latest checkpoint into ``template`` (a state built
        with the same config, on the device to resume on) and, when given,
        ``generator``. Returns ``(template, extra)``."""
        step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        payload = torch.load(self._path(step), map_location=template.device,
                             weights_only=True)
        if ("curl" in payload) != (template.curl is not None):
            raise ValueError(
                f"checkpoint {self._path(step)} is "
                f"{'' if 'curl' in payload else 'not '}a CURL state and the "
                f"template is {'' if template.curl is not None else 'not '}"
                "one: build the template with the run's --contrastive")
        for name in _entries(template):
            getattr(template, name).load_state_dict(payload[name])
        template.step = int(payload["step"])
        template.targets_tied = False  # the saved targets may be untied
        template.generator.set_state(payload["state_generator"].cpu())
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"].cpu())
        return template, dict(payload["extra"])

    def close(self) -> None:
        """Nothing to release."""
