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
``extra`` (the driver's ``env_steps``).

Layout: ``<directory>/<step>.pt``, written to a temporary name and
renamed, so a crash mid-save leaves the previous checkpoint whole; the
oldest beyond ``max_to_keep`` are deleted after each save. Saves are
synchronous, so ``wait`` has nothing to wait for. Reading the reference's
Orbax checkpoints and its replay sidecars waits for ROADMAP Queue 1
item 17.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from d4pg_tpu_torch.learner.state import D4PGState

_MODULES = ("actor", "critic", "target_actor", "target_critic")
_OPTIMIZERS = ("actor_opt", "critic_opt")


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
                   for name in _MODULES + _OPTIMIZERS}
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
        for name in _MODULES + _OPTIMIZERS:
            getattr(template, name).load_state_dict(payload[name])
        template.step = int(payload["step"])
        template.generator.set_state(payload["state_generator"].cpu())
        if generator is not None and payload["generator"] is not None:
            generator.set_state(payload["generator"].cpu())
        return template, dict(payload["extra"])

    def close(self) -> None:
        """Nothing to release."""
