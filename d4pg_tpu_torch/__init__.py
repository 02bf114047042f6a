"""PyTorch + CUDA port of ``d4pg_tpu`` for one NVIDIA H100.

The JAX package ``d4pg_tpu`` is the reference; this package mirrors its
module paths (``core/distribution.py`` here is the counterpart of
``d4pg_tpu/core/distribution.py``) and imports nothing from it, nor JAX.
It runs the reference's main path: the training driver
(``python -m d4pg_tpu_torch.train``, ``train.py`` and ``config.py``),
its actors, evaluator and weight store (``distributed/``, ``serving/``,
``envs/``), the in-process replay service feeding the fused
replay+learn loop (``learner/loop.py`` over ``learner/fused.py``, PER or
uniform), metrics and checkpoints (``io/``), with hand-written CUDA
kernels for every TPU kernel of the reference: the Bellman projection
(``ops/projection.py``), the projection fused into the cross-entropy
critic loss, forward and backward (``ops/projection_ce.py``), and the PER
sum-tree descent (``ops/sampler_descent.py``); plus the projection
autotuner (``ops/autotune.py``) and the exploration noise
(``core/noise.py``).

Device rule: every entry point takes an explicit ``device`` and defaults
to ``"cuda"``. With no card present that default fails loudly; only an
explicit ``device="cpu"`` (``--platform cpu`` for the driver) runs on the
CPU (the tests pass it). No code carries on on the CPU when it finds no
GPU. Acting and eval run on the host CPU by the driver's
``--actor_device cpu`` default, the reference's own choice.

It trains the reference's model families: the MLP and the conv-encoder
pixel models (``models/``, ``ops/augment.py``), the categorical and the
mixture-of-Gaussians critics (``core/mog.py``); the HER recipe with
observation normalization (``envs/her.py``, ``envs/normalizer.py``,
``distributed/actor.py::GoalActorWorker``); and remote actors over the
reference's wire (``core/wire.py``, ``distributed/transport.py``,
``distributed/weight_server.py``, ``actor_main.py``); and data-parallel
learners over the ranks of one ``torch.distributed`` group, one device
per rank, with the replay sharded over them (``parallel/``,
``replay/sharded_per.py``).

Precision: the port runs in float32 by default, like ``D4PGConfig``'s
``compute_dtype``; ``compute_dtype='bfloat16'`` runs the network
products in bfloat16 over float32 parameters. TF32 is switched off for
matmuls and cuDNN so a float32 product on the card keeps float32
precision (the reference's numbers are float32 products; TF32 keeps
about three decimal digits).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when a CUDA device is asked for and none exists."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
