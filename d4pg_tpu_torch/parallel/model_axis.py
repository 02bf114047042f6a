"""The ``model`` axis: the pixel encoder's convolutions split over ranks.

Counterpart of the reference's ``{data, model}`` mesh for the pixel
learner (``D4PG_RULES``: the conv encoder's kernels ``[3, 3, in, out]``
and biases ``[out]`` split over out-channels on ``model``, everything
else replicated), where XLA inserts the collectives. Here they are
written out. Each model rank of a data row holds its out-channel slice
of ``conv1`` .. ``conv4`` in all four networks (and the slices' Adam
moments); each split convolution is column-parallel:

  - its input passes through ``_CopyToModel`` (identity forward, the
    input gradient summed over the model group backward: each rank's
    slice contributes part of it);
  - its ReLU output passes through ``_GatherChannels`` (the slices joined
    along the channel dimension forward, ``RankMesh.model_gather``; this
    rank's slice of the gradient backward), so the next layer reads the
    whole activation.

Everything after the encoder runs replicated on the whole activation, so
the model ranks of a data row compute equal replicated gradients; the
data-parallel average runs over the data group for every parameter
(``data_parallel.grad_reducer``), a split slice and a replicated tensor
alike. Adam on the local slices is the unsplit Adam elementwise.

``shard_state`` turns a whole state into this rank's (placements from
``partition.state_placements``); ``gather_state`` gathers the whole
networks back to the host. Both are collective over the model group.
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.parallel import partition


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        return ctx.mesh.model_sum(grad), None


class _GatherChannels(torch.autograd.Function):
    """The channel slices joined over the model group forward; this
    rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        ctx.channels = y.shape[1]
        return mesh.model_gather(y, dim=1)

    @staticmethod
    def backward(ctx, grad):
        c = ctx.channels
        return grad.narrow(1, ctx.mesh.model_index * c, c).contiguous(), \
            None


class ModelAxis:
    """What a split ``PixelEncoder`` holds: the two region functions of
    its convolutions over ``mesh``'s model group."""

    def __init__(self, mesh):
        self.mesh = mesh

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self.mesh)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherChannels.apply(y, self.mesh)


_MODULES = tuple(attr for _, attr in partition.MODULE_FIELDS)
_OPTIMIZERS = {"actor": "actor_opt", "critic": "critic_opt"}


@torch.no_grad()
def shard_state(state, mesh):
    """In place: ``state`` (whole on every rank) becomes this rank's
    slice of every leaf the rules split over ``model``, its Adam moments
    sliced alike, and each pixel encoder gathers over ``mesh``. A no-op
    at ``model_parallel == 1``. Raises when a split dimension does not
    divide by ``model_parallel``, and for a CURL state."""
    if mesh.model_parallel == 1:
        return state
    if state.curl is not None:
        raise ValueError(
            "--contrastive curl runs on one learner: the model axis "
            "carries neither CURL's W, encoder_opt and curl_opt nor its "
            "contrastive step")
    placements = partition.state_placements(state)
    shard, _ = partition.make_shard_and_gather_fns(placements, mesh)
    for attr in _MODULES:
        module = getattr(state, attr)
        named = dict(module.named_parameters())
        opt = getattr(state, _OPTIMIZERS[attr]) if attr in _OPTIMIZERS \
            else None
        split = [n for n, d in placements[attr].items() if d is not None]
        for n in split:
            p = named[n]
            st = opt.state.get(p) if opt is not None else None
            p.data = shard[attr][n](p.data)
            if st:
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = shard[attr][n](st[key])
        if split:
            module.encoder.model_axis = ModelAxis(mesh)
    return state


@torch.no_grad()
def gather_state(state, mesh) -> dict:
    """``{module attr: {torch name: whole CPU tensor}}`` of the four
    networks (collective over the model group)."""
    placements = partition.state_placements(state)
    _, gather = partition.make_shard_and_gather_fns(placements, mesh)
    return {attr: {n: gather[attr][n](t) for n, t in
                   getattr(state, attr).state_dict().items()}
            for attr in _MODULES}
