"""Model FLOPs of one CURL-D4PG grad step: D4PG's heads on CURL's
unpadded encoder over crops, and CURL's contrastive step.

The encoder: each unpadded 3x3 convolution (two FLOPs per multiply-add:
``2 H_out W_out C_out 9 C_in``) and the projection to the latent, over
``crop_size`` crops. The grad step as the model states it runs the
encoder forward seven times (the target actor and the target critic on
s', the critic on s, the actor on s with its convolutions detached, the
stepped critic in the policy loss, the anchor on s and the momentum key
on the positive crop) and backward twice, for the critic loss and for
the contrastive loss: each the weight gradients and every input
gradient but the first convolution's, whose input is the frames, two
forwards' worth less the first convolution's. The policy loss reaches
the actor's own trunk: its projection's weight gradient, one projection
more. The MLP heads take the latent as their state (``mlp_d4pg``), and
the bilinear logits ``z_a (W z_pos^T)`` of B anchors against B keys
cost ``2 L^2 B + 2 B^2 L`` forward and ``2 L^2 B + 4 B^2 L`` backward
(the gradients of ``z_a``, of ``W z_pos^T`` and of ``W``; none of the
key).

The count is the model's, not the program's: with the target
convolutions tied, the program runs one conv map for both target
trunks, and one ``no_grad`` conv map of the stepped convolutions for
the actor's trunk and the critic's: five of the seven forwards.
"""

from __future__ import annotations

from harness import spec


def encoder_flops(crop_shape, channels, latent: int) -> tuple[int, int, int]:
    """(one crop's encoder forward, its first convolution, its
    projection)."""
    h, w, c = crop_shape
    total, first = 0, None
    for i, ch in enumerate(channels):
        s = 2 if i == 0 else 1
        h, w = (h - 3) // s + 1, (w - 3) // s + 1
        f = 2 * h * w * ch * 9 * c
        first = f if first is None else first
        total, c = total + f, ch
    proj = 2 * h * w * c * latent
    return total + proj, first, proj


def logits_flops(batch: int, latent: int) -> int:
    """The bilinear logits' forward and backward."""
    return 4 * latent * latent * batch + 6 * batch * batch * latent


def flops_per_step(cfg: dict, batch: int) -> int:
    latent = int(cfg["latent_dim"])
    size = int(cfg["crop_size"])
    enc, conv1, proj = encoder_flops(
        (size, size, cfg["obs_shape"][-1]), cfg["encoder_channels"], latent)
    mlp = spec.plugin("flops", "mlp_d4pg").mlp_per_sample(
        latent, int(cfg["act_dim"]), cfg["hidden"], int(cfg["n_atoms"]))
    return (batch * (7 * enc + 2 * (2 * enc - conv1) + proj + mlp)
            + logits_flops(batch, latent))
