"""Model FLOPs of one D4PG grad step with the DrQ pixel encoder shared by
actor and critic.

The encoder: each 3x3 convolution at XLA's ``SAME`` output size (two
FLOPs per multiply-add: ``2 H_out W_out C_out 9 C_in``) and the
projection to the latent. The grad step as the model states it runs the
encoder forward five times (the target actor and the target critic on
s', the critic on s, the actor on s with its output detached, the
stepped critic in the policy loss) and backward once, for the critic
loss: the weight gradients and every input gradient but the first
convolution's, whose input is the frames, two forwards' worth less the
first convolution's. The policy loss's gradient stops at the latent. The
MLP heads take the latent as their state (``mlp_d4pg``).

The count is the model's, not the program's: with the encoder shared
and the targets tied, the program reuses one latent for both target
heads and one for the policy loss, and runs three of the five forwards.
"""

from __future__ import annotations

from harness import spec


def encoder_flops(obs_shape, channels, latent: int) -> tuple[int, int]:
    """(one frame's encoder forward, its first convolution)."""
    h, w, c = obs_shape
    total, first = 0, None
    for i, ch in enumerate(channels):
        s = 2 if i == 0 else 1
        h, w = -(-h // s), -(-w // s)
        f = 2 * h * w * ch * 9 * c
        first = f if first is None else first
        total, c = total + f, ch
    return total + 2 * h * w * c * latent, first


def flops_per_step(cfg: dict, batch: int) -> int:
    enc, conv1 = encoder_flops(cfg["obs_shape"], cfg["encoder_channels"],
                               int(cfg["latent_dim"]))
    mlp = spec.plugin("flops", "mlp_d4pg").mlp_per_sample(
        int(cfg["latent_dim"]), int(cfg["act_dim"]), cfg["hidden"],
        int(cfg["n_atoms"]))
    return batch * (7 * enc - conv1 + mlp)
