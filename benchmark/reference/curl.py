"""CURL-D4PG in plain PyTorch: the random crop, CURL's unpadded encoder
without tanh, the bilinear InfoNCE loss and the whole grad step.

Srinivas, Laskin and Abbeel 2020, "CURL: Contrastive Unsupervised
Representations for Reinforcement Learning" (arXiv:2004.04136), as its
``curl_sac.py`` computes it, with D4PG's heads (``reference/d4pg.py``,
whose ``Learner`` this one extends, keeping its ``_critic_loss`` and
``_actor_loss``). The grad step, in ``curl_sac.py``'s order:

  - the critic loss on the crops of obs and next_obs, Adam, the actor's
    convolutions made the critic's again;
  - the policy loss through the stepped critic, the actor's own trunk
    over its convolutions with the gradient stopped between them, Adam,
    the tie;
  - the soft updates, ``encoder_tau`` on every ``encoder.`` leaf and
    ``tau`` on the heads, then the target actor's convolutions made the
    target critic's;
  - the contrastive step: the critic's encoder on the anchor (the obs
    crop), the target critic's (the momentum key encoder) on ``pos``, a
    second crop of obs, under ``no_grad``; ``logits = z_a (W z_pos^T)``
    less each row's max, the cross-entropy against ``arange(B)``; one
    gradient, stepped by the encoder's Adam (``encoder_optimizer``) and
    then by the Adam of ``W`` and the encoder (``cpc_optimizer``), each
    from its own moments; the tie.

Its networks are ``p["actor"]``, ``p["critic"]``, ``p["encoder"]`` (the
critic's encoder leaves, the same tensors) and ``p["curl"]`` (``W`` and
those tensors), each with its Adam; actor and critic have targets.

Departures from ``curl_sac.py``: D4PG's categorical critic and
deterministic actor for SAC's (and a target actor, soft-updated like
the critic); the actor and the targets update every step (CURL: every
2); the actor's convolutions are copies of the critic's, made equal
after each step, where CURL aliases them; LayerNorm's epsilon 1e-6
(CURL's 1e-5); the flatten in (h, w, c) order (CURL's (c, h, w)); every
crop offset in [0, H - size] (CURL's numpy draw stops one short).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import d4pg, nets
from reference.learner import Adam

ENCODER = "encoder."


def crop(frames: torch.Tensor, size: int, offsets: torch.Tensor):
    """[B, H, W, C] frames cut to [B, size, size, C] at ``offsets`` [B, 2]
    (top, left)."""
    b = frames.shape[0]
    dev = frames.device
    off = offsets.to(device=dev, dtype=torch.long)
    span = torch.arange(size, device=dev)
    rows = off[:, :1] + span
    cols = off[:, 1:] + span
    return frames[torch.arange(b, device=dev)[:, None, None],
                  rows[:, :, None], cols[:, None, :]]


def encoder_layout(obs_shape, channels, latent: int) -> dict[str, tuple]:
    """``{name: shape}`` of the unpadded encoder over [H, W, C] crops."""
    enc = {}
    h, w, c = obs_shape
    for i, ch in enumerate(channels):
        stride = 2 if i == 0 else 1
        enc[f"encoder.conv{i + 1}.weight"] = (ch, c, 3, 3)
        enc[f"encoder.conv{i + 1}.bias"] = (ch,)
        h, w, c = (h - 3) // stride + 1, (w - 3) // stride + 1, ch
    enc["encoder.proj.weight"] = (latent, h * w * c)
    enc["encoder.proj.bias"] = (latent,)
    enc["encoder.ln.weight"] = (latent,)
    enc["encoder.ln.bias"] = (latent,)
    return enc


def conv_map(p: dict, frames: torch.Tensor, n_layers: int) -> torch.Tensor:
    """[B, H, W, C] uint8 -> [B, h * w * c] maps of the unpadded
    convolutions, flattened in (h, w, c) order. The divisor is a 0-dim
    tensor on the frames' device, as the port's (``nets.encoder``)."""
    x = frames.to(torch.float32) / torch.full((), 255.0, device=frames.device)
    x = x.permute(0, 3, 1, 2)
    for i in range(n_layers):
        x = torch.relu(F.conv2d(x, p[f"encoder.conv{i + 1}.weight"],
                                p[f"encoder.conv{i + 1}.bias"],
                                stride=2 if i == 0 else 1))
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def trunk(p: dict, h: torch.Tensor) -> torch.Tensor:
    """``proj`` and LayerNorm, no tanh (``output_logits=True``)."""
    x = F.linear(h, p["encoder.proj.weight"], p["encoder.proj.bias"])
    return F.layer_norm(x, (x.shape[-1],), p["encoder.ln.weight"],
                        p["encoder.ln.bias"], nets.LN_EPS)


def info_nce(z_a: torch.Tensor, z_pos: torch.Tensor,
             W: torch.Tensor) -> torch.Tensor:
    """The mean over rows of ``-log softmax(logits)[i, i]``."""
    logits = z_a @ (W @ z_pos.T)
    logits = logits - logits.max(dim=1, keepdim=True).values
    log_z = torch.log(torch.exp(logits).sum(dim=1))
    return torch.mean(log_z - torch.diagonal(logits))


class Learner(d4pg.Learner):
    """The family's grad step (see the module docstring); ``cfg`` adds
    ``encoder_channels``, ``encoder_tau`` and ``lr_encoder`` to D4PG's."""

    def __init__(self, cfg: dict, params: dict):
        super().__init__(cfg, params)
        enc = {k: v for k, v in self.p["critic"].items()
               if k.startswith(ENCODER)}
        self.p["encoder"] = {k[len(ENCODER):]: v for k, v in enc.items()}
        self.p["curl"] = {"W": params["curl"]["W"].clone(), **enc}
        b1, b2 = float(cfg["adam_b1"]), float(cfg["adam_b2"])
        for net in ("encoder", "curl"):
            self.opt[net] = Adam(self.p[net], float(cfg["lr_encoder"]), b1,
                                 b2)

    def _convs(self, p: dict, obs: torch.Tensor) -> torch.Tensor:
        return conv_map(p, obs, len(self.cfg["encoder_channels"]))

    def actor(self, p, obs):
        latent = trunk(p, self._convs(p, obs).detach())
        return nets.policy(p, "actor.", latent, len(self.cfg["hidden"]))

    def critic(self, p, obs, action):
        return nets.critic_probs(p, "critic.", trunk(p, self._convs(p, obs)),
                                 action, len(self.cfg["hidden"]))

    def tie(self, params):
        """The actor's convolutions become the critic's; trunks stay."""
        for k in params["critic"]:
            if k.startswith("encoder.conv"):
                params["actor"][k] = params["critic"][k].clone()

    def _curl_loss(self, leaves, r):
        with torch.no_grad():
            key = self.target["critic"]
            z_pos = trunk(key, self._convs(key, r["pos"]))
        z_a = trunk(leaves, self._convs(leaves, r["obs"]))
        return info_nce(z_a, z_pos, leaves["W"]), None

    def step(self, rows: list[dict]) -> dict:
        """One grad step over the rows (obs, next_obs and pos cropped)."""
        g_c, critic_loss, tds = self._mean_grads(self._critic_loss,
                                                 self.p["critic"], rows)
        self.opt["critic"].step(self.p["critic"], g_c)
        self.tie(self.p)
        g_a, actor_loss, _ = self._mean_grads(self._actor_loss,
                                              self.p["actor"], rows)
        self.opt["actor"].step(self.p["actor"], g_a)
        self.tie(self.p)
        with torch.no_grad():
            for net in ("actor", "critic"):
                for k, t in self.target[net].items():
                    tau = float(self.cfg["encoder_tau"] if k.startswith(
                        ENCODER) else self.cfg["tau"])
                    t.mul_(1.0 - tau).add_(self.p[net][k], alpha=tau)
        self.tie(self.target)
        g_k, curl_loss, _ = self._mean_grads(self._curl_loss,
                                             self.p["curl"], rows)
        g_e = {k[len(ENCODER):]: g for k, g in g_k.items() if k != "W"}
        self.opt["encoder"].step(self.p["encoder"], g_e)
        self.opt["curl"].step(self.p["curl"], g_k)
        self.tie(self.p)
        self.grads.append({"actor": g_a, "critic": g_c, "encoder": g_e,
                           "curl": g_k})
        return {"losses": {"critic_loss": float(critic_loss),
                           "actor_loss": float(actor_loss),
                           "curl_loss": float(curl_loss)},
                "td": tds}
