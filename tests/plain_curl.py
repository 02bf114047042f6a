"""CURL-D4PG in plain float32 PyTorch, for the port's CPU tests.

Srinivas, Laskin and Abbeel 2020, "CURL: Contrastive Unsupervised
Representations for Reinforcement Learning" (arXiv:2004.04136), as its
``curl_sac.py`` computes it, with D4PG's heads. Written from the paper's
code and independent of the port: networks are functions of dicts of
named tensors (the port's ``state_dict`` names, so one dict describes a
network for both), the crops are loops over rows, the loss is written
out, and Adam is written out. It imports no JAX and nothing of the port.

  - ``random_crop`` / ``center_crop``: ``utils.random_crop`` at given
    offsets and ``center_crop_image``.
  - ``encoder``: ``PixelEncoder`` with ``output_logits=True``: frames
    scaled by 1/255, four unpadded 3x3 convolutions (the first at stride
    2) with ReLU, flattened, ``fc`` and LayerNorm, no tanh.
  - ``info_nce``: ``CURL.compute_logits`` (``z_a (W z_pos^T)`` less each
    row's max) and the cross-entropy against ``arange(B)``.
  - ``Learner.step``: one grad step in ``curl_sac.py``'s order: the
    critic, the actor, the soft updates, the contrastive step.

Departures from ``curl_sac.py``, the same as the port's:

  - D4PG's categorical critic (51 atoms, the action joining after the
    first hidden layer, the projected n-step target, cross-entropy loss)
    and deterministic tanh actor (loss -E[Z(s, pi(s))] through the
    stepped critic) stand in for SAC's twin Q, Gaussian actor and
    temperature; the target actor exists for D4PG and is soft-updated
    like the critic (its trunk at ``encoder_tau``);
  - the actor and the targets update every step (CURL: every 2);
  - the actor's convolutions are copies of the critic's, made equal
    after every Adam step, where CURL aliases them; the actor's Adam
    steps them with zero gradients, which moves nothing;
  - LayerNorm's epsilon is 1e-6 (torch's default, CURL's, is 1e-5) and
    the flatten is (h, w, c) (CURL's is (c, h, w));
  - every crop offset in [0, H - size] can be drawn (CURL's numpy draw
    stops one short).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
LOG_EPS = 1e-10


def random_crop(frames: torch.Tensor, size: int,
                offsets: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] frames cut to [B, size, size, C], row i at
    ``offsets[i]`` (top, left)."""
    out = torch.empty((frames.shape[0], size, size, frames.shape[3]),
                      dtype=frames.dtype)
    for i, (top, left) in enumerate(offsets.tolist()):
        out[i] = frames[i, top:top + size, left:left + size]
    return out


def center_crop(frames: torch.Tensor, size: int) -> torch.Tensor:
    h, w = frames.shape[-3], frames.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return frames[..., top:top + size, left:left + size, :]


def conv_map(p: dict, prefix: str, frames: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] uint8 -> [B, h * w * c] unpadded conv maps."""
    x = frames.to(torch.float32) / 255.0
    x = x.permute(0, 3, 1, 2)
    i = 1
    while f"{prefix}conv{i}.weight" in p:
        x = torch.relu(F.conv2d(x, p[f"{prefix}conv{i}.weight"],
                                p[f"{prefix}conv{i}.bias"],
                                stride=2 if i == 1 else 1))
        i += 1
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def trunk(p: dict, prefix: str, h: torch.Tensor) -> torch.Tensor:
    x = F.linear(h, p[f"{prefix}proj.weight"], p[f"{prefix}proj.bias"])
    return F.layer_norm(x, (x.shape[-1],), p[f"{prefix}ln.weight"],
                        p[f"{prefix}ln.bias"], LN_EPS)


def encoder(p: dict, prefix: str, frames: torch.Tensor) -> torch.Tensor:
    return trunk(p, prefix, conv_map(p, prefix, frames))


def _mlp(p: dict, prefix: str, x: torch.Tensor,
         action: torch.Tensor | None = None) -> torch.Tensor:
    i = 1
    while f"{prefix}fc{i}.weight" in p:
        x = torch.relu(F.linear(x, p[f"{prefix}fc{i}.weight"],
                                p[f"{prefix}fc{i}.bias"]))
        if i == 1 and action is not None:
            x = torch.cat([x, action], dim=-1)
        i += 1
    return x


def policy(p: dict, frames: torch.Tensor) -> torch.Tensor:
    """The actor: its own trunk over its convolutions, the gradient
    stopped between them (``detach=True`` in ``update_actor``)."""
    z = trunk(p, "encoder.", conv_map(p, "encoder.", frames).detach())
    x = _mlp(p, "actor.", z)
    return torch.tanh(F.linear(x, p["actor.out.weight"], p["actor.out.bias"]))


def critic_probs(p: dict, frames: torch.Tensor,
                 action: torch.Tensor) -> torch.Tensor:
    x = _mlp(p, "critic.", encoder(p, "encoder.", frames), action)
    return torch.softmax(F.linear(x, p["critic.head.weight"],
                                  p["critic.head.bias"]), dim=-1)


def projection(probs, reward, discount, v_min, v_max, n_atoms):
    """Each atom of ``r + d z`` (clipped) split between its neighbours."""
    atoms = torch.linspace(v_min, v_max, n_atoms)
    tz = torch.clamp(reward[:, None] + discount[:, None] * atoms, v_min,
                     v_max)
    b = (tz - v_min) / ((v_max - v_min) / (n_atoms - 1))
    w = torch.clamp(1.0 - torch.abs(b[:, :, None] - torch.arange(n_atoms)),
                    0.0, 1.0)
    return torch.einsum("bi,bij->bj", probs, w)


def info_nce(z_a: torch.Tensor, z_pos: torch.Tensor,
             W: torch.Tensor) -> torch.Tensor:
    """The mean over rows of ``-log softmax(logits)[i, i]``."""
    logits = z_a @ (W @ z_pos.T)
    logits = logits - logits.max(dim=1, keepdim=True).values
    log_z = torch.log(torch.exp(logits).sum(dim=1))
    return torch.mean(log_z - torch.diagonal(logits))


class Adam:
    """Bias-corrected Adam (eps 1e-8) over a dict of tensors, stepped in
    place; ``m`` and ``v`` its moments by name."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def _grads(loss, leaves: dict) -> dict:
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), gs)}


def _leaves(p: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}


class Learner:
    """CURL-D4PG from the initial ``actor`` and ``critic`` dicts and
    ``W``. ``cfg`` holds ``v_min``, ``v_max``, ``n_atoms``, ``tau``,
    ``encoder_tau``, ``lr_actor``, ``lr_critic``, ``lr_encoder``,
    ``adam_b1``, ``adam_b2`` and ``crop_size``. Set ``key_online`` to
    take the key through the online encoder, or ``contrastive_adams``
    to the Adams the contrastive step takes (``("encoder", "curl")``):
    the wrong variants the tests show fail."""

    key_online = False
    contrastive_adams = ("encoder", "curl")

    def __init__(self, cfg: dict, actor: dict, critic: dict,
                 W: torch.Tensor):
        self.cfg = cfg
        self.p = {"actor": {k: v.clone() for k, v in actor.items()},
                  "critic": {k: v.clone() for k, v in critic.items()}}
        self.W = {"W": W.clone()}
        self.target = {n: {k: v.clone() for k, v in self.p[n].items()}
                       for n in self.p}
        b1, b2 = cfg["adam_b1"], cfg["adam_b2"]
        self.opt = {n: Adam(self.p[n], cfg[f"lr_{n}"], b1, b2)
                    for n in ("actor", "critic")}
        self.opt["encoder"] = Adam(self._encoder(), cfg["lr_encoder"], b1, b2)
        self.opt["curl"] = Adam(self._curl(), cfg["lr_encoder"], b1, b2)

    def _encoder(self) -> dict:
        """The critic's encoder leaves (the tensors themselves)."""
        return {k: v for k, v in self.p["critic"].items()
                if k.startswith("encoder.")}

    def _curl(self) -> dict:
        return {**self.W, **self._encoder()}

    def _tie(self, nets: dict) -> None:
        for k in nets["actor"]:
            if k.startswith("encoder.conv"):
                nets["actor"][k] = nets["critic"][k].clone()

    def step(self, obs, action, reward, next_obs, discount, offsets):
        """One grad step on uint8 frames; ``offsets`` the obs, next_obs
        and pos crops' [B, 2]. Returns the losses and the TD errors."""
        cfg, size = self.cfg, self.cfg["crop_size"]
        anchor = random_crop(obs, size, offsets[0])
        nxt = random_crop(next_obs, size, offsets[1])
        pos = random_crop(obs, size, offsets[2])
        support = (cfg["v_min"], cfg["v_max"], cfg["n_atoms"])
        atoms = torch.linspace(*support)
        with torch.no_grad():
            na = policy(self.target["actor"], nxt)
            proj = projection(critic_probs(self.target["critic"], nxt, na),
                              reward, discount, *support)
        leaves = _leaves(self.p["critic"])
        td = -torch.sum(proj * torch.log(
            critic_probs(leaves, anchor, action) + LOG_EPS), dim=-1)
        critic_loss = torch.mean(td)
        self.opt["critic"].step(self.p["critic"], _grads(critic_loss, leaves))
        self._tie(self.p)

        leaves = _leaves(self.p["actor"])
        q = critic_probs(self.p["critic"], anchor, policy(leaves, anchor))
        actor_loss = -torch.mean(torch.sum(q * atoms, dim=-1))
        self.opt["actor"].step(self.p["actor"], _grads(actor_loss, leaves))
        self._tie(self.p)

        with torch.no_grad():
            for n in self.p:
                for k, t in self.target[n].items():
                    tau = (cfg["encoder_tau"] if k.startswith("encoder.")
                           else cfg["tau"])
                    t.mul_(1.0 - tau).add_(self.p[n][k], alpha=tau)
        self._tie(self.target)

        leaves = _leaves(self._curl())
        with torch.no_grad():
            key = self.p if self.key_online else self.target
            z_pos = encoder(key["critic"], "encoder.", pos)
        curl_loss = info_nce(encoder(leaves, "encoder.", anchor), z_pos,
                             leaves["W"])
        grads = _grads(curl_loss, leaves)
        if "encoder" in self.contrastive_adams:
            self.opt["encoder"].step(
                self._encoder(), {k: g for k, g in grads.items() if k != "W"})
        if "curl" in self.contrastive_adams:
            self.opt["curl"].step(self._curl(), grads)
        self._tie(self.p)
        return {"critic_loss": critic_loss.item(),
                "actor_loss": actor_loss.item(),
                "curl_loss": curl_loss.item()}, td.detach()
