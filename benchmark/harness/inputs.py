"""The inputs of a run, made from ``--seed`` on the device.

Every draw comes from a ``torch.Generator`` on the card seeded from
``(seed, tag, ...)``, so the same seed gives the same inputs, and a
block of ring rows can be made again alone (the reference gathers the
rows it needs that way, after the program's state is freed).

  - Initial weights: one normal draw for all leaves of the family's
    networks (``layout``), cut and scaled per leaf (``init_scale``); the
    targets start as copies, and the leaves the networks share are made
    equal (``tie``).
  - Ring rows: the family's observations (``observations``), actions
    U(-1, 1), n-step rewards uniform over the traffic's ``reward`` range,
    episode ends with probability ``done_share``, and discounts
    ``gamma ** n_step * (1 - done)``.
  - The loop's and the state's generators, whose draws (PER uniforms or
    uniform slots; the family's own ``draws``) the reference replays.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from harness import spec

FIELDS = ("obs", "action", "reward", "next_obs", "done", "discount")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run's ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32 & 0xFFFFFFFF]
    for t in tags:
        words.append(t if isinstance(t, int) else zlib.crc32(t.encode()))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) | (int(state[1]) & 0x7FFFFFFF) << 32


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def make_params(cfg: dict, seed: int, device) -> dict:
    """``{net: {name: tensor}}`` of the family's networks."""
    family = spec.family(cfg)
    shapes = family.layout(cfg)
    total = sum(math.prod(s) for net in shapes.values() for s in net.values())
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device)
    out, off = {}, 0
    for net, leaves in shapes.items():
        out[net] = {}
        for name, shape in leaves.items():
            n = math.prod(shape)
            kind, std = family.init_scale(name, shape, cfg, net)
            if kind == "normal":
                out[net][name] = (flat[off:off + n] * std).view(shape).clone()
            else:
                out[net][name] = torch.full(shape, 1.0 if kind == "one"
                                            else 0.0, device=device)
            off += n
    family.tie(out, cfg)
    return out


def rows_block(cfg: dict, traffic: dict, seed: int, rank: int, block: int,
               n: int, device) -> dict:
    """Ring rows ``[block * fill_block, block * fill_block + n)`` of rank
    ``rank`` as device tensors."""
    g = generator(device, seed, "rows", rank, block)
    family = spec.family(cfg)

    def obs():
        return family.observations(cfg, n, g, device)

    lo, hi = traffic["reward"]
    o = obs()
    action = torch.rand(n, int(cfg["act_dim"]), generator=g,
                        device=device) * 2 - 1
    reward = lo + (hi - lo) * torch.rand(n, generator=g, device=device)
    nxt = obs()
    done = (torch.rand(n, generator=g, device=device)
            < float(traffic["done_share"])).to(torch.float32)
    discount = (float(cfg["gamma"]) ** int(cfg["n_step"])) * (1.0 - done)
    return {"obs": o, "action": action, "reward": reward, "next_obs": nxt,
            "done": done, "discount": discount}


def ring_blocks(traffic: dict):
    """``(block, rows)`` of the fill, in ring order."""
    fill, step = int(traffic["fill_rows"]), int(traffic["fill_block"])
    for b, start in enumerate(range(0, fill, step)):
        yield b, min(step, fill - start)


def rows_at(cfg: dict, traffic: dict, seed: int, rank: int,
            slots: torch.Tensor, device) -> dict:
    """Rank ``rank``'s ring rows at ``slots`` (ring slot i holds the
    i-th row of the fill), made again block by block."""
    step = int(traffic["fill_block"])
    slots = slots.to(device=device, dtype=torch.int64)
    out = None
    for b, n in ring_blocks(traffic):
        inside = (slots >= b * step) & (slots < b * step + n)
        if not bool(inside.any()):
            continue
        rows = rows_block(cfg, traffic, seed, rank, b, n, device)
        if out is None:
            out = {k: torch.empty((slots.shape[0], *v.shape[1:]),
                                  dtype=v.dtype, device=device)
                   for k, v in rows.items()}
        where = inside.nonzero().squeeze(1)
        local = slots[where] - b * step
        for k, v in rows.items():
            out[k][where] = v[local]
    return out
