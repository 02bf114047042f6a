"""The program under test, set up as ``python -m d4pg_tpu_torch.train``
sets it up, with the benchmark's inputs.

``learner`` builds the state (``init_state``, with the configuration's
family's ``program_config``), loads the benchmark's initial weights into
the family's networks, fills the replay ring through the program's own
``add`` / ``drain`` (``FusedDeviceReplay``, or this rank's
``ShardedFusedReplay`` on a mesh), and makes the ``FusedLoop`` whose
``run`` every check step, warm-up chunk and timed chunk goes through.
``check_steps`` runs the first grad steps and reads back what they left,
to compare with the reference; the reference never sees the program's
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from harness import inputs, spec


@dataclasses.dataclass
class Learner:
    state: object
    buffer: object
    loop: object
    params0: dict  # the initial weights the benchmark made
    family: object  # families/<family>.py
    fill_s: float = 0.0

    @property
    def nets(self) -> dict:
        """``{net: (online, target or None, optimizer)}``."""
        return self.family.program_nets(self.state)


@torch.no_grad()
def load_params(nets: dict, params: dict) -> None:
    """The benchmark's initial weights into the online nets and targets
    (``nets``: ``{net: (online, target or None, optimizer)}``); the names
    and shapes must match exactly, and every network gets its weights."""
    if set(nets) != set(params):
        raise ValueError(f"the program's networks {sorted(nets)} are not "
                         f"the weights' {sorted(params)}")
    for net, (online, target, _) in nets.items():
        for module in (online, target):
            if module is not None:
                module.load_state_dict(params[net], strict=True)


def fill(buffer, cfg: dict, traffic: dict, seed: int, rank: int,
         device) -> None:
    """The ring, block by block, through ``add`` and ``drain``: each block
    made on the device and handed over as host rows, as actors hand
    them."""
    from d4pg_tpu_torch.replay.uniform import TransitionBatch

    for b, n in inputs.ring_blocks(traffic):
        rows = inputs.rows_block(cfg, traffic, seed, rank, b, n, device)
        buffer.add(TransitionBatch(*[rows[f].cpu().numpy()
                                     for f in inputs.FIELDS]))
        buffer.drain()


def learner(cfg: dict, traffic: dict, seed: int, device,
            mesh=None) -> Learner:
    import time

    from d4pg_tpu_torch.learner.loop import FusedLoop
    from d4pg_tpu_torch.learner.state import init_state

    family = spec.family(cfg)
    dc = family.program_config(cfg)
    state = init_state(dc, seed=inputs.derive(seed, "init") & 0x7FFFFFFF,
                       device=device)
    params0 = inputs.make_params(cfg, seed, device)
    load_params(family.program_nets(state), params0)
    state.generator = inputs.generator(device, seed, "state")
    rank = 0
    per = bool(traffic["prioritized"])
    if mesh is None:
        from d4pg_tpu_torch.replay.fused_buffer import FusedDeviceReplay

        buffer = FusedDeviceReplay(
            int(cfg["memory_size"]), dc.obs_spec, dc.act_dim,
            alpha=float(cfg["per_alpha"]), prioritized=per, device=device)
    else:
        from d4pg_tpu_torch.parallel.data_parallel import replicate_state
        from d4pg_tpu_torch.replay.sharded_per import ShardedFusedReplay

        replicate_state(state, mesh)
        rank = mesh.rank
        buffer = ShardedFusedReplay(
            int(cfg["memory_size"]), dc.obs_spec, dc.act_dim, mesh,
            alpha=float(cfg["per_alpha"]), prioritized=per)
    t0 = time.perf_counter()
    fill(buffer, cfg, traffic, seed, rank, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fill_s = time.perf_counter() - t0
    ranks = int(traffic.get("ranks", 1))
    loop = FusedLoop(
        dc, buffer, k=int(traffic["k"]),
        batch_size=int(traffic["batch_size"]) * ranks,
        generator=inputs.generator(device, seed, "loop", rank),
        prioritized=per, alpha=float(cfg["per_alpha"]),
        beta0=float(cfg["per_beta0"]),
        beta_steps=int(cfg["per_beta_steps"]), mesh=mesh)
    return Learner(state, buffer, loop, params0, family, fill_s)


def leaves(nets: dict) -> dict:
    """``{"<net>/<name>": tensor}`` of the online nets."""
    return {f"{net}/{k}": v for net, (online, _, _) in nets.items()
            for k, v in online.state_dict().items()}


def adam_moments(nets: dict) -> dict:
    """``{"<net>/<name>": (exp_avg, exp_avg_sq)}`` of every network's
    Adam."""
    out = {}
    for net, (online, _, opt) in nets.items():
        for k, p in online.named_parameters():
            st = opt.state.get(p, {})
            out[f"{net}/{k}"] = (st.get("exp_avg"), st.get("exp_avg_sq"))
    return out


def _norm(t) -> float:
    return 0.0 if t is None else float(t.detach().double().norm())


def check_steps(lrn: Learner, cfg: dict, steps: int) -> dict:
    """The first ``steps`` grad steps through ``FusedLoop.run`` (one step,
    then the rest), and what they left: the losses, TD errors and slots
    of every step, the first gradient as Adam got it (its first moment
    after one step over ``1 - b1``), and after the last step the change
    of every leaf, of the targets and Adam's moments, and the trees."""
    state, loop, nets = lrn.state, lrn.loop, lrn.nets
    b1 = float(cfg["adam_b1"])
    first = loop.run(state, 1)
    grad1 = {k: _norm(m) / (1.0 - b1)
             for k, (m, _) in adam_moments(nets).items()}
    rest = loop.run(state, steps - 1)
    out = {"losses": {name: [float(x) for m in (first, rest) for x in m[name]]
                      for name in lrn.family.LOSSES}}
    out["td"] = torch.cat([first["td_error"], rest["td_error"]]).float().cpu()
    out["idx"] = torch.cat([first["idx"], rest["idx"]]).long().cpu()
    out["grad1"] = grad1
    p0 = {f"{net}/{k}": v for net, leaves0 in lrn.params0.items()
          for k, v in leaves0.items()}
    now = leaves(nets)
    targets = {f"{net}/{k}": v for net, (_, target, _) in nets.items()
               if target is not None
               for k, v in target.state_dict().items()}
    out["change3"] = {k: _norm(now[k] - p0[k]) for k in p0}
    out["target3"] = {k: _norm(targets[k] - p0[k]) for k in p0
                      if k in targets}
    out["moments3"] = {}
    for k, (m, v) in adam_moments(nets).items():
        out["moments3"][k + "/m"] = _norm(m)
        out["moments3"][k + "/v"] = _norm(v)
    trees = lrn.buffer.trees
    if trees is not None:
        cap = trees.sum_tree.shape[-1] // 2
        sums = trees.sum_tree.reshape(-1, 2 * cap)
        out["roots"] = [float(x) for x in sums[:, 1]]
        out["leaves"] = [s[cap:].cpu().clone() for s in sums]
    out["params"] = torch.cat([v.detach().reshape(-1).float()
                               for v in now.values()]).cpu()
    return out
