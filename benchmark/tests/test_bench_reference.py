"""The benchmark's plain reference against the port's plain path, piece by
piece, at a tiny size on the CPU (the port's kernels run their plain
versions here)."""

from __future__ import annotations

import torch

from bench_tiny import staged, tiny
from harness import inputs, program, spec
from reference import augment, d4pg, per


def test_projection_matches_the_ports():
    from d4pg_tpu_torch.core.distribution import (
        CategoricalSupport,
        categorical_projection,
    )

    cfg = {"v_min": 0.0, "v_max": 800.0, "n_atoms": 51}
    g = torch.Generator().manual_seed(3)
    probs = torch.softmax(torch.randn(64, 51, generator=g), -1)
    r = torch.rand(64, generator=g) * 900 - 50
    d = (torch.rand(64, generator=g) > 0.2).float() * 0.97
    want = categorical_projection(CategoricalSupport(0.0, 800.0, 51), probs,
                                  r, d)
    got = d4pg.projection(cfg, probs, r, d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_sampler_tree_and_weights_match_the_ports():
    from d4pg_tpu_torch.replay import device_per as dper

    cap, size, b = 64, 50, 16
    g = torch.Generator().manual_seed(5)
    trees = dper.init(cap, "cpu")
    trees = dper.insert(trees, torch.arange(size), 0.6)
    mine = per.Trees(cap, size, "cpu")
    for _ in range(3):
        u = torch.rand(b, generator=g)
        got = mine.sample(u)
        want = dper.sample_from_uniforms(trees, u, size)
        assert torch.equal(got, want.long())
        assert float(mine.outside(got, mine.masses(u)).max()) == 0.0
        torch.testing.assert_close(per.is_weights(mine, got, 0.5),
                                   dper.is_weights(trees, want, 0.5, size))
        td = torch.rand(b, generator=g) * 4
        trees = dper.update_from_td(trees, want, td, 0.6)
        mine.write_back(got, td, 0.6)
        assert torch.equal(mine.sum_tree[1:], trees.sum_tree[1:])
        assert torch.equal(mine.min_tree[1:], trees.min_tree[1:])


def test_sharded_weights_match_the_ports():
    from d4pg_tpu_torch.learner.fused import shard_weights
    from d4pg_tpu_torch.parallel.mesh import RankMesh
    from d4pg_tpu_torch.replay import device_per as dper
    from d4pg_tpu_torch.replay.sharded_per import ShardedPerTrees

    cap, b = 32, 8
    g = torch.Generator().manual_seed(7)
    shards = [per.Trees(cap, cap, "cpu") for _ in range(2)]
    theirs = []
    for s in shards:
        slots = torch.randint(0, cap, (b,), generator=g)
        td = torch.rand(b, generator=g) * 3
        s.write_back(slots, td, 0.6)
        t = dper.update_from_td(dper.insert(dper.init(cap, "cpu"),
                                            torch.arange(cap), 0.6),
                                slots, td, 0.6)
        theirs.append(t)
    stacked = ShardedPerTrees(*[torch.stack(x) for x in zip(*theirs)])
    idx = torch.randint(0, cap, (2, b), generator=g)
    want = shard_weights(stacked, idx, 0.7, RankMesh.local("cpu", 2))
    got = torch.stack(per.sharded_is_weights(shards, list(idx), 0.7))
    torch.testing.assert_close(got, want)


def test_drq_shift_matches_the_ports():
    from d4pg_tpu_torch.ops.augment import random_shift

    g = torch.Generator().manual_seed(9)
    frames = torch.randint(0, 256, (6, 12, 12, 3), generator=g,
                           dtype=torch.uint8)
    off = torch.randint(0, 9, (6, 2), generator=g)
    assert torch.equal(augment.shift(frames, 4, off),
                       random_shift(frames, 4, offsets=off))


def test_networks_match_the_ports_with_the_benchmarks_weights():
    from d4pg_tpu_torch.learner.state import init_state

    for cell in (tiny(staged("humanoid-d4pg", "per.b32768")),
                 tiny("cheetah-pixels.per.b512")):
        cfg = cell.config
        family = spec.family(cfg)
        params = inputs.make_params(cfg, 11, torch.device("cpu"))
        state = init_state(family.program_config(cfg), 0, "cpu")
        program.load_params(family.program_nets(state), params)
        ref = family.Learner(cfg, params)
        rows = inputs.rows_block(cfg, cell.traffic, 11, 0, 0, 8,
                                 torch.device("cpu"))
        with torch.no_grad():
            a = state.actor(rows["obs"])
            torch.testing.assert_close(ref.actor(params["actor"],
                                                 rows["obs"]), a)
            q = state.critic(rows["obs"], rows["action"])
            torch.testing.assert_close(
                ref.critic(params["critic"], rows["obs"], rows["action"]),
                q)


def test_rows_made_again_are_the_rows_handed_over():
    cell = tiny(staged("humanoid-d4pg", "per.b32768"))
    dev = torch.device("cpu")
    block = inputs.rows_block(cell.config, cell.traffic, 13, 0, 1, 256, dev)
    step = int(cell.traffic["fill_block"])
    slots = torch.tensor([step + 3, step + 200])
    again = inputs.rows_at(cell.config, cell.traffic, 13, 0, slots, dev)
    for k, v in block.items():
        assert torch.equal(again[k], v[[3, 200]])
