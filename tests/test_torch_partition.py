"""Port vs reference: the partition-rule engine.

The reference's ``tests/test_partition.py`` matching and naming cases,
re-asserted on the port's names: scalar leaves are never partitioned,
the first match wins, an unmatched leaf fails loudly with the resolved
table, the production rules resolve every leaf of a real pixel state
(the port's state names are the reference's, leaf for leaf, and resolve
to the same specs), and the port's engine resolves the reference's
specs for the same tables. Then the placements: every tensor of a pixel
state resolves to the reference's spec translated into the port's
layout (the encoder's conv weights and biases split on their dim 0,
everything else replicated), a spec that splits more than one
dimension is refused, the shard functions cut each
model rank's slice, and a shard then a gather over two gloo ranks gives
back the whole tensor.
"""

import collections

import torch_ranks

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.config import ExperimentConfig as JaxExperimentConfig
from d4pg_tpu.learner.state import init_state as jax_init_state
from d4pg_tpu.parallel import partition as jpartition
from d4pg_tpu_torch.config import ExperimentConfig
from d4pg_tpu_torch.learner.state import init_state
from d4pg_tpu_torch.parallel import RankMesh, partition, spawn_local
from d4pg_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

pytestmark = pytest.mark.torchport

PS = partition.PS


def _tree():
    return {
        "encoder": {
            "conv1": {"kernel": np.ones((3, 3, 4, 8), np.float32),
                      "bias": np.ones((8,), np.float32)},
        },
        "fc1": {"kernel": np.ones((8, 16), np.float32),
                "bias": np.ones((16,), np.float32)},
        "step": np.zeros((), np.int32),
        "scale": np.ones((1,), np.float32),
    }


def _pixel_kw():
    return dict(env="pixel-point", share_encoder=True, frame_stack=3,
                augment="shift", augment_pad=1, encoder_width=8,
                batch_size=16, n_atoms=11, hidden=(16, 16))


# the state's module fields, in the reference's names
_MODULE_FIELDS = (("actor_params", "actor"), ("critic_params", "critic"),
                  ("target_actor_params", "target_actor"),
                  ("target_critic_params", "target_critic"))
_OPT_FIELDS = (("actor_opt_state", "actor_opt", "actor"),
               ("critic_opt_state", "critic_opt", "critic"))


def _wire_params(named: dict) -> dict:
    """A module's ``{torch name: tensor}`` as the Flax variable tree
    ``{"params": ...}`` of the same tensors: ``fc1.weight`` is
    ``params/fc1/kernel`` (a 1-D weight is a LayerNorm ``scale``)."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        if leaf == "weight":
            leaf = "kernel" if t.dim() in (2, 4) else "scale"
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return {"params": tree}


def state_tree(state) -> dict:
    """The port's ``D4PGState`` as the reference's named state tree: the
    four param fields, each Adam state as ``<field>/0/{count, mu, nu}``
    (zeros before the first step, as optax holds them), ``step`` and
    ``key``."""
    tree: dict = {}
    for field, attr in _MODULE_FIELDS:
        tree[field] = _wire_params(getattr(state, attr).state_dict())
    for field, opt_attr, module_attr in _OPT_FIELDS:
        opt = getattr(state, opt_attr)
        named = dict(getattr(state, module_attr).named_parameters())
        mu, nu, count = {}, {}, torch.zeros((), dtype=torch.float32)
        for n, p in named.items():
            st = opt.state.get(p, {})
            mu[n] = st.get("exp_avg", torch.zeros_like(p))
            nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
            count = st.get("step", count)
        tree[field] = {"0": {"count": count, "mu": _wire_params(mu),
                             "nu": _wire_params(nu)}}
    tree["step"] = torch.tensor(int(state.step))
    tree["key"] = state.generator.get_state()
    return tree


def _state_specs(cfg) -> dict:
    return dict(_flat(partition.match_partition_rules(
        partition.D4PG_RULES, state_tree(init_state(cfg, 0, "cpu")))))


def test_scalar_leaves_never_partitioned():
    rules = ((r".*", PS(DATA_AXIS)),)
    specs = partition.match_partition_rules(rules, _tree())
    assert specs["step"] == PS()
    assert specs["scale"] == PS()
    assert specs["fc1"]["kernel"] == PS(DATA_AXIS)


def test_first_match_wins():
    rules = (
        (r"encoder/conv\d+/kernel", PS(None, None, None, MODEL_AXIS)),
        (r"kernel", PS(DATA_AXIS)),
        (r".*", PS()),
    )
    specs = partition.match_partition_rules(rules, _tree())
    assert specs["encoder"]["conv1"]["kernel"] == PS(
        None, None, None, MODEL_AXIS)
    assert specs["fc1"]["kernel"] == PS(DATA_AXIS)
    assert specs["fc1"]["bias"] == PS()


def test_unmatched_key_fails_loudly():
    rules = ((r"kernel", PS()),)
    with pytest.raises(ValueError) as e:
        partition.match_partition_rules(rules, _tree())
    msg = str(e.value)
    assert "bias" in msg
    assert "kernel" in msg


def test_production_rules_are_total_and_name_the_reference_leaves():
    """D4PG_RULES resolve every leaf of the port's pixel state; its names
    are the reference's state's, and every leaf gets the reference's
    spec."""
    cfg = ExperimentConfig(**_pixel_kw()).resolve().learner_config(
        obs_dim=(8, 8, 9), act_dim=2, device="cpu")
    by_name = _state_specs(cfg)
    assert by_name["actor_params/params/encoder/conv1/kernel"] == PS(
        None, None, None, MODEL_AXIS)
    assert by_name["actor_params/params/encoder/conv1/bias"] == PS(
        MODEL_AXIS)
    assert by_name[
        "actor_opt_state/0/mu/params/encoder/conv1/kernel"] == PS(
        None, None, None, MODEL_AXIS)
    assert by_name["critic_params/params/critic/fc1/kernel"] == PS()
    assert by_name["step"] == PS()
    assert by_name["key"] == PS()
    # the reference's state, resolved by its own table: the same spec for
    # every name the two states share (the reference's critic nests its
    # trunk under ``torso``, the port's is flat)
    jcfg = JaxExperimentConfig(**_pixel_kw()).resolve().learner_config(
        obs_dim=(8, 8, 9), act_dim=2)
    jspecs = dict(_flat(jpartition.state_specs(jcfg)))
    shared = set(by_name) & {n.replace("torso/", "") for n in jspecs}
    assert len(shared) > 40
    jspecs = {n.replace("torso/", ""): s for n, s in jspecs.items()}
    for name in shared:
        assert tuple(by_name[name]) == tuple(jspecs[name]), name
    missing = {n for n in jspecs if n not in by_name}
    assert missing == set(), sorted(missing)[:5]


def _flat(tree):
    out = []
    partition.named_tree_map(lambda n, s: out.append((n, s)) or s, tree)
    return out


def _names(tree) -> list[str]:
    return [n for n, _ in _flat(tree)]


def test_named_tree_map_handles_namedtuples_and_none():
    Pair = collections.namedtuple("Pair", ["a", "b"])
    tree = Pair(a={"x": np.ones(3)}, b=(None, [np.zeros(2)]))
    assert _names(tree) == ["a/x", "b/1/0"]
    assert _names(tree) == jpartition.tree_names(tree)


def _spec_dict(tree, prefix="") -> dict:
    """``{name: tuple(spec)}`` of a nested dict of specs (the port's
    ``PS`` and JAX's ``PartitionSpec`` are both tuples)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_spec_dict(v, name))
        else:
            out[name] = tuple(v)
    return out


@pytest.mark.parametrize("rules", [
    ((r".*", PS(DATA_AXIS)),),
    ((r"encoder/conv\d+/kernel", PS(None, None, None, MODEL_AXIS)),
     (r"kernel", PS(DATA_AXIS)), (r".*", PS())),
    partition.D4PG_RULES,
], ids=["all-data", "first-match", "production"])
def test_rules_match_the_reference_engine(rules):
    """The port's engine and the reference's resolve one table over one
    tree to the same spec for every leaf."""
    jrules = tuple((p, jpartition.PS(*s)) for p, s in rules)
    got = _spec_dict(partition.match_partition_rules(rules, _tree()))
    want = _spec_dict(jpartition.match_partition_rules(jrules, _tree()))
    assert got == want


def test_format_rules_lists_the_table():
    """The refusal's table: one ``pattern -> spec`` row per rule, in table
    order."""
    rows = partition.format_rules().splitlines()
    assert len(rows) == len(partition.D4PG_RULES)
    for row, (pattern, s) in zip(rows, partition.D4PG_RULES):
        assert pattern in row and repr(s) in row


def test_mlp_state_resolves_replicated():
    """An MLP state resolves every leaf replicated, which is what
    ``replicate_state`` makes of it; the names cover every tensor of the
    port's state and every name of the reference's."""
    cfg = ExperimentConfig(batch_size=16, n_atoms=11, hidden=(8, 8)
                           ).resolve().learner_config(obs_dim=3, act_dim=2,
                                                      device="cpu")
    specs = _state_specs(cfg)
    assert all(s == PS() for s in specs.values())
    st = init_state(cfg, 0, "cpu")
    n_tensors = sum(len(getattr(st, m).state_dict()) for m in (
        "actor", "critic", "target_actor", "target_critic"))
    n_params = sum(len(list(getattr(st, m).parameters()))
                   for m in ("actor", "critic"))
    # four param fields, mu and nu per parameter, two counts, step, key
    assert len(specs) == n_tensors + 2 * n_params + 2 + 2
    jst = jax_init_state(JaxExperimentConfig(
        batch_size=16, n_atoms=11, hidden=(8, 8)).resolve().learner_config(
        obs_dim=3, act_dim=2), jax.random.key(0))
    assert {n for n in jpartition.tree_names(jst) if "torso" not in n} <= \
        set(specs) | {"key"}


def test_state_placements_split_the_encoder_over_out_channels():
    """Every tensor of a pixel state: the conv weights (OIHW) and biases
    split on dim 0, the rest replicated; each placement is the
    reference's spec for the tensor's wire name, in the port's layout."""
    cfg = ExperimentConfig(**_pixel_kw()).resolve().learner_config(
        obs_dim=(8, 8, 9), act_dim=2, device="cpu")
    state = init_state(cfg, 0, "cpu")
    placements = partition.state_placements(state)
    jcfg = JaxExperimentConfig(**_pixel_kw()).resolve().learner_config(
        obs_dim=(8, 8, 9), act_dim=2)
    jspecs = {n.replace("torso/", ""): s
              for n, s in _flat(jpartition.state_specs(jcfg))}
    n_split = 0
    for field, attr in partition.MODULE_FIELDS:
        named = getattr(state, attr).state_dict()
        assert set(placements[attr]) == set(named)
        for name, t in named.items():
            dim = placements[attr][name]
            split = ".conv" in name and name.startswith("encoder.")
            assert dim == (0 if split else None), (attr, name)
            n_split += split
            spec = jspecs[partition.wire_name(field, name, t.dim())]
            want = [d for d, a in enumerate(spec) if a == MODEL_AXIS]
            assert dim == (partition.torch_dim(want[0], t.dim()) if want
                           else None), (attr, name)
    assert n_split == 4 * 8  # 4 networks x 4 convs x (weight, bias)


def test_torch_dim_maps_the_flax_layouts():
    assert [partition.torch_dim(d, 4) for d in range(4)] == [2, 3, 1, 0]
    assert [partition.torch_dim(d, 2) for d in range(2)] == [1, 0]
    assert partition.torch_dim(0, 1) == 0


@pytest.mark.parametrize("spec, ndim, want", [
    (PS(None, None, None, MODEL_AXIS), 4, 0),  # HWIO out -> OIHW dim 0
    (PS(None, MODEL_AXIS), 2, 0),              # Dense [in, out] -> [out, in]
    (PS(MODEL_AXIS), 1, 0),
    (PS(None, None), 2, None),
    (PS(MODEL_AXIS, None, None, MODEL_AXIS), 4, ValueError),
    (PS(DATA_AXIS, MODEL_AXIS), 2, ValueError),
])
def test_placement_resolves_one_split_dim_or_refuses(spec, ndim, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="not a split of one"):
            partition._placement(spec, ndim)
    else:
        assert partition._placement(spec, ndim) == want


def test_wire_name_is_the_reference_leaf_name():
    assert (partition.wire_name("critic_params", "encoder.conv1.weight", 4)
            == "critic_params/params/encoder/conv1/kernel")
    assert (partition.wire_name("actor_params", "fc1.weight", 2)
            == "actor_params/params/fc1/kernel")
    assert (partition.wire_name("actor_params", "encoder.ln.weight", 1)
            == "actor_params/params/encoder/ln/scale")
    assert (partition.wire_name("target_critic_params", "fc1.bias", 1)
            == "target_critic_params/params/fc1/bias")


def _leaves(rng):
    return {"conv": (rng.standard_normal((8, 3, 3, 3)).astype(np.float32),
                     0),
            "bias": (rng.standard_normal(8).astype(np.float32), 0),
            "fc": (rng.standard_normal((5, 4)).astype(np.float32), None)}


def test_shard_fns_cut_each_model_ranks_slice(rng):
    tree = _leaves(rng)
    placements = {n: d for n, (_, d) in tree.items()}
    locals_ = []
    for r in range(2):
        mesh = RankMesh(world=2, rank=r, device=torch.device("cpu"),
                        model_parallel=2)
        shard, _ = partition.make_shard_and_gather_fns(placements, mesh)
        locals_.append({n: shard[n](a) for n, (a, _) in tree.items()})
    for n, (a, dim) in tree.items():
        if dim is None:
            for loc in locals_:
                np.testing.assert_array_equal(loc[n].numpy(), a)
        else:
            assert locals_[0][n].shape[0] == a.shape[0] // 2
            np.testing.assert_array_equal(
                torch.cat([loc[n] for loc in locals_], dim).numpy(), a)
    odd = RankMesh(world=3, rank=0, device=torch.device("cpu"),
                   model_parallel=3)
    shard, _ = partition.make_shard_and_gather_fns({"bias": 0}, odd)
    with pytest.raises(ValueError, match="do not divide"):
        shard["bias"](np.ones(8, np.float32))


def test_shard_and_gather_round_trip_over_two_ranks(rng):
    tree = _leaves(rng)
    outs = spawn_local(torch_ranks.shard_gather_round_trip, 2,
                       args=(tree,), model_parallel=2)
    for r, out in enumerate(outs):
        assert out["coords"] == (0, r)
        for n, (a, dim) in tree.items():
            np.testing.assert_array_equal(out["whole"][n], a)
            want = a if dim is None else np.split(a, 2, axis=dim)[r]
            np.testing.assert_array_equal(out["local"][n], want)
