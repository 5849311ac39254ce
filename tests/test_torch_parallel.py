"""The port's sharding rule engine against the JAX package's, in one
process.

- The rule machinery (`validate_rules`, `match_partition_rules`,
  `explain_sharding`): the same rule tables over the same trees give the
  same specs, the same scalar exemption and the same errors.
- `resolve_mesh_shape`: equal to JAX's for every preset, 1-8 devices and
  batch 1-8.
- On the default model at data 2 and 4, fsdp shards a parameter in the port
  exactly where JAX's `ShardingEngine.state_specs` shards its counterpart
  (names mapped through the weight bridge), and dp shards nothing.
- `explain` and `train --explain_sharding` list every parameter; the
  spatial presets, a spatial axis and a mesh that leaves ranks out are
  refused.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from raft_stereo_tpu.config import RAFTStereoConfig as JaxConfig
from raft_stereo_tpu.models import RAFTStereo as JaxRAFTStereo
from raft_stereo_tpu.parallel import sharding as jax_sharding
from raft_stereo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.init import build_model
from raft_stereo_tpu_torch.parallel import (
    DATA_AXIS,
    PRESETS,
    SPATIAL_AXIS,
    P,
    ShardingEngine,
    explain_sharding,
    make_mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
    resolve_mesh_shape,
    sharding,
)
from raft_stereo_tpu_torch.parallel.mesh import Mesh
from raft_stereo_tpu_torch.utils.checkpoints import _flax_key
from torch_parity import torch_single_thread  # noqa: F401 (autouse fixture)

# One rule table in both packages' spec types.
RULES = [
    (r"kernel$", (None, None, None, "data")),
    (r"^head/", ("data",)),
    (r".*", ()),
]


def port_rules(rules):
    return [(pattern, P(*spec)) for pattern, spec in rules]


def jax_rules(rules):
    return [(pattern, JP(*spec)) for pattern, spec in rules]


def tree():
    rng = np.random.default_rng(0)
    return {
        "enc": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8)), "bias": np.zeros(8)},
                "norm": {"scale": np.ones(8)}},
        "head": {"w": np.zeros((6, 2)), "one": np.zeros((1, 1)), "step": np.float32(3.0)},
        "list": [np.zeros((2, 2, 2, 4)), {"kernel": np.zeros((1, 1, 2, 6))}],
    }


def _leaf_specs(spec_tree, prefix=()):
    if isinstance(spec_tree, dict):
        out = {}
        for k, v in spec_tree.items():
            out.update(_leaf_specs(v, (*prefix, k)))
        return out
    if isinstance(spec_tree, list):
        out = {}
        for i, v in enumerate(spec_tree):
            out.update(_leaf_specs(v, (*prefix, str(i))))
        return out
    return {prefix: tuple(spec_tree)}


def test_rule_matching_matches_jax():
    """First match wins, scalars (0-d and one-element) are never
    partitioned, lists are walked by index: the port's spec tree equals
    JAX's leaf for leaf, and so does every explain line."""
    got = match_partition_rules(sharding.validate_rules(port_rules(RULES)), tree())
    want = jax_sharding.match_partition_rules(jax_sharding.validate_rules(jax_rules(RULES)), tree())
    assert _leaf_specs(got) == _leaf_specs(want)
    assert _leaf_specs(got)[("head", "one")] == () and _leaf_specs(got)[("head", "w")] == ("data",)
    ours = explain_sharding(port_rules(RULES), tree(), label="t").splitlines()
    theirs = jax_sharding.explain_sharding(jax_rules(RULES), tree(), label="t").splitlines()
    assert ours[0] == theirs[0] and len(ours) == len(theirs) == 9

    def decisions(lines):  # name -> (shape, rule, spec); JAX walks sorted keys, the port in order
        return {line.split()[0]: (line.split("->")[0].split()[1:], re.sub(r"PartitionSpec|P", "",
                                                                      line.split("->")[1]).strip())
                for line in lines[1:]}

    assert decisions(ours) == decisions(theirs)


@pytest.mark.parametrize("bad,match", [
    ([], "empty sharding rule table"),
    ([(r"kernel$", ())], "catch-all"),
    ([(r"(", ()), (r".*", ())], r"missing \)"),
    ([(r"kernel$", "data"), (r".*", ())], "spec must be"),
], ids=["empty", "no-catch-all", "bad-regex", "not-a-spec"])
def test_validate_rules_errors_match_jax(bad, match):
    with pytest.raises(Exception, match=match) as ours:
        sharding.validate_rules([(p, s if isinstance(s, str) else P(*s)) for p, s in bad])
    with pytest.raises(Exception) as theirs:
        jax_sharding.validate_rules([(p, s if isinstance(s, str) else JP(*s)) for p, s in bad])
    assert type(ours.value) is type(theirs.value)


def test_unmatched_leaf_and_rank_errors_match_jax():
    for rules, match in (([(r"^nothing$", ())], "no sharding rule matched leaf"),
                         ([(r"bias$", (None, "data")), (r".*", ())], "has rank 2 but leaf")):
        with pytest.raises(ValueError, match=match):
            match_partition_rules(port_rules(rules), tree())
        with pytest.raises(ValueError, match=match):
            jax_sharding.match_partition_rules(jax_rules(rules), tree())


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_resolve_mesh_shape_matches_jax(preset):
    assert set(PRESETS) == set(jax_sharding.PRESETS)
    for n in (1, 2, 4, 8):
        for batch in (1, 2, 3, 4, 6, 8):
            assert resolve_mesh_shape(preset, n, batch) == jax_sharding.resolve_mesh_shape(preset, n, batch)
    with pytest.raises(ValueError, match="unknown sharding preset"):
        resolve_mesh_shape("tp", 2, 2)


@pytest.fixture(scope="module")
def models():
    cfg = JaxConfig()
    img = jax.ShapeDtypeStruct((1, 64, 96, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: JaxRAFTStereo(cfg).init(jax.random.PRNGKey(0), a, b, iters=1), img, img)
    return build_model(RAFTStereoConfig(), seed=0, device="cpu"), shapes["params"]


@pytest.mark.parametrize("data,spatial", [(2, 1), (4, 1), (2, 2), (4, 2)], ids=["2", "4", "2x2", "4x2"])
def test_fsdp_shards_where_jax_does(models, data, spatial):
    """The default model: each parameter is sharded by the port's fsdp
    exactly where JAX's fsdp shards its flax counterpart on a (data,
    spatial) mesh (the 126-channel motion conv demoted at data 4, the
    C_out=1 flow head at both; the spatial axis shards no parameter), and
    always over the output channels."""
    model, jax_params = models
    want = _leaf_specs(jax_sharding.ShardingEngine(jax_make_mesh((data, spatial)), "fsdp").state_specs(jax_params))
    got = ShardingEngine(Mesh(data, spatial), "fsdp").param_specs(model)
    assert len(got) == len(want) == len(list(model.parameters()))
    flips = 0
    for name, spec in got.items():
        (_, *path), is_kernel = _flax_key(model, name)
        jax_sharded = any(a is not None for a in want[tuple(path)])
        assert (sharding._sharded_dim(spec) is not None) == jax_sharded, name
        if jax_sharded:
            assert is_kernel and sharding._sharded_dim(spec) == 0, name
            flips += 1
    demoted = {n for n, p in model.named_parameters() if p.dim() == 4 and sharding._sharded_dim(got[n]) is None}
    assert "update_block.flow_head.conv2.weight" in demoted
    assert ("update_block.encoder.conv.weight" in demoted) == (data == 4)
    assert flips == sum(1 for p in model.parameters() if p.dim() == 4) - len(demoted)
    dp = ShardingEngine(Mesh(data, spatial), "dp").param_specs(model)
    assert all(s == P() for s in dp.values())


def test_explain_lists_every_parameter(models):
    model, _ = models
    text = ShardingEngine(Mesh(4, 1), "fsdp").explain(model)
    assert text.startswith("sharding preset: fsdp") and "mesh: 4x1 (data x spatial)" in text
    for name, _ in model.named_parameters():
        assert re.search(rf"^{re.escape(name)} ", text, re.M), name
    assert "# 2 parameter(s) replicated because their dim does not divide the data axis (4)" in text


def test_shard_and_gather_fns_round_trip():
    """The chunk along the sharded dim (FSDP2's layout) and back; a whole
    spec passes through."""
    specs = {"w": P(DATA_AXIS, None), "b": P()}
    shard, gather = make_shard_and_gather_fns(Mesh(1, 1), specs)
    x = np.arange(12.0).reshape(4, 3)
    import torch

    t = torch.from_numpy(x)
    assert torch.equal(gather["w"](shard["w"](t)), t) and torch.equal(shard["b"](t), t)


@pytest.mark.parametrize("rules,mesh", [("spatial", (1, 2)), ("dp+spatial", (2, 2)), ("dp", (1, 2)), ("fsdp", (2, 2))],
                         ids=["spatial", "dp+spatial", "spatial-axis", "fsdp"])
def test_spatial_presets_and_axes_are_refused(rules, mesh):
    """A spatial axis above 1 is not refused: under every preset it runs
    row bands, as JAX's batch rules shard rows over `spatial` under every
    preset, with parameters whole, gradients summed over the ranks and the
    loss unscaled, or under fsdp its conv weights sharded over the data
    axis and the loss scaled by it (FSDP2 averages over the data group);
    `--explain_sharding` prints the band layout. tests/test_torch_spatial.py,
    tests/test_torch_spatial_quad.py and tests/test_torch_fsdp_spatial.py
    run them over gloo ranks."""
    engine = ShardingEngine(Mesh(*mesh), rules)
    fsdp = rules == "fsdp"
    assert engine.banded and engine.loss_scale == (mesh[0] if fsdp else 1)
    model = build_model(RAFTStereoConfig(hidden_dims=(16, 16, 16)), device="cpu")
    whole = len(engine.replicated_params(model))
    assert whole < len(list(model.parameters())) if fsdp else whole == len(list(model.parameters()))
    text = engine.explain()
    assert f"mesh: {mesh[0]}x{mesh[1]}" in text and "row bands: rank k of the 2 in a spatial group" in text
    assert ("gradients reduce-scattered over data, then summed over spatial" in text) == fsdp
    assert ("gradients summed over all ranks" in text) != fsdp


def test_mesh_must_cover_the_world():
    assert make_mesh((-1, 1), world_size=4).shape == {DATA_AXIS: 4, SPATIAL_AXIS: 1}
    assert make_mesh((-1, 1)).shape == {DATA_AXIS: 1, SPATIAL_AXIS: 1}  # one process
    with pytest.raises(ValueError, match="use --mesh_shape 4 1"):
        make_mesh((2, 1), world_size=4)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh((-1, 3), world_size=4)


def test_train_explain_sharding_is_a_dry_run(tmp_path, monkeypatch, capsys):
    """`train --explain_sharding` prints every parameter's decision and
    exits 0 without touching a dataset, a checkpoint or the run directory."""
    monkeypatch.chdir(tmp_path)
    argv = ["train", "--device", "cpu", "--explain_sharding", "--sharding_rules", "fsdp", "--hidden_dims", "16",
            "16", "16"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    model = build_model(RAFTStereoConfig(hidden_dims=(16, 16, 16)), device="cpu")
    assert out.startswith("sharding preset: fsdp") and "mesh: 1x1" in out
    assert all(f"\n{name} " in out for name, _ in model.named_parameters())
    assert not any(tmp_path.iterdir())
