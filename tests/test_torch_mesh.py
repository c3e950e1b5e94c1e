"""The port's mesh and partitioning (``core/mesh.py``, ``core/partitioning.py``)
against the JAX package's, without processes: the rank layout of
``rank_layout`` is JAX ``build_mesh``'s device order for
``tests/test_dcn_mesh.py``'s layouts (device i as rank i) and raises where
JAX raises; ``PartitionRules`` give the LTHM parameters (row-sharded table,
MoE stacks) JAX's specs, ``opt_state_specs`` its optimizer state's, and
``shard_slice`` keeps each device's block of JAX's sharded arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.core import mesh as jmesh
from recommendations_tpu.core import partitioning as jpart
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu_torch.core import mesh as tmesh
from recommendations_tpu_torch.core import partitioning as tpart
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

LAYOUTS = {  # tests/test_dcn_mesh.py's, and the plain meshes the other tests use
    "dcn2": dict(data=-1, dcn_data=2),
    "dcn2_model2": dict(data=-1, model=2, dcn_data=2),
    "dcn1": dict(data=-1, dcn_data=1),
    "auto": dict(data=-1),
    "model4": dict(data=-1, model=4),
    "data2_model2_expert2": dict(data=2, model=2, expert=2),
    "data4_dcn2_expert2": dict(data=4, expert=2, dcn_data=2),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_rank_layout_is_jax_device_order(name):
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**LAYOUTS[name]))
    want = np.vectorize(lambda d: d.id)(mesh.devices)
    got = tmesh.rank_layout(tmesh.MeshConfig(**LAYOUTS[name]), 8, per_node=8)
    np.testing.assert_array_equal(got, want)
    assert tmesh.MeshConfig(**LAYOUTS[name]).resolved_shape(8) == jmesh.MeshConfig(**LAYOUTS[name]).resolved_shape(8)


@pytest.mark.parametrize("cfg", [dict(data=-1, dcn_data=3), dict(data=4, dcn_data=8), dict(data=3),
                                 dict(data=-1, model=3)])
def test_rank_layout_raises_where_jax_raises(cfg):
    with pytest.raises(ValueError):
        jmesh.build_mesh(jmesh.MeshConfig(**cfg))
    with pytest.raises(ValueError):
        tmesh.rank_layout(tmesh.MeshConfig(**cfg), 8, per_node=8)


def test_nodes_are_the_granules_when_dcn_is_detected():
    """Two nodes of four ranks: one granule a node, outermost on data, as
    JAX lays two hosts' devices (and the same as dcn_data=2 forced)."""
    auto = tmesh.rank_layout(tmesh.MeshConfig(data=-1, model=2), 8, per_node=4)
    forced = tmesh.rank_layout(tmesh.MeshConfig(data=-1, model=2, dcn_data=2), 8, per_node=8)
    np.testing.assert_array_equal(auto, forced)
    assert all(len({int(r) // 4 for r in row}) == 1 for row in auto.reshape(4, 2))  # model pairs on one node
    flat = tmesh.rank_layout(tmesh.MeshConfig(data=-1, model=2, dcn_data=1), 8, per_node=4)
    np.testing.assert_array_equal(flat, np.arange(8).reshape(4, 2, 1))


def _fake_mesh(shape, rank):
    return tmesh.Mesh(np.arange(int(np.prod(shape))).reshape(shape), rank, {}, torch.device("cpu"))


@pytest.mark.parametrize("rank", range(8))
def test_local_batch_slice_and_shard_slice_are_jax_device_blocks(rank):
    """Each rank's rows of the batch and block of a sharded table are the
    shards JAX puts on the device of the same index."""
    jm = jmesh.build_mesh(jmesh.MeshConfig(data=2, model=2, expert=2))
    tm = _fake_mesh((2, 2, 2), rank)
    x = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    for spec in (("data",), ("model", None), ("expert", None), ("data", "expert")):
        arr = jax.device_put(jnp.asarray(x if len(spec) < 2 or spec[1] is None else x[:, :2]),
                             NamedSharding(jm, jax.sharding.PartitionSpec(*spec)))
        shard = [s for s in arr.addressable_shards if s.device.id == rank][0]
        got = tpart.shard_slice(torch.from_numpy(np.asarray(arr)), spec, tm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
    start, size = tmesh.local_batch_slice(tm, 32)
    assert (start, size) == (tm.index("data") * 16, 16)


def _lthm(shard_rows: bool, moe: bool):
    """The JAX tiny LTHM of ``__graft_entry__`` and the port's of the same
    config."""
    import __graft_entry__ as ge

    jw = ge._tiny_wrapper(shard_rows=shard_rows, moe=moe)
    params = jax.eval_shape(lambda: jw.init_variables(jax.random.PRNGKey(0), ge._tiny_batch()))["params"]
    cfg = LTHMModelConfig.from_dict(jw.config.model_dump())
    return jw, params, LTHMModelWrapper(cfg, device="cpu")


def _flat(tree):
    return {jpart._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


@pytest.mark.parametrize("shard_rows,moe", [(True, True), (False, True), (True, False)])
def test_partition_rules_and_opt_state_specs_match_jax(shard_rows, moe):
    jw, params, tw = _lthm(shard_rows, moe)
    rules = tw.partition_rules()
    jax_specs = _flat(jw.partition_rules().tree_specs(params))
    named = dict(tw.module.named_parameters())
    port = {tpart.jax_path(k, named[k].ndim): v for k, v in rules.tree_specs(named).items()}
    assert set(port) <= set(jax_specs)
    for path, spec in port.items():
        assert spec == tuple(jax_specs[path]), path
    assert any(spec for spec in port.values())
    # the optimizer state: a moment takes its parameter's spec by suffix,
    # trimmed to its rank; counters replicate
    opt_state = jax.eval_shape(jax_build_optimizer(jw, JaxTrainConfig(), params).init, params)
    leaves = {jpart._path_str(p): np.broadcast_to(np.float32(0), v.shape)
              for p, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]}
    want = _flat(jpart.opt_state_specs(opt_state, params, jw.partition_rules()))
    got = tpart.opt_state_specs(leaves, _flat(params), rules)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == tuple(want[path]), path
    if shard_rows:  # the table's moments live with its rows
        assert any(spec and spec[0] == "model" for path, spec in got.items() if path.endswith("embedding"))


@pytest.fixture(scope="module")
def tiny_params():
    """The tiny LTHM's parameter tree (shapes from ``eval_shape``, values
    from a seeded numpy draw)."""
    import __graft_entry__ as ge

    jw = ge._tiny_wrapper(shard_rows=True, moe=True)
    shapes = jax.eval_shape(lambda: jw.init_variables(jax.random.PRNGKey(0), ge._tiny_batch()))["params"]
    rs = np.random.RandomState(0)
    return jw, jax.tree_util.tree_map(lambda s: jnp.asarray(rs.randn(*s.shape).astype(s.dtype)), shapes)


@pytest.mark.parametrize("rank", [3, 6])
def test_shard_params_and_opt_state_keep_jax_device_shards(tiny_params, rank):
    """On the 8-device mesh data 2 x model 2 x expert 2, the tiny LTHM's
    parameters (row-sharded table, MoE stacks) and their AdamW moments:
    each rank's slice is JAX's shard on the device of the same index."""
    jw, params = tiny_params
    jm = jmesh.build_mesh(jmesh.MeshConfig(data=2, model=2, expert=2))
    tm = _fake_mesh((2, 2, 2), rank)
    rules = LTHMModelWrapper(LTHMModelConfig.from_dict(jw.config.model_dump()), device="cpu").partition_rules()

    def device_shards(tree):
        return {jpart._path_str(p): np.asarray([s for s in leaf.addressable_shards if s.device.id == rank][0].data)
                for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    flat = {jpart._path_str(p): torch.from_numpy(np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    want = device_shards(jpart.shard_params(jm, params, jw.partition_rules()))
    # the port keys its rules by state-dict key: feed it JAX's paths as keys
    got = {p: tpart.shard_slice(v, rules.spec_for(p), tm) for p, v in flat.items()}
    assert any(got[p].shape != flat[p].shape for p in got)
    for p, v in want.items():
        np.testing.assert_array_equal(got[p].numpy(), v, err_msg=p)
    opt_state = jax_build_optimizer(jw, JaxTrainConfig(), params).init(params)
    leaves = {jpart._path_str(p): torch.from_numpy(np.asarray(v))
              for p, v in jax.tree_util.tree_flatten_with_path(opt_state)[0]}
    want = device_shards(jpart.shard_opt_state(jm, opt_state, params, jw.partition_rules()))
    got = tpart.shard_opt_state(tm, leaves, flat, rules)
    for p, v in want.items():
        np.testing.assert_array_equal(got[p].numpy(), v, err_msg=p)
