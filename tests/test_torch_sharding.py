"""The port's logical-axis sharding (``distributed/sharding.py``,
``distributed/placement.py``, ``launch/mesh.py``) against the reference's,
without a process group: the rule sets, specs and axes trees must be the
reference's exactly.

``make_rules``, ``resolve_spec`` and ``choose_serve_mode`` only read a
mesh's axis names and sizes, so production-size meshes are duck-typed, as
the reference's own ``tests/test_optim_sharding.py`` fakes a 16x16 mesh;
the same object goes to both packages. The reference's ``make_sharding``
needs a real ``jax.sharding.Mesh``: its sharding trees are compared on
the one-device mesh, and on larger meshes its specs are its
``resolve_spec`` over its axes trees, as its ``tree_shardings`` computes
them.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro import configs as ref_configs
from repro.config import SHAPES as REF_SHAPES
from repro.distributed import placement as ref_placement
from repro.distributed import sharding as ref_sharding
from repro.models import attention as ref_attention
from repro.models import mamba as ref_mamba
from repro.models import model as ref_model
from repro.models import layers as ref_layers
from repro_torch import configs
from repro_torch.config import SHAPES
from repro_torch.distributed import placement, sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, layers, mamba
from repro_torch.models import model as lm

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
MODES = ("train", "prefill", "serve", "serve_seq")


def _fake(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _plain(tree):
    """Axes / spec trees as nested lists and tuples of plain values."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list) or (isinstance(tree, tuple) and tree and
                                  isinstance(tree[0], (dict, list))):
        return [_plain(v) for v in tree]
    if hasattr(tree, "spec"):                       # a NamedSharding
        return _plain(tree.spec)
    if isinstance(tree, tuple) or type(tree).__name__ == "PartitionSpec":
        return tuple(tree)
    return tree


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_make_rules_equal_the_reference(mode, mesh):
    m = _fake(mesh)
    assert sharding.make_rules(m, mode, None) == \
        ref_sharding.make_rules(m, mode, None)
    for arch in configs.ARCH_IDS:
        got = sharding.make_rules(m, mode, configs.get_config(arch))
        want = ref_sharding.make_rules(m, mode, ref_configs.get_config(arch))
        assert got == want, (arch, mode, mesh)
        got = sharding.make_rules(m, mode,
                                  configs.reduced(configs.get_config(arch)))
        want = ref_sharding.make_rules(
            m, mode, ref_configs.reduced(ref_configs.get_config(arch)))
        assert got == want, (arch, mode, mesh, "reduced")


def test_make_rules_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown sharding mode"):
        sharding.make_rules(_fake("2x2"), "decode")


LOGICAL = ("batch", "seq", "embed", "ff", "vocab", "heads", "expert",
           "tokens", "seq_kv", "act_kv", None)
MESH_AXES = ("pod", "data", "model")


@settings(max_examples=200, deadline=None)
@given(axes=st.lists(st.sampled_from(LOGICAL), max_size=6),
       rules=st.dictionaries(
           st.sampled_from(LOGICAL[:-1]),
           st.one_of(st.none(), st.sampled_from(MESH_AXES),
                     st.lists(st.sampled_from(MESH_AXES), min_size=1,
                              max_size=3, unique=True).map(tuple))))
def test_resolve_spec_equals_the_reference_and_uses_an_axis_once(axes,
                                                                 rules):
    got = sharding.resolve_spec(axes, rules)
    assert tuple(got) == tuple(ref_sharding.resolve_spec(axes, rules))
    used = [a for e in got if e is not None
            for a in ((e,) if isinstance(e, str) else e)]
    assert len(used) == len(set(used))
    assert len(got) == len(axes)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_axes_trees_equal_the_reference(arch):
    cfg = configs.get_config(arch)
    ref = ref_configs.get_config(arch)
    assert _plain(lm.param_logical_axes(cfg)) == \
        _plain(ref_model.param_logical_axes(ref))
    assert _plain(lm.cache_logical_axes(cfg)) == \
        _plain(ref_model.cache_logical_axes(ref))
    assert attention.cache_axes(cfg) == ref_attention.cache_axes(ref)
    assert mamba.state_axes(cfg) == ref_mamba.state_axes(ref)
    for mixer, mlp in cfg.layer_pattern():
        for g, defs in lm._block_defs(cfg, mixer, mlp).items():
            want = ref_model._block_defs(ref, mixer, mlp)[g]
            assert layers.axes_from_defs(defs) == \
                ref_layers.axes_from_defs(want)


def _ref_specs(axes_tree, rules):
    return jax.tree.map(lambda ax: tuple(ref_sharding.resolve_spec(ax, rules)),
                        axes_tree, is_leaf=ref_placement._is_axes_leaf)


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("mode", MODES)
def test_placement_specs_equal_the_reference(mode, mesh):
    m = _fake(mesh)
    for arch in configs.ARCH_IDS:
        cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
        rules = sharding.make_rules(m, mode, cfg)
        ref_rules = ref_sharding.make_rules(m, mode, ref)
        psh = placement.param_shardings(cfg, m, rules)
        assert _plain(psh) == _plain(_ref_specs(
            ref_model.param_logical_axes(ref), ref_rules)), arch
        assert _plain(placement.cache_shardings(cfg, m, rules)) == \
            _plain(_ref_specs(ref_model.cache_logical_axes(ref),
                              ref_rules)), arch
        bsh = placement.batch_shardings(cfg, m, rules)
        tok = ("batch", "seq") + (("codebook",) if ref.n_codebooks > 1
                                  else ())
        want = {"tokens": tok, "labels": tok}
        if ref.n_prefix:
            want["vision_embeds"] = ("batch", "seq", "act_embed")
        assert {k: tuple(v.spec) for k, v in bsh.items()} == {
            k: tuple(ref_sharding.resolve_spec(v, ref_rules))
            for k, v in want.items()}, arch
        osh = placement.opt_shardings(psh, m, with_ef=True)
        assert tuple(osh.step.spec) == ()
        assert osh.mu is psh and osh.nu is psh
        assert _plain(osh.ef) == _plain(psh)
        assert placement.opt_shardings(psh, m).ef is None


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_sharding_trees_equal_the_reference_on_one_device(arch):
    """The reference's own sharding trees (on a real one-device mesh)
    against the port's, for every mode."""
    jm = jax.make_mesh((1, 1), ("data", "model"))
    m = _fake("1x1")
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    for mode in MODES:
        rules = sharding.make_rules(m, mode, cfg)
        ref_rules = ref_sharding.make_rules(jm, mode, ref)
        assert rules == ref_rules
        psh = placement.param_shardings(cfg, m, rules)
        rpsh = ref_placement.param_shardings(ref, jm, ref_rules)
        assert _plain(psh) == _plain(rpsh)
        assert _plain(placement.cache_shardings(cfg, m, rules)) == \
            _plain(ref_placement.cache_shardings(ref, jm, ref_rules))
        assert {k: tuple(v.spec) for k, v in
                placement.batch_shardings(cfg, m, rules).items()} == \
            {k: tuple(v.spec) for k, v in
             ref_placement.batch_shardings(ref, jm, ref_rules).items()}
        rosh = ref_placement.opt_shardings(rpsh, jm, with_ef=True)
        osh = placement.opt_shardings(psh, m, with_ef=True)
        assert tuple(osh.step.spec) == tuple(rosh.step.spec)
        assert _plain(osh.ef) == _plain(rosh.ef)


def test_choose_serve_mode_over_the_shapes():
    assert set(SHAPES) == set(REF_SHAPES)
    for name in SHAPES:
        assert configs.get_shape(name) == SHAPES[name]
        assert dataclasses.asdict(configs.get_shape(name)) == \
            dataclasses.asdict(ref_configs.get_shape(name))
        for mesh in MESHES:
            m = _fake(mesh)
            assert placement.choose_serve_mode(SHAPES[name], m) == \
                ref_placement.choose_serve_mode(REF_SHAPES[name], m)


def test_named_sharding_placements_drop_size_one_axes():
    """Placements are over the mesh's axes of size > 1 (in mesh order), a
    split ('pod', 'data') dim Shard on both; read from a duck-typed mesh
    whose DTensor mesh is the mesh itself."""
    from torch.distributed.tensor import Replicate, Shard
    m = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                              devices=np.zeros((2, 2, 2)),
                              mesh_dim_names=("pod", "data", "model"),
                              shape=(2, 2, 2))
    assert sharding.dtensor_mesh(m) is m
    sh = sharding.NamedSharding(m, sharding.P(("pod", "data"), None,
                                              "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    sh = sharding.NamedSharding(m, sharding.P(None, "data"))
    assert sh.placements == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sharding.NamedSharding(m, sharding.P(("data", "pod"))).placements


def test_without_a_mesh_everything_is_a_no_op():
    import torch
    x = torch.ones(3, 4)
    assert sharding.logical_constraint(x, "batch", "embed") is x
    assert not sharding.is_dtensor(sharding.zeros((2, 3), ("batch", None),
                                                  torch.float32, "cpu"))
    y = torch.zeros(2, 6)
    sharding.write_slice(y, 1, 2, torch.ones(2, 3))
    assert y.sum() == 6 and y[:, 2:5].eq(1).all()
    local_map, kw = sharding.import_shard_map()
    from torch.distributed.tensor.experimental import local_map as lm_ref
    assert local_map is lm_ref and kw == {"redistribute_inputs": True}


def test_meshes_must_match_the_world():
    """One process a device: a mesh's axes multiply to the world size; no
    process group is started when they do not."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        mesh_mod.make_host_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="needs 256"):
        mesh_mod.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512"):
        mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    assert not dist.is_initialized()
