"""The port's MoE block against the reference's, on the CPU at reduced
qwen2-moe (8 experts top-2, 2 shared experts) and reduced qwen3-moe (no
shared experts): the same numpy inputs and weights go through both
packages. Bars: capacities equal; the router's expert choices and the keep
mask exact, its weights within 1e-6 and its aux loss within rtol 1e-6; the
block's output within 1e-5 of max(1, its largest reference value) at
capacity factors 1.25 (tokens dropped) and 16 (none dropped): at the
reference's init scales (expert weights normal / sqrt(E)) the outputs
reach ~40, where 1e-5 is a few f32 steps; ties and the combine's order
hold bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.moe as ref_moe
import repro_torch.configs as configs
from repro_torch.models import moe

torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
T_DROP = 48          # tokens of the apply tests: C = 16 at factor 1.25


def _cfgs(arch, **over):
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), **over)
    mine = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                               **over)
    assert dataclasses.asdict(ref) == dataclasses.asdict(mine)
    return ref, mine


def _params(cfg, seed=0):
    """Numpy weights for one MoE block at the reference's init scales."""
    r = np.random.default_rng(seed)
    out = {}
    for name, d in sorted(moe.param_defs(cfg).items()):
        scale = d.scale if d.scale is not None else 1 / np.sqrt(d.shape[0])
        out[name] = (r.standard_normal(d.shape) * scale).astype(np.float32)
    return out


def _x(cfg, T, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, T // 2, cfg.d_model)).astype(np.float32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      dtype=np.float32)


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 16.0])
@pytest.mark.parametrize("arch", ARCHS + ["jamba-1.5-large-398b"])
def test_capacity(arch, cf):
    ref_cfg, cfg = _cfgs(arch, capacity_factor=cf)
    for T in (1, 2, 7, 8, 24, 48, 96, 100, 2048, 4097):
        assert moe.capacity(T, cfg) == ref_moe.capacity(T, ref_cfg), T


@pytest.mark.parametrize("arch", ARCHS)
def test_route(arch):
    ref_cfg, cfg = _cfgs(arch)
    p = _params(cfg)
    x = _x(cfg, T_DROP).reshape(T_DROP, -1)
    rw, ri, ra = ref_moe.route(jnp.asarray(x), jnp.asarray(p["router"]),
                               ref_cfg)
    w, i, a = moe.route(torch.from_numpy(x), torch.from_numpy(p["router"]),
                        cfg)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert np.abs(w.numpy() - np.asarray(rw)).max() <= 1e-6
    np.testing.assert_allclose(float(a), float(ra), rtol=1e-6)


def test_route_ties_take_the_lower_expert():
    """A router whose columns 1, 3, 5 and 6 are equal: every token's
    probabilities tie there, and both packages pick the lower ids first."""
    ref_cfg, cfg = _cfgs("qwen3-moe-235b-a22b", moe_top_k=3)
    r = np.random.default_rng(4)
    router = r.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32) * 0.02
    router[:, [3, 5, 6]] = router[:, [1]]
    router[:, 1] += 1.0                     # the tied four lead every row
    router[:, [3, 5, 6]] = router[:, [1]]
    x = np.abs(r.standard_normal((16, cfg.d_model))).astype(np.float32)
    _, ri, _ = ref_moe.route(jnp.asarray(x), jnp.asarray(router), ref_cfg)
    _, i, _ = moe.route(torch.from_numpy(x), torch.from_numpy(router), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert (i.numpy() == [1, 3, 5]).all()


def _ref_keep(ref_cfg, x2d, router):
    """The reference's keep mask in its sorted-slot order (the lines of
    ``_apply_gspmd`` that compute it, on its own route)."""
    _, expert_idx, _ = ref_moe.route(x2d, router, ref_cfg)
    T, K, E = x2d.shape[0], ref_cfg.moe_top_k, ref_cfg.n_experts
    flat_e = expert_idx.reshape(-1)
    sorted_e = flat_e[jnp.argsort(flat_e, stable=True)]
    counts = jnp.zeros((E,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(T * K, dtype=jnp.int32) - starts[sorted_e]
    return np.asarray(pos < ref_moe.capacity(T, ref_cfg))


@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply(arch, cf):
    ref_cfg, cfg = _cfgs(arch, capacity_factor=cf)
    p = _params(cfg, seed=5)
    x = _x(cfg, T_DROP, seed=6)
    want, want_aux = ref_moe.apply({k: jnp.asarray(v) for k, v in p.items()},
                                   ref_cfg, jnp.asarray(x))
    got, aux = moe.apply({k: torch.from_numpy(v) for k, v in p.items()},
                         cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    err = np.abs(_np(got) - _np(want)).max()
    assert err <= 1e-5 * max(1.0, np.abs(_np(want)).max()), err
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    keep = _ref_keep(ref_cfg, jnp.asarray(x.reshape(T_DROP, -1)),
                     jnp.asarray(p["router"]))
    assert keep.all() == (cf == 16.0)      # 1.25 drops tokens, 16 none


@pytest.mark.parametrize("cf", [1.25, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_keep_mask(arch, cf):
    ref_cfg, cfg = _cfgs(arch, capacity_factor=cf)
    p = _params(cfg, seed=5)
    x2d = _x(cfg, T_DROP, seed=6).reshape(T_DROP, -1)
    want = _ref_keep(ref_cfg, jnp.asarray(x2d), jnp.asarray(p["router"]))
    _, idx, _ = moe.route(torch.from_numpy(x2d),
                          torch.from_numpy(p["router"]), cfg)
    _, slot, keep = moe.dispatch(idx, T_DROP, cfg)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert want.all() == (cf == 16.0)
    E, C = cfg.n_experts, moe.capacity(T_DROP, cfg)
    assert bool((slot[~keep] == E * C).all())
    kept = slot[keep]
    assert kept.unique().numel() == kept.numel() and bool((kept < E * C).all())


def test_combine_order_is_the_same_for_permuted_tokens():
    """Each token's k contributions are summed in ascending expert id from
    0.0, wherever the token sits: duplicated tokens give bitwise equal
    rows, and a permutation of the tokens permutes the rows bitwise."""
    _, cfg = _cfgs("qwen3-moe-235b-a22b", capacity_factor=16.0)
    p = {k: torch.from_numpy(v) for k, v in _params(cfg, seed=7).items()}
    r = np.random.default_rng(8)
    base = r.standard_normal((12, cfg.d_model)).astype(np.float32)
    x = base[r.integers(0, 12, 48)]                  # many equal tokens
    y, _ = moe.apply(p, cfg, torch.from_numpy(x)[None])
    perm = r.permutation(48)
    yp, _ = moe.apply(p, cfg, torch.from_numpy(x[perm])[None])
    assert torch.equal(yp[0], y[0][perm])
    for i in range(48):
        for j in range(i):
            if np.array_equal(x[i], x[j]):
                assert torch.equal(y[0, i], y[0, j])
