"""The port's key stream (``repro_torch.core.prng``) against ``jax.random``,
bitwise: keys, ``split``, ``uniform`` and ``randint`` for several seeds,
shapes and spans; draws for a stack of keys against ``jax.vmap``; chunked
draws against whole ones; and the per-window keys ``run_windows`` and the
fleet hand their schedulers."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.config import REDUCED_SIM
from repro_torch.core import engine, prng
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.state import init_state
from repro_torch.kernels.threefry import ref as threefry_ref
from repro_torch.scenarios import ScenarioSpec, build_knobs
from repro_torch.scenarios import batch as batch_mod
from repro_torch.sched import (TableForm, register_scheduler,
                               unregister_scheduler)

torch.set_num_threads(1)

SEEDS = (0, 7, 2 ** 31 - 1)
SHAPES = ((), (5,), (37, 101), (3, 64, 250))
SPANS = (1, 3, 7, 1024, 12_500, 2 ** 31 - 1)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_the_reference_setting():
    """The port implements the partitionable threefry only; the reference
    runs under this JAX's setting, which must still be that one."""
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is False in this JAX: the reference now "
        "draws with the original threefry split/bits, which "
        "repro_torch.core.prng does not implement")


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    for n in (1, 2, 3, 5, 64):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _np(jax.random.split(jk, n)))
    # a split of a split, and a stack of keys split at once
    jks, tks = jax.random.split(jk, 4), prng.split(tk, 4)
    np.testing.assert_array_equal(
        prng.split(tks, 3).numpy(),
        _np(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed, shape):
    jk = jax.random.split(jax.random.PRNGKey(seed))[1]
    tk = prng.split(prng.key(seed))[1]
    want = np.asarray(jax.random.uniform(jk, shape))
    got = prng.uniform(tk, shape).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0).all() and (got < 1).all()


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, span):
    jk = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
    tk = prng.split(prng.key(seed), 3)[2]
    for shape in SHAPES:
        want = np.asarray(jax.random.randint(jk, shape, 0, span))
        got = prng.randint(tk, 0, span, shape).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(shape))
    # offset bounds and an empty span behave as the reference's
    for lo, hi in ((5, 17), (-40, 3), (9, 9), (9, 2)):
        np.testing.assert_array_equal(
            prng.randint(tk, lo, hi, (64,)).numpy(),
            np.asarray(jax.random.randint(jk, (64,), lo, hi)))


def test_stacked_keys_draw_as_vmap():
    """uniform/randint over a (K, 2) stack of keys = vmap over the keys (the
    GA's population draw, the searches' per-step draws)."""
    jks = jax.random.split(jax.random.PRNGKey(3), 6)
    tks = prng.split(prng.key(3), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9, 13)))(jks))
    got = prng.uniform(tks, (9, 13)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 77))(
        jks))
    np.testing.assert_array_equal(prng.randint(tks, 0, 77).numpy(), want)


def test_chunked_draws_equal_whole_draws(monkeypatch):
    """The CPU path's chunks of the flat index (``kernels/threefry/ref``)
    give the whole draw's bits."""
    tk = prng.split(prng.key(11), 4)
    whole_u = prng.uniform(tk, (3, 50, 41))
    whole_b = prng.bits(tk[0], (7, 300))
    for chunk in (1, 97, 1000):
        monkeypatch.setattr(threefry_ref, "CHUNK", chunk)
        assert torch.equal(prng.uniform(tk, (3, 50, 41)), whole_u), chunk
        assert torch.equal(prng.bits(tk[0], (7, 300)), whole_b), chunk
    jk = jax.random.split(jax.random.PRNGKey(11), 4)
    np.testing.assert_array_equal(
        whole_u.numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3, 50, 41)))(
            jk)))


# --- the keys the engine and the fleet hand their schedulers ---------------

CFG = dataclasses.replace(REDUCED_SIM, max_nodes=8, max_tasks=32,
                          max_events_per_window=16, sched_batch=8)


def _windows(n):
    evs = [[HostEvent(0, EventKind.ADD_NODE, i, a=(1.0, 1.0, 1.0))
            for i in range(4)]] + [[] for _ in range(n - 1)]
    return window_to_torch(stack_windows([pack_window(CFG, e, i)
                                          for i, e in enumerate(evs)]), "cpu")


@pytest.fixture
def key_recorder():
    seen = []

    def propose(state, cfg, rng, idx, valid, base_ok, scores):
        seen.append(rng.clone())
        return scores

    def transform(cfg, ctx, rng, params):
        seen.append(rng.clone())
        return ctx.scores

    register_scheduler("_rec_keys", propose,
                       table_form=TableForm(transform))
    yield seen
    unregister_scheduler("_rec_keys")


@pytest.mark.parametrize("stride", [1, 3])
def test_run_windows_keys_are_the_references(key_recorder, stride):
    """Window j of a batch gets row j of split(PRNGKey(seed), W), whatever
    the stats stride."""
    from repro_torch.sched import get_scheduler
    W, seed = 7, 1234
    cfg = dataclasses.replace(CFG, stats_stride=stride)
    engine.run_windows(init_state(cfg, "cpu"), _windows(W), cfg,
                       get_scheduler("_rec_keys"), seed)
    want = _np(jax.random.split(jax.random.PRNGKey(seed), W))
    np.testing.assert_array_equal(torch.stack(key_recorder).numpy(), want)


def test_fleet_lanes_share_the_window_key(key_recorder):
    """Every lane of a fleet window sees that window's key (both dispatch
    paths: the per-lane proposals and the switchless transform)."""
    W, seed = 4, 99
    specs = [ScenarioSpec(name=f"l{i}", scheduler="_rec_keys")
             for i in range(3)]
    knobs, names = build_knobs(specs)
    want = _np(jax.random.split(jax.random.PRNGKey(seed), W))
    for dispatch in ("switch", "auto"):
        key_recorder.clear()
        cfg = dataclasses.replace(CFG, sched_dispatch=dispatch)
        batch_mod.run_scenarios(batch_mod.init_batched_state(cfg, 3, "cpu"),
                                _windows(W), knobs, cfg, names, seed,
                                lane_scheds=(0, 0, 0))
        got = torch.stack(key_recorder).numpy()
        np.testing.assert_array_equal(got, np.repeat(want, 3, axis=0))


def test_engine_window_keys_helper():
    np.testing.assert_array_equal(
        engine.window_keys(5, 9, "cpu").numpy(),
        _np(jax.random.split(jax.random.PRNGKey(5), 9)))
