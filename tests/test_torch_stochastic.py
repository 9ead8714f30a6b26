"""The stochastic schedulers — random, simulated annealing, tabu search,
genetic — against the reference's, on the same numpy inputs and keys.

* each ``tf_*`` and ``propose_*`` against the reference's jitted form (the
  form its simulator runs): the final preference bitwise; the surrogate's
  energies within rtol 1e-6;
* ``engine.run_windows`` on a grid-aligned event soup (values multiples of
  1/128) with each of the four, and ``Simulation`` over a tracegen trace:
  ``task_state``, ``task_node``, ``node_active``, the counters and the
  placements exact against the reference's;
* a fleet of all seven built-ins plus a storm and an amplified lane through
  both dispatch paths, against a reference fleet of the same B;
* determinism under a fixed key, and the scheduler invariants.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import REDUCED_SIM as REF_REDUCED
from repro.core import engine as ref_engine
from repro.core import tracegen as ref_tracegen
from repro.core.pipeline import Simulation as RefSimulation
from repro.core.state import init_state as ref_init_state
from repro.parsers import GCDParser as RefGCDParser
from repro.parsers import default_start_us as ref_start_us
from repro.scenarios import ScenarioSpec as RefSpec
from repro.scenarios import batch as ref_batch
from repro.scenarios import build_knobs as ref_build_knobs
import repro.sched as ref_sched
from repro_torch.config import REDUCED_SIM
from repro_torch.core import engine, prng, tracegen
from repro_torch.core.events import (EventKind, HostEvent, pack_window,
                                     stack_windows, window_to_torch)
from repro_torch.core.pipeline import Simulation
from repro_torch.core.state import (SimState, init_state, state_to_numpy,
                                    validate_invariants)
from repro_torch.parsers import GCDParser, default_start_us
from repro_torch.scenarios import ScenarioSpec, build_knobs
from repro_torch.scenarios import batch as batch_mod
import repro_torch.sched as sched

torch.set_num_threads(1)

STOCHASTIC = ("random", "simulated_annealing", "tabu_search", "genetic")
BUILTINS = ("greedy", "first_fit", "round_robin") + STOCHASTIC
DECISIONS = ("task_state", "task_node", "node_active", "placements",
             "evictions", "completions", "window")
FORMS = {"random": ((), "tf_random"),
         "simulated_annealing": ((64.0, 0.1), "tf_simulated_annealing"),
         "tabu_search": ((48.0, 8.0), "tf_tabu_search"),
         "genetic": ((8.0, 4.0, 0.15), "tf_genetic")}
PROPOSALS = {"random": "propose_random",
             "simulated_annealing": "propose_simulated_annealing",
             "tabu_search": "propose_tabu_search",
             "genetic": "propose_genetic"}


def _grid(r, lo, hi, shape=None, q=128):
    return (r.integers(lo, hi, shape) / q).astype(np.float32)


def _context(seed, P=24, N=16, R=3):
    """A grid-aligned base-pass context: (numpy fields, ref ctx, port ctx)."""
    r = np.random.default_rng(seed)
    base_ok = r.random((P, N)) < 0.7
    base_ok[3] = False                      # an all-infeasible task row
    scores = np.where(base_ok, _grid(r, -256, 0, (P, N)),
                      -np.inf).astype(np.float32)
    f = dict(idx=np.arange(P, dtype=np.int32), valid=r.random(P) < 0.9,
             base_ok=base_ok, scores=scores, req=_grid(r, 1, 48, (P, R)),
             node_total=_grid(r, 64, 256, (N, R)),
             node_reserved=_grid(r, 0, 64, (N, R)),
             node_active=r.random(N) < 0.9, window=np.int32(3))
    return (f, ref_sched.SchedContext(**{k: jnp.asarray(v)
                                         for k, v in f.items()}),
            sched.SchedContext(**{k: torch.as_tensor(np.asarray(v))
                                  for k, v in f.items()}))


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("name", STOCHASTIC)
def test_table_form_matches_reference(name, seed):
    params, fn = FORMS[name]
    _, rctx, pctx = _context(seed % 1000)
    want = jax.jit(lambda c, k: getattr(ref_sched, fn)(None, c, k, params))(
        rctx, jax.random.PRNGKey(seed))
    got = getattr(sched, fn)(None, pctx, prng.key(seed), params)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", STOCHASTIC)
def test_proposal_matches_reference(name):
    """propose_* over a state's lane, the reference's jitted proposal."""
    f, _, _ = _context(5)
    P, N = f["base_ok"].shape
    ref_cfg = dataclasses.replace(REF_REDUCED, max_nodes=N, sched_batch=P)
    cfg = dataclasses.replace(REDUCED_SIM, max_nodes=N, sched_batch=P)
    r = np.random.default_rng(1)
    st = {k: np.array(v) for k, v in ref_init_state(ref_cfg)._asdict().items()}
    st["node_total"], st["node_reserved"] = f["node_total"], f["node_reserved"]
    st["node_active"] = f["node_active"]
    idx = r.permutation(P).astype(np.int32)
    st["task_req"][idx] = f["req"]
    ref_state = type(ref_init_state(ref_cfg))(
        **{k: jnp.asarray(v) for k, v in st.items()})
    port_state = SimState(**{k: torch.as_tensor(v) for k, v in st.items()})
    rng_seed = 21
    args = (idx, f["valid"], f["base_ok"], f["scores"])
    want = jax.jit(lambda s, k, *a: getattr(ref_sched, PROPOSALS[name])(
        s, ref_cfg, k, *a))(ref_state, jax.random.PRNGKey(rng_seed),
                            *[jnp.asarray(a) for a in args])
    got = getattr(sched, PROPOSALS[name])(
        port_state, cfg, prng.key(rng_seed),
        *[torch.as_tensor(a) for a in args])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_surrogate_energies_within_tolerance():
    """The surrogate's trial reservation bitwise (grid data) and its
    energies within rtol 1e-6, single matrices and a stack of them."""
    _, rctx, pctx = _context(9)
    r_trial, r_energy = ref_sched.metaheuristics._ctx_surrogate(rctx)
    p_trial, p_energy = sched.metaheuristics._ctx_surrogate(pctx)
    r = np.random.default_rng(3)
    prefs = r.random((6,) + tuple(pctx.base_ok.shape)).astype(np.float32)
    e_ref = np.asarray(jax.jit(jax.vmap(r_energy))(jnp.asarray(prefs)))
    e_port = p_energy(torch.as_tensor(prefs)).numpy()
    np.testing.assert_allclose(e_port, e_ref, rtol=1e-6)
    for j in range(2):
        np.testing.assert_array_equal(
            p_trial(torch.as_tensor(prefs[j])).numpy(),
            np.asarray(jax.jit(r_trial)(jnp.asarray(prefs[j]))))
        np.testing.assert_allclose(float(p_energy(torch.as_tensor(prefs[j]))),
                                   e_ref[j], rtol=1e-6)
    # balance_objective on its own, off the grid
    tot = r.uniform(0.5, 2, (40, 3)).astype(np.float32)
    res = r.uniform(0, 1, (40, 3)).astype(np.float32)
    act = r.random(40) < 0.8
    np.testing.assert_allclose(
        float(sched.balance_objective(torch.as_tensor(res),
                                      torch.as_tensor(tot),
                                      torch.as_tensor(act))),
        float(jax.jit(ref_sched.balance_objective)(res, tot, act)),
        rtol=1e-6)


# --- single roundings and the accept test, at cell A's width ----------------

def _round_f32_exact(a, b, c):
    """a * b + c rounded once to f32 (nearest, ties to even), from the
    exact rational value."""
    from fractions import Fraction
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.int32)) & 1))


def test_fma_rounds_once():
    """``_fma`` is the single rounding of a * b + c, as XLA's contracted
    multiply-add is: where the f64 sum lands on an f32 midpoint that the
    exact value is not (above it and below it), and on random inputs."""
    fma = sched.metaheuristics._fma
    lo, hi = 2.0 ** -12 * (1 - 2.0 ** -18), 2.0 ** -12 * (1 + 2.0 ** -18)
    a = np.array([hi, hi, hi, -hi], np.float32)
    b = np.array([lo, lo, hi, lo], np.float32)
    # a*b is 2**-24 (1 - 2**-36) or 2**-24 (1 + 2**-18 ...): the f64 sum
    # of the first two rounds onto the midpoint 1 + 3 * 2**-24 or 1 + 2**-24
    c = np.array([1 + 2.0 ** -23, 1.0, 1.0, 1 + 2.0 ** -22], np.float32)
    want = np.array([_round_f32_exact(*v) for v in zip(a, b, c)])
    got = fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    xla = jax.jit(lambda x, y, z: x * y + z)(a, b, c)
    np.testing.assert_array_equal(_bits(xla), _bits(want))
    twice = (torch.as_tensor(a).double() * torch.as_tensor(b).double()
             + torch.as_tensor(c).double()).float()
    assert not np.array_equal(_bits(twice.numpy()), _bits(want))
    r = np.random.default_rng(0)
    a, b = r.standard_normal((2, 3000)).astype(np.float32)
    c = (r.standard_normal(3000)
         * 10.0 ** r.integers(-8, 3, 3000)).astype(np.float32)
    want = np.array([_round_f32_exact(*v) for v in zip(a, b, c)])
    got = fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_tabu_start_at_cell_a_width():
    """Tabu's starting preference (scores + 0.01 * u, one rounding) at
    cell A's (P, N) = (1,024, 12,500) against the reference's jitted
    ``tf_tabu_search`` with no steps, bitwise; scores off the grid."""
    from repro_torch.configs.agocs_cell_a import CONFIG as CELL_A
    P, N, R = CELL_A.sched_batch, CELL_A.max_nodes, CELL_A.n_resources
    r = np.random.default_rng(12)
    base_ok = r.random((P, N)) < 0.6
    scores = np.where(base_ok, -r.random((P, N), np.float32)
                      * np.float32(3.0), -np.inf).astype(np.float32)
    f = dict(idx=np.arange(P, dtype=np.int32), valid=r.random(P) < 0.9,
             base_ok=base_ok, scores=scores,
             req=r.random((P, R), np.float32),
             node_total=r.uniform(1, 4, (N, R)).astype(np.float32),
             node_reserved=r.random((N, R), np.float32),
             node_active=r.random(N) < 0.95, window=np.int32(3))
    rctx = ref_sched.SchedContext(**{k: jnp.asarray(v) for k, v in f.items()})
    pctx = sched.SchedContext(**{k: torch.as_tensor(np.asarray(v))
                                 for k, v in f.items()})
    want = np.asarray(jax.jit(lambda c, k: ref_sched.tf_tabu_search(
        None, c, k, (0, 8)))(rctx, jax.random.PRNGKey(31)))
    del rctx
    got = sched.tf_tabu_search(None, pctx, prng.key(31), (0, 8)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sa_accept_at_cell_a_width():
    """SA's temperatures bitwise, and its accept decisions on P * N =
    12.8 M draws of (step, e, e_new, u) at the energies' scale, against
    the reference's body (``src/repro/sched/metaheuristics.py``,
    ``tf_simulated_annealing``) jitted. ``exp`` itself differs by an ulp
    for a share of arguments (counted, not required equal); the decisions
    must not."""
    meta = sched.metaheuristics
    n_steps, t0 = 64, 0.1
    n = 1_024 * 12_500
    r = np.random.default_rng(4)
    i = r.integers(0, n_steps, n).astype(np.int32)
    e = (r.random(n) * 1e-2).astype(np.float32)
    e_new = (e + r.standard_normal(n) * 10.0 ** r.uniform(-7, -2, n)
             ).astype(np.float32)
    u = r.random(n).astype(np.float32)

    @jax.jit
    def reference(i, e, e_new, u):
        temp = t0 * (1.0 - i / n_steps) + 1e-6
        x = jnp.exp(-(e_new - e) / temp)
        return temp, x, (e_new < e) | (u < x)

    temp_r, exp_r, acc_r = (np.asarray(v) for v in reference(i, e, e_new, u))
    temps = meta._sa_temps(t0, n_steps, "cpu")
    np.testing.assert_array_equal(
        _bits(temps.numpy()),
        _bits(jax.jit(lambda k: t0 * (1.0 - k / n_steps) + 1e-6)(
            jnp.arange(n_steps, dtype=jnp.int32))))
    temp = temps[torch.as_tensor(i).long()]
    np.testing.assert_array_equal(_bits(temp.numpy()), _bits(temp_r))
    te, tn = torch.as_tensor(e), torch.as_tensor(e_new)
    acc = meta._sa_accept(tn, te, torch.as_tensor(u), temp).numpy()
    n_exp = int((_bits(torch.exp(-(tn - te) / temp).numpy())
                 != _bits(exp_r)).sum())
    assert n_exp < n // 10, n_exp
    np.testing.assert_array_equal(acc, acc_r)


# --- whole runs --------------------------------------------------------------

SHAPE = dict(max_nodes=16, max_tasks=96, max_events_per_window=64,
             sched_batch=24)
CFG = dataclasses.replace(REDUCED_SIM, **SHAPE)
REF_CFG = dataclasses.replace(REF_REDUCED, **SHAPE)


def _soup(seed, cfg=CFG, n_windows=8, n_nodes=10, n_slots=64):
    """Grid-aligned nodes, task arrivals, removals and node churn."""
    r = np.random.default_rng(seed)
    windows = [[HostEvent(0, EventKind.ADD_NODE, m,
                          a=tuple(float(x) for x in _grid(r, 64, 256, 3)))
                for m in range(n_nodes)]]
    for _ in range(n_windows - 1):
        evs = []
        for _ in range(int(r.integers(6, 20))):
            slot = int(r.integers(0, n_slots))
            kind = r.random()
            if kind < 0.7:
                evs.append(HostEvent(1, EventKind.ADD_TASK, slot,
                                     a=tuple(float(x) for x in
                                             _grid(r, 1, 48, 3)),
                                     prio=int(r.integers(0, 12))))
            elif kind < 0.9:
                evs.append(HostEvent(2, EventKind.REMOVE_TASK, slot,
                                     a=(0.0, 0, 0)))
            elif kind < 0.95:
                evs.append(HostEvent(0, EventKind.REMOVE_NODE,
                                     int(r.integers(0, n_nodes))))
            else:
                evs.append(HostEvent(0, EventKind.ADD_NODE,
                                     int(r.integers(0, n_nodes)),
                                     a=tuple(float(x) for x in
                                             _grid(r, 16, 256, 3))))
        windows.append(evs)
    return stack_windows([pack_window(cfg, evs, i)
                          for i, evs in enumerate(windows)])


def _ref_state(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


@pytest.mark.parametrize("name", STOCHASTIC)
def test_run_windows_matches_reference(name):
    windows = _soup(4)
    want, want_rows = ref_engine.run_windows_jit(
        ref_init_state(REF_CFG), jax.tree.map(jnp.asarray, windows), REF_CFG,
        name, 17)
    got, rows = engine.run_windows(init_state(CFG, "cpu"),
                                   window_to_torch(windows, "cpu"), CFG,
                                   sched.get_scheduler(name), 17)
    got, want = state_to_numpy(got), _ref_state(want)
    for k in DECISIONS + ("node_reserved", "node_used"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in want_rows.items():
        v = np.asarray(v)
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(rows[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(rows[k].numpy(), v, rtol=2.5e-7,
                                       err_msg=k)
    assert int(got["placements"]) > 0


@pytest.mark.parametrize("name", STOCHASTIC)
def test_simulation_matches_reference_end_to_end(tmp_path, name):
    """One tracegen trace (off the grid), each package's parser and
    Simulation, seed 3, batch_windows 8, a resync inside the run."""
    n_windows, shape = 24, dict(max_nodes=24, max_tasks=512,
                                max_events_per_window=256, sched_batch=32,
                                resync_windows=16)
    cfg = dataclasses.replace(REDUCED_SIM, **shape)
    ref_cfg = dataclasses.replace(REF_REDUCED, **shape)
    kw = dict(n_machines=24, n_jobs=60, horizon_windows=n_windows, seed=5,
              usage_period_us=20_000_000)
    tracegen.generate_trace(str(tmp_path / "p"), **kw)
    ref_tracegen.generate_trace(str(tmp_path / "r"), **kw)
    ref_sim = RefSimulation(ref_cfg, RefGCDParser(ref_cfg, str(tmp_path / "r"))
                            .packed_windows(n_windows,
                                            ref_start_us("gcd", ref_cfg)),
                            scheduler=name, batch_windows=8, seed=3)
    want = _ref_state(ref_sim.run())
    sim = Simulation(cfg, GCDParser(cfg, str(tmp_path / "p")).packed_windows(
        n_windows, default_start_us("gcd", cfg)), scheduler=name,
        batch_windows=8, seed=3, device="cpu")
    got = state_to_numpy(sim.run())
    assert sim.resyncs_done == ref_sim.resyncs_done == 1
    for k in DECISIONS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sf, rsf = sim.stats_frame(), ref_sim.stats_frame()
    np.testing.assert_array_equal(sf["placements"], rsf["placements"])
    assert validate_invariants(sim.state, cfg) == {}


FLEET_CFG = dataclasses.replace(CFG, inject_slots=16, inject_task_slots=32)
REF_FLEET_CFG = dataclasses.replace(REF_CFG, inject_slots=16,
                                    inject_task_slots=32)
MIXED = ([dict(name=f"b-{s}", scheduler=s) for s in BUILTINS]
         + [dict(name="storm", scheduler="greedy", evict_storm_frac=0.2),
            dict(name="amp", scheduler="round_robin", arrival_rate=2.0)])


@pytest.fixture(scope="module")
def ref_fleet():
    windows = _soup(6, FLEET_CFG)
    specs = [RefSpec(**s) for s in MIXED]
    knobs, names = ref_build_knobs(specs)
    lane_scheds = tuple(names.index(s.scheduler) for s in specs)
    state, stats = ref_batch.run_scenarios(
        ref_batch.init_batched_state(REF_FLEET_CFG, len(specs)),
        jax.tree.map(jnp.asarray, windows), knobs, REF_FLEET_CFG, names, 3,
        True, ref_sched.snapshot_dispatch(names), lane_scheds)
    return windows, _ref_state(state), {k: np.asarray(v)
                                        for k, v in stats.items()}


@pytest.mark.parametrize("dispatch", ["auto", "switch"])
def test_fleet_all_builtins_storm_injection(ref_fleet, dispatch):
    """All seven built-ins, a storm lane and an amplified lane in one
    fleet, through the switchless (kernel D's external rows) and the
    per-lane dispatch, lane for lane against the reference's fleet."""
    windows, want, want_rows = ref_fleet
    cfg = dataclasses.replace(FLEET_CFG, sched_dispatch=dispatch)
    specs = [ScenarioSpec(**s) for s in MIXED]
    knobs, names = build_knobs(specs)
    lane_scheds = tuple(names.index(s.scheduler) for s in specs)
    state, rows = batch_mod.run_scenarios(
        batch_mod.init_batched_state(cfg, len(specs), "cpu"),
        window_to_torch(windows, "cpu"), knobs, cfg, names, 3, True,
        sched.snapshot_dispatch(names), lane_scheds)
    got = state_to_numpy(state)
    for k in DECISIONS + ("node_reserved",):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in want_rows.items():
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(rows[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(rows[k].numpy(), v, rtol=5e-7,
                                       atol=1e-7, err_msg=k)
    assert (rows["placements"][-1] > 0).all()
    assert int(rows["injected_arrivals"].sum(0)[-1]) > 0


def _small_windows():
    r = np.random.default_rng(0)
    evs0 = [HostEvent(0, EventKind.ADD_NODE, i,
                      a=(float(r.uniform(0.4, 1.0)),
                         float(r.uniform(0.4, 1.0)), 1.0)) for i in range(8)]
    evs0 += [HostEvent(0, EventKind.ADD_NODE_ATTR, i, attr_idx=0,
                       attr_val=int(r.integers(0, 3))) for i in range(8)]
    evs1 = [HostEvent(1, EventKind.ADD_TASK, t,
                      a=(float(r.uniform(0.02, 0.3)),
                         float(r.uniform(0.02, 0.3)), 0.0),
                      prio=int(r.integers(0, 12)),
                      constraints=([(0, 1, int(r.integers(0, 3)))]
                                   if r.random() < 0.4 else None))
            for t in range(24)]
    return window_to_torch(stack_windows(
        [pack_window(REDUCED_SIM, evs0, 0),
         pack_window(REDUCED_SIM, evs1, 1)]), "cpu")


@pytest.mark.parametrize("name", STOCHASTIC)
def test_scheduler_invariants(name):
    state, stats = engine.run_windows(init_state(REDUCED_SIM, "cpu"),
                                      _small_windows(), REDUCED_SIM,
                                      sched.get_scheduler(name))
    assert validate_invariants(state, REDUCED_SIM) == {}, name
    assert int(stats["placements"][-1]) > 0, f"{name} placed nothing"


@pytest.mark.parametrize("name", ["simulated_annealing", "genetic",
                                  "random", "tabu_search"])
def test_stochastic_schedulers_deterministic_under_key(name):
    outs = []
    for seed in (42, 42, 43):
        state, _ = engine.run_windows(init_state(REDUCED_SIM, "cpu"),
                                      _small_windows(), REDUCED_SIM,
                                      sched.get_scheduler(name), seed=seed)
        outs.append(state.task_node.clone())
    assert torch.equal(outs[0], outs[1])
