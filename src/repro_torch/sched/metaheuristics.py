"""Meta-heuristic schedulers — simulated annealing, tabu search, genetic —
the paper's §IV MASB suite (meta-heuristics of [22]).

All three search over (P, N) preference matrices and score candidates with
the SAME cheap surrogate (:func:`argmax_surrogate`): every task goes to its
argmax node, capacity ignored, and the objective is the balance of the
resulting trial reservation — the finaliser enforces capacity later.

Each search step re-evaluates the whole surrogate: the argmax over (P, N),
the per-node sum of the chosen tasks' requests into N x R (kernel E,
``segment_usage``, on the card: a sum in task order without float atomics),
then the balance. The loops stay on the device: the step's task, node and
acceptance are tensors, the move is an indexed write of one entry, and the
key stream (``core.prng``) reproduces the reference's draws bitwise. The
keys every step splits off depend only on the scheduler's key, so all of a
loop's draws are made before it runs.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.kernels.segment_usage.ops import segment_usage_lanes
from repro_torch.kernels.window_stats.ref import node_reserved_frac
from repro_torch.sched.base import NEG
from repro_torch.sched.registry import register_scheduler
from repro_torch.sched.table import SchedContext, TableForm, context_from_state


def balance_objective(reserved, total, active):
    """Variance of per-node reservation fraction (lower = better balanced):
    reserved (..., N, R) -> (...). The mean over R is the reference's (the
    sum in index order times the f32 reciprocal of R); the two sums over N
    are accumulated in f64 and rounded once, as ``window_stats`` does."""
    f = node_reserved_frac(reserved, total, active)            # (..., N)
    na = active.sum(-1, dtype=torch.int32).clamp_min(1)
    mu = f.double().sum(-1).float() / na
    sq = torch.where(active, (f - mu[..., None]) ** 2, 0.0)
    return sq.double().sum(-1).float() / na


def _surrogate(req, node_reserved, node_total, node_active, valid, base_ok):
    """Array-level core of :func:`argmax_surrogate` — also reachable from a
    :class:`SchedContext` (switchless table forms), which carries exactly
    these slices. Both functions take one preference matrix (P, N) or a
    stack of them (..., P, N)."""
    P, N = base_ok.shape
    weight = valid & base_ok.any(1)

    def trial_reserved(pref_m):
        choice = torch.where(base_ok, pref_m, NEG).argmax(-1)   # (..., P)
        lead = choice.shape[:-1]
        B = choice[..., 0].numel()
        sums = segment_usage_lanes(
            choice.reshape(B, P).to(torch.int32), req.expand(B, P, -1),
            weight.expand(B, P), N)
        return node_reserved + sums.reshape(lead + (N, req.shape[-1]))

    def energy(pref_m):
        return balance_objective(trial_reserved(pref_m), node_total,
                                 node_active)

    return trial_reserved, energy


def argmax_surrogate(state, idx, valid, base_ok):
    """The shared trial-placement surrogate: ``(trial_reserved, energy)``.

    trial_reserved(pref_m): cheap surrogate placement — every task goes to
    its argmax node (capacity ignored; the finaliser enforces it later) and
    the implied requests are summed onto the current reservation matrix.

    energy(pref_m): post-placement reservation balance of that trial
    (lower = better). GA fitness is its negation.
    """
    return _surrogate(state.task_req[idx], state.node_reserved,
                      state.node_total, state.node_active, valid, base_ok)


def _ctx_surrogate(ctx: SchedContext):
    return _surrogate(ctx.req, ctx.node_reserved, ctx.node_total,
                      ctx.node_active, ctx.valid, ctx.base_ok)


def _step_keys(k, n_steps: int, n_sub: int) -> torch.Tensor:
    """The subkeys of a loop whose every step does ``key, *subs =
    split(key, n_sub + 1)``: (n_steps, n_sub, 2)."""
    subs = []
    for _ in range(n_steps):
        s = prng.split(k, n_sub + 1)
        k = s[0]
        subs.append(s[1:])
    if not subs:
        return k.new_zeros((0, n_sub, 2))
    return torch.stack(subs)


def _moves(k, n_steps: int, n_sub: int, P: int, N: int):
    """Each step's subkeys, and the flat (P, N) index of the move its first
    two subkeys draw (``randint`` of a task, then of a node)."""
    ks = _step_keys(k, n_steps, n_sub)
    p = prng.randint(ks[:, 0], 0, P)
    n = prng.randint(ks[:, 1], 0, N)
    return ks, p, p * N + n


def _finite_or_zero(scores):
    return torch.where(torch.isfinite(scores), scores, 0.0)


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as XLA's fused loops contract a
    multiply feeding an add. The product of two f32 values is exact in
    f64; the f64 sum is then rounded to odd (an inexact sum whose last bit
    is even moves to its neighbour toward the exact value, found by
    TwoSum), so its rounding to f32 is the single rounding of the exact
    value (53 >= 24 + 2 bits). Finite inputs."""
    p = torch.as_tensor(a, dtype=torch.float32).double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float32, device=p.device).double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)             # the exact sum is s + err
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sa_temps(t0: float, n_steps: int, device) -> torch.Tensor:
    """Every step's temperature: t0 * (1 - i / n_steps) + 1e-6, in f32
    from the loop index."""
    i = torch.arange(n_steps, dtype=torch.float32, device=device)
    return _fma(t0, 1.0 - i / float(n_steps), 1e-6)


def _sa_accept(e_new, e, u, temp):
    """SA's acceptance test, in f32. ``exp`` is not bitwise the same in
    XLA's CPU code, PyTorch's CPU code and CUDA (a share of arguments
    differ by an ulp), so a decision can differ where ``u`` falls between
    the two values; ``tests/test_torch_stochastic.py`` counts how often
    on the CPU."""
    return (e_new < e) | (u < torch.exp(-(e_new - e) / temp))


def tf_simulated_annealing(cfg, ctx: SchedContext, rng, params):
    """Table form of :func:`propose_simulated_annealing` — identical search
    over the shared base-pass context; params = (n_steps, t0)."""
    n_steps, t0 = int(params[0]), float(params[1])
    P, N = ctx.base_ok.shape
    k_init, k_steps = prng.split(rng)
    pref = prng.uniform(k_init, (P, N))
    _, energy = _ctx_surrogate(ctx)
    ks, _, flat = _moves(k_steps, n_steps, 3, P, N)
    u = prng.uniform(ks[:, 2])
    temp = _sa_temps(t0, n_steps, pref.device)
    view = pref.view(-1)            # the candidate is pref with one entry
    e = energy(pref)                # pushed; it is put back if rejected
    for s in range(n_steps):
        at = flat[s:s + 1]
        old = view[at]
        view[at] = old + 1.0        # push task p toward node n
        e_new = energy(pref)
        accept = _sa_accept(e_new, e, u[s], temp[s])
        view[at] = torch.where(accept, view[at], old)
        e = torch.where(accept, e_new, e)
    return pref


def propose_simulated_annealing(state, cfg, rng, idx, valid, base_ok,
                                scores, n_steps: int = 64, t0: float = 0.1):
    """Anneal a random feasible preference toward balanced placements.
    Objective: post-placement reservation balance."""
    ctx = context_from_state(state, idx, valid, base_ok, scores)
    return tf_simulated_annealing(cfg, ctx, rng, (n_steps, t0))


def tf_tabu_search(cfg, ctx: SchedContext, rng, params):
    """Table form of :func:`propose_tabu_search`; params = (n_steps,
    tenure).

    The reference carries the current matrix and the best one apart, but
    both start equal and are replaced by the same candidate on an
    improvement only, so one matrix holds both."""
    n_steps, tenure = int(params[0]), int(params[1])
    P, N = ctx.base_ok.shape
    k_init, k_steps = prng.split(rng)
    pref = _fma(0.01, prng.uniform(k_init, (P, N)),
                _finite_or_zero(ctx.scores))
    _, energy = _ctx_surrogate(ctx)
    _, p, flat = _moves(k_steps, n_steps, 2, P, N)
    tabu_until = torch.zeros(P, dtype=torch.int32, device=pref.device)
    view = pref.view(-1)
    e_best = energy(pref)
    for s in range(n_steps):
        at, task = flat[s:s + 1], p[s:s + 1]
        allowed = tabu_until[task] <= s
        old = view[at]
        view[at] = old + torch.where(allowed, 1.0, 0.0)
        e_new = energy(pref)
        improve = (e_new < e_best) & allowed
        # aspiration: accept any improving move; otherwise keep best-so-far
        view[at] = torch.where(improve, view[at], old)
        e_best = torch.where(improve, e_new, e_best)
        tabu_until[task] = torch.where(allowed, s + tenure, tabu_until[task])
    return pref


def propose_tabu_search(state, cfg, rng, idx, valid, base_ok, scores,
                        n_steps: int = 48, tenure: int = 8):
    """Tabu search (paper §IV names it among the MASB schedulers): greedy
    local moves on the preference surrogate with a short-term memory that
    forbids revisiting recently-touched (task) coordinates."""
    ctx = context_from_state(state, idx, valid, base_ok, scores)
    return tf_tabu_search(cfg, ctx, rng, (n_steps, tenure))


def tf_genetic(cfg, ctx: SchedContext, rng, params):
    """Table form of :func:`propose_genetic`; params = (pop, gens,
    mut_rate). The population's fitness is one surrogate evaluation of the
    whole (pop, P, N) stack (kernel E with a lane an individual)."""
    pop, gens, mut_rate = int(params[0]), int(params[1]), float(params[2])
    P, N = ctx.base_ok.shape
    keys = prng.split(rng, pop + 1)
    population = prng.uniform(keys[:pop], (P, N))
    # seed one individual with the best-fit scores (the paper's 'seeded GA')
    population[0] = _finite_or_zero(ctx.scores)
    _, energy = _ctx_surrogate(ctx)
    mut = torch.tensor(mut_rate, dtype=torch.float32,
                       device=population.device)
    for key in prng.split(keys[pop], gens):
        order = torch.argsort(energy(population), stable=True)  # -fitness
        elite = population[order[: pop // 2]]
        k1, k2 = prng.split(key)
        parents = torch.cat([elite, elite], dim=0)
        mask = prng.uniform(k1, parents.shape) < mut
        children = torch.where(mask, prng.uniform(k2, parents.shape),
                               parents)
        children[0] = elite[0]                      # elitism
        population = children
    best = torch.argmax(-energy(population))
    return population.index_select(0, best.reshape(1))[0]


def propose_genetic(state, cfg, rng, idx, valid, base_ok, scores,
                    pop: int = 8, gens: int = 4, mut_rate: float = 0.15):
    """Small GA over preference matrices (the paper's 4 GA variants, seeded
    and unseeded, distilled): tournament-free truncation selection + mutation;
    fitness = placement balance of the argmax surrogate."""
    ctx = context_from_state(state, idx, valid, base_ok, scores)
    return tf_genetic(cfg, ctx, rng, (pop, gens, mut_rate))


# All three are external table forms (rng-driven searches — nothing for the
# fused kernel to derive from scores alone), but registering them makes
# mixed fleets switchless: a lane's SA/tabu/GA loop runs for ONLY the lanes
# that asked for it. params mirror the propose_* defaults.
simulated_annealing = register_scheduler(
    "simulated_annealing", propose_simulated_annealing,
    doc="Simulated annealing toward balanced placements.",
    table_form=TableForm(tf_simulated_annealing, (64.0, 0.1)))
tabu_search = register_scheduler(
    "tabu_search", propose_tabu_search,
    doc="Tabu search with short-term move memory.",
    table_form=TableForm(tf_tabu_search, (48.0, 8.0)))
genetic = register_scheduler(
    "genetic", propose_genetic,
    doc="Genetic algorithm over preference matrices (seeded GA).",
    table_form=TableForm(tf_genetic, (8.0, 4.0, 0.15)))
