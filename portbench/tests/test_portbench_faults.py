"""A run whose timed path is broken underneath comes out not correct:
once for each fault a what-if cell can have on one chip (a step that
leaves its state unchanged; half of the lanes left out, their rows the
mean of the rest; an answer altered where it is produced). The cells run
on one chip, so there is no exchange between chips to leave out."""
import pytest
import torch

from portbench_cells import tiny_job
from portbench.harness import serve, sweep, workload


def _state_unchanged(fleet):
    advance = fleet._advance

    def stuck(batch, seed):
        kept = type(fleet.state)(*[x.clone() for x in fleet.state])
        rows = advance(batch, seed)
        fleet.state = kept
        return rows
    fleet._advance = stuck


def _half_left_out(fleet):
    advance = fleet._advance

    def half(batch, seed):
        h = fleet.n_lanes // 2
        kept = [x[h:].clone() for x in fleet.state]
        rows = advance(batch, seed)
        fleet.state = type(fleet.state)(*[torch.cat([x[:h], k])
                                          for x, k in zip(fleet.state, kept)])
        out = {}
        for key, v in rows.items():
            mean = v[:, :h].double().mean(1, keepdim=True).to(v.dtype)
            out[key] = torch.cat([v[:, :h], mean.expand_as(v[:, h:])], 1)
        return out
    fleet._advance = half


def _answer_altered(fleet):
    advance = fleet._advance

    def altered(batch, seed):
        rows = advance(batch, seed)
        rows["placements"] = rows["placements"] + 1
        return rows
    fleet._advance = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered])
def test_sweep_fault_is_caught(fault):
    job = tiny_job("cellA-sweep64.grid")
    lanes = workload.sample_lanes(job.seed, 16, job.traffic["check_lanes"])
    assert max(lanes) >= 8          # the sample reaches the left-out half
    out = sweep.run(job, broken=fault)
    assert not out.verdict.correct, out.verdict.as_json()


def _serve_answer_altered(server):
    run_batch = server._run_batch

    def altered(tickets):
        results = run_batch(tickets)
        for r in results:
            r.frame["placements"] = r.frame["placements"] + 1
            r.row["placements"] += 1
        return results
    server._run_batch = altered


def _serve_fork_unchanged(server):
    from repro_torch.service import forkpoint
    build = forkpoint.build_fork_points

    def empty_points(fleet, every, store=None):
        fresh = type(fleet.state)(*[x.clone() for x in fleet.state])
        out = build(fleet, every, store)
        for w in out.windows:
            out.add(w, fresh, fleet.specs)
        return out
    server.build_fork_points = _rebind(server, empty_points)


def _rebind(server, builder):
    from repro_torch.scenarios.runner import ScenarioFleet

    def build_fork_points(specs, every, n_windows=None):
        fleet = ScenarioFleet.from_precompiled(
            server.cfg, server.replay_path, specs,
            batch_windows=server.batch_windows, seed=server.seed,
            n_windows=n_windows, device=server.device)
        builder(fleet, every, server.forks)
        server._fork_seed = server.seed
        return server.forks.windows
    return build_fork_points


@pytest.mark.parametrize("fault", [_serve_answer_altered,
                                   _serve_fork_unchanged])
def test_serve_fault_is_caught(fault, tmp_path):
    out = serve.run(tiny_job("cellA-serve64.planners"), broken=fault,
                    stack_dir=str(tmp_path))
    assert not out.verdict.correct, out.verdict.as_json()
