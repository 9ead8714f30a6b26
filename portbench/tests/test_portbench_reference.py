"""The plain reference against the program on small cells on the CPU,
driven through the cells' own harness: a sound run is correct, and the
bfloat16 control, put in the program's place, is not."""
import pytest
import torch

from portbench_cells import tiny_job
from portbench import control
from portbench.harness import check, serve, sweep
from portbench.reference import sim as ref


@pytest.mark.parametrize("workload", ["cellA-sweep64.grid",
                                      "cellA-sweep64.surge"])
def test_sweep_run_is_correct(workload):
    job = tiny_job(workload)
    out = sweep.run(job)
    assert out.verdict.correct, out.verdict.as_json()
    assert out.verdict.numbers["rows_int_mismatch"][0] == 0
    assert out.attempted > 0 and out.values["sweep_rate"] > 0


def test_serve_run_is_correct(tmp_path):
    job = tiny_job("cellA-serve64.planners")
    out = serve.run(job, stack_dir=str(tmp_path))
    assert out.verdict.correct, out.verdict.as_json()
    assert out.failed == 0 and out.attempted % 4 == 0
    assert out.layer_inputs["lanes"] > 0
    assert out.verdict.numbers["answers_int_mismatch"][0] == 0


@pytest.mark.parametrize("workload", ["cellA-sweep64.grid",
                                      "cellA-serve64.planners"])
def test_bfloat16_control_is_not_correct(workload):
    job = tiny_job(workload, seed=2100000777)
    low = control.readings(job, torch.bfloat16)
    same = control.readings(job, torch.float32)
    assert all(v == 0 for v in same.values())
    assert any(v > check.LIMITS[k.split("_", 1)[1]]
               for k, v in low.items()), low


def test_reference_lane_order_does_not_matter():
    """A lane's rows do not depend on which other lanes the reference
    follows beside it (the check follows a sample of lanes)."""
    job = tiny_job("cellA-sweep64.grid")
    sim_cfg, trace, specs = sweep.make_inputs(job)
    a = sweep.follow(job, sim_cfg, trace, specs, [0, 5, 9], 24, 1234)
    b = sweep.follow(job, sim_cfg, trace, specs, [9, 3], 24, 1234)
    for k in a:
        assert (a[k][:, 2] == b[k][:, 0]).all(), k


def test_report_row_counts():
    import numpy as np
    frame = {"placements": np.array([1, 4]), "completions": np.array([0, 2]),
             "evictions": np.array([0, 1]),
             "injected_arrivals": np.array([3, 5]),
             "n_pending": np.array([10, 20]), "n_running": np.array([5, 6]),
             "n_nodes": np.array([7, 7]),
             "reserved_frac": np.array([[0.5, 0, 0], [0.7, 0, 0]]),
             "used_frac": np.array([[0.1, 0, 0], [0.3, 0, 0]]),
             "util_balance_var": np.array([0.01, 0.02])}
    row = ref.report_row(frame)
    assert row["placements"] == 4 and row["injected"] == 8
    assert row["pending_mean"] == 15.0
    assert row["cpu_reserved_frac_mean"] == pytest.approx(0.6)
