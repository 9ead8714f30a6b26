"""Scenario fleet — batched what-if simulation on the port.

The trace is parsed once, and B divergent scenarios — node outages,
capacity changes, arrival thinning and amplification, priority surges,
usage inflation, eviction storms, different schedulers — advance together
over a lane-batched ``SimState``.

Layout:
  spec.py    declarative ScenarioSpec + grid expansion -> stacked knobs
  perturb.py per-lane transforms of the shared event stream
             (incl. SUBMIT injection into the reserved slot pool)
  batch.py   the lane-batched fleet step, switchless or switch dispatch,
             and the lanes split over a ('data',) mesh of torch.distributed
             ranks (fleet_mesh, run_scenarios_sharded)
  runner.py  ScenarioFleet: one parse feeds all lanes
  report.py  per-scenario comparative metrics vs. a baseline scenario
"""
from repro_torch.scenarios.spec import (ScenarioKnobs, ScenarioSpec,
                                        build_knobs, expand_grid)
from repro_torch.scenarios.batch import fleet_mesh
from repro_torch.scenarios.runner import ScenarioFleet
from repro_torch.scenarios.report import format_table, scenario_report

__all__ = ["ScenarioSpec", "ScenarioKnobs", "build_knobs", "expand_grid",
           "ScenarioFleet", "fleet_mesh", "scenario_report", "format_table"]
