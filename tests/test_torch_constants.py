"""Every constant and host-side module the port re-declares equals the
reference's: task states, usage columns, priority classes, event kinds,
constraint ops, the SimConfig dataclass (fields and defaults), the cell-A
config, and the numpy event packing, trace generation and GCD parsing."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro.core.events as ref_events
import repro.core.state as ref_state
import repro.core.stats as ref_stats
import repro.core.tracegen as ref_tracegen
import repro.kernels.window_stats.ref as ref_ws
from repro.configs import agocs_cell_a as ref_cell_a
from repro.configs.agocs_full_cell import MONTH_WINDOWS as REF_MONTH
from repro.parsers import GCDParser as RefGCDParser
from repro.parsers import default_start_us as ref_start_us
import repro_torch.config as config
import repro_torch.core.events as events
import repro_torch.core.state as state
import repro_torch.core.stats as stats
import repro_torch.core.tracegen as tracegen
import repro_torch.kernels.window_stats.ref as ws
from repro_torch.configs import agocs_cell_a, get_sim_config
from repro_torch.parsers import GCDParser, default_start_us

torch.set_num_threads(1)

NAMES = [
    (state, ref_state, ("TASK_EMPTY", "TASK_PENDING", "TASK_RUNNING")),
    (stats, ref_stats, ("ACCOUNTED_USAGE_COLS", "USAGE_NAMES", "U_CPU",
                        "U_CANON_MEM", "U_ASSIGN_MEM", "U_PAGE_CACHE",
                        "U_DISK_IO", "U_DISK_SPACE", "U_CPI", "U_MAI")),
    (ws, ref_ws, ("N_PRIO",)),
    (events, ref_events, ("OP_NONE", "OP_EQ", "OP_NE", "OP_LT", "OP_GT",
                          "REMOVE_REASON_EVICT", "GCD_TASK_ACTION",
                          "GCD_MACHINE_ADD", "GCD_MACHINE_REMOVE",
                          "GCD_MACHINE_UPDATE")),
    (tracegen, ref_tracegen, ("SHIFT_US", "USAGE_PERIOD_US",
                              "PAPER_CELL_MACHINES", "PAPER_JOBS_PER_HOUR")),
]


@pytest.mark.parametrize("mod,ref,names", NAMES,
                         ids=[m.__name__ for m, _, _ in NAMES])
def test_constants_equal(mod, ref, names):
    for n in names:
        assert getattr(mod, n) == getattr(ref, n), n


def test_event_kinds_equal():
    assert ({k.name: int(k) for k in events.EventKind}
            == {k.name: int(k) for k in ref_events.EventKind})
    assert events.EventWindow._fields == ref_events.EventWindow._fields
    assert events.HostEvent._fields == ref_events.HostEvent._fields
    assert tracegen.MONTH_WINDOWS == REF_MONTH


def test_state_fields_equal():
    assert state.SimState._fields == ref_state.SimState._fields


def test_simconfig_fields_and_defaults_equal():
    mine = [(f.name, f.default) for f in dataclasses.fields(config.SimConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(ref_config.SimConfig)]
    assert mine == ref
    probe = config.SimConfig(max_nodes=10, max_tasks=100, inject_slots=4)
    ref_probe = ref_config.SimConfig(max_nodes=10, max_tasks=100,
                                     inject_slots=4)
    for prop in ("resolved_inject_task_slots", "resolved_storm_max_victims",
                 "real_task_slots", "events_per_window"):
        assert getattr(probe, prop) == getattr(ref_probe, prop), prop


@pytest.mark.parametrize("bad", [dict(stats_stride=0), dict(resync_windows=-1),
                                 dict(sched_dispatch="x"),
                                 dict(inject_slots=8192)])
def test_simconfig_validator_equal(bad):
    with pytest.raises(ValueError):
        ref_config.SimConfig(**bad)
    with pytest.raises(ValueError):
        config.SimConfig(**bad)


@pytest.mark.parametrize("mine,ref", [
    (config.REDUCED_SIM, ref_config.REDUCED_SIM),
    (agocs_cell_a.CONFIG, ref_cell_a.CONFIG),
    (get_sim_config(), ref_cell_a.CONFIG)], ids=["reduced", "cell_a",
                                                  "get_sim_config"])
def test_configs_equal(mine, ref):
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_packing_tracegen_and_parse_equal(tmp_path):
    """Same trace files, same packed windows, same parse stats."""
    cfg = dataclasses.replace(config.REDUCED_SIM, max_nodes=16,
                              max_tasks=256)
    ref_cfg = dataclasses.replace(ref_config.REDUCED_SIM, max_nodes=16,
                                  max_tasks=256)
    kw = dict(n_machines=16, n_jobs=30, horizon_windows=12, seed=3)
    a, b = tmp_path / "a", tmp_path / "b"
    tracegen.generate_trace(str(a), **kw)
    ref_tracegen.generate_trace(str(b), **kw)
    assert sorted(p.name for p in a.iterdir()) == \
        sorted(p.name for p in b.iterdir())
    for p in a.iterdir():
        assert p.read_bytes() == (b / p.name).read_bytes(), p.name
    parser, ref_parser = GCDParser(cfg, str(a)), RefGCDParser(ref_cfg, str(b))
    mine = list(parser.packed_windows(12, default_start_us("gcd", cfg)))
    ref = list(ref_parser.packed_windows(12, ref_start_us("gcd", ref_cfg)))
    assert len(mine) == len(ref) == 12
    for w, rw in zip(mine, ref):
        for f, x, y in zip(events.EventWindow._fields, w, rw):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert dataclasses.asdict(parser.stats) == \
        dataclasses.asdict(ref_parser.stats)
    tw = events.window_to_torch(events.stack_windows(mine), "cpu")
    for f, x in zip(events.EventWindow._fields, tw):
        assert x.numpy().dtype == getattr(
            ref_events.stack_windows(ref), f).dtype, f
