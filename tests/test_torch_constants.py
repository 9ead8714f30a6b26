"""Every constant and host-side module the port re-declares equals the
reference's: task states, usage columns, priority classes, event kinds,
constraint ops, the SimConfig dataclass (fields and defaults), the cell-A
config, the numpy event packing, trace generation and GCD parsing, and the
scenario fleet's proposal-family codes, perturbation salts, ScenarioSpec
(fields, defaults, validation) and knob labels; the chaos hooks' fault
kinds and the retry and breaker policies' defaults, the pre-compiled
stack's meta fields, the snapshot's meta keys, OpenB's vocabularies and the
full-cell config; the training side's
TrainConfig and ShapeConfig (fields and defaults), SHAPES, and each
architecture's parameter counts and ``describe`` line; and the
CloudSim-like baseline (policies, workload, a run's outcome)."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro.configs as ref_configs
import repro.core.events as ref_events
import repro.core.state as ref_state
import repro.core.stats as ref_stats
import repro.core.tracegen as ref_tracegen
import repro.kernels.placement_commit.kernel as ref_pc_kernel
import repro.kernels.window_stats.ref as ref_ws
import repro.core.precompile as ref_precompile
import repro.parsers.alibaba_openb as ref_openb
import repro.resilience.faults as ref_faults
import repro.resilience.policy as ref_policy
from repro.configs import agocs_full_cell as ref_full_cell
import repro.scenarios.perturb as ref_perturb
import repro.scenarios.spec as ref_spec
import repro.service.metrics as ref_service_metrics
import repro.service.protocol as ref_protocol
from repro.configs import agocs_cell_a as ref_cell_a
from repro.configs.agocs_full_cell import MONTH_WINDOWS as REF_MONTH
from repro.parsers import GCDParser as RefGCDParser
from repro.parsers import default_start_us as ref_start_us
import repro_torch.config as config
import repro_torch.configs as configs
import repro_torch.core.events as events
import repro_torch.core.state as state
import repro_torch.core.stats as stats
import repro_torch.core.tracegen as tracegen
import repro_torch.kernels.placement_commit as pc
import repro_torch.kernels.window_stats.ref as ws
import repro_torch.core.precompile as precompile
import repro_torch.parsers.alibaba_openb as openb
import repro_torch.resilience.faults as faults
import repro_torch.resilience.policy as policy
from repro_torch.configs import agocs_full_cell
import repro_torch.scenarios.perturb as perturb
import repro_torch.scenarios.spec as spec
import repro_torch.service.metrics as service_metrics
import repro_torch.service.protocol as protocol
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
    (pc, ref_pc_kernel, ("FAM_EXTERNAL", "FAM_SCORES", "FAM_NODE_ORDER")),
    (perturb, ref_perturb, ("_SALT_OUTAGE", "_SALT_THIN", "_SALT_SURGE",
                            "_SALT_STORM", "_SALT_INJECT", "_SALT_LIFETIME")),
    (spec, ref_spec, ("_KNOB_LABELS", "_FIELD_BY_LABEL")),
    (faults, ref_faults, ("KINDS",)),
    (precompile, ref_precompile, ("_META_FIELDS", "DEFAULT_SHARD_WINDOWS",
                                  "_PARSE_STAT_FIELDS")),
    (openb, ref_openb, ("_QOS_PRIO", "_QOS_DEFAULT_PRIO", "GPU_MODEL_ATTR")),
    (agocs_full_cell, ref_full_cell, ("MONTH_WINDOWS",)),
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


@pytest.mark.parametrize("name", ["RetryPolicy", "BreakerPolicy",
                                  "FaultSpec"])
def test_resilience_dataclasses_equal(name):
    mine = [(f.name, f.default) for f in
            dataclasses.fields(getattr(policy if name != "FaultSpec"
                                       else faults, name))]
    ref = [(f.name, f.default) for f in
           dataclasses.fields(getattr(ref_policy if name != "FaultSpec"
                                      else ref_faults, name))]
    assert mine == ref


def test_snapshot_meta_keys_equal(tmp_path):
    """Both packages write the same npz members and meta keys."""
    import json
    from repro.core.snapshot import save_snapshot as ref_save
    from repro_torch.core.snapshot import save_snapshot
    cfg = config.REDUCED_SIM
    save_snapshot(str(tmp_path / "a.npz"), state.init_state(cfg, "cpu"),
                  cfg, 3, extra={"x": 1})
    ref_save(str(tmp_path / "b.npz"), ref_state.init_state(
        ref_config.REDUCED_SIM), ref_config.REDUCED_SIM, 3, extra={"x": 1})
    metas = []
    for name in ("a.npz", "b.npz"):
        with np.load(tmp_path / name) as z:
            meta = json.loads(str(z["__meta__"]))
            metas.append((sorted(z.files), sorted(meta), meta["crc"],
                          meta["extra"], meta["windows_done"]))
    assert metas[0] == metas[1]


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
    (get_sim_config(), ref_cell_a.CONFIG),
    (agocs_full_cell.CONFIG, ref_full_cell.CONFIG),
    (get_sim_config("agocs_full_cell"), ref_full_cell.CONFIG)],
    ids=["reduced", "cell_a", "get_sim_config", "full_cell",
         "get_sim_config_full_cell"])
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


def test_scenario_spec_fields_defaults_and_knobs_equal():
    mine = [(f.name, f.default)
            for f in dataclasses.fields(spec.ScenarioSpec)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(ref_spec.ScenarioSpec)]
    assert mine == ref
    assert spec.ScenarioKnobs._fields == ref_spec.ScenarioKnobs._fields
    probe = dict(name="p", node_outage_frac=0.25, capacity_scale=0.5,
                 surge_priority=3, evict_storm_frac=0.125)
    assert spec.ScenarioSpec(**probe).describe() == \
        ref_spec.ScenarioSpec(**probe).describe()
    assert spec.ScenarioSpec(name="p").is_identity()


@pytest.mark.parametrize("bad", [dict(node_outage_frac=1.5),
                                 dict(capacity_scale=0.0),
                                 dict(surge_priority=12),
                                 dict(scheduler="no_such_scheduler")])
def test_scenario_spec_validation_equal(bad):
    with pytest.raises(ValueError):
        ref_spec.ScenarioSpec(**bad)
    with pytest.raises(ValueError):
        spec.ScenarioSpec(**bad)


def test_modelconfig_fields_and_defaults_equal():
    mine = [(f.name, f.default)
            for f in dataclasses.fields(config.ModelConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(ref_config.ModelConfig)]
    assert mine == ref
    assert config._round_up(151_936, 256) == ref_config._round_up(
        151_936, 256) == 152_064


def test_arch_ids_equal():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("shrink", [False, True], ids=["full", "reduced"])
def test_arch_configs_equal(arch, shrink):
    mine, ref = configs.get_config(arch), ref_configs.get_config(arch)
    if shrink:
        mine, ref = configs.reduced(mine), ref_configs.reduced(ref)
    assert type(mine) is config.ModelConfig
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("resolved_head_dim", "q_dim", "kv_dim", "d_inner",
                 "ssm_heads", "padded_vocab", "n_repeats"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.layer_pattern() == ref.layer_pattern()
    assert mine.has_attention() == ref.has_attention()
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert config.describe(mine) == ref_config.describe(ref)


def test_trainconfig_fields_and_defaults_equal():
    mine = [(f.name, f.default)
            for f in dataclasses.fields(config.TrainConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(ref_config.TrainConfig)]
    assert mine == ref


def test_shapes_equal():
    mine = [(f.name, f.default)
            for f in dataclasses.fields(config.ShapeConfig)]
    ref = [(f.name, f.default)
           for f in dataclasses.fields(ref_config.ShapeConfig)]
    assert mine == ref
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}


def test_service_error_codes_equal():
    def codes(m):
        return {k: v for k, v in vars(m.ErrorCode).items()
                if not k.startswith("_")}
    assert codes(protocol) == codes(ref_protocol)


@pytest.mark.parametrize("name", ["WhatIfQuery", "WhatIfResult"])
def test_service_dataclasses_equal(name):
    def fields(m):
        return [(f.name, f.default, repr(f.default_factory))
                for f in dataclasses.fields(getattr(m, name))]
    assert fields(protocol) == fields(ref_protocol)


def test_service_batch_key_and_metrics_keys_equal():
    kw = dict(n_windows=8, start_window=16, seed=3, deadline_s=1.0,
              priority=2)
    assert protocol.WhatIfQuery(spec.ScenarioSpec(), **kw).batch_key() == \
        ref_protocol.WhatIfQuery(ref_spec.ScenarioSpec(), **kw).batch_key()

    def keys(snap):
        return sorted(snap), sorted(snap["resilience"])
    assert keys(service_metrics.ServiceMetrics().snapshot()) == \
        keys(ref_service_metrics.ServiceMetrics().snapshot())


@pytest.mark.parametrize("policy", ["first_fit", "best_fit", "worst_fit"])
def test_cloudsim_baseline_equal(policy):
    """The port's CloudSim-like baseline is the reference's: the same
    policies, workload and outcome of a run (all but its wall time)."""
    import repro.baselines.cloudsim_like as ref_cs
    from repro_torch.baselines import cloudsim_like as cs
    assert list(cs.PLACEMENT_POLICIES) == list(ref_cs.PLACEMENT_POLICIES)
    assert (cs.CloudSimLike.SUBMIT, cs.CloudSimLike.FINISH) == \
        (ref_cs.CloudSimLike.SUBMIT, ref_cs.CloudSimLike.FINISH)
    assert [dataclasses.asdict(c) for c in cs.synth_workload(300, seed=3)] \
        == [dataclasses.asdict(c) for c in ref_cs.synth_workload(300, seed=3)]
    got = cs.run_benchmark(24, 300, seed=3, policy=policy)
    want = ref_cs.run_benchmark(24, 300, seed=3, policy=policy)
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want and got["placed"] > 0
    with pytest.raises(KeyError, match="unknown placement policy"):
        cs.CloudSimLike(4, policy="no_such_policy")
