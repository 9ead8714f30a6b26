"""The port's Alibaba OpenB trace family, the checks of the reference's
``tests/test_openb.py``: registry resolution, the checked-in mini fixture
(``tests/fixtures/openb_mini/``, read in place) through parse -> simulate,
and pre-compiled replay roundtrips. Across the packages: both parse the
fixture to the same windows, simulate it to the same decisions, and
generate the same synthetic trace."""
import hashlib
import os
import tempfile

import numpy as np
import pytest

from repro_torch.config import REDUCED_SIM
from repro_torch.core.events import EventKind, OP_EQ, stack_windows
from repro_torch.core.pipeline import Simulation
from repro_torch.core.precompile import precompile_trace, replay_windows
from repro_torch.core.state import validate_invariants
from repro_torch.core.tracegen import SHIFT_US
from repro_torch.parsers import default_start_us, get_parser
from repro_torch.parsers.alibaba_openb import (AlibabaOpenBParser,
                                         generate_openb_trace)
from repro_torch.parsers.gcd import GCDParser

CFG = REDUCED_SIM
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "openb_mini")
N = 60                                   # the fixture's 300 s horizon


def test_registry_resolves_families():
    assert get_parser("openb") is AlibabaOpenBParser
    assert get_parser("gcd") is GCDParser
    assert AlibabaOpenBParser.family == "openb"
    with pytest.raises(KeyError, match="unknown trace family"):
        get_parser("alibaba")
    assert default_start_us("gcd", CFG) == SHIFT_US - CFG.window_us
    assert default_start_us("openb", CFG) == 0


def test_fixture_parses_to_engine_contract():
    parser = AlibabaOpenBParser(CFG, FIXTURE)
    kinds, prios, n_cons = {}, set(), 0
    for w in parser.packed_windows(N, start_us=0):
        k = np.asarray(w.kind)
        for kk in k[k != 0]:
            kinds[EventKind(int(kk))] = kinds.get(EventKind(int(kk)), 0) + 1
        add = k == int(EventKind.ADD_TASK)
        prios.update(np.asarray(w.prio)[add].tolist())
        n_cons += int((np.asarray(w.constraints)[add, :, 1] == OP_EQ).sum())
    assert kinds[EventKind.ADD_NODE] == 8
    assert kinds[EventKind.ADD_NODE_ATTR] > 0       # gpu models declared
    assert kinds[EventKind.ADD_TASK] > 0
    assert kinds[EventKind.REMOVE_TASK] > 0
    # OpenB ships no usage table
    assert EventKind.UPDATE_TASK_USED not in kinds
    assert all(0 <= p <= 11 for p in prios)         # qos -> priority range
    assert len(prios) > 1                           # several qos classes
    assert n_cons > 0                               # gpu_spec constraints
    assert parser.stats.rows > 0
    assert parser.stats.bad_rows == 0
    assert parser.stats.slot_overflow == 0


def test_fixture_simulates_end_to_end():
    parser = AlibabaOpenBParser(CFG, FIXTURE)
    sim = Simulation(CFG, parser.packed_windows(N, start_us=0),
                     scheduler="greedy", batch_windows=16, device="cpu")
    state = sim.run()
    assert sim.windows_done == N
    sf = sim.stats_frame()
    assert int(sf["placements"][-1]) > 0
    assert int(sf["completions"][-1]) > 0
    assert not validate_invariants(state, CFG)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_precompiled_replay_roundtrip_bitwise():
    with tempfile.TemporaryDirectory() as d:
        a = os.path.join(d, "stream.npz")
        b = os.path.join(d, "legacy.npz")
        for path, streaming in ((a, True), (b, False)):
            n = precompile_trace(CFG, FIXTURE, path, N, start_us=0,
                                 shard_windows=16, family="openb",
                                 streaming=streaming)
            assert n == N
        assert _sha(a) == _sha(b)
        # replayed tensors == a fresh parse, field by field
        replayed = stack_windows(
            [type(bw)(*[np.asarray(f[i]) for f in bw])
             for bw in replay_windows(a, batch=8)
             for i in range(bw.kind.shape[0])])
        parsed = stack_windows(list(
            AlibabaOpenBParser(CFG, FIXTURE).packed_windows(N, start_us=0)))
        for name, got, want in zip(replayed._fields, replayed, parsed):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)


def test_generator_is_deterministic():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        generate_openb_trace(d1, n_nodes=6, n_pods=20, horizon_s=120, seed=3)
        generate_openb_trace(d2, n_nodes=6, n_pods=20, horizon_s=120, seed=3)
        for name in ("openb_node_list.csv", "openb_pod_list.csv"):
            with open(os.path.join(d1, name)) as f1, \
                    open(os.path.join(d2, name)) as f2:
                assert f1.read() == f2.read()


# --- against the reference -------------------------------------------------

def test_fixture_parses_and_simulates_as_the_reference():
    from repro.config import REDUCED_SIM as REF_CFG
    from repro.core.pipeline import Simulation as RefSimulation
    from repro.parsers.alibaba_openb import AlibabaOpenBParser as RefParser
    mine = AlibabaOpenBParser(CFG, FIXTURE)
    ref = RefParser(REF_CFG, FIXTURE)
    got = stack_windows(list(mine.packed_windows(N, start_us=0)))
    want = stack_windows(list(ref.packed_windows(N, start_us=0)))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)
    assert mine.stats == type(mine.stats)(**ref.stats.__dict__)
    sim = Simulation(CFG, AlibabaOpenBParser(CFG, FIXTURE).packed_windows(
        N, start_us=0), scheduler="tabu_search", batch_windows=16, seed=4,
        device="cpu")
    ref_sim = RefSimulation(REF_CFG, RefParser(REF_CFG, FIXTURE)
                            .packed_windows(N, start_us=0),
                            scheduler="tabu_search", batch_windows=16,
                            seed=4)
    state, ref_state = sim.run(), ref_sim.run()
    for f in ("task_state", "task_node", "node_active", "placements",
              "completions", "evictions"):
        np.testing.assert_array_equal(getattr(state, f).numpy(),
                                      np.asarray(getattr(ref_state, f)),
                                      err_msg=f)


def test_generator_equals_the_references():
    from repro.parsers.alibaba_openb import generate_openb_trace as ref_gen
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        a = generate_openb_trace(d1, n_nodes=6, n_pods=20, horizon_s=120,
                                 seed=3)
        b = ref_gen(d2, n_nodes=6, n_pods=20, horizon_s=120, seed=3)
        assert a == b
        for name in ("openb_node_list.csv", "openb_pod_list.csv"):
            with open(os.path.join(d1, name)) as f1, \
                    open(os.path.join(d2, name)) as f2:
                assert f1.read() == f2.read()
