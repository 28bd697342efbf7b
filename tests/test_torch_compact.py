"""simtpu_torch's compact carried state against the JAX package, on the CPU.

The port's compact layout (`simtpu_torch/engine/state.py`: `compact_spec`,
the plain versions of K11 `compact_compress`, K12 `compact_expand` and K13
`compact_delta`, and the engine plumbing in `engine/scan.py`) is held
against the JAX package's `simtpu/engine/state.py` on the same problems,
with zero tolerance: int32 planes equal, f32 planes equal bit for bit,
placements and reasons equal.

1. the spec (row partition, representatives, histogram width) on a mixed
   problem and on a problem with several tabular keys;
2. compression of a really placed state field by field, and expansion
   back to the dense state bit for bit;
3. the direct compact delta on evict and restore batches (the interleave
   of tests/test_state_deltas.py's TestDirectCompactDelta), tabular rows
   alone and with dense rows, against the JAX direct apply and against the
   expand -> K7 -> compress route;
4. the engine with the compact carry on against the JAX engine with it on
   and against the port with it off, over two batches that keep the
   vocabulary (so the carry is expanded and reused), with the wavefront on
   and off;
5. preemption under the compact carry: the direct delta, the compress /
   expand / direct-delta counts against the JAX package's counters, and
   the outcome;
6. the carried-byte gauge;
7. a batch that fails part-way leaves the compact carry as it was, and
   expansion shares no storage with the carry;
8. K11's row-task table (`cuda.compress_plan`) run in numpy against
   compress_state_plain on cuts of the serial and extended problems (one
   of 103 nodes: N % 4 != 0) and the problems above, every narrowed
   element written once, and its one-buffer wrapper (a recording stand-in
   for the library): aligned planes apart, the spec checked once.

Tests that plan with the audit use SIMTPU_AUDIT_JIT=0.
"""

import importlib
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.obs.metrics import REGISTRY, family
from simtpu_torch import smoke
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.engine import wavefront as twf
from simtpu_torch.kernels import cuda
from ._threads import one_torch_thread  # noqa: F401 (autouse)
from .test_torch_filter_storage import _FakeLib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _round_robin_pods(pkg, apps):
    """tests/test_compact.py's pod order: round-robined across the
    deployments, so the first half already holds a pod of every group and
    the second batch interns nothing new (the carry-reuse branch runs)."""
    per_dep: dict = {}
    for a in apps:
        for p in _mod(pkg, "workloads.expand").get_valid_pods_exclude_daemonset(a.resource):
            lbl = ((p.get("metadata") or {}).get("labels") or {}).get("app")
            per_dep.setdefault(lbl, []).append(p)
    deps = list(per_dep.values())
    pods = []
    for i in range(max(len(ps) for ps in deps)):
        for ps in deps:
            if i < len(ps):
                pods.append(ps[i])
    assert len(pods) // 2 >= len(deps), "first half must cover every group"
    return pods


def _mixed(pkg):
    """tests/test_compact.py's _mixed_problem: zone and hostname keys
    (tabular and dense rows), extended resources, hard constraints."""
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(72, seed=41, zones=3, taint_frac=0.1, gpu_frac=0.3, storage_frac=0.4)
    apps = synth.synth_apps(90, seed=42, zones=3, pods_per_deployment=15, selector_frac=0.2,
                            toleration_frac=0.1, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.5,
                            spread_frac=0.3, spread_hard_frac=0.5, gpu_frac=0.2, storage_frac=0.2,
                            affinity_frac=0.2)
    return cluster, _round_robin_pods(pkg, apps)


def _keys(pkg):
    """smoke.py's keys problem, cut: five extra label keys of 2-14 domains
    (tabular) beside the zone key, and the hostname key (72 nodes: dense)."""
    cluster, apps = smoke.keys_problem(_mod(pkg, "synth"), pkg.AppResource, pkg.ResourceTypes,
                                       n_nodes=72, keys=5, replicas=8)
    return cluster, _round_robin_pods(pkg, apps)


def _tabular(pkg):
    """tests/test_state_deltas.py's 9-node fixture: every count row tabular."""
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(9, seed=41, zones=3, taint_frac=0.1, gpu_frac=0.3, storage_frac=0.4)
    apps = synth.synth_apps(48, seed=42, zones=3, pods_per_deployment=8, selector_frac=0.2,
                            toleration_frac=0.1, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.5,
                            spread_frac=0.3, spread_hard_frac=0.5, gpu_frac=0.2, storage_frac=0.2,
                            affinity_frac=0.1)
    return cluster, _round_robin_pods(pkg, apps)


def _wide(pkg):
    """tests/test_state_deltas.py's 80-node fixture: hostname-keyed terms
    ride the dense rows."""
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(80, seed=61, zones=4, taint_frac=0.0, gpu_frac=0.2, storage_frac=0.3)
    apps = synth.synth_apps(40, seed=62, zones=4, pods_per_deployment=6, selector_frac=0.1,
                            anti_affinity_frac=0.6, anti_affinity_hard_frac=0.4, spread_frac=0.4,
                            spread_hard_frac=0.5, gpu_frac=0.1, storage_frac=0.2)
    return cluster, _round_robin_pods(pkg, apps)


def _bytes_problem(pkg):
    """tests/test_compact.py TestBytesShrink's zone-dominated problem."""
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(120, seed=21, zones=4, taint_frac=0.0)
    apps = synth.synth_apps(300, seed=22, zones=4, pods_per_deployment=30, selector_frac=0.1,
                            anti_affinity_frac=0.0, spread_frac=0.8, affinity_frac=0.5)
    return cluster, _round_robin_pods(pkg, apps)


PROBLEMS = {"mixed": _mixed, "keys": _keys, "tabular": _tabular, "wide": _wide, "bytes": _bytes_problem}


def _place(pkg, name: str, compact: bool, speculate: bool = False, batches: int = 2):
    """One engine of `pkg` placing problem `name` in two batches (the
    second reuses the carry). Returns (engine, nodes, reasons)."""
    cluster, pods = PROBLEMS[name](pkg)
    tz = _mod(pkg, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    eng = jscan.Engine(tz) if pkg is simtpu else tscan.Engine(tz, "cpu")
    eng.compact = compact
    eng.speculate = speculate
    cut = len(pods) // 2 if batches == 2 else len(pods)
    n1, r1, _ = eng.place(tz.add_pods(pods[:cut]))
    nodes, reasons = [n1], [r1]
    if batches == 2:
        b2 = tz.add_pods(pods[cut:])
        assert eng.state_vocab(tz.freeze()) == eng._last_vocab
        n2, r2, _ = eng.place(b2)
        nodes.append(n2)
        reasons.append(r2)
    return eng, np.concatenate(nodes), np.concatenate(reasons)


def _np(state):
    return {f: (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for f, x in zip(state._fields, state)}


def _assert_equal(got, want, label):
    """Every field equal with its dtype: bit for bit."""
    got, want = _np(got), _np(want)
    assert list(got) == list(want), label
    for name in want:
        assert got[name].dtype == want[name].dtype, (label, name, got[name].dtype, want[name].dtype)
        assert got[name].shape == want[name].shape, (label, name)
        assert np.array_equal(got[name], want[name]), f"{label}: plane {name} differs"


def _port_dense(jax_state):
    return tstate.state_from_numpy(jax_state, "cpu")


@pytest.mark.parametrize("name", ["mixed", "keys"])
def test_compact_spec_equals_jax(name):
    """compact_spec: the row partition, each tabular row's key and
    representatives, and the histogram width, on the port's own tensors."""
    j_eng, _, _ = _place(simtpu, name, compact=True, batches=1)
    t_eng, _, _ = _place(simtpu_torch, name, compact=True, batches=1)
    want = jstate.compact_spec(j_eng.tensorizer.freeze())
    got = tstate.compact_spec(t_eng.tensorizer.freeze())
    assert got.enabled and want.enabled and got.d == want.d
    for field in tstate.CompactSpecDev._fields:
        g, w = getattr(got.dev, field).numpy(), np.asarray(getattr(want.dev, field))
        assert g.dtype == np.int32 and np.array_equal(g, w), field
    assert len(got.dev.t_tab) and len(got.dev.t_dense) and len(got.dev.ip_tab)
    if name == "keys":
        assert len(np.unique(got.dev.t_keys.numpy())) >= 4, "several tabular keys"
    tensors = t_eng.tensorizer.freeze()
    assert tstate.compact_spec(tensors) is got  # memoized on the frozen tensors


@pytest.mark.parametrize("name", ["mixed", "keys"])
def test_compress_equals_jax_and_expand_inverts_it(name):
    """compress_state_plain equals simtpu's compress_state field by field on
    a really placed state, and expand_state_plain gives that state back."""
    j_eng, j_nodes, _ = _place(simtpu, name, compact=True)
    t_eng, t_nodes, _ = _place(simtpu_torch, name, compact=True)
    assert np.array_equal(t_nodes, j_nodes)
    j_tensors, t_tensors = j_eng.tensorizer.freeze(), t_eng.tensorizer.freeze()
    dense = j_eng.carried_state()
    want = jstate.compress_state(jstate.compact_spec(j_tensors).dev, dense)
    spec = tstate.compact_spec(t_tensors).dev
    got = tstate.compress_state_plain(spec, _port_dense(dense))
    _assert_equal(got, want, "compress")
    assert got.cm_tab.dtype == torch.int32 and got.sdev_free.dtype == torch.bool
    back = tstate.expand_state_plain(spec, got, tstate.node_dom_small_for(t_tensors, t_tensors.n_nodes,
                                                                          "cpu"))
    _assert_equal(back, dense, "expand")
    assert tstate.diff_state_planes(tstate.ensure_dense(got, t_tensors), _port_dense(dense)) == []
    # the engine's own carry is the same compact state
    assert isinstance(t_eng.last_state, tstate.CompactState)
    _assert_equal(t_eng.last_state, want, "engine carry")


def _entries_of(eng, indices):
    ext = eng.ext_log
    return [(eng.placed_group[i], eng.placed_node[i], eng.placed_req[i], ext["node"][i],
             ext["vg_alloc"][i], ext["sdev_take"][i], ext["gpu_shares"][i], ext["gpu_mem"][i])
            for i in indices]


def _pack(pkg, tensors, entries, sign):
    ext = tensors.ext
    return _mod(pkg, "engine.state").pack_delta_entries(
        entries, tensors.alloc.shape[1], ext.vg_cap.shape[1], ext.sdev_cap.shape[1],
        ext.gpu_dev_total.shape[1], sign)


@pytest.mark.parametrize("name,expect_dense", [("tabular", False), ("wide", True)])
def test_compact_delta_equals_jax(name, expect_dense):
    """-A, -B, +A out of stack order, +B, -B: the port's direct compact
    delta (K13's plain version) against the JAX package's direct apply and
    against the port's expand -> K7 plain -> compress route, every step."""
    j_eng, j_nodes, _ = _place(simtpu, name, compact=True, batches=1)
    t_eng, t_nodes, _ = _place(simtpu_torch, name, compact=True, batches=1)
    assert np.array_equal(t_nodes, j_nodes)
    j_tensors, t_tensors = j_eng.tensorizer.freeze(), t_eng.tensorizer.freeze()
    n = t_tensors.n_nodes
    j_statics = jscan.statics_from(j_tensors, None)
    t_statics = tscan.statics_from(t_tensors, None, "cpu")
    j_spec = jstate.compact_spec(j_tensors).dev
    t_spec = tstate.compact_spec(t_tensors).dev
    dspec = tstate.compact_delta_spec(t_tensors)
    ndom, nds = tstate.node_dom_for(t_tensors, n, "cpu"), tstate.node_dom_small_for(t_tensors, n, "cpu")
    j_direct = jstate.compress_state(j_spec, j_eng.carried_state())
    direct = tstate.compress_state_plain(t_spec, t_eng.carried_state())
    _assert_equal(direct, j_direct, "start")
    assert (direct.cm_dense.shape[0] > 0) == expect_dense
    m = len(t_eng.placed_node)
    a_idx, b_idx = list(range(0, m, 4)), list(range(1, m, 4))
    assert len(a_idx) >= 4 and len(b_idx) >= 4
    route = tstate.compress_state_plain(t_spec, t_eng.carried_state())
    for step, (idx, sign) in enumerate(((a_idx, -1.0), (b_idx, -1.0), (a_idx, 1.0), (b_idx, 1.0),
                                        (b_idx, -1.0))):
        j_direct = jstate.apply_placement_deltas_compact(
            j_statics, jstate.compact_delta_spec(j_tensors), jstate.node_dom_for(j_tensors, n),
            jstate.node_dom_small_for(j_tensors, n), j_direct,
            _pack(simtpu, j_tensors, _entries_of(j_eng, idx), sign))
        packed = _pack(simtpu_torch, t_tensors, _entries_of(t_eng, idx), sign)
        tstate.apply_placement_deltas_compact(t_statics, dspec, ndom, nds, direct, packed)
        _assert_equal(direct, j_direct, f"step {step} vs JAX")
        dense = tstate.expand_state_plain(t_spec, route, nds)
        tstate.apply_placement_deltas_plain(t_statics, dense, packed)
        route = tstate.compress_state_plain(t_spec, dense)
        _assert_equal(direct, route, f"step {step} vs expand -> K7 -> compress")
    moved = [f for f, a, b in zip(direct._fields, _np(direct).values(),
                                  _np(tstate.compress_state_plain(t_spec, t_eng.carried_state())).values())
             if not np.array_equal(a, b)]
    assert {"free", "cm_tab", "cnt_total"} <= set(moved), moved


def _jax_counts() -> dict:
    snap = REGISTRY.snapshot("state.")
    return {k: snap.get(f"state.{k}", 0) for k in tstate.STATE_COUNT_KEYS}


@pytest.mark.parametrize("speculate", [False, True], ids=["wavefront-off", "wavefront-on"])
@pytest.mark.parametrize("name", ["mixed", "keys"])
def test_engine_ab(name, speculate):
    """Two batches: the port with the compact carry on equals the JAX
    engine with it on and the port with it off (placements, reasons, the
    carried state); the second batch expands the stored carry, and the
    port's counts equal the JAX package's counters."""
    j0, t0 = _jax_counts(), tstate.state_counts()
    j_eng, j_nodes, j_reasons = _place(simtpu, name, compact=True, speculate=speculate)
    j_counts = {k: v - j0[k] for k, v in _jax_counts().items()}
    t_eng, t_nodes, t_reasons = _place(simtpu_torch, name, compact=True, speculate=speculate)
    t_counts = {k: v - t0[k] for k, v in tstate.state_counts().items()}
    assert t_counts == j_counts == {"compress": 2, "expand": 1, "delta_direct": 0}
    off, off_nodes, off_reasons = _place(simtpu_torch, name, compact=False, speculate=speculate)
    assert isinstance(t_eng.last_state, tstate.CompactState)
    assert isinstance(off.last_state, tstate.SchedState)
    assert np.array_equal(t_nodes, j_nodes) and np.array_equal(t_reasons, j_reasons)
    assert np.array_equal(off_nodes, j_nodes) and np.array_equal(off_reasons, j_reasons)
    carried = t_eng.carried_state()
    _assert_equal(carried, j_eng.carried_state(), "carried_state vs JAX")
    _assert_equal(carried, off.carried_state(), "carried_state vs the dense carry")
    # the divergence witness names the plane a corrupted carry differs in
    carried.cnt_match[0, 0] += 1.0
    assert tstate.diff_state_planes(carried, off.carried_state()) == ["cnt_match: max|d|=1"]


def _preempt_problem(pkg):
    """tests/test_preemption.py's compact preemption case (24 nodes in 4
    zones, a zone-spread low tier squeezed by a high-priority tier)."""
    synth = _mod(pkg, "synth")
    n = 24
    cluster = pkg.ResourceTypes()
    cluster.nodes = [synth.make_node(f"node-{i:06d}", 4000, 16,
                                     {"topology.kubernetes.io/zone": f"zone-{i % 4}",
                                      "kubernetes.io/hostname": f"node-{i:06d}"}) for i in range(n)]
    low = synth.make_deployment("low", n * 4, 1000, 512, priority=10,
                                spread_topo="topology.kubernetes.io/zone")
    high = synth.make_deployment("high", 16, 2000, 1024, priority=1000,
                                 spread_topo="topology.kubernetes.io/zone")
    return cluster, [pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[low])),
                     pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[high]))]


def _outcome(result):
    placed = tuple(sorted((p["metadata"]["name"], p["spec"].get("nodeName"))
                          for st in result.node_status for p in st.pods))
    evicted = tuple(sorted(p.pod["metadata"]["name"] for p in result.preempted_pods))
    unsched = tuple(sorted(u.pod["metadata"]["name"] for u in result.unscheduled_pods))
    return placed, evicted, unsched


def test_preemption_under_compact_rides_the_direct_delta(monkeypatch):
    """The serial path of tests/test_preemption.py's
    test_preemption_under_compact_rides_direct_delta: evictions and
    restores go straight into the compact carry (K13's plain version, no
    K7), the compress / expand / direct-delta counts equal the JAX
    package's counters over the same run, and so does the outcome."""
    monkeypatch.setenv("SIMTPU_DELTA_DIRECT", "1")
    engines = []

    class Recording(tscan.Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(simtpu_torch.api, "Engine", Recording)
    outcomes, counts = [], []
    for pkg in (simtpu, simtpu_torch):
        _mod(pkg, "workloads.expand").seed_name_hashes(3)
        before = _jax_counts() if pkg is simtpu else tstate.state_counts()
        plain0 = dict(cuda.PLAIN_CALLS)
        try:
            kw = {} if pkg is simtpu else {"device": "cpu"}
            outcomes.append(_outcome(pkg.simulate(*_preempt_problem(pkg), **kw)))
        finally:
            _mod(pkg, "workloads.expand").seed_name_hashes(None)
        after = _jax_counts() if pkg is simtpu else tstate.state_counts()
        counts.append({k: after[k] - before[k] for k in after})
    assert outcomes[1] == outcomes[0]
    assert outcomes[0][1], "the scenario must preempt"
    assert counts[1] == counts[0] and counts[0]["delta_direct"] > 0, counts
    calls = {k: cuda.PLAIN_CALLS[k] - plain0.get(k, 0) for k in ("compact_delta", "delta_apply")}
    assert calls["compact_delta"] == counts[1]["delta_direct"] and calls["delta_apply"] == 0, calls
    assert isinstance(engines[-1].last_state, tstate.CompactState)


def _hostname_problem(pkg):
    """The compact preemption case keyed by hostname on 72 nodes: more
    domains than DOM_SMALL, so no count row is tabular."""
    cluster, _ = _preempt_problem(pkg)
    synth = _mod(pkg, "synth")
    host = "kubernetes.io/hostname"
    cluster.nodes = [synth.make_node(f"node-{i:06d}", 4000, 16, {host: f"node-{i:06d}"})
                     for i in range(72)]
    low = synth.make_deployment("low", 72 * 4, 1000, 512, priority=10, spread_topo=host)
    high = synth.make_deployment("high", 16, 2000, 1024, priority=1000, spread_topo=host)
    return cluster, [pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[low])),
                     pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[high]))]


def test_no_tabular_row_carries_dense(monkeypatch):
    """With no topology key of DOM_SMALL or fewer domains the spec is
    disabled: both packages carry the dense state, compress nothing, and
    the port's preemption deltas take K7 (its plain version here)."""
    engines = []

    class Recording(tscan.Engine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(simtpu_torch.api, "Engine", Recording)
    outcomes, counts = [], []
    for pkg in (simtpu, simtpu_torch):
        _mod(pkg, "workloads.expand").seed_name_hashes(3)
        before = _jax_counts() if pkg is simtpu else tstate.state_counts()
        plain0 = dict(cuda.PLAIN_CALLS)
        try:
            kw = {} if pkg is simtpu else {"device": "cpu"}
            outcomes.append(_outcome(pkg.simulate(*_hostname_problem(pkg), **kw)))
        finally:
            _mod(pkg, "workloads.expand").seed_name_hashes(None)
        after = _jax_counts() if pkg is simtpu else tstate.state_counts()
        counts.append({k: after[k] - before[k] for k in after})
    assert outcomes[1] == outcomes[0] and outcomes[0][1], "equal, and the scenario must preempt"
    assert counts[1] == counts[0] == {"compress": 0, "expand": 0, "delta_direct": 0}
    eng = engines[-1]
    assert not tstate.compact_spec(eng.tensorizer.freeze()).enabled
    assert eng.compact and isinstance(eng.last_state, tstate.SchedState)
    assert cuda.PLAIN_CALLS["delta_apply"] > plain0.get("delta_apply", 0)
    assert cuda.PLAIN_CALLS["compact_delta"] == plain0.get("compact_delta", 0)


def test_carried_bytes_equal_the_jax_gauge():
    """TestBytesShrink's problem: state_nbytes of the port's carry equals
    the JAX gauge's carried bytes and per-plane sizes, and the port's
    gauge equals it whole."""
    _place(simtpu, "bytes", compact=True)
    want = family("state", jstate.STATE_KEYS)
    eng, _, _ = _place(simtpu_torch, "bytes", compact=True)
    got = tstate.state_nbytes(eng.last_state)
    assert want["compact"] is True and got == want["planes"]
    assert sum(got.values()) == want["carried_bytes"] < want["dense_bytes"]
    assert tstate.STATE_GAUGE == {k: want[k] for k in jstate.STATE_KEYS}
    dense = tstate.state_nbytes(eng.carried_state())
    assert sum(dense.values()) == want["dense_bytes"]


@pytest.mark.parametrize("speculate", [False, True], ids=["wavefront-off", "wavefront-on"])
def test_failed_batch_leaves_the_compact_carry_intact(speculate, monkeypatch):
    """tests/test_compact.py TestDonatedReuseGuard on the port's in-place
    engine: a batch that raises part-way leaves the compact carry bit for
    bit as it was and marks it dirty; the next place() rebuilds from the
    log and lands the JAX package's placements."""
    _, want_nodes, want_reasons = _place(simtpu, "mixed", compact=True, speculate=speculate)
    cluster, pods = _mixed(simtpu_torch)
    half = len(pods) // 2
    tz = simtpu_torch.core.tensorize.Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    eng = tscan.Engine(tz, "cpu")
    eng.speculate = speculate
    eng.place(tz.add_pods(pods[:half]))
    carry = eng.last_state
    assert isinstance(carry, tstate.CompactState) and not eng._state_dirty
    before = tstate.CompactState(*(t.clone() for t in carry))
    real_pods, real_waves = tscan.run_pods, twf.run_batch_waves

    def half_then_boom(buf, *a, **kw):
        tscan.run_pods(buf, 0, buf.n_pods // 2)  # the dense state really moves
        raise RuntimeError("injected failure part-way")

    monkeypatch.setattr(tscan, "run_batch", half_then_boom)
    monkeypatch.setattr(twf, "run_batch_waves", half_then_boom)
    b2 = tz.add_pods(pods[half:])
    assert eng.state_vocab(tz.freeze()) == eng._last_vocab
    with pytest.raises(RuntimeError, match="part-way"):
        eng.place(b2)
    assert eng._state_dirty and eng.last_state is carry
    _assert_equal(carry, before, "the carry after the failed batch")
    with pytest.raises(ValueError, match="no longer reflects"):
        eng.carried_state()
    monkeypatch.setattr(tscan, "run_batch", lambda buf: real_pods(buf, 0, buf.n_pods))
    monkeypatch.setattr(twf, "run_batch_waves", real_waves)
    expands = tstate.state_counts()["expand"]
    n2, r2, _ = eng.place(b2)  # rebuilds from the log
    assert tstate.state_counts()["expand"] == expands
    assert np.array_equal(n2, want_nodes[half:]) and np.array_equal(r2, want_reasons[half:])
    assert not eng._state_dirty and isinstance(eng.last_state, tstate.CompactState)


def test_expansion_shares_no_storage_with_the_carry():
    """expand_state writes fresh planes: no dense plane shares storage with
    any plane of the CompactState it reads (the continuous ones included),
    so the kernels' in-place updates never reach the carry."""
    eng, _, _ = _place(simtpu_torch, "mixed", compact=True)
    carry = eng.last_state
    dense = eng.carried_state()
    ptrs = {t.untyped_storage().data_ptr() for t in carry if t.numel()}
    for name, t in zip(dense._fields, dense):
        if t.numel():
            assert t.untyped_storage().data_ptr() not in ptrs, name
    dense.free.add_(1.0)
    dense.sdev_free.logical_not_()
    again = eng.carried_state()
    assert not torch.equal(again.free, dense.free) and not torch.equal(again.sdev_free, dense.sdev_free)


def test_compact_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """K11-K13's wrappers run their plain versions on CPU tensors (counted
    as such) and launch nothing; the argument block checks its tensors."""
    eng, _, _ = _place(simtpu_torch, "tabular", compact=True, batches=1)
    tensors = eng.tensorizer.freeze()
    n = tensors.n_nodes
    spec = tstate.compact_spec(tensors).dev
    nds = tstate.node_dom_small_for(tensors, n, "cpu")
    before_plain, before_launch = dict(cuda.PLAIN_CALLS), dict(cuda.LAUNCHES)
    cstate = tstate.compress_state(spec, eng.carried_state())
    tstate.expand_state(spec, cstate, nds)
    packed = _pack(simtpu_torch, tensors, _entries_of(eng, [0, 1]), -1.0)
    tstate.apply_placement_deltas_compact(tscan.statics_from(tensors, None, "cpu"),
                                          tstate.compact_delta_spec(tensors),
                                          tstate.node_dom_for(tensors, n, "cpu"), nds, cstate, packed)
    for name in ("compact_compress", "compact_expand", "compact_delta"):
        # carried_state() above expanded once more
        want = 2 if name == "compact_expand" else 1
        assert cuda.PLAIN_CALLS[name] - before_plain.get(name, 0) == want, name
        assert cuda.LAUNCHES.get(name, 0) == before_launch.get(name, 0)
    # the three argument blocks, built on these CPU tensors without a launch
    dense = eng.carried_state()
    ctx, _, out = cuda.compress_ctx(spec, dense)
    assert (ctx.n, ctx.t, ctx.rt, ctx.d) == (n, tensors.n_terms, spec.t_tab.shape[0], spec.t_rep.shape[1])
    assert ctx.cnt_match == dense.cnt_match.data_ptr() and ctx.cm_tab == out["cm_tab"].data_ptr()
    assert out["free"] is dense.free and ctx.nds is None and ctx.g is None
    ctx, out = cuda.expand_ctx(spec, cstate, nds)
    assert ctx.nds == nds.data_ptr() and ctx.k == nds.shape[0] and ctx.cm_tab == cstate.cm_tab.data_ptr()
    assert ctx.free == out["free"].data_ptr() and ctx.c_free == cstate.free.data_ptr()
    ndom = tstate.node_dom_for(tensors, n, "cpu")
    ctx, entries = cuda.delta_ctx(tscan.statics_from(tensors, None, "cpu"),
                                  tstate.compact_delta_spec(tensors), ndom, nds, cstate, packed)
    assert ctx.node_dom == ndom.data_ptr() and ctx.nds == nds.data_ptr()
    assert ctx.e == len(packed[0]) and ctx.g == entries["g"].data_ptr()
    assert ctx.c_cnt_total == cstate.cnt_total.data_ptr() and ctx.free is None
    with pytest.raises(ValueError, match="ip_rep"):
        cuda.compress_ctx(spec._replace(ip_rep=spec.ip_rep[:, :1].contiguous()), dense)
    with pytest.raises(ValueError, match="t_keys"):
        cuda.expand_ctx(spec._replace(t_keys=spec.t_keys.long()), cstate, nds)


@pytest.mark.parametrize("config,extra", [("examples/simtpu-config.yaml", []),
                                          ("examples/simtpu-storage-config.yaml", ["-e", "open-local"])],
                         ids=["demo", "storage"])
def test_plan_engine_record_equals_the_jax_json_block(monkeypatch, capsys, config, extra):
    """`apply --json`: the engine block's compact, delta_direct (applied,
    expand, compress) and state_bytes equal the JAX package's, and each
    candidate records `compact` from the engines it built."""
    from importlib import import_module

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    monkeypatch.chdir(REPO)
    docs = []
    for pkg in (simtpu, simtpu_torch):
        pkg.workloads.expand.seed_name_hashes(23)
        try:
            rc = import_module(f"{pkg.__name__}.cli").main(
                ["apply", "-f", config, *extra, "--json"] + ([] if pkg is simtpu else ["--device", "cpu"]))
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        assert rc == 0
        docs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1])["engine"])
    want, got = docs
    assert got["compact"] == want["compact"]
    assert got["delta_direct"] == {k: want["delta_direct"][k] for k in ("applied", "expand", "compress")}
    assert got["state_bytes"] == want["state_bytes"]
    assert got["delta_direct"]["compress"] > 0


def test_audit_fallback_carries_dense(monkeypatch):
    """The audit fallback's serial-exact engine runs with the compact carry
    off, as the JAX package's does; the primary candidates carry compact."""
    from simtpu_torch.plan import capacity as tcap

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    synth = _mod(simtpu_torch, "synth")
    zone = {"topology.kubernetes.io/zone": "z0"}
    cluster = simtpu_torch.ResourceTypes(nodes=[
        synth.make_node(f"n-{i}", 4000, 8, {"kubernetes.io/hostname": f"n-{i}", **zone}) for i in range(2)])
    apps = [simtpu_torch.AppResource(name="a", resource=simtpu_torch.ResourceTypes(deployments=[
        synth.make_deployment("a", 24, 1000, 1024, spread_topo="topology.kubernetes.io/zone")]))]
    template = synth.make_node("template", 4000, 8, {"kubernetes.io/hostname": "template", **zone})
    plan = tcap.plan_capacity(cluster, apps, template, 8, device="cpu", _audit_inject=True)
    assert plan.success and plan.candidates[-1]["fallback"] is True
    assert [c["compact"] for c in plan.candidates] == [not c["fallback"] for c in plan.candidates]
    # the last carry stored is the fallback's, dense
    assert tstate.STATE_GAUGE["compact"] is False


# -- 8. K11's row tasks and its one-buffer wrapper -----------------------------


def _smoke_carry(name: str, n_nodes: int, n_pods: int, seed: int):
    """A cut of chip_smoke.py's serial or extended problem on `n_nodes`
    nodes, tensorized, and a dense state rebuilt from a seeded log of
    random groups on random nodes."""
    synth = _mod(simtpu_torch, "synth")
    if name == "serial":
        cluster, apps = smoke.smoke_problem(synth.synth_cluster, synth.synth_apps, n_nodes=n_nodes, n_pods=n_pods)
    else:
        cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes,
                                               n_nodes=n_nodes, n_pods=n_pods)
    pods = [p for a in apps for p in _mod(simtpu_torch, "workloads.expand").get_valid_pods_exclude_daemonset(
        a.resource)]
    tz = simtpu_torch.core.tensorize.Tensorizer(cluster.nodes, storage_classes=list(cluster.storage_classes))
    tz.add_pods(pods)
    tensors = tz.freeze()
    rng = np.random.default_rng(seed)
    k = 4 * n_pods
    state = tstate.build_state(tensors, rng.integers(0, len(tensors.groups), k).astype(np.int32),
                               rng.integers(0, tensors.n_nodes, k).astype(np.int32),
                               np.zeros((k, tensors.alloc.shape[1]), np.float32), None, "cpu")
    return tensors, state


def _carry_of(name: str):
    if name in ("serial", "extended"):
        return _smoke_carry(name, 120, 600, 5)
    if name == "serial N % 4 = 3":
        return _smoke_carry("serial", 103, 400, 6)
    eng, _, _ = _place(simtpu_torch, name, compact=True, batches=1)
    return eng.tensorizer.freeze(), eng.carried_state()


def _emulate_k11(spec, state, setup, out) -> np.ndarray:
    """K11's task table run in numpy into `out` (compress_ctx's planes);
    returns how many times each narrowed byte was written (per plane)."""
    tasks, gather = setup["tasks"].numpy(), setup["gather"].numpy()
    planes = ("cnt_match", "cnt_own_anti", "cnt_own_aff", "w_own_aff_pref", "w_own_anti_pref")
    tab, dense = [f for f, *_ in tstate.COMPACT_PLANES], [f for _, f, _ in tstate.COMPACT_PLANES]
    casts = ("cnt_total", "ports_used", "vols_any", "vols_rw")
    writes = {f: np.zeros(out[f].numel(), np.int64) for f in cuda.NARROW_FIELDS}
    for word, src, dst, length in tasks:
        kind, q = word >> 3, word & 7
        assert 0 < length <= 4 * cuda.COMPRESS_THREADS * setup["plan"].tiles * (4 if kind == cuda.CT_BYTES else 1)
        if kind == cuda.CT_GATHER:
            f, full = tab[q], getattr(state, planes[q]).numpy().reshape(-1)
            at = gather[src:src + length]
            vals = np.where(at >= 0, full[np.maximum(at, 0)], 0).astype(np.int32)
        elif kind == cuda.CT_DENSE:
            f = dense[q]
            vals = getattr(state, planes[q]).numpy().reshape(-1)[src:src + length].astype(np.int32)
        elif kind == cuda.CT_CAST:
            f = casts[q]
            vals = getattr(state, f).numpy().reshape(-1)[src:src + length].astype(np.int32)
        else:
            f = "sdev_free"
            vals = state.sdev_free.numpy().reshape(-1)[src:src + length]
        out[f].reshape(-1)[dst:dst + length] = torch.from_numpy(np.ascontiguousarray(vals))
        writes[f][dst:dst + length] += 1
    return writes


@pytest.mark.parametrize("name", ["serial", "extended", "serial N % 4 = 3", "mixed", "tabular", "wide"])
def test_k11_row_tasks_equal_the_plain_compress(name):
    """K11's task table (`cuda.compress_plan`), run in numpy, writes every
    narrowed element exactly once and gives compress_state_plain's
    CompactState field for field; the dense planes N % 4 != 0 leaves
    misaligned are among them."""
    tensors, state = _carry_of(name)
    spec = tstate.compact_spec(tensors).dev
    want = tstate.compress_state_plain(spec, state)
    ctx, _, out = cuda.compress_ctx(spec, state)
    setup = cuda._compress_setup(spec, state)
    writes = _emulate_k11(spec, state, setup, out)
    for f, w in writes.items():
        assert (w == 1).all(), f  # every element once
    _assert_equal(tstate.CompactState(**out), want, name)
    n = tensors.n_nodes
    assert (n % 4 == 3) == (name == "serial N % 4 = 3")
    kinds = set(setup["tasks"].numpy()[:, 0] >> 3)
    assert {cuda.CT_GATHER, cuda.CT_CAST} <= kinds and (cuda.CT_DENSE in kinds) == bool(
        spec.t_dense.numel() + spec.ip_dense.numel())
    # no per-element division: a dense row is one task, its source row's
    # offset folded in on the host
    dense_tasks = setup["tasks"].numpy()[setup["tasks"].numpy()[:, 0] >> 3 == cuda.CT_DENSE]
    assert (dense_tasks[:, 3] == n).all() and (dense_tasks[:, 1] % n == 0).all()


def test_k11_one_buffer_wrapper_gives_aligned_planes_apart(monkeypatch):
    """launch_compact_compress with a recording stand-in for the library:
    one launch with the plan the setup holds, the narrowed planes 16-byte
    aligned views of one buffer, apart, of the plain version's dtypes and
    shapes, the argument block pointing at them, free / vg_free / gpu_free
    the dense tensors; the spec's part checked and built once per spec."""
    tensors, state = _carry_of("serial N % 4 = 3")
    spec = tstate.compact_spec(tensors).dev
    want = tstate.compress_state_plain(spec, state)
    libs = {name: _FakeLib() for name in cuda.KERNELS}
    monkeypatch.setattr(cuda, "build", lambda: libs)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(cuda, "LAUNCHES", Counter())
    got = tstate.CompactState(**cuda.launch_compact_compress(spec, state))
    assert cuda.LAUNCHES == {"compact_compress": 1}
    (name, (ctx, plan, stream)), = libs["compact_compress"].calls
    ctx, plan = ctx._obj, plan._obj
    setup = cuda._compress_setup(spec, state)
    assert name == "simtpu_compact_compress" and stream == 7
    assert (plan.n_tasks, plan.tiles, plan.tasks, plan.gather) == (
        len(setup["tasks"]), setup["plan"].tiles, setup["tasks"].data_ptr(), setup["gather"].data_ptr())
    spans = []
    for f, t, w in zip(got._fields, got, want):
        assert t.dtype == w.dtype and t.shape == w.shape and t.is_contiguous(), f
        if f in cuda.NARROW_FIELDS and t.numel():  # an empty view has no address
            assert t.data_ptr() % 16 == 0, f
            assert getattr(ctx, cuda._NARROW_CTX.get(f, f)) == t.data_ptr(), f
            spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
        elif f not in cuda.NARROW_FIELDS:
            assert t is getattr(state, f), f  # handed over without a copy
    assert len({t.untyped_storage().data_ptr() for f, t in zip(got._fields, got) if f in cuda.NARROW_FIELDS}) == 1
    assert len(spans) >= 8
    spans.sort()
    assert all(b <= a for (_, b), (a, _) in zip(spans, spans[1:]))  # apart
    assert ctx.cnt_match == state.cnt_match.data_ptr() and ctx.t_rep == spec.t_rep.data_ptr()
    # built once per spec and shape: a second call reuses the setup, and
    # the state's planes are checked on every call
    cuda.launch_compact_compress(spec, state)
    assert cuda._compress_setup(spec, state) is setup and len(spec.t_tab._compress) == 1
    with pytest.raises(ValueError, match="cnt_match"):
        cuda.compress_ctx(spec, state._replace(cnt_match=state.cnt_match.double()))
    with pytest.raises(ValueError, match="free"):
        cuda.compress_ctx(spec, state._replace(free=state.free.t()))
