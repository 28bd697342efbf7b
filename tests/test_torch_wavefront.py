"""simtpu_torch's speculative wavefront against the JAX package, on the CPU.

The port's wave path (`simtpu_torch/engine/wavefront.py`: the planner, the
dispatcher and the plain versions of K9 `wave_lean` and K10 `wave_hard`)
is held against the JAX package on the same inputs:

1. whole batches on the constraint mixes of tests/test_wavefront.py: the
   port with the wavefront on against the JAX package's pod-at-a-time scan
   (nodes, reasons, extended plans, final state planes), the port's
   counters against the JAX package's `wavefront.*` counters with its
   wavefront on, and the wave path engaged;
2. the verifiers alone: `wave_lean_plain` / `wave_hard_plain` against the
   JAX package's `_run_wavefront` on one run, from the same numpy statics,
   state and pods — lean with and without the inter-pod preference carry,
   against the JAX lean verifier's tabular route (small and unique-per-node
   keys), hard spread, required anti-affinity, and each heavy bit (ports,
   volumes, storage, GPU);
3. rollback and the unplaced tails' reasons, mirrored from
   tests/test_wavefront.py;
4. heavy drafting on and off, and a gnarly fuzz case audit-clean;
5. the count carry on a topology key with more than DOM_SMALL domains
   that are not unique per node (the JAX lean verifier's generic route),
   and on more topology keys than a fixed per-key table would hold;
6. the wave plan of the serial smoke problem against the JAX package's
   `plan_scan_chunks`;
7. the engine switches, the planner's audit fallback (wavefront off), the
   plan's engine record, the wrappers' CPU dispatch and the wave kernels'
   argument block.

SIMTPU_WAVEFRONT=0 comes from conftest; every JAX engine here sets
`speculate` explicitly. Tests that audit use SIMTPU_AUDIT_JIT=0.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.engine.state import diff_state_planes
from simtpu.obs.metrics import family
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.engine import wavefront as twf
from simtpu_torch.kernels import cuda

from .fixtures import make_fake_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ("north", "hard", "priority", "matrix")


def _mod(pkg, name: str):
    """`pkg.<name>`, imported (simtpu or simtpu_torch)."""
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _jax_counts() -> dict:
    return family("wavefront", jscan.WAVE_KEYS)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _expand(pkg, apps):
    pods = []
    for app in apps:
        for pod in _mod(pkg, "workloads.expand").get_valid_pods_exclude_daemonset(app.resource):
            _mod(pkg, "core.objects").set_label(pod, _mod(pkg, "constants").LABEL_APP_NAME, app.name)
            pods.append(pod)
    return pods


def _mix_problem(pkg, mix: str, seed: int, n_nodes: int = 24):
    """tests/test_wavefront.py's problem: 24-replica runs under a mix."""
    hard, matrix = mix == "hard", mix == "matrix"
    cluster = _mod(pkg, "synth").synth_cluster(
        n_nodes, seed=seed, zones=3, taint_frac=0.1, storage_frac=0.4,
        gpu_frac=0.5 if matrix else 0.0,
    )
    apps = _mod(pkg, "synth").synth_apps(
        240, seed=seed + 1, zones=3, pods_per_deployment=24, selector_frac=0.2,
        toleration_frac=0.1, anti_affinity_frac=0.25,
        anti_affinity_hard_frac=0.4 if hard else 0.0, spread_frac=0.3,
        spread_hard_frac=0.5 if hard else 0.0, gpu_frac=0.25 if matrix else 0.0,
        gpu_multi_frac=0.5 if matrix else 0.0, storage_frac=0.25,
        storage_device_frac=0.0 if matrix else 0.3, lvm_multi_frac=0.5 if matrix else 0.0,
        affinity_frac=0.15 if matrix else 0.0,
    )
    if mix == "priority":
        for i, app in enumerate(apps):
            for dep in app.resource.deployments:
                dep["spec"]["template"]["spec"]["priority"] = (i % 4) * 100
    return cluster, apps


def _place(pkg, build, speculate: bool, heavy: bool = True, monkeypatch=None):
    """One engine placing the whole problem `build(pkg)` in one batch
    (`heavy` sets the JAX package's heavy drafting; the port always
    drafts). Returns (nodes, reasons, extras, final state as numpy)."""
    cluster, apps = build(pkg)
    _mod(pkg, "workloads.expand").seed_name_hashes(0)
    try:
        pods = _expand(pkg, apps)
    finally:
        _mod(pkg, "workloads.expand").seed_name_hashes(None)
    tz = _mod(pkg, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    batch = tz.add_pods(pods)
    if pkg is simtpu:
        monkeypatch.setenv("SIMTPU_WAVE_HEAVY", "1" if heavy else "0")
        eng = jscan.Engine(tz)
    else:
        eng = tscan.Engine(tz, "cpu")
    eng.speculate = speculate
    nodes, reasons, extras = eng.place(batch)
    state = eng.carried_state()
    if pkg is simtpu:
        state = type(state)(*(np.asarray(x) for x in state))
    else:
        state = tstate.state_to_numpy(state)
    return np.asarray(nodes), np.asarray(reasons), {k: np.asarray(v) for k, v in extras.items()}, state


def _planned(pkg, build, name_seed: int = 0):
    """(pod arrays, groups, tensors, flags) of the problem `build(pkg)`."""
    cluster, apps = build(pkg)
    _mod(pkg, "workloads.expand").seed_name_hashes(name_seed)
    try:
        pods = _expand(pkg, apps)
    finally:
        _mod(pkg, "workloads.expand").seed_name_hashes(None)
    tz = _mod(pkg, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    sc = jscan if pkg is simtpu else tscan
    _, arrays = sc.build_pod_arrays(batch, tensors.alloc.shape[1])
    return arrays, np.asarray(batch.group), tensors, sc.flags_from(tensors, batch.ext)


def _assert_same(got, want):
    assert np.array_equal(got[0], want[0]), "nodes"
    assert np.array_equal(got[1], want[1]), "reasons"
    for key in want[2]:
        assert np.array_equal(got[2][key], want[2][key]), key
    assert diff_state_planes(got[3], want[3]) == []


def assert_wave_identity(build, monkeypatch):
    """The port with the wavefront on against the JAX package's serial
    scan; the port's counter deltas against the JAX wavefront's. Returns
    (the port's counter deltas, its plain-call deltas, the result)."""
    want = _place(simtpu, build, False, True, monkeypatch)
    before = _jax_counts()
    jax_wave = _place(simtpu, build, True, True, monkeypatch)
    j_delta = _delta(_jax_counts(), before)
    _assert_same(jax_wave, want)
    before, plain = twf.wave_counts(), dict(cuda.PLAIN_CALLS)
    got = _place(simtpu_torch, build, True)
    t_delta = _delta(twf.wave_counts(), before)
    calls = _delta(dict(cuda.PLAIN_CALLS), plain)
    _assert_same(got, want)
    assert t_delta == j_delta
    assert calls.get("filter_pod", 0) == len(want[0]) - t_delta["pods"]
    assert calls.get("wave_lean", 0) + calls.get("wave_hard", 0) == t_delta["wavefronts"]
    assert not cuda.LAUNCHES
    return t_delta, calls, got


# -- 1. whole batches on the mixes -------------------------------------------


@pytest.mark.parametrize(
    "mix", [pytest.param(m, marks=pytest.mark.slow) if m == "matrix" else m for m in MIXES])
def test_wave_path_identical_to_jax_serial(mix, monkeypatch):
    t_delta, calls, _ = assert_wave_identity(lambda pkg: _mix_problem(pkg, mix, 7), monkeypatch)
    assert t_delta["pods"] > 0 and calls.get("wave_lean", 0) > 0
    if mix == "hard":
        assert calls.get("wave_hard", 0) > 0 and t_delta["draft_hard"] > 0


# -- 2. the verifiers alone against _run_wavefront ----------------------------


def _heavy_problem(pkg):
    """tests/test_wavefront.py's all-heavy mix plus a read-only volume
    deployment: every run carries a heavy bit."""
    cluster = _mod(pkg, "synth").synth_cluster(24, seed=17, zones=3, taint_frac=0.0, gpu_frac=0.6,
                                      storage_frac=0.6)
    mk = _mod(pkg, "synth").make_deployment
    vols = mk("vols", 12, 200, 128)
    vols["spec"]["template"]["spec"]["volumes"] = [
        {"name": "d", "gcePersistentDisk": {"pdName": "pd-shared", "readOnly": True}}]
    res = pkg.ResourceTypes(deployments=[
        mk("lvmy", 24, 500, 256, lvm_gib=5),
        mk("gpuey", 24, 500, 256, gpu_mem_mib=1024),
        mk("devy", 12, 300, 256, device_gib=10),
        mk("porty", 16, 100, 128, host_port=8080),
        vols,
    ])
    return cluster, [pkg.AppResource(name="heavy", resource=res)]


def _kind2_problem(pkg):
    """The north mix on 80 nodes: the hostname key is unique per node
    (kind 2), the zone key small (kind 1)."""
    return _mix_problem(pkg, "north", 3, n_nodes=80)


def _group_has(tensors, g: int, what: str) -> bool:
    row = {"spread_hard": tensors.spread_hard[g] > 0, "anti_req": tensors.a_anti_req[g]}[what]
    return bool(np.asarray(row).any())


#: case -> (problem, wave predicate over (tensors, group, hard, pref, heavy))
VERIFIER_CASES = {
    "lean": (lambda p: _mix_problem(p, "north", 7),
             lambda t, g, h, p, hv: not h and not p),
    "lean-pref": (lambda p: _mix_problem(p, "north", 7),
                  lambda t, g, h, p, hv: not h and p),
    "lean-kind2": (_kind2_problem, lambda t, g, h, p, hv: not h),
    "hard-spread": (lambda p: _mix_problem(p, "hard", 7),
                    lambda t, g, h, p, hv: h and not hv and _group_has(t, g, "spread_hard")),
    "anti-req": (lambda p: _mix_problem(p, "hard", 7),
                 lambda t, g, h, p, hv: h and not hv and _group_has(t, g, "anti_req")),
    "ports": (_heavy_problem, lambda t, g, h, p, hv: hv == twf.WAVE_HEAVY_PORTS),
    "volumes": (_heavy_problem, lambda t, g, h, p, hv: hv == twf.WAVE_HEAVY_VOLS),
    "storage": (_heavy_problem, lambda t, g, h, p, hv: hv == twf.WAVE_HEAVY_STORAGE),
    "gpu": (_heavy_problem, lambda t, g, h, p, hv: hv == twf.WAVE_HEAVY_GPU),
}


@pytest.mark.parametrize("case", sorted(VERIFIER_CASES))
def test_verifier_matches_run_wavefront(case):
    """One run through the JAX package's `_run_wavefront` and through the
    port's plain verifier, from a state seeded by a placement log: nodes,
    reasons, accepts, the heavy plans and every state plane equal."""
    build, pick = VERIFIER_CASES[case]
    pod_arrays, groups, tensors, flags = _planned(simtpu, build)
    pod_arrays = tuple(np.asarray(x) for x in pod_arrays)
    t_flags = tscan.StepFlags(**{k: v for k, v in flags._asdict().items() if k in tscan.StepFlags._fields})
    ok = twf.wave_eligibility(pod_arrays, groups, tensors)
    waves = [w for _, _, ws in twf.plan_waves(groups, tensors, t_flags, ok) for w in ws]
    a, b, hard, pref, heavy = next(w for w in waves if pick(tensors, int(groups[w[0]]), *w[2:]))
    spec = jscan.wave_static_spec(tensors, hard, pref, heavy)
    if case == "lean-kind2":
        assert spec[3] is not None and 2 in spec[3]
    # the state at the run's start: a seeded placement log
    rng = np.random.default_rng(5)
    k = 40
    log_g = rng.integers(0, len(tensors.groups), k).astype(np.int32)
    log_n = rng.integers(0, tensors.n_nodes, k).astype(np.int32)
    log_r = pod_arrays[1][rng.integers(0, len(groups), k)] * np.float32(0.5)
    state = jstate.build_state(tensors, log_g, log_n, log_r, None)
    statics = jscan.statics_from(tensors)
    state_np = type(state)(*(np.asarray(x) for x in state))
    buf = tscan.StepBuffers(
        tscan.statics_from_numpy(type(statics)(*(np.asarray(x) for x in statics)), "cpu"),
        tstate.state_from_numpy(state_np, "cpu"), pod_arrays, t_flags)
    j_state, outs, accepts = jscan._run_wavefront(
        statics, state, tuple(x[a:b] for x in pod_arrays), flags, *spec)
    (twf.wave_hard_plain if hard or heavy else twf.wave_lean_plain)(buf, a, b, (hard, pref, heavy))
    nodes = buf.out_node[a:b].numpy()
    assert np.array_equal(nodes, np.asarray(outs[0]))
    assert np.array_equal(buf.reason[a:b].numpy(), np.asarray(outs[1]))
    assert np.array_equal(nodes == nodes[0], np.asarray(accepts))
    for got, want in zip((buf.out_lvm, buf.out_take, buf.out_gpu), outs[2:]):
        assert np.array_equal(got[a:b].numpy(), np.asarray(want))
    assert diff_state_planes(tstate.state_to_numpy(buf.state),
                             type(j_state)(*(np.asarray(x) for x in j_state))) == []
    assert (nodes >= 0).any()


# -- 3. rollback and the unplaced tails -------------------------------------------


def _nodes(pkg, n: int, cpu: int = 4000, mem: int = 8):
    return [_mod(pkg, "synth").make_node(f"n-{i}", cpu, mem, {"kubernetes.io/hostname": f"n-{i}",
                                                     "topology.kubernetes.io/zone": "z0"})
            for i in range(n)]


def _burst(pkg, n_nodes: int, name: str = "burst"):
    cluster = pkg.ResourceTypes(nodes=_nodes(pkg, n_nodes))
    res = pkg.ResourceTypes(deployments=[_mod(pkg, "synth").make_deployment(name, 12, 1000, 1024)])
    return cluster, [pkg.AppResource(name=name, resource=res)]


def test_forced_conflict_rolls_back_to_serial_answer(monkeypatch):
    t_delta, _, got = assert_wave_identity(lambda pkg: _burst(pkg, 3), monkeypatch)
    assert t_delta["pods"] == 12 and t_delta["rollbacks"] >= 1 and t_delta["rollback_pods"] >= 1
    assert int((got[0] >= 0).sum()) == 12


def test_overflow_tail_reasons_exact(monkeypatch):
    _, _, got = assert_wave_identity(lambda pkg: _burst(pkg, 2, "over"), monkeypatch)
    assert int((got[0] < 0).sum()) == 4
    assert set(got[1][got[0] < 0]) == {tscan.FAIL_RESOURCES}


def _blocked(pkg):
    """A lean run emptied by an existing group's required anti-affinity."""
    cluster = pkg.ResourceTypes(nodes=_nodes(pkg, 4, 64000, 64))
    blocker = _mod(pkg, "synth").make_deployment("blk", 4, 250, 1)
    blocker["spec"]["template"]["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "labelSelector": {"matchLabels": {"app": "web"}},
            "topologyKey": "kubernetes.io/hostname"}]}}
    return cluster, [
        pkg.AppResource(name="blk", resource=pkg.ResourceTypes(deployments=[blocker])),
        pkg.AppResource(name="web", resource=pkg.ResourceTypes(
            deployments=[_mod(pkg, "synth").make_deployment("web", 8, 250, 1)])),
    ]


def test_interpod_blocked_tail_reason_exact(monkeypatch):
    _, _, got = assert_wave_identity(_blocked, monkeypatch)
    unplaced = got[0] < 0
    assert unplaced.sum() == 8 and set(got[1][unplaced]) == {tscan.FAIL_INTERPOD}


def test_counters_account_for_every_wavefront_pod(monkeypatch):
    t_delta, _, _ = assert_wave_identity(lambda pkg: _mix_problem(pkg, "north", 13), monkeypatch)
    assert t_delta["pods"] > 0
    assert t_delta["accepted"] + t_delta["rollback_pods"] == t_delta["pods"]
    assert t_delta["rollbacks"] <= t_delta["wavefronts"]


# -- 4. heavy drafting ------------------------------------------------------------


def test_all_heavy_mix_accepts_where_legacy_skips(monkeypatch):
    # heavy drafting off (the JAX package's SIMTPU_WAVE_HEAVY=0): its
    # wavefront drafts nothing and equals its serial scan, and the port's
    # heavy-off plan agrees with it pod for pod
    want = _place(simtpu, _heavy_problem, False, False, monkeypatch)
    before = _jax_counts()
    _assert_same(_place(simtpu, _heavy_problem, True, False, monkeypatch), want)
    assert _delta(_jax_counts(), before)["pods"] == 0
    j_arrays, j_groups, j_tensors, _ = _planned(simtpu, _heavy_problem)
    t_arrays, t_groups, t_tensors, t_flags = _planned(simtpu_torch, _heavy_problem)
    j_ok = jscan.wave_eligibility(j_arrays, j_groups, j_tensors)
    t_ok = twf.wave_eligibility(t_arrays, t_groups, t_tensors, heavy=False)
    assert np.array_equal(t_ok, j_ok)
    assert not any(w for _, _, w in twf.plan_waves(t_groups, t_tensors, t_flags, t_ok))
    # heavy drafting on, the port's engine's only mode
    t_on, calls_on, _ = assert_wave_identity(_heavy_problem, monkeypatch)
    assert t_on["pods"] > 0 and t_on["draft_hard"] > 0 and calls_on.get("wave_hard", 0) > 0
    assert 0 < t_on["accepted"] / t_on["pods"] <= 1


def test_fuzz_gnarly_mix_identical_and_audit_clean(monkeypatch):
    """audit/fuzz.gen_case seed 5 (storage, GPU, ports): the port with the
    wavefront on equals the JAX package's serial simulate(), its K10 runs,
    and the port's auditor certifies the placement."""
    from simtpu.audit.fuzz import gen_case

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    cluster, apps, mix = gen_case(5, n_nodes=16, n_pods=96)
    assert mix["gpu_frac"] or mix["storage_frac"] or mix["ports"]

    def jax_engine(tz):
        eng = jscan.Engine(tz)
        eng.speculate = False
        return eng

    _mod(simtpu, "workloads.expand").seed_name_hashes(3)
    try:
        want = _mod(simtpu_torch, "smoke").placement_record(
            simtpu.simulate(cluster, apps, engine_factory=jax_engine))
    finally:
        _mod(simtpu, "workloads.expand").seed_name_hashes(None)
    t_cluster = simtpu_torch.ResourceTypes(**vars(cluster))
    t_apps = [simtpu_torch.AppResource(name=a.name, resource=simtpu_torch.ResourceTypes(**vars(a.resource)))
              for a in apps]
    before = twf.wave_counts()
    _mod(simtpu_torch, "workloads.expand").seed_name_hashes(3)
    try:
        result = simtpu_torch.simulate(t_cluster, t_apps, device="cpu", audit=True)
    finally:
        _mod(simtpu_torch, "workloads.expand").seed_name_hashes(None)
    delta = _delta(twf.wave_counts(), before)
    assert _mod(simtpu_torch, "smoke").record_differences(_mod(simtpu_torch, "smoke").placement_record(result), want) == []
    assert delta["pods"] > 0 and delta["draft_hard"] > 0
    assert result.audit.ok, result.audit.summary()


# -- 5. the count carry on many domains and many keys -------------------------------


def _racks(pkg):
    """70 racks of 2-3 nodes: the rack key has more than DOM_SMALL domains
    and is not unique per node (kind 0); soft spread and preferred
    anti-affinity on it."""
    nodes = []
    for i in range(170):
        labels = {"kubernetes.io/hostname": f"n-{i}", "topology.kubernetes.io/zone": f"z{i % 3}",
                  "rack": f"r{i * 70 // 170}"}
        nodes.append(_mod(pkg, "synth").make_node(f"n-{i}", 8000, 16, labels))
    mk = _mod(pkg, "synth").make_deployment
    res = pkg.ResourceTypes(deployments=[
        mk("spready", 40, 500, 512, spread_topo="rack"),
        mk("shy", 30, 700, 256, anti_affinity_topo="rack"),
        mk("zonal", 24, 300, 128, spread_topo="topology.kubernetes.io/zone"),
    ])
    return pkg.ResourceTypes(nodes=nodes), [pkg.AppResource(name="racks", resource=res)]


def test_generic_carry_identical_to_jax_serial(monkeypatch):
    cluster, apps = _racks(simtpu_torch)
    tz = _mod(simtpu_torch, "core.tensorize").Tensorizer(cluster.nodes)
    tz.add_pods(_expand(simtpu_torch, apps))
    tensors = tz.freeze()
    assert 0 in tensors.key_kind.tolist()
    assert jscan.wave_static_spec(tensors, False, True)[3] is None
    t_delta, calls, _ = assert_wave_identity(_racks, monkeypatch)
    assert calls.get("wave_lean", 0) > 0 and t_delta["pods"] > 0


def _many_keys(pkg):
    """smoke.keys_problem at 30 nodes: 22 topology keys, soft spread,
    preferred anti-affinity and hard spread on 20 of them."""
    return _mod(simtpu_torch, "smoke").keys_problem(_mod(pkg, "synth"), pkg.AppResource, pkg.ResourceTypes,
                                                    n_nodes=30, replicas=12)


def test_many_topology_keys_identical_to_jax_serial(monkeypatch):
    t_delta, calls, _ = assert_wave_identity(_many_keys, monkeypatch)
    assert calls.get("wave_lean", 0) > 0 and calls.get("wave_hard", 0) > 0
    # the argument block takes every key (K9 sizes its table at the launch)
    arrays, groups, tensors, flags = _planned(simtpu_torch, _many_keys)
    assert tensors.node_dom.shape[0] > 16
    statics = tscan.statics_from(tensors, None, torch.device("cpu"))
    state = tstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), np.float32), None, "cpu")
    buf = tscan.StepBuffers(statics, state, arrays, flags)
    waves = [w for _, _, ws in twf.plan_waves(groups, tensors, flags, twf.wave_eligibility(arrays, groups, tensors))
             for w in ws]
    for a, b, hard, pref, heavy in waves[:2]:
        ctx = cuda.make_wave_ctx(buf, a, b, (hard, pref, heavy))
        assert ctx.k == tensors.node_dom.shape[0]


# -- 6. the plan ------------------------------------------------------------------


def test_wave_plan_of_the_smoke_problem_matches_jax():
    smoke = _mod(simtpu_torch, "smoke")
    plans = []
    for pkg in (simtpu, simtpu_torch):
        arrays, groups, tensors, flags = _planned(
            pkg, lambda p: smoke.smoke_problem(_mod(p, "synth").synth_cluster, _mod(p, "synth").synth_apps),
            smoke.NAME_SEED)
        if pkg is simtpu:
            ok = jscan.wave_eligibility(arrays, groups, tensors)
            plans.append([(c0, c1, waves) for c0, c1, _, _, waves in
                          jscan.plan_scan_chunks(groups, tensors, flags, wave_ok=ok)])
        else:
            ok = twf.wave_eligibility(arrays, groups, tensors)
            plans.append(twf.plan_waves(groups, tensors, flags, ok))
    want, got = plans
    assert got == want
    assert sum(len(w) for _, _, w in got) > 100


# -- 7. switches, the planner's fallback, the wrappers ------------------------------


def test_speculate_off_runs_no_wave():
    def engine(tz, device):
        eng = tscan.Engine(tz, device)
        eng.speculate = False
        return eng

    cluster, apps = _mix_problem(simtpu_torch, "north", 7)
    before, plain = twf.wave_counts(), dict(cuda.PLAIN_CALLS)
    simtpu_torch.simulate(cluster, apps, engine_factory=engine, device="cpu")
    calls = _delta(dict(cuda.PLAIN_CALLS), plain)
    assert _delta(twf.wave_counts(), before)["wavefronts"] == 0
    assert not calls.get("wave_lean") and not calls.get("wave_hard") and calls["filter_pod"] > 0


def test_audit_fallback_runs_with_the_wavefront_off(monkeypatch):
    """The injected divergence: every primary candidate runs waves, the
    certified re-run none; the plan ships the re-run."""
    from simtpu_torch.plan import capacity as tcap

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    calls = []
    orig = tcap.simulate

    def recording(*a, **kw):
        before = twf.wave_counts()
        out = orig(*a, **kw)
        calls.append(_delta(twf.wave_counts(), before)["pods"])
        return out

    monkeypatch.setattr(tcap, "simulate", recording)
    cluster = simtpu_torch.ResourceTypes(nodes=[
        _mod(simtpu_torch, "synth").make_node(f"n-{i}", 4000, 8, {"kubernetes.io/hostname": f"n-{i}"})
        for i in range(2)])
    apps = [simtpu_torch.AppResource(name="a", resource=simtpu_torch.ResourceTypes(
        deployments=[_mod(simtpu_torch, "synth").make_deployment("a", 24, 1000, 1024)]))]
    template = make_fake_node("template", "4", "8Gi")
    plan = tcap.plan_capacity(cluster, apps, template, 8, device="cpu", _audit_inject=True)
    assert plan.success and plan.audit["fallback"] is True and plan.audit["ok"] is True
    assert plan.candidates[-1]["fallback"] is True
    assert len(calls) == len(plan.candidates)
    assert [c["speculate"] for c in plan.candidates] == [not c["fallback"] for c in plan.candidates]
    fallback = [pods for pods, c in zip(calls, plan.candidates) if c["fallback"]]
    primary = [pods for pods, c in zip(calls, plan.candidates) if not c["fallback"]]
    assert fallback == [0] and primary and all(p > 0 for p in primary)


def test_plan_engine_record_reports_the_wavefront(monkeypatch, capsys):
    from simtpu_torch.cli import main

    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    monkeypatch.chdir(REPO)
    assert main(["apply", "-f", "examples/simtpu-config.yaml", "--json", "--device", "cpu"]) == 0
    engine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["engine"]
    assert engine["speculate"] is True and engine["wave_heavy"] is True
    assert set(engine["wavefront"]) == set(twf.WAVE_KEYS)
    wf = engine["wavefront"]
    assert wf["accepted"] + wf["rollback_pods"] == wf["pods"]


def test_wave_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors run_batch_waves launches nothing: each wave runs its
    plain version, the pods between waves K1-K4's."""
    cluster, apps = _mix_problem(simtpu_torch, "hard", 7)
    pods = _expand(simtpu_torch, apps)
    tz = _mod(simtpu_torch, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, arrays = tscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    statics = tscan.statics_from(tensors, None, torch.device("cpu"))
    state = tstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), np.float32), None, "cpu")
    buf = tscan.StepBuffers(statics, state, arrays, tscan.flags_from(tensors, batch.ext))
    plain, launches = dict(cuda.PLAIN_CALLS), dict(cuda.LAUNCHES)
    waves = twf.run_batch_waves(buf, tensors, np.asarray(batch.group), arrays)
    calls = _delta(dict(cuda.PLAIN_CALLS), plain)
    hard = sum(1 for _, _, h in waves if h)
    assert calls["wave_hard"] == hard and calls["wave_lean"] == len(waves) - hard
    assert calls["filter_pod"] == len(arrays[0]) - sum(b - a for a, b, _ in waves)
    assert dict(cuda.LAUNCHES) == launches


def test_ctypes_wave_ctx_mirrors_the_cuda_header():
    header = (cuda.CSRC / "step_ctx.cuh").read_text()
    body = header[header.index("struct WaveCtx {"):]
    body = body[: body.index("};")]
    ints = re.search(r"int ([\w, ]+);", body).group(1).replace(" ", "").split(",")
    ptrs = re.findall(r"\*\s*(\w+);", body)
    assert ints == list(cuda._WAVE_INT_FIELDS)
    assert ptrs == [f for f, *_ in cuda._WAVE_PTR_FIELDS]
    assert [f for f, _ in cuda.WaveCtx._fields_] == ints + ptrs
    for name, value in (("WAVE_ROWS", cuda.WAVE_ROWS), ("WAVE_PREF", cuda.WAVE_PREF),
                        ("WAVE_HEAVY_SHIFT", cuda.WAVE_HEAVY_SHIFT)):
        assert re.search(rf"\b{name} = {value}\b", header), name


def test_wave_argument_block_checks_its_run():
    cluster, apps = _mix_problem(simtpu_torch, "north", 7)
    tz = _mod(simtpu_torch, "core.tensorize").Tensorizer(cluster.nodes)
    batch = tz.add_pods(_expand(simtpu_torch, apps)[:40])
    tensors = tz.freeze()
    _, arrays = tscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    statics = tscan.statics_from(tensors, None, torch.device("cpu"))
    state = tstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), np.float32), None, "cpu")
    buf = tscan.StepBuffers(statics, state, arrays, tscan.flags_from(tensors, batch.ext))
    ctx = cuda.make_wave_ctx(buf, 0, 8, (False, False, 0))
    assert (ctx.a, ctx.b, ctx.k, ctx.mode) == (0, 8, tensors.node_dom.shape[0], 0)
    ctx = cuda.make_wave_ctx(buf, 0, 8, (True, True, twf.WAVE_HEAVY_GPU))
    assert ctx.mode == cuda.WAVE_PREF | twf.WAVE_HEAVY_GPU << cuda.WAVE_HEAVY_SHIFT
    for a, b in ((0, 0), (-1, 4), (8, 41)):
        with pytest.raises(IndexError):
            cuda.make_wave_ctx(buf, a, b, (False, False, 0))
    buf.wave_rows = torch.zeros((cuda.WAVE_ROWS - 1, tensors.n_nodes))
    with pytest.raises(ValueError, match="carry"):
        cuda.make_wave_ctx(buf, 0, 8, (False, False, 0))


def test_wavefront_module_imports_neither_jax_nor_simtpu():
    code = (
        "import sys; import simtpu_torch.engine.wavefront; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'simtpu' or m.startswith('simtpu.')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
