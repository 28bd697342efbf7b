"""simtpu_torch's bulk rounds engine against the JAX package, on the CPU.

The port (`simtpu_torch/engine/rounds.py`: the plain versions of K14
`round_score`, K15 `round_pick` and K16 `round_commit` behind `_round_core`,
and `RoundsEngine`) is held to the JAX package's rounds engine, not to the
serial scan (the bulk tie-breaks differ from the scan by design), at zero
tolerance:

1. one round against the JAX package's compiled round program
   (`_round_place_many`, one segment) from the same numpy inputs, per
   variant: plain, quota with DoNotSchedule spread, quota with self
   anti-affinity, self-affinity with and without the bootstrap,
   single-claim LVM, exclusive device, single GPU, and the matrix rounds
   multi-GPU, preset GPU index and multi-claim LVM; and a run with no
   requests at all in the plain and quota variants. Every output and every
   state plane must be equal;
2. the engine end to end against the JAX `RoundsEngine` / `simulate(bulk=
   True)` on the cases of tests/test_rounds.py (`TestBulkEquivalence`, the
   chunked equivalence under a small ROW_BUDGET in both packages), the
   hard, north and matrix mixes at 96-128 nodes, and a bulk preemption
   case after tests/test_preemption.py's;
3. the batched leftover probes (`_probe_leftovers`) with a scripted
   mid-batch placement: the revert delta, the re-probe and the serial walk
   equal to the JAX package's under the same script;
4. the wrappers' CPU dispatch and the round kernels' argument block.

SIMTPU_WAVEFRONT=0 comes from conftest; the JAX engines here keep its
default (placements are equal either way), the port's run its wavefront.
"""

import importlib

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
from simtpu.engine import rounds as jrounds
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.engine.state import diff_state_planes
from simtpu_torch.engine import rounds as trounds
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from simtpu_torch.smoke import placement_record

from .fixtures import make_fake_deployment, make_fake_node, make_fake_pod, with_template_affinity
from ._threads import one_torch_thread  # noqa: F401 (autouse)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _mod(pkg, name: str):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def _expand(pkg, apps):
    pods = []
    for app in apps:
        for pod in _mod(pkg, "workloads.expand").get_valid_pods_exclude_daemonset(app.resource):
            _mod(pkg, "core.objects").set_label(pod, _mod(pkg, "constants").LABEL_APP_NAME, app.name)
            pods.append(pod)
    return pods


def _tensorized(pkg, build):
    """(tensors, batch, pod arrays, flags, tensorizer) of `build(pkg)`,
    pod names seeded."""
    cluster, apps = build(pkg)
    _mod(pkg, "workloads.expand").seed_name_hashes(0)
    try:
        pods = _expand(pkg, apps)
    finally:
        _mod(pkg, "workloads.expand").seed_name_hashes(None)
    tz = _mod(pkg, "core.tensorize").Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    sc = jscan if pkg is simtpu else tscan
    _, arrays = sc.build_pod_arrays(batch, tensors.alloc.shape[1])
    return tensors, batch, arrays, sc.flags_from(tensors, batch.ext), tz


# -- 1. one round against the JAX round program --------------------------------

#: the round fixture's Deployments: (name, make_deployment keywords)
ROUND_DEPS = (
    ("plain", dict()),
    ("spread", dict(spread_topo=ZONE, spread_hard=True)),
    ("anti", dict(anti_affinity_topo=HOST, anti_affinity_required=True)),
    ("aff", dict(affinity_topo=ZONE)),
    ("lvm", dict(lvm_gib=20)),
    ("dev", dict(device_gib=100)),
    ("gpu", dict(gpu_mem_mib=4096)),
    ("gpu-multi", dict(gpu_mem_mib=4096, gpu_count=2)),
    ("gpu-preset", dict(gpu_mem_mib=2048, gpu_count=2, gpu_index="0-1")),
    ("lvm-multi", dict(lvm_gib=(20, 10))),
)


def _round_problem(pkg):
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(24, seed=17, zones=3, taint_frac=0.0, storage_frac=0.6, gpu_frac=0.6)
    deps = [synth.make_deployment(name, 12, 700, 900, **kw) for name, kw in ROUND_DEPS]
    # soft terms of other groups, so the re-score's count rows move too
    deps.append(synth.make_deployment("soft", 12, 300, 256, spread_topo=ZONE, anti_affinity_topo=HOST))
    return cluster, [pkg.AppResource(name="rounds", resource=pkg.ResourceTypes(deployments=deps))]


@pytest.fixture(scope="module")
def round_inputs():
    return {pkg: _tensorized(pkg, _round_problem) for pkg in (simtpu, simtpu_torch)}


def _log(tensors, arrays, n_log: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, len(tensors.groups), n_log).astype(np.int32)
    n = rng.integers(0, tensors.n_nodes, n_log).astype(np.int32)
    r = arrays[1][rng.integers(0, len(arrays[0]), n_log)]
    return g, n, r


COUNT_PLANES = ("cnt_match", "cnt_total", "cnt_own_anti", "cnt_own_aff", "w_own_aff_pref", "w_own_anti_pref")

#: (case, deployment, variant (quota, self_aff, ext_mats), placements in the
#: seeded log the round starts from, zero the requests)
ROUND_CASES = (
    ("plain", "plain", (False, False, False), 40, False),
    ("quota-spread", "spread", (True, False, False), 40, False),
    ("quota-anti", "anti", (True, False, False), 40, False),
    ("self-aff-bootstrap", "aff", (False, True, False), 0, False),
    ("self-aff", "aff", (False, True, False), 200, False),
    ("lvm", "lvm", (False, False, False), 40, False),
    ("device", "dev", (False, False, False), 40, False),
    ("gpu", "gpu", (False, False, False), 40, False),
    ("matrix-multi-gpu", "gpu-multi", (False, False, True), 40, False),
    ("matrix-preset", "gpu-preset", (False, False, True), 40, False),
    ("matrix-multi-lvm", "lvm-multi", (False, False, True), 40, False),
    ("zero-request-plain", "plain", (False, False, False), 40, True),
    ("zero-request-quota", "spread", (True, False, False), 40, True),
)


@pytest.mark.parametrize("case,dep,variant,n_log,zero", ROUND_CASES, ids=[c[0] for c in ROUND_CASES])
def test_round_equals_the_jax_round_program(round_inputs, case, dep, variant, n_log, zero):
    quota, self_aff, ext_mats = variant
    jt, jbatch, jarr, jflags, _ = round_inputs[simtpu]
    tt, _, tarr, tflags, _ = round_inputs[simtpu_torch]
    names = [p["metadata"]["name"] for p in jbatch.pods]
    a = next(i for i, nm in enumerate(names) if nm.startswith(dep + "-"))
    k = sum(nm.startswith(dep + "-") for nm in names)
    if case.startswith("self-aff"):
        g = int(jarr[0][a])
        assert jt.a_aff_req[g].any()
    k_cap = trounds._pow2(k)
    jarr, tarr = list(jarr), list(tarr)
    if zero:
        for arrs in (jarr, tarr):
            arrs[1] = arrs[1].copy()
            arrs[1][a] = 0.0
    g_log, n_log_a, r_log = _log(jt, jarr, n_log)
    if case == "self-aff":
        # matching pods of the run's own group already placed: no bootstrap
        g_log[:5] = jarr[0][a]
    # the JAX round program (one segment, as the engine compiles it)
    js = jscan.statics_from(jt, None)
    jst = jstate.build_state(jt, g_log, n_log_a, r_log, None)
    seg = tuple(np.asarray(arr[a:a + 1]) for arr in jarr)
    import jax.numpy as jnp

    jout_state, jouts = jrounds._round_place_many(js, jst, seg, jnp.asarray([k], jnp.int32), jt.n_domains,
                                                 k_cap, jflags, quota, self_aff, ext_mats)
    want_state = type(jout_state)(*(np.asarray(x) for x in jout_state))
    # the port's round through its wrappers (the plain versions, on the CPU)
    ts = tscan.statics_from(tt, None, "cpu")
    tst = tstate.build_state(tt, g_log, n_log_a, r_log, None, "cpu")
    before = dict(cuda.PLAIN_CALLS)
    outs = trounds._round_core(ts, tst, tuple(arr[a] for arr in tarr), k, k_cap, tt, tflags, quota,
                               self_aff, ext_mats)
    calls = {n: cuda.PLAIN_CALLS[n] - before.get(n, 0) for n in ("round_score", "round_pick", "round_commit")}
    assert calls == dict.fromkeys(calls, 1) and not cuda.LAUNCHES
    for name, got, want in zip(("assign", "c1", "c2", "c3"), outs, jouts):
        want = np.asarray(want)[0]
        assert np.array_equal(got.numpy(), want, equal_nan=want.dtype.kind == "f"), (case, name)
    got_state = tstate.state_to_numpy(tst)
    for name, x, y in zip(want_state._fields, got_state, want_state):
        x, y = np.asarray(x), np.asarray(y)
        if case == "zero-request-quota" and name in COUNT_PLANES:
            # a run with no requests at all (the tensorizer never builds one:
            # every pod requests `pods`) gives the quota's split inf - inf,
            # so NaN intakes, here as in the JAX package (the outputs and
            # the other planes above and below are equal). How far the NaN
            # then spreads through the count planes follows XLA's one-hot
            # products and its algebraic rewrites, which the port's index
            # updates do not reproduce: the entries finite in both are equal,
            # and the count rows of the run's terms carry NaN in both.
            both = ~np.isnan(x) & ~np.isnan(y)
            assert np.array_equal(x[both], y[both]), (case, name)
            if name == "cnt_match":
                assert np.isnan(x).any() and not (np.isnan(x) & ~np.isnan(y)).any(), case
            continue
        # NaN where the JAX formulas give it, NaN here too
        assert np.array_equal(x, y, equal_nan=y.dtype.kind == "f"), (case, name)
    placed = int((outs[0] >= 0).sum())
    if not zero and case != "quota-anti":
        assert placed > 0, case


# -- 2. the engine end to end ---------------------------------------------------


def _place(pkg, build, engine=None, speculate=None):
    """One rounds engine placing `build(pkg)` in one batch. Returns (nodes,
    reasons, extras, final state as numpy, segments)."""
    tensors, batch, _, _, tz = _tensorized(pkg, build)
    if pkg is simtpu:
        eng = (engine or jrounds.RoundsEngine)(tz)
    else:
        eng = (engine or trounds.RoundsEngine)(tz, "cpu")
    if speculate is not None:
        eng.speculate = speculate
    nodes, reasons, extras = eng.place(batch)
    state = eng.carried_state()
    if pkg is simtpu:
        state = type(state)(*(np.asarray(x) for x in state))
    else:
        state = tstate.state_to_numpy(state)
    return (np.asarray(nodes), np.asarray(reasons), {k: np.asarray(v) for k, v in extras.items()}, state,
            eng._segments(batch, tensors))


def _assert_same(got, want):
    assert np.array_equal(got[0], want[0]), "nodes"
    assert np.array_equal(got[1], want[1]), "reasons"
    for key in want[2]:
        assert np.array_equal(got[2][key], want[2][key]), key
    assert diff_state_planes(got[3], want[3]) == []
    assert got[4] == want[4]


def _mix(mix: str, n_nodes: int):
    hard, matrix = mix == "hard", mix == "matrix"

    def build(pkg):
        synth = _mod(pkg, "synth")
        cluster = synth.synth_cluster(n_nodes, seed=3, zones=4, taint_frac=0.1, storage_frac=0.3,
                                      gpu_frac=0.4 if matrix else 0.0)
        apps = synth.synth_apps(n_nodes * 12, seed=4, zones=4, pods_per_deployment=48, selector_frac=0.2,
                                toleration_frac=0.1, anti_affinity_frac=0.2,
                                anti_affinity_hard_frac=0.34 if hard else 0.0, spread_frac=0.3,
                                spread_hard_frac=0.5 if hard else 0.0, gpu_frac=0.25 if matrix else 0.0,
                                gpu_multi_frac=0.6 if matrix else 0.0, storage_frac=0.25 if matrix else 0.2,
                                storage_device_frac=0.0 if matrix else 0.3,
                                lvm_multi_frac=0.6 if matrix else 0.0, affinity_frac=0.15 if matrix else 0.0)
        return cluster, apps

    return build


@pytest.mark.parametrize("mix,n_nodes", [("hard", 96), ("north", 96), ("matrix", 128)])
def test_engine_equals_jax_on_the_mixes(mix, n_nodes):
    want = _place(simtpu, _mix(mix, n_nodes))
    before = dict(cuda.PLAIN_CALLS)
    got = _place(simtpu_torch, _mix(mix, n_nodes))
    _assert_same(got, want)
    kinds = {s[0] for s in want[4]}
    assert {"bulk"} <= kinds and (mix != "hard" or "bulkq" in kinds)
    assert mix != "matrix" or {"bulkm", "bulka"} <= kinds
    rounds_run = sum(s[0] != "scan" for s in want[4])
    assert cuda.PLAIN_CALLS["round_commit"] - before.get("round_commit", 0) == rounds_run
    assert not cuda.LAUNCHES


def _simulate_both(build, **kw):
    """`simulate(bulk=True)` of `build(pkg)` in both packages, names seeded
    alike; the placement records must be equal. Returns the port's result."""
    records = []
    for pkg in (simtpu, simtpu_torch):
        cluster, apps = build(pkg)
        extra = {} if pkg is simtpu else {"device": "cpu"}
        _mod(pkg, "workloads.expand").seed_name_hashes(5)
        try:
            res = pkg.simulate(cluster, apps, bulk=True, **kw, **extra)
        finally:
            _mod(pkg, "workloads.expand").seed_name_hashes(None)
        records.append(placement_record(res))
    assert records[1] == records[0]
    return res


def _synth_case(n_nodes, n_pods, **apps_kw):
    def build(pkg):
        synth = _mod(pkg, "synth")
        zones = apps_kw.get("zones", 4)
        return (synth.synth_cluster(n_nodes, seed=apps_kw.pop("cseed", 11), zones=zones, taint_frac=0.1),
                synth.synth_apps(n_pods, **apps_kw))
    return build


def _one_app(pkg, nodes, deps=(), pods=()):
    cluster = pkg.ResourceTypes(nodes=nodes)
    return cluster, [pkg.AppResource(name="a", resource=pkg.ResourceTypes(deployments=list(deps)))]


BULK_EQUIVALENCE = {
    "all_placed": lambda pkg: (_mod(pkg, "synth").synth_cluster(40, seed=11, zones=4, taint_frac=0.1),
                               _mod(pkg, "synth").synth_apps(300, seed=12, zones=4, pods_per_deployment=50,
                                                             selector_frac=0.2, toleration_frac=0.1,
                                                             anti_affinity_frac=0.0)),
    "capacity_exhaustion": lambda pkg: _one_app(
        pkg, [make_fake_node(f"n{i}", "8", "16Gi") for i in range(4)],
        [make_fake_deployment("big", "default", 50, "1", "2Gi")]),
    "no_overcommit": lambda pkg: (_mod(pkg, "synth").synth_cluster(16, seed=3, zones=2),
                                  _mod(pkg, "synth").synth_apps(400, seed=4, zones=2, pods_per_deployment=100)),
    "spreading_quality": lambda pkg: _one_app(
        pkg, [make_fake_node(f"n{i}", "32", "64Gi") for i in range(10)],
        [make_fake_deployment("spread", "default", 100, "1", "1Gi")]),
    "anti_affinity": lambda pkg: _one_app(
        pkg, [make_fake_node(f"n{i}", "32", "64Gi") for i in range(12)],
        [make_fake_deployment("anti", "default", 12, "1", "1Gi", with_template_affinity({
            "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"simtpu-app": "anti"}}, "topologyKey": HOST}]}}))]),
}


def _ported(pkg):
    dep = make_fake_deployment("ported", "default", 10, "1", "1Gi")
    dep["spec"]["template"]["spec"]["containers"][0]["ports"] = [
        {"containerPort": 8080, "hostPort": 8080, "protocol": "TCP"}]
    return _one_app(pkg, [make_fake_node(f"n{i}", "32", "64Gi") for i in range(3)], [dep])


def _interleaved(pkg):
    cluster = pkg.ResourceTypes(nodes=[make_fake_node("n0", "10", "100Gi")],
                                pods=[make_fake_pod("pre", "default", "1", "1Gi")])
    apps = [pkg.AppResource(name="a", resource=pkg.ResourceTypes(
                deployments=[make_fake_deployment("filler", "default", 9, "1", "1Gi")])),
            pkg.AppResource(name="b", resource=pkg.ResourceTypes(
                pods=[make_fake_pod("post", "default", "1", "1Gi")]))]
    return cluster, apps


BULK_EQUIVALENCE.update(host_port=_ported, interleaved=_interleaved)


@pytest.mark.parametrize("case", sorted(BULK_EQUIVALENCE))
def test_bulk_equivalence_cases_equal_jax(case):
    res = _simulate_both(BULK_EQUIVALENCE[case])
    placed = sum(len(s.pods) for s in res.node_status)
    if case == "capacity_exhaustion":
        assert len(res.unscheduled_pods) == 18 and "resources" in res.unscheduled_pods[0].reason
    if case == "spreading_quality":
        assert {len(s.pods) for s in res.node_status} == {10}
    if case == "host_port":
        assert max(len(s.pods) for s in res.node_status) == 1 and len(res.unscheduled_pods) == 7
    if case == "interleaved":
        assert [u.pod["metadata"]["name"][:4] for u in res.unscheduled_pods] == ["post"]
    assert placed > 0


def _chunk_problem(pkg):
    synth = _mod(pkg, "synth")
    cluster = synth.synth_cluster(24, seed=5, zones=3, taint_frac=0.1)
    apps = synth.synth_apps(160, seed=6, zones=3, pods_per_deployment=16, selector_frac=0.2,
                            anti_affinity_frac=0.3, spread_frac=0.3)
    return cluster, apps


def test_chunked_rows_equal_jax_and_whole_plane(monkeypatch):
    """A tiny ROW_BUDGET, patched alike in both packages, cuts many chunks;
    the placements equal the whole-plane run's and the JAX package's,
    and the port's chunk plan is the JAX package's."""
    whole = _place(simtpu, _chunk_problem)

    class JChunked(jrounds.RoundsEngine):
        ROW_BUDGET = 4

    class TChunked(trounds.RoundsEngine):
        ROW_BUDGET = 4

    plans = {}
    for name, cls in (("jax", JChunked), ("port", TChunked)):
        orig = cls._chunk_runs

        def spy(self, run, batch, tensors, max_segs=None, _orig=orig, _name=name):
            out = list(_orig(self, run, batch, tensors, max_segs))
            plans.setdefault(_name, []).append([(c, None if r is None else list(r)) for c, r in out])
            return iter(out)

        monkeypatch.setattr(cls, "_chunk_runs", spy)
    j_chunked = _place(simtpu, _chunk_problem, JChunked)
    t_whole = _place(simtpu_torch, _chunk_problem)
    t_chunked = _place(simtpu_torch, _chunk_problem, TChunked)
    assert sum(len(p) for p in plans["port"]) > 1
    assert plans["port"] == plans["jax"]
    for got in (j_chunked, t_whole, t_chunked):
        _assert_same(got, whole)


def test_bulk_preemption_equals_jax():
    """tests/test_preemption.py's bulk preemption at a small scale: every
    high-priority pod lands by evicting two low-priority ones."""

    def build(pkg):
        synth = _mod(pkg, "synth")
        n = 30
        nodes = [synth.make_node(f"node-{i:06d}", 4000, 16, {ZONE: f"zone-{i % 4}", HOST: f"node-{i:06d}"})
                 for i in range(n)]
        low = synth.make_deployment("low", n * 4, 1000, 512, priority=10)
        high = synth.make_deployment("high", 25, 2000, 1024, priority=1000)
        return pkg.ResourceTypes(nodes=nodes), [
            pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[low])),
            pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[high]))]

    res = _simulate_both(build)
    assert not res.unscheduled_pods and len(res.preempted_pods) == 2 * 25


# -- 3. the batched leftover probes ------------------------------------------------


def _probe_script(pkg, monkeypatch):
    """tests/test_rounds.py's scripted probe batches through `pkg`'s
    `_probe_leftovers`: run 0 fails, run 1 places (its remainder walks the
    serial path), run 2 places too and is reverted and re-probed. Returns
    (nodes, reasons, gpu shares, probe batches, serial walks, delta entries)."""
    p, r, v, sd, gd = 8, 2, 1, 1, 1
    pods = (np.arange(p, dtype=np.int32), np.ones((p, r), np.float32), np.full(p, -1, np.int32),
            np.zeros(p, bool), np.zeros((p, v), np.float32), np.full((p, v), -1, np.int32),
            np.zeros((p, sd), np.float32), np.zeros((p, sd), np.int32), np.full(p, 2.0, np.float32),
            np.ones(p, np.int32), np.zeros((p, gd), np.float32))
    script = [(np.array([-1, 4, 6]), np.array([2, 0, 0])), (np.array([-1]), np.array([5]))]
    batches, walked, deltas = [], [], []

    def fake_idx(*args):
        idx = args[-2] if pkg is simtpu else args[-1]
        nodes_s, reasons_s = script[len(batches)]
        batches.append([int(i) for i in idx])
        k = len(idx)
        outs = (nodes_s, reasons_s, np.zeros((k, v), np.float32), np.zeros((k, sd), bool),
                np.full((k, gd), 1.0, np.float32))
        return outs if pkg is simtpu_torch else ("state", outs)

    def fake_segment(*args):
        a, b = (args[-3], args[-2]) if pkg is simtpu else (args[-2], args[-1])
        walked.append((a, b))
        k = b - a
        outs = (np.full(k, 7, np.int32), np.zeros(k, np.int32), np.zeros((k, v), np.float32),
                np.zeros((k, sd), bool), np.zeros((k, gd), np.float32))
        return outs if pkg is simtpu_torch else ("state", outs)

    def fake_delta(statics, state, entries):
        deltas.append(tuple(np.asarray(x) for x in entries))
        return state

    cls = jrounds.RoundsEngine if pkg is simtpu else trounds.RoundsEngine
    eng = cls.__new__(cls)
    monkeypatch.setattr(eng, "_run_scan_segment_idx", fake_idx)
    monkeypatch.setattr(eng, "_run_scan_segment", fake_segment)
    if pkg is simtpu:
        monkeypatch.setattr(jscan, "_apply_log_delta", fake_delta)
    else:
        monkeypatch.setattr(trounds, "apply_placement_deltas", fake_delta)
    nodes = np.full(p, -9, np.int64)
    reasons = np.zeros(p, np.int32)
    out = (np.zeros((p, v), np.float32), np.zeros((p, sd), bool), np.zeros((p, gd), np.float32))
    leftovers = [(0, 3), (3, 5), (5, 8)]
    if pkg is simtpu:
        eng._probe_leftovers(None, "state", pods, leftovers, None, nodes, reasons, *out)
    else:
        buf = type("Buf", (), {"statics": None, "state": "state"})()
        eng._probe_leftovers(buf, pods, leftovers, nodes, reasons, *out)
    return nodes, reasons, out[2], batches, walked, deltas


def test_leftover_probes_revert_and_reprobe_as_jax(monkeypatch):
    want = _probe_script(simtpu, monkeypatch)
    got = _probe_script(simtpu_torch, monkeypatch)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3] == [[0, 3, 5], [5]]
    assert got[4] == want[4] == [(4, 5)]
    assert len(got[5]) == len(want[5]) == 1
    for a, b in zip(got[5][0], want[5][0]):
        assert np.array_equal(a, b)
    g_a, n_a, w_a, _, _, _, gp_a = got[5][0]
    assert (w_a[0], n_a[0], g_a[0], gp_a[0, 0]) == (-1.0, 6, 5, 2.0)


def test_leftover_probe_places_and_reverts_end_to_end():
    """A real batch whose leftover probes place: two exhausted runs of
    different groups over a zone-spread constraint that the other run's
    pods relax. Equal to the JAX package, and the revert ran (K7's plain
    version) where the JAX package's ran its delta."""

    def build(pkg):
        nodes = [make_fake_node(f"n{i}", "4", "8Gi") for i in range(3)]
        deps = [make_fake_deployment(f"d{j}", "default", 12, "1", "1Gi") for j in range(4)]
        return _one_app(pkg, nodes, deps)

    want = _place(simtpu, build)
    before = cuda.PLAIN_CALLS["filter_pod"]
    got = _place(simtpu_torch, build)
    _assert_same(got, want)
    assert cuda.PLAIN_CALLS["filter_pod"] > before and (got[0] < 0).sum() == 48 - 12


# -- 4. the wrappers ---------------------------------------------------------------


def test_wrappers_take_the_plain_versions_on_the_cpu(round_inputs):
    tt, _, tarr, tflags, _ = round_inputs[simtpu_torch]
    ts = tscan.statics_from(tt, None, "cpu")
    st = tstate.build_state(tt, np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros((0, tt.alloc.shape[1]), np.float32), None, "cpu")
    buf = tscan.StepBuffers(ts, st, tarr, tflags)
    rb = trounds.RoundBuffers(buf, tt)
    rb.alloc_outputs(2, 16)
    before = dict(cuda.PLAIN_CALLS)
    trounds.run_round(rb, 0, 12, 0, 1)
    assert {k: cuda.PLAIN_CALLS[k] - before.get(k, 0) for k in ("round_score", "round_pick", "round_commit")} \
        == {"round_score": 1, "round_pick": 1, "round_commit": 1}
    assert not cuda.LAUNCHES
    assert int((rb.assign[1] >= 0).sum()) == 12 and bool((rb.assign[0] == -1).all())


def test_round_ctx_mirrors_the_header():
    """RoundCtx's ctypes fields follow csrc/rounds.cuh's struct, and the
    scratch row counts agree with its enums."""
    import re
    from pathlib import Path

    src = (Path(cuda.CSRC) / "rounds.cuh").read_text()
    body = src[src.index("struct RoundCtx {"):]
    body = body[: body.index("};")]
    names = re.findall(r"(?:int|float|uint8_t)\*?\s+\*?(\w+)[;,]", body.replace("const ", ""))
    ints = re.findall(r"int (\w+(?:, \w+)*);", body)[0].split(", ")
    assert [f for f, _ in cuda.RoundCtx._fields_] == ints + [n for n in names if n not in ints]
    assert f"SCR_ROWS = {cuda.ROUND_SCR_ROWS}" in src and f"DSCR_ROWS = {cuda.ROUND_DSCR_ROWS}" in src
    assert cuda.ROUND_KERNELS == ("round_score", "round_pick", "round_commit")
    assert "carry_copy" in cuda.KERNELS


# -- 5. K15's exact reorderings: numpy models of the kernel's order -------------
#
# csrc/round_pick.cu reorders the JAX formulas where the result cannot
# tell: the bisection decides PICK_LEVELS steps per block reduction from
# saturated integer counts and stops at its fixed point; the quota split
# orders the nodes by a stable LSD radix sort; the quota ladder runs over
# the compacted list of domains that are eligible or have k_dom != 0. The
# models below follow the kernel's order step by step, in float32, and are
# held to the plain version (`round_pick_plain`) and to the JAX formulas'
# own order (a 40-step bisection, a stable argsort, a ladder over every
# domain).

F32 = np.float32
BIG32 = F32(3.4e38)


def _jmin(a, b):
    return np.where(np.isnan(a) | np.isnan(b), a + b, np.minimum(a, b)).astype(F32)


def _jclip(x, lo, hi):
    x = np.where(np.isnan(x), x, np.maximum(x, F32(lo))).astype(F32)
    return _jmin(x, F32(hi))


def _counts(s0, slope, cap, tau):
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        q = np.floor((s0 - tau) / np.maximum(slope, F32(1e-30))).astype(F32) + F32(1)
    c = np.where(s0 >= tau, np.where(slope > 0, q, cap), F32(0)).astype(F32)
    return _jmin(c, cap)


def _search_inputs(s0, slope, cap, m_all, k):
    kt = F32(k)
    cap_sum = cap.sum(dtype=F32)
    hi = F32(s0.max())
    with np.errstate(over="ignore", invalid="ignore"):
        low = (s0 - slope * _jclip(cap - F32(1), 0.0, kt)).astype(F32)
    lo = F32(np.where(m_all, low, BIG32).min() - F32(1))
    return lo, hi, _jmin(kt, cap_sum)


def _kernel_bisection(s0, slope, cap, m_all, k, levels, threads=64):
    """The kernel's search: the counts saturated at kf + 1 and summed per
    thread chunk, per warp and per block; `levels` steps decided per
    reduction from the tree of their midpoints; stop at the fixed point.
    Returns (lo, hi, steps run)."""
    lo, hi, kf = _search_inputs(s0, slope, cap, m_all, k)
    kf_ok = kf == kf
    kf_u = int(kf) if kf_ok else 0
    top = kf_u + 1
    n = len(s0)
    per = -(-n // threads)

    def over_count(tau):
        c = _counts(s0, slope, cap, tau)
        nan = bool(np.isnan(c).any())
        u = np.where(c > kf, top, np.where(np.isnan(c), 0, c)).astype(np.int64)
        chunks = [min(int(u[t * per:(t + 1) * per].sum()), top) for t in range(threads)]
        warps = [min(sum(chunks[w * 32:(w + 1) * 32]), top) for w in range(threads // 32)]
        return nan, sum(warps)

    it = steps = 0
    nq = (1 << levels) - 1
    while it < 40:
        tl, th, tau = [lo] + [None] * (nq - 1), [hi] + [None] * (nq - 1), [None] * nq
        for q in range(nq):
            tau[q] = F32(F32(0.5) * F32(tl[q] + th[q]))
            if 2 * q + 2 < nq:
                tl[2 * q + 1], th[2 * q + 1] = tl[q], tau[q]
                tl[2 * q + 2], th[2 * q + 2] = tau[q], th[q]
        sums = [over_count(t) for t in tau]
        q = 0
        for _ in range(levels):
            if it >= 40:
                break
            nan, tot = sums[q]
            over = kf_ok and not nan and tot > kf_u
            nlo, nhi = (tau[q], hi) if over else (lo, tau[q])
            fixed = tau[q] == tau[q] and np.float32(nlo).tobytes() == np.float32(lo).tobytes() \
                and np.float32(nhi).tobytes() == np.float32(hi).tobytes()
            lo, hi = nlo, nhi
            it += 1
            steps += 1
            if fixed:
                it = 40
                break
            q = 2 * q + 1 + int(over)
    return lo, hi, steps


def _jax_bisection(s0, slope, cap, m_all, k):
    """The JAX formula's 40 steps, float sums in index order."""
    lo, hi, kf = _search_inputs(s0, slope, cap, m_all, k)
    for _ in range(40):
        mid = F32(F32(0.5) * F32(lo + hi))
        with np.errstate(over="ignore", invalid="ignore"):
            over = np.cumsum(_counts(s0, slope, cap, mid), dtype=F32)[-1] > kf
        lo, hi = (mid, hi) if over else (lo, mid)
    return lo, hi


def _fake_round(s0, slope, cap, m_all):
    from types import SimpleNamespace

    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)  # noqa: E731
    buf = SimpleNamespace(group=[0], flags=tscan.StepFlags(),
                          statics=SimpleNamespace(g_terms=torch.zeros((1, 0), dtype=torch.int32)))
    return SimpleNamespace(buf=buf, cap=t(cap), s0=t(s0), slope=t(slope), m_all=t(m_all, torch.bool),
                           m_n=torch.zeros(len(cap)))


def _kernel_threshold(s0, slope, cap, m_all, k, levels):
    """The kernel's threshold round after its search: the overshoot clamp
    and the tie fill, prefixes by node index."""
    lo, hi, steps = _kernel_bisection(s0, slope, cap, m_all, k, levels)
    kf = _search_inputs(s0, slope, cap, m_all, k)[2]
    m = _counts(s0, slope, cap, hi)
    with np.errstate(over="ignore", invalid="ignore"):
        mc = _jclip(kf - (np.cumsum(m, dtype=F32) - m), 0.0, m)
        room = np.maximum(_counts(s0, slope, cap, lo) - mc, F32(0)).astype(F32)
        extra = _jclip(kf - mc.sum(dtype=F32) - (np.cumsum(room, dtype=F32) - room), 0.0, room)
    return (mc + extra).astype(F32), (lo, hi, steps)


def _search_case(name, rng):
    n = 300
    s0 = rng.normal(50, 20, n).astype(F32)
    slope = rng.uniform(0, 3, n).astype(F32)
    cap = rng.integers(0, 6, n).astype(F32)
    m_all = rng.random(n) < 0.8
    k = int(rng.integers(1, 400))
    if name == "ties":
        s0 = np.round(s0 / 10).astype(F32) * F32(10)
        slope = np.where(rng.random(n) < 0.5, F32(0), np.round(slope)).astype(F32)
    elif name == "slope-0":
        slope[:] = 0
    elif name == "big-caps":
        cap = np.where(rng.random(n) < 0.05, BIG32, cap).astype(F32)
        slope = np.where(cap == BIG32, F32(0), slope).astype(F32)
    elif name == "k-0":
        k = 0
    elif name == "no-m-all":
        m_all[:] = False
    s0 = np.where(m_all, s0, F32(-3.4e38)).astype(F32)
    cap = np.where(m_all, cap, F32(0)).astype(F32)
    return s0, slope, cap, m_all, k


SEARCH_CASES = ("random", "ties", "slope-0", "big-caps", "k-0", "no-m-all")


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("case", SEARCH_CASES)
def test_k15_search_order_equals_the_plain_round(case, levels):
    """The speculative levels, the fixed-point exit and the saturated
    counts: the same (lo, hi) as the JAX formula's 40 steps and the same
    m_n as round_pick_plain, on random rounds and the edge cases."""
    for seed in range(4):
        s0, slope, cap, m_all, k = _search_case(case, np.random.default_rng(seed))
        want_lo, want_hi = _jax_bisection(s0, slope, cap, m_all, k)
        got, (lo, hi, steps) = _kernel_threshold(s0, slope, cap, m_all, k, levels)
        assert (np.float32(lo).tobytes(), np.float32(hi).tobytes()) == \
            (np.float32(want_lo).tobytes(), np.float32(want_hi).tobytes()), (case, seed)
        rb = _fake_round(s0, slope, cap, m_all)
        trounds.round_pick_plain(rb, 0, k, 0)
        assert np.array_equal(got, rb.m_n.numpy(), equal_nan=True), (case, seed)
        assert steps <= 40
    if case == "random":
        # the fixed point comes well before the 40th step on a spread of scores
        assert steps < 40


def _radix_order(keys, threads):
    """The kernel's stable LSD radix sort of (key, index): items
    warp-striped, ranks within a warp in (item, lane) order as the
    match-any ranks give them, digit-major offsets over (digit, warp)."""
    n = len(keys)
    nw = threads // 32
    per = -(-n // threads)
    seq_k, seq_n = keys.astype(np.int64), np.arange(n)
    passes = -(-int(keys.max(initial=0)).bit_length() // 8)
    for p in range(passes):
        dig = (seq_k >> (8 * p)) & 255
        hist = np.zeros((nw, 256), np.int64)
        rank = np.zeros(n, np.int64)
        warp = np.zeros(n, np.int64)
        for w in range(nw):
            for j in range(per):
                for lane in range(32):
                    q = w * 32 * per + 32 * j + lane
                    if q < n:
                        rank[q] = hist[w, dig[q]]
                        hist[w, dig[q]] += 1
                        warp[q] = w
        flat = hist.T.reshape(-1)
        off = (np.cumsum(flat) - flat).reshape(256, nw).T
        pos = off[warp, dig] + rank
        new_k, new_n = np.empty_like(seq_k), np.empty_like(seq_n)
        new_k[pos], new_n[pos] = seq_k, seq_n
        seq_k, seq_n = new_k, new_n
    return seq_n


def _split(order, key, cap, x_dom, n_keys):
    """The JAX split formula on an order of the nodes (`_quota_fill`'s
    global prefix, running maximum at domain starts, difference)."""
    key_o = key[order]
    cap_o = np.where(key_o < n_keys, cap[order], F32(0)).astype(F32)
    with np.errstate(over="ignore", invalid="ignore"):
        excl = (np.cumsum(cap_o, dtype=F32) - cap_o).astype(F32)
        start = np.ones(len(order), bool)
        start[1:] = key_o[1:] != key_o[:-1]
        seg = np.maximum.accumulate(np.where(start, excl, F32(0))).astype(F32)
        x_o = np.where(key_o < n_keys, x_dom[np.minimum(key_o, n_keys - 1)], F32(0)).astype(F32)
        allow_o = _jclip(x_o - (excl - seg), 0.0, cap_o)
    allow = np.empty_like(allow_o)
    allow[order] = allow_o
    return allow


@pytest.mark.parametrize("n_keys", [1, 37, 600])
@pytest.mark.parametrize("threads", [64, 256])
def test_k15_ranking_equals_the_stable_argsort_split(n_keys, threads):
    """The radix ranking (one pass up to 255 capped domains, two above)
    gives the stable argsort's order on keys with ties and keyless nodes,
    at D = 1 and at D = N, and so the same split, 3.4e38 caps included."""
    n = 600
    rng = np.random.default_rng(n_keys + threads)
    key = rng.integers(0, n_keys, n) if n_keys < n else rng.permutation(n)
    keyless = rng.random(n) < 0.2
    key = np.where(keyless, n_keys, key)
    order = _radix_order(key, threads)
    want = np.argsort(key, kind="stable")
    assert np.array_equal(order, want)
    cap = rng.integers(1, 5, n).astype(F32)
    cap[rng.random(n) < 0.02] = BIG32
    x_dom = rng.integers(0, 8, n_keys).astype(F32)
    assert np.array_equal(_split(order, key, cap, x_dom, n_keys), _split(want, key, cap, x_dom, n_keys),
                          equal_nan=True)


def _ladder(c, k, elig, rem, skew, ids, kernel=False):
    """The level ladder over domains `ids` (ascending) in float32; every
    other domain's intake stays 0. `kernel`: a level's total as the
    kernel takes it, min(rem, sum of the pours), the JAX formula's sum of
    the takes otherwise."""
    x = np.zeros(len(c), F32)
    rem = F32(rem)
    use_skew = skew > 0
    go = True
    levels = 0
    while go and rem > 0:
        cc = (c[ids] + x[ids]).astype(F32)
        level = F32(np.where(elig[ids], cc, BIG32).min(initial=BIG32))
        level = F32(0) if level >= BIG32 else level
        with np.errstate(invalid="ignore"):
            room = _jclip(level + F32(skew) - cc, 0.0, BIG32) if use_skew else np.full(len(ids), BIG32)
            pour = _jmin(room, (k[ids] - x[ids]).astype(F32))
            cum = np.cumsum(pour, dtype=F32)
            taken = _jclip(rem - (cum - pour), 0.0, pour)
        tot = _jmin(rem, pour.sum(dtype=F32)) if kernel else taken.sum(dtype=F32)
        x[ids] = (x[ids] + taken).astype(F32)
        rem = F32(rem - tot)
        go = tot > 0
        levels += 1
    return x, levels


@pytest.mark.parametrize("key", [ZONE, HOST])
@pytest.mark.parametrize("quota", ["spread", "anti"])
def test_k15_compacted_ladder_equals_the_full_ladder(round_inputs, key, quota):
    """On the round fixture's zone key and hostname key: the aggregates of
    random capped intakes over t*'s key, the anti clamp, then the ladder
    over the compacted list, each level's total taken as min(rem, sum of
    the pours), equals the JAX ladder over all n_dom domains, bit for bit;
    a NaN count lists every domain."""
    tt = round_inputs[simtpu_torch][0]
    d_n = int(tt.n_domains)
    dom = np.asarray(tt.node_dom)[list(tt.topo_keys).index(key)]
    # the fixture's 24 nodes: 24 hostname domains, 3 zones, global ids
    assert len(set(dom[dom >= 0].tolist())) == (3 if key == ZONE else 24) and d_n == 27
    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = len(dom)
        cap = np.where(rng.random(n) < 0.7, rng.integers(0, 5, n), 0).astype(F32)
        cnt = rng.integers(0, 4, n).astype(F32)
        own = np.where(rng.random(n) < 0.3, F32(1), F32(0))
        m_static = rng.random(n) < 0.8
        on = dom >= 0
        k_dom = np.zeros(d_n, F32)
        np.add.at(k_dom, dom[on], cap[on])
        c_dom = np.zeros(d_n, F32)
        np.maximum.at(c_dom, dom[on], cnt[on])
        own_dom = np.zeros(d_n, F32)
        np.maximum.at(own_dom, dom[on], own[on])
        elig = np.zeros(d_n, bool)
        np.logical_or.at(elig, dom[on], m_static[on])
        skew = 0.0 if quota == "anti" else float(rng.integers(1, 3))
        if quota == "anti":
            k_dom = _jmin(k_dom, ((c_dom <= 0) & (own_dom <= 0)).astype(F32))
        if seed == 5:
            c_dom[int(dom[on][0])] = np.nan
        listed = np.flatnonzero(elig | (k_dom != 0))
        if np.isnan(c_dom).any() or np.isnan(k_dom).any():
            listed = np.arange(d_n)
        else:
            # the other key's domains are never listed
            assert len(listed) <= (3 if key == ZONE else 24)
        for k in (1, 7, int(cap.sum()) + 3):
            want, _ = _ladder(c_dom, k_dom, elig, k, skew, np.arange(d_n))
            got, levels = _ladder(c_dom, k_dom, elig, k, skew, listed, kernel=True)
            assert np.array_equal(got, want, equal_nan=True), (key, quota, seed, k)
            assert levels >= 1


# -- 6. K14 / K16's cluster tiles: a numpy model of the tiled order -------------
#
# csrc/round_score.cu and round_commit.cu run a round on a thread-block
# cluster, block b owning the node tile [b * tile, (b + 1) * tile): each
# block reduces, sums and scans its tile, the blocks publish their
# partials, and every block folds them in block order. The models below
# follow that order in float32 and are held to the plain versions on the
# round fixture and on a problem with a hostname key (unique per node), a
# zone key (small) and a rack key (the fallback route).


def _tile_problem(pkg):
    """170 nodes in 3 zones and 70 racks of 2-3 nodes: the hostname key is
    unique per node (kind 2), the zone key small (kind 1), the rack key
    neither (kind 0); one run per key mix."""
    nodes = []
    for i in range(170):
        labels = {HOST: f"n-{i}", ZONE: f"z{i % 3}", "rack": f"r{i * 70 // 170}"}
        nodes.append(_mod(pkg, "synth").make_node(f"n-{i}", 8000, 16, labels))
    mk = _mod(pkg, "synth").make_deployment
    res = pkg.ResourceTypes(deployments=[
        mk("racky", 40, 500, 512, spread_topo="rack", anti_affinity_topo=HOST),
        mk("zonal", 30, 300, 128, spread_topo=ZONE, anti_affinity_topo="rack"),
        mk("hosty", 24, 700, 256, anti_affinity_topo=HOST, spread_topo=ZONE),
    ])
    return pkg.ResourceTypes(nodes=nodes), [pkg.AppResource(name="tiles", resource=res)]


@pytest.fixture(scope="module")
def tile_inputs():
    return _tensorized(simtpu_torch, _tile_problem)


def _plain_round(inputs, dep, n_log, seed=5):
    """The plain K1/K2, K14 and K15 of the first pod of deployment `dep`
    from a seeded log, on the CPU. Returns (round buffers, pod, k, group)."""
    tt, batch, tarr, tflags, _ = inputs
    names = [p["metadata"]["name"] for p in batch.pods]
    a = next(i for i, nm in enumerate(names) if nm.startswith(dep + "-"))
    k = sum(nm.startswith(dep + "-") for nm in names)
    g_log, n_log_a, r_log = _log(tt, tarr, n_log, seed)
    ts = tscan.statics_from(tt, None, "cpu")
    st = tstate.build_state(tt, g_log, n_log_a, r_log, None, "cpu")
    buf = tscan.StepBuffers(ts, st, tarr, tflags)
    rb = trounds.RoundBuffers(buf, tt)
    rb.alloc_outputs(1, trounds._pow2(k))
    tscan.filter_pod(buf, a)
    if buf.storage_live[a]:
        tscan.storage_pod(buf, a)
    if buf.gpu_live[a]:
        tscan.gpu_pod(buf, a)
    tscan.topology_pod(buf, a)
    trounds.round_score_plain(rb, a, 0)
    trounds.round_pick_plain(rb, a, k, 0)
    return rb, a, k, int(buf.group[a])


def _tile_bounds(n, blocks):
    """The model's tiles: `blocks` tiles of ceil(N / blocks) nodes, the last
    one ragged."""
    tile = -(-n // blocks)
    return [(lo, min(n, lo + tile)) for lo in range(0, n, tile)]


def _fold(parts, op):
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def _tiled_extreme(x, mask, blocks, is_min, ident):
    """A masked min or max as the cluster takes it (fminf / fmaxf): per
    tile, then folded in block order."""
    op = np.fmin if is_min else np.fmax
    parts = [op.reduce(np.where(mask[lo:hi], x[lo:hi], F32(ident)).astype(F32), initial=F32(ident))
             for lo, hi in _tile_bounds(len(x), blocks)]
    return F32(_fold(parts, op))


def _merge(a, b):
    """rounds.cuh argmax_merge: the higher value, the lower index on ties."""
    (av, ai), (bv, bi) = a, b
    return (bv, bi) if bv > av or (bv == av and bi < ai) else (av, ai)


def _tiled_argmax(v, blocks):
    parts = []
    for lo, hi in _tile_bounds(len(v), blocks):
        best = (F32(-np.inf), 2 ** 31 - 1)
        for n in range(lo, hi):
            best = _merge(best, (v[n], n))
        parts.append(best)
    return _fold(parts, _merge)[1]


def _tiled_prefix(m, blocks):
    """K16's prefix: each tile's inclusive cumsum (tile-relative, float32,
    in node order) and its total; the tiles' offsets are the totals before
    them, in block order. Returns (relative cum, tile totals, tiles)."""
    tiles = _tile_bounds(len(m), blocks)
    rel = np.zeros(len(m), F32)
    tot = []
    for lo, hi in tiles:
        rel[lo:hi] = np.cumsum(m[lo:hi], dtype=F32)
        tot.append(rel[hi - 1])
    return rel, np.asarray(tot, F32), tiles


def _tiled_search(rel, tot, tiles, slot):
    """searchsorted(cum, slot, side="right") as K16's slots take it: the
    tile whose prefix range [offset, offset + total) holds the slot (the
    block that expands it), then the first node of it whose prefix passes
    the slot."""
    tb, base = 0, F32(0)
    while tb < len(tiles) - 1 and not (slot < F32(base + tot[tb])):
        base = F32(base + tot[tb])
        tb += 1
    lo, hi = tiles[tb]
    while lo < hi:
        mid = (lo + hi) >> 1
        if not (slot < F32(base + rel[mid])):
            lo = mid + 1
        else:
            hi = mid
    return lo, base


BLOCKS = (1, 2, 3, 8, 16)


def _tile_cases(round_inputs, tile_inputs):
    """(label, round buffers, pod, k, group) of the rounds the models run
    on: the round fixture's plain, spread and anti runs, and each run of
    the tile problem."""
    out = []
    for dep in ("plain", "spread", "anti"):
        out.append((dep, *_plain_round(round_inputs[simtpu_torch], dep, 40)))
    for dep in ("racky", "zonal", "hosty"):
        out.append((dep, *_plain_round(tile_inputs, dep, 120)))
    return out


@pytest.mark.parametrize("blocks", BLOCKS)
def test_k14_tiled_normalizers_equal_the_whole_row(round_inputs, tile_inputs, blocks):
    """Per-tile masked minima and maxima folded in block order equal the
    whole row's (the plain version's amin / amax over m_all), on every
    score row a normalizer reads."""
    for label, rb, a, k, g in _tile_cases(round_inputs, tile_inputs):
        buf = rb.buf
        m_all = rb.m_all.numpy()
        rows = [buf.statics.node_pref[g], buf.statics.taint_intol[g], *buf.raw.unbind(0),
                torch.where(rb.m_all, rb.s0, torch.zeros_like(rb.s0)), rb.slope]
        for row in rows:
            x = row.to(torch.float32)
            for is_min, ident in ((True, 3.4e38), (False, -3.4e38), (False, 0.0)):
                fill = torch.full_like(x, ident)
                whole = (torch.where(rb.m_all, x, fill).amin() if is_min else
                         torch.where(rb.m_all, x, fill).amax()).numpy()
                got = _tiled_extreme(x.numpy(), m_all, blocks, is_min, ident)
                assert got.tobytes() == F32(whole).tobytes(), (label, blocks, is_min)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_k14_tiled_argmax_equals_the_first_index_argmax(round_inputs, tile_inputs, blocks):
    """The bootstrap's argmax of where(cap > 0, s0, NEG), per tile by
    argmax_merge and folded in block order, equals torch.argmax (the first
    index of the maximum): on the rounds' scores, on scores rounded into
    ties, and with NEG everywhere."""
    rng = np.random.default_rng(blocks)
    for label, rb, a, k, g in _tile_cases(round_inputs, tile_inputs):
        s0, cap = rb.s0.numpy(), rb.cap.numpy()
        n = len(s0)
        ties = np.round(s0 / F32(25)).astype(F32) * F32(25)
        for score, c in ((s0, cap), (ties, cap), (ties, np.where(rng.random(n) < 0.5, cap, F32(0))),
                         (s0, np.zeros(n, F32))):
            v = np.where(c > 0, score, F32(-3.4e38)).astype(F32)
            want = int(torch.argmax(torch.as_tensor(v)))
            assert _tiled_argmax(v, blocks) == want, (label, blocks)


@pytest.mark.parametrize("blocks", BLOCKS)
def test_k16_tiled_domain_sums_and_dots_equal_the_plain(round_inputs, tile_inputs, blocks):
    """K16's phase 1 by tiles: each tile's small-key bins (node_dom_small),
    fallback-key domain sums (node_dom) and term dots, folded in block
    order, give the plain version's per-node domain totals (`_domain_add`)
    and its dots (valid @ m_n) bit for bit; a unique key is the node's own
    intake."""
    kinds_seen = set()
    for label, rb, a, k, g in _tile_cases(round_inputs, tile_inputs):
        buf = rb.buf
        st = buf.statics
        m = rb.m_n.numpy().astype(F32)
        n = len(m)
        t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub = trounds._round_terms(buf, g)
        want_add = trounds._domain_add(rb, g, rb.m_n).numpy()
        want_dot = (valid_sub.to(torch.float32) @ rb.m_n).numpy()
        kind = rb.key_kind.numpy()
        nds = rb.node_dom_small.numpy()
        node_dom = st.node_dom.numpy()
        tiles = _tile_bounds(n, blocks)
        for t in range(t_cap):
            term = int(terms_g[t])
            if term < 0:
                continue
            key = int(st.term_topo[term])
            dom = node_dom[key]
            kinds_seen.add(int(kind[key]))
            bins, sums, dots = [], [], []
            for lo, hi in tiles:
                b = np.zeros(trounds.DOM_SMALL, F32)
                s = np.zeros(rb.n_domains, F32)
                for node in range(lo, hi):
                    if dom[node] < 0:
                        continue
                    if kind[key] == 1 and nds[key, node] >= 0:
                        b[nds[key, node]] += m[node]
                    elif kind[key] == 0:
                        s[dom[node]] += m[node]
                bins.append(b)
                sums.append(s)
                dots.append(np.sum(np.where(dom[lo:hi] >= 0, m[lo:hi], F32(0)), dtype=F32))
            b_all = _fold(bins, lambda x, y: (x + y).astype(F32))
            s_all = _fold(sums, lambda x, y: (x + y).astype(F32))
            got = np.zeros(n, F32)
            for node in range(n):
                if dom[node] < 0:
                    continue
                got[node] = (m[node] if kind[key] == 2 else
                             (b_all[nds[key, node]] if nds[key, node] >= 0 else F32(0)) if kind[key] == 1 else
                             s_all[dom[node]])
            assert got.tobytes() == want_add[t].astype(F32).tobytes(), (label, blocks, t)
            assert F32(_fold(dots, lambda x, y: F32(x + y))).tobytes() == F32(want_dot[t]).tobytes()
    assert kinds_seen == {0, 1, 2}


def _check_prefix(label, m, k_cap, blocks):
    """The tiled prefix and search of intakes `m` against torch.cumsum and
    torch.searchsorted, bit for bit."""
    rel, tot, tls = _tiled_prefix(m, blocks)
    want = torch.cumsum(torch.as_tensor(m), 0)
    offs = np.concatenate([[F32(0)], np.cumsum(tot, dtype=F32)[:-1]]).astype(F32)
    got = np.concatenate([(rel[a_:b_] + offs[j]).astype(F32) for j, (a_, b_) in enumerate(tls)])
    assert got.tobytes() == want.numpy().tobytes(), (label, blocks)
    slots = torch.arange(k_cap, dtype=torch.float32)
    want_a = torch.searchsorted(want, slots, right=True).numpy()
    total = np.sum(tot, dtype=F32)
    for j in range(k_cap):
        a_, base = _tiled_search(rel, tot, tls, F32(j))
        if F32(j) < total:
            assert a_ == want_a[j], (label, blocks, j)
            assert F32(base + rel[a_]).tobytes() == want[a_].numpy().tobytes()


@pytest.mark.parametrize("blocks", BLOCKS)
def test_k16_tiled_prefix_and_search_equal_cumsum(round_inputs, tile_inputs, blocks):
    """The tile-relative prefix plus the tiles' offsets equals
    torch.cumsum(m_n), and the two-level search equals torch.searchsorted
    (side="right") on every slot: on the rounds' intakes, with a whole tile
    of no pods, and with 3.4e38 beside it (the sums saturate and overflow
    alike in any order)."""
    rng = np.random.default_rng(blocks)
    cases = [(label, rb.m_n.numpy().astype(F32), rb.k_cap)
             for label, rb, a, k, g in _tile_cases(round_inputs, tile_inputs)]
    n = 170
    tiles = _tile_bounds(n, blocks)
    empty = rng.integers(0, 4, n).astype(F32)
    lo, hi = tiles[len(tiles) // 2]
    empty[lo:hi] = 0
    cases.append(("empty tile", empty, int(empty.sum()) + 8))
    big = empty.copy()
    big[max(lo - 1, 0)] = F32(3.4e38)
    big[min(hi, n - 1)] = F32(3.4e38)
    cases.append(("3.4e38 beside it", big, int(empty[:max(lo - 1, 0)].sum()) + 8))
    for label, m, k_cap in cases:
        with np.errstate(over="ignore"):
            _check_prefix(label, m, k_cap, blocks)

