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
