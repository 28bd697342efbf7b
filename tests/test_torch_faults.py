"""simtpu_torch's fault subsystem against the JAX package's.

`simtpu_torch/faults` (scenarios, drain and requeue, the batched sweep
through K18 `sweep_drain` and K19 `sweep_place`) and
`simtpu_torch/plan/resilience.py` are held against `simtpu/faults` and
`simtpu/plan/resilience.py` on every case of tests/test_faults.py that
needs no mesh, on the same problems (pod names seeded alike): per-scenario
requeue rows, landing nodes and reasons must be equal, and so must the
scenario masks, drain results and plans. Below that, the JAX package's
compiled `_fault_sweep` and the port's `fault_sweep` on CPU tensors (the
plain K18 and K19) run on the same numpy inputs (drained planes
bit-equal, nodes and reasons equal), a sweep leaves the engine's carry
as it found it, and scenarios that differ from
block to block give each scenario its own answer. Last, the audit cases of
tests/test_audit.py that reach the sweep, and both CLIs' `resilience` and
`apply --faults` documents.

The JAX side runs its auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`).
"""

import importlib
import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

import simtpu
import simtpu.faults as jf
import simtpu_torch
import simtpu_torch.faults as tf
from simtpu import constants as JC
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.faults import sweep as jsweep
from simtpu_torch import smoke
from simtpu_torch.engine import batched
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.faults import sweep as tsweep
from simtpu_torch.kernels import cuda

from .test_torch_kernels import _numpy_tree, _port_flags
from .test_torch_simulate import REPO
from ._threads import one_torch_thread  # noqa: F401 (autouse)

SWEEP_KEYS = ("evicted", "lost", "requeued", "unplaced", "requeue_rows", "requeue_nodes",
              "requeue_reasons")


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _synth(pkg):
    return importlib.import_module(f"{pkg.__name__}.synth")


def _mixed_problem(pkg, node_seed=21, app_seed=22, n_nodes=10, n_pods=60):
    synth = _synth(pkg)
    cluster = synth.synth_cluster(n_nodes, seed=node_seed, zones=3, taint_frac=0.1,
                                  gpu_frac=0.3, storage_frac=0.3)
    apps = synth.synth_apps(n_pods, seed=app_seed, zones=3, pods_per_deployment=10,
                            selector_frac=0.2, toleration_frac=0.1, anti_affinity_frac=0.3,
                            gpu_frac=0.2, storage_frac=0.2)
    return cluster, apps


def _place(pkg, problem=_mixed_problem, **kw):
    """(cluster, PlacedCluster) of the mixed problem (or `problem`), pod
    names seeded."""
    pkg.workloads.expand.seed_name_hashes(41)
    try:
        cluster, apps = problem(pkg, **kw)
        if pkg is simtpu:
            return cluster, jf.place_cluster(cluster, apps)
        return cluster, tf.place_cluster(cluster, apps, device="cpu")
    finally:
        pkg.workloads.expand.seed_name_hashes(None)


@pytest.fixture(scope="module")
def placed():
    """The mixed problem placed by both packages: {"jax": (cluster, pc),
    "torch": (cluster, pc)}, the base placements equal."""
    out = {"jax": _place(simtpu), "torch": _place(simtpu_torch)}
    assert np.array_equal(out["jax"][1].nodes, out["torch"][1].nodes)
    return out


def _same_sweep(a, b):
    for key in SWEEP_KEYS:
        assert np.array_equal(getattr(a, key), getattr(b, key)), key
    assert a.scenarios.labels == b.scenarios.labels
    assert a.counters() | {"fault_scenarios_per_s": 0} == b.counters() | {"fault_scenarios_per_s": 0}
    assert a.worst() == b.worst() and a.critical_nodes() == b.critical_nodes()


def _sweep_unplaced_sets(sw):
    out = []
    for s in range(len(sw.scenarios)):
        mask = (sw.requeue_rows[s] >= 0) & (sw.requeue_nodes[s] < 0)
        out.append(frozenset(int(x) for x in sw.requeue_rows[s][mask]))
    return out


class TestSweepSerialEquivalence:
    def test_exhaustive_single_node_matches_serial_replay(self, placed):
        """The port's batched sweep equals its own serial replay and the
        JAX package's sweep on every single-node scenario."""
        sweeps = {}
        for name, mod in (("jax", jf), ("torch", tf)):
            cluster, pc = placed[name]
            scen = mod.single_node_scenarios(pc.n_nodes, nodes=cluster.nodes)
            sweeps[name] = mod.sweep_scenarios(pc, scen)
        cluster, pc = placed["torch"]
        sw = sweeps["torch"]
        counts, sets = tf.serial_replay(pc, sw.scenarios)
        assert np.array_equal(sw.unplaced, counts)
        assert _sweep_unplaced_sets(sw) == sets
        assert sw.evicted.sum() > 0
        _same_sweep(sweeps["jax"], sw)

    def test_domain_and_k2_scenarios_match_serial_replay(self, placed):
        sweeps = {}
        for name, mod, C in (("jax", jf, JC), ("torch", tf, simtpu_torch.constants)):
            cluster, pc = placed[name]
            scen = mod.stack_scenarios([
                mod.domain_scenarios(cluster.nodes, C.LABEL_ZONE),
                mod.domain_scenarios(cluster.nodes, C.LABEL_RACK),
                mod.k_node_scenarios(pc.n_nodes, 2, samples=12, seed=5),
            ])
            sweeps[name] = mod.sweep_scenarios(pc, scen, s_chunk=8)
        _, pc = placed["torch"]
        counts, sets = tf.serial_replay(pc, sweeps["torch"].scenarios)
        assert np.array_equal(sweeps["torch"].unplaced, counts)
        assert _sweep_unplaced_sets(sweeps["torch"]) == sets
        _same_sweep(sweeps["jax"], sweeps["torch"])

    def test_mesh_and_pipeline_are_not_ported(self, placed):
        cluster, pc = placed["torch"]
        scen = tf.single_node_scenarios(pc.n_nodes, nodes=cluster.nodes)
        for kw in ({"mesh": object()}, {"pipeline": object()}):
            with pytest.raises(NotImplementedError, match="#10"):
                tf.sweep_scenarios(pc, scen, **kw)


class TestDrainProperties:
    @pytest.mark.parametrize("seed", [0, 23])
    def test_failure_free_drain_is_noop_and_masks_hold(self, seed):
        """An empty node mask drains nothing and leaves the log as it was;
        non-empty masks never see a drained pod reappear on a failed node,
        restore=True returns the log to the base placement, and every
        drain equals the JAX package's."""
        kw = dict(node_seed=100 + seed, app_seed=200 + seed, n_nodes=8, n_pods=40)
        (_, jpc), (_, pc) = _place(simtpu, **kw), _place(simtpu_torch, **kw)
        log_before = (list(pc.engine.placed_node), list(pc.engine.placed_group))
        res = tf.drain_requeue(pc, np.zeros(pc.n_nodes, bool), restore=True)
        assert len(res.evicted_rows) == 0 and res.unplaced == 0
        assert (list(pc.engine.placed_node), list(pc.engine.placed_group)) == log_before
        assert pc.engine.node_valid is None
        empty = tf.ScenarioSet(masks=np.zeros((1, pc.n_nodes), bool), labels=("none",))
        sw = tf.sweep_scenarios(pc, empty)
        assert sw.evicted[0] == 0 and sw.unplaced[0] == 0
        rng = np.random.default_rng(seed)
        for _ in range(3):
            mask = np.zeros(pc.n_nodes, bool)
            mask[rng.choice(pc.n_nodes, size=2, replace=False)] = True
            out = tf.drain_requeue(pc, mask, restore=True)
            want = jf.drain_requeue(jpc, mask, restore=True)
            landed = out.requeue_nodes[out.requeue_nodes >= 0]
            assert not mask[landed].any(), "drained pod reappeared on a failed node"
            assert list(pc.engine.placed_node) == log_before[0]
            for key in ("evicted_rows", "lost_rows", "requeue_rows", "requeue_nodes",
                        "requeue_reasons"):
                assert np.array_equal(getattr(out, key), getattr(want, key)), key

    def test_restore_leaves_sweep_reproducible(self, placed):
        cluster, pc = placed["torch"]
        scen = tf.single_node_scenarios(pc.n_nodes, nodes=cluster.nodes)
        first = tf.sweep_scenarios(pc, scen)
        tf.serial_replay(pc, scen, limit=3)
        second = tf.sweep_scenarios(pc, scen)
        assert np.array_equal(first.unplaced, second.unplaced)
        assert np.array_equal(first.requeue_nodes, second.requeue_nodes)

    @pytest.mark.parametrize("compact", [True, False])
    def test_sweep_leaves_the_engine_carry_untouched(self, compact):
        """The sweep only reads the base carry: the engine's carry (compact
        or dense) is equal, plane by plane, before and after."""
        cluster, apps = _mixed_problem(simtpu_torch)

        def factory(tz, device):
            eng = tscan.Engine(tz, device)
            eng.compact = compact
            return eng

        pc = tf.place_cluster(cluster, apps, device="cpu", engine_factory=factory)
        before = [t.clone() for t in pc.engine.last_state]
        sw = tf.sweep_scenarios(pc, tf.generate_scenarios(cluster.nodes, "k=1,zone"))
        assert sw.evicted.sum() > 0
        assert isinstance(pc.engine.last_state, tstate.CompactState) == compact
        assert all(torch.equal(a, b) for a, b in zip(before, pc.engine.last_state))


class TestDrainSimulator:
    def test_preemption_honors_fault_mask(self):
        """The facade-level drain requeues through the full simulate() flow
        in both packages alike; no pod of the final result sits on the
        failed node, and bound and DaemonSet pods die with it."""
        from tests.fixtures import make_fake_pod, with_pod_node_name

        out = []
        for pkg, mod in ((simtpu, jf), (simtpu_torch, tf)):
            pkg.workloads.expand.seed_name_hashes(31)
            cluster, apps = _mixed_problem(pkg, n_nodes=6, n_pods=30)
            sim = pkg.api.Simulator() if pkg is simtpu else pkg.api.Simulator(device="cpu")
            work = pkg.ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
            work.pods = pkg.workloads.expand.get_valid_pods_exclude_daemonset(work)
            work.pods += [make_fake_pod(f"bound-{i}", "default", "100m", "64Mi",
                                        with_pod_node_name(f"node-{i:06d}")) for i in range(6)]
            sim.run_cluster(work)
            for app in apps:
                sim.schedule_app(app)
            counts = np.bincount(np.asarray(sim._engine.placed_node), minlength=len(cluster.nodes))
            target = int(np.argmax(counts))
            mask = np.zeros(len(cluster.nodes), bool)
            mask[target] = True
            res = mod.drain_simulator(sim, mask)
            final = smoke.placement_record(sim._result())
            pkg.workloads.expand.seed_name_hashes(None)
            out.append((target, len(res.evicted_rows), len(res.lost_rows), res.preempted,
                        res.extra_unscheduled, final))
            assert not sim._engine.node_valid[target]
        want, got = out
        assert got == want
        target, evicted, lost, _, _, final = got
        assert evicted > 0 and lost >= 1
        assert target not in final["placed"].values()
        assert f"default/bound-{target}" not in final["placed"]


class TestScenarioModel:
    def test_k_scenarios_deterministic_distinct_and_equal(self):
        for args in ((40, 2, 16, 3), (40, 2, 16, 4), (6, 2, 100, 0), (30, 3, 50, 7)):
            n, k, samples, seed = args
            a = tf.k_node_scenarios(n, k, samples=samples, seed=seed)
            b = jf.k_node_scenarios(n, k, samples=samples, seed=seed)
            assert np.array_equal(a.masks, b.masks) and a.labels == b.labels
            assert len({m.tobytes() for m in a.masks}) == len(a)
            assert (a.masks.sum(axis=1) == k).all()
        assert len(tf.k_node_scenarios(6, 2, samples=100, seed=0)) == 15  # C(6, 2)

    def test_parse_spec(self):
        spec = "k=1,k=3:50,zone,label:foo/bar"
        assert tf.parse_fault_spec(spec) == jf.parse_fault_spec(spec)
        with pytest.raises(ValueError):
            tf.parse_fault_spec("bogus")

    def test_domain_and_generated_scenarios_equal(self):
        for pkg, mod in ((simtpu, jf), (simtpu_torch, tf)):
            cluster = _synth(pkg).synth_cluster(12, seed=9, zones=3)
            valid = np.arange(12) < 9
            got = [mod.generate_scenarios(cluster.nodes, spec, samples=7, seed=2, valid=v)
                   for spec in ("k=1", "zone,rack", "k=2,host", "label:topology.kubernetes.io/zone")
                   for v in (None, valid)]
            if mod is jf:
                want = got
            else:
                for a, b in zip(got, want):
                    assert np.array_equal(a.masks, b.masks)
                    assert (a.labels, a.kind, a.k) == (b.labels, b.kind, b.k)
        zones = tf.domain_scenarios(cluster.nodes, simtpu_torch.constants.LABEL_ZONE)
        assert len(zones) == 3 and zones.masks.any(axis=0).all()


def _plan_doc(plan) -> dict:
    doc = {k: v for k, v in plan.counters().items() if k not in smoke.TIMING_KEYS}
    doc["audit"] = smoke.audit_doc_record(plan.audit)
    doc["probes"] = {str(k): v for k, v in sorted(plan.probes.items())}
    doc["message"] = plan.message
    doc["worst"] = plan.sweep.worst() if plan.sweep is not None else None
    return doc


def _small_plan(pkg):
    synth = _synth(pkg)
    labels = {"topology.kubernetes.io/zone": "zone-a"}
    cluster = pkg.ResourceTypes()
    cluster.nodes = [synth.make_node(f"n{i}", 8000, 32, {"kubernetes.io/hostname": f"n{i}", **labels})
                     for i in range(4)]
    res = pkg.ResourceTypes()
    res.deployments.append(synth.make_deployment("web", 28, 1000, 256))
    template = synth.make_node("tmpl", 8000, 32, {"kubernetes.io/hostname": "tmpl", **labels})
    return cluster, [pkg.AppResource(name="web", resource=res)], template


def _both_plans(build, **kw):
    from simtpu.plan.resilience import plan_resilience as j_plan
    from simtpu_torch.plan.resilience import plan_resilience as t_plan

    plans = []
    for pkg, fn, extra in ((simtpu, j_plan, {}), (simtpu_torch, t_plan, {"device": "cpu"})):
        cluster, apps, template = build(pkg)
        plans.append(fn(cluster, apps, template, **kw, **extra))
    return plans


class TestPlanResilience:
    def test_plans_enough_nodes_to_survive_any_single_failure(self):
        want, got = _both_plans(_small_plan, k=1, max_new_nodes=8, seed=1)
        assert _plan_doc(got) == _plan_doc(want)
        assert got.success and got.nodes_added >= 1
        assert got.sweep is not None and bool(got.sweep.survived.all())
        assert got.probes[0]["survived"] < got.probes[0]["scenarios"]

    def test_linear_search_and_quantile(self):
        want, got = _both_plans(_small_plan, spec="k=2:6", quantile=0.5, max_new_nodes=6,
                                search="linear")
        assert _plan_doc(got) == _plan_doc(want)

    def test_assess_only_mode(self):
        def build(pkg):
            cluster, apps = _mixed_problem(pkg)
            return cluster, apps, None

        want, got = _both_plans(build, k=1)
        assert _plan_doc(got) == _plan_doc(want)
        assert 0 in got.probes and "plan_resilience_s" in got.counters()

    def test_unported_options_raise(self):
        from simtpu_torch.plan.resilience import plan_resilience

        cluster, apps, template = _small_plan(simtpu_torch)
        for kw, item in (({"checkpoint": object()}, 8), ({"control": object()}, 8),
                         ({"pipeline": object()}, 10), ({"mesh": object()}, 10)):
            with pytest.raises(NotImplementedError, match=f"#{item}"):
                plan_resilience(cluster, apps, template, device="cpu", **kw)


# -- the batched kernels' functions on the JAX package's own inputs ----------


def _jax_chunk(pc, masks, r):
    """The JAX package's `_fault_sweep` inputs for `masks` (one chunk, as
    `sweep_scenarios`' gather_block builds them) and the real requeue
    counts per scenario."""
    eng = pc.engine
    tensors = pc.tensors
    log_nodes = np.asarray(eng.placed_node, np.int32)
    dies = pc.dies_with_node
    ev_lists = [np.flatnonzero(m[log_nodes]) for m in masks]
    rq_lists = [pc.log_row[ev][~dies[pc.log_row[ev]]] for ev in ev_lists]
    e_pad = max(1, max(len(v) for v in ev_lists))
    r_pad = max(1, max(len(v) for v in rq_lists))
    s_n, n = masks.shape
    ev_idx = np.full((s_n, e_pad), -1, np.int64)
    rq_idx = np.full((s_n, r_pad), -1, np.int64)
    for s in range(s_n):
        ev_idx[s, : len(ev_lists[s])] = ev_lists[s]
        rq_idx[s, : len(rq_lists[s])] = rq_lists[s]
    ev_ok, ev_safe = ev_idx >= 0, np.maximum(ev_idx, 0)
    ext = eng.ext_log
    log_gpu = np.asarray(ext["gpu_shares"], np.float32) * np.asarray(ext["gpu_mem"], np.float32)[:, None]
    entries = (
        np.where(ev_ok, np.asarray(eng.placed_group, np.int32)[ev_safe], 0).astype(np.int32),
        np.where(ev_ok, log_nodes[ev_safe], 0).astype(np.int32),
        np.where(ev_ok, -1.0, 0.0).astype(np.float32),
        eng.log_req_matrix(r)[ev_safe],
        np.asarray(ext["vg_alloc"], np.float32)[ev_safe],
        np.asarray(ext["sdev_take"], bool)[ev_safe] & ev_ok[..., None],
        log_gpu[ev_safe],
    )
    _, pods_full = jscan.build_pod_arrays(pc.batch, r)
    rq_ok, rq_safe = rq_idx >= 0, np.maximum(rq_idx, 0)

    def pod_col(arr, fill=0):
        got = arr[rq_safe]
        keep = rq_ok.reshape(rq_ok.shape + (1,) * (got.ndim - 2))
        return np.where(keep, got, fill).astype(arr.dtype)

    pods = (pod_col(pods_full[0]), pod_col(pods_full[1]), pod_col(pods_full[2], fill=-1),
            pod_col(pods_full[3])) + tuple(pod_col(a) for a in pods_full[4:])
    return ~masks, entries, pods, np.asarray([len(v) for v in rq_lists])


def port_inputs_from_jax(valid_s, entries_s, pods_s, n_real, device="cpu"):
    """The port's sweep inputs from the JAX `_fault_sweep`'s: the [S, E]
    entries flattened into a log of S*E rows with `ev_idx[s, e]` its row
    (-1 where w = 0, JAX's padding), the [S, R] pods flattened into a batch
    of S*R rows with `rq_idx[s, j]` its row for the `n_real[s]` real pods
    (-1 on the phantom rows)."""
    s_n, e_pad = entries_s[0].shape
    r_pad = pods_s[0].shape[1]
    log = batched.upload_log(tuple(np.ascontiguousarray(x.reshape((s_n * e_pad,) + x.shape[2:]))
                                   for x in entries_s), device)
    ev_idx = np.where(entries_s[2] != 0, np.arange(s_n * e_pad).reshape(s_n, e_pad), -1)
    pods = tuple(np.ascontiguousarray(x.reshape((s_n * r_pad,) + x.shape[2:])) for x in pods_s)
    rq_idx = np.where(np.arange(r_pad)[None, :] < np.asarray(n_real)[:, None],
                      np.arange(s_n * r_pad).reshape(s_n, r_pad), -1)
    return (torch.as_tensor(np.asarray(valid_s, bool), device=device), log,
            torch.as_tensor(ev_idx.astype(np.int32), device=device), pods,
            torch.as_tensor(rq_idx.astype(np.int32), device=device))


def _jax_drained(statics, state, entries_s):
    def one(entries):
        return jax.lax.scan(partial(jstate.placement_delta_step, statics), state, entries)[0]

    return jax.jit(jax.vmap(one))(entries_s)


@pytest.mark.parametrize("spec", ["k=1", "zone,k=2:9"])
def test_fault_sweep_plain_equals_the_jax_fault_sweep(placed, spec):
    """The JAX package's compiled `_fault_sweep` and the port's
    `fault_sweep` on CPU tensors, which runs the plain K18 and K19, on the
    same numpy inputs: every drained replica plane bit-equal to the
    vmapped delta scan's, every real requeue row's landing node and reason
    equal."""
    _check_fault_sweep(placed, spec)


#: above K19's one-node-per-thread range (1024 nodes): its 2-node template
WIDE_NODES, WIDE_PODS = 1100, 240


@pytest.fixture(scope="module")
def placed_wide():
    """The mixed problem on WIDE_NODES nodes, placed by both packages."""
    kw = dict(n_nodes=WIDE_NODES, n_pods=WIDE_PODS)
    out = {"jax": _place(simtpu, **kw), "torch": _place(simtpu_torch, **kw)}
    assert np.array_equal(out["jax"][1].nodes, out["torch"][1].nodes)
    return out


def test_fault_sweep_plain_equals_the_jax_fault_sweep_above_1024_nodes(placed_wide):
    """As above on 1100 nodes, three zone outages whose requeue holds
    storage and GPU pods."""
    live = _check_fault_sweep(placed_wide, "zone")
    assert (live & 1).any() and (live & 2).any(), "storage and GPU pods in the requeue"


#: past the 4096 topology keys K18's packed sort keys held: the many-keys
#: problem (smoke.many_keys_problem, 4100 keys, Tc = 64 a group)
MANY_KEYS_NODES, MANY_KEYS_REPLICAS = 64, 2


def _many_keys_problem(pkg, n_nodes, replicas):
    return smoke.many_keys_problem(_synth(pkg), pkg.AppResource, pkg.ResourceTypes, n_nodes, replicas)


@pytest.fixture(scope="module")
def placed_many_keys():
    """The many-keys problem, placed by both packages."""
    kw = dict(problem=_many_keys_problem, n_nodes=MANY_KEYS_NODES, replicas=MANY_KEYS_REPLICAS)
    out = {"jax": _place(simtpu, **kw), "torch": _place(simtpu_torch, **kw)}
    assert np.array_equal(out["jax"][1].nodes, out["torch"][1].nodes)
    return out


def test_fault_sweep_plain_equals_the_jax_fault_sweep_past_4096_keys(placed_many_keys):
    """As above on the many-keys problem: two single-node scenarios on the
    nodes whose pods own the highest topology key ids (past 4095)."""
    _, jpc = placed_many_keys["jax"]
    statics = jscan.statics_from(jpc.tensors, jpc.engine.sched_config)
    assert np.asarray(statics.node_dom).shape[0] >= smoke.MANY_KEYS
    g_terms, topo = np.asarray(statics.g_terms), np.asarray(statics.term_topo)
    assert g_terms.shape[1] <= 64
    group_key = np.where(g_terms >= 0, topo[np.maximum(g_terms, 0)], -1).max(axis=1)
    node_key = np.full(jpc.n_nodes, -1)
    np.maximum.at(node_key, np.asarray(jpc.engine.placed_node), group_key[np.asarray(jpc.engine.placed_group)])
    pick = np.argsort(-node_key, kind="stable")[:2]
    assert node_key[pick].min() >= 4096
    masks = np.zeros((2, jpc.n_nodes), bool)
    masks[[0, 1], pick] = True
    _check_fault_sweep(placed_many_keys, masks=masks)


def _check_fault_sweep(placed, spec=None, masks=None):
    """The body of the tests above (scenarios from `spec`, or `masks`);
    returns the ext_live bits of the real requeue rows."""
    cluster, jpc = placed["jax"]
    tensors = jpc.tensors
    r = tensors.alloc.shape[1]
    if masks is None:
        masks = jf.generate_scenarios(cluster.nodes, spec, samples=9, seed=4).masks
    valid_s, entries_s, pods_s, n_real = _jax_chunk(jpc, masks, r)
    flags = jscan.flags_from(tensors, jpc.batch.ext)
    statics = jscan.statics_from(tensors, jpc.engine.sched_config)
    state = jsweep._base_state(jpc)
    j_nodes, j_reasons = jsweep._fault_sweep(statics, valid_s, state, entries_s, pods_s, flags)
    j_nodes, j_reasons = np.asarray(j_nodes), np.asarray(j_reasons)
    j_drained = _numpy_tree(_jax_drained(statics, state, entries_s))

    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(state), "cpu")
    valid, log, ev_idx, pods, rq_idx = port_inputs_from_jax(valid_s, entries_s, pods_s, n_real)
    t_flags = _port_flags(flags)
    reps = batched.sweep_drain_plain(t_statics, t_state, log, ev_idx)
    for name, got, want in zip(tstate.SchedState._fields, reps, j_drained):
        assert np.array_equal(got.numpy(), want), name
    batch_buf = tscan.StepBuffers(t_statics, t_state, pods, t_flags)
    cuda.reset_counts()
    nodes, reasons = tsweep.fault_sweep(t_statics, valid, t_state, log, ev_idx, batch_buf, pods, rq_idx)
    assert not cuda.LAUNCHES
    assert cuda.PLAIN_CALLS["sweep_drain"] == cuda.PLAIN_CALLS["sweep_place"] == 1
    real = rq_idx.numpy() >= 0
    assert real.sum() == n_real.sum() > 0
    assert np.array_equal(nodes[real], j_nodes[real])
    assert np.array_equal(reasons[real], j_reasons[real])
    assert (nodes[~real] == -1).all()
    return batch_buf.ext_live.numpy()[rq_idx.numpy()[real]]


def test_wrappers_take_the_plain_versions_on_the_cpu(placed):
    """On CPU tensors `sweep_drain` / `sweep_place` run their plain
    versions (and count them), never a launch."""
    cluster, pc = placed["torch"]
    cuda.reset_counts()
    sw = tf.sweep_scenarios(pc, tf.generate_scenarios(cluster.nodes, "zone"), s_chunk=2)
    assert not cuda.LAUNCHES
    chunks = -(-len(sw.scenarios) // 2)
    assert cuda.PLAIN_CALLS["sweep_drain"] == cuda.PLAIN_CALLS["sweep_place"] == chunks
    assert sw.timings["chunks"] == chunks


def test_scenarios_that_differ_per_block(placed):
    """One chunk whose scenarios differ block by block (the empty
    scenario, single nodes, a pair, a zone, every node): each scenario's
    answer equals the one it gets alone in a chunk of its own, and the JAX
    package's — a replica mix-up would make scenario s read another's
    state."""
    cluster, pc = placed["torch"]
    _, jpc = placed["jax"]
    n = pc.n_nodes
    masks = np.zeros((7, n), bool)
    masks[1, 3] = True
    masks[2, 0] = True
    masks[3, [1, 7]] = True
    masks[4] = tf.domain_scenarios(cluster.nodes, simtpu_torch.constants.LABEL_ZONE).masks[1]
    masks[5, n - 1] = True
    masks[6] = True
    labels = tuple(f"case:{s}" for s in range(len(masks)))
    together = tf.sweep_scenarios(pc, tf.ScenarioSet(masks=masks, labels=labels), s_chunk=8)
    alone = tf.sweep_scenarios(pc, tf.ScenarioSet(masks=masks, labels=labels), s_chunk=1)
    want = jf.sweep_scenarios(jpc, jf.ScenarioSet(masks=masks, labels=labels), s_chunk=8)
    for key in SWEEP_KEYS:
        assert np.array_equal(getattr(together, key), getattr(alone, key)), key
        assert np.array_equal(getattr(together, key), getattr(want, key)), key
    assert len(set(together.unplaced.tolist())) > 2


# -- the audit cases of tests/test_audit.py on the sweep path ----------------


def test_resilience_planner_ships_certified_fallback():
    from simtpu_torch.plan.resilience import plan_resilience

    cluster, apps, template = _small_plan(simtpu_torch)
    plan = plan_resilience(cluster, apps, template, k=1, max_new_nodes=10, device="cpu",
                           _audit_inject=True)
    assert plan.success
    assert plan.audit["fallback"] is True and plan.audit["ok"] is True
    assert plan.audit["fallback_audit"]["ok"] is True
    assert plan.audit["divergence"]["divergent_pods"] >= 1
    # the survivability verdict describes the CERTIFIED placement
    assert plan.sweep is not None


def test_audit_placed_cluster_falls_back_to_the_serial_exact_engine():
    """An audit-dirty base placement (the audit's view corrupted) is
    re-placed by the serial exact engine — the wavefront and the compact
    carry off — re-audited clean, and shipped with the divergence record,
    as the JAX package's `audit_placed_cluster` does."""
    import simtpu.audit.checker as jchecker
    from simtpu_torch.audit import checker

    (_, jpc), (_, pc) = _place(simtpu), _place(simtpu_torch)
    clean_pc, clean_doc, hard = checker.audit_placed_cluster(pc)
    assert clean_pc is pc and clean_doc["ok"] is True and hard is None
    got_pc, doc, hard = checker.audit_placed_cluster(pc, inject=True)
    want_pc, want, _ = jchecker.audit_placed_cluster(jpc, inject=True)
    assert hard is None and doc["fallback"] is True and doc["ok"] is True
    assert not got_pc.engine.speculate and not got_pc.engine.compact
    assert smoke.audit_doc_record(doc) == smoke.audit_doc_record(want)
    assert np.array_equal(got_pc.nodes, want_pc.nodes)


def test_audit_false_opts_out_and_clean_audit_rides():
    from simtpu_torch.plan.resilience import plan_resilience

    cluster, apps, template = _small_plan(simtpu_torch)
    off = plan_resilience(cluster, apps, template, k=1, max_new_nodes=10, audit=False, device="cpu")
    on = plan_resilience(cluster, apps, template, k=1, max_new_nodes=10, device="cpu")
    assert off.success and off.audit == {}
    assert on.success and on.audit["ok"] is True and on.audit["violations"] == 0


def test_faults_sweep_hard_audit_failure_exit_4(monkeypatch, capsys):
    """When neither the --faults sweep's base placement nor the
    serial-exact fallback certifies, the plan stays but the exit code is
    EXIT_AUDIT and the audit doc rides resilience.audit."""
    import simtpu_torch.audit.checker as checker
    from simtpu_torch.cli import EXIT_AUDIT, main

    monkeypatch.chdir(REPO)
    doc_in = {"ok": False, "violations": 1, "by_class": {"overcommit": 1}}

    def fake(pc, progress=None, inject=False):
        return pc, doc_in, "audit failure: nothing certified"

    monkeypatch.setattr(checker, "audit_placed_cluster", fake)
    rc = main(["apply", "-f", "examples/simtpu-config.yaml", "--json", "--faults", "k=1",
               "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == EXIT_AUDIT
    assert doc["success"] is True
    assert "nothing certified" in doc["resilience"]["error"]
    assert doc["resilience"]["audit"] == doc_in


CLI_CASES = {
    "resilience": ["resilience", "-f", "examples/simtpu-config.yaml", "--json"],
    "resilience-zone-k2": ["resilience", "-f", "examples/simtpu-config.yaml", "--json",
                           "--faults", "k=2,zone"],
    "resilience-plan": ["resilience", "-f", "examples/simtpu-config.yaml", "--json", "--plan",
                        "--max-new-nodes", "3"],
    "apply-faults": ["apply", "-f", "examples/simtpu-config.yaml", "--json", "--faults", "k=1"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_documents_equal(monkeypatch, case):
    """Both CLIs' `resilience` and `apply --faults` documents on the
    example config are equal apart from timings (the audit cut to its
    counters); `resilience` carries its clean audit."""
    from simtpu.cli import main as j_main
    from simtpu_torch.cli import main as t_main

    monkeypatch.chdir(REPO)
    argv = CLI_CASES[case]
    out = []
    for pkg, main in ((simtpu, j_main), (simtpu_torch, t_main)):
        pkg.workloads.expand.seed_name_hashes(23)
        try:
            rc, doc = smoke.run_cli_json(main, argv + ([] if pkg is simtpu else ["--device", "cpu"]))
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        doc = smoke.doc_record(doc)
        out.append((rc, doc.get("resilience") if argv[0] == "apply" else doc))
    assert out[1] == out[0]
    rc, doc = out[1]
    if "--plan" in argv:
        assert doc["candidates_probed"] >= 1 and doc["partial"] is False
    else:
        assert doc["scenarios"] > 0 and doc["audit"]["ok"] is True


def test_sweep_modules_import_neither_jax_nor_simtpu():
    import os
    import subprocess
    import sys

    mods = ("simtpu_torch.faults", "simtpu_torch.faults.sweep", "simtpu_torch.parallel.sweep",
            "simtpu_torch.plan.resilience", "simtpu_torch.engine.batched", "simtpu_torch.cli")
    code = (
        "import sys; " + "; ".join(f"import {m}" for m in mods) + "; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'simtpu' or m.startswith('simtpu.')]; print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
