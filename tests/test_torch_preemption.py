"""Priority preemption: `simtpu_torch.simulate(device="cpu")` against
`simtpu.simulate`, case for case.

Each non-slow case of tests/test_preemption.py — victim choice, the
minimal victim set, PodDisruptionBudget flips and budgets, port holders,
static failures, the wave-commit and affinity-dependence rules, the
mid-batch bookkeeping and the wave-cap abort — is built once with each
package's objects and run through both packages' serial path; the placement
records (the preempted pods included) and the final carried state planes
must be equal. Three more cases preempt for GPU memory, for Open-Local
storage and at 60 nodes (100 evictions).

Out of this slice (ROADMAP): the cases that need `bulk=True` or the compact
carry (`test_preemption_at_100k_scale`, `test_preemption_at_scale` as
written, `test_preemption_under_compact_rides_direct_delta`); the scale
case runs here serially, smaller.
"""

import copy
import json
import logging

import pytest

import simtpu
import simtpu_torch

from .fixtures import (
    make_fake_node,
    make_fake_pod,
    with_node_allocatable,
    with_node_labels,
    with_node_local_storage,
    with_pod_affinity,
    with_pod_annotations,
    with_pod_labels,
)
from .test_torch_simulate import _carried, assert_same_simulation

GI = 2**30


def _prio(pod, p):
    pod["spec"]["priority"] = p
    return pod


def _bound(pod, node):
    pod["spec"]["nodeName"] = node
    return pod


def _labels(pod, labels):
    pod["metadata"]["labels"] = dict(labels)
    return pod


def _pdb(name, match_labels, allowed=0, selector=None):
    return {
        "apiVersion": "policy/v1beta1",
        "kind": "PodDisruptionBudget",
        "metadata": {"name": name, "namespace": "default"},
        "spec": {"selector": {"matchLabels": dict(match_labels)} if selector is None else selector},
        "status": {"disruptionsAllowed": allowed},
    }


def _cluster(pkg, nodes, pods, pdbs=()):
    cluster = pkg.ResourceTypes(nodes=nodes, pods=pods)
    cluster.pod_disruption_budgets = list(pdbs)
    return cluster, []


def _high_priority_preempts_lower(pkg):
    fillers = [_prio(make_fake_pod(f"low{i}", "default", "4", "1Gi"), 0) for i in range(2)]
    vip = _prio(make_fake_pod("vip", "default", "6", "1Gi"), 1000)
    return _cluster(pkg, [make_fake_node("n0", "10", "16Gi")], fillers + [vip])


def _equal_priority(pkg):
    fillers = [_prio(make_fake_pod(f"low{i}", "default", "4", "1Gi"), 10) for i in range(2)]
    late = _prio(make_fake_pod("late", "default", "6", "1Gi"), 10)
    return _cluster(pkg, [make_fake_node("n0", "10", "16Gi")], fillers + [late])


def _lowest_victim_priority(pkg):
    pods = [_bound(_prio(make_fake_pod("mid", "default", "4", "1Gi"), 50), "n0"),
            _bound(_prio(make_fake_pod("small", "default", "4", "1Gi"), 5), "n1"),
            _prio(make_fake_pod("vip", "default", "3", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node(n, "4", "16Gi") for n in ("n0", "n1")], pods)


def _minimal_victim_set(pkg):
    fillers = [_prio(make_fake_pod(f"low{i}", "default", "2", "1Gi"), 0) for i in range(4)]
    vip = _prio(make_fake_pod("vip", "default", "2", "1Gi"), 9)
    return _cluster(pkg, [make_fake_node("n0", "8", "16Gi")], fillers + [vip])


def _mid_batch_failure(pkg):
    pods = [_prio(make_fake_pod("low0", "default", "4", "1Gi"), 0),
            _prio(make_fake_pod("low1", "default", "4", "1Gi"), 0),
            _prio(make_fake_pod("vip", "default", "6", "1Gi"), 1000),
            _prio(make_fake_pod("tiny", "default", "1", "1Gi"), 0)]
    return _cluster(pkg, [make_fake_node("n0", "10", "16Gi")], pods)


def _wave_commit_never_rides_restored_victims(pkg):
    pods = [_bound(_prio(make_fake_pod("fa", "default", "10", "1Gi"), 0), "nA"),
            _bound(_prio(make_fake_pod("fb", "default", "20", "2Gi"), 1), "nB"),
            _prio(make_fake_pod("a", "default", "10", "1Gi"), 100),
            _prio(make_fake_pod("b", "default", "20", "2Gi"), 100)]
    return _cluster(pkg, [make_fake_node("nA", "10", "16Gi"), make_fake_node("nB", "20", "32Gi")],
                    pods)


def _affinity_dependent_head(pkg):
    nodes = [make_fake_node(n, "10", "16Gi", with_node_labels({"kubernetes.io/hostname": n}))
             for n in ("n0", "n1")]
    anchor = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
        {"labelSelector": {"matchLabels": {"app": "anchor"}},
         "topologyKey": "kubernetes.io/hostname"}]}}
    pods = [_bound(_prio(make_fake_pod("f0", "default", "10", "1Gi"), 0), "n0"),
            _bound(_prio(make_fake_pod("f1", "default", "10", "1Gi"), 0), "n1"),
            _prio(make_fake_pod("x", "default", "5", "1Gi", with_pod_affinity(anchor)), 100),
            _prio(make_fake_pod("d", "default", "5", "1Gi", with_pod_labels({"app": "anchor"})), 100)]
    return _cluster(pkg, nodes, pods)


def _port_holder(pkg):
    low = _prio(make_fake_pod("low", "default", "1", "1Gi"), 0)
    low["spec"]["containers"][0]["ports"] = [{"containerPort": 80, "hostPort": 80, "protocol": "TCP"}]
    vip = _prio(copy.deepcopy(low), 100)
    vip["metadata"]["name"] = "vip"
    return _cluster(pkg, [make_fake_node("n0", "32", "64Gi")], [low, vip])


def _static_failures(pkg):
    vip = _prio(make_fake_pod("vip", "default", "1", "1Gi"), 1000)
    vip["spec"]["nodeSelector"] = {"nonexistent": "label"}
    return _cluster(pkg, [make_fake_node("n0", "10", "16Gi")],
                    [_prio(make_fake_pod("low", "default", "9", "1Gi"), 0), vip])


def _pdb_flips_victim_node(pkg):
    pods = [_bound(_labels(_prio(make_fake_pod("covered", "default", "4", "1Gi"), 0),
                           {"app": "critical-db"}), "n0"),
            _bound(_prio(make_fake_pod("free", "default", "4", "1Gi"), 0), "n1"),
            _prio(make_fake_pod("vip", "default", "3", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node(n, "4", "16Gi") for n in ("n0", "n1")], pods,
                    [_pdb("db-pdb", {"app": "critical-db"})])


def _pdb_budget_permits(pkg):
    pods = [_bound(_labels(_prio(make_fake_pod("covered", "default", "4", "1Gi"), 0),
                           {"app": "web"}), "n0"),
            _bound(_prio(make_fake_pod("pricey", "default", "4", "1Gi"), 50), "n1"),
            _prio(make_fake_pod("vip", "default", "3", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node(n, "4", "16Gi") for n in ("n0", "n1")], pods,
                    [_pdb("web-pdb", {"app": "web"}, allowed=1)])


def _pdb_prefers_uncovered(pkg):
    pods = [_labels(_prio(make_fake_pod("covered", "default", "2", "1Gi"), 0), {"app": "db"}),
            _prio(make_fake_pod("free", "default", "2", "1Gi"), 0),
            _prio(make_fake_pod("vip", "default", "4", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node("n0", "6", "16Gi")], pods, [_pdb("db-pdb", {"app": "db"})])


def _empty_pdb_selector(pkg):
    pods = [_bound(_labels(_prio(make_fake_pod("a", "default", "4", "1Gi"), 0), {"x": "1"}), "n0"),
            _bound(_labels(_prio(make_fake_pod("b", "default", "4", "1Gi"), 0), {"x": "2"}), "n1"),
            _prio(make_fake_pod("vip", "default", "3", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node(n, "4", "16Gi") for n in ("n0", "n1")], pods,
                    [_pdb("catch-all", {}, selector={})])


def _pdb_budget_no_penalty(pkg):
    pods = [_labels(_prio(make_fake_pod("covered", "default", "2", "1Gi"), 0), {"app": "web"}),
            _prio(make_fake_pod("pricey", "default", "2", "1Gi"), 50),
            _prio(make_fake_pod("vip", "default", "4", "1Gi"), 100)]
    return _cluster(pkg, [make_fake_node("n0", "6", "16Gi")], pods,
                    [_pdb("web-pdb", {"app": "web"}, allowed=1)])


def _gpu_preemption(pkg):
    """A GPU-share preemptor that needs a whole device held by lower
    priority GPU pods."""
    node = make_fake_node("g0", "64", "256Gi", with_node_allocatable(
        {"alibabacloud.com/gpu-mem": "32Gi", "alibabacloud.com/gpu-count": "2"}))

    def gpu_pod(name, mem, count, prio):
        return _prio(make_fake_pod(name, "default", "1", "1Gi", with_pod_annotations(
            {"alibabacloud.com/gpu-mem": mem, "alibabacloud.com/gpu-count": count})), prio)

    pods = [gpu_pod(f"low{i}", "10Gi", "1", 0) for i in range(3)] + [gpu_pod("vip", "16Gi", "2", 100)]
    return _cluster(pkg, [node], pods)


def _storage_preemption(pkg):
    """An Open-Local preemptor whose LVM claim needs the space lower
    priority storage pods hold."""
    storage = {"vgs": [{"name": "pool0", "capacity": 100 * GI}], "devices": []}
    node = make_fake_node("s0", "8", "16Gi", with_node_local_storage(storage))

    def lvm_pod(name, gib, prio):
        vols = [{"size": str(gib * GI), "kind": "LVM", "scName": "open-local-lvm"}]
        return _prio(make_fake_pod(name, "default", "100m", "128Mi", with_pod_annotations(
            {"simon/pod-local-storage": json.dumps({"volumes": vols})})), prio)

    cluster, apps = _cluster(pkg, [node], [lvm_pod(f"low{i}", 40, 0) for i in range(2)]
                             + [lvm_pod("vip", 50, 100)])
    cluster.storage_classes = [{"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
                                "metadata": {"name": "open-local-lvm"}, "parameters": {}}]
    return cluster, apps


def _at_scale_serial(pkg):
    """tests/test_preemption.py's at-scale case on the serial path, at 60
    nodes: every high-priority pod evicts two 1-cpu victims."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    n = 60
    cluster = pkg.ResourceTypes()
    cluster.nodes = [
        synth.make_node(f"node-{i:06d}", 4000, 16, {"topology.kubernetes.io/zone": f"zone-{i % 4}",
                                                     "kubernetes.io/hostname": f"node-{i:06d}"})
        for i in range(n)
    ]
    low = synth.make_deployment("low", n * 4, 1000, 512, priority=10)
    high = synth.make_deployment("high", 50, 2000, 1024, priority=1000)
    return cluster, [pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[low])),
                     pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[high]))]


CASES = {
    "high-priority-preempts-lower": _high_priority_preempts_lower,
    "equal-priority-does-not-preempt": _equal_priority,
    "picks-node-with-lowest-victim-priority": _lowest_victim_priority,
    "minimal-victim-set": _minimal_victim_set,
    "mid-batch-failure-keeps-bookkeeping-aligned": _mid_batch_failure,
    "wave-commit-never-rides-restored-victims": _wave_commit_never_rides_restored_victims,
    "affinity-dependent-head-not-finalized": _affinity_dependent_head,
    "preempts-port-holder": _port_holder,
    "static-failures-never-preempt": _static_failures,
    "pdb-flips-the-chosen-victim-node": _pdb_flips_victim_node,
    "pdb-budget-permits-disruption": _pdb_budget_permits,
    "pdb-prefers-uncovered-victim-within-node": _pdb_prefers_uncovered,
    "empty-pdb-selector-matches-nothing": _empty_pdb_selector,
    "pdb-with-budget-does-not-penalize-covered-victim": _pdb_budget_no_penalty,
    "gpu-share-preemption": _gpu_preemption,
    "open-local-preemption": _storage_preemption,
    "at-scale-serial": _at_scale_serial,
}
#: the cases whose reference outcome evicts at least one pod
EVICTS = {
    "high-priority-preempts-lower", "picks-node-with-lowest-victim-priority", "minimal-victim-set",
    "mid-batch-failure-keeps-bookkeeping-aligned", "wave-commit-never-rides-restored-victims",
    "affinity-dependent-head-not-finalized", "preempts-port-holder",
    "pdb-flips-the-chosen-victim-node", "pdb-budget-permits-disruption",
    "pdb-prefers-uncovered-victim-within-node", "empty-pdb-selector-matches-nothing",
    "pdb-with-budget-does-not-penalize-covered-victim", "gpu-share-preemption",
    "open-local-preemption", "at-scale-serial",
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preemption_bit_identical(case, monkeypatch):
    want, _ = assert_same_simulation(CASES[case], monkeypatch)
    assert bool(want["preempted"]) == (case in EVICTS), want["preempted"]
    if case == "at-scale-serial":
        assert len(want["preempted"]) == 2 * 50 and not want["failed"]


def test_wave_cap_abort_bit_identical(caplog):
    """The wave cap tripped on the first wave: the preemptor is recorded
    unscheduled with the cap's note, and a warning says how many pods it
    cut off — in both packages alike."""
    out = []
    for pkg, logger in ((simtpu, "simtpu.api"), (simtpu_torch, "simtpu_torch.api")):
        cluster, _ = _high_priority_preempts_lower(pkg)
        kw = {} if pkg is simtpu else {"device": "cpu"}
        sim = pkg.Simulator(**kw)
        sim.WAVE_CAP_SLACK = -100
        with caplog.at_level(logging.WARNING, logger=logger):
            result = sim.run_cluster(cluster)
        out.append([u.reason for u in result.unscheduled_pods])
        assert any("preemption wave cap exhausted with 1 pod(s)" in rec.getMessage()
                   for rec in caplog.records if rec.name == logger)
        sim.close()
    assert out[0] == out[1] and len(out[0]) == 1
    assert simtpu_torch.api.PREEMPT_WAVE_CAP_NOTE in out[1][0]


def test_state_after_preemption_matches_a_rebuild(monkeypatch):
    """The port's carried state after the evictions and restores of a
    preemption run (signed deltas) equals a rebuild from its placement log."""
    import numpy as np

    from simtpu_torch.engine.state import build_state, state_to_numpy

    engines = []
    real = simtpu_torch.api.Engine

    class Recording(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(simtpu_torch.api, "Engine", Recording)
    cluster, apps = _at_scale_serial(simtpu_torch)
    simtpu_torch.simulate(cluster, apps, device="cpu")
    eng = engines[-1]
    tensors = eng.tensorizer.freeze()
    rebuilt = build_state(tensors, np.asarray(eng.placed_group, np.int32),
                          np.asarray(eng.placed_node, np.int32),
                          eng.log_req_matrix(tensors.alloc.shape[1]), eng.ext_log, "cpu")
    carried = _carried(eng)
    assert carried is not None
    for name, a, b in zip(carried._fields, carried, state_to_numpy(rebuilt)):
        np.testing.assert_array_equal(a, b, err_msg=name)

