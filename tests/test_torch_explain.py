"""simtpu_torch's decision observability against the JAX package's.

`simtpu_torch/explain` (the failure breakdown through K20 `explain_pass`,
score attribution through K21 `pod_terms`, the bottleneck analysis) and
its surfaces (`simulate(explain=)`, the planners' `explain=`, the CLI's
`explain`, `--explain` and `report.explain_report`) are held against
`simtpu/explain` on the same problems (pod names seeded alike), on the
CPU, where each wrapper runs its kernel's plain version:

- the breakdown's per-stage counts, feasible counts, witnesses and fail
  codes equal the JAX package's `_explain_call` (jit, CPU) exactly, on the
  same numpy state, and the port's copy of the numpy twin;
- the explain documents, status strings and groups are equal apart from
  `mode` (the path that ran: "cpu" here, the JAX package's "jit") and the
  `wall_s` timing;
- score attribution: winner, runner-up and `consistent` exactly; the
  score vector bit for bit against the score the JAX package's compiled
  scan ranks (the engine's, which K3 and K21 reproduce); the raw term rows
  to rtol=1e-6, atol=1e-5 against `_eval_pod_terms` (they follow the
  standalone plugin functions, whose last bits XLA's fusion may move);
  margins to MARGIN_ATOL: `_eval_pod_terms` is compiled on its own, so its
  score may sit one f32 ulp (at most 1.2e-4 below 2048) off the scan's,
  and a margin is the difference of two scores;
- the off path imports no explain module and runs neither K20 nor K21.

The JAX side runs its auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simtpu
import simtpu.audit.fuzz  # noqa: F401
import simtpu.cli  # noqa: F401
import simtpu.plan.capacity  # noqa: F401
import simtpu.plan.incremental  # noqa: F401
import simtpu.plan.resilience  # noqa: F401
import simtpu_torch
import simtpu_torch.audit.fuzz  # noqa: F401
import simtpu_torch.cli  # noqa: F401
import simtpu_torch.plan.capacity  # noqa: F401
import simtpu_torch.plan.incremental  # noqa: F401
import simtpu_torch.plan.resilience  # noqa: F401
from simtpu_torch import smoke
from simtpu.core.tensorize import Tensorizer as JTensorizer
from simtpu.engine.scan import Engine as JEngine
from simtpu.explain import breakdown as jbd
from simtpu.explain import scores as jscores
from simtpu_torch.core.tensorize import Tensorizer as TTensorizer
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.engine.scan import Engine as TEngine
from simtpu_torch.explain import breakdown as tbd
from simtpu_torch.explain import scores as tscores
from simtpu_torch.kernels import cuda

from .test_torch_kernels import _numpy_tree
from .test_torch_simulate import REPO

RTOL, ATOL, MARGIN_ATOL = smoke.TERMS_RTOL, smoke.TERMS_ATOL, smoke.MARGIN_ATOL


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _synth(pkg):
    import importlib

    return importlib.import_module(f"{pkg.__name__}.synth")


def _expand(pkg, apps):
    pods = []
    for a in apps:
        pods.extend(pkg.workloads.expand.get_valid_pods_exclude_daemonset(a.resource))
    return pods


def _place(pkg, cluster, apps, raw=(), name_seed=17):
    """Engine-level placement (tensorizer, engine, batch, nodes, reasons,
    extras) of the expanded apps, then the `raw` pods as they are (no
    expansion), pod names seeded."""
    pkg.workloads.expand.seed_name_hashes(name_seed)
    try:
        pods = _expand(pkg, apps) + list(raw)
    finally:
        pkg.workloads.expand.seed_name_hashes(None)
    if pkg is simtpu:
        tz = JTensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
        eng = JEngine(tz)
    else:
        tz = TTensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
        eng = TEngine(tz, "cpu")
    batch = tz.add_pods(pods)
    nodes, reasons, extras = eng.place(batch)
    return tz, eng, batch, np.asarray(nodes), np.asarray(reasons), extras


def _gnarly(pkg, seed):
    """A fuzz-generated case (storage, GPU and host ports drawn in) made
    infeasible on several axes: hard constraints plus a deployment no node
    can hold."""
    fuzz = pkg.audit.fuzz if pkg is simtpu else simtpu_torch.audit.fuzz
    cluster, apps, _ = fuzz.gen_case(seed, 24, 120)
    apps[0].resource.deployments.append(_synth(pkg).make_deployment("fat-cpu", 3, 10_000_000, 8))
    return cluster, apps


def _stage_problem(pkg):
    """Three nodes (zone-a twice, a one-core node in zone-b; GPUs, a VG, a
    GCE-PD attach limit of 1) and one deployment per filter stage, each
    built so that a pod of it fails at that stage first: a selector no
    node matches, a host port on every node, 100 cores, one read-write
    GCE PD on every node, two PDs against the limit, an LVM claim no VG
    holds, GPU memory no device holds, hard zone spread whose second pod
    only fits zone-a, and required hostname anti-affinity; and one raw pod
    (not expanded, which would turn the claim into a hostPath) that
    references a missing PVC. Returns (cluster, apps, raw pods)."""
    synth = _synth(pkg)
    nodes = []
    for name, zone, cpu in (("n0", "zone-a", 8000), ("n1", "zone-a", 8000), ("n2", "zone-b", 1000)):
        node = synth.make_node(name, cpu, 32, {"kubernetes.io/hostname": name,
                                               "topology.kubernetes.io/zone": zone},
                               gpu=(1, 8192), storage_gib=(100,))
        for key in ("allocatable", "capacity"):
            node["status"][key]["attachable-volumes-gce-pd"] = "1"
        nodes.append(node)
    cluster = pkg.ResourceTypes(nodes=nodes)
    md = synth.make_deployment

    def vols(dep, volumes):
        dep["spec"]["template"]["spec"]["volumes"] = volumes
        return dep

    deps = [
        md("static", 1, 100, 64, node_selector={"topology.kubernetes.io/zone": "zone-z"}),
        md("ports", 4, 100, 64, host_port=8080),
        md("resources", 1, 100_000, 64),
        vols(md("volume", 4, 100, 64), [{"name": "d", "gcePersistentDisk": {"pdName": "pd-shared"}}]),
        vols(md("attach", 1, 100, 64), [{"name": "a", "gcePersistentDisk": {"pdName": "pd-a"}},
                                        {"name": "b", "gcePersistentDisk": {"pdName": "pd-b"}}]),
        md("storage", 1, 100, 64, lvm_gib=1000),
        md("gpu", 1, 100, 64, gpu_mem_mib=65536),
        md("spread", 2, 2000, 64, spread_topo="topology.kubernetes.io/zone", spread_hard=True),
        md("interpod", 4, 100, 64, anti_affinity_topo="kubernetes.io/hostname", anti_affinity_required=True),
    ]
    bind = md("bind", 1, 100, 64)["spec"]["template"]
    bind["metadata"] = {"name": "bind-0", "namespace": "bench", "labels": {"app": "bind"}}
    bind["spec"]["volumes"] = [{"name": "c", "persistentVolumeClaim": {"claimName": "nope"}}]
    return cluster, [pkg.AppResource(name="stages", resource=pkg.ResourceTypes(deployments=deps))], [bind]


def _port_state(jstate_):
    """The JAX package's carried state as the port's SchedState on the CPU
    (the same numpy inputs for both passes)."""
    return tstate.state_from_numpy(_numpy_tree(jstate_), "cpu")


def _strip(doc):
    """A document without what the port records differently (the pass's
    `mode`) and the timings."""
    return smoke.explain_doc_record(doc)


def _breakdowns(jrun, trun):
    """(JAX breakdown, port breakdown) of every unplaced pod of a
    placement, the port's on the JAX package's state."""
    jtz, jeng, jbatch, jnodes, jreasons, _ = jrun
    ttz, _, tbatch, tnodes, treasons, _ = trun
    assert np.array_equal(jnodes, tnodes) and np.array_equal(jreasons, treasons)
    unp = np.flatnonzero(jnodes < 0)
    jstate_ = jeng.carried_state()
    jb = jbd.explain_failures(jtz.freeze(), jbatch, unp, jstate_, reasons=jreasons)
    tb = tbd.explain_failures(ttz.freeze(), tbatch, unp, _port_state(jstate_), reasons=treasons)
    return jb, tb


def _assert_breakdowns_equal(jb, tb):
    assert jb.mode == "jit" and tb.mode == "cpu"
    for f in ("rows", "reasons", "fail_code", "counts", "feasible", "witnesses"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)
    assert tb.names == jb.names and tb.n_nodes == jb.n_nodes
    assert [tb.status(i) for i in range(len(tb))] == [jb.status(i) for i in range(len(jb))]
    assert tb.groups(top=100) == jb.groups(top=100)
    for top in (1, 10):
        assert _strip(tb.to_doc(top=top)) == _strip(jb.to_doc(top=top))


def test_stage_table_and_constants_mirror_jax():
    assert tbd.STAGES == jbd.STAGES
    assert [f for f, _ in tscan.FILTER_CASCADE] == [f"m_{k}" if k != "interpod" else "m_all"
                                                   for k, _ in tbd.STAGES]
    assert (tbd.EXPLAIN_VERSION, tbd.EXPLAIN_CHUNK, tbd.WITNESS_K) == (
        jbd.EXPLAIN_VERSION, jbd.EXPLAIN_CHUNK, jbd.WITNESS_K)
    assert tscores.PLUGIN_TERMS == jscores.PLUGIN_TERMS
    assert tscores.DEFAULT_MAX_PODS == jscores.DEFAULT_MAX_PODS


def test_one_pod_per_failing_stage():
    """The cascade-bit map pinned stage by stage: a pod that fails first at
    each of the ten stages, its counts, witnesses and fail code equal to
    the JAX pass's, to the port's numpy twin's, and the first failing
    stage in the port's breakdown is the recorded reason."""
    jrun = _place(simtpu, *_stage_problem(simtpu))
    trun = _place(simtpu_torch, *_stage_problem(simtpu_torch))
    assert jrun[2].pods[-1]["metadata"]["name"] == "bind-0"
    jb, tb = _breakdowns(jrun, trun)
    assert sorted(set(int(c) for c in tb.reasons)) == sorted(code for _, code in tbd.STAGES)
    _assert_breakdowns_equal(jb, tb)
    ttz, _, tbatch, _, _, _ = trun
    tensors = ttz.freeze()
    state_np = tstate.state_to_numpy(_port_state(jrun[1].carried_state()))
    twin = tbd.numpy_breakdown(tensors, tbatch, tb.rows, state_np, np.ones(tensors.alloc.shape[0], bool),
                               tscan.flags_from(tensors, tbatch.ext), tb.witnesses.shape[2])
    for got, want in zip(twin, (tb.counts, tb.feasible, tb.witnesses, tb.fail_code)):
        np.testing.assert_array_equal(got, want)
    for i in range(len(tb)):
        nz = np.flatnonzero(tb.counts[i])
        assert tbd.STAGES[nz[-1]][1] == int(tb.fail_code[i]) == int(tb.reasons[i]), tb.status(i)


@pytest.mark.parametrize("seed", [1000, 20000])
def test_breakdown_equals_jax_on_gnarly_cases(seed):
    jrun = _place(simtpu, *_gnarly(simtpu, seed))
    trun = _place(simtpu_torch, *_gnarly(simtpu_torch, seed))
    jb, tb = _breakdowns(jrun, trun)
    assert len(tb) >= 3
    _assert_breakdowns_equal(jb, tb)
    n = tb.n_nodes
    assert np.array_equal(tb.counts.sum(axis=1) + tb.feasible, np.full(len(tb), n))
    for i in range(len(tb)):
        for s in range(len(tbd.STAGES)):
            real = tb.witnesses[i, s][tb.witnesses[i, s] >= 0]
            assert len(real) == min(int(tb.counts[i, s]), tb.witnesses.shape[2])
            assert np.all(np.diff(real) > 0)
    # the port's numpy twin on the port's own carry agrees with its pass
    ttz, teng, tbatch, _, _, _ = trun
    tensors = ttz.freeze()
    twin = tbd.numpy_breakdown(tensors, tbatch, tb.rows, tstate.state_to_numpy(teng.carried_state()),
                               np.ones(n, bool), tscan.flags_from(tensors, tbatch.ext),
                               tb.witnesses.shape[2])
    for got, want in zip(twin, (tb.counts, tb.feasible, tb.witnesses, tb.fail_code)):
        np.testing.assert_array_equal(got, want)
    doc = tb.to_doc(top=1)
    assert len(doc["groups"]) == 1 and doc["truncated_groups"] == len(
        {(int(tb.reasons[i]), tuple(map(int, tb.counts[i]))) for i in range(len(tb))}) - 1


def test_forced_pod_reports_recorded_reason():
    runs = []
    for pkg in (simtpu, simtpu_torch):
        synth = _synth(pkg)
        cluster = synth.synth_cluster(4, seed=81, zones=2)
        apps = synth.synth_apps(4, seed=82, zones=2, pods_per_deployment=2)
        apps[0].resource.pods.append(synth.make_deployment("pinned", 1, 100, 64)["spec"]["template"])
        pinned = apps[0].resource.pods[-1]
        pinned["metadata"] = {"name": "pinned-0", "namespace": "bench", "labels": {"app": "pinned"}}
        pinned["spec"]["nodeName"] = "no-such-node"
        runs.append(_place(pkg, cluster, apps))
    jb, tb = _breakdowns(*runs)
    _assert_breakdowns_equal(jb, tb)
    i = next(i for i in range(len(tb)) if int(tb.reasons[i]) == tscan.FAIL_NO_NODE)
    assert tb.counts[i].sum() == 0 and "no nodes in the cluster" not in tb.status(i)


@pytest.mark.parametrize("variant", ["plain", "template", "free"])
def test_bottleneck_equals_jax(variant):
    """The binding-constraint analysis: without a template, with one (the
    can-never-help verdict and the node hint) and with the `free` override
    of a stateless document."""
    from simtpu.explain import bottleneck_analysis as jbottle
    from simtpu.explain import build_explain_doc as jdoc
    from simtpu_torch.explain import bottleneck_analysis as tbottle
    from simtpu_torch.explain import build_explain_doc as tdoc

    docs = []
    for pkg, bottle, mkdoc in ((simtpu, jbottle, jdoc), (simtpu_torch, tbottle, tdoc)):
        synth = _synth(pkg)
        cluster = synth.synth_cluster(4, seed=51, zones=2)
        apps = synth.synth_apps(8, seed=52, zones=2, pods_per_deployment=4)
        apps[0].resource.deployments.append(synth.make_deployment("hungry", 6, 48000, 1))
        tz, eng, batch, nodes, reasons, _ = _place(pkg, cluster, apps)
        tensors = tz.freeze()
        unp = np.flatnonzero(nodes < 0)
        template = synth.make_node("tmpl", 64000, 128, {"kubernetes.io/hostname": "tmpl"})
        free = eng.carried_state().free
        free = np.asarray(free) if pkg is simtpu else free.numpy()
        if variant == "free":
            docs.append(mkdoc(tensors, batch, unp, None, nodes, reasons, free=np.zeros_like(free)))
        else:
            docs.append(bottle(tensors, batch, nodes, reasons, free=free,
                               new_node=template if variant == "template" else None))
    assert docs[0] and _strip(docs[1]) == _strip(docs[0])


def _attribution_case(pkg):
    synth = _synth(pkg)
    cluster = synth.synth_cluster(8, seed=41, zones=2, taint_frac=0.1, storage_frac=0.4, gpu_frac=0.4)
    apps = synth.synth_apps(24, seed=42, zones=2, pods_per_deployment=8, anti_affinity_frac=0.3,
                            spread_frac=0.4, selector_frac=0.3, storage_frac=0.3, gpu_frac=0.3)
    return _place(pkg, cluster, apps)


def test_attribute_scores_equal_jax():
    """Winner, runner-up and `consistent` exactly; margins and terms to the
    stated tolerances; the extras rebuilt from the log equal `place()`'s."""
    jtz, jeng, jbatch, jnodes, _, jext = _attribution_case(simtpu)
    ttz, teng, tbatch, tnodes, _, text = _attribution_case(simtpu_torch)
    assert np.array_equal(jnodes, tnodes)
    rebuilt = tscores.extras_from_log(ttz.freeze(), tnodes, teng.ext_log)
    for key in ("lvm_alloc", "dev_take", "gpu_shares"):
        np.testing.assert_array_equal(rebuilt[key], np.asarray(text[key]), err_msg=key)
    rows = np.flatnonzero(tnodes >= 0)[::3][:8]
    jd = jscores.attribute_scores(jtz.freeze(), jbatch, jnodes, jext, rows=rows, max_pods=8)
    td = tscores.attribute_scores(ttz.freeze(), tbatch, tnodes, rebuilt, rows=rows, max_pods=8, device="cpu")
    assert len(td) == len(jd) == len(rows)
    for a, b in zip(td, jd):
        assert (a["pod"], a["row"], a["node"], a["winner"], a["runner_up"], a["consistent"]) == (
            b["pod"], b["row"], b["node"], b["winner"], b["runner_up"], b["consistent"])
        assert a["consistent"]
        assert (a["margin"] is None) == (b["margin"] is None)
        if a["margin"] is not None:
            assert a["margin"] == pytest.approx(b["margin"], rel=RTOL, abs=MARGIN_ATOL)
        for ta, tb_ in zip(a["terms"], b["terms"]):
            assert (ta["plugin"], ta["weight"]) == (tb_["plugin"], tb_["weight"])
            for key in ("winner_raw", "runner_up_raw", "delta"):
                if tb_[key] is None:
                    assert ta[key] is None
                else:
                    assert ta[key] == pytest.approx(tb_[key], rel=RTOL, abs=ATOL), (a["pod"], ta, tb_)


def test_pod_terms_score_bit_equal_to_jax():
    """The plain K21 (`pod_terms_of`) pod by pod along the JAX package's
    compiled scan from an empty state: the score vector bit for bit
    against the score the scan ranks at that step (-inf outside m_all);
    the terms to the tolerance against `_eval_pod_terms` on the same state
    (NaN where it has NaN), and its score within one ulp."""
    import jax.numpy as jnp

    from simtpu.engine import scan as jscan
    from simtpu.engine import state as jstate

    from .test_torch_kernels import _jax_scan_with_eval, _port_flags

    jtz, _, jbatch, _, _, _ = _attribution_case(simtpu)
    jt = jtz.freeze()
    jstatics = jscan.statics_from(jt)
    jflags = jscan.flags_from(jt, jbatch.ext)
    _, jpods = jscan.build_pod_arrays(jbatch, jt.alloc.shape[1])
    jpods = tuple(np.asarray(a) for a in jpods)
    r = jt.alloc.shape[1]
    empty = jstate.build_state(jt, np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, r), np.float32),
                               None)
    _, (_, _, _, j_score) = _jax_scan_with_eval(jstatics, empty, jpods, jflags)
    tstatics = tscan.statics_from_numpy(_numpy_tree(jstatics), "cpu")
    tflags = _port_flags(jflags)
    state = _port_state(empty)
    for i in range(len(jpods[0])):
        pod = tuple(a[i] for a in jpods)
        ts, tterms = tscores.eval_pod_terms(tstatics, state, pod, tflags)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(j_score[i]), err_msg=f"pod {i}")
        if i % 5 == 0:
            jst = type(empty)(*(jnp.asarray(x) for x in tstate.state_to_numpy(state)))
            js, jterms = jscores._eval_pod_terms(jstatics, jst, tuple(jnp.asarray(a) for a in pod), jflags)
            np.testing.assert_allclose(tterms.numpy(), np.asarray(jterms), rtol=RTOL, atol=ATOL,
                                       equal_nan=True, err_msg=f"pod {i}")
            fin = np.isfinite(np.asarray(js))
            assert np.array_equal(fin, np.isfinite(ts.numpy()))
            np.testing.assert_allclose(ts.numpy()[fin], np.asarray(js)[fin], rtol=2 ** -23, atol=0)
        tscan.schedule_step(tstatics, state, (pod[0], torch.as_tensor(pod[1])) + pod[2:], tflags)


def _simulate_pair(explain, dirty=False):
    """Both packages' Simulator on a problem that preempts (four 16-core
    nodes with GPUs and a VG; a low-priority filler; a high-priority app
    that must evict, with a GPU pod, an LVM pod and a pod no node holds),
    then `explain_result` — with the carry marked dirty when `dirty`,
    which takes the `build_state` branch."""
    out = []
    for pkg in (simtpu, simtpu_torch):
        synth = _synth(pkg)
        md = synth.make_deployment
        cluster = pkg.ResourceTypes(nodes=[
            synth.make_node(f"ev-{i}", 16000, 32, {"kubernetes.io/hostname": f"ev-{i}"},
                            gpu=(2, 8192), storage_gib=(100,)) for i in range(4)])
        apps = [pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[
                    md("low", 30, 2000, 1024, priority=0)])),
                pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[
                    md("high", 6, 4000, 2048, priority=100),
                    md("gpu", 3, 500, 512, gpu_mem_mib=8192, priority=100),
                    md("lvm", 2, 500, 512, lvm_gib=60, priority=100),
                    md("fat", 2, 10_000_000, 4, priority=100)]))]
        pkg.workloads.expand.seed_name_hashes(63)
        try:
            sim = pkg.Simulator() if pkg is simtpu else pkg.Simulator(device="cpu")
            sim.run_cluster(cluster)
            for app in apps:
                sim.schedule_app(app)
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        if dirty:
            sim._engine._state_dirty = True
        out.append((sim, sim.explain_result(explain)))
    return out


@pytest.mark.parametrize("dirty", [False, True], ids=["carry", "dirty-carry"])
def test_explain_result_equal_jax(dirty):
    (jsim, jdoc), (tsim, tdoc) = _simulate_pair({"top": 5}, dirty=dirty)
    assert tsim._preempted and len(tsim._unscheduled) == len(jsim._unscheduled) >= 2
    assert tdoc["failures"]["mode"] == "cpu"
    assert _strip(tdoc) == _strip(jdoc)


def test_simulate_explain_equal_jax():
    docs, unsched = [], []
    for pkg, kw in ((simtpu, {}), (simtpu_torch, {"device": "cpu"})):
        synth = _synth(pkg)
        cluster = synth.synth_cluster(4, seed=61, zones=2)
        apps = synth.synth_apps(6, seed=62, zones=2, pods_per_deployment=3)
        apps[0].resource.deployments.append(synth.make_deployment("fat", 2, 10_000_000, 4))
        pkg.workloads.expand.seed_name_hashes(64)
        try:
            result = pkg.simulate(cluster, apps, explain=True, **kw)
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        docs.append(result.explain)
        unsched.append(len(result.unscheduled_pods))
    assert unsched[0] == unsched[1] == docs[1]["failures"]["unplaced"]
    assert _strip(docs[1]) == _strip(docs[0])


def _planner_case(pkg):
    synth = _synth(pkg)
    cluster = synth.synth_cluster(3, seed=63, zones=2)
    apps = synth.synth_apps(6, seed=64, zones=2, pods_per_deployment=3)
    apps[0].resource.deployments.append(synth.make_deployment("fat", 2, 10_000_000, 4))
    template = synth.make_node("tmpl", 4000, 8, {"kubernetes.io/hostname": "tmpl"})
    return cluster, apps, template


@pytest.mark.parametrize("planner", ["capacity", "incremental", "resilience"])
def test_failing_plans_carry_the_explain_block(planner):
    docs = []
    for pkg in (simtpu, simtpu_torch):
        cluster, apps, template = _planner_case(pkg)
        kw = {} if pkg is simtpu else {"device": "cpu"}
        pkg.workloads.expand.seed_name_hashes(65)
        try:
            if planner == "capacity":
                plan = pkg.plan.capacity.plan_capacity(cluster, apps, template, max_new_nodes=3,
                                                       explain=True, audit=False, **kw)
            elif planner == "incremental":
                plan = pkg.plan.incremental.plan_capacity_incremental(cluster, apps, template, max_new_nodes=3,
                                                                      explain=True, audit=False, **kw)
            else:
                plan = pkg.plan.resilience.plan_resilience(cluster, apps, new_node=None, spec="k=1",
                                                           explain=True, audit=False, **kw)
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        assert not plan.success and plan.explain
        docs.append(plan.explain)
    assert docs[1]["bottleneck"]["unplaced"] >= 1
    assert _strip(docs[1]) == _strip(docs[0])


def _cli_doc(pkg, argv):
    main = pkg.cli.main
    return smoke.run_cli_json(main, argv if pkg is simtpu else argv + ["--device", "cpu"])


def _failing_config(pkg, root):
    """The planner case written as a simon Config: a deployment no template
    node can hold, so `apply` fails at candidate 0 and `resilience --plan`
    at its base placement."""
    cluster, apps, template = _planner_case(pkg)
    return smoke.write_capacity_config(root, cluster, apps, template)


@pytest.mark.parametrize("command", ["explain", "apply", "resilience"])
def test_cli_explain_documents_equal_jax(command, tmp_path, monkeypatch):
    # the example config's paths are relative to the repository
    monkeypatch.chdir(REPO if command == "explain" else tmp_path)
    got = []
    for pkg in (simtpu, simtpu_torch):
        if command == "explain":
            argv = ["explain", "-f", os.path.join(REPO, "examples/simtpu-config.yaml"), "--json",
                    "--scores", "3", "--no-bulk"]
        else:
            cfg = _failing_config(pkg, tmp_path / pkg.__name__)
            argv = ([command, "-f", cfg, "--json", "--explain", "--no-audit"]
                    + (["--plan", "--max-new-nodes", "3"] if command == "resilience" else []))
        pkg.workloads.expand.seed_name_hashes(66)
        try:
            rc, doc = _cli_doc(pkg, argv)
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        got.append((rc, doc))
    (jrc, jdoc), (trc, tdoc) = got
    assert trc == jrc
    if command == "explain":
        assert tdoc["placed"] == tdoc["pods"] and len(tdoc["scores"]) == 3
        jscores_, tscores_ = jdoc.pop("scores"), tdoc.pop("scores")
        for a, b in zip(tscores_, jscores_):
            assert a["consistent"] and (a["winner"], a["runner_up"]) == (b["winner"], b["runner_up"])
            assert [t["winner_raw"] for t in a["terms"]] == pytest.approx(
                [t["winner_raw"] for t in b["terms"]], rel=RTOL, abs=ATOL)
        assert tdoc == jdoc
    else:
        assert trc == 1 and tdoc["explain"]["bottleneck"]["unplaced"] >= 1
        assert _strip(tdoc["explain"]) == _strip(jdoc["explain"])


def test_explain_report_text_equal_jax():
    from simtpu.report import explain_report as jreport
    from simtpu_torch.report import explain_report as treport

    (jsim, jdoc), (tsim, tdoc) = _simulate_pair(None)
    text = treport(tdoc)
    assert "Why Unschedulable" in text and "Bottleneck" in text and "nodes are available" in text
    assert text == jreport(jdoc).replace("jit pass", "cpu pass")
    assert treport({}) == jreport({})


def test_off_path_runs_no_explain_kernel_and_imports_nothing():
    """simulate() without explain: no explain module imported, neither K20
    nor K21 launched or plain-run; with it, K20's plain version runs once
    per chunk of the unplaced pods."""
    code = (
        "import sys; import simtpu_torch; from simtpu_torch import synth; "
        "from simtpu_torch.kernels import cuda; "
        "c = synth.synth_cluster(4, seed=61, zones=2); "
        "a = synth.synth_apps(6, seed=62, zones=2, pods_per_deployment=3); "
        "a[0].resource.deployments.append(synth.make_deployment('fat', 2, 10_000_000, 4)); "
        "r = simtpu_torch.simulate(c, a, device='cpu'); "
        "off = (r.explain, 'simtpu_torch.explain' in sys.modules, "
        "cuda.PLAIN_CALLS['explain_pass'], cuda.PLAIN_CALLS['pod_terms'], "
        "cuda.LAUNCHES['explain_pass'], cuda.LAUNCHES['pod_terms']); "
        "r2 = simtpu_torch.simulate(c, a, device='cpu', explain=True); "
        "on = (len(r2.unscheduled_pods), cuda.PLAIN_CALLS['explain_pass']); "
        "print(off, on); sys.exit(0 if off == (None, False, 0, 0, 0, 0) and on == (2, 1) else 1)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_wrappers_choose_by_device():
    """K20/K21's wrappers run the plain version for CPU tensors (counted in
    PLAIN_CALLS, no launch) and equal it."""
    ttz, teng, tbatch, tnodes, treasons, _ = _place(simtpu_torch, *_gnarly(simtpu_torch, 1000))
    tensors = ttz.freeze()
    statics = tscan.statics_from(tensors, None, torch.device("cpu"))
    flags = tscan.flags_from(tensors, tbatch.ext)
    _, pods = tscan.build_pod_arrays(tbatch, tensors.alloc.shape[1])
    unp = np.flatnonzero(tnodes < 0)
    seg = tuple(np.asarray(a)[unp[:5]] for a in pods)
    cuda.reset_counts()
    got = tbd.explain_pass(statics, teng.carried_state(), seg, flags, 4)
    assert cuda.PLAIN_CALLS["explain_pass"] == 1 and not cuda.LAUNCHES
    for a, b in zip(got, tbd.explain_pass_plain(statics, teng.carried_state(), seg, flags, 4)):
        np.testing.assert_array_equal(a, b)
    pod = tuple(np.asarray(a)[0] for a in pods)
    cuda.reset_counts()
    score, terms = tscores.eval_pod_terms(statics, teng.carried_state(), pod, flags)
    assert cuda.PLAIN_CALLS["pod_terms"] == 1 and not cuda.LAUNCHES
    assert terms.shape == (len(tscores.PLUGIN_TERMS), tensors.alloc.shape[0])
    ev = tscan.filter_and_score(statics, teng.carried_state(), (pod[0], torch.as_tensor(pod[1])) + pod[2:], flags)
    assert torch.equal(score, ev.score)
