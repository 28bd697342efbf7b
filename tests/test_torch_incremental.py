"""simtpu_torch's incremental capacity planner against the JAX package's.

`simtpu_torch/plan/incremental.py plan_capacity_incremental` (bulk rounds
on one tensorization, completion probes from copies of the base snapshot,
the fresh verify run, the audit gate) is held against the JAX package's on
the incremental cases of tests/test_plan.py — the serial-planner agreement
scenario, the can-never-help diagnosis, the single-candidate cap, the
probe-sweep scenario and the no-preemption divergence — and on the repo's
example configs: the verdict, count, message, probes, audit counters and
the winning placement record must be equal (pod names seeded alike). Also:
`apply --search incremental`, the auto-selected path (thresholds lowered in
both packages) and `--corrected-ds-overhead` through both CLIs; the
unverified path; the features that raise; and K17's plain version leaving
the base snapshot untouched across the probes.

The JAX side runs its auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`).
"""

import importlib
import json

import numpy as np
import pytest

import simtpu
import simtpu.plan.capacity as jcap
import simtpu_torch
import simtpu_torch.plan.capacity as tcap
import simtpu_torch.plan.incremental as tinc
from simtpu.plan.incremental import plan_capacity_incremental as j_incremental
from simtpu_torch.kernels import cuda

from .fixtures import make_fake_daemon_set, make_fake_deployment, make_fake_node, with_node_taints
from .test_torch_plan import REPO, _cli, _plan_doc
from ._threads import one_torch_thread  # noqa: F401 (autouse)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _synth(pkg):
    return importlib.import_module(f"{pkg.__name__}.synth")


def _expand_mod(pkg):
    return importlib.import_module(f"{pkg.__name__}.workloads.expand")


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def assert_same_incremental(build, seed: int = 11, **kw):
    """Plan `build(pkg)` -> (cluster, apps, template) with both packages'
    incremental planners; returns (JAX plan, port plan) after requiring
    equal plan documents."""
    plans = []
    for pkg in (simtpu, simtpu_torch):
        cluster, apps, template = build(pkg)
        plan = j_incremental if pkg is simtpu else tinc.plan_capacity_incremental
        extra = {} if pkg is simtpu else {"device": "cpu"}
        _expand_mod(pkg).seed_name_hashes(seed)
        try:
            plans.append(plan(cluster, apps, template, **kw, **extra))
        finally:
            _expand_mod(pkg).seed_name_hashes(None)
    want, got = plans
    assert _plan_doc(got) == _plan_doc(want)
    assert got.preemption_ignored == want.preemption_ignored
    return want, got


def _serial_agreement(seed):
    def build(pkg):
        synth = _synth(pkg)
        cluster = pkg.ResourceTypes()
        cluster.nodes = [synth.make_node(f"node-{i:06d}", 8000, 16, {ZONE: f"zone-{i % 2}", HOST: f"node-{i:06d}"})
                         for i in range(3)]
        apps = synth.synth_apps(160, seed=seed + 1, zones=2, pods_per_deployment=20, selector_frac=0.0,
                                anti_affinity_frac=0.2, spread_frac=0.4, spread_hard_frac=0.5)
        template = synth.make_node("tmpl", 16000, 64, {HOST: "tmpl", ZONE: "zone-0"})
        return cluster, apps, template

    return build


@pytest.mark.parametrize("verify", [True, False])
def test_matches_the_jax_incremental_planner(verify):
    want, got = assert_same_incremental(_serial_agreement(5), seed=5, max_new_nodes=60, verify=verify)
    assert got.success and got.nodes_added > 0 and not got.result.unscheduled_pods
    assert set(got.timings) >= {"tensorize", "base", "probes", "materialize"}
    assert ("verify" in got.timings) == verify
    assert bool(got.audit) == verify and (not verify or got.audit["ok"])
    phases = [c["phase"] for c in got.candidates]
    assert phases[0] == "base" and "probes" in phases and (phases[-1] == "verify") == verify


def _small(pkg, replicas, cpu="2", memory="4Gi"):
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node("base-1", "4", "8Gi")]
    res = pkg.ResourceTypes()
    res.deployments = [make_fake_deployment("web", "default", replicas, cpu, memory)]
    return cluster, [pkg.AppResource(name="app", resource=res)]


def test_never_help_diagnostic():
    tainted = make_fake_node("tmpl", "16", "64Gi",
                             with_node_taints([{"key": "k", "value": "v", "effect": "NoSchedule"}]))
    _, got = assert_same_incremental(lambda pkg: (*_small(pkg, 6), tainted), max_new_nodes=8)
    assert not got.success and "does not fit new node affinity or taints" in got.message


def test_single_candidate_cap():
    def build(pkg):
        synth = _synth(pkg)
        cluster = pkg.ResourceTypes()
        cluster.nodes = [synth.make_node("n0", 2000, 4, {HOST: "n0"})]
        res = pkg.ResourceTypes(deployments=[synth.make_deployment("big", 8, 1000, 512)])
        return cluster, [pkg.AppResource(name="a", resource=res)], synth.make_node("t", 2000, 4, {HOST: "t"})

    _, got = assert_same_incremental(build, max_new_nodes=1)
    assert not got.success and "still failed" in got.message


def test_probe_sweep_scenario():
    """tests/test_plan.py TestProbeCompileBudget's scenario: a partial run
    stranded, several candidate sizes probed (the shape-bucket compile
    accounting is not ported: the port compiles nothing at run time)."""

    def build(pkg):
        synth = _synth(pkg)
        cluster = pkg.ResourceTypes()
        cluster.nodes = [synth.make_node(f"node-{i:06d}", 8000, 32, {HOST: f"node-{i:06d}"}) for i in range(6)]
        res = pkg.ResourceTypes(deployments=[synth.make_deployment(f"dep-{j}", 40, 1000, 512) for j in range(3)])
        return cluster, [pkg.AppResource(name="a", resource=res)], synth.make_node("tmpl", 16000, 64, {HOST: "tmpl"})

    _, got = assert_same_incremental(build, seed=5, max_new_nodes=60)
    assert got.success and len(got.probes) >= 3


def test_daemonset_clones_and_corrected_overhead():
    """Clone-pinned DaemonSet pods ride the probes (clone_of), and the
    corrected DaemonSet overhead moves the diagnosis as in the JAX
    package."""

    def build(pkg):
        cluster, apps = _small(pkg, 1, "2", "4Gi")
        cluster.daemon_sets = [make_fake_daemon_set("heavy-ds", "kube-system", "3", "1Gi")]
        return cluster, apps, make_fake_node("template", "4", "8Gi")

    for corrected in (False, True):
        _, got = assert_same_incremental(build, max_new_nodes=4, corrected_ds_overhead=corrected)
        assert ("cannot meet resource requests" in got.message) == corrected


def test_no_preemption_in_probes_as_jax(capsys):
    """tests/test_plan.py TestPlannerPreemptionDivergence: the probes never
    evict, so a priority workload gets one node where the serial planner
    preempts; the notice is printed as the JAX package prints it."""

    def build(pkg):
        cluster = pkg.ResourceTypes()
        cluster.nodes = [make_fake_node(f"n{i}", "4", "16Gi") for i in range(2)]

        def prio(p):
            def apply(d):
                d["spec"]["template"]["spec"]["priority"] = p
            return apply

        low = make_fake_deployment("low", "default", 4, "2", "1Gi", prio(0))
        high = make_fake_deployment("high", "default", 2, "2", "1Gi", prio(100))
        apps = [pkg.AppResource(name="low", resource=pkg.ResourceTypes(deployments=[low])),
                pkg.AppResource(name="high", resource=pkg.ResourceTypes(deployments=[high]))]
        return cluster, apps, make_fake_node("tmpl", "4", "16Gi")

    want, got = assert_same_incremental(build, seed=9, max_new_nodes=8)
    assert got.success and got.nodes_added == 1 and got.preemption_ignored
    err = capsys.readouterr().err.splitlines()
    notices = [line for line in err if "incremental planner never runs preemption" in line]
    assert len(notices) == 2 and notices[0] == notices[1]


def test_injected_divergence_ships_the_serial_exact_fallback():
    """The audit gate: the accepted candidate's audit view corrupted
    (`_audit_inject`), the candidate re-placed by the serial exact engine
    and shipped with the divergence record, as the JAX package does under
    SIMTPU_AUDIT_INJECT=1."""
    import os

    build = _serial_agreement(5)
    plans = []
    for pkg in (simtpu, simtpu_torch):
        cluster, apps, template = build(pkg)
        _expand_mod(pkg).seed_name_hashes(5)
        try:
            if pkg is simtpu:
                os.environ["SIMTPU_AUDIT_INJECT"] = "1"
                try:
                    plans.append(j_incremental(cluster, apps, template, max_new_nodes=60))
                finally:
                    del os.environ["SIMTPU_AUDIT_INJECT"]
            else:
                plans.append(tinc.plan_capacity_incremental(cluster, apps, template, max_new_nodes=60,
                                                            device="cpu", _audit_inject=True))
        finally:
            _expand_mod(pkg).seed_name_hashes(None)
    want, got = plans
    assert _plan_doc(got) == _plan_doc(want)
    assert got.audit["fallback"] is True and got.audit["ok"] is True
    assert got.audit["divergence"] == want.audit["divergence"]
    assert got.candidates[-1]["fallback"] and not got.candidates[-1]["speculate"]


def test_unported_options_raise():
    cluster, apps = _small(simtpu_torch, 1)
    tmpl = make_fake_node("t", "4", "8Gi")
    for kw, item in ((dict(checkpoint=object()), "#8"),
                     (dict(mesh=object()), "#10"), (dict(precompile=True), "#10")):
        with pytest.raises(NotImplementedError, match=item):
            tinc.plan_capacity_incremental(cluster, apps, tmpl, device="cpu", **kw)


def test_probes_leave_the_base_snapshot_untouched(monkeypatch):
    """Every probe starts from K17's copy (its plain version on the CPU):
    two probes ran, and the base snapshot is bit for bit what the base
    run stored."""
    copies, snaps = [], []
    real = tinc._copy_state

    def spy(state):
        if not snaps:
            snaps.append(type(state)(*(t.clone() for t in state)))
        snaps.append(state)
        out = real(state)
        copies.append(out)
        return out

    monkeypatch.setattr(tinc, "_copy_state", spy)
    before = cuda.PLAIN_CALLS["carry_copy"]
    cluster, apps, template = _serial_agreement(5)(simtpu_torch)
    _expand_mod(simtpu_torch).seed_name_hashes(5)
    try:
        plan = tinc.plan_capacity_incremental(cluster, apps, template, max_new_nodes=60, device="cpu")
    finally:
        _expand_mod(simtpu_torch).seed_name_hashes(None)
    n_probes = sum(c["phase"] == "probes" for c in plan.candidates)
    assert n_probes >= 2 and len(copies) == n_probes
    assert cuda.PLAIN_CALLS["carry_copy"] - before == n_probes
    original, *seen = snaps
    for snap in seen:
        assert snap is seen[0]  # every probe copied the same base snapshot ...
        for a, b in zip(snap, original):
            assert np.array_equal(a.numpy(), b.numpy())  # ... which no probe moved
    for copy in copies:
        assert all(a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
                   for a, b in zip(copy, original) if a.numel())


def test_copy_carry_plain_copies_dense_and_compact():
    from simtpu_torch.engine import state as tstate

    cluster, apps, template = _serial_agreement(5)(simtpu_torch)
    eng_state = []

    class Keep(tinc.MaskedRoundsEngine):
        def place(self, batch):
            out = super().place(batch)
            eng_state.append(self.last_state)
            return out

    tz = importlib.import_module("simtpu_torch.core.tensorize").Tensorizer(cluster.nodes)
    batch = tz.add_pods([p for a in apps for p in _expand_mod(simtpu_torch).get_valid_pods_exclude_daemonset(
        a.resource)])
    eng = Keep(tz, "cpu", np.ones(len(cluster.nodes), bool))
    eng.place(batch)
    compact = eng_state[0]
    dense = eng.carried_state()
    for carry in (compact, dense):
        out = tinc._copy_state(carry)
        assert type(out) is type(carry)
        for a, b in zip(out, carry):
            assert a.dtype == b.dtype and torch_equal(a, b)
    assert isinstance(compact, tstate.CompactState) and isinstance(dense, tstate.SchedState)


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


# ---- the apply front door -------------------------------------------------------


@pytest.mark.parametrize("config,extra", [("examples/simtpu-config.yaml", []),
                                          ("examples/simtpu-storage-config.yaml", ["-e", "open-local"])],
                         ids=["demo", "storage"])
def test_search_incremental_through_both_clis(monkeypatch, capsys, config, extra):
    monkeypatch.chdir(REPO)
    docs = []
    for pkg in (simtpu, simtpu_torch):
        rc, lines = _cli(pkg, ["apply", "-f", config, *extra, "--search", "incremental", "--json"], capsys)
        assert rc == 0
        docs.append(json.loads(lines[-1]))
    want, got = docs
    for key in ("success", "nodes_added", "message", "probes", "unscheduled"):
        assert got[key] == want[key], key
    for key in ("search", "bulk", "reference_exact", "auto_search", "auto_bulk", "preemption_ignored"):
        assert got["engine"][key] == want["engine"][key], key
    assert got["engine"]["search"] == "incremental" and got["engine"]["bulk"] is True
    assert {"tensorize", "base", "ingest", "plan"} <= set(got["timings"])


def test_auto_path_through_both_clis(monkeypatch, capsys):
    """Thresholds lowered in both packages so the demo config counts as
    large: the auto-selection notice, the engines and the report equal."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jcap, "AUTO_ENGINE_NODES", 1)
    monkeypatch.setattr(tcap, "AUTO_ENGINE_NODES", 1)
    outs = []
    for pkg in (simtpu, simtpu_torch):
        rc, lines = _cli(pkg, ["apply", "-f", "examples/simtpu-config.yaml"], capsys)
        outs.append((rc, lines))
    assert outs[1] == outs[0] and outs[0][0] == 0
    for pkg in (simtpu, simtpu_torch):
        _cli(pkg, ["apply", "-f", "examples/simtpu-config.yaml", "--json"], capsys)
    jerr = []
    for pkg in (simtpu, simtpu_torch):
        main = __import__(f"{pkg.__name__}.cli", fromlist=["main"]).main
        _expand_mod(pkg).seed_name_hashes(23)
        try:
            main(["apply", "-f", "examples/simtpu-config.yaml", "--json"]
                 + ([] if pkg is simtpu else ["--device", "cpu"]))
        finally:
            _expand_mod(pkg).seed_name_hashes(None)
        jerr.append([line for line in capsys.readouterr().err.splitlines() if "auto-selected" in line])
    assert jerr[0] == jerr[1] and len(jerr[0]) == 1


@pytest.mark.parametrize("corrected", [False, True])
def test_corrected_ds_overhead_through_both_clis(monkeypatch, capsys, tmp_path, corrected):
    """`apply --corrected-ds-overhead` in both CLIs: a template whose
    DaemonSet overhead leaves no room for the app pod is diagnosed only
    with the flag, as in the JAX CLI."""
    import yaml

    monkeypatch.chdir(tmp_path)
    (tmp_path / "cluster").mkdir()
    (tmp_path / "app").mkdir()
    (tmp_path / "newnode").mkdir()
    node = make_fake_node("base-1", "4", "8Gi")
    ds = make_fake_daemon_set("heavy-ds", "kube-system", "3", "1Gi")
    (tmp_path / "cluster" / "objs.yaml").write_text(yaml.safe_dump_all([node, ds]))
    dep = make_fake_deployment("web", "default", 1, "2", "4Gi")
    (tmp_path / "app" / "dep.yaml").write_text(yaml.safe_dump(dep))
    (tmp_path / "newnode" / "node.yaml").write_text(yaml.safe_dump(make_fake_node("template", "4", "8Gi")))
    config = {"apiVersion": "simon/v1alpha1", "kind": "Config", "metadata": {"name": "ds"},
              "spec": {"cluster": {"customConfig": "cluster"}, "appList": [{"name": "app", "path": "app"}],
                       "newNode": "newnode"}}
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    argv = ["apply", "-f", "config.yaml", "--json", "--search", "binary"] + (
        ["--corrected-ds-overhead"] if corrected else [])
    docs = []
    for pkg in (simtpu, simtpu_torch):
        _, lines = _cli(pkg, argv, capsys)
        docs.append(json.loads(lines[-1]))
    want, got = docs
    for key in ("success", "nodes_added", "message", "probes"):
        assert got[key] == want[key], key
    assert ("cannot meet resource requests" in got["message"]) == corrected
