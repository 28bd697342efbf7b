"""The port's capacity planner and `apply` front door against the JAX
package's.

Mirrors tests/test_plan.py's serial-planner cases — `TestNewFakeNodes`,
`TestPlanCapacity` (binary and linear, zero added, both diagnoses, a
tainted template), `TestResourceSetting`, `TestMeetResourceRequests`,
`TestBinarySearchCapNonMonotone` and `TestAutoEngines` — with each case
built once per package and planned by both, pod-name suffixes seeded
alike: the PlanResults' verdict, count, message, probes and audit counters
and the winning candidate's placement record must be equal. The engine
selection (`_resolve_engines`) must equal the JAX package's, the bulk and
incremental choices included (their plans: tests/test_torch_incremental.py).
Also here: the injected-divergence
fallback (tests/test_audit.py's serial case) and the repo's three example
configs through both CLIs (exit code, report tables, `--json` plan).

The JAX side runs its auditor's numpy twin (`SIMTPU_AUDIT_JIT=0`).
"""

import json
import os
import re

import pytest

import simtpu
import simtpu.plan.capacity as jcap
import simtpu_torch
import simtpu_torch.constants as C
import simtpu_torch.plan.capacity as tcap
from simtpu_torch.smoke import AUDIT_KEYS, placement_record

from .fixtures import (
    make_fake_daemon_set,
    make_fake_deployment,
    make_fake_node,
    make_fake_pod,
    with_node_labels,
    with_node_taints,
    with_pod_node_selector,
    with_template_node_selector,
)
from ._threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATE = make_fake_node("template", "4", "8Gi")


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _small_cluster(pkg):
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node("base-1", "4", "8Gi")]
    return cluster


def _app(pkg, replicas, cpu="2", memory="4Gi"):
    res = pkg.ResourceTypes()
    res.deployments = [make_fake_deployment("web", "default", replicas, cpu, memory)]
    return pkg.AppResource(name="app", resource=res)


def _plan_doc(plan) -> dict:
    return {
        "success": plan.success,
        "nodes_added": plan.nodes_added,
        "message": plan.message,
        "probes": dict(plan.probes),
        "audit": {k: plan.audit[k] for k in AUDIT_KEYS if k in plan.audit},
        "fallback": bool(plan.audit.get("fallback")),
        "record": None if plan.result is None else placement_record(plan.result),
    }


def assert_same_plan(build, **kw):
    """Plan `build(pkg)` -> (cluster, apps, template) with both packages;
    returns the two PlanResults (JAX, port) after requiring equal docs."""
    plans = []
    for pkg, mod in ((simtpu, jcap), (simtpu_torch, tcap)):
        cluster, apps, template = build(pkg)
        extra = {} if pkg is simtpu else {"device": "cpu"}
        pkg.workloads.expand.seed_name_hashes(11)
        try:
            plans.append(mod.plan_capacity(cluster, apps, template, **kw, **extra))
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
    want, got = plans
    assert _plan_doc(got) == _plan_doc(want)
    return want, got


def _small(replicas, cpu="2", memory="4Gi", template=TEMPLATE):
    return lambda pkg: (_small_cluster(pkg), [_app(pkg, replicas, cpu, memory)], template)


def test_new_fake_nodes_names_and_labels():
    nodes = tcap.new_fake_nodes(TEMPLATE, 3)
    assert [n["metadata"]["name"] for n in nodes] == ["simon-00", "simon-01", "simon-02"]
    for n in nodes:
        assert C.LABEL_NEW_NODE in n["metadata"]["labels"]
        assert n["metadata"]["labels"]["kubernetes.io/hostname"] == n["metadata"]["name"]
    assert nodes == jcap.new_fake_nodes(TEMPLATE, 3)


@pytest.mark.parametrize("search", ["linear", "binary"])
def test_min_nodes_found(search):
    _, got = assert_same_plan(_small(4, "3", "6Gi"), search=search)
    assert got.success and got.nodes_added == 3
    assert got.audit["ok"] and got.engine == {}


def test_zero_added_when_cluster_suffices():
    _, got = assert_same_plan(_small(1, "1", "1Gi"))
    assert got.success and got.nodes_added == 0


@pytest.mark.parametrize("search", ["linear", "binary"])
def test_linear_and_binary_agree(search):
    _, got = assert_same_plan(_small(7, "3", "1Gi"), search=search)
    assert got.success and got.nodes_added == 6


def test_diagnose_affinity_never_fits():
    def build(pkg):
        res = pkg.ResourceTypes()
        res.pods = [make_fake_pod("picky", "default", "1", "1Gi",
                                  with_pod_node_selector({"special": "yes"}))]
        return _small_cluster(pkg), [pkg.AppResource(name="a", resource=res)], TEMPLATE

    _, got = assert_same_plan(build)
    assert not got.success and "does not fit new node affinity or taints" in got.message


def test_diagnose_pod_larger_than_template():
    _, got = assert_same_plan(_small(2, "32", "1Gi"))
    assert not got.success and "cannot meet resource requests" in got.message


def test_tainted_template_diagnosed():
    template = make_fake_node("template", "4", "8Gi",
                              with_node_taints([{"key": "dedicated", "effect": "NoSchedule"}]))
    _, got = assert_same_plan(_small(4, "3", "1Gi", template))
    assert not got.success and "affinity or taints" in got.message


@pytest.mark.parametrize("cap,added", [("50", 1), ("90", 0)])
def test_max_cpu_cap(monkeypatch, cap, added):
    monkeypatch.setenv(C.ENV_MAX_CPU, cap)
    _, got = assert_same_plan(_small(1, "3", "1Gi"))
    assert got.success and got.nodes_added == added


def test_invalid_cap_falls_back_to_100(monkeypatch):
    monkeypatch.setenv(C.ENV_MAX_CPU, "250")
    _, got = assert_same_plan(_small(1, "3", "1Gi"))
    assert got.success


@pytest.mark.parametrize("corrected", [False, True])
def test_meet_resource_requests_daemonset_overhead(corrected):
    ds = make_fake_daemon_set("heavy-ds", "kube-system", "3", "1Gi")
    pod = make_fake_pod("p", "default", "2", "1Gi")
    light = make_fake_pod("p2", "default", "1", "1Gi")
    for node in (TEMPLATE, make_fake_node("simon", "4", "8Gi"),
                 make_fake_node("worker-template", "4", "8Gi")):
        for p in (pod, light):
            want = jcap.meet_resource_requests(node, p, [ds], corrected=corrected)
            assert tcap.meet_resource_requests(node, p, [ds], corrected=corrected) == want
    assert tcap.meet_resource_requests(TEMPLATE, pod, [ds])
    assert not tcap.meet_resource_requests(make_fake_node("simon", "4", "8Gi"), pod, [ds])
    assert tcap.meet_resource_requests(TEMPLATE, pod, [ds], corrected=True) is False


@pytest.mark.parametrize("corrected", [False, True])
def test_corrected_flag_changes_plan_diagnostic(corrected):
    def build(pkg):
        cluster = _small_cluster(pkg)
        cluster.daemon_sets = [make_fake_daemon_set("heavy-ds", "kube-system", "3", "1Gi")]
        return cluster, [_app(pkg, 1, "2", "4Gi")], TEMPLATE

    _, got = assert_same_plan(build, max_new_nodes=4, corrected_ds_overhead=corrected)
    assert not got.success
    assert ("cannot meet resource requests" in got.message) is corrected


def _cap_window(pkg):
    """tests/test_plan.py TestBinarySearchCapNonMonotone: with MaxCPU=24
    the feasible window is exactly {3} and the doubling never lands on it."""
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node(f"base-{i}", "10", "100Gi") for i in range(10)]
    cluster.daemon_sets = [make_fake_daemon_set(
        "heavy-agent", "kube-system", "6", "1Gi", with_template_node_selector({"pool": "fresh"}))]
    res = pkg.ResourceTypes()
    res.deployments = [make_fake_deployment(
        "web", "default", 6, "2", "1Gi", with_template_node_selector({"pool": "fresh"}))]
    template = make_fake_node("tmpl", "10", "100Gi", with_node_labels({"pool": "fresh"}))
    return cluster, [pkg.AppResource(name="web", resource=res)], template


@pytest.mark.parametrize("search", ["linear", "binary"])
def test_binary_falls_back_to_linear_answer(monkeypatch, capsys, search):
    monkeypatch.setenv(C.ENV_MAX_CPU, "24")
    _, got = assert_same_plan(_cap_window, max_new_nodes=10, search=search)
    assert got.success and got.nodes_added == 3
    if search == "binary":
        assert "falling back" in capsys.readouterr().err
        assert got.probes.get(4) == 0


def test_caps_off_stays_on_bisection(monkeypatch, capsys):
    monkeypatch.delenv(C.ENV_MAX_CPU, raising=False)
    _, got = assert_same_plan(_cap_window, max_new_nodes=10)
    assert "falling back" not in capsys.readouterr().err
    assert got.success and got.nodes_added == 3


def test_injected_divergence_ships_certified_fallback(monkeypatch):
    """tests/test_audit.py's serial planner case: the primary answer's audit
    fails (injected), the winner re-simulates with a clean audit, and the
    certified re-run ships with the divergence record."""
    monkeypatch.setenv("SIMTPU_AUDIT_INJECT", "1")
    plans = []
    for pkg, mod in ((simtpu, jcap), (simtpu_torch, tcap)):
        build = _small(7, "2", "4Gi")
        cluster, apps, template = build(pkg)
        kw = {} if pkg is simtpu else {"device": "cpu", "_audit_inject": True}
        pkg.workloads.expand.seed_name_hashes(11)
        plans.append(mod.plan_capacity(cluster, apps, template, 8, **kw))
        pkg.workloads.expand.seed_name_hashes(None)
    want, got = plans
    assert got.success and not got.result.unscheduled_pods
    doc = got.audit
    assert doc["fallback"] is True and doc["ok"] is True and doc["violations"] >= 1
    assert doc["fallback_audit"]["ok"] is True and doc["divergence"]["violations"]
    for key in ("violations", "by_class", "checked", "divergence"):
        assert doc[key] == want.audit[key], key
    assert (got.nodes_added, got.probes) == (want.nodes_added, want.probes)
    assert [c["fallback"] for c in got.candidates][-1] is True
    clean = tcap.plan_capacity(*_small(7, "2", "4Gi")(simtpu_torch), 8, device="cpu")
    assert clean.nodes_added == got.nodes_added and "fallback" not in clean.audit


def test_audit_false_opts_out():
    plan = tcap.plan_capacity(*_small(7, "2", "4Gi")(simtpu_torch), 8, audit=False, device="cpu")
    assert plan.success and plan.audit == {}
    assert all("audit_split" not in c for c in plan.candidates)


def test_candidates_record_each_simulation():
    plan = tcap.plan_capacity(*_small(7, "3", "1Gi")(simtpu_torch), device="cpu")
    assert [c["count"] for c in plan.candidates] == list(plan.probes)
    assert all(set(c["audit_split"]) == {"upload", "bulk", "host"} for c in plan.candidates)


# ---- engine selection ------------------------------------------------------


def test_small_problem_keeps_serial_engines(capsys):
    args = (_small_cluster(simtpu), [_app(simtpu, 3)])
    want = jcap._resolve_engines(jcap.ApplierOptions(), *args)
    got = tcap._resolve_engines(tcap.ApplierOptions(), _small_cluster(simtpu_torch),
                                [_app(simtpu_torch, 3)])
    assert got == want == ("binary", False, None)
    assert capsys.readouterr().err == ""


def test_large_node_count_refuses(capsys):
    """Formerly a refusal: the port now auto-selects the bulk engine and the
    incremental search with the JAX package's notice."""
    cluster = simtpu_torch.ResourceTypes()
    cluster.nodes = [make_fake_node(f"n{i}", "4", "8Gi") for i in range(tcap.AUTO_ENGINE_NODES)]
    got = tcap._resolve_engines(tcap.ApplierOptions(), cluster, [_app(simtpu_torch, 3)])
    got_err = capsys.readouterr().err
    jcluster = simtpu.ResourceTypes(nodes=cluster.nodes)
    want = jcap._resolve_engines(jcap.ApplierOptions(), jcluster, [_app(simtpu, 3)])
    assert got == want == ("incremental", True, None)
    assert got_err == capsys.readouterr().err and "auto-selected" in got_err


def test_large_declared_pod_count_refuses(capsys):
    """Formerly a refusal: the declared-pod threshold selects the fast
    engines, as in the JAX package."""
    got = tcap._resolve_engines(tcap.ApplierOptions(), _small_cluster(simtpu_torch),
                                [_app(simtpu_torch, tcap.AUTO_ENGINE_PODS)])
    got_err = capsys.readouterr().err
    want = jcap._resolve_engines(jcap.ApplierOptions(), _small_cluster(simtpu),
                                 [_app(simtpu, jcap.AUTO_ENGINE_PODS)])
    assert got == want == ("incremental", True, None)
    assert got_err == capsys.readouterr().err


@pytest.mark.parametrize("search", ["linear", "binary"])
def test_explicit_flags_override_auto(search, capsys):
    opts = tcap.ApplierOptions(search=search, bulk=False)
    got = tcap._resolve_engines(opts, _small_cluster(simtpu_torch),
                                [_app(simtpu_torch, tcap.AUTO_ENGINE_PODS)])
    want = jcap._resolve_engines(jcap.ApplierOptions(search=search, bulk=False),
                                 _small_cluster(simtpu), [_app(simtpu, jcap.AUTO_ENGINE_PODS)])
    assert got == want == (search, False, None)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("opts", [dict(search="incremental"), dict(bulk=True),
                                  dict(search="binary")])
def test_bulk_and_incremental_refuse(opts, capsys):
    """Formerly a refusal: the asked-for engines resolve as the JAX
    package's, and a bulk plan equals the JAX package's; only `shard=True`
    is refused (ROADMAP queue 1 #10)."""
    got = tcap._resolve_engines(tcap.ApplierOptions(**opts), _small_cluster(simtpu_torch),
                                [_app(simtpu_torch, tcap.AUTO_ENGINE_PODS)])
    want = jcap._resolve_engines(jcap.ApplierOptions(**opts), _small_cluster(simtpu),
                                 [_app(simtpu, jcap.AUTO_ENGINE_PODS)])
    assert got == want
    if opts.get("bulk"):
        _, plan = assert_same_plan(_small(4, "3", "6Gi"), bulk=True)
        assert plan.success and plan.nodes_added == 3
    with pytest.raises(NotImplementedError, match="queue 1 #10"):
        tcap._resolve_engines(tcap.ApplierOptions(shard=True, **opts), _small_cluster(simtpu_torch),
                              [_app(simtpu_torch, 3)])


def test_default_device_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcap.plan_capacity(_small_cluster(simtpu_torch), [_app(simtpu_torch, 1)], TEMPLATE)


# ---- the apply front door ----------------------------------------------------

EXAMPLES = [
    ("examples/simtpu-config.yaml", []),
    ("examples/simtpu-gpushare-config.yaml", ["-e", "gpu"]),
    ("examples/simtpu-storage-config.yaml", ["-e", "open-local"]),
]
#: lines that carry times or engine switches, which differ by design
_VARIABLE = ("phase timings:", "engine selection:", "simtpu: persistent compilation cache")
_AUDIT_TIME = re.compile(r", [0-9.]+s, \w+ mode\)")


def _cli(pkg, argv, capsys):
    from importlib import import_module

    main = import_module(f"{pkg.__name__}.cli").main
    pkg.workloads.expand.seed_name_hashes(23)
    try:
        rc = main(argv + ([] if pkg is simtpu else ["--device", "cpu"]))
    finally:
        pkg.workloads.expand.seed_name_hashes(None)
    out = capsys.readouterr().out
    lines = [_AUDIT_TIME.sub(")", line) for line in out.splitlines()
             if not line.startswith(_VARIABLE)]
    return rc, lines


@pytest.mark.parametrize("config,extra", EXAMPLES, ids=["demo", "gpushare", "storage"])
def test_example_reports_equal_through_both_clis(monkeypatch, capsys, config, extra):
    monkeypatch.chdir(REPO)
    want = _cli(simtpu, ["apply", "-f", config, *extra], capsys)
    got = _cli(simtpu_torch, ["apply", "-f", config, *extra], capsys)
    assert got == want
    rc, lines = got
    assert rc == 0 and any("Success!" in line for line in lines)
    assert any("Audit: clean (" in line for line in lines)


@pytest.mark.parametrize("config,extra", EXAMPLES, ids=["demo", "gpushare", "storage"])
def test_example_json_plans_equal_through_both_clis(monkeypatch, capsys, config, extra):
    monkeypatch.chdir(REPO)
    docs = []
    for pkg in (simtpu, simtpu_torch):
        rc, lines = _cli(pkg, ["apply", "-f", config, *extra, "--json"], capsys)
        assert rc == 0
        docs.append(json.loads(lines[-1]))
    want, got = docs
    for key in ("success", "nodes_added", "message", "partial", "probes", "unscheduled"):
        assert got[key] == want[key], key
    audit = {k: got["engine"]["audit"][k] for k in AUDIT_KEYS}
    assert audit == {k: want["engine"]["audit"][k] for k in AUDIT_KEYS}
    assert audit["ok"] and audit["checked"] > 0
    assert got["engine"]["search"] == "binary" and got["engine"]["bulk"] is False
    assert got["engine"]["device"] == "cpu" and set(got["timings"]) == {"ingest", "plan"}
    assert got["success"] is True and got["partial"] is False and got["unscheduled"] == 0


def test_cli_rejects_unported_flags_and_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from simtpu_torch.cli import main

    monkeypatch.chdir(REPO)
    # --explain and --solver are ported; --trace is not
    for flag in ("--shard", "--profile", "--trace", "--checkpoint"):
        with pytest.raises(SystemExit):
            main(["apply", "-f", "examples/simtpu-config.yaml", flag])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["apply", "-f", "examples/simtpu-config.yaml", "--json"]) == 1
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["success"] is False and "CUDA" in doc["message"]
