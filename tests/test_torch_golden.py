"""The golden records of the smoke problems (simtpu_torch/smoke.py).

`compute_golden()` runs the JAX package's `simtpu.simulate` on the CPU at
the smoke shape (1000 nodes × 10 000 pods) and returns its placement
record; `compute_extended_golden()` does the same for the extended problem
(Open-Local storage, GPU-share and a priority tier that preempts).
`compute_capacity_golden()` runs the JAX package's `plan_capacity` on the
capacity problem (the numpy audit twin, `SIMTPU_AUDIT_JIT=0`) and returns
its plan record: verdict, probes, audit counters and the winning
candidate's placement record.
`tests/data/torch_serial_smoke.json.gz`,
`tests/data/torch_extended_smoke.json.gz` and
`tests/data/torch_capacity_smoke.json.gz` are those records, which
`chip_smoke.py` holds the port's on-card runs against. Regenerate them with
`JAX_PLATFORMS=cpu SIMTPU_WAVEFRONT=0 SIMTPU_AUDIT_JIT=0 python tests/test_torch_golden.py --write`.
`compute_bulk_golden()` runs the JAX package's `simulate(bulk=True)` on the
bulk problem (5000 nodes x 150 000 pods) and returns its bulk record
(`smoke.bulk_record`); `compute_large_capacity_golden()` runs its
incremental planner on the large capacity problem and returns the plan
record: `tests/data/torch_bulk_smoke.json.gz` and
`tests/data/torch_large_capacity_smoke.json.gz`, written alone by
`--write --bulk-only` in the same environment.
`compute_explain_golden()` (`--write --explain-only`, the same environment)
writes `tests/data/torch_explain.json.gz`: the decision-observability
records of `chip_smoke.py` phases 12 and 13 (`smoke.EXPLAIN_GOLDEN`).
`compute_compact_carry()` (`--compact-carry`, the same environment) runs
the five with the JAX package's compact carry on and returns its
compress / expand / direct-delta counts and final carried bytes, which
`smoke.COMPACT_CARRY` holds.

A full recompute takes tens of seconds (the plan: minutes) on the CPU, so
it is marked slow; the fast tier checks the committed files' shape.
"""

import sys

import numpy as np
import pytest

from simtpu_torch import smoke
from simtpu_torch.plan.capacity import AUTO_ENGINE_NODES, AUTO_ENGINE_PODS
from ._threads import one_torch_thread  # noqa: F401 (autouse)


def _record(problem) -> dict:
    import simtpu
    from simtpu.workloads.expand import seed_name_hashes

    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.placement_record(simtpu.simulate(*problem))
    finally:
        seed_name_hashes(None)


def compute_golden() -> dict:
    from simtpu.synth import synth_apps, synth_cluster

    return _record(smoke.smoke_problem(synth_cluster, synth_apps))


def compute_extended_golden() -> dict:
    import simtpu
    from simtpu import synth

    return _record(smoke.extended_problem(synth, simtpu.AppResource, simtpu.ResourceTypes))


def compute_capacity_golden() -> dict:
    import simtpu
    from simtpu import synth
    from simtpu.plan.capacity import plan_capacity
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps, template = smoke.capacity_problem(synth, simtpu.AppResource,
                                                     simtpu.ResourceTypes)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.plan_record(plan_capacity(cluster, apps, template))
    finally:
        seed_name_hashes(None)


def test_committed_golden_is_whole():
    golden = smoke.load_record()
    assert len(golden["nodes"]) == smoke.N_NODES
    assert len(golden["placed"]) + len(golden["failed"]) == smoke.N_PODS
    assert all(0 <= i < smoke.N_NODES for i in golden["placed"].values())
    assert golden["preempted"] == [] and golden["gpu_index"] == {} and golden["node_ext"] == {}


def test_committed_extended_golden_is_whole():
    golden = smoke.load_record(smoke.EXT_GOLDEN)
    n_tier = sum(replicas for _, replicas, _ in smoke.EXT_TIER)
    assert len(golden["nodes"]) == smoke.N_NODES
    assert len(golden["placed"]) + len(golden["failed"]) + len(golden["preempted"]) == (
        smoke.N_PODS + n_tier
    )
    assert len(golden["preempted"]) >= 50
    assert sum("/tier-" in k for k in golden["placed"]) == n_tier
    assert golden["gpu_index"] and golden["node_ext"]
    assert set(golden["gpu_index"]) <= set(golden["placed"])


def test_committed_capacity_golden_is_whole():
    golden = smoke.load_record(smoke.CAP_GOLDEN)
    n_burst = sum(replicas for _, replicas, _, _ in smoke.CAP_BURST)
    added = golden["nodes_added"]
    assert golden["success"] is True and golden["message"] == "Success!"
    assert 8 <= added <= 90
    probes = {int(k): v for k, v in golden["probes"].items()}
    # the doubling ran past the answer and the bisection closed on it
    assert probes[added] == 0 and probes[added - 1] > 0 and probes[0] > 0
    assert len(probes) >= 8 and all(k < AUTO_ENGINE_NODES - smoke.CAP_NODES for k in probes)
    record = golden["record"]
    assert len(record["nodes"]) == smoke.CAP_NODES + added
    assert record["nodes"][smoke.CAP_NODES:] == [f"simon-{i:02d}" for i in range(added)]
    assert len(record["placed"]) == smoke.N_PODS + n_burst and not record["failed"]
    assert smoke.N_PODS + n_burst < AUTO_ENGINE_PODS
    assert golden["audit"] == {"ok": True, "checked": smoke.N_PODS + n_burst,
                               "violations": 0, "by_class": {}}


def test_committed_bulk_golden_is_whole():
    golden = smoke.load_record(smoke.BULK_GOLDEN)
    assert len(golden["nodes"]) == smoke.BULK_NODES == len(golden["per_node"])
    assert golden["pods"] == smoke.BULK_PODS
    assert sum(golden["per_node"]) + sum(golden["reasons"].values()) == smoke.BULK_PODS
    assert golden["preempted"] == 0 and len(golden["head"]) == smoke.BULK_HEAD
    assert [row[0] for row in golden["head"]] == sorted(row[0] for row in golden["head"])
    assert len(golden["digest"]) == len(golden["annotations"]) == 64
    # the JAX package's segment plan of the problem: rounds above the
    # auto-bulk thresholds
    assert sum(n for n, _ in smoke.BULK_SEGMENTS.values()) == 150
    assert sum(p for _, p in smoke.BULK_SEGMENTS.values()) == smoke.BULK_PODS
    assert smoke.BULK_NODES >= AUTO_ENGINE_NODES and smoke.BULK_PODS >= AUTO_ENGINE_PODS


def test_committed_large_capacity_golden_is_whole():
    golden = smoke.load_record(smoke.LCAP_GOLDEN)
    n_all = smoke.LCAP_PODS + sum(b[1] for b in smoke.LCAP_BURST)
    assert golden["success"] is True and golden["nodes_added"] == 38
    assert golden["probes"] == {"0": 300, "37": 4, "38": 0}
    assert golden["audit"] == {"ok": True, "checked": n_all, "violations": 0, "by_class": {}}
    record = golden["record"]
    assert len(record["nodes"]) == smoke.LCAP_NODES + 38 and not record["failed"]
    assert len(record["placed"]) == n_all and n_all >= AUTO_ENGINE_PODS


def test_bulk_record_keys_and_digests():
    """`bulk_record` on a small result: the head in key order, the digests
    moved by one placement, the reason counts keyed without pod names."""
    import simtpu_torch
    from simtpu_torch import synth

    cluster = synth.synth_cluster(4, seed=1, zones=2)
    apps = [simtpu_torch.AppResource(name="a", resource=simtpu_torch.ResourceTypes(
        deployments=[synth.make_deployment("big", 40, 16000, 1024)]))]
    res = simtpu_torch.simulate(cluster, apps, device="cpu")
    rec = smoke.bulk_record(res, head=5)
    assert rec["pods"] == 40 and len(rec["head"]) == 5
    assert list(rec["reasons"]) == ["insufficient cpu/memory/extended resources on every feasible node"]
    assert sum(rec["per_node"]) + sum(rec["reasons"].values()) == 40
    moved = res.node_status[0].pods.pop()
    res.node_status[1].pods.append(moved)
    other = smoke.bulk_record(res, head=5)
    assert other["digest"] != rec["digest"] and smoke.bulk_differences(other, rec)


def test_sweep_record_digests_the_requeue():
    """`sweep_record` keeps the counters without the rate and digests the
    requeue tables: one moved landing node shows."""
    from simtpu_torch import faults, synth

    cluster = synth.synth_cluster(6, seed=2, zones=2)
    apps = synth.synth_apps(30, seed=3, zones=2, pods_per_deployment=5)
    pc = faults.place_cluster(cluster, apps, device="cpu")
    sweep = faults.sweep_scenarios(pc, faults.generate_scenarios(cluster.nodes, "k=1"))
    rec = smoke.sweep_record(sweep)
    assert "fault_scenarios_per_s" not in rec["counters"] and rec["counters"]["scenarios"] == 6
    assert rec["rq_shape"] == list(sweep.requeue_rows.shape) and len(rec["requeue_nodes"]) == 64
    sweep.requeue_nodes[0, 0] += 1
    assert smoke.sweep_differences(smoke.sweep_record(sweep), rec) == [
        "requeue_nodes: " + f"{smoke.sweep_record(sweep)['requeue_nodes']!r} != golden {rec['requeue_nodes']!r}"]


def test_capacity_config_round_trips(tmp_path):
    """The capacity problem written as a simon Config loads back, through the
    port's apply front door, as the same objects (the loader only adds its
    source-file key), under the auto-bulk thresholds."""
    import simtpu_torch
    from simtpu_torch import synth
    from simtpu_torch.plan.capacity import Applier, ApplierOptions, _resolve_engines

    burst = tuple((name, 7, cpu, mem) for name, _, cpu, mem in smoke.CAP_BURST)
    cluster, apps, template = smoke.capacity_problem(
        synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes, n_nodes=30, n_pods=300,
        burst=burst)
    applier = Applier(ApplierOptions(simon_config=smoke.write_capacity_config(
        tmp_path, cluster, apps, template), device="cpu"))

    def plain(objs):
        return [{k: v for k, v in o.items() if k != "__simtpu_source__"} for o in objs]

    loaded = applier.load_apps()
    assert [a.name for a in loaded] == ["synthetic", "burst"]
    for got, want in zip(loaded, apps):
        assert plain(got.resource.deployments) == want.resource.deployments
    assert plain(applier.load_cluster().nodes) == cluster.nodes
    assert plain([applier.load_new_node()]) == [template]
    assert _resolve_engines(applier.opts, cluster, apps) == ("binary", False, None)


def test_committed_fault_goldens_are_whole():
    """The fault sweeps' records (chip_smoke.py phases 8-11): the zone sweep
    of the serial smoke problem (16 zones, every pod evicted once, up to 250
    stranded) and its k=1 sweep (1000 scenarios, all survive), the bulk
    problem's k=2:256 sweep, the capacity problem's batched feasibility at
    six candidates and its resilience plan."""
    serial = smoke.load_record(smoke.FAULT_GOLDEN)
    zone, k1 = serial["zone"], serial["k1"]
    assert zone["counters"]["scenarios"] == 16 and zone["counters"]["evicted_total"] == smoke.N_PODS
    assert len(zone["unplaced"]) == 16 and max(zone["unplaced"]) == zone["counters"]["unplaced_max"]
    assert k1["counters"]["scenarios"] == smoke.N_NODES == len(k1["unplaced"])
    assert serial["cli"]["scenarios"] == 16 and serial["cli"]["worst"] == zone["worst"]
    assert serial["rc"] in (0, 1, 4) and serial["base_unplaced"] == serial["cli"]["base_unplaced"]
    for rec in (zone, k1):
        assert sum(rec["requeued"]) + sum(rec["lost"]) == sum(rec["evicted"])
        assert all(len(rec[k]) == 64 for k in ("requeue_rows", "requeue_nodes", "requeue_reasons"))
    bulk = smoke.load_record(smoke.BULK_FAULT_GOLDEN)["sweep"]
    assert bulk["counters"]["scenarios"] == 256 == len(bulk["unplaced"])
    cap = smoke.load_record(smoke.CAP_FAULT_GOLDEN)
    assert cap["candidates"] == list(smoke.CAP_SWEEP_CANDIDATES) and len(cap["failures"]) == 6
    added = smoke.load_record(smoke.CAP_GOLDEN)["nodes_added"]
    feasible = [c for c, f in zip(cap["candidates"], cap["failures"]) if f == 0]
    assert feasible and feasible[0] == added
    winner = cap["winner"]
    assert len(winner["nodes"]) == smoke.CAP_NODES + added and not winner["failed"]
    plan = cap["plan"]
    assert plan["success"] is True and plan["nodes_added"] >= added
    assert plan["probes"][str(plan["nodes_added"])]["survived"] == plan["scenarios"] == 64


def compute_bulk_golden() -> dict:
    """The JAX package's `simulate(bulk=True)` on the bulk problem, as a
    bulk record."""
    import simtpu
    from simtpu import synth
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps = smoke.bulk_problem(synth)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.bulk_record(simtpu.simulate(cluster, apps, bulk=True))
    finally:
        seed_name_hashes(None)


def compute_large_capacity_golden() -> dict:
    """The JAX package's incremental planner on the large capacity problem
    (auto-selected: bulk placement + incremental search), as a plan record."""
    import simtpu
    from simtpu import synth
    from simtpu.plan.incremental import plan_capacity_incremental
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps, template = smoke.large_capacity_problem(synth, simtpu.AppResource,
                                                           simtpu.ResourceTypes)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        return smoke.plan_record(plan_capacity_incremental(cluster, apps, template))
    finally:
        seed_name_hashes(None)


def _compact_carry(run) -> dict:
    """The JAX package's `state.compress`, `state.expand` and
    `state.delta_direct` counters over `run()`, and its carried-state
    gauge's carried and dense bytes after it."""
    from simtpu.obs.metrics import REGISTRY

    keys = ("state.compress", "state.expand", "state.delta_direct")
    before = REGISTRY.snapshot("state.")
    run()
    after = REGISTRY.snapshot("state.")
    out = {k.split(".", 1)[1]: after.get(k, 0) - before.get(k, 0) for k in keys}
    out.update(carried_bytes=after["state.carried_bytes"], dense_bytes=after["state.dense_bytes"])
    return out


def compute_compact_carry() -> dict:
    """The JAX package's compact carry on each main path, with the carry on
    (its default): the compress / expand / direct-delta counts and the
    final carry's bytes that `chip_smoke.py` holds the port's K11/K12/K13
    launches and byte gauge against (`smoke.COMPACT_CARRY`)."""
    return {
        "serial": _compact_carry(compute_golden),
        "extended": _compact_carry(compute_extended_golden),
        "capacity": _compact_carry(compute_capacity_golden),
        **compute_bulk_compact_carry(),
    }


def compute_bulk_compact_carry() -> dict:
    """The JAX package's compact-carry counts and bytes on the bulk and the
    large capacity paths (`smoke.COMPACT_CARRY["bulk"]`, `["large_capacity"]`)."""
    return {
        "bulk": _compact_carry(compute_bulk_golden),
        "large_capacity": _compact_carry(compute_large_capacity_golden),
    }


@pytest.mark.slow
def test_golden_matches_a_fresh_jax_run():
    assert smoke.record_differences(compute_golden(), smoke.load_record()) == []


@pytest.mark.slow
def test_extended_golden_matches_a_fresh_jax_run():
    want = smoke.load_record(smoke.EXT_GOLDEN)
    assert smoke.record_differences(compute_extended_golden(), want) == []


@pytest.mark.slow
def test_capacity_golden_matches_a_fresh_jax_run(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    want = smoke.load_record(smoke.CAP_GOLDEN)
    assert smoke.plan_differences(compute_capacity_golden(), want) == []


@pytest.mark.slow
def test_bulk_golden_matches_a_fresh_jax_run():
    want = smoke.load_record(smoke.BULK_GOLDEN)
    assert smoke.bulk_differences(compute_bulk_golden(), want) == []


@pytest.mark.slow
def test_large_capacity_golden_matches_a_fresh_jax_run(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    want = smoke.load_record(smoke.LCAP_GOLDEN)
    assert smoke.plan_differences(compute_large_capacity_golden(), want) == []


@pytest.mark.slow
def test_compact_carry_matches_a_fresh_jax_run(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    monkeypatch.setenv("SIMTPU_COMPACT", "1")
    assert compute_compact_carry() == smoke.COMPACT_CARRY


def compute_fault_golden(root) -> dict:
    """The JAX package's `simtpu resilience --faults zone --json` on the
    serial smoke problem written as a simon Config under `root`, and a
    `k=1` sweep over the same PlacedCluster: the CLI document (without
    timings), both sweeps' records and the base placement's digest."""
    import simtpu.faults as jf
    from simtpu import synth
    from simtpu.cli import main
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps = smoke.smoke_problem(synth.synth_cluster, synth.synth_apps)
    cfg = smoke.write_capacity_config(root, cluster, apps, smoke.template_node(synth))
    seed_name_hashes(smoke.NAME_SEED)
    try:
        with smoke.capture_sweeps(jf) as got:
            rc, doc = smoke.run_cli_json(main, ["resilience", "-f", cfg, "--faults",
                                                smoke.FAULT_ZONE_SPEC, "--json"])
        pc, zone = got[0]
        k1 = jf.sweep_scenarios(pc, jf.generate_scenarios(cluster.nodes, smoke.FAULT_K1_SPEC))
    finally:
        seed_name_hashes(None)
    return {"rc": rc, "cli": smoke.doc_record(doc), "base": smoke.placed_digest(pc.nodes),
            "base_unplaced": int((pc.nodes < 0).sum()), "zone": smoke.sweep_record(zone),
            "k1": smoke.sweep_record(k1)}


def compute_bulk_fault_golden() -> dict:
    """The JAX package's `place_cluster` on the bulk problem and a
    `k=2:256` sweep (seed 0) over it."""
    import simtpu.faults as jf
    from simtpu import synth
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps = smoke.bulk_problem(synth)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        pc = jf.place_cluster(cluster, apps)
        sweep = jf.sweep_scenarios(pc, jf.generate_scenarios(cluster.nodes, smoke.BULK_FAULT_SPEC, seed=0))
    finally:
        seed_name_hashes(None)
    return {"base": smoke.placed_digest(pc.nodes), "base_unplaced": int((pc.nodes < 0).sum()),
            "sweep": smoke.sweep_record(sweep)}


def compute_capacity_fault_golden(root) -> dict:
    """On the capacity problem: the JAX package's batched `sweep_feasibility`
    at smoke.CAP_SWEEP_CANDIDATES and the placement record of the
    simulation `plan_capacity_batched` runs next at the first feasible
    count (its pod names continue the seeded stream after the sweep's
    expansion, as in the batched planner), and `simtpu resilience --plan
    --faults k=2:64 --seed 0 --json` on the problem written as a simon
    Config under `root` (the document without timings)."""
    import simtpu
    from simtpu import synth
    from simtpu.cli import main
    from simtpu.parallel.sweep import sweep_feasibility
    from simtpu.plan.capacity import new_fake_nodes
    from simtpu.workloads.expand import seed_name_hashes

    cluster, apps, template = smoke.capacity_problem(synth, simtpu.AppResource, simtpu.ResourceTypes)
    cfg = smoke.write_capacity_config(root, cluster, apps, template)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        failures, _, _ = sweep_feasibility(cluster, apps, template, smoke.CAP_SWEEP_CANDIDATES)
        best = next(c for c, f in zip(smoke.CAP_SWEEP_CANDIDATES, failures) if f == 0)
        trial = simtpu.ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
        trial.nodes = list(cluster.nodes) + new_fake_nodes(template, best)
        winner = smoke.placement_record(simtpu.simulate(trial, apps))
        seed_name_hashes(smoke.NAME_SEED)
        rc, doc = smoke.run_cli_json(main, ["resilience", "-f", cfg, "--plan", "--faults",
                                            smoke.CAP_RESIL_SPEC, "--seed", "0", "--json"])
    finally:
        seed_name_hashes(None)
    return {"candidates": list(smoke.CAP_SWEEP_CANDIDATES), "failures": [int(f) for f in failures],
            "winner": winner, "plan_rc": rc, "plan": smoke.doc_record(doc)}


def _write_fault_goldens(only=()) -> None:
    """Write the three fault golden records (those named in `only`:
    serial, capacity, bulk), printing each one's CPU time."""
    import tempfile
    import time

    for name, path, fn in (("serial", smoke.FAULT_GOLDEN, compute_fault_golden),
                           ("capacity", smoke.CAP_FAULT_GOLDEN, compute_capacity_fault_golden),
                           ("bulk", smoke.BULK_FAULT_GOLDEN, compute_bulk_fault_golden)):
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as root:
            record = fn(root) if fn is not compute_bulk_fault_golden else fn()
        smoke.save_record(record, path)
        print(f"wrote {path} in {time.perf_counter() - t0:.1f} s", flush=True)


@pytest.mark.slow
def test_fault_goldens_match_a_fresh_jax_run(monkeypatch, tmp_path):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    monkeypatch.chdir(tmp_path)
    assert compute_fault_golden(tmp_path / "serial") == smoke.load_record(smoke.FAULT_GOLDEN)
    assert compute_capacity_fault_golden(tmp_path / "capacity") == smoke.load_record(smoke.CAP_FAULT_GOLDEN)
    assert compute_bulk_fault_golden() == smoke.load_record(smoke.BULK_FAULT_GOLDEN)


def compute_explain_golden(root) -> dict:
    """The JAX package's decision observability on the smoke problems, each
    run with pod names seeded: (a) `simulate(explain=True)`'s document on
    the extended problem; (b) `place_cluster(bulk=True)` on the bulk problem
    and `build_explain_doc` over every unplaced pod — the document, and the
    breakdown's per-pod rows, counts, feasible counts, witnesses and fail
    codes as digests; (c) `simtpu explain --scores 8 --json --no-bulk` on
    the serial smoke problem written as a simon Config under `root`; (d)
    `plan_capacity(max_new_nodes=20, explain=True)` on the capacity
    problem, which fails (43 nodes are needed) and carries the block; (e)
    `run_mutation_kill(seed=0, per_class=4)`'s counters."""
    import simtpu
    import simtpu.faults as jf
    from simtpu import synth
    from simtpu.audit.fuzz import run_mutation_kill
    from simtpu.cli import main
    from simtpu.explain import breakdown as jbd
    from simtpu.plan.capacity import plan_capacity
    from simtpu.workloads.expand import seed_name_hashes

    out = {}
    seed_name_hashes(smoke.NAME_SEED)
    try:
        cluster, apps = smoke.extended_problem(synth, simtpu.AppResource, simtpu.ResourceTypes)
        result = simtpu.simulate(cluster, apps, explain=True)
        out["extended"] = {"unscheduled": len(result.unscheduled_pods),
                           "doc": smoke.explain_doc_record(result.explain)}
        seed_name_hashes(smoke.NAME_SEED)
        cluster, apps = smoke.bulk_problem(synth)
        pc = jf.place_cluster(cluster, apps, bulk=True)
        unplaced = np.flatnonzero(pc.nodes < 0)
        got = []
        orig = jbd.explain_failures

        def capture(*a, **kw):
            got.append(orig(*a, **kw))
            return got[-1]

        jbd.explain_failures = capture
        try:
            doc = jbd.build_explain_doc(pc.tensors, pc.batch, unplaced, pc.engine.carried_state(), pc.nodes,
                                        pc.reasons)
        finally:
            jbd.explain_failures = orig
        out["bulk"] = {**smoke.breakdown_record(got[0], pc.nodes), "doc": smoke.explain_doc_record(doc)}
        cl, ap = smoke.smoke_problem(synth.synth_cluster, synth.synth_apps)
        cfg = smoke.write_capacity_config(root, cl, ap, smoke.template_node(synth))
        seed_name_hashes(smoke.NAME_SEED)
        rc, doc = smoke.run_cli_json(main, ["explain", "-f", cfg, "--scores", str(smoke.EXPLAIN_SCORES),
                                            "--json", "--no-bulk"])
        out["scores"] = {"rc": rc, "doc": smoke.explain_doc_record(doc)}
        seed_name_hashes(smoke.NAME_SEED)
        cluster, apps, template = smoke.capacity_problem(synth, simtpu.AppResource, simtpu.ResourceTypes)
        plan = plan_capacity(cluster, apps, template, max_new_nodes=smoke.EXPLAIN_MAX_NEW, explain=True)
        out["plan"] = {"success": plan.success, "nodes_added": plan.nodes_added, "message": plan.message,
                       "probes": {str(k): v for k, v in sorted(plan.probes.items())},
                       "explain": smoke.explain_doc_record(plan.explain)}
    finally:
        seed_name_hashes(None)
    out["mutation_kill"] = run_mutation_kill(seed=0, per_class=4)
    return out


def test_committed_explain_golden_is_whole():
    """The explain records chip_smoke.py phases 12 and 13 hold the port
    against: the extended problem's 521 unscheduled pods explained, the
    bulk problem's breakdown over every unplaced pod, eight consistent
    attributions, a failing capped plan that carries the block, and a
    mutation kill of every corruption."""
    g = smoke.load_record(smoke.EXPLAIN_GOLDEN)
    ext = g["extended"]
    assert ext["unscheduled"] == ext["doc"]["failures"]["unplaced"] == ext["doc"]["bottleneck"]["unplaced"] > 0
    assert ext["doc"]["version"] == 1 and ext["doc"]["failures"]["groups"]
    bulk = g["bulk"]
    assert bulk["unplaced"] == bulk["doc"]["failures"]["unplaced"] > 64
    assert all(len(bulk[k]) == 64 for k in ("base", "rows", "counts", "feasible", "witnesses", "fail_code"))
    sc = g["scores"]
    assert sc["rc"] == 0 and len(sc["doc"]["scores"]) == smoke.EXPLAIN_SCORES
    assert all(s["consistent"] for s in sc["doc"]["scores"])
    assert sc["doc"]["placed"] + sc["doc"]["unplaced"] == sc["doc"]["pods"] == smoke.N_PODS
    plan = g["plan"]
    assert plan["success"] is False and plan["nodes_added"] == smoke.EXPLAIN_MAX_NEW
    assert plan["explain"]["failures"]["unplaced"] > 0 and "template" in plan["explain"]["bottleneck"]
    mk = g["mutation_kill"]
    assert mk["kill_rate"] == 1.0 and not mk["missed"] and mk["classes"] == mk["classes_total"]
    for rec in (ext["doc"], bulk["doc"], plan["explain"]):
        assert "mode" not in rec["failures"] and "wall_s" not in rec["failures"]


@pytest.mark.slow
def test_explain_golden_matches_a_fresh_jax_run(monkeypatch, tmp_path):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")
    assert compute_explain_golden(tmp_path) == smoke.load_record(smoke.EXPLAIN_GOLDEN)


def _zero_extras_pgd(tensors, p: int) -> dict:
    """The solver's zero extras with `gpu_shares` of the engine's [P, GD]
    shape (the JAX package's own gives [P], which its audit broadcasts to
    an [M, M] array: 14 GiB of zeros on the large capacity problem)."""
    return {"lvm_alloc": np.zeros((p, tensors.ext.vg_cap.shape[1]), np.float32),
            "dev_take": np.zeros((p, tensors.ext.sdev_cap.shape[1]), bool),
            "gpu_shares": np.zeros((p, tensors.ext.gpu_dev_total.shape[1]), np.float32)}


def _solver_cli(main, cfg, argv) -> dict:
    """One solver CLI run with pod names seeded: exit code, the document's
    solver record, the relaxation's record and the shipped plan's digest."""
    import simtpu.plan.capacity as jcap
    import simtpu.solve.planner as jplanner
    from simtpu.workloads.expand import seed_name_hashes

    seed_name_hashes(smoke.NAME_SEED)
    try:
        with smoke.record_solver(jplanner) as relax, smoke.capture_plans(jcap) as plans:
            rc, doc = smoke.run_cli_json(main, [argv[0], "-f", cfg, *argv[1:]])
    finally:
        seed_name_hashes(None)
    out = {"rc": rc, "doc": smoke.solve_doc_record(doc), "solver": relax}
    if plans:
        out["plan"] = smoke.plan_digest(plans[-1])
    return out


def compute_solve_golden(root, only=()) -> dict:
    """The JAX package's solver paths (`smoke.SOLVE_GOLDEN`): (a) `simtpu
    apply --solver --json` on the capacity problem written as a simon Config
    under `root`, (b) the same on the large capacity problem, with the
    solver's zero extras of the [P, GD] shape (`_zero_extras_pgd`, replaced
    at run time; the verdict is the same, the memory linear), (c) `simtpu
    resilience --plan --faults CAP_RESIL_SPEC --seed 0 --solver --json` on
    the capacity config, whose relaxation is (a)'s when the problem and the
    candidates are equal. `only` picks "capacity" ((a) and (c)) or "large"."""
    import hashlib

    import simtpu
    import simtpu.solve.planner as jplanner
    from simtpu import synth
    from simtpu.cli import main

    assert jplanner.solver_iters() == smoke.SOLVE_ITERS
    out = {}
    if not only or "capacity" in only:
        cluster, apps, template = smoke.capacity_problem(synth, simtpu.AppResource, simtpu.ResourceTypes)
        cfg = smoke.write_capacity_config(f"{root}/capacity", cluster, apps, template)
        cache, relax0 = {}, jplanner.relax_candidates

        def cached(prob, valid_s, *a, **kw):
            h = hashlib.sha256()
            for arr in (prob.feas, prob.req, prob.cnt, prob.fixed, prob.cap, valid_s):
                h.update(np.ascontiguousarray(arr).tobytes())
            key = h.hexdigest()
            if key not in cache:
                cache[key] = relax0(prob, valid_s, *a, **kw)
            return cache[key]

        jplanner.relax_candidates = cached
        try:
            out["capacity"] = _solver_cli(main, cfg, ["apply", "--solver", "--json"])
            out["resilience"] = _solver_cli(main, cfg, ["resilience", "--plan", "--faults", smoke.CAP_RESIL_SPEC,
                                                        "--seed", "0", "--solver", "--json"])
        finally:
            jplanner.relax_candidates = relax0
        out["resilience"]["relax_reused"] = len(cache) == 1
    if not only or "large" in only:
        cluster, apps, template = smoke.large_capacity_problem(synth, simtpu.AppResource, simtpu.ResourceTypes)
        cfg = smoke.write_capacity_config(f"{root}/large", cluster, apps, template)
        zero0 = jplanner._zero_extras
        jplanner._zero_extras = _zero_extras_pgd
        try:
            out["large_capacity"] = _solver_cli(main, cfg, ["apply", "--solver", "--json"])
        finally:
            jplanner._zero_extras = zero0
        out["large_capacity"]["zero_extras"] = "[P, GD], replaced at run time"
    out["iters"] = smoke.SOLVE_ITERS
    return out


#: the grow counters a grow record keeps
GROW_KEYS = ("grow.extends", "grow.bucket_promotions", "grow.node_extends", "grow.rebuilds")


def compute_grow_golden() -> dict:
    """The JAX package's grow run of the grow problem (`smoke.run_grow` on
    its serial `Engine` in grow mode) as a grow record (`smoke.GROW_GOLDEN`),
    its grow counts the registry's delta over the run."""
    import simtpu
    from simtpu.engine.scan import Engine
    from simtpu.obs.metrics import REGISTRY

    before = REGISTRY.snapshot()
    run = smoke.run_grow(simtpu, Engine)
    delta = REGISTRY.delta_since(before)
    return smoke.grow_record(run, {k: delta.get(k, 0) for k in GROW_KEYS})


def test_committed_grow_golden_is_whole():
    """The grow record chip_smoke.py phase 15 holds the port against: four
    waves of the serial smoke problem's pods, every final plane, and the
    growth through the buckets (extends, a promotion, one node growth, no
    rebuild)."""
    g = smoke.load_record(smoke.GROW_GOLDEN)
    assert [w["pods"] for w in g["waves"]] and sum(w["pods"] for w in g["waves"]) == smoke.N_PODS
    assert set(g["planes"]) == {"free", "cnt_match", "cnt_total", "cnt_own_anti", "cnt_own_aff",
                                "w_own_aff_pref", "w_own_anti_pref", "vg_free", "sdev_free", "gpu_free",
                                "ports_used", "vols_any", "vols_rw"}
    assert g["planes"]["free"]["shape"][0] == smoke.N_NODES + smoke.GROW_CLONES
    gr = g["grow"]
    assert gr["grow.extends"] == 3 and gr["grow.bucket_promotions"] >= 1
    assert gr["grow.node_extends"] == 1 and gr["grow.rebuilds"] == 0


def test_committed_solve_golden_is_whole():
    """The solver records chip_smoke.py phase 14 holds the port against:
    the capacity plan (the consult rejected at k=0 after the fallback, the
    exact search's 43 nodes), the large capacity plan (accepted), the
    resilience plan's lower bound, each with its relaxation over 100
    candidates at SOLVE_ITERS iterations."""
    g = smoke.load_record(smoke.SOLVE_GOLDEN)
    assert g["iters"] == smoke.SOLVE_ITERS
    for key in ("capacity", "large_capacity", "resilience"):
        rec = g[key]
        (rel,) = rec["solver"]["relax"]
        assert rel["s"] == len(rel["residual"]) == 100
    cap = g["capacity"]["doc"]
    assert cap["nodes_added"] == 43 and cap["engine"]["solve"]["status"] == "rejected"
    assert cap["engine"]["solve"]["fallback"] is True and "wall_s" not in cap["engine"]["solve"]
    lcap = g["large_capacity"]
    assert lcap["doc"]["engine"]["solve"]["status"] == "accepted" and lcap["plan"]["placed"] > 0
    assert g["resilience"]["relax_reused"] and g["resilience"]["doc"]["solve"]["mode"] == "lower_bound"
    for key in ("capacity", "large_capacity"):
        (rnd,) = g[key]["solver"]["round"]
        m = smoke.unpack_array(rnd["m"])
        assert m.sum() > 0 and rnd["m"]["sha256"]


@pytest.mark.slow
def test_grow_golden_matches_a_fresh_jax_run():
    assert compute_grow_golden() == smoke.load_record(smoke.GROW_GOLDEN)


if __name__ == "__main__" and "--write" in sys.argv and "--grow-only" in sys.argv:
    import time

    t0 = time.perf_counter()
    smoke.save_record(compute_grow_golden(), smoke.GROW_GOLDEN)
    print(f"wrote {smoke.GROW_GOLDEN} in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
if __name__ == "__main__" and "--write" in sys.argv and "--solve-only" in sys.argv:
    import tempfile
    import time

    t0 = time.perf_counter()
    only = [a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")]
    with tempfile.TemporaryDirectory() as root:
        part = compute_solve_golden(root, only)
    record = smoke.load_record(smoke.SOLVE_GOLDEN) if only and smoke.SOLVE_GOLDEN.exists() else {}
    record.update(part)
    smoke.save_record(record, smoke.SOLVE_GOLDEN)
    print(f"wrote {sorted(part)} into {smoke.SOLVE_GOLDEN} in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
if __name__ == "__main__" and "--write" in sys.argv and "--explain-only" in sys.argv:
    import tempfile
    import time

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        smoke.save_record(compute_explain_golden(root), smoke.EXPLAIN_GOLDEN)
    print(f"wrote {smoke.EXPLAIN_GOLDEN} in {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(0)
if __name__ == "__main__" and "--write" in sys.argv and "--faults-only" in sys.argv:
    _write_fault_goldens([a.split("=", 1)[1] for a in sys.argv if a.startswith("--only=")])
    sys.exit(0)
if __name__ == "__main__" and "--compact-carry" in sys.argv:
    print(compute_compact_carry())
if __name__ == "__main__" and "--write" in sys.argv and "--bulk-only" in sys.argv:
    smoke.save_record(compute_bulk_golden(), smoke.BULK_GOLDEN)
    smoke.save_record(compute_large_capacity_golden(), smoke.LCAP_GOLDEN)
    print("wrote", smoke.BULK_GOLDEN, smoke.LCAP_GOLDEN)
elif __name__ == "__main__" and "--write" in sys.argv:
    if "--capacity-only" not in sys.argv:
        smoke.save_record(compute_golden())
        smoke.save_record(compute_extended_golden(), smoke.EXT_GOLDEN)
    smoke.save_record(compute_capacity_golden(), smoke.CAP_GOLDEN)
    if "--capacity-only" not in sys.argv:
        import tempfile

        smoke.save_record(compute_bulk_golden(), smoke.BULK_GOLDEN)
        smoke.save_record(compute_large_capacity_golden(), smoke.LCAP_GOLDEN)
        with tempfile.TemporaryDirectory() as root:
            smoke.save_record(compute_explain_golden(root), smoke.EXPLAIN_GOLDEN)
    print("wrote", smoke.GOLDEN, smoke.EXT_GOLDEN, smoke.CAP_GOLDEN, smoke.BULK_GOLDEN, smoke.LCAP_GOLDEN,
          smoke.EXPLAIN_GOLDEN)
