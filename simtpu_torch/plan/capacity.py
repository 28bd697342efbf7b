"""Capacity planner: minimum node additions for a full deployment.

The port of the JAX package's `simtpu/plan/capacity.py` serial planner.
Mirrors `Applier.Run` (`pkg/apply/apply.go:88-245`): load apps + cluster +
new-node template, then find the smallest number of template-node clones that
lets every pod schedule, subject to the MaxCPU/MaxMemory/MaxVG average
utilization caps (`apply.go:580-666`), with "adding nodes can never help"
diagnostics (`apply.go:213-231` → `utils.NodeShouldRunPod`,
`utils.MeetResourceRequests`).

Search strategy: the reference walks i = 0,1,2,…,100 re-simulating from
scratch each time (`apply.go:183`, `MaxNumNewNode=100`). Feasibility is
monotone in the clone count (clones only add capacity), so the default here is
a doubling probe + binary search — O(log N) full simulations instead of O(N) —
with `search="linear"` available for reference-exact behavior.

Non-monotone caveat: SCHEDULABILITY is monotone, but the
MaxCPU/MaxMemory/MaxVG occupancy-cap verdict need not be — with DaemonSet
overhead, every clone adds `u` usage against `A` capacity, so the average
rate tends toward u/A and RISES with the clone count whenever it starts
below that ratio. The binary search therefore falls back LOUDLY to the
reference-exact linear scan the moment any probe is rejected by the caps
alone (everything scheduled, rate over the cap); probes already known
unschedulable are skipped in the fallback. With the caps at their default
100 the fallback can never trigger.

Every candidate is one `simulate(audit=True)` on the serial engine (the
speculative wavefront and the compact carry on), on the plan's device. The
auditor gates the winner: an audit-dirty winner is re-simulated with the
wavefront and the compact carry off —
never the engine config whose answer just failed its audit — and the
certified re-run ships with the divergence record. With `bulk=True` every
candidate runs the bulk rounds engine (`engine/rounds.py`); the incremental
search lives in `plan/incremental.py`. `Applier.run` auto-selects both for
large problems, as the JAX package does (`_resolve_engines`).
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .. import constants as C
from ..api import simulate
from ..config import SimonConfig, validate_config
from ..core.match import node_should_run_pod
from ..core.objects import (
    AppResource,
    ResourceTypes,
    SimulateResult,
    name_of,
    namespace_of,
    pod_requests,
    set_label,
)
from ..core.quantity import parse_quantity
from ..device import resolve_device
from ..engine import wavefront
from ..engine.scan import Engine
from ..engine.state import STATE_GAUGE, state_counts
from ..io.cluster import (
    create_cluster_resource_from_client,
    create_cluster_resource_from_cluster_config,
    match_and_set_local_storage_annotation_on_node,
)
from ..io.yaml_loader import get_objects_from_yaml_content, get_yaml_content_from_directory
from ..workloads.expand import make_valid_node_by_node, new_daemon_pod

#: what the port cannot run yet, named where it refuses
NOT_PORTED_SHARD = "node-axis sharding over a device mesh is not ported (ROADMAP queue 1 #10)"


@dataclass
class PlanResult:
    success: bool
    nodes_added: int
    result: Optional[SimulateResult]
    message: str = ""
    # per-candidate-count unscheduled totals, for transparency
    probes: Dict[int, int] = field(default_factory=dict)
    # per-phase wall-clock seconds (ingest, plan)
    timings: Dict[str, float] = field(default_factory=dict)
    # the engines that ran: search strategy, bulk placement, device, and
    # the audit record of the shipped candidate
    engine: Dict[str, object] = field(default_factory=dict)
    # the independent placement audit of the shipped candidate
    # (audit/checker.py): AuditReport.counters() plus — when the winner's
    # audit failed and the re-simulation shipped instead — "fallback":
    # true, the fallback's own counters and a "divergence" record.
    # {} = audit not run (audit=False)
    audit: Dict[str, object] = field(default_factory=dict)
    # one record per simulation the plan ran, in order: the clone count,
    # whether it was the fallback's re-run, its wall seconds, whether its
    # engine ran the speculative wavefront and, when audited, the audit's
    # wall and split (upload / bulk / host seconds)
    candidates: List[Dict[str, object]] = field(default_factory=list)
    # decision-observability block (explain/, `--explain`): the failure
    # breakdown + bottleneck analysis of the reported candidate's unplaced
    # pods; {} = not requested, or nothing unplaced. Carries the
    # "version" stamp (explain.EXPLAIN_VERSION) and rides --json as
    # "explain"
    explain: Dict[str, object] = field(default_factory=dict)
    # the global-solver backend's record (solve/): status, the candidate
    # the relaxation found, the certified lower bound, the reason it
    # stepped aside, and the fallback trail when its answer shipped.
    # {} = solver not consulted; rides --json under engine.solve
    solve: Dict[str, object] = field(default_factory=dict)


def new_fake_nodes(template: dict, count: int) -> List[dict]:
    """Clone the template node `count` times as simon-%02d with the new-node
    label (`pkg/apply/apply.go:286-303`)."""
    nodes = []
    for i in range(count):
        hostname = f"{C.NEW_NODE_NAME_PREFIX}-{i:02d}"
        node = make_valid_node_by_node(template, hostname)
        set_label(node, C.LABEL_NEW_NODE, "")
        nodes.append(node)
    return nodes


def _env_cap(name: str) -> int:
    """0-100 percentage cap from env; out-of-range falls back to 100
    (`apply.go:580-610`)."""
    raw = os.environ.get(name, "")
    if not raw:
        return 100
    val = int(raw)
    return 100 if (val > 100 or val < 0) else val


def satisfy_resource_setting(result: SimulateResult) -> (bool, str):
    """Average cluster occupancy caps MaxCPU/MaxMemory/MaxVG
    (`apply.go:580-666`)."""
    max_cpu = _env_cap(C.ENV_MAX_CPU)
    max_mem = _env_cap(C.ENV_MAX_MEMORY)
    max_vg = _env_cap(C.ENV_MAX_VG)

    total = {"cpu": 0.0, "memory": 0.0}
    used = {"cpu": 0.0, "memory": 0.0}
    vg_cap = vg_req = 0.0
    for status in result.node_status:
        alloc = ((status.node.get("status") or {}).get("allocatable")) or {}
        total["cpu"] += parse_quantity(alloc.get("cpu"))
        total["memory"] += parse_quantity(alloc.get("memory"))
        for pod in status.pods:
            req = pod_requests(pod)
            used["cpu"] += req.get("cpu", 0.0)
            used["memory"] += req.get("memory", 0.0)
        anno = (status.node.get("metadata") or {}).get("annotations") or {}
        raw = anno.get(C.ANNO_NODE_LOCAL_STORAGE)
        if raw:
            storage = json.loads(raw)
            for vg in storage.get("vgs") or []:
                vg_cap += parse_quantity(vg.get("capacity"))
                vg_req += parse_quantity(vg.get("requested"))

    cpu_rate = int(used["cpu"] / total["cpu"] * 100) if total["cpu"] else 0
    mem_rate = int(used["memory"] / total["memory"] * 100) if total["memory"] else 0
    if cpu_rate > max_cpu:
        return False, (
            f"the average occupancy rate({cpu_rate}%) of cpu goes beyond "
            f"the env setting({max_cpu}%)\n"
        )
    if mem_rate > max_mem:
        return False, (
            f"the average occupancy rate({mem_rate}%) of memory goes beyond "
            f"the env setting({max_mem}%)\n"
        )
    if vg_cap:
        vg_rate = int(vg_req / vg_cap * 100)
        if vg_rate > max_vg:
            return False, (
                f"the average occupancy rate({vg_rate}%) of vg goes beyond "
                f"the env setting({max_vg}%)\n"
            )
    return True, ""


def meet_resource_requests(
    node: dict, pod: dict, daemon_sets: Sequence[dict], corrected: bool = False
) -> bool:
    """Could the new-node template EVER hold this pod, once its daemonsets are
    accounted for? (`pkg/utils/utils.go:768-818`).

    Reference quirk preserved by default: the probe daemon pod is pinned to a
    node named `simon` (`utils.go:777` passes NewNodeNamePrefix as the node
    name), so unless the template node is literally named "simon" the
    matchFields pin fails NodeShouldRunPod and daemonset overhead contributes
    nothing — a DS-heavy cluster under-provisions exactly like the reference.
    `corrected=True` pins the probe pod to the template node's own name so
    the overhead is actually accounted.
    """
    probe_name = name_of(node) if corrected else C.NEW_NODE_NAME_PREFIX
    total_cpu = total_mem = 0.0
    for ds in daemon_sets:
        daemon_pod = new_daemon_pod(ds, probe_name)
        if node_should_run_pod(node, daemon_pod):
            req = pod_requests(daemon_pod)
            total_cpu += req.get("cpu", 0.0)
            total_mem += req.get("memory", 0.0)
    req = pod_requests(pod)
    total_cpu += req.get("cpu", 0.0)
    total_mem += req.get("memory", 0.0)
    alloc = ((node.get("status") or {}).get("allocatable")) or {}
    if total_cpu > parse_quantity(alloc.get("cpu")) or total_mem > parse_quantity(
        alloc.get("memory")
    ):
        return False
    # local storage: sum of LVM claims must fit the largest VG
    anno = (node.get("metadata") or {}).get("annotations") or {}
    raw = anno.get(C.ANNO_NODE_LOCAL_STORAGE)
    if not raw:
        return True
    storage = json.loads(raw)
    vg_max = max(
        [parse_quantity(vg.get("capacity")) for vg in storage.get("vgs") or []] or [0.0]
    )
    pod_anno = (pod.get("metadata") or {}).get("annotations") or {}
    pvc_raw = pod_anno.get(C.ANNO_POD_LOCAL_STORAGE)
    pvc_sum = 0.0
    if pvc_raw:
        for vol in (json.loads(pvc_raw) or {}).get("volumes") or []:
            if vol.get("kind") == "LVM":
                pvc_sum += parse_quantity(vol.get("size"))
    return pvc_sum <= vg_max


def _pod_at_a_time(tensorizer, device) -> Engine:
    """The audit fallback's engine: the per-pod kernels only, the wavefront
    off and the dense carry."""
    eng = Engine(tensorizer, device)
    eng.speculate = False
    eng.compact = False
    return eng


def plan_capacity(
    cluster: ResourceTypes,
    apps: Sequence[AppResource],
    new_node: dict,
    max_new_nodes: int = C.MAX_NUM_NEW_NODE,
    extended_resources: Sequence[str] = (),
    search: str = "binary",
    progress: Optional[Callable[[str], None]] = None,
    bulk: bool = False,
    sched_config=None,
    corrected_ds_overhead: bool = False,
    audit: Optional[bool] = None,
    device=None,
    _audit_inject: bool = False,
    explain: bool = False,
    solver: Optional[bool] = None,
) -> PlanResult:
    """Find the minimum clone count of `new_node` that deploys everything.

    `search` is "binary" (doubling probe, then bisection, with the linear
    walk when an occupancy cap rejects a candidate) or "linear" (the
    reference's walk). `audit` (None = on) runs the independent placement
    auditor inside every candidate simulation and gates the WINNER on its
    verdict: an audit-dirty winner is never shipped — the candidate
    re-simulates on the same serial engine with a clean audit, and the
    result carries the divergence record under `PlanResult.audit`.
    `_audit_inject` corrupts the audit's view of every primary candidate
    (never of the re-run), which drives that fallback end to end.

    Every simulation runs on `device` (None = the CUDA card); with
    `bulk=True` on the bulk rounds engine (the audit fallback stays on the
    pod-at-a-time engine). `search="incremental"` is
    `plan/incremental.py plan_capacity_incremental`.

    `explain` (off by default: the off path launches nothing more)
    attaches the decision-observability block (explain/) to the result:
    every candidate simulation computes the failure breakdown (K20) and
    bottleneck analysis of its unplaced pods, and the reported
    candidate's block rides `PlanResult.explain` — so an infeasible plan
    reports *what to buy* (binding resource, template-node hint), not just
    *how many*. Fully placed candidates pay nothing.

    `solver` (None = off) consults the global solve backend (solve/)
    FIRST: one relaxation over every candidate count (K22/K23) replaces
    the whole doubling + bisection when its rounded answer is
    audit-certified at a count whose predecessor carries an infeasibility
    proof. A rejected or uncertified solve falls through to the exact
    search below, warm-started with the solver's certified lower bound
    when one exists; the answer is then the solver-off run's."""
    if search not in ("binary", "linear"):
        raise ValueError(f"unknown search strategy {search!r}")
    device = resolve_device(device)
    say = progress or (lambda s: None)
    probes: Dict[int, int] = {}
    # -- global-solver consult (solve/): the solver proposes, the auditor
    # disposes. An accepted attempt IS the plan (no simulate() at all);
    # anything else warm-starts the exact search below
    solve_doc: Dict[str, object] = {}
    lb_hint = 0
    if solver:
        from ..solve import solve_capacity_plan

        plan_s, att = solve_capacity_plan(cluster, apps, new_node, max_new_nodes, extended_resources,
                                          progress=say, sched_config=sched_config, device=device,
                                          _audit_inject=_audit_inject)
        if plan_s is not None:
            return plan_s
        solve_doc = att.doc
        if att.certified and att.lower_bound > 0:
            lb_hint = min(att.lower_bound, max_new_nodes - 1)
            say(f"solver: certified lower bound {att.lower_bound} — warm-starting the exact search")
    candidates: List[Dict[str, object]] = []
    all_daemon_sets = list(cluster.daemon_sets)
    for app in apps:
        all_daemon_sets += app.resource.daemon_sets
    last_result: list = [None]  # most recent live SimulateResult
    audit_on = True if audit is None else bool(audit)
    # the template context folds the can-another-node-ever-help verdict
    # into the bottleneck block
    explain_opts = (
        {"new_node": new_node, "daemon_sets": all_daemon_sets, "corrected": corrected_ds_overhead}
        if explain
        else False
    )

    def with_explain(out: PlanResult, result) -> PlanResult:
        out.explain = getattr(result, "explain", None) or {}
        return out

    def run(i: int, serial_exact: bool = False) -> SimulateResult:
        say(f"add {i} node(s)")
        t0 = time.perf_counter()
        trial = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
        trial.nodes = list(cluster.nodes) + new_fake_nodes(new_node, i)
        # the divergence-safe fallback's engine: pod-at-a-time, the
        # wavefront off, the dense carry
        if serial_exact:
            factory = _pod_at_a_time
        elif bulk:
            from ..engine.rounds import RoundsEngine

            factory = RoundsEngine
        else:
            factory = Engine
        built: List[Engine] = []

        def build(tz, dev) -> Engine:
            built.append(factory(tz, dev))
            return built[-1]

        result = simulate(
            trial,
            apps,
            extended_resources=extended_resources,
            engine_factory=build,
            sched_config=sched_config,
            device=device,
            audit=audit_on or serial_exact,
            _audit_inject=audit_on and _audit_inject and not serial_exact,
            explain=explain_opts,
        )
        rec: Dict[str, object] = {
            "count": i, "fallback": serial_exact, "wall_s": time.perf_counter() - t0,
            "speculate": all(e.speculate for e in built),
            "compact": all(e.compact for e in built),
        }
        if result.audit is not None:
            rec["audit_wall_s"] = result.audit.wall_s
            rec["audit_split"] = dict(result.audit.split)
        candidates.append(rec)
        if serial_exact:
            return result
        probes[i] = len(result.unscheduled_pods)
        last_result[0] = result
        return result

    def diagnose(result: SimulateResult) -> Optional[str]:
        """Return a message when adding template nodes can never help
        (`apply.go:213-231`)."""
        for unsched in result.unscheduled_pods:
            pod = unsched.pod
            if not node_should_run_pod(new_node, pod):
                return (
                    f"failed to schedule pod {namespace_of(pod)}/{name_of(pod)}: "
                    "the pod cannot be scheduled successfully by adding node: "
                    "pod does not fit new node affinity or taints"
                )
            if not meet_resource_requests(
                new_node, pod, all_daemon_sets, corrected=corrected_ds_overhead
            ):
                return (
                    f"failed to schedule pod {namespace_of(pod)}/{name_of(pod)}: "
                    "new node cannot meet resource requests of pod: the total "
                    "requested resource of daemonset pods in new node is too large"
                )
        return None

    cap_rejected = False  # a probe scheduled everything but missed a cap

    def feasible(result: SimulateResult) -> Tuple[bool, str]:
        """Candidate acceptance = everything scheduled AND occupancy caps
        hold. The reference treats a cap miss like infeasibility
        (`apply.go:199-207`); a cap rejection is flagged and aborts the
        O(log N) search in favor of the reference's linear walk."""
        nonlocal cap_rejected
        if result.unscheduled_pods:
            return False, ""
        ok, reason = satisfy_resource_setting(result)
        if not ok:
            cap_rejected = True
            say(reason.rstrip("\n"))
        return ok, reason

    def evaluate(i: int):
        """(feasible, unscheduled, diagnosis, result) for candidate i."""
        result = run(i)
        ok, _ = feasible(result)
        msg = diagnose(result) if result.unscheduled_pods else None
        return ok, probes[i], msg, result

    def final_success(i: int, result) -> PlanResult:
        out = with_explain(PlanResult(True, i, result, "Success!", probes), result)
        rep = result.audit
        if not audit_on or rep is None:
            return out
        out.audit = rep.counters()
        if rep.ok:
            return out
        # divergence-safe fallback: the winner's audit failed — do NOT
        # ship it; re-simulate with a clean audit and ship that
        say(
            f"audit FAILED on the winning candidate ({rep.summary()}) — "
            "re-simulating through the serial exact engines"
        )
        fb = run(i, serial_exact=True)
        rep_f = fb.audit
        audit_doc = {
            **rep.counters(),
            "fallback": True,
            "fallback_audit": rep_f.counters(),
            "divergence": _result_divergence(result, fb, rep),
        }
        if not rep_f.ok or fb.unscheduled_pods:
            out = with_explain(PlanResult(
                False, i, fb,
                "audit failure: the winning candidate violates its claimed "
                "constraints and the serial-exact fallback did not certify "
                f"either ({rep_f.summary()})",
                probes,
            ), fb)
            out.audit = audit_doc
            return out
        audit_doc["ok"] = True
        out.result = fb
        out.explain = getattr(fb, "explain", None) or {}
        out.audit = audit_doc
        return out

    def _result_divergence(primary, fallback, report) -> Dict[str, object]:
        """Divergence record for two SimulateResults: per-node pod counts
        (pod-name suffixes differ between the two simulations)."""

        def by_node(res):
            return {name_of(s.node): len(s.pods) for s in res.node_status}

        pa, fb = by_node(primary), by_node(fallback)
        changed = sorted(n for n in pa if pa.get(n) != fb.get(n))
        return {
            "violations": dict(report.by_class),
            "nodes_changed": len(changed),
            "first_changed_node": changed[0] if changed else "",
        }

    fail_msg = f"we have added {max_new_nodes} nodes but it still failed!!"

    def linear_from(start: int) -> PlanResult:
        """The reference-exact linear walk over [start, max_new_nodes);
        candidates already probed and found UNSCHEDULABLE are skipped
        (schedulability is monotone), cap-rejected ones re-run."""
        for i in range(start, max_new_nodes):
            if i in probes and probes[i] > 0:
                continue  # known unschedulable
            ok, unsched, msg, result = evaluate(i)
            if ok:
                return final_success(i, result)
            if unsched and msg:
                return with_explain(PlanResult(False, i, result, msg, probes), result)
        return with_explain(PlanResult(False, max_new_nodes, last_result[0], fail_msg, probes),
                            last_result[0])

    def cap_fallback() -> PlanResult:
        """A cap rejection makes feasibility potentially non-monotone —
        bisection could skip the window the reference's walk would find.
        Fall back loudly to the linear scan."""
        msg = (
            "simtpu: an occupancy cap rejected a fully-scheduled "
            "candidate; cap feasibility can be non-monotone in the "
            "clone count (DaemonSet overhead) — falling back to the "
            "reference's linear scan"
        )
        print(msg, file=sys.stderr)
        say(msg)
        return linear_from(1)

    def search_candidates() -> PlanResult:
        if lb_hint < 1:
            ok, unsched, msg, result = evaluate(0)
            if ok:
                return final_success(0, result)
            if unsched and msg:
                return with_explain(PlanResult(False, 0, result, msg, probes), result)
        # else: the solver PROVED candidate 0 (and everything below
        # lb_hint) infeasible — skip straight to the bound

        # the reference's loop is `for i := 0; i < MaxNumNewNode; i++`
        # (apply.go:183) — the largest candidate ever tried is
        # max_new_nodes-1
        if search == "linear":
            return linear_from(max(1, lb_hint))
        # doubling probe then binary search (feasibility monotone in
        # clone count); a certified solver lower bound starts the doubling
        # at the bound instead of 1
        hi, hi_result = None, None
        probe = max(1, lb_hint)
        while probe < max_new_nodes:
            ok, unsched, msg, result = evaluate(probe)
            if cap_rejected:
                return cap_fallback()
            if ok:
                hi, hi_result = probe, result
                break
            if unsched and msg:
                return with_explain(PlanResult(False, probe, result, msg, probes), result)
            probe *= 2
        if hi is None:
            probe = max_new_nodes - 1
            if probe in probes:  # already tried as the last doubling step
                return with_explain(PlanResult(False, max_new_nodes, last_result[0], fail_msg, probes),
                                    last_result[0])
            ok, unsched, msg, result = evaluate(probe)
            if cap_rejected:
                return cap_fallback()
            if not ok:
                return with_explain(PlanResult(False, max_new_nodes, result, fail_msg, probes), result)
            hi, hi_result = probe, result
        # lowest infeasible known is hi//2 (probed by the doubling, or 0)
        # — unless the solver certified everything below lb_hint
        lo = max(hi // 2, lb_hint - 1)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            ok, _, _, result = evaluate(mid)
            if cap_rejected:
                return cap_fallback()
            if ok:
                hi, hi_result = mid, result
            else:
                lo = mid
        return final_success(hi, hi_result)

    out = search_candidates()
    out.candidates = candidates
    # a rejected/uncertified solver consult still rides the result —
    # --json consumers see WHY the exact search answered
    if solve_doc and not out.solve:
        out.solve = dict(solve_doc)
    return out


@dataclass
class ApplierOptions:
    """CLI options (`pkg/apply/apply.go:32-38`), cut to what the port's
    planner honours. `search` / `bulk` default to None = scale-aware auto:
    the serial scan + binary search below the size thresholds, the bulk
    rounds engine + the incremental planner above them
    (`_resolve_engines`)."""

    simon_config: str = ""
    default_scheduler_config: str = ""
    # reference-parity no-op: accepted, never wired to the scheduler (as in
    # the reference and the JAX package)
    use_greed: bool = False
    interactive: bool = False
    extended_resources: Sequence[str] = ()
    search: Optional[str] = None  # None = auto; binary | linear | incremental
    bulk: Optional[bool] = None  # None = auto; place replica runs in bulk rounds
    # DaemonSet overhead in the can-never-help diagnosis: the reference's
    # sum (False) or the corrected per-node overhead (True)
    corrected_ds_overhead: bool = False
    # node-axis sharding of the incremental plan: None = auto (one card:
    # never), True = required (not ported), False = off
    shard: Optional[bool] = None
    # None = on: audit the accepted candidate and fall back on failure;
    # False = --no-audit
    audit: Optional[bool] = None
    # the device every simulation runs on (None = the CUDA card)
    device: Optional[str] = None
    # decision observability (explain/, --explain): attach failure
    # breakdowns + bottleneck analysis to a failing plan; off = no explain
    # import, no extra launch
    explain: bool = False
    # None/False = off: consult the global solve backend (solve/) before
    # the exact search — advisory mode, the auditor gates everything it
    # proposes; --solver turns it on, --no-solver off
    solver: Optional[bool] = None


# Auto-engine thresholds: below both, the serial scan keeps its per-pod
# reference-exact tie-breaks; above either, the bulk rounds engine and the
# incremental planner take over, as in the JAX package.  Declared pods,
# not expanded: the estimate runs before workload expansion.
AUTO_ENGINE_NODES = 1024
AUTO_ENGINE_PODS = 16384


def _declared_pod_estimate(cluster: ResourceTypes, apps: Sequence[AppResource]) -> int:
    """Cheap upper-ish estimate of the expanded pod count: declared replica
    counts plus one DaemonSet pod per node, without running expansion."""

    def one(res: ResourceTypes, n_nodes: int) -> int:
        total = len(res.pods)
        for w in res.deployments + res.replica_sets + res.replication_controllers + res.stateful_sets:
            spec = w.get("spec") or {}
            total += int(spec.get("replicas") or 1)
        for j in res.jobs:
            spec = j.get("spec") or {}
            total += int(spec.get("completions") or spec.get("parallelism") or 1)
        for cj in res.cron_jobs:
            total += 1
        total += len(res.daemon_sets) * n_nodes
        return total

    n = len(cluster.nodes)
    return one(cluster, n) + sum(one(a.resource, n) for a in apps)


def _resolve_engines(
    opts: ApplierOptions,
    cluster: ResourceTypes,
    apps: Sequence[AppResource],
) -> Tuple[str, bool, None]:
    """Fill in auto (None) search/bulk choices from the problem size and say
    so on stderr, as the JAX package does. Returns (search, bulk, mesh);
    with one card the mesh is always None, and `shard=True` raises
    NotImplementedError."""
    n_nodes = len(cluster.nodes)
    est_pods = _declared_pod_estimate(cluster, apps)
    large = n_nodes >= AUTO_ENGINE_NODES or est_pods >= AUTO_ENGINE_PODS
    search = opts.search if opts.search is not None else ("incremental" if large else "binary")
    bulk = opts.bulk if opts.bulk is not None else large
    if large and (opts.search is None or opts.bulk is None):
        print(
            f"simtpu: large problem ({n_nodes} nodes, ~{est_pods} declared "
            f"pods) — auto-selected {'bulk' if bulk else 'serial'} placement"
            f" + {search} search; pass --search binary/linear or --no-bulk "
            "for the serial reference-exact engines",
            file=sys.stderr,
        )
    if opts.shard is True:
        raise NotImplementedError(NOT_PORTED_SHARD)
    return search, bulk, None


class Applier:
    """End-to-end capacity-planning run (`pkg/apply/apply.go:55-245`)."""

    def __init__(self, opts: ApplierOptions):
        self.opts = opts
        self.config = SimonConfig.from_file(opts.simon_config)
        validate_config(self.config, opts.default_scheduler_config)

    def load_apps(self) -> List[AppResource]:
        apps = []
        for info in self.config.app_list:
            if info.chart:
                from .. import chart as chart_mod

                content = chart_mod.process_chart(info.name, info.path)
            else:
                content = get_yaml_content_from_directory(info.path)
            apps.append(
                AppResource(name=info.name, resource=get_objects_from_yaml_content(content))
            )
        return apps

    def load_cluster(self) -> ResourceTypes:
        if self.config.cluster.kube_config:
            return create_cluster_resource_from_client(self.config.cluster.kube_config)
        return create_cluster_resource_from_cluster_config(self.config.cluster.custom_config)

    def _sched_config(self):
        """Parse --default-scheduler-config when given
        (`pkg/simulator/utils.go:281` loads the file the same way)."""
        if not self.opts.default_scheduler_config:
            return None
        from ..schedconfig import SchedulerConfig

        return SchedulerConfig.from_file(self.opts.default_scheduler_config)

    def load_new_node(self) -> dict:
        content = get_yaml_content_from_directory(self.config.new_node)
        resources = get_objects_from_yaml_content(content)
        if not resources.nodes:
            raise ValueError(f"the new node directory({self.config.new_node}) has no nodes")
        match_and_set_local_storage_annotation_on_node(resources.nodes, self.config.new_node)
        return resources.nodes[0]

    def run(
        self,
        select_apps: Optional[Callable[[List[str]], List[str]]] = None,
        progress: Optional[Callable[[str], None]] = None,
    ) -> PlanResult:
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        apps = self.load_apps()
        if select_apps is not None:
            # human think-time must not count toward the ingest phase
            timings["ingest"] = time.perf_counter() - t0
            chosen = set(select_apps([a.name for a in apps]))
            apps = [a for a in apps if a.name in chosen]
            t0 = time.perf_counter()
        cluster = self.load_cluster()
        new_node = self.load_new_node()
        timings["ingest"] = timings.get("ingest", 0.0) + time.perf_counter() - t0

        search, bulk, _ = _resolve_engines(self.opts, cluster, apps)
        device = resolve_device(self.opts.device)
        t0 = time.perf_counter()
        waves0 = wavefront.wave_counts()
        counts0 = state_counts()
        if search == "incremental":
            from .incremental import plan_capacity_incremental

            plan = plan_capacity_incremental(
                cluster,
                apps,
                new_node,
                extended_resources=self.opts.extended_resources,
                progress=progress,
                sched_config=self._sched_config(),
                corrected_ds_overhead=self.opts.corrected_ds_overhead,
                audit=self.opts.audit,
                device=device,
                explain=self.opts.explain,
                solver=self.opts.solver,
            )
        else:
            plan = plan_capacity(
                cluster,
                apps,
                new_node,
                extended_resources=self.opts.extended_resources,
                search=search,
                progress=progress,
                bulk=bulk,
                sched_config=self._sched_config(),
                corrected_ds_overhead=self.opts.corrected_ds_overhead,
                audit=self.opts.audit,
                device=device,
                explain=self.opts.explain,
                solver=self.opts.solver,
            )
        timings["plan"] = time.perf_counter() - t0
        # the incremental planner's phase breakdown rides beside the
        # ingest / plan walls
        plan.timings = {**plan.timings, **timings}
        speculated = all(c["speculate"] for c in plan.candidates)
        counts = state_counts()
        plan.engine = {
            "search": search,
            "bulk": bool(bulk) if search != "incremental" else True,
            "shards": 0,
            "auto_search": self.opts.search is None,
            "auto_bulk": self.opts.bulk is None,
            "reference_exact": search == "linear" and not bulk,
            "device": device.type,
            # the speculative wavefront over this plan's simulations, as
            # their engines ran it (False once the audit fallback re-ran a
            # candidate with it off; heavy runs are drafted whenever it is
            # on): placements are equal either way, so this is
            # observability — acceptance rate and rollback volume
            "speculate": speculated,
            "wave_heavy": speculated,
            "wavefront": {k: v - waves0[k] for k, v in wavefront.wave_counts().items()},
            # the carried state: `compact` is what the final carry was (not
            # the engines' switch, which a problem with no tabular key
            # overrides); the compact-carry counts over this plan; the
            # final carry's bytes beside the dense layout's
            "compact": STATE_GAUGE["compact"],
            "delta_direct": {
                "applied": counts["delta_direct"] - counts0["delta_direct"],
                "expand": counts["expand"] - counts0["expand"],
                "compress": counts["compress"] - counts0["compress"],
            },
            "state_bytes": {
                "carried_bytes": STATE_GAUGE["carried_bytes"],
                "dense_bytes": STATE_GAUGE["dense_bytes"],
                "planes": dict(STATE_GAUGE["planes"]),
            },
            # the independent placement audit of the shipped candidate:
            # counters, plus fallback/divergence records when the primary
            # answer failed certification; {"enabled": False} = --no-audit
            "audit": plan.audit if plan.audit else {"enabled": False},
            # the global-solver backend's record (solve/): which engine
            # ANSWERED — an accepted status means the relaxation produced
            # the shipped plan; rejected/ineligible means the exact search
            # did (with the solver's certified lower bound when one
            # existed). {"enabled": False} = solver not consulted
            "solve": plan.solve if plan.solve else {"enabled": False},
            # the incremental planner's probes never run preemption; True
            # when this plan's specs carried priorities that were ignored
            "preemption_ignored": bool(getattr(plan, "preemption_ignored", False)),
        }
        return plan
