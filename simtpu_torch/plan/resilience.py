"""N+k survivability planning: the smallest cluster that still fits after
k failures.

The port of the JAX package's `simtpu/plan/resilience.py`. `plan_capacity`
answers "min template clones so everything fits" (`pkg/apply/apply.go:
183-233` semantics); capacity reviews ask the harder question — "min
clones so everything STILL fits after any (or a p-quantile of) k-node
outages". This module wraps the fault subsystem (simtpu_torch/faults) in
the same search scaffolding as `plan/capacity.py`:

- ONE tensorization of base + max clones
  (`parallel.sweep.assemble_planning_problem`), candidate membership via
  `node_valid` masks — the incremental planner's lever;
- per candidate i: one bulk base placement (`MaskedRoundsEngine`), then
  one batched fault sweep (`faults.sweep.sweep_scenarios`: K18 and K19
  once per chunk) over scenarios generated on candidate i's live nodes
  (failures may hit clones too — an added node is as mortal as a base
  node);
- a candidate is FEASIBLE when the base placement strands nothing and at
  least `quantile` of its scenarios fully re-place after drain + requeue;
- doubling probe + bisection over the candidate count (`search="binary"`,
  the default), with `search="linear"` for the reference-shaped upward
  walk.

Monotonicity caveat (the same assumption `plan_capacity` documents for
schedulability): with SAMPLED scenario sets (k >= 2 on large clusters)
each candidate is judged on its own deterministic sample (seed `seed +
candidate`), so bisection can in principle disagree with the linear walk
near the boundary by sampling noise.

Preemption does not run inside the sweep (the capacity-planning
contract); `faults.drain_simulator` is the eviction-semantics path.

With `explain` a failed search carries the decision-observability block
(explain/) of its last failing candidate; `solver` floors the search with
the solve backend's certified no-failure lower bound. Not ported:
`checkpoint` and `control` (ROADMAP queue 1 #8), `mesh` and `pipeline`
(#10) raise NotImplementedError; the JAX package's shared bulk-shape registry has no
counterpart here (the port compiles no shapes).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from .. import constants as C
from ..core.objects import AppResource, ResourceTypes
from ..device import resolve_device
from ..faults.drain import PlacedCluster
from ..faults.scenarios import generate_scenarios, parse_fault_spec
from ..faults.sweep import SweepResult, sweep_scenarios
from .incremental import MaskedRoundsEngine


@dataclass
class ResiliencePlan:
    """Outcome of one `plan_resilience` search."""

    success: bool
    nodes_added: int
    k: int
    quantile: float
    message: str = ""
    #: per-candidate {"scenarios": S, "survived": n, "base_unplaced": m}
    probes: Dict[int, Dict[str, int]] = field(default_factory=dict)
    #: the winning candidate's sweep (None when the search failed)
    sweep: Optional[SweepResult] = None
    timings: Dict[str, float] = field(default_factory=dict)
    #: independent placement audit of the winning candidate's base
    #: placement (audit/checker.py): AuditReport.counters(), plus fallback/
    #: divergence records when the bulk engine's answer failed its audit
    #: and the serial-exact fallback shipped instead.  {} = not audited
    audit: Dict[str, object] = field(default_factory=dict)
    #: decision-observability block (explain/, `--explain`): for a failed
    #: search, the last failing candidate's failure breakdown (base
    #: placement strands) or the worst scenario's binding-constraint
    #: bottleneck — *what to buy*, not just *how many*. {} = not requested
    explain: Dict[str, object] = field(default_factory=dict)
    #: the global-solver backend's relax-only lower-bound record
    #: (solve/ `solve_lower_bound`): the no-failure LP bound the doubling
    #: started from. {} = solver not consulted
    solve: Dict[str, object] = field(default_factory=dict)

    def counters(self) -> Dict[str, object]:
        """Machine-readable summary (CLI --json, bench)."""
        out = {
            "success": self.success,
            "nodes_added": self.nodes_added,
            "k": self.k,
            "quantile": self.quantile,
            "candidates_probed": len(self.probes),
            "plan_resilience_s": round(self.timings.get("total_s", 0.0), 2),
        }
        if self.audit:
            out["audit"] = dict(self.audit)
        if self.explain:
            out["explain"] = dict(self.explain)
        if self.solve:
            out["solve"] = dict(self.solve)
        if self.sweep is not None:
            out.update(self.sweep.counters())
        return out


def _diagnose_doomed(
    sweep: SweepResult, batch, new_node: dict, all_ds, corrected: bool
):
    """Scenarios no clone count can rescue: a stranded pod that cannot EVER
    run on the template (`apply.go:213-231` semantics — affinity/taints or
    template capacity net of DaemonSet overhead).  Returns (doomed scenario
    count, message for the first doomed pod)."""
    from ..core.match import node_should_run_pod
    from ..core.objects import name_of, namespace_of
    from .capacity import meet_resource_requests

    doomed, msg = 0, None
    for s in np.flatnonzero(~sweep.survived):
        rows = sweep.requeue_rows[s]
        stranded = rows[(rows >= 0) & (sweep.requeue_nodes[s] < 0)]
        for j in stranded[:16]:  # a handful decides the scenario
            pod = batch.pods[int(j)]
            why = None
            if not node_should_run_pod(new_node, pod):
                why = (
                    "the pod cannot be scheduled successfully by adding "
                    "node: pod does not fit new node affinity or taints"
                )
            elif not meet_resource_requests(
                new_node, pod, all_ds, corrected=corrected
            ):
                why = (
                    "new node cannot meet resource requests of pod: the "
                    "total requested resource of daemonset pods in new "
                    "node is too large"
                )
            if why is not None:
                doomed += 1
                if msg is None:
                    msg = (
                        f"scenario {sweep.scenarios.labels[int(s)]!r} cannot "
                        f"be survived by adding nodes: pod "
                        f"{namespace_of(pod)}/{name_of(pod)}: {why}"
                    )
                break
    return doomed, msg


def plan_resilience(
    cluster: ResourceTypes,
    apps: Sequence[AppResource] = (),
    new_node: Optional[dict] = None,
    k: int = 1,
    quantile: float = 1.0,
    spec: Optional[str] = None,
    samples: int = 256,
    seed: int = 0,
    max_new_nodes: int = C.MAX_NUM_NEW_NODE,
    extended_resources: Sequence[str] = (),
    search: str = "binary",
    progress=None,
    sched_config=None,
    mesh=None,
    pipeline=None,
    s_chunk: Optional[int] = None,
    corrected_ds_overhead: bool = False,
    checkpoint=None,
    control=None,
    audit: Optional[bool] = None,
    explain: bool = False,
    solver: Optional[bool] = None,
    device=None,
    _audit_inject: bool = False,
) -> ResiliencePlan:
    """Minimum clone count of `new_node` whose cluster still fully places
    every workload under the failure model.

    The failure model is `spec` (a `faults.parse_fault_spec` string) when
    given, else ``k=<k>`` — sampled/exhaustive k-node outages. A candidate
    passes when its base placement strands nothing AND the surviving
    fraction of its scenario sweep is >= `quantile` (1.0 = every scenario).
    `new_node=None` assesses only the as-is cluster (candidate 0) and
    reports success/failure without searching.

    `audit` (None = on) certifies the WINNING candidate's base placement
    through the independent auditor (audit/checker.py). An audit-dirty
    winner is never shipped: the base placement re-runs through the serial
    exact engine, re-audits, and the sweep re-runs over the certified
    placement, with the divergence record under `ResiliencePlan.audit`.
    `_audit_inject` corrupts the audit's view of the primary placement
    (never the fallback's), which drives that path end to end. Every
    placement and sweep runs on `device` (None = the CUDA card).

    `explain` attaches, to a failed search, the last failing candidate's
    failure breakdown (K20) + bottleneck when its base placement stranded
    pods, or the worst scenario's bottleneck over its stranded set when a
    sweep failed.

    `solver` (None = off) consults the solve backend's relax-only lower
    bound (solve/ `solve_lower_bound`, K22/K23): the no-failure fit is
    necessary for survivability — failures only remove capacity — so a
    certified LP infeasibility proof at count j rules out every candidate
    <= j, and the doubling starts at the bound instead of 1."""
    for name, on, item in (("checkpoint", checkpoint is not None, 8), ("control", control is not None, 8),
                           ("mesh", mesh is not None, 10), ("pipeline", pipeline is not None, 10)):
        if on:
            raise NotImplementedError(f"plan_resilience({name}=...) is not ported (ROADMAP queue 1 #{item})")
    from ..engine.scan import statics_from
    from ..parallel.sweep import assemble_planning_problem

    device = resolve_device(device)
    say = progress or (lambda s: None)
    t_start = time.perf_counter()
    timings: Dict[str, float] = {}
    fault_spec = spec if spec is not None else f"k={k}"
    # the reported k is the largest failure size the spec names (domain
    # outages fail whole label domains; their size is scenario-dependent)
    k = max(
        [t["k"] for t in parse_fault_spec(fault_spec) if t["kind"] == "k"],
        default=k,
    )
    max_new = max(max_new_nodes - 1, 0) if new_node is not None else 0
    template = new_node if new_node is not None else cluster.nodes[0]
    t0 = time.perf_counter()
    tz, all_nodes, n_base, ordered = assemble_planning_problem(
        cluster, apps, template, max_new, extended_resources
    )
    batch = tz.add_pods(ordered)
    tensors = tz.freeze()
    statics_from(tensors, sched_config, device)  # move the device statics once
    pin = np.asarray(batch.pin)
    clone_of = pin - n_base  # >= 0 for clone-pinned (DaemonSet) pods
    timings["tensorize"] = time.perf_counter() - t0

    # relax-only solver consult: a certified no-failure LP bound floors
    # the candidate search (survivability requires the base fit)
    solve_doc: Dict[str, object] = {}
    lb_solve = 0
    if solver and new_node is not None and max_new > 0:
        from ..solve import solve_lower_bound

        t_s = time.perf_counter()
        lb_solve, solve_doc = solve_lower_bound(tensors, batch, n_base, len(all_nodes), max_new,
                                                device=device)
        solve_doc["wall_s"] = round(time.perf_counter() - t_s, 4)
        lb_solve = min(lb_solve, max_new)
        if lb_solve > 0:
            say(f"solver: certified no-failure lower bound {lb_solve} — starting the candidate search there")

    probes: Dict[int, Dict[str, int]] = {}
    sweeps: Dict[int, SweepResult] = {}
    all_ds = list(cluster.daemon_sets)
    for app in apps:
        all_ds += app.resource.daemon_sets

    class _Doomed(Exception):
        """A failure scenario no clone count can rescue forces the
        quantile unreachable — abort the search with the diagnosis."""

    def valid_mask(i: int) -> np.ndarray:
        m = np.ones(len(all_nodes), bool)
        m[n_base + i:] = False
        return m

    # artifacts of the lowest surviving candidate's live base placement —
    # what the winner audit certifies (one slot: worse candidates are
    # dropped)
    best_run: Dict[str, object] = {}
    # the last candidate a probe found FAILING — what a failed search's
    # explain block describes
    last_fail: Dict[str, object] = {}
    audit_on = True if audit is None else bool(audit)

    def probe(i: int) -> bool:
        """Base placement + fault sweep for candidate i; True = survives."""
        say(f"resilience probe: {i} node(s) added, faults={fault_spec}")
        valid = valid_mask(i)
        eng = MaskedRoundsEngine(tz, device, valid)
        eng.sched_config = sched_config
        nodes, reasons, extras = eng.place(batch)
        nodes = np.asarray(nodes)
        phantom = clone_of >= i
        base_unplaced = int(((nodes < 0) & ~phantom).sum())
        rec = {"scenarios": 0, "survived": 0, "base_unplaced": base_unplaced}
        probes[i] = rec
        if base_unplaced:
            if explain:
                # retained ONLY under explain: the engine keeps its carried
                # device state alive for the rest of the search
                last_fail.update(i=i, eng=eng, nodes=nodes, reasons=np.asarray(reasons))
            return False
        pc = PlacedCluster(
            tz=tz, tensors=tensors, batch=batch, engine=eng,
            nodes=nodes, reasons=np.asarray(reasons),
        )
        scen = generate_scenarios(
            all_nodes, fault_spec, samples=samples, seed=seed + i, valid=valid
        )
        sweep = sweep_scenarios(pc, scen, s_chunk=s_chunk)
        sweeps[i] = sweep
        rec["scenarios"] = len(scen)
        rec["survived"] = int(sweep.survived.sum())
        ok = sweep.survival_rate >= quantile - 1e-12
        if not ok and new_node is not None:
            doomed, msg = _diagnose_doomed(
                sweep, batch, new_node, all_ds, corrected_ds_overhead
            )
            if doomed and (len(scen) - doomed) / len(scen) < quantile - 1e-12:
                raise _Doomed(msg)
        if not ok and explain:
            last_fail.update(i=i, eng=eng, nodes=nodes, reasons=np.asarray(reasons))
        if ok and (not best_run or i <= best_run["i"]):
            best_run.update(
                i=i, eng=eng, nodes=nodes, reasons=np.asarray(reasons),
                extras=extras,
            )
        return ok

    def _audit_winner(i: int):
        """Certify the winning candidate's base placement; on failure
        re-place through the serial exact engine, re-audit, and re-sweep
        over the certified placement (the divergence-safe fallback).
        Returns (audit_doc, hard_failure_message_or_None)."""
        from ..audit.checker import audit_placement, divergence_diagnostic, inject_divergence
        from ..engine.scan import Engine
        from ..engine.state import build_state, diff_state_planes

        eng = best_run["eng"]
        nodes = np.asarray(best_run["nodes"])
        phantom = clone_of >= i
        valid = valid_mask(i)
        nodes_aud = inject_divergence(tensors, batch, nodes) if _audit_inject else nodes
        rep = audit_placement(
            tensors, batch, nodes_aud, best_run["extras"],
            node_valid=valid, require_all=True, expect_mask=~phantom, device=device,
        )
        if rep.ok:
            return rep.counters(), None
        say(
            f"audit FAILED on the winning candidate ({rep.summary()}) — "
            "re-placing through the serial exact scan"
        )
        fb = Engine(tz, device)
        fb.node_valid = valid
        fb.speculate = False
        fb.compact = False
        fb.sched_config = sched_config
        nodes_f, reasons_f, extras_f = fb.place(batch)
        nodes_f = np.asarray(nodes_f)
        rep_f = audit_placement(
            tensors, batch, nodes_f, extras_f,
            node_valid=valid, require_all=True, expect_mask=~phantom, device=device,
        )
        r = tensors.alloc.shape[1]

        def dense(e):
            return build_state(
                tensors,
                np.asarray(e.placed_group, np.int32),
                np.asarray(e.placed_node, np.int32),
                e.log_req_matrix(r),
                e.ext_log,
                device,
            )

        audit_doc = {
            **rep.counters(),
            "fallback": True,
            "fallback_audit": rep_f.counters(),
            "divergence": divergence_diagnostic(
                tensors, batch, nodes_aud, nodes_f, rep,
                planes=diff_state_planes(dense(eng), dense(fb)),
            ),
        }
        if not rep_f.ok:
            return audit_doc, (
                "audit failure: the winning candidate violates its claimed "
                "constraints and the serial-exact fallback did not certify "
                f"either ({rep_f.summary()})"
            )
        # certified fallback placement: the survivability verdict must
        # describe IT, so the winner's sweep re-runs over it
        audit_doc["ok"] = True
        pc = PlacedCluster(
            tz=tz, tensors=tensors, batch=batch, engine=fb,
            nodes=nodes_f, reasons=np.asarray(reasons_f),
        )
        scen = generate_scenarios(
            all_nodes, fault_spec, samples=samples, seed=seed + i, valid=valid
        )
        sweeps[i] = sweep_scenarios(pc, scen, s_chunk=s_chunk)
        rec = probes.get(i) or {}
        rec["survived"] = int(sweeps[i].survived.sum())
        if sweeps[i].survival_rate < quantile - 1e-12:
            return audit_doc, (
                "audit fallback: the serial-exact placement does not "
                "survive the failure model "
                f"({rec['survived']}/{len(scen)} scenarios place fully)"
            )
        return audit_doc, None

    def finish(i: int) -> ResiliencePlan:
        # i is the lowest candidate that survived, so best_run holds its
        # live placement and sweeps its sweep
        audit_doc: Dict[str, object] = {}
        if audit_on:
            audit_doc, hard_fail = _audit_winner(i)
            if hard_fail is not None:
                timings["total_s"] = time.perf_counter() - t_start
                out = ResiliencePlan(
                    False, i, k, quantile, hard_fail,
                    probes=probes, sweep=sweeps.get(i), timings=timings,
                )
                out.audit = audit_doc
                out.solve = solve_doc
                return out
        timings["total_s"] = time.perf_counter() - t_start
        out = ResiliencePlan(
            True, i, k, quantile, "Success!",
            probes=probes, sweep=sweeps.get(i), timings=timings,
        )
        out.audit = audit_doc
        out.solve = solve_doc
        return out

    def mk_explain() -> Dict[str, object]:
        """The failed search's decision-observability block (explain/):
        when the last failing candidate's BASE placement stranded pods, the
        full per-stage breakdown + bottleneck; when its base placed clean
        but a scenario sweep failed, the worst scenario's binding-constraint
        bottleneck over its stranded set (free capacity = the drained
        surviving cluster)."""
        if not explain or not last_fail:
            return {}
        from ..explain import EXPLAIN_VERSION, bottleneck_analysis, build_explain_doc

        i = int(last_fail["i"])
        eng = last_fail["eng"]
        nodes = np.asarray(last_fail["nodes"])
        reasons_a = np.asarray(last_fail["reasons"])
        valid = valid_mask(i)
        phantom = clone_of >= i
        doc: Dict[str, object] = {"version": EXPLAIN_VERSION}
        unp = np.flatnonzero((nodes < 0) & ~phantom)
        if len(unp):
            try:
                state = eng.carried_state()
            except ValueError:
                state = None
            return build_explain_doc(
                tensors, batch, unp, state, nodes, reasons_a,
                node_valid=valid, sched_config=sched_config,
                new_node=new_node, daemon_sets=all_ds,
                corrected_ds_overhead=corrected_ds_overhead,
            )
        sweep = sweeps.get(i)
        if sweep is None:
            return doc
        s_idx = int(np.argmax(sweep.unplaced))
        rows_s = np.asarray(sweep.requeue_rows[s_idx])
        nodes_s = np.asarray(sweep.requeue_nodes[s_idx])
        reasons_s = np.asarray(sweep.requeue_reasons[s_idx])
        live = rows_s >= 0
        stranded = rows_s[live & (nodes_s < 0)]
        if not len(stranded):
            return doc
        # the drained cluster's final placement: requeued pods move to
        # their landing nodes, pods that died with a failed node vacate
        alive = valid & ~np.asarray(sweep.scenarios.masks[s_idx], bool)
        nodes_final = nodes.copy()
        nodes_final[rows_s[live]] = nodes_s[live]
        on_failed = (nodes_final >= 0) & ~alive[np.clip(nodes_final, 0, None)]
        nodes_final[on_failed] = -1
        reasons_full = np.zeros(len(nodes), np.int32)
        reasons_full[rows_s[live]] = reasons_s[live]
        doc["worst_scenario"] = sweep.scenarios.labels[s_idx]
        doc["bottleneck"] = bottleneck_analysis(
            tensors, batch, nodes_final, reasons_full, rows=stranded,
            node_valid=alive, new_node=new_node, daemon_sets=all_ds,
            corrected_ds_overhead=corrected_ds_overhead,
        )
        return doc

    def fail(msg: str) -> ResiliencePlan:
        timings["total_s"] = time.perf_counter() - t_start
        out = ResiliencePlan(
            False, max_new_nodes, k, quantile, msg, probes=probes,
            sweep=None, timings=timings,
        )
        out.explain = mk_explain()
        out.solve = solve_doc
        return out

    fail_msg = (
        f"we have added {max_new_nodes} nodes but the workloads still do "
        f"not survive {fault_spec} failures!!"
    )
    t0 = time.perf_counter()
    try:
        # a certified solver bound >= 1 proves candidate 0's base fit
        # impossible — its probe is a wasted placement
        if lb_solve < 1 and probe(0):
            timings["search"] = time.perf_counter() - t0
            return finish(0)
        if new_node is None:
            timings["search"] = time.perf_counter() - t0
            rec = probes[0]
            return fail(
                "cluster does not survive the failure model "
                f"({rec['survived']}/{rec['scenarios']} scenarios place fully, "
                f"{rec['base_unplaced']} pods unplaced before any failure)"
            )

        if search == "linear":
            for i in range(max(1, lb_solve), max_new + 1):
                if probe(i):
                    timings["search"] = time.perf_counter() - t0
                    return finish(i)
            timings["search"] = time.perf_counter() - t0
            return fail(fail_msg)

        # doubling probe then bisection (survivability capacity-monotone,
        # the plan_capacity scaffolding; see the module docstring's
        # sampling caveat)
        hi = None
        cand = max(1, lb_solve)
        while cand <= max_new:
            if probe(cand):
                hi = cand
                break
            cand *= 2
        if hi is None:
            if max_new >= 1 and max_new not in probes and probe(max_new):
                hi = max_new
            else:
                timings["search"] = time.perf_counter() - t0
                return fail(fail_msg)
        lo = max(
            [i for i in probes if i < hi and not _passed(probes[i], quantile)],
            default=max(0, lb_solve - 1),  # certified infeasible below
        )
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if probe(mid):
                hi = mid
            else:
                lo = mid
    except _Doomed as exc:
        timings["search"] = time.perf_counter() - t0
        return fail(str(exc))
    timings["search"] = time.perf_counter() - t0
    return finish(hi)


def _passed(rec: Dict[str, int], quantile: float) -> bool:
    if rec["base_unplaced"] or not rec["scenarios"]:
        return False
    return rec["survived"] / rec["scenarios"] >= quantile - 1e-12
