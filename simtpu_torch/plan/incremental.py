"""Incremental min-node-add capacity planning: one tensorization, one base
placement, cheap completion probes.

The port of the JAX package's `simtpu/plan/incremental.py`. The reference
re-simulates the ENTIRE cluster for every candidate clone count
(`pkg/apply/apply.go:183-233`); this planner tensorizes the base cluster
plus every clone ONCE and flips a `node_valid` mask per candidate
(`MaskedRoundsEngine`), places everything once on the base cluster, and
answers "do the base failures fit once i clones exist?" with completion
probes that resume from the base run's carried state: each probe places
the clone-pinned DaemonSet pods of clones < i plus the base failures, in
their original order. `verify=True` (the default) re-runs the winning
candidate as one fresh full placement; if the fresh run disagrees, the
search walks upward with fresh runs. The accepted placement is audited
(`audit/checker.py`); an audit-dirty answer is re-placed by the serial
exact engine (pod at a time, the wavefront off, the dense carry) and ships
with the divergence record.

Every probe starts from a copy of the base snapshot made by K17
`carry_copy` (`kernels/csrc/carry_copy.cu`, `_copy_state`): the port's
kernels update dense planes in place, so a probe that reused the snapshot
would corrupt it. The JAX package skips the copy for a compact snapshot
(its expansion never mutates the carry); the port copies either layout, so
the snapshot stays untouched by construction.

Preemption does not run inside probes, as in the JAX package: a loud notice
says so when specs carry priorities. `explain` attaches the failing
candidate's breakdown (K20) and bottleneck block; `solver` consults the
solve backend first (solve/: an audited answer ships, a rejected one floors
the probe search with its certified bound); `checkpoint`, `mesh` and
`precompile` raise NotImplementedError (ROADMAP queue 1 #8, #10).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import constants as C
from ..core.objects import (
    AppResource,
    NodeStatus,
    ResourceTypes,
    SimulateResult,
    UnscheduledPod,
    deep_copy,
    name_of,
    namespace_of,
    pod_priority,
)
from ..core.tensorize import PodBatch, slice_batch
from ..device import resolve_device
from ..engine.rounds import RoundsEngine
from ..engine.scan import REASON_TEXT, Engine, statics_from
from ..kernels import cuda
from ..parallel.sweep import assemble_planning_problem  # noqa: F401  (re-exported)
from .capacity import PlanResult, _env_cap, meet_resource_requests, new_fake_nodes


class MaskedRoundsEngine(RoundsEngine):
    """Bulk rounds engine restricted to a candidate cluster: `node_valid`
    masks out the clone nodes beyond the candidate's size (dead rows no pod
    can select)."""

    def __init__(self, tensorizer, device, node_valid: np.ndarray):
        super().__init__(tensorizer, device)
        self.node_valid = np.asarray(node_valid, bool)


def copy_carry_plain(state):
    """Plain version of K17: every plane of the carry cloned, in field
    order."""
    cuda.count_plain("carry_copy")
    return type(state)(*(t.clone() for t in state))


def _copy_state(state):
    """The carry copied into fresh storage, one segment per plane: K17
    (`kernels/csrc/carry_copy.cu`) in one launch for a carry on the card,
    its plain version for one on the CPU (the JAX `_copy_state`)."""
    if state.free.device.type == "cpu":
        return copy_carry_plain(state)
    return type(state)(*cuda.launch_carry_copy(list(state)))


def _vocab_of(tensors) -> tuple:
    """Engine.place's state-reuse key, for snapshot injection."""
    return Engine.state_vocab(tensors)


def _caps_satisfied(tensors, placed_req_sum: np.ndarray, node_valid: np.ndarray, vg_extra: float) -> tuple:
    """MaxCPU/MaxMemory/MaxVG occupancy caps (`apply.go:580-666`) from the
    dense arrays. All caps at their default 100 hold trivially."""
    max_cpu = _env_cap(C.ENV_MAX_CPU)
    max_mem = _env_cap(C.ENV_MAX_MEMORY)
    max_vg = _env_cap(C.ENV_MAX_VG)
    if max_cpu == 100 and max_mem == 100 and max_vg == 100:
        return True, ""
    from ..core.tensorize import RES_CPU, RES_MEMORY

    alloc = tensors.alloc[node_valid]
    total_cpu = float(alloc[:, RES_CPU].sum())
    total_mem = float(alloc[:, RES_MEMORY].sum())
    cpu_rate = int(placed_req_sum[RES_CPU] / total_cpu * 100) if total_cpu else 0
    mem_rate = int(placed_req_sum[RES_MEMORY] / total_mem * 100) if total_mem else 0
    if cpu_rate > max_cpu:
        return False, (f"the average occupancy rate({cpu_rate}%) of cpu goes beyond "
                       f"the env setting({max_cpu}%)\n")
    if mem_rate > max_mem:
        return False, (f"the average occupancy rate({mem_rate}%) of memory goes beyond "
                       f"the env setting({max_mem}%)\n")
    ext = tensors.ext
    vg_cap = float(ext.vg_cap[node_valid].sum())
    if vg_cap:
        vg_req = float(ext.vg_req0[node_valid].sum()) + vg_extra
        vg_rate = int(vg_req / vg_cap * 100)
        if vg_rate > max_vg:
            return False, (f"the average occupancy rate({vg_rate}%) of vg goes beyond "
                           f"the env setting({max_vg}%)\n")
    return True, ""


def plan_capacity_incremental(
    cluster: ResourceTypes,
    apps: Sequence[AppResource],
    new_node: dict,
    max_new_nodes: int = C.MAX_NUM_NEW_NODE,
    extended_resources: Sequence[str] = (),
    progress=None,
    sched_config=None,
    corrected_ds_overhead: bool = False,
    verify: bool = True,
    materialize: bool = True,
    mesh=None,
    precompile: bool = False,
    speculate=None,
    checkpoint=None,
    audit: Optional[bool] = None,
    explain: bool = False,
    solver: Optional[bool] = None,
    device=None,
    _audit_inject: bool = False,
) -> PlanResult:
    """Minimum clone count of `new_node` deploying everything, via the
    incremental probe strategy of the module docstring. Matches
    `plan_capacity`'s contract (candidates 0..max_new_nodes-1, occupancy
    caps, can-never-help diagnoses, PlanResult shape). `PlanResult.timings`
    carries the phase breakdown (tensorize / base / probes / verify /
    materialize); `PlanResult.candidates` one record per placement run.

    `audit` (None = on) audits the accepted candidate's fresh verify
    placement; on failure the candidate re-places through the serial exact
    engine and ships with the divergence record. `_audit_inject` corrupts
    the audit's view of the primary placement (never the fallback's), which
    drives that path end to end. Every placement runs on `device` (None =
    the CUDA card).

    `explain` (off by default: the off path launches nothing more)
    attaches the decision-observability block (explain/) to terminal
    failure results: the per-stage breakdown (K20) of the failing
    candidate's unplaced pods against its carried state, plus the
    binding-constraint bottleneck with the template verdict."""
    for name, on, item in (("checkpoint", checkpoint is not None, 8), ("mesh", mesh is not None, 10),
                           ("precompile", precompile, 10)):
        if on:
            raise NotImplementedError(
                f"plan_capacity_incremental({name}=...) is not ported (ROADMAP queue 1 #{item})")
    from ..audit.checker import audit_placement, divergence_diagnostic, inject_divergence

    device = resolve_device(device)
    audit_on = (True if audit is None else bool(audit)) and verify
    say = progress or (lambda s: None)
    timings: Dict[str, float] = {}
    probes: Dict[int, int] = {}
    candidates: List[Dict[str, object]] = []
    preempt_flag = [False]
    # the global-solver consult's record, attached to EVERY result this
    # plan returns (finalize)
    solve_doc: Dict[str, object] = {}
    fail_msg = f"we have added {max_new_nodes} nodes but it still failed!!"

    def finalize(out: PlanResult) -> PlanResult:
        out.timings = timings
        out.candidates = candidates
        if solve_doc and not out.solve:
            out.solve = dict(solve_doc)
        out.preemption_ignored = preempt_flag[0]
        return out

    t0 = time.perf_counter()
    max_new = max(max_new_nodes - 1, 0)  # reference walks i in [0, max)
    tz, all_nodes, n_base, ordered = assemble_planning_problem(
        cluster, apps, new_node, max_new, extended_resources)
    batch = tz.add_pods(ordered)
    tensors = tz.freeze()
    statics_from(tensors, sched_config, device)  # move the device statics once
    vocab = _vocab_of(tensors)
    pin = np.asarray(batch.pin)
    clone_of = pin - n_base  # >= 0 for clone-pinned (DaemonSet) pods
    timings["tensorize"] = time.perf_counter() - t0

    if any(pod_priority(p) != 0 for p in ordered):
        preempt_flag[0] = True
        notice = ("simtpu: specs carry pod priorities, but the incremental "
                  "planner never runs preemption — priority/eviction semantics "
                  "are IGNORED (use --search binary/linear for simulate()'s "
                  "preemption path)")
        print(notice, file=sys.stderr)
        say(notice)

    # -- global-solver consult (solve/): one relaxation over every
    # candidate count, on the SAME tensorization the probes use. Accepted
    # => the plan ships here (no base placement, no probes); rejected =>
    # its certified LP bound floors the resource lower bound below
    lb_solve = 0
    if solver:
        from ..solve import attempt_solve

        t_s = time.perf_counter()
        att = attempt_solve(tz, tensors, batch, all_nodes, n_base, max_new, sched_config, say,
                            device=device, _audit_inject=_audit_inject)
        timings["solve"] = time.perf_counter() - t_s
        solve_doc.update(att.doc)
        if att.accepted:
            probes[att.k] = 0
            result = None
            if materialize:
                t1 = time.perf_counter()
                result = _materialize(tz, all_nodes, n_base + att.k, batch, att.nodes_arr, att.reasons,
                                      clone_of, att.k, att.ext_log, att.gpu_arr)
                timings["materialize"] = time.perf_counter() - t1
            out = PlanResult(True, att.k, result, "Success!", probes)
            out.audit = att.audit_doc
            return finalize(out)
        if att.certified:
            lb_solve = att.lower_bound
            if lb_solve > 0:
                say(f"solver: certified lower bound {lb_solve} — flooring the probe search")

    def make_engine(node_valid: np.ndarray):
        eng = MaskedRoundsEngine(tz, device, node_valid)
        eng.sched_config = sched_config
        if speculate is not None:
            eng.speculate = bool(speculate)
        return eng

    def valid_mask(i: int) -> np.ndarray:
        m = np.ones(len(all_nodes), bool)
        m[n_base + i:] = False
        return m

    def _fallback_engine(i: int):
        """The serial exact referee the audit falls back to: pod at a time,
        the wavefront off, the dense carry."""
        fb = Engine(tz, device)
        fb.node_valid = valid_mask(i)
        fb.speculate = False
        fb.compact = False
        fb.sched_config = sched_config
        return fb

    r_res = tensors.alloc.shape[1]
    req_pad = batch.req
    if req_pad.shape[1] < r_res:
        req_pad = np.pad(req_pad, ((0, 0), (0, r_res - req_pad.shape[1])))

    def mk_explain(eng, ebatch, erows, enodes, ereasons, i, base_nodes=None):
        """Decision-observability block for a failing candidate (explain/):
        per-stage breakdown against the engine's carried state + the
        bottleneck analysis with the template verdict. {} when explain was
        not requested. An engine with no carried state explains with the
        bottleneck block alone, its free capacity rebuilt from EVERY
        visible placement: probe call sites hand in `base_nodes`, because
        their `enodes`/`ebatch` cover only the unplaced-from-base slice."""
        if not explain or not len(erows):
            return {}
        from ..explain import build_explain_doc

        all_ds = list(cluster.daemon_sets)
        for app in apps:
            all_ds += app.resource.daemon_sets
        try:
            state = eng.carried_state()
        except ValueError:
            state = None
        free = None
        if state is None:
            used = np.zeros(tensors.alloc.shape, np.float32)
            enodes_np = np.asarray(enodes)
            ereq = np.asarray(ebatch.req, np.float32)
            if ereq.shape[1] < r_res:
                ereq = np.pad(ereq, ((0, 0), (0, r_res - ereq.shape[1])))
            placed = np.flatnonzero(enodes_np >= 0)
            np.add.at(used, enodes_np[placed], ereq[placed])
            if base_nodes is not None:
                base_np = np.asarray(base_nodes)
                bplaced = np.flatnonzero(base_np >= 0)
                np.add.at(used, base_np[bplaced], req_pad[bplaced])
            free = tensors.alloc - used
        return build_explain_doc(
            tensors, ebatch, erows, state, np.asarray(enodes),
            np.asarray(ereasons), node_valid=valid_mask(i),
            sched_config=sched_config, new_node=new_node,
            daemon_sets=all_ds, corrected_ds_overhead=corrected_ds_overhead,
            free=free,
        )

    def _plane_diff(a_eng, b_eng):
        """Which carried-state planes the two engines' logs disagree on."""
        from ..engine.state import build_state, diff_state_planes

        def dense(e):
            return build_state(tensors, np.asarray(e.placed_group, np.int32),
                               np.asarray(e.placed_node, np.int32), e.log_req_matrix(r_res),
                               e.ext_log, device)

        return diff_state_planes(dense(a_eng), dense(b_eng))

    def place(eng, pbatch, count: int, phase: str, fallback: bool = False):
        t_c = time.perf_counter()
        out = eng.place(pbatch)
        candidates.append({"count": count, "phase": phase, "fallback": fallback,
                           "wall_s": time.perf_counter() - t_c, "speculate": eng.speculate,
                           "compact": eng.compact})
        return out

    def fresh_run(i: int, phase: str = "verify"):
        """Full placement of every pod against base + i clones."""
        phantom = clone_of >= i
        eng = make_engine(valid_mask(i))
        nodes, reasons, extras = place(eng, batch, i, phase)
        failed = (nodes < 0) & ~phantom
        probes[i] = int(failed.sum())
        return eng, nodes, reasons, failed, extras

    # -- base candidate: i = 0
    t0 = time.perf_counter()
    say("add 0 node(s)")
    base_eng, base_nodes_arr, base_reasons, base_failed, base_extras = fresh_run(0, phase="base")
    timings["base"] = time.perf_counter() - t0

    def finish(i, eng, nodes_arr, reasons, extras):
        ok, reason = _caps_satisfied(
            tensors, batch.req[nodes_arr >= 0].sum(axis=0), valid_mask(i),
            vg_extra=float(np.asarray(eng.ext_log["vg_alloc"]).sum()
                           if len(eng.ext_log["vg_alloc"]) else 0.0))
        if not ok:
            say(reason.rstrip("\n"))
            return None
        nodes_arr = np.asarray(nodes_arr)
        reasons = np.asarray(reasons)
        ext_log = eng.ext_log
        gpu_arr = extras["gpu_shares"]
        audit_doc: Dict[str, object] = {}
        if audit_on:
            phantom = clone_of >= i
            nodes_aud = inject_divergence(tensors, batch, nodes_arr) if _audit_inject else nodes_arr
            rep = audit_placement(tensors, batch, nodes_aud, extras, node_valid=valid_mask(i),
                                  require_all=True, expect_mask=~phantom, device=device)
            audit_doc = rep.counters()
            if not rep.ok:
                say(f"audit FAILED on the accepted candidate ({rep.summary()}) — re-placing "
                    "through the serial exact scan")
                fb = _fallback_engine(i)
                nodes_f, reasons_f, extras_f = place(fb, batch, i, "fallback", fallback=True)
                nodes_f = np.asarray(nodes_f)
                rep_f = audit_placement(tensors, batch, nodes_f, extras_f, node_valid=valid_mask(i),
                                        require_all=True, expect_mask=~phantom, device=device)
                audit_doc = {
                    **rep.counters(),
                    "fallback": True,
                    "fallback_audit": rep_f.counters(),
                    "divergence": divergence_diagnostic(tensors, batch, nodes_aud, nodes_f, rep,
                                                        planes=_plane_diff(eng, fb)),
                }
                if not rep_f.ok:
                    out = PlanResult(
                        False, i, None,
                        "audit failure: the accepted candidate violates its claimed constraints "
                        f"and the serial-exact fallback did not certify either ({rep_f.summary()})",
                        probes)
                    out.audit = audit_doc
                    return finalize(out)
                audit_doc["ok"] = True
                nodes_arr, reasons = nodes_f, np.asarray(reasons_f)
                ext_log, gpu_arr = fb.ext_log, extras_f["gpu_shares"]
        result = None
        if materialize:
            t1 = time.perf_counter()
            result = _materialize(tz, all_nodes, n_base + i, batch, nodes_arr, reasons, clone_of, i,
                                  ext_log, gpu_arr)
            timings["materialize"] = time.perf_counter() - t1
        out = PlanResult(True, i, result, "Success!", probes)
        out.audit = audit_doc
        return finalize(out)

    if probes[0] == 0:
        done = finish(0, base_eng, base_nodes_arr, base_reasons, base_extras)
        if done is not None:
            return done
    u0 = np.flatnonzero(base_failed)

    def diagnose(failed_idx) -> Optional[str]:
        """Adding template nodes can never help (`apply.go:213-231`)."""
        from ..core.match import node_should_run_pod

        all_ds = list(cluster.daemon_sets)
        for app in apps:
            all_ds += app.resource.daemon_sets
        for j in failed_idx[:64]:  # a handful suffices for the message
            pod = ordered[int(j)]
            if not node_should_run_pod(new_node, pod):
                return (f"failed to schedule pod {namespace_of(pod)}/{name_of(pod)}: "
                        "the pod cannot be scheduled successfully by adding node: "
                        "pod does not fit new node affinity or taints")
            if not meet_resource_requests(new_node, pod, all_ds, corrected=corrected_ds_overhead):
                return (f"failed to schedule pod {namespace_of(pod)}/{name_of(pod)}: "
                        "new node cannot meet resource requests of pod: the total "
                        "requested resource of daemonset pods in new node is too large")
        return None

    msg = diagnose(u0)
    if msg:
        out = PlanResult(False, 0, None, msg, probes)
        out.explain = mk_explain(base_eng, batch, u0, base_nodes_arr, base_reasons, 0)
        return finalize(out)
    if max_new == 0:
        # no candidate beyond 0 exists (max_new_nodes <= 1) — the base
        # failure is terminal
        out = PlanResult(False, max_new_nodes, None, fail_msg, probes)
        out.explain = mk_explain(base_eng, batch, u0, base_nodes_arr, base_reasons, 0)
        return finalize(out)

    # -- snapshot + cheap probes
    t0 = time.perf_counter()
    snapshot = base_eng.last_state

    def probe(i: int) -> tuple:
        """Completion probe: from a copy of the base snapshot, place the
        clone DaemonSet pods for clones < i plus every base failure, in
        original order. Feasible iff all of them place."""
        idx = np.flatnonzero(base_failed | ((clone_of >= 0) & (clone_of < i)))
        say(f"add {i} node(s)")
        probe_batch = slice_batch(batch, idx)
        eng = make_engine(valid_mask(i))
        eng.last_state = _copy_state(snapshot)
        eng._last_vocab = vocab
        eng._state_dirty = False
        nodes, reasons, extras = place(eng, probe_batch, i, "probes")
        failed = nodes < 0
        probes[i] = int(failed.sum())
        return eng, idx, nodes, reasons, failed, extras["gpu_shares"]

    # resource lower bound: the base failures must at least FIT the added
    # template capacity, DaemonSet overhead aside
    lb = 1
    if len(u0):
        demand = batch.req[u0].sum(axis=0)
        cap = tensors.alloc[n_base]
        with np.errstate(divide="ignore", invalid="ignore"):
            need = np.where(demand > 0, demand / np.maximum(cap, 1e-30), 0.0)
        need_max = float(need.max())
        if not math.isfinite(need_max) or need_max >= max_new_nodes:
            lb = max_new
        else:
            lb = max(1, int(math.ceil(need_max - 1e-9)))
    # the solver's certified LP bound floors the resource bound — LP
    # feasibility is necessary for ANY placement, so probes below it are
    # wasted
    lb = max(lb, lb_solve)
    # doubling from the bound, then bisection on the open interval; when the
    # first probe (the bound) is feasible, try bound-1 next
    hi = None
    first_cand = cand = min(max(lb, 1), max_new)
    lo = 0
    while True:
        if cand <= lo:
            break
        eng_i, idx_i, nodes_i, reasons_i, failed_i, gpu_i = probe(cand)
        if probes[cand] == 0:
            hi, hi_run = cand, (eng_i, idx_i, nodes_i, gpu_i)
        else:
            lo = max(lo, cand)
            msg = diagnose(idx_i[failed_i])
            if msg:
                out = PlanResult(False, cand, None, msg, probes)
                out.explain = mk_explain(eng_i, slice_batch(batch, idx_i), np.flatnonzero(failed_i),
                                         nodes_i, reasons_i, cand, base_nodes=base_nodes_arr)
                return finalize(out)
        if hi is None:
            if cand >= max_new:
                out = PlanResult(False, max_new_nodes, None, fail_msg, probes)
                out.explain = mk_explain(eng_i, slice_batch(batch, idx_i), np.flatnonzero(np.asarray(failed_i)),
                                         nodes_i, reasons_i, cand, base_nodes=base_nodes_arr)
                return finalize(out)
            cand = min(cand * 2, max_new)
        elif hi == first_cand and lo == 0 and hi - 1 > lo:
            cand = hi - 1  # tight-bound fast path
        elif hi - lo > 1:
            cand = (lo + hi) // 2
        else:
            break
    timings["probes"] = time.perf_counter() - t0

    # -- reference-faithful confirmation
    if verify:
        t0 = time.perf_counter()
        i = hi
        while i < max_new_nodes:
            say(f"verify {i} node(s) with a fresh placement")
            eng_v, nodes_v, reasons_v, failed_v, extras_v = fresh_run(i)
            if probes[i] == 0:
                timings["verify"] = time.perf_counter() - t0
                done = finish(i, eng_v, nodes_v, reasons_v, extras_v)
                if done is not None:
                    return done
                i += 1  # caps failed: monotone in node count, walk upward
                continue
            msg = diagnose(np.flatnonzero(failed_v))
            if msg:
                out = PlanResult(False, i, None, msg, probes)
                out.explain = mk_explain(eng_v, batch, np.flatnonzero(failed_v), nodes_v, reasons_v, i)
                return finalize(out)
            i += 1
        out = PlanResult(False, max_new_nodes, None, fail_msg, probes)
        out.explain = mk_explain(eng_v, batch, np.flatnonzero(failed_v), nodes_v, reasons_v,
                                 max_new_nodes - 1)
        return finalize(out)

    # -- incremental result: base placements + winning probe
    eng_w, idx_w, nodes_w, gpu_w = hi_run
    nodes_all = base_nodes_arr.copy()
    nodes_all[idx_w] = nodes_w
    gpu_all = np.asarray(base_extras["gpu_shares"]).copy()
    if len(idx_w):
        gpu_all[idx_w] = gpu_w
    reasons_all = base_reasons.copy()
    ext_log = {k: list(base_eng.ext_log[k]) + list(eng_w.ext_log[k]) for k in base_eng.ext_log}
    ok, reason = _caps_satisfied(
        tensors, batch.req[nodes_all >= 0].sum(axis=0), valid_mask(hi),
        vg_extra=float(np.asarray(ext_log["vg_alloc"]).sum() if len(ext_log["vg_alloc"]) else 0.0))
    if not ok:
        say(reason.rstrip("\n"))
        i = hi + 1
        while i < max_new_nodes:
            eng_v, nodes_v, reasons_v, failed_v, extras_v = fresh_run(i)
            if probes[i] == 0:
                done = finish(i, eng_v, nodes_v, reasons_v, extras_v)
                if done is not None:
                    return done
            i += 1
        return finalize(PlanResult(False, max_new_nodes, None, fail_msg, probes))
    result = None
    if materialize:
        t1 = time.perf_counter()
        result = _materialize(tz, all_nodes, n_base + hi, batch, nodes_all, reasons_all, clone_of, hi,
                              ext_log, gpu_all)
        timings["materialize"] = time.perf_counter() - t1
    return finalize(PlanResult(True, hi, result, "Success!", probes))


def _materialize(tz, all_nodes: List[dict], n_nodes: int, batch: PodBatch, nodes_arr: np.ndarray,
                 reasons: np.ndarray, clone_of: np.ndarray, n_clones: int, ext_log: dict,
                 gpu_shares_arr) -> SimulateResult:
    """Assemble the SimulateResult for the winning candidate from the
    engine-level placement vector (one pass)."""
    from ..api import record_placed_pod, write_extended_annotations

    node_objs = [deep_copy(n) for n in all_nodes[:n_nodes]]
    write_extended_annotations(tz.ext, ext_log, node_objs)
    names = [name_of(n) for n in node_objs]
    by_node: List[List[dict]] = [[] for _ in range(n_nodes)]
    unscheduled: List[UnscheduledPod] = []
    gpu_shares_arr = np.asarray(gpu_shares_arr)
    phantom = clone_of >= n_clones
    for j in np.flatnonzero((nodes_arr >= 0) & ~phantom):
        pod = batch.pods[int(j)]
        by_node[int(nodes_arr[j])].append(record_placed_pod(pod, names[int(nodes_arr[j])], gpu_shares_arr[j]))
    for j in np.flatnonzero((nodes_arr < 0) & ~phantom):
        pod = batch.pods[int(j)]
        msg = REASON_TEXT.get(int(reasons[j]), "unschedulable")
        unscheduled.append(UnscheduledPod(
            pod=pod,
            reason=(f"failed to schedule pod ({namespace_of(pod)}/{name_of(pod)}): "
                    f"Unschedulable: 0/{n_nodes} nodes are available: {msg}")))
    statuses = [NodeStatus(node=n, pods=by_node[i]) for i, n in enumerate(node_objs)]
    return SimulateResult(unscheduled_pods=unscheduled, node_status=statuses, preempted_pods=[])
