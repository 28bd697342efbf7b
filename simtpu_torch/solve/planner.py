"""The solve backend's planning surface: propose, certify, or step aside.

The JAX package's `solve/planner.py`. `attempt_solve` is the whole
advisory-mode contract in one function:

  eligibility gate -> the relaxation over every candidate count (K22/K23)
  -> float64 infeasibility certificate at the boundary -> host rounding ->
  occupancy caps -> independent audit (K8) -> on a dirty audit, the
  serial exact engine re-places the candidate.

Nothing uncertified ever ships: an accepted answer is an audited integral
placement at a candidate count whose predecessor carries an infeasibility
proof. Every other outcome ("rejected", "infeasible", "ineligible") steps
aside and hands the exact planners a certified lower bound when one
exists.

Differences from the JAX package: the `solve.*` counters are the plain
count `SOLVE_COUNTS` (read through `solve_counts()`), as the port keeps
its other counts; the `solve.*` spans are not ported (ROADMAP queue 1
#9). There is no `SIMTPU_SOLVER` default: a planner's `solver=None` means
off, the JAX default when the variable is unset. The zero extras of a
solver placement give `gpu_shares` the engine's [P, GD] shape, where the
JAX package's give [P] (which its audit broadcasts to an [M, M] array of
zeros; the verdict is the same). The injected divergence is the port's
planners' `_audit_inject` lever, not an environment switch.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..device import resolve_device
from .relax import (
    DEFAULT_ITERS,
    RESIDUAL_TOL,
    build_relax_problem,
    fetch_y,
    infeasibility_certificate,
    relax_candidates,
)
from .rounding import nodes_from_counts, round_candidate

#: the `solve.*` counter family of the JAX package
SOLVE_COUNT_KEYS = ("attempts", "accepted", "rejected", "ineligible", "infeasible", "fallbacks")
#: solver consults of this process (read through `solve_counts()`)
SOLVE_COUNTS: Counter = Counter()


def solve_counts() -> dict:
    """The solver counters, one entry per SOLVE_COUNT_KEYS key."""
    return {k: SOLVE_COUNTS[k] for k in SOLVE_COUNT_KEYS}


def _bump(key: str) -> None:
    SOLVE_COUNTS[key] += 1


@dataclass
class SolveAttempt:
    """One consult of the solve backend, with everything a planner needs
    to either ship the answer or warm-start the exact search."""

    #: accepted | accepted_fallback | rejected | infeasible | ineligible
    status: str
    #: winning clone count (accepted states), else -1
    k: int = -1
    #: certified lower bound on the clone count (0 = no certificate)
    lower_bound: int = 0
    #: True when `lower_bound` carries the float64 infeasibility proof
    certified: bool = False
    #: accepted placement artifacts, `_materialize`-shaped
    nodes_arr: Optional[np.ndarray] = None
    reasons: Optional[np.ndarray] = None
    ext_log: Optional[dict] = None
    gpu_arr: Optional[np.ndarray] = None
    #: the auditor's verdict on the shipped placement (PlanResult.audit)
    audit_doc: Dict[str, object] = field(default_factory=dict)
    #: the structured record (PlanResult.solve / --json engine.solve)
    doc: Dict[str, object] = field(default_factory=dict)

    @property
    def accepted(self) -> bool:
        return self.status in ("accepted", "accepted_fallback")


def _ineligible_reason(batch) -> Optional[str]:
    """Specs the relaxation cannot faithfully model are gated out up
    front: extended storage/GPU demand, and a forced pod naming an
    unknown node. Ports/affinity/spread are NOT gated — the solver tries
    and the auditor disposes."""
    ext = batch.ext
    if np.asarray(ext["lvm_size"]).any() or np.asarray(ext["dev_size"]).any():
        return "extended local-storage demand (lvm/device)"
    if (np.asarray(ext["gpu_mem"]) > 0).any() or (np.asarray(ext["gpu_count"]) > 0).any():
        return "gpu-share demand"
    pin = np.asarray(batch.pin)
    forced = np.asarray(batch.forced, bool)
    if (forced & (pin < 0)).any():
        return "forced pod names an unknown node"
    return None


def _zero_extras(tensors, p: int) -> Dict[str, np.ndarray]:
    """Audit-shaped extras for a solver placement: eligibility guarantees
    zero extended demand, so the allocations are all zeros, in the shapes
    of the engine's extras ([P, V], [P, SD], [P, GD])."""
    ext = tensors.ext
    return {
        "lvm_alloc": np.zeros((p, ext.vg_cap.shape[1]), np.float32),
        "dev_take": np.zeros((p, ext.sdev_cap.shape[1]), bool),
        "gpu_shares": np.zeros((p, ext.gpu_dev_total.shape[1]), np.float32),
    }


def _solver_ext_log(tensors, batch, nodes_arr: np.ndarray) -> dict:
    """Placement-order ext_log for `_materialize` (zero extended
    allocations, the engine's ext_log contract)."""
    ext = tensors.ext
    ok = np.flatnonzero(nodes_arr >= 0)
    return {
        "node": nodes_arr[ok].tolist(),
        "vg_alloc": list(np.zeros((len(ok), ext.vg_cap.shape[1]), np.float32)),
        "sdev_take": list(np.zeros((len(ok), ext.sdev_cap.shape[1]), bool)),
        "gpu_shares": list(np.zeros((len(ok), ext.gpu_dev_total.shape[1]), np.float32)),
        "gpu_mem": np.asarray(batch.ext["gpu_mem"])[ok].tolist(),
    }


def _candidate_masks(n_total: int, n_base: int, max_new: int) -> np.ndarray:
    """[max_new + 1, N] membership masks: the base nodes and the first i
    clones for candidate i."""
    clone_idx = np.arange(n_total) - n_base
    cands = np.arange(max_new + 1)
    return (clone_idx[None, :] < cands[:, None]) | (clone_idx[None, :] < 0)


def attempt_solve(tz, tensors, batch, all_nodes, n_base: int, max_new: int, sched_config=None,
                  progress=None, device=None, iters: int = DEFAULT_ITERS,
                  _audit_inject: bool = False) -> SolveAttempt:
    """One full solver consult over candidates 0..max_new (inclusive),
    every placement and audit on `device` (None = the CUDA card).

    Accepts only what the auditor certifies at a count whose predecessor
    is PROVEN infeasible; everything else returns a non-accepted attempt
    whose `lower_bound`/`doc` the exact search consumes. `_audit_inject`
    corrupts the audit's view of the rounded placement (never the
    fallback's), which drives the fallback path end to end."""
    device = resolve_device(device)
    say = progress or (lambda s: None)
    _bump("attempts")
    t0 = time.perf_counter()
    doc: Dict[str, object] = {"enabled": True, "iters": int(iters)}

    def finish(att: SolveAttempt) -> SolveAttempt:
        doc["status"] = att.status
        doc["wall_s"] = round(time.perf_counter() - t0, 4)
        if att.certified:
            doc["lower_bound"] = att.lower_bound
        att.doc = doc
        return att

    reason = _ineligible_reason(batch)
    if reason is not None:
        _bump("ineligible")
        doc["reason"] = reason
        return finish(SolveAttempt("ineligible"))

    prob = build_relax_problem(tensors, batch)
    valid_s = _candidate_masks(len(all_nodes), n_base, max_new)
    doc["candidates"] = int(max_new + 1)

    verd = relax_candidates(prob, valid_s, iters, device)
    finite = verd.residual[np.isfinite(verd.residual)]
    doc["residual"] = float(finite.min()) if len(finite) else None
    feasible = np.flatnonzero(verd.residual <= RESIDUAL_TOL)
    if len(feasible) == 0:
        # the relaxation converged nowhere — certify the LARGEST candidate
        # when possible, so the exact search knows the whole range is
        # hopeless
        _bump("infeasible")
        y_last = fetch_y(verd, max_new)
        certified = infeasibility_certificate(prob, y_last, valid_s[max_new])
        doc["reason"] = "no candidate count is relax-feasible"
        return finish(SolveAttempt("infeasible", lower_bound=max_new + 1 if certified else 0,
                                   certified=certified))

    k = int(feasible[0])
    doc["k"] = k
    doc["residual"] = float(verd.residual[k])
    certified = k == 0
    if k > 0:
        # one boundary proof suffices: the candidate masks are nested, so
        # k-1 infeasible => everything below k infeasible
        certified = infeasibility_certificate(prob, fetch_y(verd, k - 1), valid_s[k - 1])
    doc["certified_lb"] = bool(certified)
    lb = k if certified else 0
    if not certified:
        _bump("rejected")
        doc["reason"] = "minimality not certified (duality gap)"
        return finish(SolveAttempt("rejected", k=k))

    m, why = round_candidate(prob, fetch_y(verd, k), valid_s[k])
    if m is None:
        _bump("rejected")
        doc["reason"] = f"rounding failed: {why}"
        return finish(SolveAttempt("rejected", k=k, lower_bound=lb, certified=True))

    pin = np.asarray(batch.pin)
    nodes_arr = nodes_from_counts(prob, pin, m)
    phantom = (pin - n_base) >= k
    nodes_arr[phantom] = -1

    from ..plan.incremental import _caps_satisfied

    valid_k = np.asarray(valid_s[k], bool)
    ok, cap_reason = _caps_satisfied(tensors, np.asarray(batch.req)[nodes_arr >= 0].sum(axis=0),
                                     valid_k, vg_extra=0.0)
    if not ok:
        # cap feasibility can be non-monotone (DaemonSet overhead) — the
        # exact planners own that walk
        _bump("rejected")
        doc["reason"] = f"occupancy cap: {cap_reason.strip()}"
        return finish(SolveAttempt("rejected", k=k, lower_bound=lb, certified=True))

    from ..audit.checker import audit_placement, divergence_diagnostic, inject_divergence

    extras = _zero_extras(tensors, len(pin))
    nodes_aud = inject_divergence(tensors, batch, nodes_arr) if _audit_inject else nodes_arr
    rep = audit_placement(tensors, batch, nodes_aud, extras, node_valid=valid_k, require_all=True,
                          expect_mask=~phantom, device=device)
    audit_doc: Dict[str, object] = rep.counters()
    if rep.ok:
        _bump("accepted")
        say(f"solver: candidate {k} certified by the auditor")
        return finish(SolveAttempt(
            "accepted", k=k, lower_bound=lb, certified=True, nodes_arr=nodes_arr,
            reasons=np.zeros(len(pin), np.int32), ext_log=_solver_ext_log(tensors, batch, nodes_arr),
            gpu_arr=np.zeros(len(pin), np.float32), audit_doc=audit_doc))

    # audit-dirty: the serial exact engine re-places candidate k, and only
    # ITS certified answer may ship
    _bump("fallbacks")
    say(f"solver: audit FAILED on the rounded candidate ({rep.summary()}) "
        "— re-placing through the serial exact scan")
    from ..engine.scan import Engine

    fb = Engine(tz, device)
    fb.node_valid = valid_k
    fb.speculate = False
    fb.compact = False
    fb.sched_config = sched_config
    nodes_f, reasons_f, extras_f = fb.place(batch)
    nodes_f = np.asarray(nodes_f)
    doc["fallback"] = True
    if ((nodes_f < 0) & ~phantom).any():
        # the exact engine cannot complete candidate k either (the
        # relaxation missed a constraint the engine enforces) — reject,
        # keeping the still-valid LP lower bound for the exact search
        _bump("rejected")
        doc["reason"] = "exact fallback could not place candidate k"
        return finish(SolveAttempt("rejected", k=k, lower_bound=lb, certified=True))
    rep_f = audit_placement(tensors, batch, nodes_f, extras_f, node_valid=valid_k, require_all=True,
                            expect_mask=~phantom, device=device)
    audit_doc = {
        **rep.counters(),
        "fallback": True,
        "fallback_audit": rep_f.counters(),
        "divergence": divergence_diagnostic(tensors, batch, nodes_aud, nodes_f, rep),
    }
    if not rep_f.ok:
        _bump("rejected")
        doc["reason"] = f"fallback placement failed its audit too ({rep_f.summary()})"
        att = SolveAttempt("rejected", k=k, lower_bound=lb, certified=True)
        att.audit_doc = audit_doc
        return finish(att)
    audit_doc["ok"] = True
    _bump("accepted")
    return finish(SolveAttempt(
        "accepted_fallback", k=k, lower_bound=lb, certified=True, nodes_arr=nodes_f,
        reasons=np.asarray(reasons_f), ext_log=fb.ext_log,
        gpu_arr=np.asarray(extras_f["gpu_shares"]), audit_doc=audit_doc))


def solve_capacity_plan(cluster, apps, new_node: dict, max_new_nodes: int, extended_resources=(),
                        progress=None, sched_config=None, device=None, iters: int = DEFAULT_ITERS,
                        _audit_inject: bool = False):
    """Solver-backed capacity plan for the facade planner: one
    tensorization, one relaxation, one audit — no simulate() at all on the
    accepted path.

    Returns (PlanResult, attempt) when the solver's answer is certified,
    else (None, attempt) and the caller runs the exact search (using
    `attempt.lower_bound` as a warm start when certified)."""
    from ..parallel.sweep import assemble_planning_problem
    from ..plan.capacity import PlanResult
    from ..plan.incremental import _materialize

    say = progress or (lambda s: None)
    max_new = max(max_new_nodes - 1, 0)
    tz, all_nodes, n_base, ordered = assemble_planning_problem(
        cluster, apps, new_node, max_new, extended_resources)
    batch = tz.add_pods(ordered)
    tensors = tz.freeze()
    att = attempt_solve(tz, tensors, batch, all_nodes, n_base, max_new, sched_config, say,
                        device=device, iters=iters, _audit_inject=_audit_inject)
    if not att.accepted:
        return None, att
    clone_of = np.asarray(batch.pin) - n_base
    result = _materialize(tz, all_nodes, n_base + att.k, batch, att.nodes_arr, att.reasons,
                          clone_of, att.k, att.ext_log, att.gpu_arr)
    plan = PlanResult(True, att.k, result, "Success!", {int(att.k): 0})
    plan.audit = att.audit_doc
    plan.solve = att.doc
    return plan, att


def solve_lower_bound(tensors, batch, n_base: int, n_total: int, max_new: int, device=None,
                      iters: int = DEFAULT_ITERS) -> Tuple[int, Dict[str, object]]:
    """Relax-only certified lower bound on the clone count (0 = no claim),
    for `plan_resilience`: the no-failure fit is necessary for
    survivability, so an LP infeasibility proof at count j rules out every
    candidate <= j. No rounding, no audit — this never ships a placement."""
    device = resolve_device(device)
    doc: Dict[str, object] = {"enabled": True, "mode": "lower_bound"}
    if _ineligible_reason(batch) is not None:
        doc["status"] = "ineligible"
        return 0, doc
    prob = build_relax_problem(tensors, batch)
    valid_s = _candidate_masks(n_total, n_base, max_new)
    verd = relax_candidates(prob, valid_s, iters, device)
    feasible = np.flatnonzero(verd.residual <= RESIDUAL_TOL)
    k = int(feasible[0]) if len(feasible) else max_new + 1
    doc["k"] = k
    if k == 0:
        doc["status"] = "trivial"
        return 0, doc
    boundary = min(k - 1, max_new)
    certified = infeasibility_certificate(prob, fetch_y(verd, boundary), valid_s[boundary])
    doc["certified_lb"] = bool(certified)
    if not certified:
        doc["status"] = "uncertified"
        return 0, doc
    doc["status"] = "certified"
    doc["lower_bound"] = k
    return k, doc
