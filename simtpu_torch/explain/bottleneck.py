"""Binding-constraint analysis: *what to buy*, not just *how many*.

The port of the JAX package's `explain/bottleneck.py` (host numpy, copied).
When a plan is infeasible (or a placement strands pods), this module
aggregates over the WHOLE unplaced set:

- per-resource pressure: total requested by the unplaced pods vs total
  free on the valid nodes, the dominant (binding) resource, and a
  fragmentation signal (the largest single-pod request vs the largest
  single-node free block — aggregate room with no node big enough);
- constraint-class split: how many failures are resource-shaped (more
  capacity helps) vs topology/affinity/storage-shaped (capacity alone
  cannot help);
- the template verdict: folds the planners' `diagnose` logic
  (`node_should_run_pod` + `meet_resource_requests`) over the unplaced
  set — how many pods another template clone could EVER host — and, when
  a resource deficit exists, a template-node count hint
  (ceil(deficit / template capacity), the "what to buy" number).

Everything here is host-side numpy over arrays the planners already hold:
no kernel runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..engine.scan import (
    FAIL_ATTACH,
    FAIL_GPU,
    FAIL_PORTS,
    FAIL_RESOURCES,
    FAIL_STORAGE,
    FAIL_VOLUME,
    REASON_TEXT,
)

#: failure classes where buying capacity (more/larger nodes) can help;
#: everything else (selector/affinity/spread/volume-bind) is a
#: constraint-shaped failure capacity alone cannot fix
_CAPACITY_SHAPED = {
    FAIL_RESOURCES,
    FAIL_STORAGE,
    FAIL_GPU,
    FAIL_PORTS,
    FAIL_VOLUME,
    FAIL_ATTACH,
}

#: unplaced pods probed against the template (a handful decides the
#: verdict; the cap is reported, never silent)
_TEMPLATE_PROBE_CAP = 64


def bottleneck_analysis(
    tensors,
    batch,
    nodes_arr: np.ndarray,
    reasons: np.ndarray,
    *,
    rows: Optional[Sequence[int]] = None,
    node_valid: Optional[np.ndarray] = None,
    new_node: Optional[dict] = None,
    daemon_sets: Sequence[dict] = (),
    corrected_ds_overhead: bool = False,
    free: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """The binding-constraint record for one placement's unplaced set.

    `rows` restricts the unplaced set (planners pass the non-phantom
    failures); `node_valid` the candidate cluster's membership mask.
    With `new_node` (the template), the can-another-node-ever-help
    verdict and the node-count hint are folded in.  `free` overrides the
    free-capacity matrix ([N, R] — e.g. a carried state's `free` plane,
    which also accounts placements `nodes_arr` cannot see: a probe run
    resumed from a base snapshot, a preemption-surgered log)."""
    return _bottleneck(
        tensors, batch, nodes_arr, reasons, rows, node_valid,
        new_node, daemon_sets, corrected_ds_overhead, free,
    )


def _bottleneck(
    tensors, batch, nodes_arr, reasons, rows, node_valid,
    new_node, daemon_sets, corrected_ds_overhead, free,
) -> Dict[str, object]:
    nodes_arr = np.asarray(nodes_arr)
    reasons = np.asarray(reasons)
    if rows is None:
        rows = np.flatnonzero(nodes_arr < 0)
    else:
        rows = np.asarray(list(rows), np.int64)
    if not len(rows):
        return {}
    n, r = tensors.alloc.shape
    valid = (
        np.ones(n, bool) if node_valid is None else np.asarray(node_valid, bool)
    )
    req_pad = np.asarray(batch.req, np.float32)
    if req_pad.shape[1] < r:
        req_pad = np.pad(req_pad, ((0, 0), (0, r - req_pad.shape[1])))

    # free capacity on the valid nodes after every successful placement
    if free is None:
        placed = np.flatnonzero(nodes_arr >= 0)
        used = np.zeros((n, r), np.float32)
        np.add.at(used, nodes_arr[placed], req_pad[placed])
        free = tensors.alloc - used
    free = np.where(valid[:, None], np.asarray(free, np.float32), 0.0)

    demand = req_pad[rows].sum(axis=0)  # [r]
    free_total = free.sum(axis=0)
    free_max = free.max(axis=0) if n else np.zeros(r, np.float32)
    demand_max = req_pad[rows].max(axis=0)

    resources: List[Dict[str, object]] = []
    names = list(tensors.resource_names)
    binding = None
    binding_share = -1.0
    for i in range(r):
        if demand[i] <= 0:
            continue
        ft = float(free_total[i])
        share = float(demand[i]) / ft if ft > 0 else math.inf
        rec = {
            "resource": names[i] if i < len(names) else f"res[{i}]",
            "requested": float(demand[i]),
            "free": ft,
            "share": round(min(share, 1e9), 4),
            # fragmentation: the biggest single request vs the biggest
            # single free block — aggregate room that no one node offers
            "max_pod_request": float(demand_max[i]),
            "max_node_free": float(free_max[i]),
            "fragmented": bool(demand_max[i] > free_max[i] + 1e-6)
            and ft >= float(demand[i]),
        }
        resources.append(rec)
        if share > binding_share:
            binding_share = share
            binding = rec

    by_reason: Dict[str, int] = {}
    capacity_shaped = 0
    for code in reasons[rows].astype(int):
        by_reason[REASON_TEXT.get(code, "unschedulable")] = (
            by_reason.get(REASON_TEXT.get(code, "unschedulable"), 0) + 1
        )
        if code in _CAPACITY_SHAPED:
            capacity_shaped += 1

    doc: Dict[str, object] = {
        "unplaced": int(len(rows)),
        "by_reason": dict(sorted(by_reason.items(), key=lambda kv: -kv[1])),
        "capacity_shaped": int(capacity_shaped),
        "constraint_shaped": int(len(rows) - capacity_shaped),
        "resources": resources,
    }
    if binding is not None:
        doc["binding"] = dict(binding)

    if new_node is not None:
        doc["template"] = _template_verdict(
            batch, rows, new_node, daemon_sets, corrected_ds_overhead,
            demand, free_total, names,
        )
    return doc


def _template_verdict(
    batch, rows, new_node, daemon_sets, corrected, demand, free_total, names
) -> Dict[str, object]:
    """Fold the planners' can-never-help diagnosis over the unplaced set
    and size the deficit in template nodes (the what-to-buy hint)."""
    from ..core.match import node_should_run_pod
    from ..core.quantity import parse_quantity
    from ..plan.capacity import meet_resource_requests

    helpable = never = 0
    first_never = ""
    probe = rows[:_TEMPLATE_PROBE_CAP]
    for j in probe:
        pod = batch.pods[int(j)] if batch.pods else None
        if pod is None:
            continue
        if not node_should_run_pod(new_node, pod):
            never += 1
            if not first_never:
                first_never = "pod does not fit new node affinity or taints"
            continue
        if not meet_resource_requests(
            new_node, pod, list(daemon_sets), corrected=corrected
        ):
            never += 1
            if not first_never:
                first_never = (
                    "new node cannot meet resource requests of pod: the "
                    "total requested resource of daemonset pods in new "
                    "node is too large"
                )
            continue
        helpable += 1
    alloc = ((new_node.get("status") or {}).get("allocatable")) or {}
    nodes_hint = 0
    for rname in ("cpu", "memory"):
        if rname not in names:
            continue
        i = names.index(rname)
        cap = float(parse_quantity(alloc.get(rname)))
        deficit = float(demand[i]) - float(free_total[i])
        if cap > 0 and deficit > 0:
            nodes_hint = max(nodes_hint, int(math.ceil(deficit / cap)))
    out: Dict[str, object] = {
        "probed": int(len(probe)),
        "helpable": int(helpable),
        "never_helpable": int(never),
    }
    if len(probe) < len(rows):
        out["probe_truncated"] = int(len(rows) - len(probe))
    if first_never:
        out["never_reason"] = first_never
    if nodes_hint:
        out["template_nodes_hint"] = nodes_hint
    return out
