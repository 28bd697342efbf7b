"""Fractional assignment → integral candidate placement (the JAX
package's `solve/rounding.py`, copied).

Host-side (numpy, float64) on purpose: rounding touches [C, N] count
matrices, not [P, N] planes, so it is cheap — and the auditor will judge
the result against the raw tensorized inputs anyway, so there is nothing
to gain from doing it on device and something to lose (f32 thresholds).

The rule, per class row of the relaxed solution y:

1. floor     — take m = floor(y) pods on each node;
2. remainder — hand the class's remaining cnt - sum(m) pods out one each
   to the feasible nodes with the LARGEST fractional mass, ties broken
   toward the lower node index (lexsort on (node_index, -frac)), which
   makes the rounding deterministic for the tie-broken-masses test;
3. repair    — greedy local repair in exact arithmetic: while any node's
   f64 load exceeds its capacity, move one pod from it to the first
   feasible node with room.  Bounded by 2·pods + 10 moves; exhausting
   the budget (or finding no legal move) fails the round, which the
   planner reports as a rejection — never a garbage placement.

Order-safety: requests are non-negative, so if the END state fits on
every node, every prefix of a batch-row-ordered placement fits too —
the rounded counts expand to a pod→node vector that passes the
auditor's conservation replay without any per-step search.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .relax import RelaxProblem


def round_candidate(
    prob: RelaxProblem, y: np.ndarray, valid: np.ndarray
) -> Tuple[Optional[np.ndarray], str]:
    """Round one candidate's fractional assignment to integral per-class
    node counts.  Returns (m [C, N] int64, "") on success or
    (None, reason) when no repair within budget produces a load that fits
    — the planner treats that as a rejected solve, not an infeasibility
    claim (only the certificate may claim infeasibility)."""
    c, n = y.shape if y.ndim == 2 else (0, prob.cap_raw.shape[0])
    valid = np.asarray(valid, bool)
    cnt = np.array([len(rows) for rows in prob.cls_rows], np.int64)
    if c == 0:
        return np.zeros((0, n), np.int64), ""

    feas = prob.feas & valid[None, :]
    y = np.where(feas, np.maximum(np.asarray(y, np.float64), 0.0), 0.0)
    m = np.floor(y + 1e-9).astype(np.int64)
    frac = y - m

    for ci in range(c):
        d = int(cnt[ci] - m[ci].sum())
        order = np.lexsort((np.arange(n), -frac[ci]))
        order = order[feas[ci][order]]
        if d > 0 and order.size == 0:
            return None, "no_feasible_node"
        k = 0
        while d > 0:  # hand out remainders, largest fraction first
            m[ci, order[k % order.size]] += 1
            d -= 1
            k += 1
        while d < 0:  # float overshoot: pull back smallest occupied mass
            occ = np.flatnonzero(m[ci] > 0)
            j = occ[np.argsort(frac[ci][occ], kind="stable")[0]]
            m[ci, j] -= 1
            d += 1

    req = prob.req_raw  # [C, R] f64, unscaled
    cap = prob.cap_raw * valid[:, None]
    load = np.einsum("cn,cr->nr", m.astype(np.float64), req)
    load += prob.fixed_raw * valid[:, None]
    tol = prob.scale * 1e-9

    moves, budget = 0, int(cnt.sum()) * 2 + 10
    while True:
        over = np.flatnonzero(np.any(load > cap + tol, axis=1))
        if over.size == 0:
            return m, ""
        if moves >= budget:
            return None, "repair_budget"
        nj = int(over[0])
        moved = False
        for ci in np.flatnonzero(m[:, nj] > 0):
            fits = np.all(load + req[ci][None, :] <= cap + tol, axis=1)
            targets = np.flatnonzero(feas[ci] & fits)
            targets = targets[targets != nj]
            if targets.size:
                t = int(targets[0])
                m[ci, nj] -= 1
                m[ci, t] += 1
                load[nj] -= req[ci]
                load[t] += req[ci]
                moves += 1
                moved = True
                break
        if not moved:
            reason = "overfull_fixed" if not m[:, nj].any() else "repair_stuck"
            return None, reason


def nodes_from_counts(
    prob: RelaxProblem, pin: np.ndarray, m: np.ndarray
) -> np.ndarray:
    """Expand per-class node counts to the engine's pod→node vector.
    Free rows of each class are filled in batch-row order against the
    class's nodes in ascending node order (deterministic; pods within a
    class are interchangeable).  Pinned rows keep their pin — the caller
    masks phantom clone rows to -1 afterwards."""
    pin = np.asarray(pin)
    nodes = np.full(pin.shape[0], -1, np.int32)
    if len(prob.pinned_rows):
        nodes[prob.pinned_rows] = pin[prob.pinned_rows].astype(np.int32)
    for ci, rows in enumerate(prob.cls_rows):
        nodes[rows] = np.repeat(
            np.arange(m.shape[1], dtype=np.int32), m[ci]
        )
    return nodes
