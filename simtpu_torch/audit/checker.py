"""Independent placement auditor: trust-but-verify for emitted plans.

The port of the JAX package's `simtpu/audit/checker.py`. A SECOND
implementation of the feasibility semantics checks a finished placement
against the raw tensorized inputs (`core/tensorize.ClusterTensors` —
shared data, not shared code) without touching any engine scoring or
placement kernel: it never calls K1-K7 or the engine's statics.

What is certified (per placed pod, in placement order):

- node validity & pinning, resource conservation at each step, Open-Local
  storage, GPU-share memory, host ports, exclusive volumes and attach
  limits — the bulk pass, K8 `audit_bulk` on the card
  (`kernels/audit.py`), its plain PyTorch version on the CPU;
- required inter-pod affinity/anti-affinity (both directions, with the
  first-pod-in-series escape) and DoNotSchedule topology spread, against
  the prefix state — host numpy, sorted-event prefix counts and the
  rank-threshold minimum, as in the JAX package;
- preemption legality (Simulator runs): every victim strictly lower
  priority than its preemptor, the preemptor placed, no victim both
  evicted and placed;
- all-or-nothing completeness when the caller claims it (`require_all`).

The bulk pass runs on the device the simulation ran on; its inputs are
uploaded from `ClusterTensors` once per audit, and the report times the
upload, the bulk pass and the host checks apart (`AuditReport.split`).
Violation reports carry witnesses (pod, node, constraint class, the
numbers that prove the violation); `AuditReport.counters()` is the
machine-readable summary the planner surfaces under ``engine.audit``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.audit import BULK_BITS, AuditInputs, audit_bulk

#: violations stored verbatim per report; everything beyond is counted only
MAX_VIOLATIONS = 64

# constraint classes (Violation.kind)
K_UNPLACED = "unplaced"
K_INVALID_NODE = "invalid-node"
K_OVERCOMMIT = "overcommit"
K_PORT = "port-conflict"
K_VOLUME = "volume-conflict"
K_ATTACH = "attach-limit"
K_STORAGE = "storage"
K_GPU = "gpu"
K_ANTI_AFFINITY = "anti-affinity"
K_AFFINITY = "affinity"
K_SPREAD = "spread"
K_PREEMPTION = "preemption"

#: bit positions in the bulk pass's per-entry flag word — host-side
#: witness extraction decodes these (K8 and its plain version share them)
_BULK_BITS = (
    K_INVALID_NODE,
    K_OVERCOMMIT,
    K_PORT,
    K_VOLUME,
    K_ATTACH,
    K_STORAGE,
    K_GPU,
)
assert _BULK_BITS == BULK_BITS


@dataclass
class Violation:
    """One certified constraint violation, with its witness numbers."""

    kind: str  # constraint class (K_* above)
    row: int  # batch row / log position of the offending pod (-1 n/a)
    pod: str = ""  # pod name when known
    node: int = -1  # landing node index (-1 n/a)
    node_name: str = ""
    witness: Dict[str, object] = field(default_factory=dict)

    def describe(self) -> str:
        wit = ", ".join(f"{k}={v}" for k, v in self.witness.items())
        where = self.node_name or (str(self.node) if self.node >= 0 else "-")
        who = self.pod or (f"row {self.row}" if self.row >= 0 else "-")
        return f"[{self.kind}] pod {who} on node {where}" + (
            f" ({wit})" if wit else ""
        )


@dataclass
class AuditReport:
    """Outcome of one audit pass."""

    ok: bool
    checked: int  # placed pods audited
    total: int = 0  # total violations (violations list is capped)
    violations: List[Violation] = field(default_factory=list)
    by_class: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0
    mode: str = "cuda"  # "cuda" (K8 on the card) | "plain" (its CPU version)
    #: seconds of the pass's parts: "upload" (inputs to the device),
    #: "bulk" (K8 or its plain version, flags back on the host), "host"
    #: (witnesses and the interpod/spread checks)
    split: Dict[str, float] = field(default_factory=dict)

    def add(self, v: Violation) -> None:
        self.ok = False
        self.total += 1
        self.by_class[v.kind] = self.by_class.get(v.kind, 0) + 1
        if len(self.violations) < MAX_VIOLATIONS:
            self.violations.append(v)

    #: per-violation witness records carried into counters()/--json; the
    #: stored list is already capped at MAX_VIOLATIONS, this caps the doc
    DETAIL_CAP = 16

    def counters(self) -> Dict[str, object]:
        """Machine-readable summary (CLI --json `engine.audit`, bench).
        Dirty reports carry the first DETAIL_CAP witnessed violations
        verbatim — pod, node, constraint class, witness numbers — so the
        --json consumer sees WHAT failed, not only how many."""
        doc: Dict[str, object] = {
            "ok": self.ok,
            "checked": self.checked,
            "violations": self.total,
            "by_class": dict(self.by_class),
            "wall_s": round(self.wall_s, 4),
            "mode": self.mode,
        }
        if not self.ok:
            doc["detail"] = [
                {
                    "class": v.kind,
                    "pod": v.pod or f"row {v.row}",
                    "node": v.node_name or (str(v.node) if v.node >= 0 else ""),
                    "witness": {k: str(w) for k, w in v.witness.items()},
                }
                for v in self.violations[: self.DETAIL_CAP]
            ]
        return doc

    def summary(self) -> str:
        if self.ok:
            return f"audit: clean ({self.checked} placements certified)"
        by = ", ".join(f"{k}×{n}" for k, n in sorted(self.by_class.items()))
        return (
            f"audit: {self.total} violation(s) over {self.checked} "
            f"placements ({by})"
        )


# ---------------------------------------------------------------------------
# Entry assembly — the audit's own view of one finished placement
# ---------------------------------------------------------------------------


@dataclass
class _Entries:
    """Placed-pod arrays in PLACEMENT ORDER (the sequential checks replay
    prefixes over this order — batch order for engine-level placements,
    log order for Simulator runs whose log saw preemption surgery)."""

    g: np.ndarray  # [M] group
    n: np.ndarray  # [M] landing node
    req: np.ndarray  # [M, R] padded request rows
    forced: np.ndarray  # [M] bound via spec.nodeName (filters bypassed)
    pin: np.ndarray  # [M] required node (-1 unpinned, -2 nonexistent)
    lvm: np.ndarray  # [M, V] VG allocation
    sdev: np.ndarray  # [M, SD] exclusive-device takes
    gpu: np.ndarray  # [M, GD] device memory load (shares × mem)
    rows: np.ndarray  # [M] original batch row / log position (reporting)
    names: Optional[List[str]] = None  # pod names, parallel (reporting)


def _pad_req(req: np.ndarray, r: int) -> np.ndarray:
    if req.shape[1] < r:
        req = np.pad(req, ((0, 0), (0, r - req.shape[1])))
    return np.asarray(req, np.float64)


def _entries_from_batch(tensors, batch, nodes, ext) -> _Entries:
    nodes = np.asarray(nodes)
    placed = np.flatnonzero(nodes >= 0)
    r = tensors.alloc.shape[1]
    m = len(placed)
    v = tensors.ext.vg_cap.shape[1]
    sd = tensors.ext.sdev_cap.shape[1]
    gd = tensors.ext.gpu_dev_total.shape[1]
    if ext is not None:
        lvm = np.asarray(ext["lvm_alloc"], np.float64)[placed]
        sdev = np.asarray(ext["dev_take"], bool)[placed]
        gpu = (
            np.asarray(ext["gpu_shares"], np.float64)[placed]
            * np.asarray(batch.ext["gpu_mem"], np.float64)[placed, None]
        )
    else:
        lvm = np.zeros((m, v))
        sdev = np.zeros((m, sd), bool)
        gpu = np.zeros((m, gd))
    names = None
    if batch.pods:
        names = [
            (batch.pods[int(i)].get("metadata") or {}).get("name", "")
            for i in placed
        ]
    return _Entries(
        g=np.asarray(batch.group, np.int64)[placed],
        n=nodes[placed].astype(np.int64),
        req=_pad_req(np.asarray(batch.req, np.float64)[placed], r),
        forced=np.asarray(batch.forced, bool)[placed],
        pin=np.asarray(batch.pin, np.int64)[placed],
        lvm=lvm,
        sdev=sdev,
        gpu=gpu,
        rows=placed,
        names=names,
    )


# ---------------------------------------------------------------------------
# Segmented prefix algebra (numpy, for witnesses)
# ---------------------------------------------------------------------------


def _by_node_order(n: np.ndarray) -> np.ndarray:
    """Stable order grouping entries by node, placement order within."""
    return np.argsort(n, kind="stable")


def _prefix_within(order: np.ndarray, n: np.ndarray, cols: np.ndarray):
    """Exclusive per-node prefix sums of `cols` along placement order.

    Returns [M, C] in ORIGINAL entry order: row j holds the column sums of
    all earlier-placed entries on the same node."""
    m = len(order)
    out = np.zeros_like(cols, dtype=np.float64)
    if not m:
        return out
    c = np.asarray(cols, np.float64)[order]
    ns = n[order]
    cum = np.cumsum(c, axis=0)
    excl = cum - c
    seg_start = np.concatenate([[True], ns[1:] != ns[:-1]])
    first = np.maximum.accumulate(np.where(seg_start, np.arange(m), 0))
    out[order] = excl - excl[first]
    return out


# ---------------------------------------------------------------------------
# Bulk checks — K8 on the card, its plain version on the CPU
# ---------------------------------------------------------------------------


def _upload(tensors, e: _Entries, node_valid: np.ndarray, device) -> AuditInputs:
    """The bulk pass's inputs from the frozen ClusterTensors and the
    entries, on `device` (one host-to-device copy each)."""
    ext = tensors.ext

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    f64, b, i64 = torch.float64, torch.bool, torch.int64
    return AuditInputs(
        alloc=put(np.asarray(tensors.alloc, np.float64), f64),
        static_mask=put(np.asarray(tensors.static_mask, bool), b),
        vol_mask=put(np.asarray(tensors.vol_mask, bool), b),
        node_valid=put(np.asarray(node_valid, bool), b),
        ports=put(np.asarray(tensors.ports, bool), b),
        vol_rw=put(np.asarray(tensors.vol_rw, bool), b),
        vol_ro=put(np.asarray(tensors.vol_ro, bool), b),
        vol_att=put(np.asarray(tensors.vol_att, bool), b),
        vol_class_mask=put(np.asarray(tensors.vol_class_mask, np.float64), f64),
        attach_limits=put(np.asarray(tensors.attach_limits, np.float64), f64),
        vg_avail0=put((ext.vg_cap - ext.vg_req0).astype(np.float64), f64),
        sdev_free0=put((ext.sdev_cap > 0) & ~ext.sdev_alloc0, b),
        gpu_total=put(ext.gpu_dev_total.astype(np.float64), f64),
        g=put(e.g.astype(np.int64), i64),
        n=put(e.n.astype(np.int64), i64),
        req=put(e.req, f64),
        forced=put(e.forced, b),
        pin=put(e.pin.astype(np.int64), i64),
        lvm=put(np.asarray(e.lvm, np.float64), f64),
        sdev=put(np.asarray(e.sdev, bool), b),
        gpu=put(np.asarray(e.gpu, np.float64), f64),
    )


def bulk_flags(
    tensors, e: _Entries, node_valid: np.ndarray, device,
    split: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Per-entry violation flag word (bits per _BULK_BITS) on `device`;
    `split` receives the upload's and the bulk pass's seconds."""
    split = {} if split is None else split
    n, g = tensors.alloc.shape[0], tensors.static_mask.shape[0]
    if len(e.n) and (e.n.min() < 0 or e.n.max() >= n or e.g.min() < 0 or e.g.max() >= g):
        raise ValueError(f"audit: entries outside the {n} nodes or {g} groups")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    x = _upload(tensors, e, node_valid, device)
    sync()
    t1 = time.perf_counter()
    flags = audit_bulk(x).cpu().numpy().astype(np.int64)
    split["upload"] = t1 - t0
    split["bulk"] = time.perf_counter() - t1
    return flags


# ---------------------------------------------------------------------------
# Order-dependent interpod / spread checks (sorted-event prefix algebra)
# ---------------------------------------------------------------------------


def _term_events(tensors, e: _Entries, t: int, incid: np.ndarray):
    """(positions, domains) of entries carrying `incid` for term t, on
    nodes that carry the term's topology key (the engine only counts
    those — cnt_total semantics)."""
    k = int(tensors.term_topo_key[t])
    dom = np.asarray(tensors.node_dom[k], np.int64)
    d = dom[e.n]
    hit = incid[e.g] & (d >= 0)
    pos = np.flatnonzero(hit)
    return pos, d[pos], dom


def _count_before(ev_pos, ev_dom, q_pos, q_dom):
    """#events with domain == q_dom and position < q_pos, per query —
    one composite-key searchsorted (events are position-sorted within a
    domain after the stable composite sort)."""
    m_key = max(int(ev_pos.max(initial=0)), int(q_pos.max(initial=0))) + 2
    ev_key = np.sort(ev_dom.astype(np.int64) * m_key + ev_pos)
    lo = np.searchsorted(ev_key, q_dom.astype(np.int64) * m_key)
    hi = np.searchsorted(ev_key, q_dom.astype(np.int64) * m_key + q_pos)
    return hi - lo


def _interpod_spread_checks(
    tensors, e: _Entries, node_valid: np.ndarray, report: AuditReport
) -> None:
    """Required (anti-)affinity and DoNotSchedule spread, replayed over
    the placement order with the engine's exact predicate semantics
    (`kernels/filters.py interpod_filter` / `topology_spread_filter`)."""
    t_n = tensors.n_terms
    m = len(e.n)
    if not t_n or not m:
        return
    a_aff = np.asarray(tensors.a_aff_req, bool)
    a_anti = np.asarray(tensors.a_anti_req, bool)
    s_match = np.asarray(tensors.s_match, bool)
    sp_hard = np.asarray(tensors.spread_hard, np.float64)
    static = np.asarray(tensors.static_mask, bool)
    nv = np.asarray(node_valid, bool)
    soft_rows = np.flatnonzero(~e.forced)

    def _viol(kind, j, t, **wit):
        report.add(
            Violation(
                kind=kind,
                row=int(e.rows[j]),
                pod=e.names[j] if e.names else "",
                node=int(e.n[j]),
                node_name=tensors.node_names[int(e.n[j])],
                witness={"term": int(t), **wit},
            )
        )

    # ---- anti-affinity: own terms + the symmetric direction -------------
    anti_terms = np.flatnonzero(a_anti.any(axis=0))
    for t in anti_terms:
        ev_pos, ev_dom, dom = _term_events(tensors, e, t, s_match[:, t])
        own_pos, own_dom, _ = _term_events(tensors, e, t, a_anti[:, t])
        d_q = dom[e.n]
        # pods owning the term: no earlier matching pod in the domain
        q = soft_rows[a_anti[e.g[soft_rows], t] & (d_q[soft_rows] >= 0)]
        if len(q) and len(ev_pos):
            cnt = _count_before(ev_pos, ev_dom, q, d_q[q])
            for idx in np.flatnonzero(cnt > 0):
                _viol(
                    K_ANTI_AFFINITY, int(q[idx]), t,
                    matching_in_domain=int(cnt[idx]),
                )
        # pods MATCHING the term: no earlier owner in the domain
        q = soft_rows[s_match[e.g[soft_rows], t] & (d_q[soft_rows] >= 0)]
        if len(q) and len(own_pos):
            cnt = _count_before(own_pos, own_dom, q, d_q[q])
            for idx in np.flatnonzero(cnt > 0):
                _viol(
                    K_ANTI_AFFINITY, int(q[idx]), t,
                    owners_in_domain=int(cnt[idx]),
                )

    # ---- required affinity (with the first-pod-in-series escape) --------
    aff_groups = np.flatnonzero(a_aff.any(axis=1))
    if len(aff_groups):
        aff_terms = np.flatnonzero(a_aff.any(axis=0))
        events = {
            int(t): _term_events(tensors, e, t, s_match[:, t])
            for t in aff_terms
        }
        for j in soft_rows:
            g = int(e.g[j])
            terms = np.flatnonzero(a_aff[g])
            if not len(terms):
                continue
            sat = True
            total_before = 0
            missing = -1
            for t in terms:
                ev_pos, ev_dom, dom = events[int(t)]
                d_j = dom[e.n[j]]
                total_before += int(np.searchsorted(np.sort(ev_pos), j))
                if d_j < 0:
                    sat, missing = False, int(t)
                    continue
                cnt = _count_before(
                    ev_pos, ev_dom, np.array([j]), np.array([d_j])
                )[0]
                if cnt == 0:
                    sat, missing = False, int(t)
            if sat:
                continue
            # escape: no matching pod anywhere yet, pod matches its own
            # terms, and the node carries every topology key
            keys_ok = all(
                events[int(t)][2][e.n[j]] >= 0 for t in terms
            )
            self_ok = bool(np.all(s_match[g, terms]))
            if total_before == 0 and self_ok and keys_ok:
                continue
            _viol(K_AFFINITY, j, missing, matching_before=total_before)

    # ---- DoNotSchedule topology spread ----------------------------------
    hard_pairs = np.argwhere(sp_hard > 0)
    by_term: Dict[int, List[int]] = {}
    for g, t in hard_pairs:
        by_term.setdefault(int(t), []).append(int(g))
    for t, groups in by_term.items():
        ev_pos, ev_dom, dom = _term_events(tensors, e, t, s_match[:, t])
        d_q = dom[e.n]
        for g in groups:
            skew = float(sp_hard[g, t])
            q = soft_rows[(e.g[soft_rows] == g)]
            if not len(q):
                continue
            missing_key = q[d_q[q] < 0]
            for j in missing_key:
                _viol(K_SPREAD, j, t, reason="node lacks topology key")
            q = q[d_q[q] >= 0]
            if not len(q):
                continue
            # eligible domains: those containing >= 1 node passing the
            # pod's static filters (pinned pods audited per-pod below)
            elig_nodes = static[g] & nv
            cnt_q = _count_before(ev_pos, ev_dom, q, d_q[q])
            for idx, j in enumerate(q):
                pin = int(e.pin[j])
                en = elig_nodes
                if pin >= 0:
                    en = np.zeros_like(elig_nodes)
                    en[pin] = elig_nodes[pin]
                min_c = _min_over_eligible(dom, en, ev_pos, ev_dom, int(j))
                if cnt_q[idx] + 1.0 - min_c > skew + 1e-9:
                    _viol(
                        K_SPREAD, j, t,
                        count=int(cnt_q[idx]), min_eligible=int(min_c),
                        max_skew=int(skew),
                    )


def _min_over_eligible(
    dom: np.ndarray, elig_nodes: np.ndarray, ev_pos: np.ndarray,
    ev_dom: np.ndarray, before: int,
) -> int:
    """min over eligible domains of the matching-pod count strictly before
    placement position `before` — the rank-threshold formulation: the min
    reaches v+1 exactly when the LAST eligible domain gains its (v+1)-th
    event, so min(i) = #{v : t_v < i} with t_v the max over domains of the
    rank-v event position."""
    E = np.unique(dom[(dom >= 0) & elig_nodes])
    if not len(E):
        return 0
    in_e = np.isin(ev_dom, E) & (ev_pos < before)
    d_e, p_e = ev_dom[in_e], ev_pos[in_e]
    if not len(d_e):
        return 0
    per_dom = np.zeros(len(E), np.int64)
    comp = np.searchsorted(E, d_e)
    np.add.at(per_dom, comp, 1)
    c_star = int(per_dom.min())
    if c_star == 0:
        return 0
    order = np.lexsort((p_e, comp))
    comp_s, pos_s = comp[order], p_e[order]
    seg_start = np.concatenate([[True], comp_s[1:] != comp_s[:-1]])
    first = np.maximum.accumulate(
        np.where(seg_start, np.arange(len(comp_s)), 0)
    )
    rank = np.arange(len(comp_s)) - first
    t_v = np.zeros(c_star, np.int64)
    keep = rank < c_star
    np.maximum.at(t_v, rank[keep], pos_s[keep])
    return int(np.searchsorted(t_v, before, side="left"))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def audit_placement(
    tensors,
    batch,
    nodes,
    ext: Optional[dict] = None,
    node_valid: Optional[np.ndarray] = None,
    require_all: bool = False,
    expect_mask: Optional[np.ndarray] = None,
    entries: Optional[_Entries] = None,
    device=None,
) -> AuditReport:
    """Audit one finished engine-level placement.

    `nodes` is the [P] landing-node vector `Engine.place` returned for
    `batch` (-1 = unplaced), `ext` the matching extras dict
    (`lvm_alloc`/`dev_take`/`gpu_shares`, per batch row).  `node_valid`
    is the candidate-cluster mask the placement ran under.  With
    `require_all`, every row of `expect_mask` (default: all rows) that is
    unplaced is a completeness violation — the all-or-nothing contract of
    an ACCEPTED capacity candidate.  `entries` substitutes a pre-built
    placement-order view (the Simulator path).  The bulk pass runs on
    `device` (None = the CUDA card, as every entry point of the port).
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    n = tensors.alloc.shape[0]
    nv = (
        np.ones(n, bool)
        if node_valid is None
        else np.asarray(node_valid, bool)
    )
    e = entries if entries is not None else _entries_from_batch(
        tensors, batch, nodes, ext
    )
    report = AuditReport(
        ok=True, checked=len(e.n), mode="cuda" if device.type == "cuda" else "plain"
    )

    if require_all:
        nodes_a = np.asarray(nodes)
        exp = (
            np.ones(len(nodes_a), bool)
            if expect_mask is None
            else np.asarray(expect_mask, bool)
        )
        for j in np.flatnonzero((nodes_a < 0) & exp):
            name = ""
            if batch is not None and batch.pods:
                name = (batch.pods[int(j)].get("metadata") or {}).get("name", "")
            report.add(
                Violation(
                    kind=K_UNPLACED, row=int(j), pod=name,
                    witness={"claimed": "all-or-nothing"},
                )
            )

    flags = bulk_flags(tensors, e, nv, device, report.split)
    t1 = time.perf_counter()
    if flags.any():
        _decode_bulk(tensors, e, nv, flags, report)
    _interpod_spread_checks(tensors, e, nv, report)
    t2 = time.perf_counter()
    report.split["host"] = t2 - t1
    report.wall_s = t2 - t0
    return report


def _decode_bulk(
    tensors, e: _Entries, nv: np.ndarray, flags: np.ndarray,
    report: AuditReport,
) -> None:
    """Turn bulk flag bits into witnessed Violations (host side; flagged
    rows are few, so the witness recomputation is per-row numpy)."""
    ext = tensors.ext
    order = _by_node_order(e.n)
    used = _prefix_within(order, e.n, e.req)
    for bit, kind in enumerate(_BULK_BITS):
        rows = np.flatnonzero((flags >> bit) & 1)
        for j in rows:
            wit: Dict[str, object] = {}
            node = int(e.n[j])
            if kind == K_INVALID_NODE:
                g = int(e.g[j])
                wit = {
                    "static_mask": bool(tensors.static_mask[g, node]),
                    "vol_mask": bool(tensors.vol_mask[g, node]),
                    "node_valid": bool(nv[node]),
                    "pin": int(e.pin[j]),
                    "forced": bool(e.forced[j]),
                }
            elif kind == K_OVERCOMMIT:
                alloc = np.asarray(tensors.alloc, np.float64)[node]
                free = alloc - used[j]
                r_bad = int(np.argmax(e.req[j] - free))
                wit = {
                    "resource": tensors.resource_names[r_bad],
                    "request": float(e.req[j, r_bad]),
                    "free_at_step": float(free[r_bad]),
                    "allocatable": float(alloc[r_bad]),
                }
            elif kind == K_GPU:
                wit = {"gpu_load": float(e.gpu[j].sum())}
            elif kind == K_STORAGE:
                wit = {"lvm": float(e.lvm[j].sum()), "sdev": int(e.sdev[j].sum())}
            report.add(
                Violation(
                    kind=kind,
                    row=int(e.rows[j]),
                    pod=e.names[j] if e.names else "",
                    node=node,
                    node_name=tensors.node_names[node],
                    witness=wit,
                )
            )


def simulation_entries(sim):
    """(tensors, entries) of a live `Simulator`: the tensorizer's frozen
    ClusterTensors and the engine placement log in LOG order (preemption
    surgery reorders it), with each entry's pin and forced flag."""
    from ..core.objects import name_of
    from ..core.tensorize import _group_of_pod

    eng = sim._engine
    tz = sim._tensorizer
    tensors = tz.freeze()
    r = tensors.alloc.shape[1]
    m = len(eng.placed_node)
    ext_log = eng.ext_log
    pins = np.full(m, -1, np.int64)
    names: List[str] = []
    for i, pod in enumerate(sim._scheduled):
        names.append(name_of(pod))
        if sim._placed_forced[i]:
            pins[i] = eng.placed_node[i]
            continue
        _, pin_name = _group_of_pod(pod)
        if pin_name is not None:
            pins[i] = tz.node_idx.get(pin_name, -2)
    gpu_mem = (
        np.asarray(ext_log["gpu_mem"], np.float64)
        if m
        else np.zeros(0)
    )
    e = _Entries(
        g=np.asarray(eng.placed_group, np.int64),
        n=np.asarray(eng.placed_node, np.int64),
        req=_pad_req(eng.log_req_matrix(r), r),
        forced=np.asarray(sim._placed_forced, bool),
        pin=pins,
        lvm=(
            np.asarray(ext_log["vg_alloc"], np.float64)
            if m
            else np.zeros((0, tensors.ext.vg_cap.shape[1]))
        ),
        sdev=(
            np.asarray(ext_log["sdev_take"], bool)
            if m
            else np.zeros((0, tensors.ext.sdev_cap.shape[1]), bool)
        ),
        gpu=(
            np.asarray(ext_log["gpu_shares"], np.float64) * gpu_mem[:, None]
            if m
            else np.zeros((0, tensors.ext.gpu_dev_total.shape[1]))
        ),
        rows=np.arange(m),
        names=names,
    )
    return tensors, e


def audit_simulation(sim, inject: bool = False) -> AuditReport:
    """Audit a live `Simulator`'s full state: the engine placement log (in
    LOG order — preemption surgery reorders it) plus preemption legality
    over `sim._preempted`.  `inject` corrupts the audit's OWN view of the
    log (the planner's `_audit_inject` lever): the shipped result is untouched,
    but the audit fails as if the engine had diverged, driving the
    fallback path end-to-end.  The bulk pass runs on the simulator's
    device."""
    from ..core.objects import name_of, namespace_of, pod_priority

    tensors, e = simulation_entries(sim)
    m = len(e.n)
    if inject and m:
        static = np.asarray(tensors.static_mask, bool)
        for j in np.flatnonzero(~e.forced):
            bad = np.flatnonzero(~static[int(e.g[j])])
            if len(bad):
                e.n[j] = int(bad[0])
                break
        else:
            if m > 1:
                e.n[:] = e.n[0]  # all-pass masks: force overcommit
    node_valid = sim._engine.node_valid
    report = audit_placement(
        tensors, None, e.n, node_valid=node_valid, entries=e, device=sim._device
    )

    # ---- preemption legality --------------------------------------------
    placed_by_key: Dict[str, List[int]] = {}
    for i, pod in enumerate(sim._scheduled):
        placed_by_key.setdefault(
            f"{namespace_of(pod)}/{name_of(pod)}", []
        ).append(i)
    for pre in sim._preempted:
        vkey = f"{namespace_of(pre.pod)}/{name_of(pre.pod)}"
        owners = placed_by_key.get(pre.preempted_by)
        vict_prio = pod_priority(pre.pod)
        if not owners:
            report.add(
                Violation(
                    kind=K_PREEMPTION, row=-1, pod=vkey,
                    witness={
                        "reason": "preemptor not placed",
                        "preemptor": pre.preempted_by,
                    },
                )
            )
            continue
        pre_prio = max(sim._placed_prio[i] for i in owners)
        if not vict_prio < pre_prio:
            report.add(
                Violation(
                    kind=K_PREEMPTION, row=-1, pod=vkey,
                    witness={
                        "reason": "victim not strictly lower priority",
                        "victim_priority": vict_prio,
                        "preemptor_priority": pre_prio,
                        "preemptor": pre.preempted_by,
                    },
                )
            )
        if vkey in placed_by_key:
            report.add(
                Violation(
                    kind=K_PREEMPTION, row=-1, pod=vkey,
                    witness={
                        "reason": "victim reported evicted but still placed",
                        "preemptor": pre.preempted_by,
                    },
                )
            )
    return report


def extras_from_log(pc) -> Dict[str, np.ndarray]:
    """Per-batch-row extras (`lvm_alloc`/`dev_take`/`gpu_shares`) rebuilt
    from a `PlacedCluster`'s engine ext log — the shape `audit_placement`
    consumes when the caller kept the log but not `place()`'s extras."""
    t = pc.tensors
    p = len(pc.nodes)
    ext = {
        "lvm_alloc": np.zeros((p, t.ext.vg_cap.shape[1])),
        "dev_take": np.zeros((p, t.ext.sdev_cap.shape[1]), bool),
        "gpu_shares": np.zeros((p, t.ext.gpu_dev_total.shape[1])),
    }
    rows = pc.log_row
    if len(rows):
        ext["lvm_alloc"][rows] = np.asarray(pc.engine.ext_log["vg_alloc"])
        ext["dev_take"][rows] = np.asarray(pc.engine.ext_log["sdev_take"])
        ext["gpu_shares"][rows] = np.asarray(pc.engine.ext_log["gpu_shares"])
    return ext


def audit_placed_cluster(pc, progress=None, inject: bool = False):
    """Audit a `PlacedCluster`'s base placement (the fault sweep's
    drain-from state) on its engine's device; on failure re-place through
    the serial exact engine (pod at a time, the wavefront off, the dense
    carry) and re-audit — the divergence-safe fallback at the sweep
    boundary. `inject` corrupts the audit's view of the primary placement
    (never the fallback's).

    Returns `(pc, audit_doc, hard_failure_message_or_None)`: `pc` is the
    certified cluster (the fallback's when the original failed its
    audit), `audit_doc` the machine-readable record the CLI surfaces."""
    from ..engine.scan import Engine
    from ..faults.drain import PlacedCluster

    say = progress or (lambda s: None)
    tensors, batch = pc.tensors, pc.batch
    device = pc.engine.device
    nodes = np.asarray(pc.nodes)
    nodes_aud = inject_divergence(tensors, batch, nodes) if inject else nodes
    rep = audit_placement(tensors, batch, nodes_aud, extras_from_log(pc),
                          node_valid=pc.engine.node_valid, device=device)
    if rep.ok:
        return pc, rep.counters(), None
    say(f"audit FAILED on the base placement ({rep.summary()}) — re-placing through the serial "
        "exact scan")
    fb = Engine(pc.tz, device)
    fb.node_valid = pc.engine.node_valid
    fb.speculate = False
    fb.compact = False
    fb.sched_config = pc.engine.sched_config
    nodes_f, reasons_f, _ = fb.place(batch)
    pc_f = PlacedCluster(tz=pc.tz, tensors=tensors, batch=batch, engine=fb, nodes=nodes_f,
                         reasons=reasons_f)
    rep_f = audit_placement(tensors, batch, pc_f.nodes, extras_from_log(pc_f),
                            node_valid=fb.node_valid, device=device)
    audit_doc = {
        **rep.counters(),
        "fallback": True,
        "fallback_audit": rep_f.counters(),
        "divergence": divergence_diagnostic(tensors, batch, nodes_aud, pc_f.nodes, rep),
    }
    if not rep_f.ok:
        return pc_f, audit_doc, (
            "audit failure: the base placement violates its claimed constraints and the "
            f"serial-exact fallback did not certify either ({rep_f.summary()})")
    audit_doc["ok"] = True
    return pc_f, audit_doc, None


# ---------------------------------------------------------------------------
# Test lever: injected divergence
# ---------------------------------------------------------------------------


def divergence_diagnostic(tensors, batch, bad_nodes, serial_nodes, report: AuditReport,
                          planes: Optional[List[str]] = None) -> Dict[str, object]:
    """The structured record of one caught divergence: the first pod whose
    audited placement differs from the serial-exact answer, the two
    landing nodes, the violation classes that tripped the audit, and (when
    the caller compared carries) the differing state planes."""
    bad = np.asarray(bad_nodes)
    good = np.asarray(serial_nodes)
    diff = np.flatnonzero(bad != good)
    first = int(diff[0]) if len(diff) else -1
    doc: Dict[str, object] = {
        "divergent_pods": int(len(diff)),
        "first_divergent_row": first,
        "violations": dict(report.by_class),
    }
    if first >= 0:
        if batch is not None and batch.pods:
            doc["first_divergent_pod"] = (batch.pods[first].get("metadata") or {}).get("name", "")
        bn, gn = int(bad[first]), int(good[first])
        doc["audited_node"] = tensors.node_names[bn] if bn >= 0 else "<unplaced>"
        doc["serial_node"] = tensors.node_names[gn] if gn >= 0 else "<unplaced>"
    if planes:
        doc["state_planes"] = list(planes)
    return doc


def inject_divergence(tensors, batch, nodes: np.ndarray) -> np.ndarray:
    """Corrupt one placement: move the first non-forced placed pod onto a
    node its static mask rejects (or, when every node passes, onto the
    most loaded node to force overcommit)."""
    nodes = np.asarray(nodes).copy()
    forced = np.asarray(batch.forced, bool)
    static = np.asarray(tensors.static_mask, bool)
    for j in np.flatnonzero((nodes >= 0) & ~forced):
        g = int(batch.group[j])
        bad = np.flatnonzero(~static[g])
        if len(bad):
            nodes[j] = int(bad[0])
            return nodes
    # all-pass masks: stack every placed pod onto one node → overcommit
    placed = np.flatnonzero((nodes >= 0) & ~forced)
    if len(placed) > 1:
        nodes[placed] = nodes[placed[0]]
    return nodes
