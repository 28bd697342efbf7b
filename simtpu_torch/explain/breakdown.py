"""Per-pod failure breakdowns: the kube-scheduler status string, exactly.

The port of the JAX package's `explain/breakdown.py`. kube-scheduler's
PodScheduled condition reads "0/N nodes are available: 3 Insufficient cpu,
5 node(s) had untolerated taint." — every node accounted to the filter
stage that eliminated it. The engine's fail code names only the FIRST
stage that emptied the candidate set; this module re-evaluates each
unplaced pod's whole filter cascade (the engine's own stage masks) against
a carried state and renders the per-stage split.

Semantics: the breakdown is evaluated against the state the caller hands
in — for `simulate(explain=...)`, `explain` and `--explain` the END-OF-RUN
carry, so the counts answer "why does this pod not fit the cluster as it
now stands". The recorded fail code (evaluated at the pod's attempt) stays
the headline reason; the breakdown's own first-failing stage is reported
beside it. Per-stage counts plus `feasible` always sum to the valid node
count.

The pass is K20 `explain_pass` (`kernels/csrc/explain_pass.cu`): one
launch per chunk of up to EXPLAIN_CHUNK runnable pods, one block per pod,
every block reading the one state. `explain_pass` decides by the device of
the state: a CPU state runs the plain version `explain_pass_plain` (the
textbook `filter_and_score`'s ten cascade masks, pod by pod), a CUDA state
launches the kernel. `numpy_breakdown` is the JAX package's pure-numpy
twin, copied: the independent oracle the tests pin both against.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.scan import (
    FAIL_NO_NODE,
    FILTER_CASCADE,
    OK,
    REASON_TEXT,
    StepBuffers,
    build_pod_arrays,
    filter_and_score,
    flags_from,
    statics_from,
)
from ..kernels import cuda

#: versions the `explain` block in `--json` — bump when the document layout
#: (stage keys, group fields, message grammar) changes
EXPLAIN_VERSION = 1

#: (stage key, failure code) in cascade order — FILTER_CASCADE with the
#: StepEval field names shortened. The final stage ("interpod", the cascade
#: default) owns every node the full mask chain eliminated last.
STAGES = tuple(
    (fld[2:] if fld != "m_all" else "interpod", code)
    for fld, code in FILTER_CASCADE
)

#: pods explained per K20 launch
EXPLAIN_CHUNK = 64

#: per-stage witness nodes recorded per pod (lowest-index eliminated)
WITNESS_K = 4


def _witness_cap(n: int, k: int) -> int:
    return max(1, min(int(k), int(n)))


# ---------------------------------------------------------------------------
# K20: the plain version, the buffers and the wrapper
# ---------------------------------------------------------------------------


def explain_pass_plain(statics, state, pods, flags, k: int):
    """Plain version of K20 over the pod tuple `pods` (build_pod_arrays'
    layout, one row per pod): per pod, `filter_and_score`'s ten cascade
    masks walked from `statics.node_valid`; per stage the count of alive
    nodes it eliminates and the lowest `k` of them (ascending, -1 pad), the
    count that survive every stage, and the fail code. Returns (counts
    [P, S], feasible [P], witnesses [P, S, k], fail_code [P]) int32 numpy."""
    cuda.count_plain("explain_pass")
    p = len(pods[0])
    s_n = len(FILTER_CASCADE)
    counts = np.zeros((p, s_n), np.int32)
    feas = np.zeros(p, np.int32)
    wits = np.full((p, s_n, k), -1, np.int32)
    codes = np.zeros(p, np.int32)
    device = statics.alloc.device
    for u in range(p):
        pod = (pods[0][u], torch.as_tensor(pods[1][u], device=device)) + tuple(a[u] for a in pods[2:])
        ev = filter_and_score(statics, state, pod, flags)
        alive = statics.node_valid
        for s, (fld, _code) in enumerate(FILTER_CASCADE):
            m = getattr(ev, fld)
            elim = alive & ~m
            counts[u, s] = int(elim.sum())
            first = torch.nonzero(elim).flatten()[:k].cpu().numpy()
            wits[u, s, : len(first)] = first
            alive = alive & m
        feas[u] = int(alive.sum())
        codes[u] = ev.fail_code()
    return counts, feas, wits, codes


class ExplainBuffers:
    """What K20 reads and writes for one chunk of P pods: the chunk's pod
    arrays (a StepBuffers over them), the statics and the state (read
    only), per-block copies of K1/K2/K5/K6's scratch, and the outputs.

    `stage`, `raw` and the plan scratch are the views of block 0, which the
    kernel's argument block points at (`kernels/cuda.py make_ctx`); the
    `*_s` tensors are the whole [P, ...] planes, block p's at row p."""

    def __init__(self, statics, state, pods, flags, k: int):
        buf = StepBuffers(statics, state, pods, flags)
        dev = buf.device
        p = buf.n_pods
        n = statics.alloc.shape[0]
        v, sd = statics.vg_cap.shape[1], statics.sdev_cap.shape[1]
        gd = state.gpu_free.shape[1]
        self.buf = buf
        self.device = dev
        self.k = k

        def z(*shape, dtype=torch.float32, fill=0):
            return torch.full((p,) + shape, fill, dtype=dtype, device=dev)

        scratch = {
            "stage": z(n, dtype=torch.uint8), "raw": z(4, n), "st_ok": z(n, dtype=torch.bool, fill=1),
            "st_alloc": z(n, v), "st_take": z(n, sd, dtype=torch.bool), "st_raw": z(n),
            "gpu_ok": z(n, dtype=torch.bool, fill=1), "gpu_sh": z(n, gd),
        }
        for name, plane in scratch.items():
            setattr(self, name + "_s", plane)
            setattr(buf, name, plane[0])
        s_n = len(FILTER_CASCADE)
        self.counts = torch.zeros((p, s_n), dtype=torch.int32, device=dev)
        self.feasible = torch.zeros(p, dtype=torch.int32, device=dev)
        self.witnesses = torch.full((p, s_n, k), -1, dtype=torch.int32, device=dev)
        self.fail_code = torch.zeros(p, dtype=torch.int32, device=dev)

    def outputs(self):
        """(counts, feasible, witnesses, fail_code) as int32 numpy."""
        return tuple(t.cpu().numpy().astype(np.int32)
                     for t in (self.counts, self.feasible, self.witnesses, self.fail_code))


def explain_pass(statics, state, pods, flags, k: int):
    """K20 (`kernels/csrc/explain_pass.cu`) over the pod tuple `pods`: one
    launch, one block per pod, for a state on the card; the plain version
    for one on the CPU. Returns what `explain_pass_plain` returns."""
    if state.free.device.type == "cpu":
        return explain_pass_plain(statics, state, pods, flags, k)
    eb = ExplainBuffers(statics, state, pods, flags, k)
    cuda.launch_explain_pass(eb)
    return eb.outputs()


# ---------------------------------------------------------------------------
# Pure-numpy twin (the count oracle the tests pin), copied from the JAX
# package: it mirrors the stage semantics on the HOST tensors over the full
# term axis — structurally different from the device pass (no per-group
# term compaction), so a compaction or indexing fault shows as a count
# mismatch. float32 like the device pass, so the epsilon comparisons agree.
# ---------------------------------------------------------------------------

_RES_EPS = np.float32(1e-5)
_BIG = np.float32(3.4e38)


def _np_lvm_fits(vg_free, vg_name_id, sizes, vg_ids):
    """numpy twin of kernels.storage.lvm_plan (fits mask only)."""
    n, v = vg_free.shape
    exists = vg_name_id >= 0
    has_any = exists.any(axis=1)
    fits = np.ones(n, bool)
    free = vg_free.astype(np.float32).copy()
    for i in range(sizes.shape[0]):
        size, vid = np.float32(sizes[i]), int(vg_ids[i])
        active = size > 0
        named = vid >= 0
        slot_named = exists & (vg_name_id == vid)
        has_named = slot_named.any(axis=1)
        eligible = exists & (free >= size)
        key = np.where(eligible, free, _BIG)
        slot_binpack = np.zeros((n, v), bool)
        slot_binpack[np.arange(n), np.argmin(key, axis=1)] = eligible.any(axis=1)
        slot = slot_named if named else slot_binpack
        room = (slot & (free >= size)).any(axis=1)
        ok = (has_named & room if named else eligible.any(axis=1))
        ok = ok & (vid != -2) & has_any
        take = slot & (free >= size)
        upd = np.where(active & ok[:, None] & take, size, np.float32(0.0))
        free = free - upd
        if active:
            fits = fits & ok
    return fits


def _np_device_fits(sdev_free, sdev_cap, sdev_media, sizes, medias):
    """numpy twin of kernels.storage.device_plan (fits mask only)."""
    n, sd = sdev_cap.shape
    fits = np.ones(n, bool)
    free = sdev_free.astype(bool).copy()
    for i in range(sizes.shape[0]):
        size, media = np.float32(sizes[i]), int(medias[i])
        active = size > 0
        eligible = free & (sdev_media == media) & (sdev_cap >= size)
        key = np.where(eligible, sdev_cap.astype(np.float32), _BIG)
        choice = np.argmin(key, axis=1)
        found = eligible.any(axis=1)
        sel = np.zeros((n, sd), bool)
        sel[np.arange(n), choice] = found
        sel = sel & active
        free = free & ~sel
        if active:
            fits = fits & found
    return fits


def _np_gpu_fits(gpu_free, dev_exists, gpu_total, mem, count, preset):
    """numpy twin of kernels.gpushare.gpu_plan (fits mask only)."""
    n, gd = gpu_free.shape
    mem = np.float32(mem)
    count = np.float32(count)
    is_gpu = mem > 0
    valid_req = count > 0
    free = np.where(dev_exists, gpu_free.astype(np.float32), np.float32(-1.0))
    per_dev = np.where(
        free >= mem,
        np.floor(free / np.maximum(mem, np.float32(1e-30))),
        np.float32(0.0),
    )
    cum = np.cumsum(per_dev, axis=1)
    prev = cum - per_dev
    greedy = np.clip(np.minimum(cum, count) - prev, 0.0, per_dev)
    fit1 = free >= mem
    key = np.where(fit1, free, _BIG)
    tight = np.zeros((n, gd), np.float32)
    tight[np.arange(n), np.argmin(key, axis=1)] = np.where(
        fit1.any(axis=1), np.float32(1.0), np.float32(0.0)
    )
    shares = tight if count == 1 else greedy
    enough = shares.sum(axis=1) >= count
    node_total_ok = gpu_total >= mem
    has_dev = dev_exists.any(axis=1)
    fits = np.where(is_gpu, node_total_ok & has_dev & valid_req & enough, True)
    if preset is not None and np.sum(preset) > 0:
        fits = np.where(is_gpu, node_total_ok & has_dev & valid_req, True)
    return fits.astype(bool)


def _np_spread_filter(cnt_at, valid, max_skew, elig_nodes):
    """numpy twin of kernels.filters.topology_spread_filter."""
    t, n = cnt_at.shape
    if t == 0:
        return np.ones(n, bool)
    active = max_skew > 0
    elig = valid & elig_nodes[None, :]
    inf = np.float32(3.4e38)
    min_cnt = np.min(np.where(elig, cnt_at, inf), axis=1)
    min_cnt = np.where(min_cnt >= inf, np.float32(0.0), min_cnt)
    ok = (~active[:, None]) | (
        valid & (cnt_at + np.float32(1.0) - min_cnt[:, None] <= max_skew[:, None])
    )
    return ok.all(axis=0)


def _np_interpod_filter(cnt_at, own_anti_at, valid, cnt_total, s_match, a_aff, a_anti):
    """numpy twin of kernels.filters.interpod_filter."""
    t, n = cnt_at.shape
    if t == 0:
        return np.ones(n, bool)
    anti_violated = (a_anti[:, None] & (cnt_at > 0)).any(axis=0)
    sym_violated = (s_match[:, None] & (own_anti_at > 0)).any(axis=0)
    aff_ok = ((~a_aff[:, None]) | (valid & (cnt_at > 0))).all(axis=0)
    # first-pod-in-series escape: no matching pod anywhere for any required
    # term AND the pod matches all its own terms AND the node carries every
    # required topology key
    total_match = np.sum(np.where(a_aff, cnt_total, np.float32(0.0)))
    self_ok = (
        (total_match == 0)
        & np.all(np.where(a_aff, s_match, True))
        & ((~a_aff[:, None]) | valid).all(axis=0)
    )
    aff_ok = aff_ok | (a_aff.any() & self_ok)
    return aff_ok & ~anti_violated & ~sym_violated


def numpy_breakdown(tensors, batch, rows: np.ndarray, state_host, node_valid: np.ndarray, flags, k: int):
    """The twin pass: (counts [U, S], feasible [U], witnesses [U, S, k],
    fail_code [U]) from host numpy alone. `state_host` is a SchedState of
    numpy arrays (a fetched carry)."""
    from ..engine.state import interpod_term_index

    n = tensors.alloc.shape[0]
    t = tensors.n_terms
    ext = tensors.ext
    node_ids = np.arange(n)
    free = np.asarray(state_host.free, np.float32)
    ip_of = interpod_term_index(tensors)
    own_anti_full = np.zeros((t, n), np.float32)
    if t:
        cnt_own_anti = np.asarray(state_host.cnt_own_anti, np.float32)
        has_row = ip_of >= 0
        own_anti_full[has_row] = cnt_own_anti[ip_of[has_row]]
        cnt_match = np.asarray(state_host.cnt_match, np.float32)
        cnt_total = np.asarray(state_host.cnt_total, np.float32)
        dom_full = tensors.node_dom[tensors.term_topo_key]  # [T, N]
        valid_full = dom_full >= 0
    counts = np.zeros((len(rows), len(STAGES)), np.int32)
    feas = np.zeros(len(rows), np.int32)
    wits = np.full((len(rows), len(STAGES), k), -1, np.int32)
    codes = np.zeros(len(rows), np.int32)
    bext = batch.ext
    for u, r in enumerate(np.asarray(rows)):
        r = int(r)
        g = int(batch.group[r])
        req = np.asarray(batch.req[r], np.float32)
        if req.shape[0] < tensors.alloc.shape[1]:
            req = np.pad(req, (0, tensors.alloc.shape[1] - req.shape[0]))
        pin = int(batch.pin[r])
        pin_m = (node_ids == pin) if pin >= 0 else np.full(n, pin > -2)
        m_static = tensors.static_mask[g] & pin_m & node_valid

        m_ports = m_static
        if flags.ports and tensors.n_ports:
            want = tensors.ports[g]
            used = np.asarray(state_host.ports_used, np.float32)
            m_ports = m_static & ~((want[None, :] & (used > 0)).any(axis=1))

        slack = _RES_EPS * np.maximum(np.abs(free), np.float32(1.0))
        m_res = m_ports & np.all(free + slack >= req[None, :], axis=1)

        m_vol = m_res
        if flags.vols and tensors.n_vols:
            vols_any = np.asarray(state_host.vols_any, np.float32)
            vols_rw = np.asarray(state_host.vols_rw, np.float32)
            rw_conf = (tensors.vol_rw[g][None, :] & (vols_any > 0)).any(axis=1)
            ro_conf = (tensors.vol_ro[g][None, :] & (vols_rw > 0)).any(axis=1)
            m_vol = m_res & ~(rw_conf | ro_conf)

        m_att = m_vol
        if flags.attach and tensors.n_vols:
            vols_any = np.asarray(state_host.vols_any, np.float32)
            present = (vols_any > 0).astype(np.float32)
            cm = tensors.vol_class_mask.astype(np.float32)
            used_c = present @ cm.T
            new_c = (
                (np.float32(1.0) - present)
                * tensors.vol_att[g].astype(np.float32)[None, :]
            ) @ cm.T
            m_att = m_vol & np.all(
                (new_c == 0) | (used_c + new_c <= tensors.attach_limits), axis=1
            )

        m_bind = m_att & tensors.vol_mask[g]

        m_storage = m_bind
        if flags.storage:
            lvm_size = np.asarray(bext["lvm_size"][r], np.float32)
            dev_size = np.asarray(bext["dev_size"][r], np.float32)
            if (lvm_size > 0).any() or (dev_size > 0).any():
                lvm_ok = _np_lvm_fits(
                    np.asarray(state_host.vg_free, np.float32),
                    ext.vg_name_id,
                    lvm_size,
                    np.asarray(bext["lvm_vg"][r]),
                )
                dev_ok = _np_device_fits(
                    np.asarray(state_host.sdev_free),
                    ext.sdev_cap.astype(np.float32),
                    ext.sdev_media,
                    dev_size,
                    np.asarray(bext["dev_media"][r]),
                )
                m_storage = m_bind & ext.has_storage & lvm_ok & dev_ok

        m_gpu = m_storage
        if flags.gpu and float(bext["gpu_mem"][r]) > 0:
            m_gpu = m_storage & _np_gpu_fits(
                np.asarray(state_host.gpu_free, np.float32),
                ext.gpu_dev_total > 0,
                ext.gpu_total.astype(np.float32),
                float(bext["gpu_mem"][r]),
                float(bext["gpu_count"][r]),
                np.asarray(bext["gpu_preset"][r]),
            )

        m_spread = m_gpu
        if flags.spread_hard and t and (tensors.spread_hard[g] > 0).any():
            m_spread = m_gpu & _np_spread_filter(
                cnt_match, valid_full, tensors.spread_hard[g],
                tensors.static_mask[g] & pin_m & node_valid,
            )

        m_all = m_spread
        if flags.interpod_req and t:
            m_all = m_spread & _np_interpod_filter(
                cnt_match, own_anti_full, valid_full, cnt_total,
                tensors.s_match[g], tensors.a_aff_req[g], tensors.a_anti_req[g],
            )

        alive = node_valid.copy()
        cascade_masks = (
            m_static, m_ports, m_res, m_vol, m_att, m_bind,
            m_storage, m_gpu, m_spread, m_all,
        )
        code = STAGES[-1][1]
        for s, m in enumerate(cascade_masks):
            elim = alive & ~m
            counts[u, s] = int(elim.sum())
            first = node_ids[elim][:k]
            wits[u, s, : len(first)] = first
            alive = alive & m
        feas[u] = int(alive.sum())
        for s in range(len(cascade_masks) - 1, -1, -1):
            if not cascade_masks[s].any():
                code = STAGES[s][1]
        codes[u] = code
    return counts, feas, wits, codes


# ---------------------------------------------------------------------------
# Host driver + rendering
# ---------------------------------------------------------------------------


@dataclass
class FailureBreakdown:
    """One explanation pass's result over a set of unplaced pods."""

    n_nodes: int  # valid-node universe ("0/N nodes are available")
    rows: np.ndarray  # [U] batch row of each explained pod
    names: List[str]  # [U] "namespace/name"
    reasons: np.ndarray  # [U] RECORDED fail codes (the legacy headline)
    fail_code: np.ndarray  # [U] first-failing stage vs the explained state
    counts: np.ndarray  # [U, S] nodes eliminated per cascade stage
    feasible: np.ndarray  # [U] nodes surviving the whole cascade
    witnesses: np.ndarray  # [U, S, K] example node indices (-1 pad)
    node_names: List[str] = field(default_factory=list)
    mode: str = "cuda"  # the path the pass ran: cuda (K20) | cpu (its plain version)
    wall_s: float = 0.0

    def __len__(self) -> int:
        return len(self.rows)

    def headline(self, i: int) -> str:
        """The legacy reason — REASON_TEXT of the recorded fail code,
        bit-equal to what the placement report already prints."""
        return REASON_TEXT.get(int(self.reasons[i]), "unschedulable")

    def status(self, i: int) -> str:
        """The kube-scheduler-style status string: per-stage elimination
        counts in cascade order, each rendered with the stage's
        REASON_TEXT — so the entry for the first failing stage reads
        exactly like the legacy headline reason."""
        parts = [
            f"{int(self.counts[i, s])} {REASON_TEXT[code]}"
            for s, (_key, code) in enumerate(STAGES)
            if int(self.counts[i, s]) > 0
        ]
        if int(self.feasible[i]) > 0:
            parts.append(
                f"{int(self.feasible[i])} node(s) would now be feasible "
                "(ordering artifact: later placements satisfied this pod's "
                "constraints after it failed)"
            )
        avail = int(self.feasible[i])
        if parts:
            tail = ", ".join(parts)
        elif self.n_nodes == 0:
            tail = "no nodes in the cluster"
        else:
            # a pod that never ran the cascade (spec.nodeName forced onto a
            # node outside this cluster): the recorded reason is the story
            tail = self.headline(i)
        return f"{avail}/{self.n_nodes} nodes are available: {tail}."

    def witness_names(self, i: int, s: int) -> List[str]:
        out = []
        for w in self.witnesses[i, s]:
            if int(w) >= 0 and int(w) < len(self.node_names):
                out.append(self.node_names[int(w)])
        return out

    def groups(self, top: int = 10) -> List[Dict[str, object]]:
        """Pods grouped by identical (headline code, per-stage counts) —
        one entry per distinct failure shape, largest first, capped."""
        by_key: Dict[tuple, Dict[str, object]] = {}
        for i in range(len(self.rows)):
            key = (int(self.reasons[i]), tuple(int(c) for c in self.counts[i]))
            got = by_key.get(key)
            if got is None:
                by_key[key] = {
                    "pods": 1,
                    "example": self.names[i],
                    "reason": self.headline(i),
                    "fail_code": int(self.reasons[i]),
                    "final_fail_code": int(self.fail_code[i]),
                    "status": self.status(i),
                    "stages": {
                        STAGES[s][0]: int(self.counts[i, s])
                        for s in range(len(STAGES))
                        if int(self.counts[i, s]) > 0
                    },
                    "feasible": int(self.feasible[i]),
                    "witnesses": {
                        STAGES[s][0]: self.witness_names(i, s)
                        for s in range(len(STAGES))
                        if int(self.counts[i, s]) > 0
                    },
                }
            else:
                got["pods"] += 1
        groups = sorted(by_key.values(), key=lambda d: -d["pods"])
        return groups[:top]

    def to_doc(self, top: int = 10) -> Dict[str, object]:
        groups = self.groups(top=top)
        distinct = len(
            {
                (int(self.reasons[i]), tuple(int(c) for c in self.counts[i]))
                for i in range(len(self.rows))
            }
        )
        doc = {
            "version": EXPLAIN_VERSION,
            "n_nodes": int(self.n_nodes),
            "unplaced": int(len(self.rows)),
            "mode": self.mode,
            "wall_s": round(self.wall_s, 4),
            "groups": groups,
        }
        if distinct > top:
            # no silent caps: a truncated view must say what was dropped
            doc["truncated_groups"] = distinct - top
        return doc


def build_explain_doc(
    tensors,
    batch,
    rows: Sequence[int],
    state,
    nodes_arr: np.ndarray,
    reasons: np.ndarray,
    *,
    node_valid: Optional[np.ndarray] = None,
    sched_config=None,
    new_node: Optional[dict] = None,
    daemon_sets: Sequence[dict] = (),
    corrected_ds_overhead: bool = False,
    top: int = 10,
    free: Optional[np.ndarray] = None,
) -> Dict[str, object]:
    """The ONE assembly of the versioned explain document — failures
    breakdown (when a carried state is available) + bottleneck analysis —
    shared by `Simulator.explain_result`, the planners' failure paths and
    the `explain` subcommand. `state=None` degrades to the bottleneck block
    alone, its free capacity taken from `free` when the caller can supply
    the full picture and otherwise derived from the visible placements in
    `nodes_arr`."""
    from .bottleneck import bottleneck_analysis

    rows = np.asarray(list(rows), np.int64)
    doc: Dict[str, object] = {"version": EXPLAIN_VERSION}
    if not len(rows):
        return {}
    if state is not None:
        bd = explain_failures(
            tensors, batch, rows, state, reasons=reasons,
            node_valid=node_valid, sched_config=sched_config,
        )
        doc["failures"] = bd.to_doc(top=top)
        free = state.free.cpu().numpy()  # the carry is exact — it wins
    doc["bottleneck"] = bottleneck_analysis(
        tensors, batch, np.asarray(nodes_arr), np.asarray(reasons),
        rows=rows, node_valid=node_valid, new_node=new_node,
        daemon_sets=daemon_sets,
        corrected_ds_overhead=corrected_ds_overhead, free=free,
    )
    return doc


def explain_failures(
    tensors,
    batch,
    rows: Sequence[int],
    state,
    *,
    reasons: Optional[np.ndarray] = None,
    node_valid: Optional[np.ndarray] = None,
    sched_config=None,
    names: Optional[List[str]] = None,
    witnesses: int = WITNESS_K,
    chunk: int = EXPLAIN_CHUNK,
) -> FailureBreakdown:
    """Explain the unplaced pods at `rows` against `state` (a dense
    SchedState — `Engine.carried_state()` or a `build_state` output), on
    the state's device: one K20 launch per chunk of `chunk` runnable pods
    on the card, the plain version on the CPU.

    `reasons` carries the recorded per-row fail codes (the legacy
    headline); when omitted, the breakdown's own first-failing stage is
    the headline too. Forced pods (spec.nodeName) that failed with
    FAIL_NO_NODE never ran the cascade — they are reported with zero stage
    counts and the recorded reason alone."""
    t0 = time.perf_counter()
    rows = np.asarray(list(rows), np.int64)
    n = tensors.alloc.shape[0]
    valid = np.ones(n, bool) if node_valid is None else np.asarray(node_valid, bool)
    n_valid = int(valid.sum())
    k = _witness_cap(n, witnesses)
    s_n = len(STAGES)
    counts = np.zeros((len(rows), s_n), np.int32)
    feas = np.zeros(len(rows), np.int32)
    wits = np.full((len(rows), s_n, k), -1, np.int32)
    codes = np.zeros(len(rows), np.int32)

    # forced-fail pods (FAIL_NO_NODE) skip the cascade: their failure is
    # "the pinned node does not exist / is outside this cluster"
    forced = np.asarray(batch.forced)[rows].astype(bool)
    codes[forced] = FAIL_NO_NODE
    run_rows = rows[~forced]
    run_idx = np.flatnonzero(~forced)

    device = state.free.device
    flags = flags_from(tensors, batch.ext)
    if len(run_rows):
        statics = statics_from(tensors, sched_config, device)
        statics = statics._replace(
            node_valid=statics.node_valid & torch.as_tensor(valid, device=device))
        _, pods = build_pod_arrays(batch, tensors.alloc.shape[1])
        pos = 0
        while pos < len(run_rows):
            sel = run_rows[pos : pos + chunk]
            seg = tuple(np.asarray(arr)[sel] for arr in pods)
            c, f, w, fc = explain_pass(statics, state, seg, flags, k)
            dst = run_idx[pos : pos + chunk]
            counts[dst], feas[dst] = c, f
            wits[dst], codes[dst] = w, fc
            pos += len(sel)
    if reasons is not None:
        recorded = np.asarray(reasons)[rows].astype(np.int32)
        # placed/OK rows explained by mistake keep the recomputed code
        recorded = np.where(recorded == OK, codes, recorded)
    else:
        recorded = codes.copy()
    if names is None:
        from ..core.objects import name_of, namespace_of

        names = [
            f"{namespace_of(batch.pods[int(r)])}/{name_of(batch.pods[int(r)])}"
            if batch.pods
            else f"pod[{int(r)}]"
            for r in rows
        ]
    return FailureBreakdown(
        n_nodes=n_valid,
        rows=rows,
        names=list(names),
        reasons=recorded,
        fail_code=codes,
        counts=counts,
        feasible=feas,
        witnesses=wits,
        node_names=list(tensors.node_names),
        mode=device.type,
        wall_s=time.perf_counter() - t0,
    )
