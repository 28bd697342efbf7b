"""The speculative wavefront: a same-group run of pods placed in one launch.

The PyTorch counterpart of the JAX package's speculative wavefront
(`simtpu/engine/scan.py:1558-1834`): the host planner (`wave_eligibility`,
`_plan_waves`, `flatten_wave_segments`, the wave part of `plan_scan_chunks`
:1272-1333), the dispatcher (`run_scan_chunked`'s wave branch :1440-1597)
and the two verifiers (`_wave_verify_lean` :2422, `_wave_verify_hard`
:2035) behind `wavefront_scan` :1796 / `_run_wavefront` :2794.

A batch is cut into chunks of `SCAN_CHUNK` pods; inside each chunk the
planner finds maximal runs of consecutive pods of one group with the same
eligibility (unpinned, unforced; the storage, GPU, ports and volume
families ride along as heavy stage bits, as under the JAX package's
default heavy drafting) of at least
`_WAVE_MIN` pods. Each run is one launch of a wave kernel; the pods between
runs take the per-pod kernels K1-K6 (`scan.run_pods`). Both write into the
same `StepBuffers` outputs, on one stream, with no host sync; the batch
fetches its outputs once at its end.

Every wave gives exactly what the serial chain K1->(K5)->(K6)->K2->K3->K4
gives pod by pod: each pod's node and reason, the extended plans, and the
state after the run. The verifiers reproduce the serial step's arithmetic
(`engine/scan.py score_pod`, `kernels/scores.py`), not the JAX wavefront
program's own contractions:

- K9 `wave_lean` (`kernels/csrc/wave_lean.cu`, plain `wave_lean_plain`):
  the run owns no hard term and carries no heavy bits, so its feasibility
  mask moves only where `free` moves. It carries the fit mask and the
  resource score pair row by row (only the chosen node's row is
  recomputed), `m_all` and the normalized static terms (refreshed only
  when a placement flips its node's fit row), the SelectorSpread masked
  maxima (advanced by a scalar max between flips) and the count raws,
  bumped per placement by the group's per-key coefficients on the nodes
  that share a key's domain with the chosen node. The count planes are
  bumped in place per placement, as K4 does.
- K10 `wave_hard` (`kernels/csrc/wave_hard.cu`, plain `wave_hard_plain`):
  the run owns a hard term (DoNotSchedule spread, required (anti-)
  affinity) or heavy bits. The run-constant stages (static mask, and the
  ports, volume and attach masks where the run adds nothing to their
  planes) are evaluated once; each step recomputes the resource fit, the
  heavy stages against the occupancy planes as they stand, the storage and
  GPU plans, the hard-spread minimum and the inter-pod filter over the
  group's term rows, the score, the argmax and the commit.

Counters (`wave_counts()`) are kept as the JAX package keeps its
`wavefront.*` counters: per wave after the batch's fetch, `accepts =
nodes == nodes[0]` (a first pod that failed counts too), the accepted
prefix, rollbacks and rolled-back pods; `draft_hard` counts the pods of
hard waves at dispatch.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..kernels import cuda
from ..kernels.filters import (
    attach_limits_ok,
    ports_conflict_free,
    resources_fit,
    volume_conflict_free,
)
from ..kernels.fp import fma
from ..kernels.scores import (
    maxabs_normalize,
    minmax_normalize,
    resource_base_score,
    selector_spread_compose,
    simon_minmax,
    spread_score_from_raw,
    taint_toleration_score,
)
from .scan import (
    OK,
    StepEval,
    choose,
    commit,
    gpu_step,
    open_local_term,
    run_pods,
    score_pod,
    storage_step,
    topology_masks,
    topology_raws,
    uses_topology,
)

#: pods per chunk: wave boundaries never cross a chunk boundary (the JAX
#: package's `_SCAN_CHUNK`), so the plans and the counters agree
SCAN_CHUNK = 1024
#: minimum run length worth a wave launch (shorter runs take K1-K6)
_WAVE_MIN = 8
# heavy stage bits: families the hard verifier recomputes per step
WAVE_HEAVY_PORTS = 1  # group requests host ports
WAVE_HEAVY_VOLS = 2  # group has volume conflicts / attach limits
WAVE_HEAVY_STORAGE = 4  # pod demands Open-Local LVM / device storage
WAVE_HEAVY_GPU = 8  # pod demands GPU shares

WAVE_KEYS = ("wavefronts", "pods", "accepted", "rollbacks", "rollback_pods", "draft_hard")
#: the wavefront counters of this process (read through `wave_counts()`)
WAVE_COUNTS: Counter = Counter()


def wave_counts() -> dict:
    """The wavefront counters, one entry per WAVE_KEYS key."""
    return {k: WAVE_COUNTS[k] for k in WAVE_KEYS}


# -- the host planner ---------------------------------------------------------


def wave_group_mask(tensors) -> np.ndarray:
    """[G] bool — groups with no host-port and no volume requests (the lean
    restriction of `wave_pod_mask` with heavy drafting off). Memoized on
    the tensors object."""
    cached = getattr(tensors, "_wave_group_cache", None)
    if cached is not None:
        return cached
    ok = np.ones(len(tensors.groups), bool)
    if tensors.n_ports:
        ok &= ~tensors.ports.any(axis=1)
    if tensors.n_vols:
        ok &= ~(tensors.vol_rw.any(axis=1) | tensors.vol_ro.any(axis=1) | tensors.vol_att.any(axis=1))
    object.__setattr__(tensors, "_wave_group_cache", ok)
    return ok


def _storage_pods(pods) -> np.ndarray:
    """[P] bool — pods that demand Open-Local LVM or device storage."""
    out = np.zeros(len(pods[0]), bool)
    for arr in (np.asarray(pods[4]), np.asarray(pods[6])):
        if arr.size:
            out |= arr.max(axis=1) > 0
    return out


def wave_pod_mask(pods, groups: np.ndarray, tensors, heavy: bool = True) -> np.ndarray:
    """[P] bool — pods eligible for a wave. With heavy drafting (the
    engine's only mode) only pinned and forced pods are excluded;
    `heavy=False` is the JAX package's SIMTPU_WAVE_HEAVY=0 plan, which also
    excludes storage and GPU pods and the pods of port or volume groups
    (the parity tests hold the two planners against each other). Host
    numpy over the pod tuple (`build_pod_arrays` layout)."""
    ok = (np.asarray(pods[2]) == -1) & ~np.asarray(pods[3], bool)
    if heavy:
        return ok
    ok &= ~_storage_pods(pods)
    ok &= np.asarray(pods[8]) <= 0
    return ok & wave_group_mask(tensors)[groups]


def wave_group_heavy(tensors) -> np.ndarray:
    """[G] int16 — per-group heavy stage bits (WAVE_HEAVY_PORTS / _VOLS).
    Memoized on the tensors object."""
    cached = getattr(tensors, "_wave_heavy_cache", None)
    if cached is not None:
        return cached
    bits = np.zeros(len(tensors.groups), np.int16)
    if tensors.n_ports:
        bits |= np.where(tensors.ports.any(axis=1), WAVE_HEAVY_PORTS, 0).astype(np.int16)
    if tensors.n_vols:
        vol = tensors.vol_rw.any(axis=1) | tensors.vol_ro.any(axis=1) | tensors.vol_att.any(axis=1)
        bits |= np.where(vol, WAVE_HEAVY_VOLS, 0).astype(np.int16)
    object.__setattr__(tensors, "_wave_heavy_cache", bits)
    return bits


def wave_eligibility(pods, groups: np.ndarray, tensors, heavy: bool = True) -> np.ndarray:
    """[P] int16 — -1 for pods no wave may take, else the heavy stage bits
    the verifier needs for the pod (0 = lean). The planner breaks runs on
    value changes, so a run is homogeneous in group and heavy bits."""
    ok = wave_pod_mask(pods, groups, tensors, heavy)
    bits = np.zeros(len(ok), np.int16)
    if heavy:
        bits = wave_group_heavy(tensors)[groups].astype(np.int16)
        bits |= np.where(_storage_pods(pods), WAVE_HEAVY_STORAGE, 0).astype(np.int16)
        bits |= np.where(np.asarray(pods[8]) > 0, WAVE_HEAVY_GPU, 0).astype(np.int16)
    return np.where(ok, bits, -1).astype(np.int16)


def _wave_group_hard(tensors) -> np.ndarray:
    """[G] bool — the group owns a hard term (DoNotSchedule skew or a
    required (anti-)affinity incidence): its waves take K10. Memoized."""
    cached = getattr(tensors, "_wave_hard_cache", None)
    if cached is not None:
        return cached
    hard = np.zeros(len(tensors.groups), bool)
    if tensors.n_terms:
        hard = (
            (tensors.spread_hard > 0).any(axis=1)
            | tensors.a_aff_req.any(axis=1)
            | tensors.a_anti_req.any(axis=1)
        )
    object.__setattr__(tensors, "_wave_hard_cache", hard)
    return hard


def _wave_group_pref(tensors) -> np.ndarray:
    """[G] bool — the group's own inter-pod preference weights move its
    inter-pod raw while it places (K9 then renormalizes that term per
    step). Memoized."""
    cached = getattr(tensors, "_wave_pref_cache", None)
    if cached is not None:
        return cached
    pref = np.zeros(len(tensors.groups), bool)
    if tensors.n_terms:
        pref = ((tensors.w_aff_pref != tensors.w_anti_pref) & tensors.s_match).any(axis=1)
    object.__setattr__(tensors, "_wave_pref_cache", pref)
    return pref


def _plan_waves(groups, wave_ok, c0: int, c1: int, hard_g, pref_g, use_topo: bool, use_ip: bool):
    """Maximal same-group, same-eligibility runs of eligible pods within
    [c0, c1), at least _WAVE_MIN long, as absolute (a, b, hard, pref,
    heavy) entries. Any heavy bit forces the hard verifier."""
    g = groups[c0:c1]
    if g.shape[0] == 0:
        return []
    ok = np.asarray(wave_ok[c0:c1])
    brk = np.flatnonzero((g[1:] != g[:-1]) | (ok[1:] != ok[:-1])) + 1
    starts = np.concatenate([[0], brk])
    ends = np.concatenate([brk, [len(g)]])
    return [
        (
            int(c0 + a),
            int(c0 + b),
            (use_topo and bool(hard_g[g[a]])) or int(ok[a]) != 0,
            use_ip and bool(pref_g[g[a]]),
            int(ok[a]),
        )
        for a, b in zip(starts, ends)
        if ok[a] >= 0 and b - a >= _WAVE_MIN
    ]


def plan_waves(groups: np.ndarray, tensors, flags, wave_ok: np.ndarray, chunk: int = None):
    """The chunk plan: [(c0, c1, waves)] with each chunk's wave entries
    (`_plan_waves`). The port carries full planes, so the JAX package's
    group and term-row slicing of a chunk is left out; the chunk cut is
    kept, because wave boundaries and the counters depend on it."""
    chunk = SCAN_CHUNK if chunk is None else chunk
    use_topo = uses_topology(flags)
    use_ip = flags.interpod_req or flags.interpod_pref
    hard_g, pref_g = _wave_group_hard(tensors), _wave_group_pref(tensors)
    return [
        (c0, min(c0 + chunk, len(groups)),
         _plan_waves(groups, wave_ok, c0, min(c0 + chunk, len(groups)), hard_g, pref_g,
                     use_topo, use_ip))
        for c0 in range(0, len(groups), chunk)
    ]


def flatten_wave_segments(c0: int, c1: int, waves):
    """One chunk's dispatch order: ('scan' | 'wave', a, b, mode) segments,
    waves interleaved with the per-pod remainders in pod order (mode =
    (hard, pref, heavy) for waves, None for the per-pod kernels)."""
    segs = []
    pos = c0
    for wa, wb, w_hard, w_pref, w_heavy in waves:
        if wa > pos:
            segs.append(("scan", pos, wa, None))
        segs.append(("wave", wa, wb, (w_hard, w_pref, w_heavy)))
        pos = wb
    if pos < c1:
        segs.append(("scan", pos, c1, None))
    return segs


# -- the dispatcher -------------------------------------------------------------


def run_batch_waves(buf, tensors, groups: np.ndarray, pods, a0: int = 0, b0: int = None) -> list:
    """The pods [a0, b0) of the batch (default all) in order: each planned
    wave in one K9 or K10 launch (heavy runs drafted), the pods between
    waves through the per-pod kernels, no host sync. The plan is cut from
    a0, as the JAX package plans a segment's slice of the batch. Returns
    the waves launched, [(a, b, hard)] absolute, for `count_waves`."""
    groups = np.asarray(groups)
    b0 = len(groups) if b0 is None else b0
    if b0 <= a0:
        return []
    sub = groups[a0:b0]
    wave_ok = wave_eligibility(tuple(np.asarray(x)[a0:b0] for x in pods), sub, tensors)
    launched = []
    for c0, c1, waves in plan_waves(sub, tensors, buf.flags, wave_ok):
        for kind, a, b, mode in flatten_wave_segments(c0 + a0, c1 + a0,
                                                      [(wa + a0, wb + a0, *m) for wa, wb, *m in waves]):
            if kind == "scan":
                run_pods(buf, a, b)
                continue
            hard, _, w_heavy = mode
            (wave_hard if hard or w_heavy else wave_lean)(buf, a, b, mode)
            if hard:
                WAVE_COUNTS["draft_hard"] += b - a
            launched.append((a, b, hard))
    return launched


def count_waves(launched, nodes: np.ndarray, base: int = 0) -> None:
    """The counters of a batch's waves, from its fetched nodes (`nodes[0]`
    is pod `base` of the batch)."""
    for a, b, _ in launched:
        real = b - a
        acc = nodes[a - base:b - base] == nodes[a - base]
        prefix = real if acc.all() else int(acc.argmin())
        WAVE_COUNTS["wavefronts"] += 1
        WAVE_COUNTS["pods"] += real
        WAVE_COUNTS["accepted"] += prefix
        if prefix < real:
            WAVE_COUNTS["rollbacks"] += 1
            WAVE_COUNTS["rollback_pods"] += real - prefix


# -- the verifiers: plain versions ------------------------------------------------


def _run_constants(buf, g: int, heavy_ports: bool, heavy_vols: bool):
    """The run-constant stages: (m_static, ports_ok, vol_ok, att_ok); a
    heavy family's stage is recomputed per step instead (all-true here)."""
    st, state, f = buf.statics, buf.state, buf.flags
    ones = torch.ones(st.alloc.shape[0], dtype=torch.bool, device=st.alloc.device)
    m_static = st.static_mask[g] & st.node_valid
    ports_ok = ports_conflict_free(state.ports_used, st.ports_req[g]) if f.ports and not heavy_ports else ones
    vol_ok = (
        volume_conflict_free(state.vols_any, state.vols_rw, st.vol_rw_req[g], st.vol_ro_req[g])
        if f.vols and not heavy_vols else ones
    )
    att_ok = (
        attach_limits_ok(state.vols_any, st.vol_att_req[g], st.vol_class_mask, st.attach_limits)
        if f.attach and not heavy_vols else ones
    )
    return m_static, ports_ok, vol_ok, att_ok


def _key_coefficients(buf, g: int) -> torch.Tensor:
    """[4, K] per-key coefficients of the count raws (rows in K2's raw
    order: inter-pod, soft spread, SelectorSpread host, zone): what one
    placement adds to node n's raw for every key on which n shares the
    chosen node's domain. Integer-valued: the sums are exact."""
    st = buf.statics
    k_n = st.node_dom.shape[0]
    coef = torch.zeros((4, k_n), dtype=torch.float32, device=st.alloc.device)
    terms = st.g_terms[g]
    for t in range(terms.shape[0]):
        term = int(terms[t])
        if term < 0:
            continue
        k = int(st.term_topo[term])
        s = 1.0 if bool(st.s_match[g, t]) else 0.0
        coef[0, k] += 2.0 * (st.w_aff_pref[g, t] - st.w_anti_pref[g, t]) * s
        coef[1, k] += st.spread_soft[g, t] * s
        coef[2, k] += (1.0 if bool(st.ss_host[g, t]) else 0.0) * s
        coef[3, k] += (1.0 if bool(st.ss_zone[g, t]) else 0.0) * s
    return coef


def wave_lean_plain(buf, a: int, b: int, mode) -> None:
    """Plain version of K9: the lean run [a, b) with the carried state of
    the module docstring, writing the pods' outputs and the state after
    the run into `buf`."""
    cuda.count_plain("wave_lean")
    pref = mode[1]
    st, state, f = buf.statics, buf.state, buf.flags
    g = int(buf.group[a])
    w_ = st.score_w
    t_cap = st.g_terms.shape[1] if uses_topology(f) else 0
    has_ss, has_soft = bool(t_cap) and f.selector_spread, bool(t_cap) and f.spread_soft
    has_ip = bool(t_cap) and (f.interpod_req or f.interpod_pref)
    m_static, ports_ok, vol_ok, att_ok = _run_constants(buf, g, False, False)
    m_ports = m_static & ports_ok
    vol_mask = st.vol_mask[g]
    _, ip_mask = topology_masks(st, state, g, m_static, f)
    m_nofit = m_ports & vol_ok & att_ok & vol_mask & ip_mask
    req0 = buf.req[a]
    m_fit = resources_fit(state.free, req0)
    fscore = resource_base_score(state.free, st.alloc, req0, w_[0], w_[1])
    m_all = m_nofit & m_fit
    # the count raws (K2's four rows, as the carry stands) and what one
    # placement adds to them per key
    raws = torch.stack(topology_raws(st, state, g))
    coef = _key_coefficients(buf, g)
    any_zone = st.ss_zone[g].any()

    def refresh():
        """The carries that depend on m_all alone: the normalized static
        terms, the constant-raw inter-pod term, feasibility and the
        SelectorSpread maxima."""
        terms = {"simon": simon_minmax(st.alloc, req0, m_all)}
        if f.node_pref:
            terms["node_pref"] = minmax_normalize(st.node_pref[g], m_all)
        if f.taint_pref:
            terms["taint"] = taint_toleration_score(st.taint_intol[g], m_all)
        if has_ip and not pref:
            terms["ipa"] = maxabs_normalize(raws[0], m_all)
        scal = {"feasible": bool(m_all.any())}
        if has_ss:
            scal["max_h"] = torch.where(m_all, raws[2], 0.0).amax()
            scal["max_z"] = torch.where(m_all, raws[3], 0.0).amax()
        return terms, scal

    terms, scal = refresh()
    for i in range(a, b):
        req = buf.req[i]
        score = fscore
        if f.node_pref:
            score = score + (w_[2] + w_[3]) * terms["simon"]
            score = fma(w_[4], terms["node_pref"], score)
        else:
            score = fma(w_[2] + w_[3], terms["simon"], score)
        if f.taint_pref:
            score = fma(w_[5], terms["taint"], score)
        if has_ip:
            ipa = maxabs_normalize(raws[0], m_all) if pref else terms["ipa"]
            score = fma(w_[6], ipa, score)
        if has_soft:
            score = fma(w_[7], spread_score_from_raw(raws[1], m_all), score)
        if has_ss:
            ss = selector_spread_compose(raws[2], raws[3], scal["max_h"], scal["max_z"],
                                         any_zone)
            score = fma(w_[8], ss, score)
        if f.static_score:
            score = score + fma(w_[9], st.static_score[g], w_[11] * st.avoid_pen[g])
        score = torch.where(m_all, score, -torch.inf)
        chosen = int(torch.argmax(score))
        placed = scal["feasible"]
        reason = OK
        if not placed:
            # the lean cascade: storage, GPU and spread are the bind stage
            m_res = m_ports & m_fit
            m_bind = m_res & vol_ok & att_ok & vol_mask
            ev = StepEval(m_static, m_ports, m_res, m_res & vol_ok, m_res & vol_ok & att_ok,
                          m_bind, m_bind, m_bind, m_bind, m_all, *(None,) * 5)
            reason = ev.fail_code()
        buf.chosen[i] = chosen
        buf.placed[i] = placed
        buf.reason[i] = reason
        buf.out_node[i] = chosen if placed else -1
        if not placed:
            continue
        commit(st, state, g, req, chosen, True, f)
        fit_row = bool(resources_fit(state.free[chosen:chosen + 1], req)[0])
        prev_fit = bool(m_fit[chosen])
        m_fit[chosen] = fit_row
        fscore[chosen] = resource_base_score(state.free[chosen:chosen + 1], st.alloc[chosen:chosen + 1],
                                             req, w_[0], w_[1])[0]
        m_all[chosen] = bool(m_nofit[chosen]) and fit_row
        dom_c = st.node_dom[:, chosen]
        raws += coef @ ((st.node_dom == dom_c[:, None]) & (dom_c >= 0)[:, None]).to(torch.float32)
        if fit_row != prev_fit:
            terms, scal = refresh()
        elif has_ss:
            scal["max_h"] = torch.maximum(scal["max_h"], raws[2][chosen])
            scal["max_z"] = torch.maximum(scal["max_z"], raws[3][chosen])


def wave_hard_plain(buf, a: int, b: int, mode) -> None:
    """Plain version of K10: the hard or heavy run [a, b), each step's
    cascade recomputed over the group's term rows and the heavy stages
    against the occupancy planes as they stand, the run-constant stages
    evaluated once; the pods' outputs and plans and the state after the
    run into `buf`."""
    cuda.count_plain("wave_hard")
    heavy = mode[2]
    st, state, f = buf.statics, buf.state, buf.flags
    g = int(buf.group[a])
    heavy_ports = bool(heavy & WAVE_HEAVY_PORTS) and f.ports
    heavy_vols = bool(heavy & WAVE_HEAVY_VOLS) and (f.vols or f.attach)
    m_static, ports_ok, vol_ok, att_ok = _run_constants(buf, g, heavy_ports, heavy_vols)
    vol_mask = st.vol_mask[g]
    ones = torch.ones_like(m_static)
    for i in range(a, b):
        req = buf.req[i]
        if heavy_ports:
            ports_ok = ports_conflict_free(state.ports_used, st.ports_req[g])
        m_ports = m_static & ports_ok
        m_res = m_ports & resources_fit(state.free, req)
        if heavy_vols and f.vols:
            vol_ok = volume_conflict_free(state.vols_any, state.vols_rw, st.vol_rw_req[g], st.vol_ro_req[g])
        if heavy_vols and f.attach:
            att_ok = attach_limits_ok(state.vols_any, st.vol_att_req[g], st.vol_class_mask,
                                      st.attach_limits)
        m_vol = m_res & vol_ok
        m_att = m_vol & att_ok
        m_bind = m_att & vol_mask
        storage_ok, gpu_ok, raw = ones, ones, None
        plans = [None, None, None]
        if buf.storage_live[i]:
            storage_ok, lvm_alloc, dev_take, raw = storage_step(st, state, buf.pod_ext(i))
            plans[:2] = lvm_alloc, dev_take
        if buf.gpu_live[i]:
            gpu_ok, plans[2] = gpu_step(st, state, buf.pod_ext(i))
        m_storage = m_bind & storage_ok
        m_gpu = m_storage & gpu_ok
        spread_ok, ip_ok = topology_masks(st, state, g, m_static, f)
        m_spread = m_gpu & spread_ok
        m_all = m_spread & ip_ok
        score = score_pod(st, state, g, req, m_all, f)
        if raw is not None:
            score = open_local_term(st, score, raw, m_all, f)
        ev = StepEval(m_static, m_ports, m_res, m_vol, m_att, m_bind, m_storage, m_gpu, m_spread, m_all,
                      score, None, None, None, None)
        chosen, placed, reason = choose(ev, False, -1, st.node_valid)
        buf.chosen[i] = chosen
        buf.placed[i] = placed
        buf.reason[i] = reason
        buf.out_node[i] = chosen if placed else -1
        if not placed:
            continue
        rows = [p[chosen] if p is not None else None for p in plans]
        if rows[0] is not None:
            buf.out_lvm[i], buf.out_take[i] = rows[0], rows[1]
        if rows[2] is not None:
            buf.out_gpu[i] = rows[2]
        commit(st, state, g, req, chosen, True, f, (*rows, float(buf.gpu_mem[i])))


# -- the wrappers ----------------------------------------------------------------


def wave_lean(buf, a: int, b: int, mode) -> None:
    """K9 (`kernels/csrc/wave_lean.cu`) for the lean run [a, b) under the
    wave's mode (hard, pref, heavy)."""
    if buf.device.type == "cpu":
        wave_lean_plain(buf, a, b, mode)
    else:
        cuda.launch_wave("wave_lean", buf, a, b, mode)


def wave_hard(buf, a: int, b: int, mode) -> None:
    """K10 (`kernels/csrc/wave_hard.cu`) for the hard or heavy run [a, b)
    under the wave's mode (hard, pref, heavy)."""
    if buf.device.type == "cpu":
        wave_hard_plain(buf, a, b, mode)
    else:
        cuda.launch_wave("wave_hard", buf, a, b, mode)
