"""Bulk placement engine: a whole same-spec pod run placed in one round.

The PyTorch counterpart of the JAX package's `simtpu/engine/rounds.py`:
the round (`_round_core` :291 with `_floor_slots` :114, `_fill_order` :128,
`_unsort_take` :149 and `_quota_fill` :158), the scan over a chunk's rounds
(`rounds_scan` :751) and `RoundsEngine` :874 with its segment plan, stretch
groups, chunk plan, host records and leftover probes. The placements are the
JAX package's, bit for bit: the bulk tie-breaks differ from the serial scan
by design (the JAX module docstring), and the port is held to the JAX
rounds engine, not to the serial scan.

One round of a run of k identical pods, representative pod i of the batch:

1. the pod's filter cascade and plans through the serial step's kernels
   K1 `filter_pod`, K5 `storage_pod` / K6 `gpu_pod` where the pod demands
   them, and K2 `topology_pod` (`engine/scan.py`);
2. K14 `round_score` (`kernels/csrc/round_score.cu`): the score and its
   storage-free part, the per-node intake caps (resources with the relative
   slack, the exclusive cap, the LVM / device / GPU slot counts with their
   tightest-first visit orders, the matrix variant's multi-claim and
   multi-GPU caps), the one-more-pod re-score and its clipped slope, `s0`,
   and the self-affinity bootstrap restriction;
3. K15 `round_pick` (`round_pick.cu`): the per-node intake m_n — the
   40-step threshold bisection with its overshoot clamp and index-ordered
   tie fill, or the domain-quota water-fill of a quota round;
4. K16 `round_commit` (`round_commit.cu`): the batched state update, IN
   PLACE, and the slot expansion (node per slot, container picks, the
   matrix round's per-slot LVM / GPU rows).

Each kernel's wrapper below decides by the device of the tensors: CPU
tensors run its plain PyTorch version (`round_score_plain`, ...), which
mirrors the JAX functions line by line; CUDA tensors launch the kernel or
raise. A chunk's rounds are launched back to back with no host sync; a
stretch group's outputs are fetched once.

The port carries full state planes, so the JAX chunk's count-plane row
slice (`rounds_scan_sliced`) is only a choice of which rounds share one
dispatch; the chunk plan is kept (`_chunk_runs`), since it is the JAX
package's dispatch order. The JAX package's shape buckets, AOT pipeline
and OOM backoff are not ported (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import cuda
from ..kernels.filters import _RES_EPS, interpod_filter, topology_spread_filter
from ..kernels.fp import fma
from .scan import (
    Engine,
    StepBuffers,
    TopoRaws,
    _compact_terms,
    _ext_masks,
    _stage_masks,
    filter_pod,
    gpu_pod,
    open_local_term,
    run_pods,
    score_pod,
    storage_pod,
    topology_pod,
    uses_topology,
)
from .state import add_rows, apply_placement_deltas, take_rows, take_rows_i32

_NEG = -3.4e38
_BIG = 3.4e38
#: the compact per-key domain ids of a small topology key (core/tensorize.py)
DOM_SMALL = 64
#: bisection steps of the threshold search
BISECT_STEPS = 40
#: round variant bits (the kernels' `mode`)
V_QUOTA, V_SELF_AFF, V_MATS = 1, 2, 4

_F32 = torch.float32


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _clip(x, lo, hi):
    """`jnp.clip`: maximum then minimum, NaN propagating as in XLA."""
    t = torch.as_tensor
    x = torch.maximum(x, t(lo, dtype=x.dtype, device=x.device))
    return torch.minimum(x, t(hi, dtype=x.dtype, device=x.device))


def _floor_slots(free: torch.Tensor, size) -> torch.Tensor:
    """floor(free / size), one slot less where the f32 division rounded up
    across an integer boundary (the serial kernels never overshoot)."""
    size = torch.as_tensor(size, dtype=_F32, device=free.device)
    c = torch.floor(free / torch.clamp(size, min=1e-30))
    return torch.where(c * size > free, c - 1.0, c)


def _fill_order(cap_x: torch.Tensor, free_x: torch.Tensor):
    """Tightest-first visit order over a node's containers: ascending free
    among the containers with slots (stable, ties by index). Returns
    (order [N, X], c_sorted, cum_sorted); the JAX one-hot einsums are exact
    permutations, here gathers."""
    key = torch.where(cap_x > 0, free_x, torch.full_like(free_x, _BIG))
    order = torch.argsort(key, dim=1, stable=True)
    c_sorted = torch.gather(cap_x, 1, order)
    return order.to(torch.int32), c_sorted, torch.cumsum(c_sorted, dim=1)


def _unsort_take(m_n, order, c_sorted, cum_sorted):
    """Pods per container given m_n pods on each node, mapped back from the
    visit order to container positions. [N, X]."""
    take_sorted = _clip(m_n[:, None] - (cum_sorted - c_sorted), 0.0, c_sorted)
    out = torch.zeros_like(take_sorted)
    return out.scatter_(1, order.long(), take_sorted)


class RoundBuffers:
    """What K14-K16 read and write besides the batch's `StepBuffers`: the
    per-node round scratch (caps, s0, slope, m_n, the fill orders), the key
    routing of the count update, the kernels' scratch rows, and the rounds'
    outputs, written row by row (rows of `k_cap` slots, allocated by
    `alloc_outputs`)."""

    def __init__(self, buf: StepBuffers, tensors):
        dev = buf.device
        st = buf.statics
        n = st.alloc.shape[0]
        v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], buf.state.gpu_free.shape[1]
        self.buf = buf
        self.device = dev
        self.n_domains = int(tensors.n_domains)
        k_n = st.node_dom.shape[0]
        kk = np.asarray(tensors.key_kind, np.int32)
        nds = np.asarray(tensors.node_dom_small, np.int32)
        self.key_kind = torch.as_tensor(kk if kk.size else np.zeros(k_n, np.int32), device=dev)
        self.node_dom_small = torch.as_tensor(
            nds if nds.size else np.full((k_n, n), -1, np.int32), device=dev).contiguous()

        def z(*shape, dtype=_F32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cap, self.s0, self.slope, self.m_n = z(n), z(n), z(n), z(n)
        self.m_all = z(n, dtype=torch.bool)
        self.ord_vg, self.cs_vg, self.cum_vg = z(n, v, dtype=torch.int32), z(n, v), z(n, v)
        self.ord_dev, self.cs_dev, self.cum_dev = z(n, sd, dtype=torch.int32), z(n, sd), z(n, sd)
        self.ord_gpu, self.cs_gpu, self.cum_gpu = z(n, gd, dtype=torch.int32), z(n, gd), z(n, gd)
        self.c_gpu, self.cum_gidx = z(n, gd), z(n, gd)
        # K16's per-(term row, domain) sums of the fallback key route, and
        # the kernels' node / domain scratch rows (rounds.cuh SCR_ROWS ...)
        self.dom_sums = z(max(st.g_terms.shape[1], 1), self.n_domains)
        self.scr = z(cuda.ROUND_SCR_ROWS, n)
        self.dscr = z(cuda.ROUND_DSCR_ROWS, self.n_domains + 1)
        self.iscr = z(4 * n + 2 * (self.n_domains + 1), dtype=torch.int32)
        # K16's per-block words where the group's term columns pass its
        # shared budget (kernels/cuda.py round_plan's global mode), at first use
        self.pub = None
        self.alloc_outputs(1, 1)

    def alloc_outputs(self, rows: int, k_cap: int) -> None:
        """Fresh output rows: assign, vg/dev/gpu container per slot (-1
        none) and the matrix round's per-slot LVM bytes / GPU shares."""
        st, dev = self.buf.statics, self.device
        self.k_cap = k_cap
        self.assign = torch.full((rows, k_cap), -1, dtype=torch.int32, device=dev)
        self.vg_idx = torch.full((rows, k_cap), -1, dtype=torch.int32, device=dev)
        self.dev_idx = torch.full((rows, k_cap), -1, dtype=torch.int32, device=dev)
        self.gpu_idx = torch.full((rows, k_cap), -1, dtype=torch.int32, device=dev)
        self.lvm_mat = torch.zeros((rows, k_cap, st.vg_cap.shape[1]), dtype=_F32, device=dev)
        self.gpu_mat = torch.zeros((rows, k_cap, self.buf.state.gpu_free.shape[1]), dtype=_F32,
                                   device=dev)
        self.ctx = None


def _round_terms(buf: StepBuffers, g: int):
    """(t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub) of group g, with
    t_cap 0 when no topology feature is on (the JAX round's `use_topo`)."""
    st = buf.statics
    t_cap = st.g_terms.shape[1] if uses_topology(buf.flags) else 0
    if not t_cap:
        return 0, None, None, None, None, None
    terms_g = st.g_terms[g]
    tvalid = terms_g >= 0
    tsafe = terms_g.clamp(min=0)
    dom_sub = take_rows_i32(st.node_dom, torch.where(tvalid, st.term_topo[tsafe], -1))
    valid_sub = (dom_sub >= 0) & tvalid[:, None]
    return t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub


def _pod_scalars(buf: StepBuffers, i: int):
    """Pod i's extended demands as the round reads them: the heaviest LVM
    claim (size, named VG), the heaviest device claim (size, media), the
    GPU memory, count and preset row, and whether it has several LVM claims."""
    lvm, dev = buf.lvm_size[i], buf.dev_size[i]
    li = int(torch.argmax(lvm)) if lvm.numel() else 0
    di = int(torch.argmax(dev)) if dev.numel() else 0
    return dict(
        l_size=float(lvm[li]) if lvm.numel() else 0.0,
        l_vid=int(buf.lvm_vg[i][li]) if lvm.numel() else -1,
        multi_lvm=int((lvm > 0).sum()) > 1,
        d_size=float(dev[di]) if dev.numel() else 0.0,
        d_media=int(buf.dev_media[i][di]) if dev.numel() else 0,
        gpu_mem=float(buf.gpu_mem[i]),
        gpu_count=int(buf.gpu_count[i]),
        preset=buf.gpu_preset[i],
    )


def round_score_plain(rb: RoundBuffers, i: int, mode: int) -> None:
    """Plain version of K14 for the round of representative pod i (after
    K1/K5/K6/K2 ran for it): m_all, the caps, the fill orders and — outside
    a quota round — s0 and the slope (`_round_core` :363-523)."""
    cuda.count_plain("round_score")
    buf = rb.buf
    st, state, f = buf.statics, buf.state, buf.flags
    g, req = int(buf.group[i]), buf.req[i]
    m = _stage_masks(buf.stage)
    st_ok, gpu_ok, raw = _ext_masks(buf, i)
    m_all = m[7] & st_ok & gpu_ok
    score_ns = score_pod(st, state, g, req, m_all, f, TopoRaws(*buf.raw.unbind(0)))
    score = open_local_term(st, score_ns, raw, m_all, f)
    pod = _pod_scalars(buf, i)
    ext_mats = bool(mode & V_MATS)

    # -- per-node intake caps (:365-460)
    with_req = req > 0
    slack_free = fma(_RES_EPS, torch.clamp(state.free.abs(), min=1.0), state.free)
    ratio = torch.where(with_req[None, :],
                        torch.floor(slack_free / torch.clamp(req, min=1e-30)[None, :]),
                        torch.full_like(state.free, _BIG))
    cap = ratio.amin(dim=1)
    exclusive = (f.ports and bool(st.ports_req[g].any())) or (f.vols and bool(st.vol_rw_req[g].any()))
    if exclusive:
        cap = torch.clamp(cap, max=1.0)
    if f.storage:
        has_lvm = pod["l_size"] > 0
        elig_vg = st.vg_name_id >= 0
        if pod["l_vid"] >= 0:
            elig_vg = elig_vg & (st.vg_name_id == pod["l_vid"])
        c_vg = torch.where(has_lvm & elig_vg & (state.vg_free >= pod["l_size"]),
                           _floor_slots(state.vg_free, pod["l_size"]), torch.zeros_like(state.vg_free))
        cap_lvm = c_vg.sum(dim=1)
        if ext_mats and pod["multi_lvm"]:
            lvm_alloc = buf.st_alloc if int(buf.ext_live[i]) & 1 else torch.zeros_like(buf.st_alloc)
            used_st = lvm_alloc > 0
            slots_st = torch.where(used_st, _floor_slots(state.vg_free, torch.clamp(lvm_alloc, min=1e-30)),
                                   torch.full_like(lvm_alloc, _BIG))
            cap_lvm = torch.where(used_st.any(dim=1), slots_st.amin(dim=1), torch.zeros_like(cap))
        if has_lvm:
            cap = torch.minimum(cap, cap_lvm)
        rb.ord_vg[:], rb.cs_vg[:], rb.cum_vg[:] = _fill_order(c_vg, state.vg_free)
        has_dev = pod["d_size"] > 0
        c_dev = (has_dev & state.sdev_free & (st.sdev_media == pod["d_media"])
                 & (st.sdev_cap >= pod["d_size"])).to(_F32)
        if has_dev:
            cap = torch.minimum(cap, c_dev.sum(dim=1))
        rb.ord_dev[:], rb.cs_dev[:], rb.cum_dev[:] = _fill_order(c_dev, st.sdev_cap)
    if f.gpu:
        gm = pod["gpu_mem"]
        is_gpu = gm > 0
        free_g = torch.where(st.gpu_dev_exists, state.gpu_free, torch.full_like(state.gpu_free, -1.0))
        c_gpu = torch.where(is_gpu & (free_g >= gm), _floor_slots(free_g, gm), torch.zeros_like(free_g))
        cap_gpu = c_gpu.sum(dim=1)
        if ext_mats:
            count_f = max(float(pod["gpu_count"]), 1.0)
            rb.c_gpu[:] = c_gpu
            rb.cum_gidx[:] = torch.cumsum(c_gpu, dim=1)
            if pod["gpu_count"] > 1:
                cap_gpu = torch.floor(cap_gpu / torch.tensor(count_f, dtype=_F32, device=cap_gpu.device))
            if int(pod["preset"].sum()) > 0:
                cap_gpu = torch.full_like(cap_gpu, _BIG)
        if is_gpu:
            cap = torch.minimum(cap, cap_gpu)
        rb.ord_gpu[:], rb.cs_gpu[:], rb.cum_gpu[:] = _fill_order(c_gpu, free_g)
    rb.m_all[:] = m_all
    t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub = _round_terms(buf, g)
    if mode & V_QUOTA and t_cap:
        rb.cap[:] = cap  # K15 lifts t*'s filter and owns the rest
        return
    cap = torch.where(m_all, cap, torch.zeros_like(cap))
    if mode & V_SELF_AFF and t_cap:
        # colocate-with-self: in the bootstrap case (no matching pod
        # cluster-wide) confine the round to the best feasible node's domain
        saff = st.s_match[g] & st.a_aff_req[g] & tvalid
        t_star = int(torch.argmax(saff.to(torch.uint8)))
        aff_terms = st.a_aff_req[g] & tvalid
        total_match = torch.where(aff_terms, state.cnt_total[tsafe], 0.0).sum()
        dom_a = dom_sub[t_star]
        best = int(torch.argmax(torch.where(cap > 0, score, torch.full_like(score, _NEG))))
        d_star = dom_a[best]
        if float(total_match) <= 0:
            cap = torch.where((dom_a == d_star) & (dom_a >= 0), cap, torch.zeros_like(cap))
    # -- the one-more-pod re-score and its slope (:491-523)
    cnt_sub1 = None
    if t_cap:
        bump1 = torch.where(valid_sub, st.s_match[g].to(_F32)[:, None], 0.0)
        cnt_sub1 = take_rows(state.cnt_match, terms_g) + bump1
    score1 = score_pod(st, state, g, req, m_all, f, free=state.free - req[None, :], cnt_sub=cnt_sub1)
    slope = torch.where(m_all, score_ns - score1, torch.zeros_like(score1))
    rb.slope[:] = _clip(slope, 0.0, 1e6)
    rb.s0[:] = torch.where(m_all, score, torch.full_like(score, _NEG))
    rb.cap[:] = cap


def _quota_fill(rb: RoundBuffers, i: int, k: int) -> torch.Tensor:
    """Per-node intake for a run with ONE self-matching hard term t*
    (`_quota_fill` :158): base feasibility with t*'s own filter lifted,
    domain aggregates over t*'s key, the level ladder, the per-domain split
    in node-index order and the run-length clamp. The formulas are the JAX
    package's, `inf` and `inf - inf` included where caps are `_BIG`."""
    buf = rb.buf
    st, state, f = buf.statics, buf.state, buf.flags
    g = int(buf.group[i])
    t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub = _round_terms(buf, g)
    m = _stage_masks(buf.stage)
    st_ok, gpu_ok, _ = _ext_masks(buf, i)
    m_static, m_gpu = m[0], m[5] & st_ok & gpu_ok
    cap = rb.cap
    self_hard = st.s_match[g] & (st.a_anti_req[g] | (st.spread_hard[g] > 0)) & tvalid
    t_star = int(torch.argmax(self_hard.to(torch.uint8)))
    onehot = torch.arange(t_cap, device=cap.device) == t_star
    skew = st.spread_hard[g][t_star]
    use_skew = bool(skew > 0)
    anti = bool(st.a_anti_req[g][t_star])
    dom_t, valid_t = dom_sub[t_star], valid_sub[t_star]
    cnt_sub = take_rows(state.cnt_match, torch.where(tvalid, tsafe, -1))
    cnt_t = cnt_sub[t_star]
    ip_eff = torch.where(tvalid, st.ip_of[tsafe], -1)
    own_sub = take_rows(state.cnt_own_anti, ip_eff)
    own_t = own_sub[t_star]
    base = m_gpu
    if f.spread_hard:
        sh_excl = st.spread_hard[g] * (~onehot).to(_F32)
        base = base & topology_spread_filter(cnt_sub, valid_sub, sh_excl, m_static)
        base = base & (valid_t | (not use_skew))
    if f.interpod_req:
        base = base & interpod_filter(
            cnt_sub, own_sub, valid_sub, torch.where(tvalid, state.cnt_total[tsafe], 0.0),
            st.s_match[g] & ~onehot, st.a_aff_req[g], st.a_anti_req[g] & ~onehot)
    cap = torch.where(base, cap, torch.zeros_like(cap))

    d_n = rb.n_domains
    dev = cap.device
    safe_dom = torch.where(valid_t, dom_t, 0).long()
    on_key = valid_t.to(_F32)
    k_dom = torch.zeros(d_n, dtype=_F32, device=dev).index_add_(0, safe_dom, cap * on_key)
    c_dom = torch.zeros(d_n, dtype=_F32, device=dev).scatter_reduce_(
        0, safe_dom, cnt_t * on_key, "amax", include_self=True)
    own_dom = torch.zeros(d_n, dtype=_F32, device=dev).scatter_reduce_(
        0, safe_dom, own_t * on_key, "amax", include_self=True)
    elig_dom = torch.zeros(d_n, dtype=_F32, device=dev).scatter_reduce_(
        0, safe_dom, (valid_t & m_static).to(_F32), "amax", include_self=True) > 0
    open_dom = (c_dom <= 0) & (own_dom <= 0)
    if anti:
        k_dom = torch.minimum(k_dom, open_dom.to(_F32))

    # the level ladder: pour to (min + skew) until stuck or k exhausted
    x = torch.zeros(d_n, dtype=_F32, device=dev)
    rem = torch.tensor(float(k), dtype=_F32, device=dev)
    big = torch.full_like(x, _BIG)
    go = True
    while go and float(rem) > 0:
        cc = c_dom + x
        level = torch.where(elig_dom, cc, big).amin()
        level = torch.where(level >= _BIG, torch.zeros_like(level), level)
        room = _clip(level + skew - cc, 0.0, _BIG) if use_skew else big
        pour = torch.minimum(room, k_dom - x)
        cum = torch.cumsum(pour, 0)
        pour = _clip(rem - (cum - pour), 0.0, pour)
        tot = pour.sum()
        x = x + pour
        rem = rem - tot
        go = bool(tot > 0)

    # split each domain's intake across its nodes in index order
    n = cap.shape[0]
    key_d = torch.where(valid_t & (cap > 0), dom_t, torch.full_like(dom_t, d_n))
    order = torch.argsort(key_d, stable=True)
    key_o = key_d[order]
    cap_o = torch.where(key_o < d_n, cap[order], torch.zeros_like(cap))
    cum_o = torch.cumsum(cap_o, 0)
    excl_o = cum_o - cap_o
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = key_o[1:] != key_o[:-1]
    seg_base = torch.cummax(torch.where(is_start, excl_o, torch.zeros_like(excl_o)), 0).values
    before_o = excl_o - seg_base
    x_o = torch.where(key_o < d_n, x[key_o.clamp(0, d_n - 1).long()], torch.zeros_like(cap))
    allow_o = _clip(x_o - before_o, 0.0, cap_o)
    allow = torch.zeros(n, dtype=_F32, device=dev).index_copy_(0, order, allow_o)
    m_n = torch.where(valid_t, allow, cap)
    cum_m = torch.cumsum(m_n, 0)
    return _clip(torch.tensor(float(k), dtype=_F32, device=dev) - (cum_m - m_n), 0.0, m_n)


def round_pick_plain(rb: RoundBuffers, i: int, k: int, mode: int) -> None:
    """Plain version of K15: the per-node intake m_n of the round
    (`_round_core` :525-563, or `_quota_fill` on a quota round)."""
    cuda.count_plain("round_pick")
    t_cap = _round_terms(rb.buf, int(rb.buf.group[i]))[0]
    if mode & V_QUOTA and t_cap:
        rb.m_n[:] = _quota_fill(rb, i, k)
        return
    cap, s0, slope, m_all = rb.cap, rb.s0, rb.slope, rb.m_all
    zero = torch.zeros_like(cap)
    kt = torch.tensor(float(k), dtype=_F32, device=cap.device)

    def counts(tau):
        c = torch.where(s0 >= tau,
                        torch.where(slope > 0, torch.floor((s0 - tau) / torch.clamp(slope, min=1e-30)) + 1.0,
                                    cap),
                        zero)
        return torch.minimum(c, cap)

    kf = torch.minimum(kt, cap.sum())
    hi = s0.amax()
    low_slot = s0 - slope * _clip(cap - 1.0, 0.0, kt)
    lo = torch.where(m_all, low_slot, torch.full_like(cap, _BIG)).amin() - 1.0
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        over = counts(mid).sum() > kf
        lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
    m_n = counts(hi)
    cum_m = torch.cumsum(m_n, 0)
    m_n = _clip(kf - (cum_m - m_n), 0.0, m_n)
    extra_room = torch.maximum(counts(lo) - m_n, zero)
    cum = torch.cumsum(extra_room, 0)
    extra = _clip(kf - m_n.sum() - (cum - extra_room), 0.0, extra_room)
    rb.m_n[:] = m_n + extra


def _domain_add(rb: RoundBuffers, g: int, m_n: torch.Tensor) -> torch.Tensor:
    """[Tc, N] per-domain totals of m_n over the group's term rows,
    broadcast to every node of the domain (0 where the node misses the
    key): sums of integer-valued f32 counts, exact in any order."""
    buf = rb.buf
    _, _, tvalid, tsafe, dom_sub, valid_sub = _round_terms(buf, g)
    contrib = torch.where(valid_sub, m_n[None, :], torch.zeros_like(valid_sub, dtype=_F32))
    t_cap = contrib.shape[0]
    safe_d = torch.where(valid_sub, dom_sub, 0).long()
    sums = torch.zeros((t_cap, rb.n_domains), dtype=_F32, device=m_n.device)
    sums.scatter_add_(1, safe_d, contrib)
    return torch.where(valid_sub, torch.gather(sums, 1, safe_d), torch.zeros_like(contrib))


def round_commit_plain(rb: RoundBuffers, i: int, k: int, mode: int, row: int) -> None:
    """Plain version of K16: the round's batched state update IN PLACE
    (`_round_core` :565-671) and the slot expansion into output row `row`
    (:673-748)."""
    cuda.count_plain("round_commit")
    buf = rb.buf
    st, state, f = buf.statics, buf.state, buf.flags
    g, req = int(buf.group[i]), buf.req[i]
    m_n = rb.m_n.clone()
    pod = _pod_scalars(buf, i)
    ext_mats = bool(mode & V_MATS)
    t_cap, terms_g, tvalid, tsafe, dom_sub, valid_sub = _round_terms(buf, g)
    state.free.copy_(fma(-m_n[:, None], req[None, :], state.free))
    one = torch.clamp(m_n, max=1.0)
    if f.ports:
        state.ports_used.add_(one[:, None] * st.ports_req[g].to(_F32))
    if f.vols or f.attach:
        v_rw = st.vol_rw_req[g]
        v_present = v_rw | st.vol_ro_req[g] | st.vol_att_req[g]
        state.vols_any.add_(one[:, None] * v_present.to(_F32))
        if f.vols:
            state.vols_rw.add_(one[:, None] * v_rw.to(_F32))
    if t_cap:
        add_n = _domain_add(rb, g, m_n)
        s_match_g = st.s_match[g].to(_F32)
        add_rows(state.cnt_match, terms_g, s_match_g[:, None] * add_n)
        state.cnt_total.index_add_(0, tsafe.long(), s_match_g * (valid_sub.to(_F32) @ m_n))
        ip_eff = torch.where(tvalid, st.ip_of[tsafe], -1)
        if f.interpod_req:
            add_rows(state.cnt_own_anti, ip_eff, st.a_anti_req[g].to(_F32)[:, None] * add_n)
            add_rows(state.cnt_own_aff, ip_eff, st.a_aff_req[g].to(_F32)[:, None] * add_n)
        if f.interpod_pref:
            add_rows(state.w_own_aff_pref, ip_eff, st.w_aff_pref[g][:, None] * add_n)
            add_rows(state.w_own_anti_pref, ip_eff, st.w_anti_pref[g][:, None] * add_n)
    multi_lvm = ext_mats and pod["multi_lvm"]
    gpu_multi = ext_mats and pod["gpu_count"] > 1
    has_preset = ext_mats and int(pod["preset"].sum()) > 0
    count_f = max(float(pod["gpu_count"]), 1.0)
    if f.storage:
        take_vg = _unsort_take(m_n, rb.ord_vg, rb.cs_vg, rb.cum_vg)
        if multi_lvm:
            lvm_alloc = buf.st_alloc if int(buf.ext_live[i]) & 1 else torch.zeros_like(buf.st_alloc)
            state.vg_free.copy_(state.vg_free - m_n[:, None] * lvm_alloc)
        elif ext_mats:
            state.vg_free.copy_(state.vg_free - take_vg * pod["l_size"])
        else:
            state.vg_free.copy_(fma(-take_vg, pod["l_size"], state.vg_free))
        taken_dev = _unsort_take(m_n, rb.ord_dev, rb.cs_dev, rb.cum_dev) > 0
        state.sdev_free.logical_and_(~taken_dev)
    if f.gpu:
        gm = pod["gpu_mem"]
        if has_preset:
            upd = (m_n[:, None] * pod["preset"].to(_F32)[None, :]) * gm
            state.gpu_free.copy_(state.gpu_free - upd)
        elif gpu_multi:
            total_sh = m_n * count_f
            prev_g = rb.cum_gidx - rb.c_gpu
            pool_take = _clip(torch.minimum(rb.cum_gidx, total_sh[:, None]) - prev_g, 0.0, rb.c_gpu)
            state.gpu_free.copy_(state.gpu_free - pool_take * gm)
        elif ext_mats:
            take_gpu = _unsort_take(m_n, rb.ord_gpu, rb.cs_gpu, rb.cum_gpu)
            state.gpu_free.copy_(state.gpu_free - take_gpu * gm)
        else:
            take_gpu = _unsort_take(m_n, rb.ord_gpu, rb.cs_gpu, rb.cum_gpu)
            state.gpu_free.copy_(fma(-take_gpu, gm, state.gpu_free))

    # -- slot expansion
    k_cap = rb.k_cap
    dev = m_n.device
    slots = torch.arange(k_cap, dtype=_F32, device=dev)
    cum_slots = torch.cumsum(m_n, 0)
    assign = torch.searchsorted(cum_slots, slots, right=True)
    valid_slot = slots < cum_slots[-1]
    a_safe = torch.where(valid_slot, assign, torch.zeros_like(assign))
    ordinal = slots - (cum_slots[a_safe] - m_n[a_safe])

    def pick(order_x, cum_x):
        x_n = order_x.shape[1]
        if not x_n:
            return torch.full((k_cap,), -1, dtype=torch.int32, device=dev)
        rank = (cum_x[a_safe] <= ordinal[:, None]).sum(dim=1).clamp(0, x_n - 1)
        return order_x[a_safe, rank]

    neg = torch.full((k_cap,), -1, dtype=torch.int32, device=dev)
    vg_idx = dev_idx = gpu_idx = neg
    has_lvm, has_dev, is_gpu = pod["l_size"] > 0, pod["d_size"] > 0, pod["gpu_mem"] > 0
    if f.storage:
        vg_idx = torch.where(valid_slot & has_lvm, pick(rb.ord_vg, rb.cum_vg), neg)
        dev_idx = torch.where(valid_slot & has_dev, pick(rb.ord_dev, rb.cum_dev), neg)
    if f.gpu:
        gpu_idx = torch.where(valid_slot & is_gpu, pick(rb.ord_gpu, rb.cum_gpu), neg)
    rb.assign[row] = torch.where(valid_slot, assign.to(torch.int32), neg)
    rb.dev_idx[row] = dev_idx
    if not ext_mats:
        rb.vg_idx[row], rb.gpu_idx[row] = vg_idx, gpu_idx
        return
    v_n, gd_n = rb.lvm_mat.shape[2], rb.gpu_mat.shape[2]
    if f.storage and v_n:
        single_v = torch.nn.functional.one_hot(vg_idx.clamp(min=0).long(), v_n).to(_F32) * pod["l_size"]
        if multi_lvm:
            lvm_alloc = buf.st_alloc if int(buf.ext_live[i]) & 1 else torch.zeros_like(buf.st_alloc)
            lvm = lvm_alloc[a_safe]
        else:
            lvm = torch.where((vg_idx >= 0)[:, None], single_v, 0.0)
        rb.lvm_mat[row] = torch.where(valid_slot[:, None] & has_lvm, lvm, 0.0)
    if f.gpu and gd_n:
        if has_preset:
            gmat = pod["preset"].to(_F32)[None, :].expand(k_cap, gd_n)
        elif gpu_multi:
            cum_r = rb.cum_gidx[a_safe]
            per_r = rb.c_gpu[a_safe]
            start = ordinal * count_f
            gmat = _clip(torch.minimum(cum_r, (start + count_f)[:, None])
                         - torch.maximum(cum_r - per_r, start[:, None]), 0.0, per_r)
        else:
            gmat = torch.where((gpu_idx >= 0)[:, None],
                               torch.nn.functional.one_hot(gpu_idx.clamp(min=0).long(), gd_n).to(_F32),
                               0.0)
        rb.gpu_mat[row] = torch.where(valid_slot[:, None] & is_gpu, gmat, 0.0)


def round_score(rb: RoundBuffers, i: int, mode: int) -> None:
    """K14 (`kernels/csrc/round_score.cu`) for the round of pod i."""
    if rb.device.type == "cpu":
        round_score_plain(rb, i, mode)
    else:
        cuda.launch_round("round_score", rb, i, 0, mode, 0)


def round_pick(rb: RoundBuffers, i: int, k: int, mode: int) -> None:
    """K15 (`kernels/csrc/round_pick.cu`) for the round of pod i, run
    length k."""
    if rb.device.type == "cpu":
        round_pick_plain(rb, i, k, mode)
    else:
        cuda.launch_round("round_pick", rb, i, k, mode, 0)


def round_commit(rb: RoundBuffers, i: int, k: int, mode: int, row: int) -> None:
    """K16 (`kernels/csrc/round_commit.cu`) for the round of pod i, into
    output row `row`."""
    if rb.device.type == "cpu":
        round_commit_plain(rb, i, k, mode, row)
    else:
        cuda.launch_round("round_commit", rb, i, k, mode, row)


def run_round(rb: RoundBuffers, i: int, k: int, mode: int, row: int) -> None:
    """One round: the representative pod's cascade and plans (K1, K5/K6
    where it demands them, K2), then K14 -> K15 -> K16, no host sync."""
    buf = rb.buf
    filter_pod(buf, i)
    if buf.storage_live[i]:
        storage_pod(buf, i)
    if buf.gpu_live[i]:
        gpu_pod(buf, i)
    topology_pod(buf, i)
    round_score(rb, i, mode)
    round_pick(rb, i, k, mode)
    round_commit(rb, i, k, mode, row)


def variant_mode(quota: bool, self_aff: bool, ext_mats: bool) -> int:
    return (V_QUOTA if quota else 0) | (V_SELF_AFF if self_aff else 0) | (V_MATS if ext_mats else 0)


def rounds_scan(rb: RoundBuffers, firsts, ks, quota=False, self_aff=False, ext_mats=False):
    """The rounds of one chunk, in order, on `rb`'s state (in place): round
    s places up to ks[s] copies of pod firsts[s]. Returns the device
    outputs (assign, vg_idx, dev_idx, gpu_idx) [S, k_cap] — or, with
    `ext_mats`, (assign, dev_idx, lvm_mat [S, k_cap, V], gpu_mat
    [S, k_cap, GD]) — as the JAX `rounds_scan`."""
    mode = variant_mode(quota, self_aff, ext_mats)
    rb.alloc_outputs(len(firsts), _pow2(int(max(ks))) if len(ks) else 1)
    for s, (i, k) in enumerate(zip(firsts, ks)):
        run_round(rb, int(i), int(k), mode, s)
    if ext_mats:
        return rb.assign, rb.dev_idx, rb.lvm_mat, rb.gpu_mat
    return rb.assign, rb.vg_idx, rb.dev_idx, rb.gpu_idx


def _round_core(statics, state, pod, k, k_cap, tensors, flags, quota=False, self_aff=False,
                ext_mats=False):
    """One round of up to k copies of `pod` (a pod tuple of the
    `build_pod_arrays` layout, one row each) on `state`, IN PLACE, through
    the same wrappers the engine uses. Returns the outputs of `rounds_scan`
    for the single round, each without its leading axis."""
    pods = tuple(np.asarray(x)[None] for x in pod)
    buf = StepBuffers(statics, state, pods, flags)
    rb = RoundBuffers(buf, tensors)
    mode = variant_mode(quota, self_aff, ext_mats)
    rb.alloc_outputs(1, k_cap)
    run_round(rb, 0, int(k), mode, 0)
    outs = (rb.assign, rb.dev_idx, rb.lvm_mat, rb.gpu_mat) if ext_mats else (
        rb.assign, rb.vg_idx, rb.dev_idx, rb.gpu_idx)
    return tuple(o[0] for o in outs)


class RoundsEngine(Engine):
    """Engine that places eligible same-spec pod runs in bulk rounds and
    routes everything else through the inherited serial path (the per-pod
    kernels and the speculative wavefront).

    Drop-in for `Engine` via `simulate(..., bulk=True)` or
    `simulate(..., engine_factory=RoundsEngine)`."""

    #: minimum run length worth a bulk round (shorter runs ride the scan)
    MIN_RUN = 8
    #: maximum pods per bulk round — longer runs split into consecutive rounds
    MAX_RUN = 4096
    #: carried-row budget per bulk chunk of the JAX package (its chunk plan
    #: is kept: it is the dispatch order)
    ROW_BUDGET = 224
    #: max bulk runs per MATRIX chunk
    MATS_CHUNK = 256

    KIND_SERIAL = 0  # pod-by-pod serial path only
    KIND_PLAIN = 1  # plain bulk round (threshold search)
    KIND_QUOTA = 2  # domain-quota bulk round (one self-matching hard term)
    KIND_AFF = 3  # self-affinity round (domain-restricted threshold search)

    def _group_bulk_kind(self, tensors, gid: int) -> int:
        """How a group's runs may be placed in bulk (JAX `_group_bulk_kind`):
        PLAIN with no self-matching hard term, QUOTA with exactly one
        self-matching spread / anti-affinity term, AFF with exactly one
        self-matching required affinity term, else SERIAL."""
        s = tensors.s_match[gid]
        n_aff = int(np.count_nonzero(s & tensors.a_aff_req[gid]))
        n_as = int(np.count_nonzero(s & (tensors.a_anti_req[gid] | (tensors.spread_hard[gid] > 0))))
        if n_aff == 0 and n_as == 0:
            return self.KIND_PLAIN
        if n_aff == 0 and n_as == 1:
            return self.KIND_QUOTA
        if n_aff == 1 and n_as == 0:
            return self.KIND_AFF
        return self.KIND_SERIAL

    def _segments(self, batch, tensors):
        """Split the batch index space into ('bulk*' | 'scan', start, stop)
        (JAX `_segments`): runs are change points of group, request, kind,
        matrix bit and the extended demands; short or serial runs merge
        into scan segments; bulk runs split at MAX_RUN."""
        p = len(batch.group)
        if p == 0:
            return []
        ext = batch.ext
        group = np.asarray(batch.group)
        eligible = (np.asarray(batch.pin) == -1) & ~np.asarray(batch.forced)
        mats = np.zeros(p, bool)
        if ext["lvm_size"].shape[1]:
            mats |= (np.asarray(ext["lvm_size"]) > 0).sum(axis=1) > 1
            eligible &= ~(np.asarray(ext["lvm_vg"]) == -2).any(axis=1)
        if ext["dev_size"].shape[1]:
            eligible &= (np.asarray(ext["dev_size"]) > 0).sum(axis=1) <= 1
        gpu_mem = np.asarray(ext["gpu_mem"])
        gpu_count = np.asarray(ext["gpu_count"])
        has_gpu = gpu_mem > 0
        eligible &= ~has_gpu | (gpu_count >= 1)
        mats |= has_gpu & (gpu_count > 1)
        if ext["gpu_preset"].shape[1]:
            mats |= has_gpu & (np.asarray(ext["gpu_preset"]).sum(axis=1) > 0)
        group_kind = np.array(
            [self._group_bulk_kind(tensors, gid) for gid in range(len(tensors.groups))], np.int32)
        kind = np.where(eligible, group_kind[group], self.KIND_SERIAL)
        mats &= kind != self.KIND_SERIAL
        change = np.zeros(p, bool)
        change[0] = True
        change[1:] = ((group[1:] != group[:-1]) | np.any(batch.req[1:] != batch.req[:-1], axis=1)
                      | (kind[1:] != kind[:-1]) | (mats[1:] != mats[:-1]))
        for key in ("lvm_size", "lvm_vg", "dev_size", "dev_media", "gpu_preset"):
            arr = np.asarray(ext[key])
            if arr.shape[1]:
                change[1:] |= np.any(arr[1:] != arr[:-1], axis=1)
        for key in ("gpu_mem", "gpu_count"):
            arr = np.asarray(ext[key])
            change[1:] |= arr[1:] != arr[:-1]
        starts = np.flatnonzero(change)
        stops = np.append(starts[1:], p)
        segments = []
        names = {self.KIND_PLAIN: "bulk", self.KIND_QUOTA: "bulkq", self.KIND_AFF: "bulka"}
        for a, b in zip(starts.tolist(), stops.tolist()):
            if kind[a] != self.KIND_SERIAL and b - a >= self.MIN_RUN:
                name = names[kind[a]] + ("m" if mats[a] else "")
                for c in range(a, b, self.MAX_RUN):
                    segments.append((name, c, min(c + self.MAX_RUN, b)))
            elif segments and segments[-1][0] == "scan":
                segments[-1] = ("scan", segments[-1][1], b)
            else:
                segments.append(("scan", a, b))
        return segments

    def _run_scan_segment(self, buf, pods, a: int, b: int):
        """Pods [a, b) through the serial path on the shared state (the wave
        path when `speculate` is on); host outputs."""
        waves = self._run_range(buf, pods, a, b)
        return self._fetch_range(buf, a, b, waves)

    def _run_scan_segment_idx(self, buf, pods, idx):
        """One serial pass over an arbitrary index selection of the batch's
        pods (the batched leftover probes), on the shared state: the
        per-pod kernels, no waves, as the JAX package's plain scan call."""
        sub = StepBuffers(buf.statics, buf.state, tuple(np.asarray(arr)[idx] for arr in pods),
                          buf.flags)
        run_pods(sub, 0, len(idx))
        return self._fetch_range(sub, 0, len(idx))

    @staticmethod
    def _pad_rows(rows, t, floor: int = 1):
        """The JAX package's pow2 row padding of a chunk's term rows (None =
        the full plane)."""
        rows = np.asarray(rows, np.int32)
        u_pad = max(_pow2(len(rows)), floor)
        if u_pad >= t:
            return None
        pad = u_pad - len(rows)
        if pad > 0:
            unused = np.setdiff1d(np.arange(t, dtype=np.int32), rows, assume_unique=False)[:pad]
            rows = np.concatenate([rows, unused])
        return rows

    def _chunk_runs(self, run, batch, tensors, max_segs=None):
        """Split a stretch of bulk runs into the JAX package's chunks: term-
        row unions within ROW_BUDGET, at most max_segs runs for matrix
        rounds. Yields (chunk, rows_p)."""
        t = tensors.n_terms
        if _pow2(min(t, self.ROW_BUDGET)) >= t:
            if max_segs is None:
                yield run, None
            else:
                for c in range(0, len(run), max_segs):
                    yield run[c: c + max_segs], None
            return
        g_terms, _ = _compact_terms(tensors)
        group = np.asarray(batch.group)
        chunk, rows = [], set()
        for seg in run:
            seg_terms = {int(x) for x in g_terms[group[seg[1]]] if x >= 0}
            if chunk and ((len(rows | seg_terms) > self.ROW_BUDGET and _pow2(len(rows)) < t)
                          or (max_segs is not None and len(chunk) >= max_segs)):
                yield chunk, self._pad_rows(sorted(rows), t)
                chunk, rows = [], set()
            chunk.append(seg)
            rows |= seg_terms
        if chunk:
            yield chunk, self._pad_rows(sorted(rows), t)

    @staticmethod
    def _kind_flags(bkind: str):
        """(quota, self_aff, ext_mats) for a bulk segment kind."""
        return bkind in ("bulkq", "bulkqm"), bkind in ("bulka", "bulkam"), bkind.endswith("m")

    @staticmethod
    def _stretch_group(segments, idx: int):
        """Consume the maximal run of consecutive non-scan segments at idx
        into [(bulk kind, [same-kind segments]), ...]; returns (group_runs,
        next idx)."""
        group_runs = []
        while idx < len(segments) and segments[idx][0] != "scan":
            bkind = segments[idx][0]
            run = []
            while idx < len(segments) and segments[idx][0] == bkind:
                run.append(segments[idx])
                idx += 1
            group_runs.append((bkind, run))
        return group_runs, idx

    def _group_work_items(self, group_runs, batch, tensors):
        """(chunk, rows_p, quota, self_aff, ext_mats) per bulk chunk of one
        stretch group, in dispatch order."""
        for bkind, run in group_runs:
            quota, self_aff, ext_mats = self._kind_flags(bkind)
            for chunk, rows_p in self._chunk_runs(run, batch, tensors,
                                                  max_segs=self.MATS_CHUNK if ext_mats else None):
                yield chunk, rows_p, quota, self_aff, ext_mats

    @staticmethod
    def _record_chunk(chunk, hosts, nodes, reasons, lvm_alloc, dev_take, gpu_shares, gpu_mem,
                      lvm_sizes, dev_sizes, leftovers):
        assign_host, vg_host, dev_host, gpu_host = hosts
        for s, (_, i0, j0) in enumerate(chunk):
            row = assign_host[s]
            placed = int((row >= 0).sum())
            nodes[i0: i0 + placed] = row[:placed]
            reasons[i0: i0 + placed] = 0
            if placed:
                sel = np.arange(i0, i0 + placed)
                if lvm_sizes.shape[1] and lvm_sizes[i0].max() > 0:
                    vgs = vg_host[s, :placed]
                    ok_v = vgs >= 0
                    lvm_alloc[sel[ok_v], vgs[ok_v]] = lvm_sizes[i0].max()
                if dev_sizes.shape[1] and dev_sizes[i0].max() > 0:
                    devs = dev_host[s, :placed]
                    ok_d = devs >= 0
                    dev_take[sel[ok_d], devs[ok_d]] = True
                if gpu_mem[i0] > 0:
                    gpus = gpu_host[s, :placed]
                    ok_g = gpus >= 0
                    gpu_shares[sel[ok_g], gpus[ok_g]] = 1.0
            if placed < j0 - i0:
                leftovers.append((i0 + placed, j0))

    @staticmethod
    def _record_chunk_mats(chunk, hosts, nodes, reasons, lvm_alloc, dev_take, gpu_shares,
                           dev_sizes, leftovers):
        """Record a MATRIX chunk: per-slot LVM / GPU rows come back dense;
        only the (single) device claim stays an index."""
        assign_host, dev_host, lvm_host, gpu_host = hosts
        for s, (_, i0, j0) in enumerate(chunk):
            row = assign_host[s]
            placed = int((row >= 0).sum())
            nodes[i0: i0 + placed] = row[:placed]
            reasons[i0: i0 + placed] = 0
            if placed:
                sel = np.arange(i0, i0 + placed)
                if lvm_alloc.shape[1]:
                    lvm_alloc[sel] = lvm_host[s, :placed]
                if dev_sizes.shape[1] and dev_sizes[i0].max() > 0:
                    devs = dev_host[s, :placed]
                    ok_d = devs >= 0
                    dev_take[sel[ok_d], devs[ok_d]] = True
                if gpu_shares.shape[1]:
                    gpu_shares[sel] = gpu_host[s, :placed]
            if placed < j0 - i0:
                leftovers.append((i0 + placed, j0))

    def _bulk_chunk(self, rb: RoundBuffers, chunk, quota, self_aff, ext_mats):
        """Launch one chunk's rounds back to back (no host sync); returns
        the chunk's device outputs."""
        firsts = [i0 for _, i0, _ in chunk]
        ks = [j0 - i0 for _, i0, j0 in chunk]
        return rounds_scan(rb, firsts, ks, quota, self_aff, ext_mats)

    def _dispatch(self, buf: StepBuffers, pods):
        batch, tensors = self._current_batch, self._current_tensors
        segments = self._segments(batch, tensors)
        p = len(batch.group)
        ext = batch.ext
        gpu_mem = np.asarray(ext["gpu_mem"])
        st = buf.statics
        nodes = np.full(p, -1, np.int64)
        reasons = np.zeros(p, np.int32)
        lvm_alloc = np.zeros((p, st.vg_cap.shape[1]), np.float32)
        dev_take = np.zeros((p, st.sdev_cap.shape[1]), bool)
        gpu_shares = np.zeros((p, st.gpu_dev_exists.shape[1]), np.float32)
        outs_all = (nodes, reasons, lvm_alloc, dev_take, gpu_shares)
        rb = None
        idx = 0
        while idx < len(segments):
            kind, a, b = segments[idx]
            if kind == "scan":
                outs = self._run_scan_segment(buf, pods, a, b)
                for dst, src in zip(outs_all, outs):
                    dst[a:b] = src
                idx += 1
                continue
            # a stretch group: every chunk of every kind launched back to
            # back, ONE fetch for the group's outputs, then the leftovers
            group_runs, idx = self._stretch_group(segments, idx)
            if rb is None:
                rb = RoundBuffers(buf, tensors)
            pending = [
                (chunk, ext_mats, self._bulk_chunk(rb, chunk, quota, self_aff, ext_mats))
                for chunk, _, quota, self_aff, ext_mats in self._group_work_items(group_runs, batch, tensors)
            ]
            leftovers = []
            lvm_sizes = np.asarray(ext["lvm_size"])
            dev_sizes = np.asarray(ext["dev_size"])
            for chunk, ext_mats_c, outs_dev in pending:
                hosts = tuple(o.cpu().numpy() for o in outs_dev)
                if ext_mats_c:
                    self._record_chunk_mats(chunk, hosts, nodes, reasons, lvm_alloc, dev_take,
                                            gpu_shares, dev_sizes, leftovers)
                else:
                    self._record_chunk(chunk, hosts, nodes, reasons, lvm_alloc, dev_take, gpu_shares,
                                       gpu_mem, lvm_sizes, dev_sizes, leftovers)
            self._probe_leftovers(buf, pods, leftovers, *outs_all)
        return outs_all

    def _probe_leftovers(self, buf, pods, leftovers, nodes, reasons, lvm_alloc, dev_take, gpu_shares):
        """The JAX package's batched leftover probes (rounds.py :1588-1678),
        line for line: one serial pass probes the first pod of every
        leftover run; past the first placement, probes that placed are
        reverted through a signed delta (K7) and re-probed; the placed run's
        remainder walks the serial path; past four placements in one pass
        the rest go one run at a time."""
        pending = list(leftovers)
        while pending:
            firsts = np.array([a for a, _ in pending], np.int32)
            nodes_p, reasons_p, lvm_p, dev_p, gpu_p = self._run_scan_segment_idx(buf, pods, firsts)
            placed_pos = np.flatnonzero(nodes_p >= 0)
            stop = int(placed_pos[0]) if len(placed_pos) else len(pending)
            go_serial = len(placed_pos) > 4
            for j in range(stop):
                a2, b2 = pending[j]
                nodes[a2:b2] = -1
                reasons[a2:b2] = reasons_p[j]
            if stop == len(pending):
                break
            revert = [int(j) for j in placed_pos if j > stop]
            if revert:
                v_pad = _pow2(len(revert))
                r = pods[1].shape[1]
                g_a = np.zeros(v_pad, np.int32)
                n_a = np.zeros(v_pad, np.int32)
                w_a = np.zeros(v_pad, np.float32)
                req_a = np.zeros((v_pad, r), np.float32)
                vg_a = np.zeros((v_pad, lvm_p.shape[1]), np.float32)
                sd_a = np.zeros((v_pad, dev_p.shape[1]), bool)
                gp_a = np.zeros((v_pad, gpu_p.shape[1]), np.float32)
                for i, j in enumerate(revert):
                    g_a[i] = pods[0][firsts[j]]
                    n_a[i] = nodes_p[j]
                    w_a[i] = -1.0
                    req_a[i] = pods[1][firsts[j]]
                    vg_a[i] = lvm_p[j]
                    sd_a[i] = dev_p[j]
                    gp_a[i] = gpu_p[j] * pods[8][firsts[j]]
                apply_placement_deltas(buf.statics, buf.state, (g_a, n_a, w_a, req_a, vg_a, sd_a, gp_a))
            a2, b2 = pending[stop]
            nodes[a2], reasons[a2] = nodes_p[stop], 0
            lvm_alloc[a2], dev_take[a2], gpu_shares[a2] = lvm_p[stop], dev_p[stop], gpu_p[stop]
            if a2 + 1 < b2:
                outs2 = self._run_scan_segment(buf, pods, a2 + 1, b2)
                for dst, src in zip((nodes, reasons, lvm_alloc, dev_take, gpu_shares), outs2):
                    dst[a2 + 1: b2] = src
            pending = pending[stop + 1:]
            if go_serial:
                for a3, b3 in pending:
                    outs3 = self._run_scan_segment(buf, pods, a3, a3 + 1)
                    nodes[a3], reasons[a3] = outs3[0][0], outs3[1][0]
                    lvm_alloc[a3], dev_take[a3], gpu_shares[a3] = outs3[2][0], outs3[3][0], outs3[4][0]
                    if nodes[a3] < 0:
                        nodes[a3 + 1: b3] = -1
                        reasons[a3 + 1: b3] = reasons[a3]
                    elif a3 + 1 < b3:
                        outs3 = self._run_scan_segment(buf, pods, a3 + 1, b3)
                        for dst, src in zip((nodes, reasons, lvm_alloc, dev_take, gpu_shares), outs3):
                            dst[a3 + 1: b3] = src
                return
