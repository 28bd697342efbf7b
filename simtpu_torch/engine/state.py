"""Scheduling state — the per-pod loop's carry, as torch tensors.

The plain PyTorch counterpart of the JAX package's `engine/state.py` core:
`SchedState`, `build_state` (the rebuild from the host-side placement log)
and the row gather/scatter helpers, written as index ops. Unlike the JAX
carry, which is immutable, the port updates these planes IN PLACE: the
commit step (`kernels/csrc/commit_pod.cu`, or its plain version) adds the
placed pod into the chosen node's rows and the same-domain count rows.

`placement_delta_step` / `apply_placement_deltas` fold signed placement-log
entries into the state in place (w = +1 re-places, -1 evicts, 0 is a
padding no-op): the eviction and restore behind preemption, run on the card
by `kernels/csrc/delta_apply.cu` (K7).

`state_from_numpy` / `state_to_numpy` carry the JAX package's `SchedState`
fields, as numpy arrays, into the port and back — the tests feed identical
state to both packages through them.

Between batches the engine carries the state in the COMPACT layout
(`CompactState`, the section at the end): the count rows of topology keys
with at most DOM_SMALL domains as per-domain histograms, the other count
rows as int32, masks as bool. K11 `compact_compress` and K12
`compact_expand` convert between the two layouts, K13 `compact_delta`
applies signed log deltas straight to the compact carry.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.tensorize import COUNT_DTYPE, MASK_DTYPE
from ..kernels import cuda


def take_rows(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """`plane[rows]` as f32 for a [K, N] plane and a small [Tc] row vector;
    negative row ids yield ZERO rows."""
    out = torch.zeros((rows.shape[0], plane.shape[1]), dtype=torch.float32, device=plane.device)
    keep = rows >= 0
    if plane.shape[0] and bool(keep.any()):
        out[keep] = plane.index_select(0, rows[keep].long()).to(torch.float32)
    return out


def take_rows_i32(plane: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Integer-plane row gather; negative row ids yield 0 — callers that need
    a -1 sentinel for invalid rows must mask separately."""
    out = torch.zeros((rows.shape[0], plane.shape[1]), dtype=torch.int32, device=plane.device)
    keep = rows >= 0
    if plane.shape[0] and bool(keep.any()):
        out[keep] = plane.index_select(0, rows[keep].long()).to(torch.int32)
    return out


def add_rows(plane: torch.Tensor, rows: torch.Tensor, delta: torch.Tensor) -> None:
    """IN PLACE `plane[rows] += delta`; rows with a negative id are skipped."""
    keep = rows >= 0
    if bool(keep.any()):
        plane.index_add_(0, rows[keep].long(), delta[keep].to(plane.dtype))


def interpod_term_index(tensors) -> np.ndarray:
    """[T] → row in the compacted interpod ("own") count planes, -1 when the
    term appears in no group's required/preferred (anti-)affinity. Ascending
    term order; shared by statics_from and build_state so plane rows agree."""
    cached = getattr(tensors, "_ip_of_cache", None)
    if cached is not None:
        return cached
    t = tensors.n_terms
    if not t:
        ip_of = np.zeros(0, np.int32)
    else:
        used = (
            tensors.a_aff_req.any(axis=0)
            | tensors.a_anti_req.any(axis=0)
            | (tensors.w_aff_pref != 0).any(axis=0)
            | (tensors.w_anti_pref != 0).any(axis=0)
        )
        ip_of = np.full(t, -1, np.int32)
        ip_of[used] = np.arange(int(used.sum()), dtype=np.int32)
    object.__setattr__(tensors, "_ip_of_cache", ip_of)
    return ip_of


def _add_at_rows(dst: np.ndarray, idx: np.ndarray, src: np.ndarray) -> None:
    """dst[idx[i], :] += src[i, :], in log order."""
    if dst.size == 0 or len(idx) == 0:
        return
    np.add.at(dst, idx, src)


class SchedState(NamedTuple):
    """Mutable cluster state (field for field the JAX package's SchedState).

    Topology counts are stored per node: `cnt_*[t, n]` is the count in node
    n's domain for term t's topology key (0 where the node misses the key).

    free:            [N, R] remaining allocatable per node
    cnt_match:       [T, N] placed pods matching term t in node n's domain
    cnt_total:       [T] cluster-wide matching count per term
    cnt_own_anti:    [Ti, N] placed pods owning required anti-affinity term
    cnt_own_aff:     [Ti, N] placed pods owning required affinity term
    w_own_aff_pref:  [Ti, N] summed preferred-affinity weights of placed owners
    w_own_anti_pref: [Ti, N] summed preferred-anti-affinity weights
    vg_free:         [N, V] free LVM volume-group space (Open-Local)
    sdev_free:       [N, SD] exclusive storage devices still unallocated
    gpu_free:        [N, GD] free GPU memory per device (GPU-share)
    ports_used:      [N, P] in-use (protocol, hostPort) pairs (NodePorts)
    vols_any:        [N, W] users of exclusive volume w (VolumeRestrictions)
    vols_rw:         [N, W] read-write users of exclusive volume w

    The commit step (K4) takes a placed pod's LVM allocation out of
    `vg_free`, its exclusive devices out of `sdev_free` and its GPU shares
    times its per-GPU memory out of `gpu_free`; a signed log delta (K7)
    gives them back or takes them again.
    """

    free: torch.Tensor
    cnt_match: torch.Tensor
    cnt_total: torch.Tensor
    cnt_own_anti: torch.Tensor
    cnt_own_aff: torch.Tensor
    w_own_aff_pref: torch.Tensor
    w_own_anti_pref: torch.Tensor
    vg_free: torch.Tensor
    sdev_free: torch.Tensor
    gpu_free: torch.Tensor
    ports_used: torch.Tensor
    vols_any: torch.Tensor
    vols_rw: torch.Tensor


def state_from_numpy(fields, device) -> SchedState:
    """A SchedState on `device` from a mapping (or NamedTuple) of numpy
    arrays — e.g. the JAX package's SchedState carried across as numpy."""
    get = fields._asdict() if hasattr(fields, "_asdict") else fields
    return SchedState(
        **{
            name: torch.as_tensor(np.array(get[name]), device=device).contiguous()
            for name in SchedState._fields
        }
    )


def state_to_numpy(state: SchedState) -> SchedState:
    """The same SchedState with every plane copied to a host numpy array."""
    return SchedState(*(t.detach().cpu().numpy() for t in state))


def build_state(
    tensors,
    placed_group: np.ndarray,
    placed_node: np.ndarray,
    placed_req: np.ndarray,
    placed_ext: dict,
    device,
) -> SchedState:
    """Reconstruct the full state from the host-side placement log, the
    numpy computation of the JAX package's build_state, moved to `device`.
    Called at the start of every batch whose vocabulary changed."""
    n, r = tensors.alloc.shape
    t, d = tensors.n_terms, tensors.n_domains
    ip_of = interpod_term_index(tensors)
    ext = tensors.ext
    free = tensors.alloc.astype(np.float32).copy()
    vg_free = (ext.vg_cap - ext.vg_req0).astype(np.float32)
    sdev_free = (ext.sdev_cap > 0) & ~ext.sdev_alloc0
    gpu_free = ext.gpu_dev_total.astype(np.float32).copy()
    if placed_ext and len(placed_ext.get("node", ())):
        pn = np.asarray(placed_ext["node"], np.int32)
        _add_at_rows(vg_free, pn, -np.asarray(placed_ext["vg_alloc"], np.float32))
        np.minimum.at(sdev_free, pn, ~np.asarray(placed_ext["sdev_take"], bool))
        _add_at_rows(
            gpu_free,
            pn,
            -np.asarray(placed_ext["gpu_shares"], np.float32)
            * np.asarray(placed_ext["gpu_mem"], np.float32)[:, None],
        )
    ports_used = np.zeros((n, tensors.n_ports), np.float32)
    if len(placed_group) and tensors.n_ports:
        _add_at_rows(ports_used, placed_node, tensors.ports[placed_group].astype(np.float32))
    vols_any = np.zeros((n, tensors.n_vols), np.float32)
    vols_rw = np.zeros((n, tensors.n_vols), np.float32)
    if len(placed_group) and tensors.n_vols:
        rw = tensors.vol_rw[placed_group]
        present = rw | tensors.vol_ro[placed_group] | tensors.vol_att[placed_group]
        _add_at_rows(vols_any, placed_node, present.astype(np.float32))
        _add_at_rows(vols_rw, placed_node, rw.astype(np.float32))
    if len(placed_group):
        req = placed_req
        if req.shape[1] < r:  # resource vocab grew after this pod was logged
            req = np.pad(req, ((0, 0), (0, r - req.shape[1])))
        _add_at_rows(free, placed_node, -req)
    # Topology counts via group-level aggregation: the count of term t in
    # node n's domain is Σ_g incid[g, t] · (placements of group g in that
    # domain) — one (group, node) bincount plus a per-domain sum per key.
    ip_terms = np.flatnonzero(ip_of >= 0)  # ascending = plane row order
    cnt_match = np.zeros((t, n), np.float32)
    own_n = np.zeros((4, len(ip_terms), n), np.float32)
    cnt_total = np.zeros(t, np.float32)
    if t and len(placed_group):
        g_n = len(tensors.groups)
        term_topo = tensors.term_topo_key
        key_valid = tensors.node_dom >= 0  # [K, N]
        flat = placed_group.astype(np.int64) * n + placed_node
        cnt_gn = np.bincount(flat, minlength=g_n * n).reshape(g_n, n).astype(np.float32)
        cnt_dg, safe_k = {}, {}
        for k in {int(x) for x in term_topo[:t]}:
            safe_k[k] = np.where(key_valid[k], tensors.node_dom[k], 0)
            src = np.where(key_valid[k][None, :], cnt_gn, 0.0).T.copy()  # [N, G]
            buf = np.zeros((d, g_n), np.float32)
            _add_at_rows(buf, safe_k[k], src)
            cnt_dg[k] = buf
        tot_kg = {k: buf.sum(axis=0) for k, buf in cnt_dg.items()}
        row_cache = {}  # (key, group) → expanded [N] domain-count row

        def group_row(k, g_i):
            got = row_cache.get((k, g_i))
            if got is None:
                got = np.where(key_valid[k], cnt_dg[k][safe_k[k], g_i], 0.0)
                row_cache[(k, g_i)] = got
            return got

        def fill_rows(dst, term_ids, incid, totals=None):
            """dst[i] += Σ_g incid[g, term_ids[i]] · domain-count row of g;
            `totals` accumulates the per-term cluster-wide sum."""
            sub = incid if term_ids is None else incid[:, term_ids]
            for g_i, t_i in zip(*np.nonzero(sub)):
                tid = t_i if term_ids is None else term_ids[t_i]
                k = int(term_topo[tid])
                w = float(sub[g_i, t_i])
                dst[t_i] += w * group_row(k, g_i)
                if totals is not None:
                    totals[tid] += w * tot_kg[k][g_i]

        fill_rows(cnt_match, None, tensors.s_match, totals=cnt_total)
        for s_i, mat in enumerate(
            (tensors.a_anti_req, tensors.a_aff_req, tensors.w_aff_pref, tensors.w_anti_pref)
        ):
            fill_rows(own_n[s_i], ip_terms, mat)
    return state_from_numpy(
        dict(
            free=free,
            cnt_match=cnt_match,
            cnt_total=cnt_total,
            cnt_own_anti=own_n[0],
            cnt_own_aff=own_n[1],
            w_own_aff_pref=own_n[2],
            w_own_anti_pref=own_n[3],
            vg_free=vg_free,
            sdev_free=sdev_free,
            gpu_free=gpu_free,
            ports_used=ports_used,
            vols_any=vols_any,
            vols_rw=vols_rw,
        ),
        device,
    )


# -- batch apply / undo of placement deltas ----------------------------------
#
# The analog of the scheduler cache's AddPod/RemovePod pair: signed
# placement-log entries folded into the carried state in log order — +1
# re-places, -1 evicts, 0 is a padding no-op — without rebuilding the state
# from the whole log. Drives preemption (Engine._apply_saved_delta applies
# an eviction and its undo as the same call with opposite signs).


def placement_delta_step(statics, state: SchedState, entry) -> None:
    """Apply one placement-log entry to the state IN PLACE with weight w
    (+1 = re-place, -1 = evict): the JAX package's `placement_delta_step`,
    i.e. the commit step's update without filters or node choice. `entry` =
    (g, node, w, req [R], vg_alloc [V], sdev_take [SD], gpu_vec [GD])."""
    g, node, w, req, vg_alloc, sdev_take, gpu_vec = entry
    g, safe, w = int(g), max(int(node), 0), float(w)
    f32 = torch.float32
    state.free[safe] += -req * w
    if state.ports_used.shape[1]:
        state.ports_used[safe] += statics.ports_req[g].to(f32) * w
    if state.vols_any.shape[1]:
        v_rw = statics.vol_rw_req[g]
        v_present = v_rw | statics.vol_ro_req[g] | statics.vol_att_req[g]
        state.vols_any[safe] += v_present.to(f32) * w
        state.vols_rw[safe] += v_rw.to(f32) * w
    if state.vg_free.shape[1]:
        state.vg_free[safe] += -vg_alloc * w
    if state.sdev_free.shape[1]:
        # boolean devices: w > 0 consumes (clear), otherwise releases (set)
        row = state.sdev_free[safe]
        state.sdev_free[safe] = row & ~sdev_take if w > 0 else row | sdev_take
    if state.gpu_free.shape[1]:
        state.gpu_free[safe] += -gpu_vec * w
    t_cap = statics.g_terms.shape[1]
    if not t_cap or w == 0:
        return
    terms_g = statics.g_terms[g]
    tvalid = terms_g >= 0
    tsafe = terms_g.clamp(min=0)
    dom_sub = take_rows_i32(statics.node_dom, torch.where(tvalid, statics.term_topo[tsafe], -1))
    valid_sub = (dom_sub >= 0) & tvalid[:, None]
    dom_chosen = dom_sub[:, safe]
    valid_chosen = (dom_chosen >= 0) & tvalid
    same = valid_sub & (dom_sub == dom_chosen[:, None]) & valid_chosen[:, None]
    inc = same.to(f32) * w  # [Tc, N]
    add_rows(state.cnt_match, terms_g, statics.s_match[g].to(f32)[:, None] * inc)
    state.cnt_total.index_add_(
        0, terms_g[valid_chosen].long(), statics.s_match[g][valid_chosen].to(f32) * w
    )
    ip_eff = torch.where(tvalid, statics.ip_of[tsafe], -1)
    for plane, vals in (
        (state.cnt_own_anti, statics.a_anti_req[g].to(f32)),
        (state.cnt_own_aff, statics.a_aff_req[g].to(f32)),
        (state.w_own_aff_pref, statics.w_aff_pref[g]),
        (state.w_own_anti_pref, statics.w_anti_pref[g]),
    ):
        add_rows(plane, ip_eff, vals[:, None] * inc)


def apply_placement_deltas_plain(statics, state: SchedState, entries) -> None:
    """Plain version of K7: `placement_delta_step` over the packed entries,
    in order (w = 0 rows are exact no-ops)."""
    cuda.count_plain("delta_apply")
    dev = state.free.device
    g_a, n_a, w_a, req_a, vg_a, sd_a, gp_a = (torch.as_tensor(np.asarray(x), device=dev)
                                              for x in entries)
    for e in range(len(g_a)):
        if float(w_a[e]) == 0.0:
            continue
        placement_delta_step(
            statics, state, (g_a[e], n_a[e], w_a[e], req_a[e], vg_a[e], sd_a[e], gp_a[e])
        )


def apply_placement_deltas(statics, state: SchedState, entries) -> None:
    """Fold packed entries (`pack_delta_entries`) into the state IN PLACE,
    in order: K7 (`kernels/csrc/delta_apply.cu`) for a state on the card, in
    one launch; the plain version for a state on the CPU. Entries with
    w = -1 undo what the same entries with w = +1 applied."""
    if state.free.device.type == "cpu":
        apply_placement_deltas_plain(statics, state, entries)
    else:
        cuda.launch_delta(statics, state, entries)


def pack_delta_entries(entries, n_resources: int, vg_w: int, sd_w: int, gd_w: int,
                       sign: float, pad_to: int = None):
    """Padded entry arrays for `apply_placement_deltas` from saved
    placement-log records in `Engine.remove_placements`' layout ((g, node,
    req, ext_node, vg_alloc, sdev_take, gpu_shares, gpu_mem) per entry).
    Rows beyond len(entries) carry w = 0 and are exact no-ops; `pad_to`
    overrides the default pow2-bounded padding."""
    v = len(entries)
    v_pad = pad_to if pad_to is not None else 1 << max(v - 1, 0).bit_length()
    g_a = np.zeros(v_pad, np.int32)
    n_a = np.zeros(v_pad, np.int32)
    w_a = np.zeros(v_pad, np.float32)
    req_a = np.zeros((v_pad, n_resources), np.float32)
    vg_a = np.zeros((v_pad, vg_w), np.float32)
    sd_a = np.zeros((v_pad, sd_w), bool)
    gp_a = np.zeros((v_pad, gd_w), np.float32)
    for i, (g, node, req, _enode, vg, sdev, gpu_sh, gpu_mem) in enumerate(entries):
        g_a[i], n_a[i], w_a[i] = g, node, sign
        req_a[i, : req.shape[0]] = req
        vg_a[i] = vg
        sd_a[i] = sdev
        gp_a[i] = np.asarray(gpu_sh) * gpu_mem
    return (g_a, n_a, w_a, req_a, vg_a, sd_a, gp_a)


# -- compact carried state ---------------------------------------------------
#
# The carried count planes are [T, N] / [Ti, N] f32, but for every topology
# key with a small domain cardinality (key_kind == 1: zone / rack / region
# sized keys, <= DOM_SMALL compact ids in node_dom_small) the per-node value
# is CONSTANT within a domain: cnt[t, n] is "matching pods in node n's
# domain", the same number for every node of the domain and 0 where the key
# is absent. Between batches those rows travel as [Rt, D] histograms indexed
# by node_dom_small; the other rows (kind 2, unique per node, and kind 0)
# travel as [Rd, N] rows; integer planes are narrowed to COUNT_DTYPE and
# masks to MASK_DTYPE (core/tensorize.py). Compression gathers one
# representative node per (key, domain) — no reduction, so it is exact for
# domain-constant rows, which every state update (K4, K7, K9/K10, K13)
# keeps them; expansion is one gather through node_dom_small. Both are
# integer-valued casts, so expand(compress(s)) == s bit for bit.
#
# Unlike the JAX package's functional carry, the port's kernels update the
# dense state in place: expansion therefore writes FRESH planes, the
# continuous ones (free, vg_free, gpu_free, sdev_free) included, so a batch
# that fails part-way leaves the compact carry as it was.

#: compact-carry events of this process (read through `state_counts()`),
#: kept as the JAX package keeps its `state.compress` / `state.expand` /
#: `state.delta_direct` counters
STATE_COUNTS: Counter = Counter()
STATE_COUNT_KEYS = ("compress", "expand", "delta_direct")
#: the carried-state byte gauge, refreshed each time an engine stores a
#: carry (the JAX package's `state.*` gauges)
STATE_GAUGE: dict = {"carried_bytes": 0, "dense_bytes": 0, "compact": False, "planes": {}}


def state_counts() -> dict:
    """The compact-carry counters, one entry per STATE_COUNT_KEYS key."""
    return {k: STATE_COUNTS[k] for k in STATE_COUNT_KEYS}


def _memo(tensors, attr: str, key, build):
    """`build()` memoized under `key` in a dict kept on the frozen tensors."""
    cache = getattr(tensors, attr, None)
    if cache is None:
        cache = {}
        object.__setattr__(tensors, attr, cache)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def _on(nt, device):
    """A NamedTuple of tensors moved to `device`."""
    return type(nt)(*(t.to(device) for t in nt))


class CompactSpecDev(NamedTuple):
    """The index arrays driving compress/expand (int32 tensors, constant per
    tensors; `compact_spec` holds them on the CPU, `compact_spec_dev` on a
    device)."""

    t_tab: torch.Tensor  # [Rt] cnt_match rows with a kind-1 (tabular) key
    t_dense: torch.Tensor  # [Rd] the rest (kind 0/2) — Rt + Rd == T
    t_keys: torch.Tensor  # [Rt] topology key per tabular row
    t_rep: torch.Tensor  # [Rt, D] representative node per domain (-1 none)
    ip_tab: torch.Tensor  # [Rti] interpod-plane rows with a kind-1 key
    ip_dense: torch.Tensor  # [Rdi] — Rti + Rdi == Ti
    ip_keys: torch.Tensor  # [Rti]
    ip_rep: torch.Tensor  # [Rti, D]


class CompactSpec(NamedTuple):
    """Host-side compaction plan for one frozen tensors object."""

    enabled: bool  # any tabular row exists (else carry dense SchedState)
    d: int  # histogram width (max small-domain count over kind-1 keys)
    dev: Optional[CompactSpecDev]


def compact_spec(tensors) -> CompactSpec:
    """The (memoized) compaction plan: partition the cnt_match and interpod
    plane rows by their topology key's reduction kind, and precompute one
    representative node — the FIRST node carrying the domain id — per
    (kind-1 key, domain) for the representative-gather compression."""
    cached = getattr(tensors, "_compact_spec_cache", None)
    if cached is not None:
        return cached
    t = int(tensors.n_terms)
    kinds = tensors.key_kind if tensors.key_kind is not None else np.zeros(0, np.int32)
    nds = tensors.node_dom_small
    spec = CompactSpec(False, 1, None)
    if t and kinds.shape[0]:
        term_keys = np.asarray(tensors.term_topo_key[:t], np.int32)
        tab_mask = kinds[term_keys] == 1
        t_tab = np.flatnonzero(tab_mask).astype(np.int32)
        t_dense = np.flatnonzero(~tab_mask).astype(np.int32)
        if len(t_tab):
            d = 1
            for k in np.unique(term_keys[tab_mask]):
                d = max(d, int(nds[k].max(initial=-1)) + 1)
            rep = np.full((kinds.shape[0], d), -1, np.int32)
            for k in range(kinds.shape[0]):
                if kinds[k] != 1:
                    continue
                ids = nds[k]
                valid = np.flatnonzero(ids >= 0)
                # reversed, so the first node of each domain is written last
                rep[k, ids[valid][::-1]] = valid[::-1].astype(np.int32)
            ip_of = interpod_term_index(tensors)
            ip_terms = np.flatnonzero(ip_of >= 0)  # ascending = plane row order
            ip_tabm = tab_mask[ip_terms]
            ip_tab = np.flatnonzero(ip_tabm).astype(np.int32)
            ip_dense = np.flatnonzero(~ip_tabm).astype(np.int32)
            t_keys = term_keys[t_tab]
            ip_keys = term_keys[ip_terms[ip_tab]]
            dev = CompactSpecDev(*(torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (
                t_tab, t_dense, t_keys, rep[t_keys], ip_tab, ip_dense, ip_keys, rep[ip_keys])))
            spec = CompactSpec(True, d, dev)
    object.__setattr__(tensors, "_compact_spec_cache", spec)
    return spec


def compact_spec_dev(tensors, device) -> CompactSpecDev:
    """compact_spec(tensors).dev on `device` (memoized per device)."""
    return _memo(tensors, "_compact_spec_dev_cache", str(torch.device(device)),
                 lambda: _on(compact_spec(tensors).dev, device))


def _padded_map(plane: np.ndarray, n: int, device, min_rows: int = 0) -> torch.Tensor:
    plane = np.asarray(plane, np.int32)
    if plane.shape[0] < min_rows:
        plane = np.full((min_rows, plane.shape[1]), -1, np.int32)
    pad = n - plane.shape[1]
    if pad:
        plane = np.pad(plane, ((0, 0), (0, pad)), constant_values=-1)
    return torch.from_numpy(np.ascontiguousarray(plane)).to(device)


def node_dom_small_for(tensors, n: int, device) -> torch.Tensor:
    """tensors.node_dom_small as an int32 tensor on `device` whose node axis
    is padded to `n` with -1 (absent); memoized per width and device."""
    return _memo(tensors, "_nds_pad_cache", (n, str(torch.device(device))),
                 lambda: _padded_map(tensors.node_dom_small, n, device))


def node_dom_for(tensors, n: int, device) -> torch.Tensor:
    """tensors.node_dom the same way (one all -1 row when there is no key),
    the full-domain-id companion the direct delta reads at the chosen
    node; memoized per width and device."""
    return _memo(tensors, "_ndom_pad_cache", (n, str(torch.device(device))),
                 lambda: _padded_map(tensors.node_dom, n, device, min_rows=1))


class CompactState(NamedTuple):
    """SchedState's between-batch form: domain-tabular count planes,
    COUNT_DTYPE integers, MASK_DTYPE masks. Field pairs (`*_tab`, `*_dense`)
    partition the corresponding SchedState plane's rows; the continuous
    planes (free, vg_free, gpu_free) keep their f32 form."""

    free: torch.Tensor  # [N, R] f32
    cm_tab: torch.Tensor  # [Rt, D] cnt_match tabular rows
    cm_dense: torch.Tensor  # [Rd, N] cnt_match dense rows
    cnt_total: torch.Tensor  # [T]
    oa_tab: torch.Tensor  # cnt_own_anti
    oa_dense: torch.Tensor
    of_tab: torch.Tensor  # cnt_own_aff
    of_dense: torch.Tensor
    wa_tab: torch.Tensor  # w_own_aff_pref
    wa_dense: torch.Tensor
    wn_tab: torch.Tensor  # w_own_anti_pref
    wn_dense: torch.Tensor
    vg_free: torch.Tensor  # [N, V] f32
    sdev_free: torch.Tensor  # [N, SD] bool
    gpu_free: torch.Tensor  # [N, GD] f32
    ports_used: torch.Tensor  # [N, P]
    vols_any: torch.Tensor  # [N, W]
    vols_rw: torch.Tensor  # [N, W]


#: COUNT_DTYPE and MASK_DTYPE as torch dtypes
_COUNT = torch.from_numpy(np.zeros(0, COUNT_DTYPE)).dtype
_MASK = torch.from_numpy(np.zeros(0, MASK_DTYPE)).dtype
#: (CompactState tab field, dense field, SchedState plane) of the narrowed
#: count planes, in the order the kernels walk them
COMPACT_PLANES = (
    ("cm_tab", "cm_dense", "cnt_match"),
    ("oa_tab", "oa_dense", "cnt_own_anti"),
    ("of_tab", "of_dense", "cnt_own_aff"),
    ("wa_tab", "wa_dense", "w_own_aff_pref"),
    ("wn_tab", "wn_dense", "w_own_anti_pref"),
)


def _compress_rows(full, ids_tab, ids_dense, rep):
    """One [rows, N] f32 plane as its ([Rt, D] histogram, [Rd, N] rows)
    pair: a representative-node gather (domains without a node read 0) and
    a row gather, both cast to COUNT_DTYPE (truncating, exact for counts)."""
    tab = full.index_select(0, ids_tab.long()).gather(1, rep.clamp(min=0).long())
    tab = torch.where(rep >= 0, tab, torch.zeros((), dtype=full.dtype, device=full.device))
    return tab.to(_COUNT), full.index_select(0, ids_dense.long()).to(_COUNT)


def compress_state_plain(spec: CompactSpecDev, state: SchedState) -> CompactState:
    """Plain version of K11: the dense state in the compact layout. The
    continuous planes move over without a copy (the dense state is dropped
    after compression)."""
    cuda.count_plain("compact_compress")
    rows = {"cnt_match": (spec.t_tab, spec.t_dense, spec.t_rep)}
    out = {}
    for tab_f, dense_f, plane in COMPACT_PLANES:
        ids_tab, ids_dense, rep = rows.get(plane, (spec.ip_tab, spec.ip_dense, spec.ip_rep))
        out[tab_f], out[dense_f] = _compress_rows(getattr(state, plane), ids_tab, ids_dense, rep)
    return CompactState(
        free=state.free,
        cnt_total=state.cnt_total.to(_COUNT),
        vg_free=state.vg_free,
        sdev_free=state.sdev_free.to(_MASK, copy=True),
        gpu_free=state.gpu_free,
        ports_used=state.ports_used.to(_COUNT),
        vols_any=state.vols_any.to(_COUNT),
        vols_rw=state.vols_rw.to(_COUNT),
        **out,
    )


def _expand_rows(tab, dense, ids_tab, ids_dense, keys, nds):
    """The [rows, N] f32 plane: one gather of each histogram row through
    its key's node_dom_small ids (0 where the node misses the key), the
    dense rows cast back."""
    rows = tab.shape[0] + dense.shape[0]
    full = torch.zeros((rows, nds.shape[1]), dtype=torch.float32, device=nds.device)
    if tab.shape[0]:
        idx = nds.index_select(0, keys.long())  # [Rt, N]
        vals = tab.to(torch.float32).gather(1, idx.clamp(min=0).long())
        full[ids_tab.long()] = torch.where(idx >= 0, vals, torch.zeros((), device=nds.device))
    if dense.shape[0]:
        full[ids_dense.long()] = dense.to(torch.float32)
    return full


def expand_state_plain(spec: CompactSpecDev, cstate: CompactState, nds: torch.Tensor) -> SchedState:
    """Plain version of K12: the dense SchedState of a compact carry, every
    plane a fresh tensor (the engine's kernels update it in place, and the
    carry must survive a batch that fails part-way)."""
    cuda.count_plain("compact_expand")
    rows = {"cnt_match": (spec.t_tab, spec.t_dense, spec.t_keys)}
    out = {}
    for tab_f, dense_f, plane in COMPACT_PLANES:
        ids_tab, ids_dense, keys = rows.get(plane, (spec.ip_tab, spec.ip_dense, spec.ip_keys))
        out[plane] = _expand_rows(getattr(cstate, tab_f), getattr(cstate, dense_f), ids_tab,
                                  ids_dense, keys, nds)
    f32 = torch.float32
    return SchedState(
        free=cstate.free.clone(),
        cnt_total=cstate.cnt_total.to(f32),
        vg_free=cstate.vg_free.clone(),
        sdev_free=cstate.sdev_free.clone(),
        gpu_free=cstate.gpu_free.clone(),
        ports_used=cstate.ports_used.to(f32),
        vols_any=cstate.vols_any.to(f32),
        vols_rw=cstate.vols_rw.to(f32),
        **out,
    )


def compress_state(spec: CompactSpecDev, state: SchedState) -> CompactState:
    """The dense state in the compact layout: K11 (`kernels/csrc/
    compact_compress.cu`) in one launch for a state on the card, the plain
    version for a state on the CPU."""
    if state.free.device.type == "cpu":
        return compress_state_plain(spec, state)
    return CompactState(**cuda.launch_compact_compress(spec, state))


def expand_state(spec: CompactSpecDev, cstate: CompactState, nds: torch.Tensor) -> SchedState:
    """The dense SchedState of a compact carry, in fresh tensors: K12
    (`kernels/csrc/compact_expand.cu`) in one launch for a carry on the
    card, the plain version for a carry on the CPU."""
    if cstate.free.device.type == "cpu":
        return expand_state_plain(spec, cstate, nds)
    return SchedState(**cuda.launch_compact_expand(spec, cstate, nds))


# -- direct compact-delta apply ----------------------------------------------
#
# Preemption's evictions and restores replay small packed delta batches
# against the carry. On a compact carry they go STRAIGHT into it, with no
# expand -> K7 -> compress round trip: a kind-1 row is domain-constant, so
# the dense update (add the value on every node of the chosen node's
# domain) is ONE histogram bucket add at [row, node_dom_small[key, node]];
# dense rows and the continuous planes take placement_delta_step's per-row
# updates, routed through the inverse row maps below. Every count delta is
# an integer-valued f32, so accumulating in COUNT_DTYPE equals the dense
# f32 accumulate followed by the truncating compress cast.


class CompactDeltaSpec(NamedTuple):
    """Inverse row maps for scattering deltas into a CompactState: term axis
    -> carried-plane row, -1 when the term has no row on that plane."""

    t_tab_of: torch.Tensor  # [T] -> row in cm_tab, -1 if dense
    t_dense_of: torch.Tensor  # [T] -> row in cm_dense, -1 if tabular
    ip_tab_of: torch.Tensor  # [Ti] -> row in the *_tab interpod planes
    ip_dense_of: torch.Tensor  # [Ti] -> row in the *_dense interpod planes


def compact_delta_spec(tensors) -> CompactDeltaSpec:
    """The (memoized) inverse of compact_spec's row partition, on the CPU."""
    cached = getattr(tensors, "_compact_delta_spec_cache", None)
    if cached is not None:
        return cached
    dev = compact_spec(tensors).dev
    t = int(tensors.n_terms)

    def inverse(ids, size):
        ids = ids.numpy()
        of = np.full(size, -1, np.int32)
        of[ids] = np.arange(len(ids), dtype=np.int32)
        return torch.from_numpy(of)

    ti = int(dev.ip_tab.shape[0] + dev.ip_dense.shape[0])
    spec = CompactDeltaSpec(
        t_tab_of=inverse(dev.t_tab, t),
        t_dense_of=inverse(dev.t_dense, t),
        ip_tab_of=inverse(dev.ip_tab, ti),
        ip_dense_of=inverse(dev.ip_dense, ti),
    )
    object.__setattr__(tensors, "_compact_delta_spec_cache", spec)
    return spec


def compact_delta_spec_dev(tensors, device) -> CompactDeltaSpec:
    """compact_delta_spec(tensors) on `device` (memoized per device)."""
    return _memo(tensors, "_compact_delta_spec_dev_cache", str(torch.device(device)),
                 lambda: _on(compact_delta_spec(tensors), device))


def compact_delta_step(statics, dspec: CompactDeltaSpec, ndom, nds, cstate: CompactState, entry) -> None:
    """placement_delta_step retargeted at the compact carry, IN PLACE: the
    same continuous-plane updates (cast to the narrowed dtypes), topology
    counts as one histogram bucket add per tabular row and same-domain row
    adds for dense rows. `ndom` / `nds` are node_dom / node_dom_small at
    the carry's node width."""
    g, node, w, req, vg_alloc, sdev_take, gpu_vec = entry
    g, safe, w = int(g), max(int(node), 0), float(w)
    f32, cd = torch.float32, _COUNT
    cstate.free[safe] += -req * w
    if cstate.ports_used.shape[1]:
        cstate.ports_used[safe] += (statics.ports_req[g].to(f32) * w).to(cd)
    if cstate.vols_any.shape[1]:
        v_rw = statics.vol_rw_req[g]
        v_present = v_rw | statics.vol_ro_req[g] | statics.vol_att_req[g]
        cstate.vols_any[safe] += (v_present.to(f32) * w).to(cd)
        cstate.vols_rw[safe] += (v_rw.to(f32) * w).to(cd)
    if cstate.vg_free.shape[1]:
        cstate.vg_free[safe] += -vg_alloc * w
    if cstate.sdev_free.shape[1]:
        row = cstate.sdev_free[safe]
        cstate.sdev_free[safe] = row & ~sdev_take if w > 0 else row | sdev_take
    if cstate.gpu_free.shape[1]:
        cstate.gpu_free[safe] += -gpu_vec * w
    if not statics.g_terms.shape[1] or w == 0:
        return
    terms_g = statics.g_terms[g]
    tvalid = terms_g >= 0
    tsafe = terms_g.clamp(min=0).long()
    keys = torch.where(tvalid, statics.term_topo[tsafe], 0).clamp(min=0).long()
    # the chosen node's domain under each term's key, in the full (node_dom)
    # and the small (node_dom_small) numbering: the small id is the bucket
    dom_ch = torch.where(tvalid, ndom[keys, safe], -1)
    ds_ch = torch.where(tvalid, nds[keys, safe], -1)
    valid_ch = dom_ch >= 0
    wv = torch.where(valid_ch, w, 0.0)
    s_val = statics.s_match[g].to(f32) * wv
    cstate.cnt_total.index_add_(0, tsafe, s_val.to(cd))
    ip_eff = torch.where(tvalid, statics.ip_of[tsafe], -1)
    ip_vals = (
        ("oa_tab", "oa_dense", statics.a_anti_req[g].to(f32)),
        ("of_tab", "of_dense", statics.a_aff_req[g].to(f32)),
        ("wa_tab", "wa_dense", statics.w_aff_pref[g]),
        ("wn_tab", "wn_dense", statics.w_anti_pref[g]),
    )
    bucket = ds_ch.clamp(min=0).long()
    if cstate.cm_tab.shape[0]:
        t_row = torch.where(tvalid, dspec.t_tab_of[tsafe], -1)
        ok = (t_row >= 0) & (ds_ch >= 0) & valid_ch
        cstate.cm_tab.index_put_((t_row.clamp(min=0).long(), bucket),
                                 torch.where(ok, s_val, 0.0).to(cd), accumulate=True)
    if cstate.oa_tab.shape[0]:
        ip_row = torch.where(ip_eff >= 0, dspec.ip_tab_of[ip_eff.clamp(min=0).long()], -1)
        ok = (ip_row >= 0) & (ds_ch >= 0) & valid_ch
        for tab_f, _, vals in ip_vals:
            getattr(cstate, tab_f).index_put_((ip_row.clamp(min=0).long(), bucket),
                                              torch.where(ok, vals * wv, 0.0).to(cd), accumulate=True)
    if cstate.cm_dense.shape[0] or cstate.oa_dense.shape[0]:
        # dense rows keep placement_delta_step's same-domain compare
        dom_sub = ndom.index_select(0, keys)  # [Tc, N]
        same = (dom_sub >= 0) & tvalid[:, None] & (dom_sub == dom_ch[:, None]) & valid_ch[:, None]
        inc = torch.where(same, w, 0.0)
        if cstate.cm_dense.shape[0]:
            d_row = torch.where(tvalid, dspec.t_dense_of[tsafe], -1)
            add_rows(cstate.cm_dense, d_row, statics.s_match[g].to(f32)[:, None] * inc)
        if cstate.oa_dense.shape[0]:
            ipd_row = torch.where(ip_eff >= 0, dspec.ip_dense_of[ip_eff.clamp(min=0).long()], -1)
            for _, dense_f, vals in ip_vals:
                add_rows(getattr(cstate, dense_f), ipd_row, vals[:, None] * inc)


def apply_placement_deltas_compact_plain(statics, dspec, ndom, nds, cstate: CompactState,
                                         entries) -> None:
    """Plain version of K13: `compact_delta_step` over the packed entries,
    in order (w = 0 rows are exact no-ops)."""
    cuda.count_plain("compact_delta")
    dev = cstate.free.device
    g_a, n_a, w_a, req_a, vg_a, sd_a, gp_a = (torch.as_tensor(np.asarray(x), device=dev)
                                              for x in entries)
    for e in range(len(g_a)):
        if float(w_a[e]) == 0.0:
            continue
        compact_delta_step(statics, dspec, ndom, nds, cstate,
                           (g_a[e], n_a[e], w_a[e], req_a[e], vg_a[e], sd_a[e], gp_a[e]))


def apply_placement_deltas_compact(statics, dspec, ndom, nds, cstate: CompactState, entries) -> None:
    """Fold packed entries (`pack_delta_entries`) into a compact carry IN
    PLACE: K13 (`kernels/csrc/compact_delta.cu`) in one launch for a carry
    on the card, the plain version for a carry on the CPU."""
    if cstate.free.device.type == "cpu":
        apply_placement_deltas_compact_plain(statics, dspec, ndom, nds, cstate, entries)
    else:
        cuda.launch_compact_delta(statics, dspec, ndom, nds, cstate, entries)


def ensure_dense(state, tensors):
    """The dense SchedState view of a free-standing carried state (a
    CompactState is expanded through the memoized spec; a dense state
    passes through). For an engine's carry use `Engine.carried_state()`,
    which also checks that the carry is current."""
    if not isinstance(state, CompactState):
        return state
    device = state.free.device
    return expand_state(compact_spec_dev(tensors, device), state,
                        node_dom_small_for(tensors, state.free.shape[0], device))


def diff_state_planes(a, b) -> list:
    """Names of the planes whose values differ between two DENSE states,
    each tagged with its max absolute difference (or the shape mismatch)."""
    out = []
    for name, x, y in zip(a._fields, a, b):
        x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
        y = np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y)
        if x.shape != y.shape:
            out.append(f"{name}: shape {x.shape} vs {y.shape}")
        elif x.size and not np.array_equal(x, y):
            delta = np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)))
            out.append(f"{name}: max|d|={float(delta):g}")
    return out


def state_nbytes(state) -> dict:
    """Per-plane byte sizes of a carried state (SchedState or CompactState),
    from shapes and dtypes only."""
    return {name: int(t.numel()) * t.element_size() for name, t in zip(state._fields, state)}


def update_state_gauge(stored, dense_bytes: int) -> None:
    """Refresh STATE_GAUGE for the carry an engine just stored."""
    planes = state_nbytes(stored)
    STATE_GAUGE.update(carried_bytes=sum(planes.values()), dense_bytes=int(dense_bytes),
                       compact=isinstance(stored, CompactState), planes=planes)


# -- grow mode: append-only growth of a dense carry ---------------------------
#
# A grow-mode engine (`Engine.enable_grow`) carries a DENSE state whose term
# axes are padded to power-of-two buckets: cnt_match / cnt_total to t_cap
# rows, the four own planes to ti_cap rows, zero above the live counts.
# Every kernel indexes those planes by term id with a row stride of N, so
# the padding changes nothing they compute. A vocabulary growth extends
# the carry (K24 `grow_terms`: promote the buckets, add the appended term
# rows, re-gather the own planes through the new interpod layout) and a
# node growth widens it (K25 `grow_nodes`) instead of rebuilding it from
# the placement log. The host planners (`grow_plan_terms`,
# `grow_plan_nodes`) are the JAX package's, copied. K24/K25 write fresh
# planes (the JAX package donates the carry); the planes a growth does not
# touch are shared with the old carry, which the engine drops.


def snap_pow2(x: int, floor: int = 1) -> int:
    """Next power of two >= x (at least `floor`): the shape bucket of a
    grow-mode plane and of an appended-row batch."""
    return max(floor, 1 << max(int(x) - 1, 0).bit_length())


#: the `engine.grow` counter block's names (the JAX package's registry
#: family; `compile.grow` stays 0: the port has no per-shape executables,
#: and `grow.retensorize_fallbacks` belongs to the serve sessions, not
#: ported)
GROW_COUNTERS = (
    "grow.extends",
    "grow.bucket_promotions",
    "grow.node_extends",
    "grow.rebuilds",
    "grow.retensorize_fallbacks",
    "compile.grow",
)
#: grow-mode events of this process, keyed by GROW_COUNTERS names
GROW_COUNTS: Counter = Counter()


def grow_counters_doc() -> dict:
    """The append-only-growth counter block (process-lifetime counts),
    `grow.` prefix stripped, as `apply --json` carries it under
    `engine.grow`."""
    return {
        name.split("grow.", 1)[-1] if name.startswith("grow.") else name: int(GROW_COUNTS[name])
        for name in GROW_COUNTERS
    }


def _grow_aggregates(tensors, placed_group, placed_node, keys):
    """The per-key [D, G] domain aggregates build_state derives its count
    rows from, restricted to the topology keys a growth event touches."""
    n = tensors.alloc.shape[0]
    g_n = len(tensors.groups)
    d = tensors.n_domains
    key_valid = tensors.node_dom >= 0
    flat = placed_group.astype(np.int64) * n + placed_node
    cnt_gn = np.bincount(flat, minlength=g_n * n).reshape(g_n, n).astype(np.float32)
    cnt_dg, safe_k = {}, {}
    for k in keys:
        safe_k[k] = np.where(key_valid[k], tensors.node_dom[k], 0)
        src = np.where(key_valid[k][None, :], cnt_gn, 0.0).T.copy()
        buf = np.zeros((d, g_n), np.float32)
        _add_at_rows(buf, safe_k[k], src)
        cnt_dg[k] = buf
    return cnt_dg, safe_k, key_valid


def _term_rows_subset(tensors, placed_group, placed_node, term_ids):
    """Count rows + cluster totals for a SUBSET of terms, by the same
    aggregation build_state runs for all terms (integer-valued counts and
    the same ascending-group accumulation keep the rows bit-identical to a
    from-scratch rebuild's)."""
    n = tensors.alloc.shape[0]
    rows = np.zeros((len(term_ids), n), np.float32)
    tot = np.zeros(len(term_ids), np.float32)
    if not len(placed_group) or not len(term_ids):
        return rows, tot
    term_topo = tensors.term_topo_key
    keys = {int(term_topo[tid]) for tid in term_ids}
    cnt_dg, safe_k, key_valid = _grow_aggregates(tensors, placed_group, placed_node, keys)
    tot_kg = {k: buf.sum(axis=0) for k, buf in cnt_dg.items()}
    row_cache = {}

    def group_row(k, g_i):
        got = row_cache.get((k, g_i))
        if got is None:
            got = np.where(key_valid[k], cnt_dg[k][safe_k[k], g_i], 0.0)
            row_cache[(k, g_i)] = got
        return got

    sub = tensors.s_match[:, term_ids]
    for g_i, t_i in zip(*np.nonzero(sub)):
        tid = int(term_ids[t_i])
        k = int(term_topo[tid])
        w = float(sub[g_i, t_i])
        rows[t_i] += w * group_row(k, g_i)
        tot[t_i] += w * tot_kg[k][g_i]
    return rows, tot


def _node_cols_subset(tensors, placed_group, placed_node, node_ids):
    """Count-plane COLUMNS for appended nodes: cnt_match [T, a] plus the
    four own planes [Ti, a] evaluated at the new nodes' domains — a pod
    already placed in a zone a clone joins is counted on the clone."""
    t = tensors.n_terms
    ip_of = interpod_term_index(tensors)
    ip_terms = np.flatnonzero(ip_of >= 0)
    a = len(node_ids)
    cnt_cols = np.zeros((t, a), np.float32)
    own_cols = np.zeros((4, len(ip_terms), a), np.float32)
    if not len(placed_group) or not t:
        return cnt_cols, own_cols
    term_topo = tensors.term_topo_key
    keys = {int(x) for x in term_topo[:t]}
    cnt_dg, safe_k, key_valid = _grow_aggregates(tensors, placed_group, placed_node, keys)
    row_cache = {}

    def group_cols(k, g_i):
        got = row_cache.get((k, g_i))
        if got is None:
            got = np.where(key_valid[k][node_ids], cnt_dg[k][safe_k[k][node_ids], g_i], 0.0)
            row_cache[(k, g_i)] = got
        return got

    def fill(dst, term_ids, incid):
        sub = incid if term_ids is None else incid[:, term_ids]
        for g_i, t_i in zip(*np.nonzero(sub)):
            tid = t_i if term_ids is None else term_ids[t_i]
            k = int(term_topo[tid])
            dst[t_i] += float(sub[g_i, t_i]) * group_cols(k, g_i)

    fill(cnt_cols, None, tensors.s_match)
    for s_i, mat in enumerate((tensors.a_anti_req, tensors.a_aff_req, tensors.w_aff_pref,
                               tensors.w_anti_pref)):
        fill(own_cols[s_i], ip_terms, mat)
    return cnt_cols, own_cols


def grow_plan_terms(tensors, t_old: int, ip_terms_old, placed_group, placed_node):
    """Host-side plan for a term-axis growth event: appended term rows and
    totals (bucket-padded, ids -1 above the live count), the own-plane
    re-layout gather, and the target buckets. `ip_terms_old` is the
    ascending term-id layout the carried own planes were built under."""
    t_new = tensors.n_terms
    ip_of = interpod_term_index(tensors)
    ip_terms_new = np.flatnonzero(ip_of >= 0)
    ti_new = len(ip_terms_new)
    m = t_new - t_old
    m_cap = snap_pow2(m) if m else 0
    ids = np.full(m_cap, -1, np.int32)
    rows = np.zeros((m_cap, tensors.alloc.shape[0]), np.float32)
    tot = np.zeros(m_cap, np.float32)
    if m:
        new_ids = np.arange(t_old, t_new, dtype=np.int32)
        ids[:m] = new_ids
        rows[:m], tot[:m] = _term_rows_subset(tensors, placed_group, placed_node, new_ids)
    ti_cap = snap_pow2(ti_new) if ti_new else 0
    perm = np.full(max(ti_cap, 1), -1, np.int32)[:ti_cap]
    pos_old = {int(tid): i for i, tid in enumerate(np.asarray(ip_terms_old))}
    for j, tid in enumerate(ip_terms_new):
        perm[j] = pos_old.get(int(tid), -1)
    return {
        "ids": ids,
        "rows": rows,
        "tot": tot,
        "perm": perm,
        "t": t_new,
        "ti": ti_new,
        "t_cap": snap_pow2(t_new) if t_new else 0,
        "ti_cap": ti_cap,
        "ip_terms": ip_terms_new,
    }


def grow_plan_nodes(tensors, n_old: int, placed_group, placed_node, t_cap: int, ti_cap: int):
    """Host-side plan for a node-axis growth event (Tensorizer.add_clone_nodes
    appended rows [n_old:]): the new nodes' free/storage rows and the
    count-plane columns at the carried bucket heights."""
    n_new = tensors.alloc.shape[0]
    node_ids = np.arange(n_old, n_new)
    ext = tensors.ext
    cnt_cols, own_cols = _node_cols_subset(tensors, placed_group, placed_node, node_ids)
    t, ti = cnt_cols.shape[0], own_cols.shape[1]
    cnt_p = np.zeros((t_cap, len(node_ids)), np.float32)
    cnt_p[:t] = cnt_cols
    own_p = np.zeros((4, ti_cap, len(node_ids)), np.float32)
    own_p[:, :ti] = own_cols
    return {
        "free": tensors.alloc[n_old:].astype(np.float32),
        "cnt_cols": cnt_p,
        "own_cols": own_p,
        "vg": (ext.vg_cap[n_old:] - ext.vg_req0[n_old:]).astype(np.float32),
        "sdev": (ext.sdev_cap[n_old:] > 0) & ~ext.sdev_alloc0[n_old:],
        "gpu": ext.gpu_dev_total[n_old:].astype(np.float32),
        "n": n_new,
    }


#: the four interpod ("own") planes of a SchedState, in order
OWN_PLANES = ("cnt_own_anti", "cnt_own_aff", "w_own_aff_pref", "w_own_anti_pref")


class GrowTerms(NamedTuple):
    """K24's inputs beside the old planes, on the carry's device: `inv`
    [t_cap] the appended row feeding each bucket row (-1 = none), `rows`
    [M, N] / `tot` [M] the appended count rows and totals, `perm` [ti_cap]
    the old own-plane row feeding each new row (-1 = a zero row)."""

    inv: torch.Tensor
    rows: torch.Tensor
    tot: torch.Tensor
    perm: torch.Tensor
    t_cap: int
    ti_cap: int


def grow_terms_plain(state: SchedState, g: GrowTerms) -> dict:
    """K24's function: the six term planes in their buckets — cnt_match
    [t_cap, N] and cnt_total [t_cap] with the old rows (zero above them)
    plus each appended row at its id, the own planes [ti_cap, N] gathered
    through `perm`. Returns {plane name: fresh tensor}."""
    cuda.count_plain("grow_terms")
    n = state.free.shape[0]
    device = state.free.device
    t_old = state.cnt_match.shape[0]
    cm = torch.zeros((g.t_cap, n), dtype=torch.float32, device=device)
    ct = torch.zeros(g.t_cap, dtype=torch.float32, device=device)
    cm[:t_old] = state.cnt_match
    ct[:t_old] = state.cnt_total
    hit = torch.nonzero(g.inv >= 0).reshape(-1)
    src = g.inv[hit].long()
    cm[hit] = cm[hit] + g.rows[src]
    ct[hit] = ct[hit] + g.tot[src]
    out = {"cnt_match": cm, "cnt_total": ct}
    live = g.perm >= 0
    for name in OWN_PLANES:
        plane = getattr(state, name)
        new = torch.zeros((g.ti_cap, n), dtype=torch.float32, device=device)
        if plane.shape[0] and g.ti_cap:
            new[live] = plane[g.perm[live].long()]
        out[name] = new
    return out


def grow_terms(state: SchedState, g: GrowTerms) -> SchedState:
    """K24 in one launch for a carry on the card, its plain version for a
    carry on the CPU: the state with its six term planes replaced by fresh
    bucketed ones (the other planes shared)."""
    if state.free.device.type == "cpu":
        planes = grow_terms_plain(state, g)
    else:
        planes = cuda.launch_grow_terms(state, g)
    return state._replace(**planes)


def _grow_terms_inputs(state: SchedState, ids, rows, tot, perm, t_cap: int, ti_cap: int) -> GrowTerms:
    """GrowTerms on the carry's device from a host plan's ids / rows / tot
    / perm (the appended ids are distinct, so each bucket row has at most
    one appended row)."""
    device = state.free.device
    ids = np.asarray(ids, np.int64)
    inv = np.full(t_cap, -1, np.int32)
    live = np.flatnonzero(ids >= 0)
    inv[ids[live]] = live
    n = state.free.shape[0]
    rows = np.asarray(rows, np.float32).reshape(-1, n)
    return GrowTerms(
        inv=torch.as_tensor(inv, device=device),
        rows=torch.as_tensor(np.ascontiguousarray(rows), device=device),
        tot=torch.as_tensor(np.asarray(tot, np.float32), device=device),
        perm=torch.as_tensor(np.asarray(perm, np.int32), device=device),
        t_cap=int(t_cap), ti_cap=int(ti_cap))


def pad_terms(state: SchedState, t_cap: int, ti_cap: int) -> SchedState:
    """A freshly built exact-shape state copied into its term buckets
    (zero rows above the live counts): the JAX package's
    `_pad_terms_kernel`, K24 with no appended rows and the identity
    own-plane layout."""
    ti = state.cnt_own_anti.shape[0]
    perm = np.full(ti_cap, -1, np.int32)
    perm[: min(ti, ti_cap)] = np.arange(min(ti, ti_cap), dtype=np.int32)
    n = state.free.shape[0]
    return grow_terms(state, _grow_terms_inputs(state, np.zeros(0, np.int32), np.zeros((0, n), np.float32),
                                                np.zeros(0, np.float32), perm, t_cap, ti_cap))


def extend_state(state: SchedState, plan: dict) -> SchedState:
    """Apply a `grow_plan_terms` plan to a grow-mode carry (the JAX
    package's `_extend_terms_kernel`, through K24)."""
    return grow_terms(state, _grow_terms_inputs(state, plan["ids"], plan["rows"], plan["tot"], plan["perm"],
                                                plan["t_cap"], plan["ti_cap"]))


#: the planes K25 widens and what fills the new nodes' part: "rows" (the
#: plan's rows), "cols" (the plan's columns) or "zeros"
NODE_GROWTH = (
    ("free", "rows"), ("cnt_match", "cols"), ("cnt_own_anti", "cols"), ("cnt_own_aff", "cols"),
    ("w_own_aff_pref", "cols"), ("w_own_anti_pref", "cols"), ("vg_free", "rows"),
    ("sdev_free", "rows"), ("gpu_free", "rows"), ("ports_used", "zeros"), ("vols_any", "zeros"),
    ("vols_rw", "zeros"),
)


def node_growth_inputs(state: SchedState, plan: dict) -> dict:
    """{plane name: the new nodes' part} of a `grow_plan_nodes` plan, on the
    carry's device in the planes' dtypes (None = zeros)."""
    device = state.free.device

    def on(x, like):
        return torch.as_tensor(np.ascontiguousarray(x), device=device).to(like.dtype)

    add = {"free": on(plan["free"], state.free), "cnt_match": on(plan["cnt_cols"], state.cnt_match),
           "vg_free": on(plan["vg"], state.vg_free), "sdev_free": on(plan["sdev"], state.sdev_free),
           "gpu_free": on(plan["gpu"], state.gpu_free)}
    for i, name in enumerate(OWN_PLANES):
        add[name] = on(plan["own_cols"][i], getattr(state, name))
    return {name: add.get(name) for name, _ in NODE_GROWTH}


def grow_nodes_plain(state: SchedState, add: dict, a: int) -> dict:
    """K25's function: every plane but cnt_total widened from N to N + a
    nodes — the old values, then the new nodes' rows or columns from `add`
    (zeros where `add` has none). Returns {plane name: fresh tensor}."""
    cuda.count_plain("grow_nodes")
    out = {}
    for name, kind in NODE_GROWTH:
        plane = getattr(state, name)
        extra = add[name]
        if kind == "cols":
            out[name] = torch.cat([plane, extra], dim=1)
        else:
            if extra is None:
                extra = torch.zeros((a, plane.shape[1]), dtype=plane.dtype, device=plane.device)
            out[name] = torch.cat([plane, extra], dim=0)
    return out


def extend_state_nodes(state: SchedState, plan: dict) -> SchedState:
    """Apply a `grow_plan_nodes` plan (the JAX package's
    `_extend_nodes_kernel`): K25 in one launch for a carry on the card, its
    plain version for a carry on the CPU. cnt_total is shared."""
    a = plan["n"] - state.free.shape[0]
    add = node_growth_inputs(state, plan)
    if state.free.device.type == "cpu":
        planes = grow_nodes_plain(state, add, a)
    else:
        planes = cuda.launch_grow_nodes(state, add, a)
    return state._replace(**planes)


def strip_term_padding(state: SchedState, t: int, ti: int) -> SchedState:
    """Exact-shape dense view of a grow-mode (bucket-padded) carry: what
    carried_state() hands to consumers expecting [T, N] / [Ti, N] planes.
    The planes are row slices of the live carry (views, no copy): a
    consumer reads them and must not write through them."""
    if state.cnt_match.shape[0] == t and state.cnt_own_anti.shape[0] == ti:
        return state
    return state._replace(
        cnt_match=state.cnt_match[:t],
        cnt_total=state.cnt_total[:t],
        cnt_own_anti=state.cnt_own_anti[:ti],
        cnt_own_aff=state.cnt_own_aff[:ti],
        w_own_aff_pref=state.w_own_aff_pref[:ti],
        w_own_anti_pref=state.w_own_anti_pref[:ti],
    )
