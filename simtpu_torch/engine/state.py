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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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
