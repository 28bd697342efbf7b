"""Scheduling state — the per-pod loop's carry, as torch tensors.

The plain PyTorch counterpart of the JAX package's `engine/state.py` core:
`SchedState`, `build_state` (the rebuild from the host-side placement log)
and the row gather/scatter helpers, written as index ops. Unlike the JAX
carry, which is immutable, the port updates these planes IN PLACE: the
commit step (`kernels/csrc/commit_pod.cu`, or its plain version) adds the
placed pod into the chosen node's rows and the same-domain count rows.

`state_from_numpy` / `state_to_numpy` carry the JAX package's `SchedState`
fields, as numpy arrays, into the port and back — the tests feed identical
state to both packages through them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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

    This slice places no storage or GPU-share pod, so `vg_free`,
    `sdev_free` and `gpu_free` are carried unchanged.
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
