"""The serial placement engine: one scheduling cycle per pod, over all nodes.

The PyTorch counterpart of the JAX package's `engine/scan.py` serial core.
Each pod runs a full scheduling cycle (filter → score → select → state
update) over the whole node axis; pods are strictly ordered like the
reference's serial loop. Ties go to the lowest node index.

On the device the per-pod step is four hand-written CUDA kernels
(`kernels/csrc/`), launched back to back for pod `i` with no host sync:

- K1 `filter_pod`: the per-node filter stages (static/pin/valid, ports,
  resources, volumes, attach limits, volume binding) → one byte of
  cumulative stage bits per node;
- K2 `topology_pod`: the `[Tc, N]` work of the group's term rows — the
  hard-spread and inter-pod filters (stage bits 6 and 7) and the raw
  inter-pod, soft-spread and selector-spread count vectors;
- K3 `score_argmax_pod`: the first failing stage, the normalizers, the
  weighted score sum in the JAX package's term order, the argmax (lowest
  index on ties) and the forced-pod override → chosen, placed, reason;
- K4 `commit_pod`: the state update at the chosen node, IN PLACE.

Each kernel's wrapper below decides by the device of the tensors it is
given: CPU tensors go to its plain PyTorch version (same module), CUDA
tensors launch the kernel or raise. The plain versions are built from the
textbook functions `node_masks`, `topology_masks`, `topology_raws`,
`score_pod`, `choose` and `commit`, which mirror the JAX functions line by
line; `filter_and_score` and `schedule_step` compose them.

Bit layout of the stage byte (each bit implies the ones before it):
0 static, 1 ports, 2 resources, 3 volumes, 4 attach, 5 bind, 6 spread,
7 all. Storage and GPU-share stages equal `bind` in this slice.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..core.tensorize import ClusterTensors, PodBatch
from ..kernels import cuda
from ..kernels.filters import (
    attach_limits_ok,
    interpod_filter,
    ports_conflict_free,
    resources_fit,
    topology_spread_filter,
    volume_conflict_free,
)
from ..kernels.fp import fma
from ..kernels.scores import (
    interpod_score,
    maxabs_normalize,
    minmax_normalize,
    resource_base_score,
    selector_spread_from_counts,
    simon_minmax,
    spread_score_from_raw,
    taint_toleration_score,
)
from .state import (
    SchedState,
    add_rows,
    build_state,
    interpod_term_index,
    take_rows,
    take_rows_i32,
)

# Failure-reason codes (the host maps them to the scheduler's
# "0/N nodes are available: ..." status strings)
OK = 0
FAIL_STATIC = 1  # affinity / selector / taints / pin — no node passed
FAIL_RESOURCES = 2  # insufficient free resources on every remaining node
FAIL_INTERPOD = 3  # inter-pod (anti-)affinity rules
FAIL_NO_NODE = 4  # forced pod names an unknown node
FAIL_STORAGE = 5  # Open-Local LVM/device storage
FAIL_GPU = 6  # GPU-share memory/devices
FAIL_PORTS = 7  # requested host port already in use everywhere feasible
FAIL_SPREAD = 8  # topology spread maxSkew would be violated everywhere
FAIL_VOLUME = 9  # exclusive volume (EBS/GCE-PD/ISCSI/RBD) conflict everywhere
FAIL_ATTACH = 10  # node volume attach limits exceeded everywhere
FAIL_VOLUME_BIND = 11  # PVC missing / not bindable / PV zone mismatch

REASON_TEXT = {
    FAIL_STATIC: "node(s) didn't match node selector/affinity or had untolerated taints",
    FAIL_RESOURCES: "insufficient cpu/memory/extended resources on every feasible node",
    FAIL_INTERPOD: "node(s) didn't satisfy inter-pod affinity/anti-affinity rules",
    FAIL_NO_NODE: "pod references a node that does not exist",
    FAIL_STORAGE: "insufficient open-local storage (LVM volume groups / exclusive devices)",
    FAIL_GPU: "insufficient GPU memory on every feasible node's devices",
    FAIL_PORTS: "node(s) didn't have free ports for the requested pod ports",
    FAIL_SPREAD: "node(s) didn't match pod topology spread constraints",
    FAIL_VOLUME: "node(s) had a volume attach conflict for the requested volumes",
    FAIL_ATTACH: "node(s) exceeded max volume count for the requested volumes",
    FAIL_VOLUME_BIND: (
        "persistentvolumeclaim not found, not bindable, or bound to a volume "
        "unreachable from the node's zone"
    ),
}

#: The filter cascade in registry evaluation order: (StepEval mask field,
#: failure code when that stage is the first to empty the candidate set).
#: The final (m_all, FAIL_INTERPOD) entry is the cascade default.
FILTER_CASCADE = (
    ("m_static", FAIL_STATIC),
    ("m_ports", FAIL_PORTS),
    ("m_res", FAIL_RESOURCES),
    ("m_vol", FAIL_VOLUME),
    ("m_att", FAIL_ATTACH),
    ("m_bind", FAIL_VOLUME_BIND),
    ("m_storage", FAIL_STORAGE),
    ("m_gpu", FAIL_GPU),
    ("m_spread", FAIL_SPREAD),
    ("m_all", FAIL_INTERPOD),
)


class StaticArrays(NamedTuple):
    """Per-simulation constants (the fields of the JAX package's
    StaticArrays that the serial path without storage/GPU reads).

    Unlike the JAX package, constant [G, N] planes are NOT collapsed to one
    row: every `[G, ...]` plane has all G rows, so a group index never needs
    XLA's clamping gather."""

    alloc: torch.Tensor  # [N, R] f32
    static_mask: torch.Tensor  # [G, N] bool
    vol_mask: torch.Tensor  # [G, N] bool VolumeBinding+VolumeZone feasibility
    node_pref: torch.Tensor  # [G, N] f32
    taint_intol: torch.Tensor  # [G, N] f32
    static_score: torch.Tensor  # [G, N] f32 ImageLocality score
    avoid_pen: torch.Tensor  # [G, N] f32 NodePreferAvoidPods penalty
    node_dom: torch.Tensor  # [K, N] i32 node domain per topology key (-1 absent)
    term_topo: torch.Tensor  # [T] i32 topology-key index per term
    ip_of: torch.Tensor  # [T] i32 interpod-plane row per term (-1 none)
    g_terms: torch.Tensor  # [G, Tc] i32 relevant term indices (-1 pad)
    s_match: torch.Tensor  # [G, Tc] bool
    a_aff_req: torch.Tensor  # [G, Tc] bool
    a_anti_req: torch.Tensor  # [G, Tc] bool
    w_aff_pref: torch.Tensor  # [G, Tc] f32
    w_anti_pref: torch.Tensor  # [G, Tc] f32
    spread_hard: torch.Tensor  # [G, Tc] f32 maxSkew (0 = inactive)
    spread_soft: torch.Tensor  # [G, Tc] f32 ScheduleAnyway multiplicity
    ss_host: torch.Tensor  # [G, Tc] bool SelectorSpread hostname terms
    ss_zone: torch.Tensor  # [G, Tc] bool SelectorSpread zone terms
    ports_req: torch.Tensor  # [G, P] bool
    vol_rw_req: torch.Tensor  # [G, W] bool
    vol_ro_req: torch.Tensor  # [G, W] bool
    vol_att_req: torch.Tensor  # [G, W] bool
    vol_class_mask: torch.Tensor  # [C, W] bool
    attach_limits: torch.Tensor  # [N, C] f32
    score_w: torch.Tensor  # [schedconfig.N_TERMS] f32
    node_valid: torch.Tensor  # [N] bool


_STATIC_DTYPES = {
    "alloc": np.float32, "static_mask": bool, "vol_mask": bool,
    "node_pref": np.float32, "taint_intol": np.float32,
    "static_score": np.float32, "avoid_pen": np.float32,
    "node_dom": np.int32, "term_topo": np.int32, "ip_of": np.int32,
    "g_terms": np.int32, "s_match": bool, "a_aff_req": bool,
    "a_anti_req": bool, "w_aff_pref": np.float32, "w_anti_pref": np.float32,
    "spread_hard": np.float32, "spread_soft": np.float32, "ss_host": bool,
    "ss_zone": bool, "ports_req": bool, "vol_rw_req": bool,
    "vol_ro_req": bool, "vol_att_req": bool, "vol_class_mask": bool,
    "attach_limits": np.float32, "score_w": np.float32, "node_valid": bool,
}
_GROUP_NODE_PLANES = (
    "static_mask", "vol_mask", "node_pref", "taint_intol", "static_score", "avoid_pen",
)


def statics_from_numpy(fields, device) -> StaticArrays:
    """StaticArrays on `device` from a mapping (or NamedTuple, e.g. the JAX
    package's StaticArrays fetched to numpy) of host arrays. A [G, N] plane
    that arrives collapsed to [1, N] is broadcast back to all G rows."""
    get = fields._asdict() if hasattr(fields, "_asdict") else fields
    g_n = np.asarray(get["g_terms"]).shape[0]
    out = {}
    for name, dtype in _STATIC_DTYPES.items():
        arr = np.asarray(get[name], dtype)
        if name in _GROUP_NODE_PLANES and arr.shape[0] != g_n:
            arr = np.broadcast_to(arr, (g_n, arr.shape[1]))
        out[name] = torch.as_tensor(np.array(arr), device=device).contiguous()
    return StaticArrays(**out)


def build_pod_arrays(batch: PodBatch, n_resources: int):
    """Pad the batch's request matrix to the cluster resource vocabulary and
    stack the per-pod arrays in the order the step unpacks them (the JAX
    package's pod-tuple layout). Returns (padded_req, pods_tuple)."""
    req = batch.req
    if req.shape[1] < n_resources:
        req = np.pad(req, ((0, 0), (0, n_resources - req.shape[1])))
    ext = batch.ext
    pods = (
        np.asarray(batch.group, np.int32),
        np.asarray(req, np.float32),
        np.asarray(batch.pin, np.int32),
        np.asarray(batch.forced),
        np.asarray(ext["lvm_size"], np.float32),
        np.asarray(ext["lvm_vg"], np.int32),
        np.asarray(ext["dev_size"], np.float32),
        np.asarray(ext["dev_media"], np.int32),
        np.asarray(ext["gpu_mem"], np.float32),
        np.asarray(ext["gpu_count"], np.int32),
        np.asarray(ext["gpu_preset"], np.int32),
    )
    return req, pods


def _compact_terms(tensors: ClusterTensors):
    """Per-group relevant-term compaction: g_terms[g] lists the <= Tc term
    indices relevant to group g (-1 pad; Tc a power of two), and `compact`
    aligns any [G, T] matrix to those columns. Memoized on the tensors."""
    cached = getattr(tensors, "_compact_cache", None)
    if cached is not None:
        return cached
    g_n, t_n = tensors.s_match.shape
    relevant = (
        tensors.s_match
        | tensors.a_aff_req
        | tensors.a_anti_req
        | (tensors.w_aff_pref != 0)
        | (tensors.w_anti_pref != 0)
        | (tensors.spread_hard > 0)
        | (tensors.spread_soft > 0)
        | tensors.ss_host
        | tensors.ss_zone
    )
    per_g = [np.flatnonzero(row) for row in relevant]
    t_cap = max((len(ids) for ids in per_g), default=0)
    t_cap = 1 << max(t_cap - 1, 0).bit_length() if t_cap else 0
    g_terms = np.full((g_n, t_cap), -1, np.int32)
    for gi, ids in enumerate(per_g):
        g_terms[gi, : len(ids)] = ids

    def compact(mat):
        out = np.zeros((g_n, t_cap), mat.dtype)
        for gi, ids in enumerate(per_g):
            out[gi, : len(ids)] = mat[gi, ids]
        return out

    object.__setattr__(tensors, "_compact_cache", (g_terms, compact))
    return g_terms, compact


def statics_from(tensors: ClusterTensors, sched_config, device) -> StaticArrays:
    """The per-simulation constants on `device`, memoized on the tensors
    object per (scheduler config, device)."""
    from ..schedconfig import DEFAULT_WEIGHTS

    cached = getattr(tensors, "_torch_statics_cache", None)
    if cached is not None and cached[0] is sched_config and cached[1] == device:
        return cached[2]
    g_terms, compact = _compact_terms(tensors)
    n = tensors.alloc.shape[0]
    score_w = sched_config.score_weights if sched_config is not None else DEFAULT_WEIGHTS
    statics = statics_from_numpy(
        dict(
            alloc=tensors.alloc,
            static_mask=tensors.static_mask,
            vol_mask=tensors.vol_mask,
            node_pref=tensors.node_pref_score,
            taint_intol=tensors.taint_intolerable,
            static_score=tensors.static_score,
            avoid_pen=tensors.avoid_pen,
            node_dom=tensors.node_dom if tensors.node_dom.shape[0] else np.zeros((1, n)),
            term_topo=tensors.term_topo_key,
            ip_of=interpod_term_index(tensors),
            g_terms=g_terms,
            s_match=compact(tensors.s_match),
            a_aff_req=compact(tensors.a_aff_req),
            a_anti_req=compact(tensors.a_anti_req),
            w_aff_pref=compact(tensors.w_aff_pref),
            w_anti_pref=compact(tensors.w_anti_pref),
            spread_hard=compact(tensors.spread_hard),
            spread_soft=compact(tensors.spread_soft),
            ss_host=compact(tensors.ss_host),
            ss_zone=compact(tensors.ss_zone),
            ports_req=tensors.ports,
            vol_rw_req=tensors.vol_rw,
            vol_ro_req=tensors.vol_ro,
            vol_att_req=tensors.vol_att,
            vol_class_mask=tensors.vol_class_mask,
            attach_limits=tensors.attach_limits,
            score_w=score_w,
            node_valid=np.ones(n, bool),
        ),
        device,
    )
    object.__setattr__(tensors, "_torch_statics_cache", (sched_config, device, statics))
    return statics


class StepFlags(NamedTuple):
    """Statically-known problem features. Each False flag removes the
    corresponding terms from the step, exactly as the JAX package prunes
    them from its compiled step: a pruned score term is constant across
    nodes but adding it would round differently, so the flags are honoured
    term for term (K3 receives them as a bitmask, bit i = field i)."""

    ports: bool = True  # any group requests host ports
    vols: bool = True  # any exclusive-volume conflicts possible
    attach: bool = True  # any attachable volumes present
    spread_hard: bool = True  # any DoNotSchedule topology constraint
    spread_soft: bool = True  # any ScheduleAnyway constraint
    selector_spread: bool = True  # any SelectorSpread counting term
    interpod_req: bool = True  # any required (anti-)affinity term
    interpod_pref: bool = True  # any preferred (anti-)affinity weight
    storage: bool = True  # any Open-Local node storage or pod demand
    gpu: bool = True  # any GPU-share capacity or pod demand
    node_pref: bool = True  # any preferred node affinity weight
    taint_pref: bool = True  # any intolerable PreferNoSchedule taint
    static_score: bool = True  # any ImageLocality / preferAvoidPods signal


def flag_bits(flags: StepFlags) -> int:
    """The bitmask form of `flags` the CUDA kernels read."""
    return sum(1 << i for i, on in enumerate(flags) if on)


def uses_topology(flags: StepFlags) -> bool:
    """Whether any flag needs the term-row count planes updated."""
    f = flags
    return f.spread_hard or f.spread_soft or f.selector_spread or f.interpod_req or f.interpod_pref


def flags_from(tensors: ClusterTensors, batch_ext: dict) -> StepFlags:
    """Derive the step flags from concrete host-side arrays (the batch's
    extended demands included, as the JAX package does)."""
    ext = tensors.ext
    storage = bool(ext.has_storage.any())
    gpu = bool(ext.gpu_total.any())
    storage = storage or bool(
        np.asarray(batch_ext["lvm_size"]).size and np.asarray(batch_ext["lvm_size"]).max() > 0
    ) or bool(
        np.asarray(batch_ext["dev_size"]).size and np.asarray(batch_ext["dev_size"]).max() > 0
    )
    gpu = gpu or bool(np.asarray(batch_ext["gpu_mem"]).max(initial=0) > 0)
    return StepFlags(
        ports=tensors.n_ports > 0,
        vols=bool(tensors.vol_rw.any() or tensors.vol_ro.any()),
        attach=bool(tensors.vol_att.any()),
        spread_hard=bool(tensors.spread_hard.any()),
        spread_soft=bool(tensors.spread_soft.any()),
        selector_spread=bool(tensors.ss_host.any() or tensors.ss_zone.any()),
        interpod_req=bool(tensors.a_aff_req.any() or tensors.a_anti_req.any()),
        interpod_pref=bool(tensors.w_aff_pref.any() or tensors.w_anti_pref.any()),
        storage=storage,
        gpu=gpu,
        node_pref=bool(tensors.node_pref_score.any()),
        taint_pref=bool(tensors.taint_intolerable.any()),
        static_score=bool(tensors.static_score.any() or tensors.avoid_pen.any()),
    )


class StepEval(NamedTuple):
    """The mask cascade and the combined score of one scheduling cycle."""

    m_static: torch.Tensor  # [N]
    m_ports: torch.Tensor
    m_res: torch.Tensor
    m_vol: torch.Tensor
    m_att: torch.Tensor
    m_bind: torch.Tensor
    m_storage: torch.Tensor  # == m_bind: no storage demand in this slice
    m_gpu: torch.Tensor  # == m_bind: no GPU-share demand in this slice
    m_spread: torch.Tensor
    m_all: torch.Tensor
    score: torch.Tensor  # [N], -inf outside m_all

    def fail_code(self) -> int:
        """First mask stage that emptied the candidate set."""
        fail = FILTER_CASCADE[-1][1]
        for field, code in reversed(FILTER_CASCADE[:-1]):
            if not bool(getattr(self, field).any()):
                fail = code
        return fail


class TopoRaws(NamedTuple):
    """The raw [N] count vectors K2 hands to K3 (rows of `StepBuffers.raw`)."""

    ipa: torch.Tensor  # inter-pod affinity raw score (before max-abs)
    spread: torch.Tensor  # soft topology-spread raw count (soft_w @ cnt)
    ss_host: torch.Tensor  # SelectorSpread hostname-key counts
    ss_zone: torch.Tensor  # SelectorSpread zone-key counts


def _term_rows(statics: StaticArrays, g: int):
    """The group's term rows: ids, validity, clipped ids, domain rows
    [Tc, N], their validity, and the interpod-plane rows."""
    terms_g = statics.g_terms[g]
    tvalid = terms_g >= 0
    tsafe = terms_g.clamp(min=0)
    dom_sub = take_rows_i32(
        statics.node_dom, torch.where(tvalid, statics.term_topo[tsafe], -1)
    )
    valid_sub = (dom_sub >= 0) & tvalid[:, None]
    ip_eff = torch.where(tvalid, statics.ip_of[tsafe], -1)
    return terms_g, tvalid, tsafe, dom_sub, valid_sub, ip_eff


def node_masks(statics: StaticArrays, state: SchedState, g: int, req, pin: int, flags: StepFlags):
    """K1's function: (m_static, m_ports, m_res, m_vol, m_att, m_bind)."""
    f = flags
    n = statics.alloc.shape[0]
    node_ids = torch.arange(n, device=statics.alloc.device)
    # pin: -1 = unpinned, -2 = pinned to a nonexistent node (matches nothing)
    pin_m = node_ids == pin if pin >= 0 else torch.full((n,), pin > -2, device=node_ids.device)
    m_static = statics.static_mask[g] & pin_m & statics.node_valid
    m_ports = m_static
    if f.ports:
        m_ports = m_static & ports_conflict_free(state.ports_used, statics.ports_req[g])
    m_res = m_ports & resources_fit(state.free, req)
    m_vol = m_res
    if f.vols:
        m_vol = m_res & volume_conflict_free(
            state.vols_any, state.vols_rw, statics.vol_rw_req[g], statics.vol_ro_req[g]
        )
    m_att = m_vol
    if f.attach:
        m_att = m_vol & attach_limits_ok(
            state.vols_any, statics.vol_att_req[g], statics.vol_class_mask, statics.attach_limits
        )
    m_bind = m_att & statics.vol_mask[g]
    return m_static, m_ports, m_res, m_vol, m_att, m_bind


def topology_masks(statics: StaticArrays, state: SchedState, g: int, m_static, flags: StepFlags):
    """K2's filters: (spread_ok, ip_ok) over all nodes."""
    n = statics.alloc.shape[0]
    ones = torch.ones(n, dtype=torch.bool, device=statics.alloc.device)
    if not statics.g_terms.shape[1]:
        return ones, ones
    terms_g, tvalid, tsafe, _, valid_sub, ip_eff = _term_rows(statics, g)
    cnt_sub = take_rows(state.cnt_match, terms_g)
    spread_ok = ip_ok = ones
    if flags.spread_hard:
        spread_ok = topology_spread_filter(cnt_sub, valid_sub, statics.spread_hard[g], m_static)
    if flags.interpod_req:
        ip_ok = interpod_filter(
            cnt_sub,
            take_rows(state.cnt_own_anti, ip_eff),
            valid_sub,
            torch.where(tvalid, state.cnt_total[tsafe], 0.0),
            statics.s_match[g],
            statics.a_aff_req[g],
            statics.a_anti_req[g],
        )
    return spread_ok, ip_ok


def topology_raws(statics: StaticArrays, state: SchedState, g: int) -> TopoRaws:
    """K2's raw count vectors over the group's term rows."""
    n = statics.alloc.shape[0]
    if not statics.g_terms.shape[1]:
        z = torch.zeros(n, dtype=torch.float32, device=statics.alloc.device)
        return TopoRaws(z, z, z, z)
    terms_g, _, _, _, _, ip_eff = _term_rows(statics, g)
    cnt_sub = take_rows(state.cnt_match, terms_g)
    ipa = interpod_score(
        cnt_sub,
        take_rows(state.cnt_own_aff, ip_eff),
        take_rows(state.w_own_aff_pref, ip_eff),
        take_rows(state.w_own_anti_pref, ip_eff),
        statics.s_match[g],
        statics.w_aff_pref[g],
        statics.w_anti_pref[g],
    )
    return TopoRaws(
        ipa,
        statics.spread_soft[g] @ cnt_sub,
        statics.ss_host[g].to(torch.float32) @ cnt_sub,
        statics.ss_zone[g].to(torch.float32) @ cnt_sub,
    )


def score_pod(
    statics: StaticArrays,
    state: SchedState,
    g: int,
    req,
    m_all,
    flags: StepFlags,
    raws: TopoRaws = None,
) -> torch.Tensor:
    """The combined score sum for one pod over all nodes, -inf outside
    `m_all`, in the JAX package's term order and with the arithmetic of its
    compiled step (kernels/scores.py, "the step's composition"): the
    resource pair as one FMA, the Simon numerator contracted, the static
    pair as one FMA, the other terms added with two roundings each
    (`score + w * term`). A term whose flag is False is not added; the
    per-pod skips of the JAX package (a pod with no terms of a family) are
    evaluated live, which gives the same constants."""
    f = flags
    t_cap = statics.g_terms.shape[1]
    if raws is None:
        raws = topology_raws(statics, state, g)
    w_ = statics.score_w
    score = resource_base_score(state.free, statics.alloc, req, w_[0], w_[1])
    # Simon score + the GPU-share score, the same dominant-share formula:
    # computed once, counted twice
    score = score + (w_[2] + w_[3]) * simon_minmax(statics.alloc, req, m_all)
    if f.node_pref:
        score = score + w_[4] * minmax_normalize(statics.node_pref[g], m_all)
    if f.taint_pref:
        score = score + w_[5] * taint_toleration_score(statics.taint_intol[g], m_all)
    if t_cap and (f.interpod_pref or f.interpod_req):
        score = score + w_[6] * maxabs_normalize(raws.ipa, m_all)
    if t_cap and f.spread_soft:
        score = score + w_[7] * spread_score_from_raw(raws.spread, m_all)
    if t_cap and f.selector_spread:
        ss = selector_spread_from_counts(raws.ss_host, raws.ss_zone, statics.ss_zone[g].any(), m_all)
        score = score + w_[8] * ss
    if f.static_score:
        score = score + fma(w_[9], statics.static_score[g], w_[11] * statics.avoid_pen[g])
    return torch.where(m_all, score, -torch.inf)


def _finish_score(statics: StaticArrays, score, flags: StepFlags):
    """The Open-Local term: w10 × minmax(0) = w10 × 0 for the storage-free
    pods of this slice, added after the mask as in the JAX package."""
    if flags.storage:
        score = score + statics.score_w[10] * torch.zeros_like(score)
    return score


def filter_and_score(statics: StaticArrays, state: SchedState, pod, flags: StepFlags) -> StepEval:
    """The full filter cascade and score sum for one pod (g, req, pin)."""
    g, req, pin = int(pod[0]), pod[1], int(pod[2])
    m_static, m_ports, m_res, m_vol, m_att, m_bind = node_masks(statics, state, g, req, pin, flags)
    spread_ok, ip_ok = topology_masks(statics, state, g, m_static, flags)
    m_spread = m_bind & spread_ok
    m_all = m_spread & ip_ok
    score = _finish_score(statics, score_pod(statics, state, g, req, m_all, flags), flags)
    return StepEval(
        m_static, m_ports, m_res, m_vol, m_att, m_bind, m_bind, m_bind, m_spread, m_all, score
    )


def choose(ev: StepEval, forced: bool, pin: int, node_valid) -> tuple:
    """(chosen, placed, reason): the argmax (lowest index on ties; 0 when
    every score is -inf) or, for a forced pod, its pinned node — which must
    exist (pin >= 0) and be valid. The pin is clamped before it indexes."""
    n = node_valid.shape[0]
    chosen = pin if forced else int(torch.argmax(ev.score))
    if forced:
        placed = pin >= 0 and bool(node_valid[min(max(pin, 0), n - 1)])
    else:
        placed = bool(ev.m_all.any())
    reason = OK if placed else (FAIL_NO_NODE if forced else ev.fail_code())
    return chosen, placed, reason


def commit(
    statics: StaticArrays,
    state: SchedState,
    g: int,
    req,
    chosen: int,
    placed: bool,
    flags: StepFlags,
) -> None:
    """K4's function: the state update at the chosen node, IN PLACE. A pod
    that was not placed changes nothing (the JAX package adds zeros)."""
    if not placed:
        return
    f = flags
    state.free[chosen] -= req
    if f.ports:
        state.ports_used[chosen] += statics.ports_req[g].to(torch.float32)
    if f.vols or f.attach:
        v_rw = statics.vol_rw_req[g]
        v_present = v_rw | statics.vol_ro_req[g] | statics.vol_att_req[g]
        state.vols_any[chosen] += v_present.to(torch.float32)
        if f.vols:
            state.vols_rw[chosen] += v_rw.to(torch.float32)
    if not (uses_topology(f) and statics.g_terms.shape[1]):
        return
    # same-domain increment on the group's term rows: every node sharing
    # the chosen node's domain for term t gains the pod's incidence
    terms_g, tvalid, _, dom_sub, valid_sub, ip_eff = _term_rows(statics, g)
    dom_chosen = dom_sub[:, chosen]  # [Tc]
    valid_chosen = (dom_chosen >= 0) & tvalid  # [Tc]
    same = valid_sub & (dom_sub == dom_chosen[:, None]) & valid_chosen[:, None]
    inc = same.to(torch.float32)  # [Tc, N]

    def col(mat):
        return mat[g].to(torch.float32)[:, None]

    add_rows(state.cnt_match, terms_g, col(statics.s_match) * inc)
    state.cnt_total.index_add_(
        0, terms_g[valid_chosen].long(), statics.s_match[g][valid_chosen].to(torch.float32)
    )
    if f.interpod_req:
        add_rows(state.cnt_own_anti, ip_eff, col(statics.a_anti_req) * inc)
        add_rows(state.cnt_own_aff, ip_eff, col(statics.a_aff_req) * inc)
    if f.interpod_pref:
        add_rows(state.w_own_aff_pref, ip_eff, col(statics.w_aff_pref) * inc)
        add_rows(state.w_own_anti_pref, ip_eff, col(statics.w_anti_pref) * inc)


def schedule_step(statics: StaticArrays, state: SchedState, pod, flags: StepFlags):
    """One scheduling cycle for one pod (g, req, pin, forced, ...) against
    every node; updates `state` in place. Returns (out_node, reason)."""
    ev = filter_and_score(statics, state, pod, flags)
    chosen, placed, reason = choose(ev, bool(pod[3]), int(pod[2]), statics.node_valid)
    commit(statics, state, int(pod[0]), pod[1], chosen, placed, flags)
    return (chosen if placed else -1), reason


# -- the per-pod kernels: device buffers, plain versions, wrappers ----------


class StepBuffers:
    """Everything K1–K4 read and write for one batch, on one device: the
    statics, the state (updated in place), the batch's pod arrays, the
    per-node scratch (stage byte, raw count rows, score) and the per-pod
    outputs, which stay on the device until the batch ends."""

    def __init__(self, statics: StaticArrays, state: SchedState, pods, flags: StepFlags):
        dev = statics.alloc.device
        self.device = dev
        self.statics = statics
        self.state = state
        self.flags = flags
        self.flag_bits = flag_bits(flags)
        group, req, pin, forced = pods[:4]
        self.group = torch.as_tensor(np.asarray(group, np.int32), device=dev)
        self.req = torch.as_tensor(np.asarray(req, np.float32), device=dev).contiguous()
        self.pin = torch.as_tensor(np.asarray(pin, np.int32), device=dev)
        self.forced = torch.as_tensor(np.asarray(forced, bool), device=dev)
        n, p = statics.alloc.shape[0], len(self.group)
        self.n_pods = p
        self.stage = torch.zeros(n, dtype=torch.uint8, device=dev)
        self.raw = torch.zeros((4, n), dtype=torch.float32, device=dev)
        self.score = torch.zeros(n, dtype=torch.float32, device=dev)
        self.chosen = torch.zeros(p, dtype=torch.int32, device=dev)
        self.placed = torch.zeros(p, dtype=torch.bool, device=dev)
        self.reason = torch.zeros(p, dtype=torch.int32, device=dev)
        self.out_node = torch.full((p,), -1, dtype=torch.int32, device=dev)
        self.ctx = None  # the kernels' argument struct, built at first launch


def _stage_masks(stage: torch.Tensor):
    """The eight cumulative stage masks packed in the stage byte."""
    return [((stage >> b) & 1).bool() for b in range(8)]


def filter_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K1: stage bits 0-5 for pod i (bits 6-7 cleared)."""
    cuda.count_plain("filter_pod")
    masks = node_masks(
        buf.statics, buf.state, int(buf.group[i]), buf.req[i], int(buf.pin[i]), buf.flags
    )
    stage = torch.zeros_like(buf.stage)
    for b, m in enumerate(masks):
        stage |= m.to(torch.uint8) << b
    buf.stage.copy_(stage)


def topology_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K2: stage bits 6-7 and the raw count rows."""
    cuda.count_plain("topology_pod")
    g = int(buf.group[i])
    masks = _stage_masks(buf.stage)
    spread_ok, ip_ok = topology_masks(buf.statics, buf.state, g, masks[0], buf.flags)
    m_spread = masks[5] & spread_ok
    m_all = m_spread & ip_ok
    buf.stage.copy_(
        (buf.stage & 0x3F) | (m_spread.to(torch.uint8) << 6) | (m_all.to(torch.uint8) << 7)
    )
    buf.raw.copy_(torch.stack(topology_raws(buf.statics, buf.state, g)))


def score_argmax_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K3: score, fail code, argmax and forced override."""
    cuda.count_plain("score_argmax_pod")
    g, pin, forced = int(buf.group[i]), int(buf.pin[i]), bool(buf.forced[i])
    m = _stage_masks(buf.stage)
    score = score_pod(
        buf.statics, buf.state, g, buf.req[i], m[7], buf.flags, TopoRaws(*buf.raw.unbind(0))
    )
    score = _finish_score(buf.statics, score, buf.flags)
    ev = StepEval(m[0], m[1], m[2], m[3], m[4], m[5], m[5], m[5], m[6], m[7], score)
    chosen, placed, reason = choose(ev, forced, pin, buf.statics.node_valid)
    buf.score.copy_(score)
    buf.chosen[i] = chosen
    buf.placed[i] = placed
    buf.reason[i] = reason
    buf.out_node[i] = chosen if placed else -1


def commit_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K4: the in-place state update for pod i."""
    cuda.count_plain("commit_pod")
    commit(
        buf.statics, buf.state, int(buf.group[i]), buf.req[i],
        int(buf.chosen[i]), bool(buf.placed[i]), buf.flags,
    )


def filter_pod(buf: StepBuffers, i: int) -> None:
    """K1 (`kernels/csrc/filter_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        filter_pod_plain(buf, i)
    else:
        cuda.launch("filter_pod", buf, i)


def topology_pod(buf: StepBuffers, i: int) -> None:
    """K2 (`kernels/csrc/topology_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        topology_pod_plain(buf, i)
    else:
        cuda.launch("topology_pod", buf, i)


def score_argmax_pod(buf: StepBuffers, i: int) -> None:
    """K3 (`kernels/csrc/score_argmax_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        score_argmax_pod_plain(buf, i)
    else:
        cuda.launch("score_argmax_pod", buf, i)


def commit_pod(buf: StepBuffers, i: int) -> None:
    """K4 (`kernels/csrc/commit_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        commit_pod_plain(buf, i)
    else:
        cuda.launch("commit_pod", buf, i)


def run_batch(buf: StepBuffers) -> None:
    """K1→K4 for every pod of the batch, in order, with no host sync."""
    for i in range(buf.n_pods):
        filter_pod(buf, i)
        topology_pod(buf, i)
        score_argmax_pod(buf, i)
        commit_pod(buf, i)


class Engine:
    """Host-side engine: threads the placement log across app batches, with
    the scheduling state carried on `device` between batches."""

    def __init__(self, tensorizer, device):
        self.tensorizer = tensorizer
        self.device = torch.device(device)
        #: optional schedconfig.SchedulerConfig (score-weight overrides)
        self.sched_config = None
        #: optional [N] host bool mask — False rows are out of this cluster
        self.node_valid = None
        self.placed_group: List[int] = []
        self.placed_node: List[int] = []
        self.placed_req: List[np.ndarray] = []
        # extended-resource placement log, keyed parallel to placed_node
        self.ext_log = {"node": [], "vg_alloc": [], "sdev_take": [], "gpu_shares": [], "gpu_mem": []}
        self.last_state: SchedState = None
        self._last_vocab = None

    def log_req_matrix(self, r: int) -> np.ndarray:
        """The placement log's request rows padded to r resource columns."""
        if not self.placed_req:
            return np.zeros((0, r), np.float32)
        return np.stack([np.pad(q, (0, r - q.shape[0])) for q in self.placed_req]).astype(
            np.float32
        )

    @staticmethod
    def state_vocab(tensors) -> tuple:
        """The vocabulary tuple a carried state is valid under."""
        return (
            tensors.alloc.shape[1],
            tensors.n_terms,
            tensors.n_ports,
            tensors.n_vols,
            int((interpod_term_index(tensors) >= 0).sum()),
            tensors.alloc.shape[0],
        )

    def carried_state(self) -> SchedState:
        """The engine's carried state (dense; None before the first batch)."""
        return self.last_state

    def place(self, batch: PodBatch):
        """Schedule one batch. Returns (node index per pod [-1 = failed],
        reason codes, extras) like the JAX package's Engine.place; the
        extended allocations in `extras` are all zero in this slice."""
        ext = batch.ext
        for key in ("lvm_size", "dev_size", "gpu_mem"):
            if np.asarray(ext[key]).size and np.asarray(ext[key]).max() > 0:
                raise NotImplementedError(
                    "storage and GPU-share pods: ROADMAP queue 1 "
                    f"(a pod of this batch demands {key})"
                )
        tensors = self.tensorizer.freeze()
        r = tensors.alloc.shape[1]
        req, pods = build_pod_arrays(batch, r)
        vocab = self.state_vocab(tensors)
        state = self.last_state
        if state is None or self._last_vocab != vocab:
            state = build_state(
                tensors,
                np.asarray(self.placed_group, np.int32),
                np.asarray(self.placed_node, np.int32),
                self.log_req_matrix(r),
                self.ext_log,
                self.device,
            )
        statics = statics_from(tensors, self.sched_config, self.device)
        if self.node_valid is not None:
            statics = statics._replace(
                node_valid=statics.node_valid
                & torch.as_tensor(np.asarray(self.node_valid, bool), device=self.device)
            )
        buf = StepBuffers(statics, state, pods, flags_from(tensors, ext))
        # the batch updates the state in place: a failure part-way leaves it
        # inconsistent with the log, so drop it until the batch completes
        self.last_state = None
        run_batch(buf)
        nodes = buf.out_node.cpu().numpy().astype(np.int64)
        reasons = buf.reason.cpu().numpy()
        self.last_state = state
        self._last_vocab = vocab
        p = len(nodes)
        lvm_alloc = np.zeros((p, tensors.ext.vg_cap.shape[1]), np.float32)
        dev_take = np.zeros((p, tensors.ext.sdev_cap.shape[1]), bool)
        gpu_shares = np.zeros((p, tensors.ext.gpu_dev_total.shape[1]), np.float32)
        ok = np.flatnonzero(nodes >= 0)
        self.placed_group.extend(np.asarray(batch.group)[ok].tolist())
        self.placed_node.extend(nodes[ok].tolist())
        self.placed_req.extend(req[ok])
        self.ext_log["node"].extend(nodes[ok].tolist())
        self.ext_log["vg_alloc"].extend(lvm_alloc[ok])
        self.ext_log["sdev_take"].extend(dev_take[ok])
        self.ext_log["gpu_shares"].extend(gpu_shares[ok])
        self.ext_log["gpu_mem"].extend(np.asarray(ext["gpu_mem"])[ok].tolist())
        return nodes, reasons, {
            "lvm_alloc": lvm_alloc,
            "dev_take": dev_take,
            "gpu_shares": gpu_shares,
        }
