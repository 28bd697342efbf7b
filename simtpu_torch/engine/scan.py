"""The serial placement engine: one scheduling cycle per pod, over all nodes.

The PyTorch counterpart of the JAX package's `engine/scan.py` serial core.
Each pod runs a full scheduling cycle (filter → score → select → state
update) over the whole node axis; pods are strictly ordered like the
reference's serial loop. Ties go to the lowest node index.

On the device the per-pod step is up to six hand-written CUDA kernels
(`kernels/csrc/`), launched back to back for pod `i` with no host sync:

- K1 `filter_pod`: the per-node filter stages (static/pin/valid, ports,
  resources, volumes, attach limits, volume binding) → one byte of
  cumulative stage bits per node;
- K5 `storage_pod` (Open-Local pods only): the LVM and exclusive-device
  plans and the raw Open-Local score of every node;
- K6 `gpu_pod` (GPU-share pods only): the GPU device plan of every node;
- K2 `topology_pod`: the `[Tc, N]` work of the group's term rows — the
  hard-spread and inter-pod filters (stage bits 6 and 7) and the raw
  inter-pod, soft-spread and selector-spread count vectors;
- K3 `score_argmax_pod`: the storage and GPU verdicts ANDed into the
  cascade, the first failing stage, the normalizers, the weighted score
  sum in the JAX package's term order (the Open-Local term last), the
  argmax (lowest index on ties) and the forced-pod override → chosen,
  placed, reason;
- K4 `commit_pod`: the state update at the chosen node, IN PLACE, and the
  pod's extended allocations at that node.

A pod that demands no storage (no GPU memory) skips K5 (K6), as the JAX
package's `lax.cond` skips the plans: the host decides from the batch's
numpy arrays, and K3/K4 read a per-pod flag and use the skip constants
(all nodes fit, raw score 0, zero allocation).

Each kernel's wrapper below decides by the device of the tensors it is
given: CPU tensors go to its plain PyTorch version (same module), CUDA
tensors launch the kernel or raise. The plain versions are built from the
textbook functions `node_masks`, `topology_masks`, `topology_raws`,
`score_pod`, `choose` and `commit`, which mirror the JAX functions line by
line; `filter_and_score` and `schedule_step` compose them.

Bit layout of the stage byte (each bit implies the ones before it):
0 static, 1 ports, 2 resources, 3 volumes, 4 attach, 5 bind, 6 bind and
spread, 7 bind, spread and inter-pod. The storage and GPU verdicts are not
in the byte: K3 ANDs them into bits 5-7 (AND commutes, so `m_spread` =
bit 6 & storage & GPU, `m_all` = bit 7 & storage & GPU).

`Engine.remove_placements` / `restore_placements` apply signed log deltas
to the carried state (preemption), through K7 `delta_apply` on the card
(`engine/state.py apply_placement_deltas`).

With `Engine.speculate` (the default) `Engine.place` hands the batch to the
speculative wavefront (`engine/wavefront.py`): each planned same-group run
of pods is placed by one launch of K9 `wave_lean` or K10 `wave_hard`, and
only the pods between runs take the per-pod kernels (`run_pods`). The
placements are the same either way.

With `Engine.compact` (the default) the state carried between batches is
the compact layout (`engine/state.py CompactState`): `place()` stores the
final state through K11 `compact_compress` and expands a reused carry
through K12 `compact_expand` into fresh dense planes for the kernels;
preemption's deltas go straight into the compact carry through K13
`compact_delta`. A dense carry (the switch off, or no topology key with
few enough domains) keeps K7. The placements are the same either way.
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
from ..kernels.gpushare import gpu_plan
from ..kernels.storage import storage_plan
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
    GROW_COUNTS,
    STATE_COUNTS,
    CompactState,
    SchedState,
    add_rows,
    apply_placement_deltas,
    apply_placement_deltas_compact,
    build_state,
    compact_delta_spec_dev,
    compact_spec,
    compact_spec_dev,
    compress_state,
    expand_state,
    extend_state,
    extend_state_nodes,
    grow_plan_nodes,
    grow_plan_terms,
    pad_terms,
    snap_pow2,
    strip_term_padding,
    interpod_term_index,
    node_dom_for,
    node_dom_small_for,
    pack_delta_entries,
    state_nbytes,
    take_rows,
    take_rows_i32,
    update_state_gauge,
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
    StaticArrays that the serial path reads).

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
    # extended resources (Open-Local storage, GPU-share)
    has_storage: torch.Tensor  # [N] bool
    vg_cap: torch.Tensor  # [N, V] f32
    vg_name_id: torch.Tensor  # [N, V] i32 interned VG name (-1 pad)
    sdev_cap: torch.Tensor  # [N, SD] f32
    sdev_media: torch.Tensor  # [N, SD] i32 media code (0 none)
    gpu_dev_exists: torch.Tensor  # [N, GD] bool
    gpu_total: torch.Tensor  # [N] f32
    score_w: torch.Tensor  # [schedconfig.N_TERMS] f32
    node_valid: torch.Tensor  # [N] bool


_STATIC_DTYPES = {
    "alloc": np.float32, "static_mask": bool, "vol_mask": bool,
    "node_pref": np.float32, "taint_intol": np.float32,
    "static_score": np.float32, "avoid_pen": np.float32,
    "node_dom": np.int32,
    "term_topo": np.int32, "ip_of": np.int32,
    "g_terms": np.int32, "s_match": bool, "a_aff_req": bool,
    "a_anti_req": bool, "w_aff_pref": np.float32, "w_anti_pref": np.float32,
    "spread_hard": np.float32, "spread_soft": np.float32, "ss_host": bool,
    "ss_zone": bool, "ports_req": bool, "vol_rw_req": bool,
    "vol_ro_req": bool, "vol_att_req": bool, "vol_class_mask": bool,
    "attach_limits": np.float32, "has_storage": bool, "vg_cap": np.float32,
    "vg_name_id": np.int32, "sdev_cap": np.float32, "sdev_media": np.int32,
    "gpu_dev_exists": bool, "gpu_total": np.float32, "score_w": np.float32,
    "node_valid": bool,
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
    ext = tensors.ext
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
            has_storage=ext.has_storage,
            vg_cap=ext.vg_cap,
            vg_name_id=ext.vg_name_id,
            sdev_cap=ext.sdev_cap,
            sdev_media=ext.sdev_media,
            gpu_dev_exists=ext.gpu_dev_total > 0,
            gpu_total=ext.gpu_total,
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
    """The mask cascade, the combined score and the extended-resource plans
    of one scheduling cycle (field for field the JAX package's StepEval)."""

    m_static: torch.Tensor  # [N]
    m_ports: torch.Tensor
    m_res: torch.Tensor
    m_vol: torch.Tensor
    m_att: torch.Tensor
    m_bind: torch.Tensor
    m_storage: torch.Tensor
    m_gpu: torch.Tensor
    m_spread: torch.Tensor
    m_all: torch.Tensor
    score: torch.Tensor  # [N], -inf outside m_all
    score_nostorage: torch.Tensor  # [N] score minus the Open-Local term
    lvm_alloc: torch.Tensor  # [N, V]
    dev_take: torch.Tensor  # [N, SD]
    gpu_shares: torch.Tensor  # [N, GD]

    def fail_code(self) -> int:
        """First mask stage that emptied the candidate set."""
        fail = FILTER_CASCADE[-1][1]
        for field, code in reversed(FILTER_CASCADE[:-1]):
            if not bool(getattr(self, field).any()):
                fail = code
        return fail


class PodExt(NamedTuple):
    """One pod's extended-resource demands (the tail of the pod tuple)."""

    lvm_size: torch.Tensor  # [L] f32 LVM claim sizes (0 = padding)
    lvm_vg: torch.Tensor  # [L] i32 named VG (-1 unnamed, -2 missing)
    dev_size: torch.Tensor  # [K] f32 exclusive-device claim sizes
    dev_media: torch.Tensor  # [K] i32 media code per claim
    gpu_mem: float  # per-GPU memory request
    gpu_count: int  # GPU shares requested
    gpu_preset: torch.Tensor  # [GD] shares from an existing gpu-index annotation


def pod_ext(pod, device) -> PodExt:
    """The extended demands of a pod tuple (g, req, pin, forced, lvm_size,
    lvm_vg, dev_size, dev_media, gpu_mem, gpu_count, gpu_preset)."""

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return PodExt(
        t(pod[4], np.float32), t(pod[5], np.int32), t(pod[6], np.float32),
        t(pod[7], np.int32), float(pod[8]), int(pod[9]), t(pod[10], np.int32),
    )


def storage_demand(lvm_size, dev_size) -> np.ndarray:
    """Which pods demand Open-Local storage (the JAX package's cond
    predicate `any(lvm_size > 0) | any(dev_size > 0)`), over the claim axis
    of host arrays of one pod or a batch."""
    return (np.asarray(lvm_size) > 0).any(axis=-1) | (np.asarray(dev_size) > 0).any(axis=-1)


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


def topology_raws(statics: StaticArrays, state: SchedState, g: int, cnt_sub=None) -> TopoRaws:
    """K2's raw count vectors over the group's term rows; `cnt_sub`
    overrides the group's [Tc, N] cnt_match rows (the rounds engine's
    one-more-pod re-score)."""
    n = statics.alloc.shape[0]
    if not statics.g_terms.shape[1]:
        z = torch.zeros(n, dtype=torch.float32, device=statics.alloc.device)
        return TopoRaws(z, z, z, z)
    terms_g, _, _, _, _, ip_eff = _term_rows(statics, g)
    if cnt_sub is None:
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
    free=None,
    cnt_sub=None,
) -> torch.Tensor:
    """The combined score sum for one pod over all nodes, -inf outside
    `m_all`, in the JAX package's term order and with the arithmetic of its
    compiled step, whose weights are runtime values (kernels/scores.py,
    "the step's composition"): the resource pair with two roundings, the
    Simon term as one FMA — two roundings when the node-affinity term
    follows it —, every later term added as one FMA `fma(w, term, score)`,
    the static pair as one FMA added with two roundings. A term whose flag is False is not added; the per-pod skips
    of the JAX package (a pod with no terms of a family) are evaluated
    live, which gives the same constants.

    `free` / `cnt_sub` override `state.free` and the group's [Tc, N]
    cnt_match rows, as in the JAX package: the rounds engine scores a
    hypothetical one-more-pod-per-node state (`engine/rounds.py`)."""
    f = flags
    t_cap = statics.g_terms.shape[1]
    if raws is None:
        raws = topology_raws(statics, state, g, cnt_sub)
    w_ = statics.score_w
    fr = state.free if free is None else free
    score = resource_base_score(fr, statics.alloc, req, w_[0], w_[1])
    # Simon score + the GPU-share score, the same dominant-share formula:
    # computed once, counted twice
    simon = simon_minmax(statics.alloc, req, m_all)
    if f.node_pref:
        score = score + (w_[2] + w_[3]) * simon
    else:
        score = fma(w_[2] + w_[3], simon, score)
    if f.node_pref:
        score = fma(w_[4], minmax_normalize(statics.node_pref[g], m_all), score)
    if f.taint_pref:
        score = fma(w_[5], taint_toleration_score(statics.taint_intol[g], m_all), score)
    if t_cap and (f.interpod_pref or f.interpod_req):
        score = fma(w_[6], maxabs_normalize(raws.ipa, m_all), score)
    if t_cap and f.spread_soft:
        score = fma(w_[7], spread_score_from_raw(raws.spread, m_all), score)
    if t_cap and f.selector_spread:
        ss = selector_spread_from_counts(raws.ss_host, raws.ss_zone, statics.ss_zone[g].any(), m_all)
        score = fma(w_[8], ss, score)
    if f.static_score:
        score = score + fma(w_[9], statics.static_score[g], w_[11] * statics.avoid_pen[g])
    return torch.where(m_all, score, -torch.inf)


def storage_step(statics: StaticArrays, state: SchedState, ext: PodExt):
    """K5's function: (storage_ok [N], lvm_alloc [N, V], dev_take [N, SD],
    raw Open-Local score [N]) of a pod that demands storage."""
    return storage_plan(
        state.vg_free, statics.vg_name_id, statics.vg_cap, state.sdev_free,
        statics.sdev_cap, statics.sdev_media, statics.has_storage,
        ext.lvm_size, ext.lvm_vg, ext.dev_size, ext.dev_media,
    )


def gpu_step(statics: StaticArrays, state: SchedState, ext: PodExt):
    """K6's function: (gpu_ok [N], gpu_shares [N, GD]) of a GPU-share pod."""
    return gpu_plan(
        state.gpu_free, statics.gpu_dev_exists, statics.gpu_total,
        ext.gpu_mem, ext.gpu_count, ext.gpu_preset,
    )


def open_local_term(statics: StaticArrays, score, raw, m_all, flags: StepFlags):
    """`score + w10 * minmax(raw, m_all)` as one FMA, the Open-Local term
    added after the mask as in the JAX package (a storage-free pod's raw 0
    normalizes to exactly 0)."""
    if flags.storage:
        score = fma(statics.score_w[10], minmax_normalize(raw, m_all), score)
    return score


def filter_and_score(statics: StaticArrays, state: SchedState, pod, flags: StepFlags) -> StepEval:
    """The full filter cascade and score sum for one pod tuple (g, req, pin,
    forced, lvm_size, lvm_vg, dev_size, dev_media, gpu_mem, gpu_count,
    gpu_preset); a 4-tuple is a pod with no extended demands."""
    g, req, pin = int(pod[0]), pod[1], int(pod[2])
    f = flags
    m_static, m_ports, m_res, m_vol, m_att, m_bind = node_masks(statics, state, g, req, pin, f)
    ext = pod_ext(pod, statics.alloc.device) if len(pod) > 4 else None
    # the skip constants of a storage-free pod: every node fits, zero
    # allocation, raw score 0
    storage_ok = torch.ones_like(m_bind)
    lvm_alloc = torch.zeros_like(statics.vg_cap)
    dev_take = torch.zeros(statics.sdev_cap.shape, dtype=torch.bool, device=m_bind.device)
    raw = torch.zeros_like(statics.vg_cap[:, 0])
    m_storage = m_bind
    if f.storage:
        if ext is not None and storage_demand(pod[4], pod[6]):
            storage_ok, lvm_alloc, dev_take, raw = storage_step(statics, state, ext)
        m_storage = m_bind & storage_ok
    gpu_shares = torch.zeros_like(state.gpu_free)
    m_gpu = m_storage
    if f.gpu:
        gpu_ok = torch.ones_like(m_bind)
        if ext is not None and ext.gpu_mem > 0:
            gpu_ok, gpu_shares = gpu_step(statics, state, ext)
        m_gpu = m_storage & gpu_ok
    spread_ok, ip_ok = topology_masks(statics, state, g, m_static, f)
    m_spread = m_gpu & spread_ok
    m_all = m_spread & ip_ok
    score = score_pod(statics, state, g, req, m_all, f)
    return StepEval(
        m_static, m_ports, m_res, m_vol, m_att, m_bind, m_storage, m_gpu, m_spread, m_all,
        open_local_term(statics, score, raw, m_all, f), score, lvm_alloc, dev_take, gpu_shares,
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
    extended=None,
) -> None:
    """K4's function: the state update at the chosen node, IN PLACE. A pod
    that was not placed changes nothing (the JAX package adds zeros).
    `extended` = (lvm_alloc [V], dev_take [SD], gpu_shares [GD], gpu_mem):
    the pod's extended allocations at the chosen node; None (or a None
    row) adds nothing, exactly as the JAX package's zero allocation."""
    if not placed:
        return
    f = flags
    state.free[chosen] += -req
    if f.ports:
        state.ports_used[chosen] += statics.ports_req[g].to(torch.float32)
    if f.vols or f.attach:
        v_rw = statics.vol_rw_req[g]
        v_present = v_rw | statics.vol_ro_req[g] | statics.vol_att_req[g]
        state.vols_any[chosen] += v_present.to(torch.float32)
        if f.vols:
            state.vols_rw[chosen] += v_rw.to(torch.float32)
    if extended is not None:
        lvm_row, take_row, shares_row, gpu_mem = extended
        if f.storage and lvm_row is not None:
            state.vg_free[chosen] += -lvm_row
            state.sdev_free[chosen] &= ~take_row
        if f.gpu and shares_row is not None:
            state.gpu_free[chosen] += -shares_row * gpu_mem
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
    """One scheduling cycle for one pod tuple against every node; updates
    `state` in place. Returns (out_node, reason)."""
    ev = filter_and_score(statics, state, pod, flags)
    chosen, placed, reason = choose(ev, bool(pod[3]), int(pod[2]), statics.node_valid)
    extended = None
    if len(pod) > 4 and placed:
        extended = (ev.lvm_alloc[chosen], ev.dev_take[chosen], ev.gpu_shares[chosen], float(pod[8]))
    commit(statics, state, int(pod[0]), pod[1], chosen, placed, flags, extended)
    return (chosen if placed else -1), reason


# -- the per-pod kernels: device buffers, plain versions, wrappers ----------


class StepBuffers:
    """Everything K1–K6 read and write for one batch, on one device: the
    statics, the state (updated in place), the batch's pod arrays, the
    per-node scratch (stage byte, raw count rows, score, the storage and
    GPU plans) and the per-pod outputs, which stay on the device until the
    batch ends. `storage_live` / `gpu_live` are host arrays: which pods
    run K5 / K6 (decided from the batch's numpy arrays, no device sync);
    `ext_live` is the same per-pod bitmask on the device for K3/K4."""

    def __init__(self, statics: StaticArrays, state: SchedState, pods, flags: StepFlags):
        dev = statics.alloc.device
        self.device = dev
        self.statics = statics
        self.state = state
        self.flags = flags
        self.flag_bits = flag_bits(flags)

        def host(x, dtype):
            return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, dtype)

        def on_dev(x, dtype):
            return torch.as_tensor(host(x, dtype), device=dev).contiguous()

        group, req, pin, forced = pods[:4]
        # the pods' groups and pins on the host too (lists: the launch reads
        # one): K1, K2 and K4 take a pod's group, K1 its pin, as arguments,
        # one dependent load less on the card
        self.group = on_dev(group, np.int32)
        self.group_host = host(group, np.int32).tolist()
        self.req = on_dev(req, np.float32)
        self.pin = on_dev(pin, np.int32)
        self.pin_host = host(pin, np.int32).tolist()
        self.forced = on_dev(forced, bool)
        n, p = statics.alloc.shape[0], len(self.group)
        v, sd = statics.vg_cap.shape[1], statics.sdev_cap.shape[1]
        gd = state.gpu_free.shape[1]
        self.n_pods = p
        if len(pods) > 4:
            lvm_size, lvm_vg, dev_size, dev_media, gpu_mem, gpu_count, gpu_preset = pods[4:]
        else:  # no extended demands
            lvm_size = dev_size = np.zeros((p, 1), np.float32)
            lvm_vg = np.full((p, 1), -1, np.int32)
            dev_media = np.zeros((p, 1), np.int32)
            gpu_mem, gpu_count = np.zeros(p, np.float32), np.zeros(p, np.int32)
            gpu_preset = np.zeros((p, gd), np.int32)
        lvm_size, dev_size = host(lvm_size, np.float32), host(dev_size, np.float32)
        gpu_mem = host(gpu_mem, np.float32)
        self.storage_live = storage_demand(lvm_size, dev_size) & flags.storage
        self.gpu_live = (gpu_mem > 0) if flags.gpu else np.zeros(p, bool)
        self.ext_live = on_dev(self.storage_live.astype(np.uint8) | (self.gpu_live.astype(np.uint8) << 1),
                               np.uint8)
        self.lvm_size = on_dev(lvm_size, np.float32)
        self.lvm_vg = on_dev(lvm_vg, np.int32)
        self.dev_size = on_dev(dev_size, np.float32)
        self.dev_media = on_dev(dev_media, np.int32)
        self.gpu_mem = on_dev(gpu_mem, np.float32)
        self.gpu_count = on_dev(gpu_count, np.int32)
        self.gpu_preset = on_dev(gpu_preset, np.int32)
        # each pod's GPU request on the host too, as K6 takes it: (per-GPU
        # memory, count, whether its preset row is set — a sum > 0 in
        # int32, as the JAX package sums it)
        preset_set = host(gpu_preset, np.int32).sum(axis=1, dtype=np.int32) > 0
        self.gpu_host = list(zip(gpu_mem.tolist(), host(gpu_count, np.int32).tolist(),
                                 preset_set.astype(np.int32).tolist()))
        self.stage = torch.zeros(n, dtype=torch.uint8, device=dev)
        self.raw = torch.zeros((4, n), dtype=torch.float32, device=dev)
        self.score = torch.zeros(n, dtype=torch.float32, device=dev)
        self.st_ok = torch.ones(n, dtype=torch.bool, device=dev)
        self.st_alloc = torch.zeros((n, v), dtype=torch.float32, device=dev)
        self.st_fr = torch.zeros((n, v), dtype=torch.float32, device=dev)  # K5's running VG free space
        self.st_take = torch.zeros((n, sd), dtype=torch.bool, device=dev)
        self.st_raw = torch.zeros(n, dtype=torch.float32, device=dev)
        self.gpu_ok = torch.ones(n, dtype=torch.bool, device=dev)
        self.gpu_sh = torch.zeros((n, gd), dtype=torch.float32, device=dev)
        self.chosen = torch.zeros(p, dtype=torch.int32, device=dev)
        self.placed = torch.zeros(p, dtype=torch.bool, device=dev)
        self.reason = torch.zeros(p, dtype=torch.int32, device=dev)
        self.out_node = torch.full((p,), -1, dtype=torch.int32, device=dev)
        self.out_lvm = torch.zeros((p, v), dtype=torch.float32, device=dev)
        self.out_take = torch.zeros((p, sd), dtype=torch.bool, device=dev)
        self.out_gpu = torch.zeros((p, gd), dtype=torch.float32, device=dev)
        # the wave kernels' (engine/wavefront.py) carried rows where a
        # thread's nodes pass what registers hold, and the phase cycles the
        # kernels' profile build adds up (kernels/csrc/wave.cuh)
        self.wave_rows = torch.zeros((cuda.WAVE_ROWS, n), dtype=torch.float32, device=dev)
        self.wave_prof = torch.zeros(cuda.WAVE_PROF_SLOTS, dtype=torch.int64, device=dev)
        # K10's scratch past its shared budget (kernels/cuda.py
        # wave_hard_plan), at first use
        self.wave_slab = None
        # K2's launch plan (kernels/cuda.py topology_plan) and its slab, at
        # first use; a swept plan's, kept alive while in use; the term
        # columns' table K2 and K4 stage (kernels/cuda.py column_table),
        # built with the argument block
        self.topo_plan = None
        self.topo_sweep = None
        # K1's, K5's and K6's launch plans (kernels/cuda.py filter_plan,
        # storage_plan, gpu_plan), at first use
        self.filter_plan = None
        self.storage_plan = None
        # K6's plan, its address and the requests it points at (host)
        self.gpu_plan = self.gpu_plan_ptr = self.gpu_reqs = None
        self.g_cols = None
        self.ctx = None  # the kernels' argument struct, built at first launch

    def pod_ext(self, i: int) -> PodExt:
        """Pod i's extended demands, as the plain versions take them."""
        return PodExt(
            self.lvm_size[i], self.lvm_vg[i], self.dev_size[i], self.dev_media[i],
            float(self.gpu_mem[i]), int(self.gpu_count[i]), self.gpu_preset[i],
        )


def _stage_masks(stage: torch.Tensor):
    """The eight cumulative stage masks packed in the stage byte."""
    return [((stage >> b) & 1).bool() for b in range(8)]


def _ext_masks(buf: StepBuffers, i: int):
    """(storage_ok, gpu_ok, raw) of pod i as K3 reads them: the plan
    buffers where K5/K6 ran for the pod, the skip constants elsewhere."""
    live = int(buf.ext_live[i])
    st_ok = buf.st_ok if live & 1 else torch.ones_like(buf.st_ok)
    gpu_ok = buf.gpu_ok if live & 2 else torch.ones_like(buf.gpu_ok)
    raw = buf.st_raw if live & 1 else torch.zeros_like(buf.st_raw)
    return st_ok, gpu_ok, raw


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


def storage_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K5: the storage plan of pod i into the scratch."""
    cuda.count_plain("storage_pod")
    ok, alloc, take, raw = storage_step(buf.statics, buf.state, buf.pod_ext(i))
    buf.st_ok.copy_(ok)
    buf.st_alloc.copy_(alloc)
    buf.st_take.copy_(take)
    buf.st_raw.copy_(raw)


def gpu_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K6: the GPU plan of pod i into the scratch."""
    cuda.count_plain("gpu_pod")
    ok, shares = gpu_step(buf.statics, buf.state, buf.pod_ext(i))
    buf.gpu_ok.copy_(ok)
    buf.gpu_sh.copy_(shares)


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
    """Plain version of K3: the storage and GPU verdicts, score, fail code,
    argmax and forced override."""
    cuda.count_plain("score_argmax_pod")
    g, pin, forced = int(buf.group[i]), int(buf.pin[i]), bool(buf.forced[i])
    m = _stage_masks(buf.stage)
    st_ok, gpu_ok, raw = _ext_masks(buf, i)
    m_storage = m[5] & st_ok
    m_gpu = m_storage & gpu_ok
    m_spread = m[6] & st_ok & gpu_ok
    m_all = m[7] & st_ok & gpu_ok
    score = score_pod(
        buf.statics, buf.state, g, buf.req[i], m_all, buf.flags, TopoRaws(*buf.raw.unbind(0))
    )
    none = torch.zeros(0)
    ev = StepEval(m[0], m[1], m[2], m[3], m[4], m[5], m_storage, m_gpu, m_spread, m_all,
                  open_local_term(buf.statics, score, raw, m_all, buf.flags), score,
                  none, none, none)
    chosen, placed, reason = choose(ev, forced, pin, buf.statics.node_valid)
    buf.score.copy_(ev.score)
    buf.chosen[i] = chosen
    buf.placed[i] = placed
    buf.reason[i] = reason
    buf.out_node[i] = chosen if placed else -1


def commit_pod_plain(buf: StepBuffers, i: int) -> None:
    """Plain version of K4: the in-place state update for pod i and its
    extended allocations at the chosen node."""
    cuda.count_plain("commit_pod")
    chosen, placed = int(buf.chosen[i]), bool(buf.placed[i])
    live = int(buf.ext_live[i])
    extended = None
    if placed:
        st, gp = live & 1, live & 2
        extended = (
            buf.st_alloc[chosen] if st else None,
            buf.st_take[chosen] if st else None,
            buf.gpu_sh[chosen] if gp else None,
            float(buf.gpu_mem[i]),
        )
        if st:
            buf.out_lvm[i] = buf.st_alloc[chosen]
            buf.out_take[i] = buf.st_take[chosen]
        if gp:
            buf.out_gpu[i] = buf.gpu_sh[chosen]
    commit(buf.statics, buf.state, int(buf.group[i]), buf.req[i], chosen, placed, buf.flags, extended)


def filter_pod(buf: StepBuffers, i: int) -> None:
    """K1 (`kernels/csrc/filter_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        filter_pod_plain(buf, i)
    else:
        cuda.launch("filter_pod", buf, i)


def storage_pod(buf: StepBuffers, i: int) -> None:
    """K5 (`kernels/csrc/storage_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        storage_pod_plain(buf, i)
    else:
        cuda.launch("storage_pod", buf, i)


def gpu_pod(buf: StepBuffers, i: int) -> None:
    """K6 (`kernels/csrc/gpu_pod.cu`) for pod i."""
    if buf.device.type == "cpu":
        gpu_pod_plain(buf, i)
    else:
        cuda.launch("gpu_pod", buf, i)


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
    """The per-pod kernels for every pod of the batch, in order, with no
    host sync; K5/K6 only for the pods whose demands need them."""
    run_pods(buf, 0, buf.n_pods)


def run_pods(buf: StepBuffers, a: int, b: int) -> None:
    """The per-pod kernels for the pods [a, b) of the batch, in order."""
    for i in range(a, b):
        filter_pod(buf, i)
        if buf.storage_live[i]:
            storage_pod(buf, i)
        if buf.gpu_live[i]:
            gpu_pod(buf, i)
        topology_pod(buf, i)
        score_argmax_pod(buf, i)
        commit_pod(buf, i)


class Engine:
    """Host-side engine: threads the placement log across app batches, with
    the scheduling state carried on `device` between batches.

    The placement log is the functional analog of the scheduler cache:
    evicting a victim deletes its log entry (`remove_placements`), and the
    carried state follows through a signed log delta (K13 on a compact
    carry, K7 on a dense one) instead of a rebuild from the whole log."""

    def __init__(self, tensorizer, device):
        self.tensorizer = tensorizer
        self.device = torch.device(device)
        #: optional schedconfig.SchedulerConfig (score-weight overrides)
        self.sched_config = None
        #: place same-group runs through the speculative wavefront (K9/K10,
        #: engine/wavefront.py); placements are equal either way
        self.speculate = True
        #: carry the state between batches in the compact layout
        #: (engine/state.py CompactState); placements are equal either way
        self.compact = True
        #: optional [N] host bool mask — False rows are out of this cluster
        self.node_valid = None
        self.placed_group: List[int] = []
        self.placed_node: List[int] = []
        self.placed_req: List[np.ndarray] = []
        # extended-resource placement log, keyed parallel to placed_node
        self.ext_log = {"node": [], "vg_alloc": [], "sdev_take": [], "gpu_shares": [], "gpu_mem": []}
        #: the carried state: a CompactState, or a dense SchedState when
        #: the compact layout is off or has no tabular row
        self.last_state = None
        self._last_vocab = None
        #: the carried state no longer reflects the log (a batch or a delta
        #: failed part-way, or a delta had no carry to apply to): the next
        #: place() rebuilds it from the log
        self._state_dirty = False
        #: grow mode (`enable_grow`): a dense carry with bucket-padded term
        #: axes, extended in place as the vocabulary or the node axis grows
        self.grow = False
        #: the bucket layout of the grow-mode carry (`_grow_layout`)
        self._grow_ref = None

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

    # -- compact carried-state plumbing ----------------------------------

    def _active_compact_spec(self, tensors):
        """The compaction plan when this engine carries compact state (None
        = carry dense: the switch is off, or no topology key is tabular)."""
        if not self.compact:
            return None
        spec = compact_spec(tensors)
        return spec if spec.enabled else None

    def _expand_carry(self, tensors, cstate: CompactState) -> SchedState:
        """The dense view of a compact carry, in fresh tensors (K12)."""
        STATE_COUNTS["expand"] += 1
        return expand_state(compact_spec_dev(tensors, self.device), cstate,
                            node_dom_small_for(tensors, cstate.free.shape[0], self.device))

    def _store_state(self, tensors, final_state: SchedState):
        """The carry place() stores: compressed (K11) when the compact
        layout is active, and gauged."""
        dense_bytes = sum(state_nbytes(final_state).values())
        stored = final_state
        if self._active_compact_spec(tensors) is not None:
            STATE_COUNTS["compress"] += 1
            stored = compress_state(compact_spec_dev(tensors, self.device), final_state)
        update_state_gauge(stored, dense_bytes)
        return stored

    def carried_state(self) -> SchedState:
        """The engine's carried state as a dense SchedState (None before the
        first batch); a compact carry is expanded into fresh tensors."""
        state = self.last_state
        if state is not None and self._state_dirty:
            raise ValueError(
                "carried_state(): the carry no longer reflects the placement log; "
                "place() again (which rebuilds it from the log) before reading it"
            )
        if state is None:
            return state
        tensors = self.tensorizer.freeze()
        if self._last_vocab != self.state_vocab(tensors):
            raise ValueError(
                "carried_state(): the carry predates a vocabulary change; place() the "
                "pending batch first, or rebuild from the placement log"
            )
        if isinstance(state, CompactState):
            state = self._expand_carry(tensors, state)
        if self.grow and self._grow_ref is not None:
            # grow-mode carries are bucket-padded; consumers get the
            # exact-shape view: row slices of the LIVE carry, which they
            # read and must not write through
            state = strip_term_padding(state, self._grow_ref["t"], self._grow_ref["ti"])
        return state

    # -- append-only vocabulary growth (grow mode) ---------------------------

    def enable_grow(self) -> None:
        """Switch this engine to grow mode: the carried state stays DENSE
        with its term axes padded to pow2 buckets, and a vocabulary growth
        extends it in place (K24) instead of rebuilding it from the log;
        `grow_nodes` widens it after `Tensorizer.add_clone_nodes` (K25).
        The compact carry is off: its plan is keyed to the exact term
        partition. Placements are bit-identical either way."""
        self.grow = True
        self.compact = False

    def _grow_layout(self, tensors) -> dict:
        """The bucket layout of a grow-mode carry built over `tensors`."""
        ip_terms = np.flatnonzero(interpod_term_index(tensors) >= 0)
        t, ti = tensors.n_terms, len(ip_terms)
        return {"t": t, "ti": ti, "ip_terms": ip_terms, "t_cap": snap_pow2(t) if t else 0,
                "ti_cap": snap_pow2(ti) if ti else 0, "n": tensors.alloc.shape[0]}

    def _enter_grow_buckets(self, tensors, dense_state: SchedState) -> SchedState:
        """Copy a freshly built exact-shape state into its term buckets
        (K24) and record the carried layout."""
        ref = self._grow_layout(tensors)
        state = pad_terms(dense_state, ref["t_cap"], ref["ti_cap"])
        self._grow_ref = ref
        return state

    def _try_extend_carry(self, tensors, vocab):
        """Extend the carried (bucket-padded) state to a grown vocabulary
        (K24); None when the change is not an in-place append
        (resource/port/volume axes or the node axis moved — rebuild
        instead)."""
        old = self._last_vocab
        ref = self._grow_ref
        if old is None or ref is None:
            return None
        r1, t1, p1, w1, _ti1, n1 = vocab
        r0, _t0, p0, w0, _ti0, n0 = old
        if (r1, p1, w1, n1) != (r0, p0, w0, n0) or n1 != ref["n"]:
            return None
        if t1 < ref["t"]:
            return None
        plan = grow_plan_terms(tensors, ref["t"], ref["ip_terms"], np.asarray(self.placed_group, np.int32),
                               np.asarray(self.placed_node, np.int32))
        promoted = plan["t_cap"] != ref["t_cap"] or plan["ti_cap"] != ref["ti_cap"]
        self._state_dirty = True
        state = extend_state(self.last_state, plan)
        self._state_dirty = False
        self._grow_ref = {"t": plan["t"], "ti": plan["ti"], "ip_terms": plan["ip_terms"],
                          "t_cap": plan["t_cap"], "ti_cap": plan["ti_cap"], "n": n1}
        GROW_COUNTS["grow.extends"] += 1
        if promoted:
            GROW_COUNTS["grow.bucket_promotions"] += 1
        return state

    def grow_nodes(self) -> bool:
        """Extend the carried state to the tensorizer's grown node axis
        (after `Tensorizer.add_clone_nodes`, K25): counts of pods already
        placed in a domain a clone joins appear on the clone's columns.
        Returns False (carry invalidated, the next place() rebuilds from
        the log) when no extendable grow-mode carry exists."""
        tensors = self.tensorizer.freeze()
        vocab = self.state_vocab(tensors)
        if self._last_vocab == vocab and not self._state_dirty:
            return True  # the node axis did not actually move
        ref = self._grow_ref
        if (
            not self.grow
            or ref is None
            or self.last_state is None
            or self._state_dirty
            or isinstance(self.last_state, CompactState)
            or self._last_vocab is None
            or self._last_vocab[:5] != vocab[:5]
            or tensors.alloc.shape[0] < ref["n"]
        ):
            self._last_vocab = None
            return False
        plan = grow_plan_nodes(tensors, ref["n"], np.asarray(self.placed_group, np.int32),
                               np.asarray(self.placed_node, np.int32), ref["t_cap"], ref["ti_cap"])
        self._state_dirty = True
        self.last_state = extend_state_nodes(self.last_state, plan)
        self._state_dirty = False
        self._grow_ref = dict(ref, n=plan["n"])
        self._last_vocab = vocab
        GROW_COUNTS["grow.node_extends"] += 1
        return True

    def place(self, batch: PodBatch):
        """Schedule one batch. Returns (node index per pod [-1 = failed],
        reason codes, extras) like the JAX package's Engine.place: extras
        carries each pod's extended allocation at its node (LVM per-VG
        bytes, device take mask, GPU device shares)."""
        ext = batch.ext
        tensors = self.tensorizer.freeze()
        r = tensors.alloc.shape[1]
        req, pods = build_pod_arrays(batch, r)
        vocab = self.state_vocab(tensors)
        state = self.last_state
        if state is not None and not self._state_dirty and self._last_vocab == vocab:
            if isinstance(state, CompactState):
                # fresh dense planes: the carry itself stays as it is until
                # the batch has run through
                state = self._expand_carry(tensors, state)
        else:
            state = None
            if (self.grow and self.last_state is not None and not self._state_dirty
                    and not isinstance(self.last_state, CompactState)):
                # append-only vocabulary growth: extend the carried planes
                # instead of rebuilding them from the log
                state = self._try_extend_carry(tensors, vocab)
            if state is None:
                if self.grow and self._grow_ref is not None:
                    GROW_COUNTS["grow.rebuilds"] += 1
                state = build_state(
                    tensors,
                    np.asarray(self.placed_group, np.int32),
                    np.asarray(self.placed_node, np.int32),
                    self.log_req_matrix(r),
                    self.ext_log,
                    self.device,
                )
                if self.grow:
                    state = self._enter_grow_buckets(tensors, state)
        statics = statics_from(tensors, self.sched_config, self.device)
        if self.node_valid is not None:
            statics = statics._replace(
                node_valid=statics.node_valid
                & torch.as_tensor(np.asarray(self.node_valid, bool), device=self.device)
            )
        buf = StepBuffers(statics, state, pods, flags_from(tensors, ext))
        # the batch updates `state` in place: a failure part-way leaves a
        # reused dense carry inconsistent with the log (a compact carry
        # stays intact, its expansion being fresh planes); either way the
        # next place() rebuilds from the log, as the JAX package does
        self._state_dirty = True
        # batch context for _dispatch overrides (the rounds engine segments
        # the batch by group and spec)
        self._current_batch, self._current_tensors = batch, tensors
        nodes, reasons, lvm_alloc, dev_take, gpu_shares = self._dispatch(buf, pods)
        self.last_state = self._store_state(tensors, buf.state)
        self._last_vocab = vocab
        self._state_dirty = False
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

    def _dispatch(self, buf: StepBuffers, pods):
        """Place every pod of the batch on `buf`'s state, in place; returns
        the host outputs (nodes, reasons, lvm_alloc, dev_take, gpu_shares).
        The rounds engine (`engine/rounds.py`) overrides it, as the JAX
        package's `Engine._dispatch` is overridden."""
        waves = self._run_range(buf, pods, 0, buf.n_pods)
        return self._fetch_range(buf, 0, buf.n_pods, waves)

    def _run_range(self, buf: StepBuffers, pods, a: int, b: int) -> list:
        """The pods [a, b) of the batch on `buf`'s shared state: through the
        speculative wavefront (its chunk plan cut from a) when `speculate`
        is on, else the per-pod kernels. Returns the waves launched."""
        if not self.speculate:
            if (a, b) == (0, buf.n_pods):
                run_batch(buf)
            else:
                run_pods(buf, a, b)
            return []
        from . import wavefront

        return wavefront.run_batch_waves(
            buf, self._current_tensors, np.asarray(self._current_batch.group), pods, a, b)

    @staticmethod
    def _fetch_range(buf: StepBuffers, a: int, b: int, waves=()):
        """The host outputs of pods [a, b) (one sync), with the wavefront
        counters of the waves launched over them."""
        nodes = buf.out_node[a:b].cpu().numpy().astype(np.int64)
        if waves:
            from . import wavefront

            wavefront.count_waves(waves, nodes, a)
        return (nodes, buf.reason[a:b].cpu().numpy(), buf.out_lvm[a:b].cpu().numpy(),
                buf.out_take[a:b].cpu().numpy(), buf.out_gpu[a:b].cpu().numpy())

    # -- preemption support -------------------------------------------------

    def _apply_saved_delta(self, saved: dict, sign: float) -> None:
        """Apply an eviction (sign=-1) or its undo (sign=+1) to the carried
        state in place, so preemption does not force a rebuild from the
        placement log: K13 straight into a compact carry, K7 into a dense
        one. With no carry to apply to (none yet, a dirty one, or one of an
        older vocabulary) the state is marked dirty instead and the next
        place() rebuilds it."""
        entries = saved["entries"]
        if self.last_state is None or self._state_dirty or not entries:
            self._state_dirty = True
            return
        tensors = self.tensorizer.freeze()
        if self._last_vocab != self.state_vocab(tensors):
            self._state_dirty = True
            return
        ext = tensors.ext
        packed = pack_delta_entries(
            entries,
            tensors.alloc.shape[1],
            ext.vg_cap.shape[1],
            ext.sdev_cap.shape[1],
            ext.gpu_dev_total.shape[1],
            sign,
        )
        statics = statics_from(tensors, self.sched_config, self.device)
        state = self.last_state
        # a delta that fails part-way leaves the carry half-applied
        self._state_dirty = True
        if isinstance(state, CompactState):
            n_carry = state.free.shape[0]
            apply_placement_deltas_compact(
                statics, compact_delta_spec_dev(tensors, self.device),
                node_dom_for(tensors, n_carry, self.device),
                node_dom_small_for(tensors, n_carry, self.device), state, packed)
            STATE_COUNTS["delta_direct"] += 1
        else:
            apply_placement_deltas(statics, state, packed)
            self.last_state = self._store_state(tensors, state)
        self._state_dirty = False

    def remove_placements(self, indices: List[int]) -> dict:
        """Delete log entries at `indices`; returns an undo token."""
        idx = sorted(set(indices))
        ext = self.ext_log
        saved = {
            "indices": idx,
            "entries": [
                (
                    self.placed_group[i],
                    self.placed_node[i],
                    self.placed_req[i],
                    ext["node"][i],
                    ext["vg_alloc"][i],
                    ext["sdev_take"][i],
                    ext["gpu_shares"][i],
                    ext["gpu_mem"][i],
                )
                for i in idx
            ],
        }
        for i in reversed(idx):
            del self.placed_group[i]
            del self.placed_node[i]
            del self.placed_req[i]
            for key in ("node", "vg_alloc", "sdev_take", "gpu_shares", "gpu_mem"):
                del ext[key][i]
        self._apply_saved_delta(saved, sign=-1.0)
        return saved

    def restore_placements(self, saved: dict) -> None:
        """Undo a remove_placements (entries return to their positions)."""
        ext = self.ext_log
        for i, entry in zip(saved["indices"], saved["entries"]):
            g, node, req, enode, vg, sdev, gpu_sh, gpu_mem = entry
            self.placed_group.insert(i, g)
            self.placed_node.insert(i, node)
            self.placed_req.insert(i, req)
            ext["node"].insert(i, enode)
            ext["vg_alloc"].insert(i, vg)
            ext["sdev_take"].insert(i, sdev)
            ext["gpu_shares"].insert(i, gpu_sh)
            ext["gpu_mem"].insert(i, gpu_mem)
        self._apply_saved_delta(saved, sign=1.0)
