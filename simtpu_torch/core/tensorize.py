"""Cluster + pod tensorization: k8s objects → dense arrays.

This module is the boundary between the host-side object world and the device
engine. It lowers the state the vendored scheduler keeps in caches and
informers (`vendor/.../scheduler/internal/cache/cache.go:57`, snapshot per
cycle) into:

- per-node resource arrays `alloc[N, R]`,
- per-topology-key domain ids `node_dom[K, N]`,
- a *pod group* axis G (pods with identical scheduling-relevant specs share a
  group), with a precomputed static feasibility mask `static_mask[G, N]`
  covering the stateless filter plugins (NodeUnschedulable, NodeName,
  TaintToleration, NodeAffinity/selector — `vendor/.../algorithmprovider/
  registry.go:75-145`), plus static per-group score terms, and
- an inter-pod affinity *term universe* T with the group↔term incidence
  matrices the scan-time InterPodAffinity kernels consume
  (`vendor/.../framework/plugins/interpodaffinity/filtering.go` semantics).

Node labels/taints never change during a simulation (nodes are pure data,
`SURVEY.md §4`), so everything that depends only on (pod spec, node spec) is
evaluated here once, vectorized over nodes in numpy; only state that evolves
with placements (free resources, topology counts, storage, GPU devices) lives
in the scan carry (engine/state.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from .extended import (
    ExtendedNodeArrays,
    StorageClassCatalog,
    pod_extended_demand,
    tensorize_node_storage,
)
from .match import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_IN,
    match_label_selector,
    toleration_tolerates_taint,
)
from .objects import (
    ATTACH_CLASSES,
    labels_of,
    name_of,
    namespace_of,
    node_allocatable,
    node_images,
    node_prefer_avoid_pods,
    node_taints,
    node_unschedulable,
    pod_affinity,
    pod_attachable_volumes,
    pod_host_ports,
    pod_images,
    pod_node_name,
    pod_node_selector,
    pod_owner_kind,
    pod_pvc_names,
    pod_requests,
    pod_tolerations,
    pod_topology_spread_constraints,
    pod_volume_conflicts,
    csi_attach_limit_key,
    pv_attachable_source,
    pv_csi_source,
)
from .quantity import parse_quantity
from .vocab import Interner

# Canonical resource order; extended resources appended dynamically.
RES_CPU = 0
RES_MEMORY = 1
RES_PODS = 2
_BASE_RESOURCES = ("cpu", "memory", "pods")

# Synthetic taint for unschedulable nodes (NodeUnschedulable plugin semantics:
# `vendor/.../plugins/nodeunschedulable/node_unschedulable.go`).
_UNSCHEDULABLE_TAINT = {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"}

# Domain-count cap for the "small key" same-domain reduction route (zone /
# region / rack-sized keys); keys with more domains use the unique-per-node
# route (hostname) or the scatter fallback. Shared with engine/rounds.py.
DOM_SMALL = 64

# -- carried-state dtype policy (THE conversion boundary) -------------------
#
# Every count-like plane of the carried scheduling state (topology counts,
# interpod owner counts/weights, port and volume user counts) holds small
# integers by construction: placements bump them by ±1 or by integer k8s
# preference weights, so the values are exact in int32 AND in float32 (below
# 2^24).  The layout policy (docs/memory.md, "state layout" table) is:
#
#   carried/boundary form (engine/state.py CompactState): COUNT_DTYPE —
#     integer, the honest dtype; crossing a dispatch boundary or the wire in
#     this form costs no precision and keeps regrouped sums bit-stable.
#   in-kernel form (SchedState inside a dispatch): float32 — the one-hot
#     matmul row gathers (state.take_rows) and the scoring kernels are
#     float pipelines; int-valued f32 arithmetic on counts is exact, so the
#     f32 <-> COUNT_DTYPE casts at expand/compress are bit-clean round trips.
#   boolean planes (sdev_free, node_valid, every feasibility mask):
#     MASK_DTYPE end to end — never widened to float.
#
# This block is the single place the policy lives; engine/state.py imports
# these names rather than restating dtypes at each conversion site.
COUNT_DTYPE = np.int32
MASK_DTYPE = np.bool_


# ---------------------------------------------------------------------------
# Node-side vectorized label algebra
# ---------------------------------------------------------------------------


class NodeLabelIndex:
    """Boolean-column view of node labels for vectorized selector evaluation."""

    def __init__(self, nodes: Sequence[dict]):
        self.n = len(nodes)
        self.names = np.array([name_of(n) for n in nodes])
        # per key: an [N] int32 value-id array (-1 = key absent) plus the
        # value→id map. Storage is O(keys x N) — a dense bool column per
        # (key, value) pair would be O(N^2) through high-cardinality keys
        # like kubernetes.io/hostname.
        self._vid: Dict[str, np.ndarray] = {}
        self._vmap: Dict[str, Dict[str, int]] = {}
        self._val: Dict[str, np.ndarray] = {}  # raw values per key (for Gt/Lt)
        for i, node in enumerate(nodes):
            for k, v in labels_of(node).items():
                v = "" if v is None else str(v)
                vid = self._vid.get(k)
                if vid is None:
                    vid = self._vid[k] = np.full(self.n, -1, np.int32)
                    self._vmap[k] = {}
                    self._val[k] = np.full(self.n, "", object)
                vm = self._vmap[k]
                j = vm.get(v)
                if j is None:
                    j = vm[v] = len(vm)
                vid[i] = j
                self._val[k][i] = v

    def has_kv(self, key: str, value: str) -> np.ndarray:
        vid = self._vid.get(key)
        if vid is None:
            return np.zeros(self.n, bool)
        return vid == self._vmap[key].get(value, -2)

    def has_key(self, key: str) -> np.ndarray:
        vid = self._vid.get(key)
        return vid >= 0 if vid is not None else np.zeros(self.n, bool)

    def match_requirement(self, req: dict, field_names: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized NodeSelectorRequirement over all nodes.

        field_names switches evaluation to matchFields (metadata.name).
        Semantics mirror match.match_requirement / apimachinery selector.go.
        """
        key = req.get("key", "")
        op = req.get("operator", "")
        vals = req.get("values") or []
        if field_names is not None:
            # only metadata.name is a legal field key
            if key != "metadata.name":
                return np.zeros(self.n, bool)
            present = np.ones(self.n, bool)
            member = np.isin(field_names, vals)
            if op == OP_IN:
                return member
            if op == OP_NOT_IN:
                return ~member
            if op == OP_EXISTS:
                return present
            if op == OP_DOES_NOT_EXIST:
                return ~present
            return np.zeros(self.n, bool)
        present = self.has_key(key)
        if op == OP_IN:
            out = np.zeros(self.n, bool)
            for v in vals:
                out |= self.has_kv(key, v)
            return out
        if op == OP_NOT_IN:
            out = np.zeros(self.n, bool)
            for v in vals:
                out |= self.has_kv(key, v)
            return ~out
        if op == OP_EXISTS:
            return present
        if op == OP_DOES_NOT_EXIST:
            return ~present
        if op in (OP_GT, OP_LT):
            if not vals:
                return np.zeros(self.n, bool)
            try:
                rhs = int(vals[0])
            except ValueError:
                return np.zeros(self.n, bool)
            out = np.zeros(self.n, bool)
            raw = self._val.get(key)
            if raw is None:
                return out
            for i in range(self.n):
                if present[i]:
                    try:
                        lhs = int(raw[i])
                    except (ValueError, TypeError):
                        continue
                    out[i] = lhs > rhs if op == OP_GT else lhs < rhs
            return out
        return np.zeros(self.n, bool)

    def match_term(self, term: dict) -> np.ndarray:
        """One NodeSelectorTerm over all nodes (AND of expressions+fields)."""
        exprs = term.get("matchExpressions") or []
        fields = term.get("matchFields") or []
        if not exprs and not fields:
            return np.zeros(self.n, bool)
        out = np.ones(self.n, bool)
        for req in exprs:
            out &= self.match_requirement(req)
        for req in fields:
            out &= self.match_requirement(req, field_names=self.names)
        return out


# ---------------------------------------------------------------------------
# Group signatures & pin extraction
# ---------------------------------------------------------------------------


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _extract_pin(node_affinity_required: Optional[dict]) -> Tuple[Optional[str], Optional[dict]]:
    """Detect a DaemonSet-style metadata.name pin common to every term.

    DaemonSet pods are pinned per node (`pkg/utils/utils.go:861-906`), which
    would otherwise explode the group axis to one group per node. If every
    required term carries the same single `metadata.name In [x]` matchFields
    requirement, return (x, affinity-with-fields-stripped).
    """
    if not node_affinity_required:
        return None, node_affinity_required
    terms = node_affinity_required.get("nodeSelectorTerms") or []
    if not terms:
        return None, node_affinity_required
    pin = None
    stripped_terms = []
    for term in terms:
        fields = term.get("matchFields") or []
        if (
            len(fields) != 1
            or fields[0].get("key") != "metadata.name"
            or fields[0].get("operator") != OP_IN
            or len(fields[0].get("values") or []) != 1
        ):
            return None, node_affinity_required
        value = fields[0]["values"][0]
        if pin is None:
            pin = value
        elif pin != value:
            return None, node_affinity_required
        t = {k: v for k, v in term.items() if k != "matchFields"}
        stripped_terms.append(t)
    # a term left empty after stripping was pure pin — its expression part is
    # vacuously true, and terms are OR'd, so the whole required clause reduces
    # to just the pin
    if any(not t.get("matchExpressions") for t in stripped_terms):
        return pin, None
    return pin, {"nodeSelectorTerms": stripped_terms}


@dataclass
class PodGroup:
    """One equivalence class of pods (identical scheduling-relevant spec)."""

    node_selector: dict
    affinity_required: Optional[dict]  # pin-stripped node affinity required
    affinity_preferred: list
    tolerations: list
    labels: Dict[str, str]
    namespace: str
    pod_affinity: dict  # podAffinity sub-dict
    pod_anti_affinity: dict
    host_ports: Tuple[Tuple[str, int], ...] = ()  # (protocol, hostPort)
    topology_spread: tuple = ()  # canonicalized topologySpreadConstraints
    owner_kind: str = ""  # controller ownerReference kind
    images: Tuple[str, ...] = ()  # container image names
    vol_rw: Tuple[str, ...] = ()  # exclusive volume keys (VolumeRestrictions)
    vol_ro: Tuple[str, ...] = ()  # read-only-shareable volume keys
    vol_att: tuple = ()  # inline attachable (key, class) pairs (NodeVolumeLimits)
    pvc_refs: Tuple[str, ...] = ()  # referenced claim names (VolumeBinding/Zone)

    def signature(self) -> str:
        return _canon(
            [
                self.node_selector,
                self.affinity_required,
                self.affinity_preferred,
                self.tolerations,
                sorted(self.labels.items()),
                self.namespace,
                self.pod_affinity,
                self.pod_anti_affinity,
                list(self.host_ports),
                list(self.topology_spread),
                self.owner_kind,
                sorted(self.images),
                list(self.vol_rw),
                list(self.vol_ro),
                [list(p) for p in self.vol_att],
                list(self.pvc_refs),
            ]
        )


def _group_of_pod(pod: dict) -> Tuple[PodGroup, Optional[str]]:
    aff = pod_affinity(pod)
    node_aff = aff.get("nodeAffinity") or {}
    pin, stripped_required = _extract_pin(
        node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    )
    # NodePorts semantics collapse hostIP to the (protocol, port) pair: two
    # hostPorts conflict when IPs overlap and 0.0.0.0 (the default) overlaps
    # everything (`plugins/nodeports/node_ports.go`); distinct non-wildcard
    # IPs on the same port are rare enough to treat as conflicting.
    ports = tuple(
        sorted({(proto, port) for proto, _ip, port in pod_host_ports(pod)})
    )
    spread = tuple(
        _canon(c) for c in pod_topology_spread_constraints(pod)
    )
    vol_rw, vol_ro = pod_volume_conflicts(pod)
    return (
        PodGroup(
            node_selector=pod_node_selector(pod),
            affinity_required=stripped_required,
            affinity_preferred=node_aff.get("preferredDuringSchedulingIgnoredDuringExecution")
            or [],
            tolerations=pod_tolerations(pod),
            labels=labels_of(pod),
            namespace=namespace_of(pod),
            pod_affinity=aff.get("podAffinity") or {},
            pod_anti_affinity=aff.get("podAntiAffinity") or {},
            host_ports=ports,
            topology_spread=spread,
            owner_kind=pod_owner_kind(pod),
            images=tuple(pod_images(pod)),
            vol_rw=vol_rw,
            vol_ro=vol_ro,
            vol_att=tuple(pod_attachable_volumes(pod)),
            pvc_refs=tuple(sorted(set(pod_pvc_names(pod)))),
        ),
        pin,
    )


# ---------------------------------------------------------------------------
# Inter-pod affinity term universe
# ---------------------------------------------------------------------------


_UNPARSED = object()


@dataclass(frozen=True)
class Term:
    topology_key: str
    namespaces: Tuple[str, ...]
    selector_json: str  # canonical labelSelector

    @property
    def selector(self) -> dict:
        """Parsed labelSelector, cached on the instance — s_match refresh
        touches terms repeatedly and a per-call json.loads dominated it at
        scale. The cache lives and dies with the Term (no process-global
        growth); callers treat the returned dict as read-only. eq/hash use
        the declared fields only, so the cache slot does not affect
        interning."""
        got = getattr(self, "_parsed", _UNPARSED)
        if got is _UNPARSED:
            got = json.loads(self.selector_json)
            object.__setattr__(self, "_parsed", got)
        return got


def _terms_of(spec_terms: list, default_ns: str) -> List[Tuple[Term, float]]:
    """PodAffinityTerm list → [(Term, weight)] with weight 1 for required."""
    out = []
    for item in spec_terms or []:
        if "podAffinityTerm" in item:  # weighted form
            weight = float(item.get("weight", 0))
            term = item["podAffinityTerm"]
        else:
            weight = 1.0
            term = item
        ns = tuple(sorted(term.get("namespaces") or [default_ns]))
        sel = term.get("labelSelector")
        out.append(
            (
                Term(
                    topology_key=term.get("topologyKey", ""),
                    namespaces=ns,
                    selector_json=_canon(sel),
                ),
                weight,
            )
        )
    return out


class _RowTable:
    """Growing [G, N] plane with capacity doubling.

    Replaces per-group Python lists of [N] rows: freeze() used to np.stack
    ~2 GB of them at 1000 groups × 100k nodes (seconds per plane); here rows
    land in place and freeze() returns a zero-copy view. `append(None)`
    leaves the row at the fill value without touching memory — most planes
    (ImageLocality, preferred affinity, avoid penalties, volume masks) are
    all-fill for most groups.
    """

    def __init__(self, n: int, dtype, fill=0):
        self.n = n
        self.dtype = np.dtype(dtype)
        self.fill = fill
        self.rows = 0
        self.buf = self._alloc(16)

    def _alloc(self, cap: int) -> np.ndarray:
        if self.fill == 0 or self.fill is False:
            return np.zeros((cap, self.n), self.dtype)
        out = np.empty((cap, self.n), self.dtype)
        out.fill(self.fill)
        return out

    def append(self, row: Optional[np.ndarray]) -> None:
        if self.rows == self.buf.shape[0]:
            new = self._alloc(self.buf.shape[0] * 2)
            new[: self.rows] = self.buf
            self.buf = new
        if row is not None:
            self.buf[self.rows] = row
        self.rows += 1

    def view(self) -> np.ndarray:
        """[rows, N] zero-copy view. Later appends only write rows beyond it
        (or reallocate), so a frozen view's contents never change."""
        return self.buf[: self.rows]

    def __getitem__(self, i: int) -> np.ndarray:
        # bound-check against rows, not capacity: an index into the grown
        # tail would silently return a fill row and mask an off-by-one
        if not 0 <= i < self.rows:
            raise IndexError(i)
        return self.buf[i]

    def __len__(self) -> int:
        return self.rows


# ---------------------------------------------------------------------------
# The tensorized cluster
# ---------------------------------------------------------------------------


@dataclass
class ClusterTensors:
    """Everything static the engine needs, as numpy arrays (host-side)."""

    node_names: List[str]
    resource_names: List[str]
    alloc: np.ndarray  # [N, R] f32
    node_dom: np.ndarray  # [K, N] i32 global domain id, -1 when key absent
    n_domains: int
    topo_keys: List[str]
    # per-key same-domain reduction routing (engine/rounds.py): 1 = SMALL
    # (≤ DOM_SMALL domains; compact per-key ids in node_dom_small feed a
    # one-hot einsum), 2 = UNIQUE (every domain holds one node — zone sums
    # are the values themselves), 0 = fallback scatter
    key_kind: np.ndarray  # [K] i32
    node_dom_small: np.ndarray  # [K, N] i32 compact per-key id, -1 absent

    # group axis
    groups: List[PodGroup]
    static_mask: np.ndarray  # [G, N] bool — unschedulable+taints+affinity+selector
    node_pref_score: np.ndarray  # [G, N] f32 — NodeAffinity preferred raw score
    taint_intolerable: np.ndarray  # [G, N] f32 — count of intolerable PreferNoSchedule
    static_score: np.ndarray  # [G, N] f32 — ImageLocality

    # inter-pod term axis
    terms: List[Term]
    term_topo_key: np.ndarray  # [T] i32 index into topo_keys
    s_match: np.ndarray  # [G, T] bool — group's pods match term selector+ns
    a_aff_req: np.ndarray  # [G, T] bool
    a_anti_req: np.ndarray  # [G, T] bool
    w_aff_pref: np.ndarray  # [G, T] f32 (summed weights)
    w_anti_pref: np.ndarray  # [G, T] f32
    spread_hard: np.ndarray  # [G, T] f32 — maxSkew of DoNotSchedule constraints (0 = none)
    spread_soft: np.ndarray  # [G, T] f32 — count weight of ScheduleAnyway constraints
    ss_host: np.ndarray  # [G, T] bool — SelectorSpread hostname-key terms
    ss_zone: np.ndarray  # [G, T] bool — SelectorSpread zone-key terms

    # host-port axis (interned (protocol, hostPort) pairs)
    ports: np.ndarray = None  # [G, P] bool — group requests port p
    n_ports: int = 0

    avoid_pen: np.ndarray = None  # [G, N] f32 — NodePreferAvoidPods penalty

    # shared volume-identity axis (VolumeRestrictions + NodeVolumeLimits)
    vol_mask: np.ndarray = None  # [G, N] bool — VolumeBinding+VolumeZone feasibility
    vol_rw: np.ndarray = None  # [G, W] bool — group uses volume w read-write
    vol_ro: np.ndarray = None  # [G, W] bool — group uses volume w read-only
    vol_att: np.ndarray = None  # [G, W] bool — group attaches volume w
    vol_class_mask: np.ndarray = None  # [C, W] bool — volume w is attach class c
    attach_limits: np.ndarray = None  # [N, C] f32 per-node attach limits
    n_vols: int = 0

    # extended resources (Open-Local storage + GPU share)
    ext: ExtendedNodeArrays = field(repr=False, default=None)

    label_index: NodeLabelIndex = field(repr=False, default=None)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_terms(self) -> int:
        return len(self.terms)


@dataclass
class PodBatch:
    """Per-pod arrays for one schedulable batch, aligned with `pods`."""

    pods: List[dict]
    group: np.ndarray  # [P] i32
    req: np.ndarray  # [P, R] f32 (includes the synthetic `pods`=1 resource)
    pin: np.ndarray  # [P] i32 node index or -1
    forced: np.ndarray  # [P] bool — pre-assigned via spec.nodeName
    ext: dict = None  # stacked extended demand arrays (built by add_pods)


def slice_batch(batch: PodBatch, idx) -> PodBatch:
    """An index-selected view of a batch.  Engines consume only the arrays;
    `pods` follows (as references) when the source batch carries it, so
    drain/requeue consumers can still name the pods they report.  Shared by
    the incremental planner's completion probes and the fault subsystem's
    requeue batches."""
    idx = np.asarray(idx, np.int64)
    return PodBatch(
        pods=[batch.pods[int(i)] for i in idx] if batch.pods else [],
        group=batch.group[idx],
        req=batch.req[idx],
        pin=batch.pin[idx],
        forced=batch.forced[idx],
        ext={k: np.asarray(v)[idx] for k, v in batch.ext.items()},
    )


class GrowRefused(RuntimeError):
    """`Tensorizer.add_clone_nodes` cannot extend the node axis in place —
    the extension would change something the interned vocabularies already
    depend on (zone key, a reduction route, an ext plane width).  Raised
    BEFORE any mutation; callers fall back to a full re-tensorize."""


class Tensorizer:
    """Incremental tensorization: one instance per simulation.

    The group/term vocabularies grow as apps are scheduled in sequence
    (mirroring `sim.ScheduleApp` being called per app, `pkg/simulator/
    simulator.go:167-184`); node-side arrays are fixed at construction.
    """

    def __init__(
        self,
        nodes: Sequence[dict],
        extra_resources: Sequence[str] = (),
        storage_classes: Sequence[dict] = (),
        services: Sequence[dict] = (),
        pvcs: Sequence[dict] = (),
        pvs: Sequence[dict] = (),
    ):
        self.nodes = list(nodes)
        self.label_index = NodeLabelIndex(self.nodes)
        self.node_idx = {name: i for i, name in enumerate(self.label_index.names)}
        self.vg_names = Interner()
        self.ext = tensorize_node_storage(self.nodes, self.vg_names)
        self.catalog = StorageClassCatalog(storage_classes)
        self.services = list(services)
        # VolumeBinding/VolumeZone context: claims by (namespace, name), PVs
        # by name (`plugins/volumebinding`, `plugins/volumezone`)
        self.claim_map = {(namespace_of(c), name_of(c)): c for c in pvcs}
        self.pv_map = {name_of(pv): pv for pv in pvs}
        self._pv_mask_cache: Dict[str, np.ndarray] = {}  # PVs are immutable

        # resource vocabulary: base + everything any node allocates
        # (allocatable maps parse once and are reused by _attach_limits)
        self._alloc_maps = [node_allocatable(node) for node in self.nodes]
        self.resources = Interner()
        for r in _BASE_RESOURCES:
            self.resources.intern(r)
        for am in self._alloc_maps:
            for r in am:
                self.resources.intern(r)
        for r in extra_resources:
            self.resources.intern(r)

        n, r = len(self.nodes), len(self.resources)
        self.alloc = np.zeros((n, r), np.float32)
        for i, am in enumerate(self._alloc_maps):
            for rname, val in am.items():
                self.alloc[i, self.resources.intern(rname)] = val

        self.taints: List[List[dict]] = [list(node_taints(nd)) for nd in self.nodes]
        for i, node in enumerate(self.nodes):
            if node_unschedulable(node):
                self.taints[i] = self.taints[i] + [_UNSCHEDULABLE_TAINT]
        # distinct-taint incidence: clusters carry few distinct taints, so
        # per-group toleration checks run per *distinct taint* and fan out to
        # nodes through these masks instead of a Python loop over N nodes
        self._hard_taints: List[dict] = []  # NoSchedule / NoExecute
        self._pref_taints: List[dict] = []  # PreferNoSchedule
        hard_ids: Dict[str, int] = {}
        pref_ids: Dict[str, int] = {}
        hard_rows: List[np.ndarray] = []
        pref_rows: List[np.ndarray] = []
        for i, taints in enumerate(self.taints):
            for taint in taints:
                effect = taint.get("effect")
                if effect in ("NoSchedule", "NoExecute"):
                    ids, rows, bucket = hard_ids, hard_rows, self._hard_taints
                elif effect == "PreferNoSchedule":
                    ids, rows, bucket = pref_ids, pref_rows, self._pref_taints
                else:
                    continue
                key = _canon(taint)
                t = ids.get(key)
                if t is None:
                    t = ids[key] = len(bucket)
                    bucket.append(taint)
                    rows.append(np.zeros(n, bool))
                rows[t][i] = True
        self._hard_taint_incid = (
            np.stack(hard_rows) if hard_rows else np.zeros((0, n), bool)
        )
        self._pref_taint_incid = (
            np.stack(pref_rows) if pref_rows else np.zeros((0, n), bool)
        )

        # NodePreferAvoidPods: static per-node avoid flag (annotation)
        self.prefer_avoid = np.array(
            [node_prefer_avoid_pods(nd) for nd in self.nodes], bool
        )
        # ImageLocality: image name → (nodes having it [N] bool, sizeBytes)
        self.image_index: Dict[str, Tuple[np.ndarray, float]] = {}
        for i, node in enumerate(self.nodes):
            for img in node_images(node):
                size = float(img.get("sizeBytes") or 0)
                for nm in img.get("names") or []:
                    have, _ = self.image_index.setdefault(
                        nm, (np.zeros(n, bool), size)
                    )
                    have[i] = True
        # SelectorSpread zone key: modern label if any node carries it, else
        # the legacy beta key (`selectorspread` zone weighting, k8s 1.20)
        if self.label_index.has_key(C.LABEL_ZONE).any():
            self.zone_key = C.LABEL_ZONE
        elif self.label_index.has_key(C.LABEL_ZONE_BETA).any():
            self.zone_key = C.LABEL_ZONE_BETA
        else:
            self.zone_key = None

        # topology keys/domains and the term universe grow lazily
        self.topo_keys = Interner()
        self.domains = Interner()  # (key, value) pairs
        self._node_dom_rows: List[np.ndarray] = []  # [K][N]
        self._node_dom_small_rows: List[np.ndarray] = []  # [K][N] compact ids
        self._key_kinds: List[int] = []  # [K] reduction route per key
        self.term_interner = Interner()
        self.terms: List[Term] = []
        self._term_topo: List[int] = []
        # inverted term-selector index for s_match refresh: matchLabels-only
        # selectors register under ONE (key, value) pair, so a group's
        # candidate terms come from its own label pairs instead of a G×T scan
        self._term_sel_index: Dict[Tuple[str, str], List[int]] = {}
        self._term_general: List[int] = []  # terms needing full evaluation

        self.groups: List[PodGroup] = []
        self._group_ids: Dict[str, int] = {}
        self._smatch_done: List[int] = []  # per-group s_match term watermark
        self._static_mask = _RowTable(n, bool)
        self._vol_mask = _RowTable(n, bool, fill=True)
        self._node_pref = _RowTable(n, np.float32)
        self._taint_intol = _RowTable(n, np.float32)
        self._static_score = _RowTable(n, np.float32)
        self._avoid_pen = _RowTable(n, np.float32)
        # group×term incidence, grown row-wise (lists of dict[t]=val)
        self._s_match: List[Dict[int, bool]] = []
        self._a_aff: List[Dict[int, bool]] = []
        self._a_anti: List[Dict[int, bool]] = []
        self._w_aff: List[Dict[int, float]] = []
        self._w_anti: List[Dict[int, float]] = []
        self._spread_hard: List[Dict[int, float]] = []
        self._spread_soft: List[Dict[int, float]] = []
        self._ss_host: List[Dict[int, bool]] = []
        self._ss_zone: List[Dict[int, bool]] = []
        # host-port vocabulary ((protocol, port) pairs) and group rows
        self.ports = Interner()
        self._port_rows: List[Dict[int, bool]] = []
        # shared volume-identity vocabulary: VolumeRestrictions conflict keys
        # and NodeVolumeLimits attachable volumes intern into the same axis so
        # per-node presence (`vols_any`) counts each volume once
        self.vols = Interner()
        self._vol_rw_rows: List[Dict[int, bool]] = []
        self._vol_ro_rows: List[Dict[int, bool]] = []
        self._vol_att_rows: List[Dict[int, bool]] = []
        self._vol_class: Dict[int, int] = {}  # vol index → attach class
        # attach-limit class axis: the static in-tree classes plus one class
        # per CSI driver seen in a bound PV (csi.go per-driver limit keys);
        # CSI defaults to no limit — upstream enforces only a published limit
        self.attach_classes: List[tuple] = list(ATTACH_CLASSES)
        self._csi_class: Dict[str, int] = {}  # driver → class index
        # content fingerprint for the freeze() memo: every mutation today
        # grows a vocabulary (already part of the cache key), but any FUTURE
        # mutator that edits array contents in place (node allocatable, a
        # group row) MUST bump this counter or freeze() returns stale tensors
        self._content_version = 0

    # -- topology ----------------------------------------------------------

    def _intern_topo_key(self, key: str) -> int:
        k = self.topo_keys.get(key)
        if k >= 0:
            return k
        k = self.topo_keys.intern(key)
        li = self.label_index
        vid = li._vid.get(key)
        n = len(self.nodes)
        if vid is None:
            row = np.full(n, -1, np.int32)
            small = np.full(n, -1, np.int32)
            kind = 1  # vacuous small key: no domains at all
        else:
            # domain id per label-value id, then one vectorized gather (a
            # 100k-node Python loop per new topology key was measurable);
            # vid -1 (key absent) indexes the -1 sentinel slot
            vmap = li._vmap[key]
            dom_of = np.empty(len(vmap) + 1, np.int32)
            dom_of[-1] = -1
            for v, j in vmap.items():
                dom_of[j] = self.domains.intern((key, v))
            row = dom_of[vid]
            # same-domain reduction routing: the per-key value ids are
            # already compact [0, n_vals)
            if len(vmap) <= DOM_SMALL:
                kind, small = 1, vid.astype(np.int32)
            elif vid.max(initial=-1) >= 0 and np.all(
                np.bincount(vid[vid >= 0]) <= 1
            ):
                kind, small = 2, np.full(n, -1, np.int32)  # unique per node
            else:
                kind, small = 0, np.full(n, -1, np.int32)  # scatter fallback
        self._node_dom_rows.append(row)
        self._node_dom_small_rows.append(small)
        self._key_kinds.append(kind)
        return k

    def _intern_term(self, term: Term) -> int:
        t = self.term_interner.get(term)
        if t >= 0:
            return t
        t = self.term_interner.intern(term)
        self.terms.append(term)
        self._term_topo.append(self._intern_topo_key(term.topology_key))
        # register for the s_match candidate index: a matchLabels-only
        # selector is findable through any one of its pairs; everything else
        # (matchExpressions, empty selector) is evaluated for every group.
        # A nil selector never matches and registers nowhere.
        sel = term.selector
        ml = (sel or {}).get("matchLabels") if isinstance(sel, dict) else None
        me = (sel or {}).get("matchExpressions") if isinstance(sel, dict) else None
        if sel is not None:
            if ml and not me:
                k_, v_ = min(ml.items())
                self._term_sel_index.setdefault((k_, str(v_)), []).append(t)
            else:
                self._term_general.append(t)
        return t

    # -- groups ------------------------------------------------------------

    def _static_mask_for(self, g: PodGroup) -> np.ndarray:
        """Stateless filters vectorized over nodes: taints (NoSchedule/
        NoExecute + unschedulable), nodeSelector, required node affinity."""
        li = self.label_index
        mask = np.ones(li.n, bool)
        # TaintToleration + NodeUnschedulable: evaluate tolerations once per
        # distinct taint, fan out through the node-incidence matrix
        for t, taint in enumerate(self._hard_taints):
            if not any(toleration_tolerates_taint(tol, taint) for tol in g.tolerations):
                mask &= ~self._hard_taint_incid[t]
        # nodeSelector: every kv must be a node label
        for k, v in (g.node_selector or {}).items():
            mask &= li.has_kv(k, "" if v is None else str(v))
        # required node affinity: OR over terms
        if g.affinity_required is not None:
            terms = g.affinity_required.get("nodeSelectorTerms") or []
            any_term = np.zeros(li.n, bool)
            for term in terms:
                any_term |= li.match_term(term)
            mask &= any_term
        return mask

    # Zone/region label keys VolumeZone checks on bound PVs
    # (`plugins/volumezone/volume_zone.go` volumeZoneLabels); values are
    # "__"-joined sets (volumehelpers.LabelZonesToSet).
    _PV_TOPO_KEYS = (
        C.LABEL_ZONE_BETA,
        "failure-domain.beta.kubernetes.io/region",
        C.LABEL_ZONE,
        "topology.kubernetes.io/region",
    )

    def _pv_node_mask(self, pv: dict) -> np.ndarray:
        """Nodes a PV is reachable from: its nodeAffinity.required
        (volume_binding.go Filter → PVAssumeCache) AND its zone/region
        topology labels (volume_zone.go Filter). Cached per PV name."""
        cached = self._pv_mask_cache.get(name_of(pv))
        if cached is not None:
            return cached
        li = self.label_index
        mask = np.ones(li.n, bool)
        node_aff = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
        if node_aff:
            any_term = np.zeros(li.n, bool)
            for term in node_aff.get("nodeSelectorTerms") or []:
                any_term |= li.match_term(term)
            mask &= any_term
        for key, raw in (labels_of(pv) or {}).items():
            if key not in self._PV_TOPO_KEYS:
                continue
            allowed = set(str(raw).split("__"))
            ok = np.zeros(li.n, bool)
            for zone in allowed:
                ok |= li.has_kv(key, zone)
            mask &= ok
        self._pv_mask_cache[name_of(pv)] = mask
        return mask

    def _volume_mask_for(self, g: PodGroup) -> Optional[np.ndarray]:
        """VolumeBinding + VolumeZone feasibility over nodes.
        Returns None (= unconstrained, the row table's all-True fill) for
        groups referencing no claims — the overwhelmingly common case.

        Mirrors `plugins/volumebinding/volume_binding.go` PreFilter/Filter and
        `plugins/volumezone/volume_zone.go`:
        - a referenced PVC that does not exist → unschedulable everywhere;
        - a bound PVC restricts nodes to the PV's nodeAffinity and zone/region
          topology labels;
        - an unbound PVC with a StorageClass needs the class to exist
          (dynamic provisioning is then assumed feasible on any node, both
          binding modes);
        - an unbound PVC without a StorageClass is statically provisioned:
          some unclaimed PV of sufficient capacity must exist, and the pod is
          restricted to nodes reachable by at least one such PV (the
          FindPodVolumes static-binding pass, approximated without
          access-mode matching);
        - claims of the Open-Local / yoda storage classes are excluded — they
          are scheduled by the storage kernels (`kernels/storage.py`) from the
          pod's local-storage annotation instead.
        """
        if not g.pvc_refs:
            return None
        li = self.label_index
        mask = np.ones(li.n, bool)
        open_local = set(C.SC_LVM) | set(C.SC_DEVICE_SSD) | set(C.SC_DEVICE_HDD)
        for claim in g.pvc_refs:
            pvc = self.claim_map.get((g.namespace, claim))
            if pvc is None:
                return np.zeros(li.n, bool)
            spec = pvc.get("spec") or {}
            sc_name = spec.get("storageClassName") or ""
            if sc_name in open_local:
                continue
            pv_name = spec.get("volumeName") or ""
            if pv_name:
                pv = self.pv_map.get(pv_name)
                if pv is None:
                    continue  # bound to a PV we weren't given: no constraint
                mask &= self._pv_node_mask(pv)
                continue
            # unbound: upstream findMatchingVolume takes a PV pre-bound to
            # this very claim first — claimRef naming the claim wins
            # regardless of class/capacity (IsVolumeBoundToClaim requires
            # exact namespace+name equality; an empty claimRef namespace
            # never matches)
            prebound = np.zeros(li.n, bool)
            has_prebound = False
            for pv in self.pv_map.values():
                ref = (pv.get("spec") or {}).get("claimRef") or {}
                if ref.get("name") == claim and ref.get("namespace") == g.namespace:
                    has_prebound = True
                    prebound |= self._pv_node_mask(pv)
            if has_prebound:
                mask &= prebound
            elif sc_name:
                if sc_name not in self.catalog:
                    # unbound, named class doesn't exist →
                    # UnschedulableAndUnresolvable
                    return np.zeros(li.n, bool)
            else:
                # static provisioning: any unclaimed classless PV with
                # enough capacity
                want = parse_quantity(
                    ((spec.get("resources") or {}).get("requests") or {}).get(
                        "storage", 0
                    )
                )
                candidates = np.zeros(li.n, bool)
                for pv in self.pv_map.values():
                    pv_spec = pv.get("spec") or {}
                    # class equality: a classless claim binds classless PVs only
                    if pv_spec.get("claimRef") or pv_spec.get("storageClassName"):
                        continue
                    cap = parse_quantity(
                        (pv_spec.get("capacity") or {}).get("storage", 0)
                    )
                    if cap >= want:
                        candidates |= self._pv_node_mask(pv)
                mask &= candidates
        return mask

    def _node_pref_for(self, g: PodGroup) -> Optional[np.ndarray]:
        """NodeAffinity preferred raw score (sum of matching term weights),
        mirroring `plugins/nodeaffinity` Score. None = all-zero."""
        if not g.affinity_preferred:
            return None
        score = np.zeros(self.label_index.n, np.float32)
        for item in g.affinity_preferred:
            w = float(item.get("weight", 0))
            pref = item.get("preference") or {}
            score += w * self.label_index.match_term(pref).astype(np.float32)
        return score

    def _taint_intol_for(self, g: PodGroup) -> Optional[np.ndarray]:
        """Count of PreferNoSchedule taints the group does not tolerate
        (`plugins/tainttoleration` Score). None = all-zero (no
        PreferNoSchedule taints in the cluster, or all tolerated)."""
        out = None
        for t, taint in enumerate(self._pref_taints):
            if not any(toleration_tolerates_taint(tol, taint) for tol in g.tolerations):
                if out is None:
                    out = np.zeros(self.label_index.n, np.float32)
                out += self._pref_taint_incid[t]
        return out

    # ImageLocality thresholds (`plugins/imagelocality/image_locality.go`)
    _IMG_MIN = 23 * 1024 * 1024
    _IMG_MAX = 1000 * 1024 * 1024

    def _static_score_for(self, g: PodGroup) -> Optional[np.ndarray]:
        """ImageLocality score, which depends only on (group, node specs)
        (`plugins/imagelocality/image_locality.go`; no NormalizeScore).
        None = all-zero (no group image resides on any node — sub-threshold
        sums score 0 anyway)."""
        n = self.label_index.n
        imgs = [im for im in set(g.images) if im in self.image_index]
        if not imgs or not n:
            return None
        # sum of node-resident image sizes scaled by spread
        sum_scores = np.zeros(n, np.float64)
        for img in imgs:
            have, size = self.image_index[img]
            spread = have.sum() / n
            sum_scores += np.where(have, size * spread, 0.0)
        img_score = np.clip(
            (sum_scores - self._IMG_MIN) * 100.0 / (self._IMG_MAX - self._IMG_MIN),
            0.0,
            100.0,
        )
        img_score[sum_scores < self._IMG_MIN] = 0.0
        return img_score.astype(np.float32)

    def _avoid_penalty_for(self, g: PodGroup) -> Optional[np.ndarray]:
        """NodePreferAvoidPods for RC/RS-owned pods: upstream adds
        weight·score = 10000·100 on non-avoid nodes and 0 on avoid nodes.
        Adding ~1e6 uniformly would erase sub-0.0625 deltas from the other
        plugins in float32, so keep the argmax-equivalent penalty form:
        0 baseline, -1e6 only on avoid-annotated nodes. None = all-zero."""
        if g.owner_kind in (C.KIND_RC, C.KIND_RS) and self.prefer_avoid.any():
            return -10000.0 * 100.0 * self.prefer_avoid.astype(np.float32)
        return None

    def _spread_selectors_for(self, g: PodGroup) -> List[dict]:
        """LabelSelectors the SelectorSpread score counts against: services
        selecting the group's pods, plus the controller's selector for
        RC/RS/STS-owned pods (`plugins/selectorspread/selector_spread.go`).
        Expanded pods inherit their owner's template labels verbatim
        (`workloads/expand.py`), so the full label set stands in for the
        owner's selector."""
        sels: List[dict] = []
        if g.owner_kind in (C.KIND_RC, C.KIND_RS, C.KIND_STS):
            if g.labels:
                sels.append({"matchLabels": dict(g.labels)})
        for svc in self.services:
            if namespace_of(svc) != g.namespace:
                continue
            raw = ((svc.get("spec") or {}).get("selector")) or {}
            if not raw:
                continue
            if all(g.labels.get(k) == str(v) for k, v in raw.items()):
                sels.append({"matchLabels": {k: str(v) for k, v in raw.items()}})
        return sels

    def _intern_group(self, g: PodGroup) -> int:
        sig = g.signature()
        gid = self._group_ids.get(sig)
        if gid is not None:
            return gid
        gid = len(self.groups)
        self._group_ids[sig] = gid
        self.groups.append(g)
        self._static_mask.append(self._static_mask_for(g))
        self._vol_mask.append(self._volume_mask_for(g))
        self._node_pref.append(self._node_pref_for(g))
        self._taint_intol.append(self._taint_intol_for(g))
        self._static_score.append(self._static_score_for(g))
        self._avoid_pen.append(self._avoid_penalty_for(g))

        # NodePorts: intern the group's (protocol, port) pairs
        prow: Dict[int, bool] = {}
        for pair in g.host_ports:
            prow[self.ports.intern(pair)] = True
        self._port_rows.append(prow)

        # VolumeRestrictions: intern the group's exclusive volume keys
        vrw: Dict[int, bool] = {}
        vro: Dict[int, bool] = {}
        for key in g.vol_rw:
            vrw[self.vols.intern(key)] = True
        for key in g.vol_ro:
            vro[self.vols.intern(key)] = True
        self._vol_rw_rows.append(vrw)
        self._vol_ro_rows.append(vro)

        # NodeVolumeLimits: attachable volumes, inline + resolved through
        # bound PVCs (`plugins/nodevolumelimits/non_csi.go`
        # filterAttachableVolumes); presence-per-node makes the count unique
        # per node like upstream, not per pod
        vatt: Dict[int, bool] = {}
        att_pairs = list(g.vol_att)
        for claim in g.pvc_refs:
            pvc = self.claim_map.get((g.namespace, claim))
            if pvc is None:
                continue
            pv = self.pv_map.get((pvc.get("spec") or {}).get("volumeName") or "")
            if pv is None:
                continue
            pair = pv_attachable_source(pv)
            if pair is not None:
                att_pairs.append(pair)
                continue
            csi = pv_csi_source(pv)
            if csi is not None:
                key, driver = csi
                cls = self._csi_class.get(driver)
                if cls is None:
                    cls = len(self.attach_classes)
                    self.attach_classes.append(
                        (csi_attach_limit_key(driver), np.inf)
                    )
                    self._csi_class[driver] = cls
                att_pairs.append((key, cls))
        for key, cls in set(att_pairs):
            w = self.vols.intern(key)
            vatt[w] = True
            self._vol_class[w] = cls
        self._vol_att_rows.append(vatt)

        # PodTopologySpread: one term per constraint; stricter maxSkew wins
        # on (key, selector) collisions
        sp_hard: Dict[int, float] = {}
        sp_soft: Dict[int, float] = {}
        for raw in g.topology_spread:
            c = json.loads(raw)
            term = Term(
                topology_key=c.get("topologyKey", ""),
                namespaces=(g.namespace,),
                selector_json=_canon(c.get("labelSelector")),
            )
            t = self._intern_term(term)
            if c.get("whenUnsatisfiable", "DoNotSchedule") == "DoNotSchedule":
                skew = float(c.get("maxSkew", 1))
                sp_hard[t] = min(sp_hard.get(t, np.inf), skew)
            else:
                sp_soft[t] = sp_soft.get(t, 0.0) + 1.0
        self._spread_hard.append(sp_hard)
        self._spread_soft.append(sp_soft)

        # SelectorSpread: hostname + zone counting terms per spread selector
        ssh: Dict[int, bool] = {}
        ssz: Dict[int, bool] = {}
        for sel in self._spread_selectors_for(g):
            sel_json = _canon(sel)
            ssh[
                self._intern_term(
                    Term(C.LABEL_HOSTNAME, (g.namespace,), sel_json)
                )
            ] = True
            if self.zone_key is not None:
                ssz[
                    self._intern_term(
                        Term(self.zone_key, (g.namespace,), sel_json)
                    )
                ] = True
        self._ss_host.append(ssh)
        self._ss_zone.append(ssz)

        s_match: Dict[int, bool] = {}
        a_aff: Dict[int, bool] = {}
        a_anti: Dict[int, bool] = {}
        w_aff: Dict[int, float] = {}
        w_anti: Dict[int, float] = {}
        pa, paa = g.pod_affinity, g.pod_anti_affinity
        for term, _ in _terms_of(
            pa.get("requiredDuringSchedulingIgnoredDuringExecution"), g.namespace
        ):
            a_aff[self._intern_term(term)] = True
        for term, _ in _terms_of(
            paa.get("requiredDuringSchedulingIgnoredDuringExecution"), g.namespace
        ):
            a_anti[self._intern_term(term)] = True
        for term, w in _terms_of(
            pa.get("preferredDuringSchedulingIgnoredDuringExecution"), g.namespace
        ):
            t = self._intern_term(term)
            w_aff[t] = w_aff.get(t, 0.0) + w
        for term, w in _terms_of(
            paa.get("preferredDuringSchedulingIgnoredDuringExecution"), g.namespace
        ):
            t = self._intern_term(term)
            w_anti[t] = w_anti.get(t, 0.0) + w
        self._s_match.append(s_match)
        self._a_aff.append(a_aff)
        self._a_anti.append(a_anti)
        self._w_aff.append(w_aff)
        self._w_anti.append(w_anti)
        return gid

    def _attach_limits(self) -> np.ndarray:
        """[N, C] per-node attach limits: the published `attachable-volumes-*`
        allocatable, or the in-tree default when the key is absent (a
        published 0 stays 0 — upstream only falls back when unset).
        Columns are cached per class count: classes only append (new CSI
        drivers), and re-walking 100k parsed allocatable maps per freeze was
        measurable."""
        c_n = len(self.attach_classes)
        cached = getattr(self, "_attach_cache", None)
        if cached is not None and cached.shape[1] == c_n:
            return cached
        start = 0 if cached is None else cached.shape[1]
        out = np.zeros((len(self.nodes), c_n), np.float32)
        if cached is not None:
            out[:, :start] = cached
        for c in range(start, c_n):
            res, default = self.attach_classes[c]
            col = out[:, c]
            for i, am in enumerate(self._alloc_maps):
                col[i] = am.get(res, default)
        self._attach_cache = out
        return out

    def _refresh_s_match(self) -> None:
        """(Re)evaluate group-labels × term-selector incidence.

        Done once per batch build so terms interned by later apps see earlier
        groups too. Each group carries a watermark (terms already evaluated —
        the interners only append), only True entries are stored (readers
        .get() with a falsy default, and freeze()'s dense pass walks stored
        items), and candidates come from the inverted selector index rather
        than a full G×T scan (each candidate still gets its own
        match_label_selector call; only the selector parse is shared).
        """
        t_n = len(self.terms)
        while len(self._smatch_done) < len(self.groups):
            self._smatch_done.append(0)
        general = self._term_general
        idx = self._term_sel_index
        for gid, g in enumerate(self.groups):
            start = self._smatch_done[gid]
            if start >= t_n:
                continue
            labels, ns = g.labels, g.namespace
            # candidate terms: the general pool plus every indexed term
            # reachable through one of the group's own label pairs (the
            # index key is a necessary condition for a matchLabels match)
            cands = [t for t in general if t >= start]
            for k, v in labels.items():
                lst = idx.get((k, str(v)))
                if lst:
                    cands.extend(t for t in lst if t >= start)
            if not cands:
                self._smatch_done[gid] = t_n
                continue
            row = self._s_match[gid]
            for t in set(cands):
                term = self.terms[t]
                sel = term.selector
                if (
                    ns in term.namespaces
                    and sel is not None
                    and match_label_selector(sel, labels)
                ):
                    row[t] = True
            self._smatch_done[gid] = t_n

    # -- append-only node growth (warm-engine serving, ISSUE 20) -----------

    def add_clone_nodes(self, new_nodes: Sequence[dict]) -> None:
        """Append template-clone nodes to the node axis in place.

        The node-side arrays are "fixed at construction" above — this is the
        ONE sanctioned mutation, and it must leave the tensorizer
        indistinguishable from a from-scratch `Tensorizer(all_nodes)` fed the
        same pod sequence (modulo global domain-id numbering, which every
        consumer treats as opaque): the serve capacity fast path and the
        replay autoscaler grow a warm engine's node axis through it
        (`Engine.grow_nodes`) instead of re-tensorizing the cluster.

        Raises `GrowRefused` — without mutating any state — when the
        extension would change something the interned vocabularies already
        depend on: the SelectorSpread zone key, a topology key's same-domain
        reduction route (`key_kind`), or an extended-storage plane width.
        Callers fall back to a full re-tensorize; the refusal is a
        correctness guard, never an error.
        """
        new_nodes = list(new_nodes)
        if not new_nodes:
            return
        nodes = self.nodes + new_nodes
        n = len(nodes)
        li = NodeLabelIndex(nodes)

        # -- pass 1: validation only (no mutation before any refusal) ------
        if li.has_key(C.LABEL_ZONE).any():
            zone_key = C.LABEL_ZONE
        elif li.has_key(C.LABEL_ZONE_BETA).any():
            zone_key = C.LABEL_ZONE_BETA
        else:
            zone_key = None
        if zone_key != self.zone_key and any(
            self._ss_host[g] or self._ss_zone[g] for g in range(len(self.groups))
        ):
            # a from-scratch tensorize would have interned the spread
            # selectors' zone terms under the recomputed key
            raise GrowRefused(
                "SelectorSpread zone key would flip with the new nodes"
            )
        kinds = []
        for key in self.topo_keys.items():
            key = str(key)
            vid = li._vid.get(key)
            if vid is None:
                kinds.append(1)
                continue
            vmap = li._vmap[key]
            if len(vmap) <= DOM_SMALL:
                kinds.append(1)
            elif vid.max(initial=-1) >= 0 and np.all(
                np.bincount(vid[vid >= 0]) <= 1
            ):
                kinds.append(2)
            else:
                kinds.append(0)
        for k, kind in enumerate(kinds):
            if kind != self._key_kinds[k]:
                raise GrowRefused(
                    f"topology key {self.topo_keys.items()[k]!r} would "
                    f"change reduction route ({self._key_kinds[k]} -> {kind})"
                )
        from .extended import NodeStorage

        for node in new_nodes:
            s = NodeStorage.from_node(node)
            if s:
                if len(s.vgs) > self.ext.vg_cap.shape[1]:
                    raise GrowRefused("new node widens the VG plane")
                if len(s.devices) > self.ext.sdev_cap.shape[1]:
                    raise GrowRefused("new node widens the device plane")
            cap = ((node.get("status") or {}).get("capacity")) or {}
            if int(parse_quantity(cap.get(C.RES_GPU_COUNT))) > (
                self.ext.gpu_dev_total.shape[1]
            ):
                raise GrowRefused("new node widens the GPU device plane")

        # -- pass 2: extend ------------------------------------------------
        self.nodes = nodes
        self.label_index = li
        self.zone_key = zone_key
        for i, node in enumerate(new_nodes):
            self.node_idx[name_of(node)] = len(self.node_idx)
            self._alloc_maps.append(node_allocatable(node))
            for rname in self._alloc_maps[-1]:
                self.resources.intern(rname)
        r = len(self.resources)
        alloc = np.zeros((n, r), np.float32)
        alloc[: self.alloc.shape[0], : self.alloc.shape[1]] = self.alloc
        for i in range(len(self.nodes) - len(new_nodes), n):
            for rname, val in self._alloc_maps[i].items():
                alloc[i, self.resources.intern(rname)] = val
        self.alloc = alloc

        # extended storage/GPU planes: re-run over all nodes (interner is
        # idempotent, widths pinned equal by pass 1)
        self.ext = tensorize_node_storage(self.nodes, self.vg_names)

        # distinct-taint machinery: rebuild from scratch over all nodes —
        # first-seen node order keeps the old distinct-taint prefix stable
        for node in new_nodes:
            taints = list(node_taints(node))
            if node_unschedulable(node):
                taints = taints + [_UNSCHEDULABLE_TAINT]
            self.taints.append(taints)
        self._hard_taints = []
        self._pref_taints = []
        hard_ids: Dict[str, int] = {}
        pref_ids: Dict[str, int] = {}
        hard_rows: List[np.ndarray] = []
        pref_rows: List[np.ndarray] = []
        for i, taints in enumerate(self.taints):
            for taint in taints:
                effect = taint.get("effect")
                if effect in ("NoSchedule", "NoExecute"):
                    ids, rows, bucket = hard_ids, hard_rows, self._hard_taints
                elif effect == "PreferNoSchedule":
                    ids, rows, bucket = pref_ids, pref_rows, self._pref_taints
                else:
                    continue
                key = _canon(taint)
                t = ids.get(key)
                if t is None:
                    t = ids[key] = len(bucket)
                    bucket.append(taint)
                    rows.append(np.zeros(n, bool))
                rows[t][i] = True
        self._hard_taint_incid = (
            np.stack(hard_rows) if hard_rows else np.zeros((0, n), bool)
        )
        self._pref_taint_incid = (
            np.stack(pref_rows) if pref_rows else np.zeros((0, n), bool)
        )

        self.prefer_avoid = np.array(
            [node_prefer_avoid_pods(nd) for nd in self.nodes], bool
        )
        self.image_index = {}
        for i, node in enumerate(self.nodes):
            for img in node_images(node):
                size = float(img.get("sizeBytes") or 0)
                for nm in img.get("names") or []:
                    have, _ = self.image_index.setdefault(
                        nm, (np.zeros(n, bool), size)
                    )
                    have[i] = True

        # topology rows: recompute over all nodes. `vmap.items()` follows
        # first-seen node order, so old domain values re-intern to their
        # existing ids and only genuinely new values append (the numbering
        # still differs from from-scratch across MULTIPLE keys — by-key
        # instead of by-pod-sequence — which is fine: domain ids are opaque
        # scatter indices, and the grow carry is dense [T, N], never [Rt, D])
        self._node_dom_rows = []
        self._node_dom_small_rows = []
        for k, key in enumerate(self.topo_keys.items()):
            key = str(key)
            vid = li._vid.get(key)
            if vid is None:
                row = np.full(n, -1, np.int32)
                small = np.full(n, -1, np.int32)
            else:
                vmap = li._vmap[key]
                dom_of = np.empty(len(vmap) + 1, np.int32)
                dom_of[-1] = -1
                for v, j in vmap.items():
                    dom_of[j] = self.domains.intern((key, v))
                row = dom_of[vid]
                if kinds[k] == 1 and len(vmap):
                    small = vid.astype(np.int32)
                else:
                    small = np.full(n, -1, np.int32)
            self._node_dom_rows.append(row)
            self._node_dom_small_rows.append(small)
        self._key_kinds = kinds

        # group planes: recompute every row through the stored evaluators —
        # deterministic functions of (group, rebuilt node-side state), so the
        # old-node prefix is unchanged and the result matches from-scratch
        # (ImageLocality's spread fraction legitimately shifts with N for ALL
        # nodes; statics are re-derived from the next freeze() anyway)
        self._pv_mask_cache = {}
        self._static_mask = _RowTable(n, bool)
        self._vol_mask = _RowTable(n, bool, fill=True)
        self._node_pref = _RowTable(n, np.float32)
        self._taint_intol = _RowTable(n, np.float32)
        self._static_score = _RowTable(n, np.float32)
        self._avoid_pen = _RowTable(n, np.float32)
        for g in self.groups:
            self._static_mask.append(self._static_mask_for(g))
            self._vol_mask.append(self._volume_mask_for(g))
            self._node_pref.append(self._node_pref_for(g))
            self._taint_intol.append(self._taint_intol_for(g))
            self._static_score.append(self._static_score_for(g))
            self._avoid_pen.append(self._avoid_penalty_for(g))

        self._attach_cache = None
        self._content_version += 1

    # -- batches -----------------------------------------------------------

    @staticmethod
    def _pod_identity_key(pod: dict):
        """Identity-based key over every nested structure `_group_of_pod`,
        `pod_requests` and `pod_extended_demand` read, plus the scalar value
        fields. Shared by run detection (adjacent compare, together with
        labels/annotations dict equality) and `_pod_fingerprint` — a field
        added to one but not the other would silently mis-collapse runs.

        Workload expansion clones replicas from one normalized prototype
        (`workloads/expand.py` _clone_pod), so replicas *share* their nested
        spec objects — id() equality over those lets a batch of identical
        pods tensorize once. ids are stable for the duration of the call
        (the pods list keeps everything alive).
        """
        spec = pod.get("spec") or {}
        meta = pod.get("metadata") or {}
        return (
            id(spec.get("containers")),
            id(spec.get("initContainers")),
            id(spec.get("affinity")),
            id(spec.get("tolerations")),
            id(spec.get("nodeSelector")),
            id(spec.get("topologySpreadConstraints")),
            id(spec.get("volumes")),
            id(spec.get("overhead")),
            id(meta.get("ownerReferences")),
            meta.get("namespace") or "",
            spec.get("nodeName") or "",
        )

    @classmethod
    def _pod_fingerprint(cls, pod: dict):
        """The identity key plus order-insensitive label/annotation values —
        the cache key deduping non-adjacent identical pods."""
        meta = pod.get("metadata") or {}
        return cls._pod_identity_key(pod) + (
            tuple(sorted((meta.get("labels") or {}).items())),
            tuple(sorted((meta.get("annotations") or {}).items())),
        )

    def add_pods(self, pods: Sequence[dict]) -> PodBatch:
        """Intern a batch of pods, growing group/term vocabularies.

        Replica runs collapse: workload expansion clones replicas from one
        normalized prototype (`workloads/expand.py` _clone_pod), so
        consecutive replicas share their nested spec objects. Pass 1 detects
        run boundaries with identity/equality compares only; everything
        per-spec (grouping, requests, extended demand) then runs once per RUN
        and broadcasts over the run's slice — at million-pod batches the old
        per-pod path was the single largest host cost.
        """
        p = len(pods)
        group = np.zeros(p, np.int32)
        pin = np.full(p, -1, np.int32)
        forced = np.zeros(p, bool)

        # -- pass 1: adjacent-run detection (no hashing of value fields) ----
        starts: List[int] = []
        prev_key: object = None
        prev_labels = prev_annos = None
        identity_key = self._pod_identity_key
        for i, pod in enumerate(pods):
            meta = pod.get("metadata") or {}
            key = identity_key(pod)
            labels = meta.get("labels") or {}
            annos = meta.get("annotations") or {}
            if (
                not starts
                or key != prev_key
                or labels != prev_labels
                or annos != prev_annos
            ):
                starts.append(i)
                prev_key, prev_labels, prev_annos = key, labels, annos
        stops = starts[1:] + [p]

        # -- pass 2: one grouping/request/demand evaluation per run ---------
        # (the fingerprint cache still dedupes non-adjacent repeats)
        run_info: List[tuple] = []  # (start, stop, req_dict, demand)
        cache = {}
        for start, stop in zip(starts, stops):
            pod = pods[start]
            fp = self._pod_fingerprint(pod)
            hit = cache.get(fp)
            if hit is None:
                g, pin_name = _group_of_pod(pod)
                gid = self._intern_group(g)
                pin_v, forced_v = -1, False
                node_name = pod_node_name(pod)
                if node_name:
                    pin_v = self.node_idx.get(node_name, -1)
                    forced_v = True
                elif pin_name is not None:
                    # -2 = pinned to a node that does not exist →
                    # unschedulable everywhere (the NodeAffinity filter
                    # would match no node)
                    pin_v = self.node_idx.get(pin_name, -2)
                hit = (
                    gid,
                    pin_v,
                    forced_v,
                    pod_requests(pod),
                    pod_extended_demand(pod, self.catalog, self.vg_names),
                )
                cache[fp] = hit
            gid, pin_v, forced_v, r, demand = hit
            group[start:stop] = gid
            pin[start:stop] = pin_v
            forced[start:stop] = forced_v
            run_info.append((start, stop, r, demand))
        self._refresh_s_match()

        # -- request matrix: grow the vocabulary first, then one row per run
        for _, _, r, _ in run_info:
            for rname in r:
                if self.resources.get(rname) < 0:
                    # a resource no node allocates can never fit; grow the
                    # vocabulary so fit fails cleanly
                    self.resources.intern(rname)
                    self.alloc = np.pad(self.alloc, ((0, 0), (0, 1)))
        n_res = len(self.resources)
        req = np.zeros((p, n_res), np.float32)
        if p:
            req[:, RES_PODS] = 1.0
        row = np.zeros(n_res, np.float32)
        for start, stop, r, _ in run_info:
            row[:] = 0.0
            row[RES_PODS] = 1.0
            for rname, val in r.items():
                row[self.resources.get(rname)] = val
            req[start:stop] = row

        # -- extended demand arrays, filled per run ------------------------
        l_max = max([len(d.lvm_sizes) for _, _, _, d in run_info] + [1])
        k_max = max([len(d.dev_sizes) for _, _, _, d in run_info] + [1])
        gd = max(self.ext.gpu_dev_total.shape[1], 1)
        ext = {
            "lvm_size": np.zeros((p, l_max), np.float32),
            "lvm_vg": np.full((p, l_max), -1, np.int32),
            "dev_size": np.zeros((p, k_max), np.float32),
            "dev_media": np.zeros((p, k_max), np.int32),
            "gpu_mem": np.zeros(p, np.float32),
            "gpu_count": np.zeros(p, np.int32),
            "gpu_preset": np.zeros((p, gd), np.float32),
        }
        for start, stop, _, d in run_info:
            if d.lvm_sizes:
                ext["lvm_size"][start:stop, : len(d.lvm_sizes)] = d.lvm_sizes
                ext["lvm_vg"][start:stop, : len(d.lvm_vg_ids)] = d.lvm_vg_ids
            if d.dev_sizes:
                ext["dev_size"][start:stop, : len(d.dev_sizes)] = d.dev_sizes
                ext["dev_media"][start:stop, : len(d.dev_medias)] = d.dev_medias
            if d.gpu_mem:
                ext["gpu_mem"][start:stop] = d.gpu_mem
            if d.gpu_count:
                ext["gpu_count"][start:stop] = d.gpu_count
            for dev_id in d.gpu_preset:
                # device ids beyond the cluster's device table are silently
                # ignored, like the reference's guarded map lookup
                # (`gpunodeinfo.go:108-110`)
                if 0 <= dev_id < gd:
                    ext["gpu_preset"][start:stop, dev_id] += 1.0
        return PodBatch(
            pods=list(pods),
            group=group,
            req=req,
            pin=pin,
            forced=forced,
            ext=ext,
        )

    def freeze(self) -> ClusterTensors:
        """Materialize the dense arrays for the current vocabularies.

        Memoized on the vocabulary sizes: Engine.place freezes per batch,
        and re-stacking the [G, N] planes for an unchanged vocabulary costs
        seconds at 100k nodes (the frozen object also carries the memoized
        statics/compaction caches, so reuse preserves those too). Any growth
        in groups/terms/ports/vols/resources/attach classes — the only
        mutations add_pods can make — changes the key and rebuilds.
        """
        n, g_n, t_n = len(self.nodes), len(self.groups), len(self.terms)
        key = (
            n,
            g_n,
            t_n,
            len(self.ports),
            len(self.vols),
            len(self.resources),
            len(self.attach_classes),
            len(self.domains),
            self._content_version,
        )
        cached = getattr(self, "_freeze_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        def dense(rows: List[Dict[int, float]], dtype) -> np.ndarray:
            out = np.zeros((g_n, t_n), dtype)
            for gi, row in enumerate(rows):
                for t, v in row.items():
                    out[gi, t] = v
            return out

        node_dom = (
            np.stack(self._node_dom_rows) if self._node_dom_rows else np.zeros((0, n), np.int32)
        )
        node_dom_small = (
            np.stack(self._node_dom_small_rows)
            if self._node_dom_small_rows
            else np.zeros((0, n), np.int32)
        )
        key_kind = np.asarray(self._key_kinds, np.int32)
        p_n = len(self.ports)
        ports = np.zeros((g_n, p_n), bool)
        for gi, row in enumerate(self._port_rows):
            for p, v in row.items():
                ports[gi, p] = v
        w_n = len(self.vols)
        vol_rw = np.zeros((g_n, w_n), bool)
        vol_ro = np.zeros((g_n, w_n), bool)
        vol_att = np.zeros((g_n, w_n), bool)
        for gi, row in enumerate(self._vol_rw_rows):
            for w, v in row.items():
                vol_rw[gi, w] = v
        for gi, row in enumerate(self._vol_ro_rows):
            for w, v in row.items():
                vol_ro[gi, w] = v
        for gi, row in enumerate(self._vol_att_rows):
            for w, v in row.items():
                vol_att[gi, w] = v
        vol_class_mask = np.zeros((len(self.attach_classes), w_n), bool)
        for w, cls in self._vol_class.items():
            vol_class_mask[cls, w] = True
        tensors = ClusterTensors(
            node_names=list(self.label_index.names),
            resource_names=[str(r) for r in self.resources.items()],
            alloc=self.alloc.copy(),
            node_dom=node_dom,
            n_domains=max(len(self.domains), 1),
            topo_keys=[str(k) for k in self.topo_keys.items()],
            key_kind=key_kind,
            node_dom_small=node_dom_small,
            groups=list(self.groups),
            static_mask=self._static_mask.view(),
            node_pref_score=self._node_pref.view(),
            taint_intolerable=self._taint_intol.view(),
            static_score=self._static_score.view(),
            avoid_pen=self._avoid_pen.view(),
            terms=list(self.terms),
            term_topo_key=np.asarray(self._term_topo, np.int32),
            s_match=dense(self._s_match, bool),
            a_aff_req=dense(self._a_aff, bool),
            a_anti_req=dense(self._a_anti, bool),
            w_aff_pref=dense(self._w_aff, np.float32),
            w_anti_pref=dense(self._w_anti, np.float32),
            spread_hard=dense(self._spread_hard, np.float32),
            spread_soft=dense(self._spread_soft, np.float32),
            ss_host=dense(self._ss_host, bool),
            ss_zone=dense(self._ss_zone, bool),
            ports=ports,
            n_ports=p_n,
            vol_mask=self._vol_mask.view(),
            vol_rw=vol_rw,
            vol_ro=vol_ro,
            vol_att=vol_att,
            vol_class_mask=vol_class_mask,
            attach_limits=self._attach_limits(),
            n_vols=w_n,
            ext=self.ext,
            label_index=self.label_index,
        )
        self._freeze_cache = (key, tensors)
        return tensors
