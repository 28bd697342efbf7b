"""Lightweight Kubernetes object model.

The reference links the full k8s API type tree (`pkg/simulator/core.go:29-43`
enumerates the 13 resource kinds it ingests). We are not a controller — objects
here are inert simulation inputs — so instead of typed structs we keep each
manifest as its raw dict and provide accessor helpers for the handful of fields
the scheduler semantics read. This keeps ingestion = `yaml.safe_load`, workload
expansion = dict surgery, and leaves the numeric heavy lifting to tensorize.py.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

from .quantity import parse_quantity

# Kind names shared with simtpu.constants (single canonical table there).
from ..constants import (  # noqa: F401
    KIND_CRON_JOB,
    KIND_DEPLOYMENT,
    KIND_DS,
    KIND_JOB,
    KIND_POD,
    KIND_RC,
    KIND_RS,
    KIND_STS,
)

KIND_SERVICE = "Service"
KIND_PVC = "PersistentVolumeClaim"
KIND_PV = "PersistentVolume"
KIND_PDB = "PodDisruptionBudget"
KIND_STORAGE_CLASS = "StorageClass"
KIND_NODE = "Node"

WORKLOAD_KINDS = (
    KIND_DEPLOYMENT,
    KIND_RS,
    KIND_RC,
    KIND_STS,
    KIND_DS,
    KIND_JOB,
    KIND_CRON_JOB,
)


def meta(obj: dict) -> dict:
    """Read-only view of metadata; use ensure_meta() when mutating."""
    return obj.get("metadata") or {}


def ensure_meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def name_of(obj: dict) -> str:
    return meta(obj).get("name", "")


def namespace_of(obj: dict) -> str:
    return meta(obj).get("namespace") or "default"


def labels_of(obj: dict) -> Dict[str, str]:
    return meta(obj).get("labels") or {}


def annotations_of(obj: dict) -> Dict[str, str]:
    return meta(obj).get("annotations") or {}


def set_annotation(obj: dict, key: str, value: str) -> None:
    ensure_meta(obj).setdefault("annotations", {})[key] = value


def set_label(obj: dict, key: str, value: str) -> None:
    ensure_meta(obj).setdefault("labels", {})[key] = value


def nn_key(obj: dict) -> str:
    """namespace/name key used for identity maps."""
    return f"{namespace_of(obj)}/{name_of(obj)}"


def owner_references(obj: dict) -> List[dict]:
    return meta(obj).get("ownerReferences") or []


def deep_copy(obj: dict) -> dict:
    return copy.deepcopy(obj)


def shallow_pod_copy(pod: dict) -> dict:
    """A pod copy isolated exactly where the simulator mutates: top level,
    metadata (+labels/annotations), spec, status. Deep sub-structures
    (containers, volumes, affinity, ...) are shared read-only — at
    million-pod scale `copy.deepcopy` per placed pod (and again per
    `_result()` call) dominated the whole facade."""
    placed = dict(pod)
    meta = dict(pod.get("metadata") or {})
    if "annotations" in meta:
        meta["annotations"] = dict(meta["annotations"])
    if "labels" in meta:
        meta["labels"] = dict(meta["labels"])
    placed["metadata"] = meta
    placed["spec"] = dict(pod.get("spec") or {})
    placed["status"] = dict(pod.get("status") or {})
    return placed


# ---------------------------------------------------------------------------
# Pod helpers
# ---------------------------------------------------------------------------


def pod_spec(pod: dict) -> dict:
    """Read-only view of spec."""
    return pod.get("spec") or {}


def pod_node_name(pod: dict) -> str:
    return pod_spec(pod).get("nodeName") or ""


def pod_containers(pod: dict) -> List[dict]:
    return pod_spec(pod).get("containers") or []


def pod_init_containers(pod: dict) -> List[dict]:
    return pod_spec(pod).get("initContainers") or []


def _container_requests(container: dict) -> Dict[str, float]:
    res = (container.get("resources") or {}).get("requests") or {}
    # limits default requests when requests are absent (k8s defaulting)
    limits = (container.get("resources") or {}).get("limits") or {}
    out = {k: parse_quantity(v) for k, v in limits.items()}
    out.update({k: parse_quantity(v) for k, v in res.items()})
    return out


def pod_requests(pod: dict) -> Dict[str, float]:
    """Aggregate pod resource requests.

    Mirrors k8s resourcehelper.PodRequestsAndLimits (used at
    `pkg/simulator/plugin/simon.go:45`): sum of containers, elementwise max with
    each init container, plus pod overhead.
    """
    totals: Dict[str, float] = {}
    for c in pod_containers(pod):
        for k, v in _container_requests(c).items():
            totals[k] = totals.get(k, 0.0) + v
    for c in pod_init_containers(pod):
        for k, v in _container_requests(c).items():
            if v > totals.get(k, 0.0):
                totals[k] = v
    for k, v in (pod_spec(pod).get("overhead") or {}).items():
        totals[k] = totals.get(k, 0.0) + parse_quantity(v)
    # keep negatives so validation can reject malformed manifests
    return {k: v for k, v in totals.items() if v != 0}


def pod_host_ports(pod: dict) -> List[tuple]:
    """(protocol, hostIP, hostPort) triples, for the NodePorts filter."""
    out = []
    for c in pod_containers(pod):
        for p in c.get("ports") or []:
            hp = p.get("hostPort")
            if hp:
                out.append((p.get("protocol", "TCP"), p.get("hostIP", "0.0.0.0"), int(hp)))
    return out


def pod_topology_spread_constraints(pod: dict) -> List[dict]:
    """topologySpreadConstraints, for the PodTopologySpread plugin."""
    return pod_spec(pod).get("topologySpreadConstraints") or []


def pod_volumes(pod: dict) -> List[dict]:
    return pod_spec(pod).get("volumes") or []


def pod_pvc_names(pod: dict) -> List[str]:
    """Claim names referenced by the pod's volumes (VolumeBinding/VolumeZone
    inputs, `plugins/volumebinding/volume_binding.go` podHasPVCs)."""
    out = []
    for v in pod_volumes(pod):
        pvc = v.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName"):
            out.append(pvc["claimName"])
    return out


# Volume-identity key builders — shared by pod_volume_conflicts
# (VolumeRestrictions) and _attachable_source (NodeVolumeLimits) so one
# interned identity serves both and per-node presence counts each volume once.


def _ebs_key(src: dict) -> str:
    return f"aws:{src['volumeID']}"


def _gce_key(src: dict) -> str:
    return f"gce:{src['pdName']}"


def _azure_key(src: dict) -> str:
    return f"azure:{src['diskName']}"


def _cinder_key(src: dict) -> str:
    return f"cinder:{src['volumeID']}"


def _iscsi_key(src: dict) -> str:
    # upstream conflicts on same IQN *and* same LUN (volume_restrictions.go
    # isVolumeConflict): both participate in the identity
    return f"iscsi:{src.get('iqn', '')}:lun{src.get('lun', 0)}"


def _rbd_key(src: dict) -> str:
    # upstream compares CephMonitors overlap + pool + image; monitor-set
    # equality stands in for overlap (distinct-but-overlapping monitor lists
    # are vanishingly rare in manifests)
    mons = ",".join(sorted(src.get("monitors") or []))
    pool = src.get("pool") or "rbd"
    return f"rbd:{mons}:{pool}/{src.get('image', '')}"


def pod_volume_conflicts(pod: dict) -> tuple:
    """(read_write_keys, read_only_keys) of exclusive volume identities.

    VolumeRestrictions semantics (`plugins/volumerestrictions/
    volume_restrictions.go` isVolumeConflict): two pods on one node may not
    share
    - an AWS EBS volume at all,
    - a GCE PD / ISCSI (IQN+LUN) / RBD (monitors+pool+image) unless both
      mount it read-only.
    A volume in the read_write list excludes any other user of the same key;
    one in the read_only list excludes only read-write users.
    """
    rw, ro = [], []
    for v in pod_volumes(pod):
        src = v.get("awsElasticBlockStore")
        if src and src.get("volumeID"):
            rw.append(_ebs_key(src))  # always-exclusive
            continue
        src = v.get("gcePersistentDisk")
        if src and src.get("pdName"):
            (ro if src.get("readOnly") else rw).append(_gce_key(src))
            continue
        src = v.get("iscsi")
        if src and src.get("iqn"):
            (ro if src.get("readOnly") else rw).append(_iscsi_key(src))
            continue
        src = v.get("rbd")
        if src and src.get("image"):
            (ro if src.get("readOnly") else rw).append(_rbd_key(src))
    return tuple(sorted(set(rw))), tuple(sorted(set(ro) - set(rw)))


#: NodeVolumeLimits classes, in the order of the engine's static attach-limit
#: columns: (allocatable resource name, default limit when unpublished).
#: Defaults mirror the in-tree values (`plugins/nodevolumelimits/non_csi.go`
#: DefaultMaxEBSVolumes / DefaultMaxGCEPDVolumes / DefaultMaxAzureDiskVolumes,
#: `pkg/volume/util/attach_limit.go` DefaultMaxCinderVolumes). CSI classes are
#: per-driver and appended dynamically by the Tensorizer
#: (`plugins/nodevolumelimits/csi.go` — `attachable-volumes-csi-<driver>`).
ATTACH_CLASSES = (
    ("attachable-volumes-aws-ebs", 39.0),
    ("attachable-volumes-gce-pd", 16.0),
    ("attachable-volumes-azure-disk", 16.0),
    ("attachable-volumes-cinder", 256.0),
)


def csi_attach_limit_key(driver: str) -> str:
    """Per-driver CSI limit resource name (`pkg/volume/util/attach_limit.go`
    GetCSIAttachLimitKey: `attachable-volumes-csi-` prefix, driver appended)."""
    return f"attachable-volumes-csi-{driver}"


def _attachable_source(src_holder: dict) -> tuple:
    """(volume-key, class-index) of an inline EBS/GCE/Azure/Cinder source,
    else None.

    Keys are shared with `pod_volume_conflicts` so one interned volume
    identity serves both VolumeRestrictions and NodeVolumeLimits.
    """
    src = src_holder.get("awsElasticBlockStore")
    if src and src.get("volumeID"):
        return _ebs_key(src), 0
    src = src_holder.get("gcePersistentDisk")
    if src and src.get("pdName"):
        return _gce_key(src), 1
    src = src_holder.get("azureDisk")
    if src and src.get("diskName"):
        return _azure_key(src), 2
    src = src_holder.get("cinder")
    if src and src.get("volumeID"):
        return _cinder_key(src), 3
    return None


def pod_attachable_volumes(pod: dict) -> List[tuple]:
    """Inline attachable volumes as unique (key, class-index) pairs
    (NodeVolumeLimits, `plugins/nodevolumelimits/non_csi.go`). PVC-backed
    volumes are resolved by the Tensorizer, which holds the PVC/PV maps."""
    out = []
    for v in pod_volumes(pod):
        pair = _attachable_source(v)
        if pair is not None:
            out.append(pair)
    return sorted(set(out))


def pv_attachable_source(pv: dict) -> tuple:
    """The PV's attachable (key, class-index), or None (non_csi.go
    filterAttachableVolumes resolves PVC → PV → volume source)."""
    return _attachable_source((pv.get("spec") or {}))


def pv_csi_source(pv: dict) -> tuple:
    """The PV's CSI (volume-key, driver-name), or None.

    CSILimits counts only PVC-backed CSI volumes, keyed by driver +
    volumeHandle (`plugins/nodevolumelimits/csi.go` filterAttachableVolumes /
    getCSIDriverInfo); each driver gets its own per-node limit class."""
    src = (pv.get("spec") or {}).get("csi")
    if src and src.get("driver") and src.get("volumeHandle"):
        return f"csi:{src['driver']}:{src['volumeHandle']}", str(src["driver"])
    return None


def pod_owner_kind(pod: dict) -> str:
    """Kind of the pod's controller owner reference ('' when unowned)."""
    for ref in (pod.get("metadata") or {}).get("ownerReferences") or []:
        if ref.get("kind"):
            return str(ref["kind"])
    return ""


def pod_images(pod: dict) -> List[str]:
    """Container image names, for the ImageLocality score."""
    return [c["image"] for c in pod_containers(pod) if c.get("image")]


#: Built-in priority classes (`k8s.io/api/scheduling/v1/types.go`); the
#: reference's ResourceTypes carries no PriorityClass objects
#: (`pkg/simulator/core.go:29-43`), so only these resolve by name.
_BUILTIN_PRIORITY_CLASSES = {
    "system-cluster-critical": 2000000000.0,
    "system-node-critical": 2000001000.0,
}


def pod_priority(pod: dict) -> float:
    """Effective scheduling priority: spec.priority, else the built-in
    priorityClassName value, else 0 (the admission-defaulted globalDefault)."""
    p = pod_spec(pod).get("priority")
    if p is not None:
        return float(p)
    name = pod_spec(pod).get("priorityClassName") or ""
    return _BUILTIN_PRIORITY_CLASSES.get(name, 0.0)


def pod_tolerations(pod: dict) -> List[dict]:
    return pod_spec(pod).get("tolerations") or []


def pod_node_selector(pod: dict) -> Dict[str, str]:
    return pod_spec(pod).get("nodeSelector") or {}


def pod_affinity(pod: dict) -> dict:
    return pod_spec(pod).get("affinity") or {}


# ---------------------------------------------------------------------------
# Node helpers
# ---------------------------------------------------------------------------


def node_allocatable(node: dict) -> Dict[str, float]:
    alloc = ((node.get("status") or {}).get("allocatable")) or {}
    return {k: parse_quantity(v) for k, v in alloc.items()}


def node_taints(node: dict) -> List[dict]:
    return (node.get("spec") or {}).get("taints") or []


def node_unschedulable(node: dict) -> bool:
    return bool((node.get("spec") or {}).get("unschedulable"))


def node_images(node: dict) -> List[dict]:
    """status.images ({names, sizeBytes} entries), for ImageLocality."""
    return (node.get("status") or {}).get("images") or []


#: scheduler.alpha.kubernetes.io/preferAvoidPods — consumed by the
#: NodePreferAvoidPods score plugin (weight 10000 in the default provider).
ANNO_PREFER_AVOID_PODS = "scheduler.alpha.kubernetes.io/preferAvoidPods"


def node_prefer_avoid_pods(node: dict) -> bool:
    """True when the node's preferAvoidPods annotation lists any entry.

    The upstream plugin matches entries against the pod's RC/RS controller
    signature (`plugins/nodepreferavoidpods/node_prefer_avoid_pods.go`); the
    simulation has no UIDs, so any entry avoids all RC/RS-owned pods.
    """
    raw = annotations_of(node).get(ANNO_PREFER_AVOID_PODS)
    if not raw:
        return False
    try:
        parsed = json.loads(raw)
    except (ValueError, TypeError):
        return False
    return bool((parsed or {}).get("preferAvoidPods"))


# ---------------------------------------------------------------------------
# ResourceTypes — the 13-kind container (pkg/simulator/core.go:29-43)
# ---------------------------------------------------------------------------

_KIND_TO_FIELD = {
    KIND_POD: "pods",
    KIND_DEPLOYMENT: "deployments",
    KIND_RS: "replica_sets",
    KIND_RC: "replication_controllers",
    KIND_STS: "stateful_sets",
    KIND_DS: "daemon_sets",
    KIND_JOB: "jobs",
    KIND_CRON_JOB: "cron_jobs",
    KIND_SERVICE: "services",
    KIND_PVC: "persistent_volume_claims",
    KIND_PV: "persistent_volumes",
    KIND_PDB: "pod_disruption_budgets",
    KIND_STORAGE_CLASS: "storage_classes",
    KIND_NODE: "nodes",
}


@dataclass
class ResourceTypes:
    """All simulation inputs, grouped by kind.

    Mirrors `simulator.ResourceTypes` (`pkg/simulator/core.go:29-43`).
    """

    nodes: List[dict] = field(default_factory=list)
    pods: List[dict] = field(default_factory=list)
    deployments: List[dict] = field(default_factory=list)
    replica_sets: List[dict] = field(default_factory=list)
    replication_controllers: List[dict] = field(default_factory=list)
    stateful_sets: List[dict] = field(default_factory=list)
    daemon_sets: List[dict] = field(default_factory=list)
    jobs: List[dict] = field(default_factory=list)
    cron_jobs: List[dict] = field(default_factory=list)
    services: List[dict] = field(default_factory=list)
    persistent_volume_claims: List[dict] = field(default_factory=list)
    persistent_volumes: List[dict] = field(default_factory=list)
    pod_disruption_budgets: List[dict] = field(default_factory=list)
    storage_classes: List[dict] = field(default_factory=list)

    def add(self, obj: dict) -> bool:
        """Type-switch an object into its bucket.

        Mirrors `simulator.GetObjectFromYamlContent`'s decode-and-switch
        (`pkg/simulator/utils.go:139-183`). Returns False for unrecognized kinds
        (the reference errors; callers decide).
        """
        kind = obj.get("kind")
        fld = _KIND_TO_FIELD.get(kind)
        if fld is None:
            return False
        getattr(self, fld).append(obj)
        return True

    def extend(self, other: "ResourceTypes") -> None:
        for fld in _KIND_TO_FIELD.values():
            getattr(self, fld).extend(getattr(other, fld))

    def workloads(self) -> Iterator[dict]:
        for fld in (
            "deployments",
            "replica_sets",
            "replication_controllers",
            "stateful_sets",
            "daemon_sets",
            "jobs",
            "cron_jobs",
        ):
            yield from getattr(self, fld)

    def __iter__(self) -> Iterator[dict]:
        for fld in _KIND_TO_FIELD.values():
            yield from getattr(self, fld)


@dataclass
class AppResource:
    """A named application bundle (`pkg/simulator/core.go:45-48`)."""

    name: str
    resource: ResourceTypes


@dataclass
class UnscheduledPod:
    """A pod the engine could not place, with the failing constraint.

    Mirrors `simulator.UnscheduledPod` (`pkg/simulator/core.go:56-59`), but the
    reason is recovered from the constraint masks (which kernel zeroed the row)
    instead of a PodCondition message.
    """

    pod: dict
    reason: str


@dataclass
class NodeStatus:
    """One node plus the pods placed on it (`pkg/simulator/core.go:105-108`)."""

    node: dict
    pods: List[dict]


@dataclass
class PreemptedPod:
    """A lower-priority pod evicted to make room for a preemptor.

    The reference inherits this behavior from the vendored scheduler's
    DefaultPreemption PostFilter (`vendor/.../plugins/defaultpreemption/`):
    victims are deleted from the fake cluster and never re-queued (they were
    fake-Running, not owned by live controllers), so the simulation surfaces
    them explicitly instead of silently dropping them.
    """

    pod: dict
    preempted_by: str  # "namespace/name" of the preemptor
    node: str  # node the victim was evicted from


@dataclass
class SimulateResult:
    """Result of one simulation (`pkg/simulator/core.go:56-62`)."""

    unscheduled_pods: List[UnscheduledPod]
    node_status: List[NodeStatus]
    preempted_pods: List[PreemptedPod] = field(default_factory=list)
    # independent placement audit (simtpu/audit AuditReport) when the
    # caller asked `simulate(audit=True)`; None = not audited
    audit: object = None
    # decision-observability record (simtpu/explain: failure breakdowns +
    # bottleneck analysis) when the caller asked `simulate(explain=...)`;
    # None = not explained (the zero-cost default)
    explain: object = None
