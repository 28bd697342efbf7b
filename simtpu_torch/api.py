"""Public simulation API of the port: the serial path behind `simulate()`.

The cut-down counterpart of the JAX package's `api.py`: `Simulator` with
`run_cluster` / `schedule_app`, and the one-shot `simulate()`. The engine
runs on `device` (default `cuda`; `device="cpu"` selects the plain
PyTorch path explicitly).

Not in this slice (ROADMAP queue 1): preemption beyond its gate — a failed
pod that preemption could help raises NotImplementedError, every other
failed pod is recorded exactly as the JAX package records it — and pods
that demand Open-Local storage or GPU-share memory (the engine raises).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import constants as C
from .core.objects import (
    AppResource,
    NodeStatus,
    ResourceTypes,
    SimulateResult,
    UnscheduledPod,
    annotations_of,
    deep_copy,
    name_of,
    namespace_of,
    pod_priority,
    set_annotation,
    set_label,
    shallow_pod_copy,
)
from .core.quantity import parse_quantity
from .core.tensorize import Tensorizer
from .device import resolve_device
from .engine.scan import (
    FAIL_ATTACH,
    FAIL_GPU,
    FAIL_INTERPOD,
    FAIL_PORTS,
    FAIL_RESOURCES,
    FAIL_SPREAD,
    FAIL_STORAGE,
    FAIL_VOLUME,
    REASON_TEXT,
    Engine,
)
from .workloads.expand import (
    get_valid_pods_exclude_daemonset,
    make_valid_pods_by_daemonset,
)

# Failure classes where evicting lower-priority pods can help — the analog
# of DefaultPreemption's PostFilter eligibility.
_PREEMPTIBLE_REASONS = {
    FAIL_RESOURCES,
    FAIL_PORTS,
    FAIL_STORAGE,
    FAIL_GPU,
    FAIL_INTERPOD,
    FAIL_SPREAD,
    FAIL_VOLUME,
    FAIL_ATTACH,
}


def _sort_app_pods(pods: List[dict], nodes: Sequence[dict] = (), use_greed: bool = False) -> List[dict]:
    """Stable emulation of the reference's app-pod ordering: AffinityQueue
    (nodeSelector pods first) then TolerationQueue (tolerations pods first);
    with `use_greed`, GreedQueue's DRF dominant-share order first."""
    from .algo import affinity_sort, greed_sort, toleration_sort

    if use_greed:
        pods = greed_sort(pods, nodes)
    return toleration_sort(affinity_sort(pods))


class Simulator:
    """One in-memory cluster simulation on one device."""

    def __init__(
        self,
        extra_resources: Sequence[str] = (),
        use_greed: bool = False,
        sched_config=None,
        device=None,
    ):
        self._extra_resources = extra_resources
        self._use_greed = use_greed
        self._sched_config = sched_config
        self._device = resolve_device(device)
        self._tensorizer: Optional[Tensorizer] = None
        self._engine: Optional[Engine] = None
        self._nodes: List[dict] = []
        self._scheduled: List[dict] = []  # placed pods, nodeName set
        self._placed_prio: List[float] = []  # parallel to the placement log
        self._unscheduled: List[UnscheduledPod] = []

    def run_cluster(self, cluster: ResourceTypes) -> SimulateResult:
        """Install nodes and schedule the cluster's own pods."""
        self._nodes = [deep_copy(n) for n in cluster.nodes]
        self._tensorizer = Tensorizer(
            self._nodes,
            self._extra_resources,
            storage_classes=list(cluster.storage_classes),
            services=list(cluster.services),
            pvcs=list(cluster.persistent_volume_claims),
            pvs=list(cluster.persistent_volumes),
        )
        self._engine = Engine(self._tensorizer, self._device)
        self._engine.sched_config = self._sched_config
        self._schedule_pods(cluster.pods)
        return self._result()

    def schedule_app(self, app: AppResource) -> SimulateResult:
        """Expand one app into pods and schedule them in order (only the
        app's pods enter the simulation, as in the reference)."""
        pods = get_valid_pods_exclude_daemonset(app.resource)
        for ds in app.resource.daemon_sets:
            pods.extend(make_valid_pods_by_daemonset(ds, self._nodes))
        for pod in pods:
            set_label(pod, C.LABEL_APP_NAME, app.name)
        pods = _sort_app_pods(pods, self._nodes, self._use_greed)
        self._schedule_pods(pods)
        return self._result()

    def close(self) -> None:
        self._tensorizer = None
        self._engine = None

    def _record_placed(self, pod: dict, node_idx: int, gpu_shares) -> None:
        self._scheduled.append(
            record_placed_pod(pod, self._nodes[node_idx]["metadata"]["name"], gpu_shares)
        )
        self._placed_prio.append(pod_priority(pod))

    def _record_failed(self, pod: dict, reason: int) -> None:
        msg = REASON_TEXT[int(reason)]
        self._unscheduled.append(
            UnscheduledPod(
                pod=pod,
                reason=(
                    f"failed to schedule pod ({namespace_of(pod)}/{name_of(pod)}): "
                    f"Unschedulable: 0/{len(self._nodes)} nodes are available: {msg}"
                ),
            )
        )

    def _schedule_pods(self, pods: Sequence[dict]) -> None:
        # only default-scheduler pods enter the scheduling path; pods bound
        # via spec.nodeName occupy capacity regardless of schedulerName
        pods = [
            p
            for p in pods
            if (p.get("spec") or {}).get("nodeName")
            or ((p.get("spec") or {}).get("schedulerName") or C.DEFAULT_SCHEDULER_NAME)
            == C.DEFAULT_SCHEDULER_NAME
        ]
        if not pods:
            return
        batch = self._tensorizer.add_pods(pods)
        nodes, reasons, extras = self._engine.place(batch)
        # record every placement FIRST, so the priorities stay parallel to
        # the engine's placement log, then settle the failed pods
        failed = []
        for i, (pod, node_idx, reason) in enumerate(zip(batch.pods, nodes, reasons)):
            if node_idx >= 0:
                self._record_placed(pod, node_idx, extras["gpu_shares"][i])
            else:
                failed.append((pod, int(reason)))
        self._settle_failed(failed)

    def _settle_failed(self, failed) -> None:
        """The preemption gate of the JAX package's `_propose_victims`: a pod
        whose failure preemption cannot help (its reason is not preemptible,
        or no placed pod has a strictly lower priority) is recorded failed.
        A pod that preemption could help raises: preemption is not ported
        yet."""
        prios = np.asarray(self._placed_prio, np.float64)
        for pod, reason in failed:
            if reason in _PREEMPTIBLE_REASONS and len(prios) and np.any(prios < pod_priority(pod)):
                raise NotImplementedError("preemption: ROADMAP queue 1")
            self._record_failed(pod, reason)

    def _result(self) -> SimulateResult:
        by_node = {name_of(n): [] for n in self._nodes}
        for pod in self._scheduled:
            by_node[pod["spec"]["nodeName"]].append(shallow_pod_copy(pod))
        nodes = [deep_copy(n) for n in self._nodes]
        write_extended_annotations(self._tensorizer.ext, self._engine.ext_log, nodes)
        statuses = [NodeStatus(node=n, pods=by_node[name_of(n)]) for n in nodes]
        return SimulateResult(
            unscheduled_pods=list(self._unscheduled),
            node_status=statuses,
            preempted_pods=[],
        )


def record_placed_pod(pod: dict, node_name: str, gpu_shares) -> dict:
    """The placed copy of `pod`: nodeName bound, phase Running, and the GPU
    device-assignment annotation the reference's GpuSharePlugin.Bind
    applies."""
    placed = shallow_pod_copy(pod)
    placed["spec"]["nodeName"] = node_name
    placed.setdefault("status", {})["phase"] = "Running"
    already = annotations_of(placed).get(C.ANNO_POD_GPU_INDEX)
    if gpu_shares.sum() > 0 and not already:
        ids = []
        for dev_id, cnt in enumerate(gpu_shares):
            ids.extend([str(dev_id)] * int(round(float(cnt))))
        set_annotation(placed, C.ANNO_POD_GPU_INDEX, "-".join(ids))
    return placed


def write_extended_annotations(ext, log: dict, nodes: List[dict]) -> None:
    """Mirror the storage/GPU state the reference's Bind/Reserve plugins
    write back into node annotations. `ext` is the tensorizer's
    ExtendedNodeArrays, `log` an engine ext_log (node-parallel lists)."""
    import json as _json

    from .core.extended import NodeStorage

    n = len(nodes)
    v = ext.vg_cap.shape[1]
    sd = ext.sdev_cap.shape[1]
    gd = ext.gpu_dev_total.shape[1]
    vg_used = np.zeros((n, v), np.float64)
    sdev_taken = np.zeros((n, sd), bool)
    gpu_used = np.zeros((n, gd), np.float64)
    gpu_pods = np.zeros(n, np.int64)
    for node_idx, vg_alloc, take, shares, mem in zip(
        log["node"], log["vg_alloc"], log["sdev_take"], log["gpu_shares"], log["gpu_mem"]
    ):
        vg_used[node_idx] += vg_alloc
        sdev_taken[node_idx] |= take
        gpu_used[node_idx] += np.asarray(shares) * mem
        if mem > 0:
            gpu_pods[node_idx] += 1
    for i, node in enumerate(nodes):
        storage = NodeStorage.from_node(node)
        if storage is not None:
            for j, vg in enumerate(storage.vgs):
                if j < v:
                    prev = parse_quantity(vg.get("requested") or 0)
                    vg["requested"] = int(prev + vg_used[i, j])
                    if isinstance(vg.get("capacity"), str):
                        vg["capacity"] = int(parse_quantity(vg["capacity"]))
            for j, dev in enumerate(storage.devices):
                if j < sd and sdev_taken[i, j]:
                    dev["isAllocated"] = True
            set_annotation(
                node,
                C.ANNO_NODE_LOCAL_STORAGE,
                _json.dumps({"vgs": storage.vgs, "devices": storage.devices}),
            )
        if ext.gpu_total[i] > 0:
            devs = {
                str(j): {
                    "gpuTotalMemory": int(ext.gpu_dev_total[i, j]),
                    "gpuUsedMemory": int(gpu_used[i, j]),
                }
                for j in range(gd)
                if ext.gpu_dev_total[i, j] > 0
            }
            info = {
                "gpuCount": int((ext.gpu_dev_total[i] > 0).sum()),
                "gpuAllocatable": int(((ext.gpu_dev_total[i] > 0) & (gpu_used[i] == 0)).sum()),
                "gpuTotalMemory": int(ext.gpu_total[i]),
                "gpuUsedMemory": int(gpu_used[i].sum()),
                "numPods": int(gpu_pods[i]),
                "devs": devs,
            }
            set_annotation(node, C.ANNO_NODE_GPU_SHARE, _json.dumps(info))


def simulate(
    cluster: ResourceTypes,
    apps: Sequence[AppResource] = (),
    extended_resources: Sequence[str] = (),
    use_greed: bool = False,
    sched_config=None,
    device=None,
) -> SimulateResult:
    """One-shot simulation: expand cluster workloads, run the cluster, then
    schedule each app in order. Unscheduled pods accumulate across the
    cluster and every app; node status reflects the final cluster.

    `device=None` runs on the CUDA card (RuntimeError without one);
    `device="cpu"` runs the plain PyTorch path."""
    sim = Simulator(
        extra_resources=extended_resources,
        use_greed=use_greed,
        sched_config=sched_config,
        device=device,
    )
    cluster = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
    try:
        cluster_pods = get_valid_pods_exclude_daemonset(cluster)
        for ds in cluster.daemon_sets:
            cluster_pods.extend(make_valid_pods_by_daemonset(ds, cluster.nodes))
        cluster.pods = cluster_pods
        result = sim.run_cluster(cluster)
        for app in apps:
            result = sim.schedule_app(app)
        return result
    finally:
        sim.close()
