"""Drain & requeue: evict the pods of failed nodes, re-place the backlog.

The functional analog of what a real cluster does when a node dies: the
node controller deletes the node's pods, their controllers recreate them,
and kube-scheduler places the recreations against the surviving nodes.
Here the placement log IS the cluster state, so a drain is a batch of
signed log deltas (`Engine.remove_placements`: K13 into a compact carry,
K7 into a dense one) and the requeue is one more engine placement over
the masked cluster (`Engine.node_valid`). The port of the JAX package's
`simtpu/faults/drain.py`.

Two entry points:

- `drain_requeue` (engine level): exact, restorable, and the serial
  oracle the batched sweep (faults/sweep.py) is pinned against.  Pods
  FORCED to a failed node (DaemonSet pods, spec.nodeName pins) die with
  the node — they are drained but not requeued, and never count as
  unplaced (their node no longer exists to run them).
- `drain_simulator` (facade level): requeues through
  `Simulator._schedule_pods`, so the evicted pods re-enter the FULL
  scheduling flow including DefaultPreemption retry semantics (api.py) —
  a high-priority evictee may push lower-priority pods off surviving
  nodes, exactly as a fresh submission would.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .. import constants as C
from ..core.objects import AppResource, ResourceTypes, annotations_of, shallow_pod_copy
from ..core.tensorize import PodBatch, slice_batch
from ..device import resolve_device
from ..engine.scan import Engine


@dataclass
class PlacedCluster:
    """One placed problem the fault subsystem reasons about: the frozen
    tensors, the full pod batch, the engine holding the placement log, and
    the base placement vector.  `log_row[j]` maps engine log index j back
    to its batch row (the log appends placed pods in batch order)."""

    tz: object
    tensors: object
    batch: PodBatch
    engine: Engine
    nodes: np.ndarray  # [P] base landing node per batch row (-1 = unplaced)
    reasons: np.ndarray  # [P]

    def __post_init__(self):
        self.nodes = np.asarray(self.nodes)
        self.reasons = np.asarray(self.reasons)
        self.log_row = np.flatnonzero(self.nodes >= 0)
        self._dies = None

    @property
    def n_nodes(self) -> int:
        return self.tensors.alloc.shape[0]

    @property
    def dies_with_node(self) -> np.ndarray:
        """[P] rows that DIE with their node rather than requeue: pods
        forced via spec.nodeName, and DaemonSet-owned pods (the reference
        pins those per node through a matchFields affinity,
        workloads/expand.py — either way the pod has no other node to
        exist on, exactly as in a real cluster where the DS controller
        only recreates it when a node comes back)."""
        if self._dies is None:
            forced = np.asarray(self.batch.forced, bool)
            if self.batch.pods:
                daemon = np.fromiter(
                    (_is_daemon_pod(p) for p in self.batch.pods),
                    bool,
                    len(self.batch.pods),
                )
                self._dies = forced | daemon
            else:
                self._dies = forced.copy()
        return self._dies


def place_cluster(
    cluster: ResourceTypes,
    apps: Sequence[AppResource] = (),
    extended_resources: Sequence[str] = (),
    bulk: bool = True,
    sched_config=None,
    engine_factory=None,
    speculate=None,
    device=None,
) -> PlacedCluster:
    """Expand, tensorize and place the whole problem through ONE engine —
    the base placement every fault scenario drains from.  Pod order matches
    `simulate()` (cluster pods + DaemonSet expansion, then each app's
    sorted pods); preemption does not run here (the sweep's scenario axis
    asks whether everything fits, the same contract as the incremental
    planner — use `drain_simulator` when eviction semantics matter).
    The placement runs on `device` (None = the CUDA card)."""
    from ..engine.rounds import RoundsEngine
    from ..parallel.sweep import assemble_planning_problem

    device = resolve_device(device)

    if not cluster.nodes:
        raise ValueError("cannot place against a cluster with no nodes")
    tz, _all_nodes, _n_base, ordered = assemble_planning_problem(
        cluster, apps, cluster.nodes[0], 0, extended_resources
    )
    batch = tz.add_pods(ordered)
    factory = engine_factory or (RoundsEngine if bulk else Engine)
    eng = factory(tz, device)
    eng.sched_config = sched_config
    if speculate is not None:
        eng.speculate = bool(speculate)
    nodes, reasons, _extras = eng.place(batch)
    return PlacedCluster(
        tz=tz, tensors=tz.freeze(), batch=batch, engine=eng,
        nodes=nodes, reasons=reasons,
    )


@dataclass
class DrainResult:
    """Outcome of one drain + requeue scenario."""

    fail_mask: np.ndarray  # [N] the scenario (True = node failed)
    evicted_rows: np.ndarray  # batch rows drained off failed nodes
    lost_rows: np.ndarray  # forced subset that dies with its node
    requeue_rows: np.ndarray  # rows requeued (evicted minus lost)
    requeue_nodes: np.ndarray  # landing node per requeue row (-1 = unplaced)
    requeue_reasons: np.ndarray  # failure codes parallel to requeue_nodes
    preempted: int = 0  # victims evicted by preemption (drain_simulator only)
    extra_unscheduled: int = 0  # facade-path pods unplaced even after preemption

    @property
    def unplaced_rows(self) -> np.ndarray:
        return self.requeue_rows[np.asarray(self.requeue_nodes) < 0]

    @property
    def unplaced(self) -> int:
        return int((np.asarray(self.requeue_nodes) < 0).sum()) + self.extra_unscheduled

    @property
    def survived(self) -> bool:
        return self.unplaced == 0


def drain_requeue(
    pc: PlacedCluster,
    fail_mask: np.ndarray,
    restore: bool = False,
) -> DrainResult:
    """Drain every pod placed on a failed node, then requeue the survivors'
    backlog (original placement order) against the masked cluster.

    With `restore=True` the engine is rolled back afterwards — requeue
    placements removed, victims restored via the batch-delta undo — so the
    next scenario drains from a bit-identical base (the serial-replay
    oracle the sweep tests are pinned against).  With `restore=False` the
    engine is left holding the post-failure cluster (node mask applied,
    backlog placed where it fits)."""
    eng = pc.engine
    n = pc.n_nodes
    fail = np.asarray(fail_mask, bool)
    if fail.shape != (n,):
        raise ValueError(f"fail_mask shape {fail.shape} != ({n},)")
    placed_log_nodes = np.asarray(eng.placed_node, np.int64)
    vict_log = np.flatnonzero(fail[placed_log_nodes])
    rows = pc.log_row[vict_log]
    dies = pc.dies_with_node[rows]
    # DaemonSet pods and spec.nodeName pins die with their node: drained
    # from the state, but with no other node to exist on they neither
    # requeue nor count as unplaced
    lost_rows = rows[dies]
    requeue_rows = rows[~dies]

    # an empty drain must not touch the log: remove_placements with no
    # entries would mark the carried state dirty (forcing a rebuild), and
    # the failure-free scenario is pinned as a strict no-op
    saved = (
        eng.remove_placements([int(i) for i in vict_log])
        if len(vict_log)
        else {"indices": [], "entries": []}
    )
    prev_valid = eng.node_valid
    eng.node_valid = (
        ~fail if prev_valid is None else np.asarray(prev_valid, bool) & ~fail
    )
    try:
        if len(requeue_rows):
            probe = slice_batch(pc.batch, requeue_rows)
            log_base = len(eng.placed_node)
            req_nodes, req_reasons, _extras = eng.place(probe)
            req_nodes = np.asarray(req_nodes)
            req_reasons = np.asarray(req_reasons)
        else:
            log_base = len(eng.placed_node)
            req_nodes = np.zeros(0, np.int64)
            req_reasons = np.zeros(0, np.int32)
        if restore:
            placed_cnt = int((req_nodes >= 0).sum())
            if placed_cnt:
                # permanent removal of the requeue entries (no undo token
                # kept): the restore below returns the log to the base
                eng.remove_placements(
                    list(range(log_base, log_base + placed_cnt))
                )
            if saved["indices"]:
                eng.restore_placements(saved)
    finally:
        if restore:
            eng.node_valid = prev_valid
    return DrainResult(
        fail_mask=fail,
        evicted_rows=rows,
        lost_rows=lost_rows,
        requeue_rows=requeue_rows,
        requeue_nodes=req_nodes,
        requeue_reasons=req_reasons,
    )


def _is_daemon_pod(pod: dict) -> bool:
    for ref in (pod.get("metadata") or {}).get("ownerReferences") or []:
        if ref.get("kind") == "DaemonSet":
            return True
    return False


def _unbind(pod: dict, gpu_assigned: bool) -> dict:
    """A requeue-able copy of a placed pod: binding and phase cleared.  The
    GPU device-index annotation `record_placed_pod` wrote at bind time is
    dropped when the engine log shows this placement consumed GPU shares —
    keeping it would act as a preset pin onto device indices of a node the
    pod may no longer land on.  (A pod whose index annotation predates the
    simulation is indistinguishable from an assigned one here; dropping is
    the safe default for drained pods and is documented in
    docs/resilience.md.)"""
    p = shallow_pod_copy(pod)
    p["spec"].pop("nodeName", None)
    if "status" in p:
        p["status"] = dict(p["status"])
        p["status"].pop("phase", None)
    if gpu_assigned and C.ANNO_POD_GPU_INDEX in annotations_of(p):
        p["metadata"]["annotations"] = {
            k: v
            for k, v in annotations_of(p).items()
            if k != C.ANNO_POD_GPU_INDEX
        }
    return p


def drain_simulator(sim, fail_mask: np.ndarray) -> DrainResult:
    """Drain failed nodes on a live `Simulator` and requeue the evicted
    pods through the full facade flow — `Simulator._schedule_pods`
    including DefaultPreemption (api.py): a requeued pod may evict
    lower-priority pods on surviving nodes exactly as a fresh submission
    would, and requeue failures are recorded in the simulator's
    unscheduled list with real reason strings.

    The failure mask STAYS applied to the simulator's engine (the cluster
    has genuinely lost those nodes); `sim._result()` afterwards reflects
    the post-failure placement.  DaemonSet pods and spec.nodeName-bound
    pods on failed nodes die with their node (drained, not requeued)."""
    eng = sim._engine
    fail = np.asarray(fail_mask, bool)
    placed_log_nodes = np.asarray(eng.placed_node, np.int64)
    vict_log = [int(i) for i in np.flatnonzero(fail[placed_log_nodes])]
    gpu_mem_log = [float(eng.ext_log["gpu_mem"][i]) for i in vict_log]
    bound_log = [bool(sim._placed_forced[i]) for i in vict_log]
    saved = (
        eng.remove_placements(vict_log)
        if vict_log
        else {"indices": [], "entries": []}
    )
    victims = [sim._scheduled[i] for i in saved["indices"]]
    for i in reversed(saved["indices"]):
        del sim._scheduled[i]
        del sim._placed_prio[i]
        del sim._placed_forced[i]
    requeue, lost = [], 0
    for pod, gpu_mem, bound in zip(victims, gpu_mem_log, bound_log):
        if bound or _is_daemon_pod(pod):
            # same death rule as the engine oracle (drain_requeue): pods
            # statically bound via spec.nodeName die with their node too
            lost += 1
            continue
        requeue.append(_unbind(pod, gpu_assigned=gpu_mem > 0))
    prev_valid = eng.node_valid
    eng.node_valid = (
        ~fail if prev_valid is None else np.asarray(prev_valid, bool) & ~fail
    )
    before_unsched = len(sim._unscheduled)
    before_preempted = len(sim._preempted)
    sim._schedule_pods(requeue)
    return DrainResult(
        fail_mask=fail,
        evicted_rows=np.asarray(saved["indices"], np.int64),
        lost_rows=np.zeros(lost, np.int64),
        requeue_rows=np.arange(len(requeue), dtype=np.int64),
        requeue_nodes=np.zeros(0, np.int64),
        requeue_reasons=np.zeros(0, np.int32),
        preempted=len(sim._preempted) - before_preempted,
        extra_unscheduled=len(sim._unscheduled) - before_unsched,
    )
