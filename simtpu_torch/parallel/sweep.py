"""Batched capacity-planning sweep: all candidate cluster sizes at once.

The port of the JAX package's `simtpu/parallel/sweep.py`. The reference
finds the minimum node-add count with up to 101 *serial* full
re-simulations (`pkg/apply/apply.go:183-233`); here the candidate axis is
a tensor dimension: ONE tensorization holds the base nodes plus `max_new`
template clones, a `node_valid [S, N]` mask marks each candidate's
membership, and one launch of K19 `sweep_place` (`engine/batched.py`)
places the whole pod list for every candidate, one block per candidate,
each on its own replica of the empty state that K18 `sweep_drain`
broadcasts (no entries to drain). `sweep_scan` is that pair, the
counterpart of the JAX `_sweep_scan` (on CPU tensors it runs their plain
versions).

DaemonSet semantics: clone nodes get their DaemonSet pods expanded like
real nodes, so candidate i ignores failures of pods pinned to clones >= i
(those pods don't exist in candidate i's cluster — the reference only ever
creates DS pods for nodes present in that iteration,
`pkg/simulator/core.go:72-82`).

`mesh` raises NotImplementedError (ROADMAP queue 1 #10).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import constants as C
from ..core.objects import AppResource, ResourceTypes, set_label
from ..core.tensorize import Tensorizer
from ..device import resolve_device
from ..engine import batched
from ..engine.scan import StepBuffers, build_pod_arrays, flags_from, statics_from
from ..engine.state import build_state
from ..workloads.expand import get_valid_pods_exclude_daemonset, make_valid_pods_by_daemonset


def assemble_planning_problem(cluster: ResourceTypes, apps: Sequence[AppResource], new_node: dict,
                              max_new: int, extended_resources: Sequence[str] = ()):
    """One tensorization covering the base cluster plus `max_new` template
    clones, with the ordered pod sequence exactly as simulate() submits it
    (cluster pods + DaemonSet expansion over ALL nodes incl. clones, then
    each app's sorted pods). Returns (tensorizer, all_nodes, n_base,
    ordered_pods). The JAX package's `parallel/sweep.py` function."""
    from ..api import _sort_app_pods
    from ..plan.capacity import new_fake_nodes

    base_nodes = list(cluster.nodes)
    n_base = len(base_nodes)
    all_nodes = base_nodes + new_fake_nodes(new_node, max_new)
    ordered: List[dict] = []
    work = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
    work.nodes = all_nodes
    cluster_pods = get_valid_pods_exclude_daemonset(work)
    for ds in work.daemon_sets:
        cluster_pods.extend(make_valid_pods_by_daemonset(ds, all_nodes))
    ordered.extend(cluster_pods)
    for app in apps:
        pods = get_valid_pods_exclude_daemonset(app.resource)
        for ds in app.resource.daemon_sets:
            pods.extend(make_valid_pods_by_daemonset(ds, all_nodes))
        for pod in pods:
            set_label(pod, C.LABEL_APP_NAME, app.name)
        ordered.extend(_sort_app_pods(pods))
    tensorizer = Tensorizer(
        all_nodes,
        extended_resources,
        storage_classes=list(cluster.storage_classes),
        services=list(cluster.services),
        pvcs=list(cluster.persistent_volume_claims),
        pvs=list(cluster.persistent_volumes),
    )
    return tensorizer, all_nodes, n_base, ordered


def _sweep_inputs(statics, valid_s: np.ndarray, state, pods, flags):
    """The device inputs of `sweep_scan`: the combined [S, N] masks, the
    whole batch's pod arrays and the [S, P] rows (every candidate walks
    the whole pod list)."""
    dev = statics.alloc.device
    valid = torch.as_tensor(np.asarray(valid_s, bool), device=dev) & statics.node_valid[None, :]
    s_n, p = valid.shape[0], len(pods[0])
    rows = torch.arange(p, dtype=torch.int32, device=dev).repeat(s_n, 1)
    batch_buf = StepBuffers(statics, state, pods, flags)
    return valid, rows, batch_buf


def sweep_scan(statics, valid_s: np.ndarray, state, pods, flags):
    """Every candidate mask's placement of the whole pod list: K18
    `sweep_drain` with no entries (the broadcast of `state`, which is only
    read), then one K19 `sweep_place` over every candidate, on the device
    of `statics` (the plain versions on the CPU). Returns (nodes, reasons)
    [S, P] on the host — the JAX `_sweep_scan`'s outputs."""
    valid, rows, batch_buf = _sweep_inputs(statics, valid_s, state, pods, flags)
    empty = torch.zeros((valid.shape[0], 0), dtype=torch.int32, device=valid.device)
    reps = batched.sweep_drain(statics, state, batched.empty_log_like(state), empty)
    sb = batched.SweepBuffers(batch_buf, pods, statics, reps, valid, rows)
    batched.sweep_place(sb)
    return sb.outputs()


def sweep_feasibility(
    cluster: ResourceTypes,
    apps: Sequence[AppResource],
    new_node: dict,
    candidates: Sequence[int],
    extended_resources: Sequence[str] = (),
    mesh=None,
    sched_config=None,
    device=None,
):
    """Run every candidate clone-count in one batched placement on `device`
    (None = the CUDA card).

    Returns (failures [S] int array — unscheduled-pod count per candidate,
    n_base, pods) where `pods` is the concatenated ordered pod list.
    """
    if mesh is not None:
        raise NotImplementedError("sweep_feasibility(mesh=...) is not ported (ROADMAP queue 1 #10)")
    device = resolve_device(device)
    candidates = np.asarray(list(candidates), np.int32)
    max_new = int(candidates.max()) if len(candidates) else 0
    tensorizer, all_nodes, n_base, ordered = assemble_planning_problem(
        cluster, apps, new_node, max_new, extended_resources
    )
    batch = tensorizer.add_pods(ordered)
    tensors = tensorizer.freeze()
    statics = statics_from(tensors, sched_config, device)
    r = tensors.alloc.shape[1]
    _, pods_arrays = build_pod_arrays(batch, r)
    state = build_state(
        tensors,
        np.zeros(0, np.int32),
        np.zeros(0, np.int32),
        np.zeros((0, r), np.float32),
        None,
        device,
    )
    n_total = len(all_nodes)
    # valid_s[s, j]: base nodes always; clone j-n_base iff < candidates[s]
    clone_idx = np.arange(n_total) - n_base
    valid_s = (clone_idx[None, :] < candidates[:, None]) | (clone_idx[None, :] < 0)
    nodes_sp, _ = sweep_scan(statics, valid_s, state, pods_arrays, flags_from(tensors, batch.ext))

    # per-candidate failure count, ignoring pods that only exist on clones
    # beyond the candidate's size (pins into invalid clone rows)
    pin = np.asarray(batch.pin)
    failures = np.zeros(len(candidates), np.int64)
    for s, cand in enumerate(candidates):
        phantom = (pin >= 0) & (pin - n_base >= cand)
        failures[s] = int(((nodes_sp[s] < 0) & ~phantom).sum())
    return failures, n_base, ordered


def plan_capacity_batched(
    cluster: ResourceTypes,
    apps: Sequence[AppResource],
    new_node: dict,
    max_new_nodes: int = C.MAX_NUM_NEW_NODE,
    extended_resources: Sequence[str] = (),
    mesh=None,
    progress=None,
    sched_config=None,
    corrected_ds_overhead: bool = False,
    device=None,
):
    """Batched replacement for the serial min-node-add search.

    Evaluates all candidate counts 0..max_new_nodes-1 in one batched sweep,
    then re-runs the precise serial simulation at the winning count to
    produce the full report-grade `SimulateResult` (the sweep's phantom-pod
    bookkeeping makes its placements candidate-exact, but reports want node
    annotations built for exactly the winning cluster). Every placement
    runs on `device` (None = the CUDA card).
    """
    from ..api import simulate
    from ..plan.capacity import PlanResult, new_fake_nodes, plan_capacity, satisfy_resource_setting

    say = progress or (lambda s: None)
    # parity with the serial planner: the largest candidate ever simulated is
    # max_new_nodes-1 (the reference's `for i := 0; i < MaxNumNewNode` walk,
    # apply.go:183; see plan_capacity)
    candidates = list(range(max_new_nodes))
    say(f"sweeping {len(candidates)} candidate sizes in one batch")
    failures, _, _ = sweep_feasibility(
        cluster, apps, new_node, candidates, extended_resources, mesh, sched_config, device
    )
    feasible = np.flatnonzero(failures == 0)
    probes = {int(c): int(f) for c, f in zip(candidates, failures)}
    if len(feasible) == 0:
        # fall back to the serial planner for its rich infeasibility
        # diagnostics (apply.go:213-231 semantics)
        return plan_capacity(
            cluster,
            apps,
            new_node,
            max_new_nodes,
            extended_resources,
            search="binary",
            progress=progress,
            sched_config=sched_config,
            corrected_ds_overhead=corrected_ds_overhead,
            device=device,
        )
    # occupancy caps (MaxCPU/MaxMemory/MaxVG) are part of feasibility and
    # monotone in node count — the reference keeps adding nodes on a cap
    # miss (`apply.go:199-207`), so walk the schedulable candidates upward
    result, reason = None, ""
    for best in (int(c) for c in feasible):
        say(f"candidate add = {best} node(s); re-simulating exactly")
        trial = ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
        trial.nodes = list(cluster.nodes) + new_fake_nodes(new_node, best)
        result = simulate(
            trial, apps, extended_resources=extended_resources, sched_config=sched_config,
            device=device,
        )
        ok, reason = satisfy_resource_setting(result)
        if ok:
            return PlanResult(True, best, result, "Success!", probes)
        say(reason.rstrip("\n"))
    return PlanResult(False, int(feasible[-1]), result, reason, probes)
