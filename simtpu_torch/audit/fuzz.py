"""Placement corruptions in every constraint class the auditor checks.

`_mutation_fixture`, `MUTATION_CLASSES` and `_mutate_nodes` are the port's
copy of the JAX package's mutation-kill helpers (`simtpu/audit/fuzz.py`):
a placed problem with a target for every engine-level corruption, and the
corruption of the landing-node vector for each class. The illegal-eviction
class corrupts a preemption record, not a placement, and has no node
mutation (`_mutate_nodes` returns None for it, as in the JAX package).

`BULK_CORRUPTIONS` / `corrupt` add what the bulk pass (K8) checks beyond
those classes: exclusive-volume, attach-limit, Open-Local storage and
GPU-share violations, forced and pinned entries, and a node filled exactly
(and one just past it). They corrupt the audit's inputs — the frozen
ClusterTensors and the placement-order entries (`checker._Entries`) — as
numpy, so the same corrupted inputs reach every version of the bulk pass.
`bulk_fixture` is a small placed problem with a target for each.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np

from ..core.objects import AppResource, ResourceTypes
from ..synth import make_deployment, synth_cluster


def _mutation_fixture(seed: int = 0, n_nodes: int = 16):
    """A placed problem guaranteeing every corruption class a target:
    headroom-light burst pods (overcommit), zone selectors (invalid node),
    hard hostname anti-affinity, hard zone spread, required zone
    self-affinity, and one host port per node."""
    cluster = synth_cluster(n_nodes, seed=seed, zones=4, taint_frac=0.0)
    res = ResourceTypes()
    res.deployments = [
        make_deployment("burst", 3 * n_nodes, 2000, 512),
        make_deployment("sel", 8, 250, 256,
                        node_selector={"topology.kubernetes.io/zone": "zone-0"}),
        make_deployment("anti", 6, 250, 256,
                        anti_affinity_topo="kubernetes.io/hostname",
                        anti_affinity_required=True),
        make_deployment("spread", 8, 250, 256,
                        spread_topo="topology.kubernetes.io/zone",
                        spread_hard=True),
        make_deployment("colo", 6, 250, 256,
                        affinity_topo="topology.kubernetes.io/zone"),
        make_deployment("porty", 4, 100, 128, host_port=8080),
    ]
    apps = [AppResource(name="mut", resource=res)]
    return cluster, apps


MUTATION_CLASSES = (
    "invalid-node",
    "overcommit",
    "affinity-break",
    "anti-affinity-break",
    "spread-break",
    "port-conflict",
    "illegal-eviction",
)


def _mutate_nodes(kind: str, tensors, batch, nodes: np.ndarray, rng):
    """Corrupt the landing-node vector for one engine-level mutation
    class; returns the corrupted copy, or None when the case lacks the
    feature (the fixture guarantees it never does)."""
    nodes = np.asarray(nodes).copy()
    group = np.asarray(batch.group)
    placed = (nodes >= 0) & ~np.asarray(batch.forced, bool)
    static = np.asarray(tensors.static_mask, bool)

    def rows_of(pred_g) -> np.ndarray:
        gs = np.flatnonzero(pred_g)
        return np.flatnonzero(placed & np.isin(group, gs))

    if kind == "invalid-node":
        for j in rng.permutation(np.flatnonzero(placed)):
            bad = np.flatnonzero(~static[group[j]])
            if len(bad):
                nodes[j] = int(rng.choice(bad))
                return nodes
        return None
    if kind == "overcommit":
        from ..core.tensorize import RES_CPU

        alloc = np.asarray(tensors.alloc)
        req = np.asarray(batch.req)
        target = int(np.argmin(alloc[:, RES_CPU]))
        total = 0.0
        moved = False
        for j in np.flatnonzero(placed):
            if not static[group[j], target]:
                continue
            nodes[j] = target
            total += float(req[j, RES_CPU])
            moved = True
            if total > alloc[target, RES_CPU] * 1.01:
                return nodes
        return nodes if moved and total > alloc[target, RES_CPU] else None
    if kind == "anti-affinity-break":
        a_anti = np.asarray(tensors.a_anti_req, bool)
        rows = rows_of(a_anti.any(axis=1))
        if len(rows) < 2:
            return None
        nodes[rows[1]] = nodes[rows[0]]
        return nodes
    if kind == "spread-break":
        sh = np.asarray(tensors.spread_hard)
        rows = rows_of((sh > 0).any(axis=1))
        if len(rows) < 3:
            return None
        nodes[rows] = nodes[rows[0]]
        return nodes
    if kind == "affinity-break":
        a_aff = np.asarray(tensors.a_aff_req, bool)
        for g in np.flatnonzero(a_aff.any(axis=1)):
            rows = np.flatnonzero(placed & (group == g))
            if len(rows) < 2:
                continue
            t = int(np.flatnonzero(a_aff[g])[0])
            dom = tensors.node_dom[int(tensors.term_topo_key[t])]
            have = set(int(d) for d in dom[nodes[rows]])
            other = np.flatnonzero(
                (dom >= 0) & ~np.isin(dom, list(have)) & static[g]
            )
            if len(other):
                nodes[rows[-1]] = int(other[0])
                return nodes
        return None
    if kind == "port-conflict":
        ports = np.asarray(tensors.ports, bool)
        rows = rows_of(ports.any(axis=1))
        if len(rows) < 2:
            return None
        nodes[rows[1]] = nodes[rows[0]]
        return nodes
    return None


def entries_as_batch(e) -> SimpleNamespace:
    """An entries view with the batch fields `_mutate_nodes` reads."""
    return SimpleNamespace(group=e.g, forced=e.forced, req=e.req)


def mutate_entries(kind: str, tensors, e, rng):
    """`_mutate_nodes` applied to placement-order entries: a corrupted copy
    of `e`, or None when the class has no node mutation here."""
    nodes = _mutate_nodes(kind, tensors, entries_as_batch(e), e.n, rng)
    return None if nodes is None else dataclasses.replace(e, n=nodes)


def _gce_volumes(pd: str, read_only: bool = False) -> list:
    return [{"name": "d", "gcePersistentDisk": {"pdName": pd, "readOnly": read_only}}]


def bulk_fixture(seed: int = 0, n_nodes: int = 12):
    """(cluster, apps) with a target for every bulk corruption: Open-Local
    VGs and exclusive SSDs, GPU nodes, LVM, device, one- and multi-GPU
    pods, host ports, and one GCE PD mounted read-write and read-only
    (exclusive-volume conflicts and attach limits)."""
    cluster = synth_cluster(n_nodes, seed=seed, zones=3, taint_frac=0.0,
                            storage_frac=0.6, gpu_frac=0.6)
    deps = [
        make_deployment("lvm", 8, 500, 512, lvm_gib=(20, 10)),
        make_deployment("ssd", 4, 500, 512, device_gib=60),
        make_deployment("gpu1", 6, 500, 512, gpu_mem_mib=8192),
        make_deployment("gpu2", 4, 500, 512, gpu_mem_mib=4096, gpu_count=2),
        make_deployment("porty", 4, 100, 128, host_port=9090),
        make_deployment("disk-rw", 4, 100, 128),
        make_deployment("disk-ro", 4, 100, 128),
        make_deployment("plain", 24, 1000, 1024),
    ]
    # one GCE PD, mounted read-write by one deployment, read-only by another
    for dep, read_only in ((deps[5], False), (deps[6], True)):
        dep["spec"]["template"]["spec"]["volumes"] = _gce_volumes("pd-shared", read_only)
    return cluster, [AppResource(name="bulk", resource=ResourceTypes(deployments=deps))]


BULK_CORRUPTIONS = (
    "volume-conflict",
    "read-only-conflict",
    "attach-limit",
    "storage-space",
    "device-double-take",
    "gpu",
    "forced-elsewhere",
    "forced-overcommit",
    "pin-missing",
    "pin-elsewhere",
    "exact-fill",
    "just-past-fill",
)


def zero_widths(tensors, e):
    """(tensors, entries) with every optional family cut to width 0: no
    host ports, volumes, attach classes, VGs, devices or GPUs."""
    ext = tensors.ext
    ext0 = dataclasses.replace(
        ext, vg_cap=ext.vg_cap[:, :0], vg_req0=ext.vg_req0[:, :0],
        sdev_cap=ext.sdev_cap[:, :0], sdev_alloc0=ext.sdev_alloc0[:, :0],
        gpu_dev_total=ext.gpu_dev_total[:, :0],
    )
    t0 = dataclasses.replace(
        tensors, ext=ext0, ports=tensors.ports[:, :0], n_ports=0,
        vol_rw=tensors.vol_rw[:, :0], vol_ro=tensors.vol_ro[:, :0],
        vol_att=tensors.vol_att[:, :0], vol_class_mask=tensors.vol_class_mask[:0, :0],
        attach_limits=tensors.attach_limits[:, :0], n_vols=0,
    )
    e0 = dataclasses.replace(e, lvm=e.lvm[:, :0], sdev=e.sdev[:, :0], gpu=e.gpu[:, :0])
    return t0, e0


def corrupt(kind: str, tensors, e, rng):
    """(tensors, entries) corrupted for one BULK_CORRUPTIONS class (copies;
    the inputs are untouched), or None when the case has no target."""
    e = dataclasses.replace(
        e, n=e.n.copy(), req=e.req.copy(), forced=e.forced.copy(), pin=e.pin.copy(),
        lvm=np.array(e.lvm, np.float64), sdev=np.array(e.sdev, bool),
        gpu=np.array(e.gpu, np.float64),
    )
    m = len(e.n)
    soft = np.flatnonzero(~e.forced)
    if not len(soft):
        return None
    rw = np.asarray(tensors.vol_rw, bool)
    ro = np.asarray(tensors.vol_ro, bool)
    att = np.asarray(tensors.vol_att, bool)

    def stack(rows) -> bool:
        """Move the second of `rows` onto the first's node."""
        if len(rows) < 2:
            return False
        e.n[rows[1]] = e.n[rows[0]]
        return True

    if kind == "volume-conflict":
        rows = soft[rw[e.g[soft]].any(axis=1)] if rw.shape[1] else soft[:0]
        return (tensors, e) if stack(rows) else None
    if kind == "read-only-conflict":
        # a read-only mount moved onto a node whose entry holds the same
        # volume read-write
        shared = np.flatnonzero(rw.any(axis=0) & ro.any(axis=0)) if rw.shape[1] else []
        for w in shared:
            a = soft[rw[e.g[soft], w]]
            b = soft[ro[e.g[soft], w]]
            if len(a) and len(b):
                e.n[b[0]] = e.n[a[0]]
                return tensors, e
        return None
    if kind == "attach-limit":
        rows = soft[att[e.g[soft]].any(axis=1)] if att.shape[1] else soft[:0]
        if not len(rows):
            return None
        limits = np.array(tensors.attach_limits, np.float32)
        limits[e.n[rows[0]], :] = 0.0
        return dataclasses.replace(tensors, attach_limits=limits), e
    if kind == "storage-space":
        rows = soft[e.lvm[soft].sum(axis=1) > 0]
        if not len(rows):
            return None
        e.lvm[rows[0]] *= 1000.0
        return tensors, e
    if kind == "device-double-take":
        rows = soft[e.sdev[soft].any(axis=1)]
        if not len(rows):
            return None
        j = int(rows[0])
        k = int(soft[soft != j][0])
        e.n[k] = e.n[j]
        e.sdev[k] = e.sdev[j]
        return tensors, e
    if kind == "gpu":
        rows = soft[e.gpu[soft].sum(axis=1) > 0]
        if not len(rows):
            return None
        e.gpu[rows[0]] *= 100.0
        return tensors, e
    if kind == "forced-elsewhere":
        j = int(rng.choice(soft))
        e.forced[j] = True
        e.pin[j] = (int(e.n[j]) + 1) % tensors.alloc.shape[0]
        return tensors, e
    if kind == "forced-overcommit":
        # a forced binding bypasses fit, but its request still counts: the
        # next soft entry on its node overcommits
        for j in soft:
            later = soft[(soft > j) & (e.n[soft] == e.n[j])]
            if len(later):
                e.forced[j] = True
                e.pin[j] = e.n[j]
                e.req[j] = np.asarray(tensors.alloc, np.float64)[e.n[j]]
                return tensors, e
        return None
    if kind == "pin-missing":
        e.pin[int(rng.choice(soft))] = -2
        return tensors, e
    if kind == "pin-elsewhere":
        j = int(rng.choice(soft))
        e.pin[j] = (int(e.n[j]) + 1) % tensors.alloc.shape[0]
        return tensors, e
    if kind in ("exact-fill", "just-past-fill"):
        # the last soft entry of a node with earlier entries takes exactly
        # the node's remaining cpu (or 1 more); sums of requests are exact
        # in f64, so every form of the prefix gives the same free value
        from ..core.tensorize import RES_CPU

        alloc = np.asarray(tensors.alloc, np.float64)
        for j in soft[::-1]:
            before = np.flatnonzero((np.arange(m) < j) & (e.n == e.n[j]))
            if len(before):
                free = alloc[e.n[j], RES_CPU] - e.req[before, RES_CPU].sum()
                e.req[j, RES_CPU] = free + (1.0 if kind == "just-past-fill" else 0.0)
                return tensors, e
        return None
    raise ValueError(f"unknown corruption {kind!r}")
