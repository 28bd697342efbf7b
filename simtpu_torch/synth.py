"""Synthetic cluster/workload generation for benchmarks and scale tests.

The reference ships only small hand-written example clusters
(`example/cluster/demo_1`, 4 nodes); its implied scaling axis is
pods × nodes (SURVEY.md §6). This module manufactures arbitrarily large
clusters and app lists with the full constraint mix — zone labels, taints +
tolerations, node selectors, preferred node affinity, inter-pod
anti-affinity, GPU-share nodes, Open-Local storage nodes — so the engine,
sweep, and bench exercise every kernel at any N.

Deterministic: all choices derive from `seed` via numpy's Generator.
"""

from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

from .core.objects import AppResource, ResourceTypes


def make_node(
    name: str,
    cpu_milli: int,
    mem_gib: int,
    labels=None,
    taints=None,
    gpu: Tuple[int, int] = None,  # (count, mem_mib_per_device)
    storage_gib: Tuple[int, ...] = (),
    device_gib: Tuple[Tuple[int, str], ...] = (),  # (gib, "ssd"|"hdd") each
) -> dict:
    alloc = {
        "cpu": f"{cpu_milli}m",
        "memory": f"{mem_gib}Gi",
        "pods": "256",
    }
    annotations = {}
    if gpu:
        count, mem = gpu
        alloc["alibabacloud.com/gpu-count"] = str(count)
        alloc["alibabacloud.com/gpu-mem"] = f"{count * mem}Mi"
    if storage_gib or device_gib:
        annotations["simon/node-local-storage"] = json.dumps(
            {
                "vgs": [
                    {"name": f"vg{j}", "capacity": g * (1 << 30), "requested": 0}
                    for j, g in enumerate(storage_gib)
                ],
                "devices": [
                    {
                        "device": f"/dev/sd{chr(ord('b') + j)}",
                        "capacity": g * (1 << 30),
                        "mediaType": media,
                        "isAllocated": False,
                    }
                    for j, (g, media) in enumerate(device_gib)
                ],
            }
        )
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": name, "labels": dict(labels or {}), "annotations": annotations},
        "spec": ({"taints": taints} if taints else {}),
        "status": {"allocatable": dict(alloc), "capacity": dict(alloc)},
    }


def make_deployment(
    name: str,
    replicas: int,
    cpu_milli: int,
    mem_mib: int,
    namespace: str = "bench",
    node_selector=None,
    tolerations=None,
    anti_affinity_topo: str = None,
    anti_affinity_required: bool = False,  # required vs preferred anti-affinity
    affinity_topo: str = None,  # required SELF-affinity (colocate-with-self)
    spread_topo: str = None,  # topologySpreadConstraints topology key
    spread_hard: bool = False,  # DoNotSchedule vs ScheduleAnyway
    gpu_mem_mib: int = 0,
    gpu_count: int = 1,  # GPU shares per pod (multi-GPU when > 1)
    gpu_index: str = None,  # preset gpu-index annotation, e.g. "0-1"
    lvm_gib=0,  # int (one claim) or tuple of ints (multi-claim)
    device_gib: int = 0,  # exclusive-SSD claim size
    host_port: int = 0,  # hostPort on the container (NodePorts conflicts)
    priority: int = None,  # spec.priority (preemption-relevant mixes)
) -> dict:
    labels = {"app": name}
    requests = {"cpu": f"{cpu_milli}m", "memory": f"{mem_mib}Mi"}
    container = {"name": "c", "image": "app", "resources": {"requests": requests}}
    if host_port:
        container["ports"] = [{"containerPort": host_port, "hostPort": host_port}]
    spec = {"containers": [container]}
    if priority is not None:
        spec["priority"] = int(priority)
    if node_selector:
        spec["nodeSelector"] = dict(node_selector)
    if tolerations:
        spec["tolerations"] = list(tolerations)
    if anti_affinity_topo:
        term = {
            "labelSelector": {"matchLabels": labels},
            "topologyKey": anti_affinity_topo,
        }
        if anti_affinity_required:
            # hard self-anti: at most one replica per topology domain — the
            # "one per node/zone" pattern (requiredDuringScheduling)
            anti = {"requiredDuringSchedulingIgnoredDuringExecution": [term]}
        else:
            anti = {
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": 100, "podAffinityTerm": term}
                ]
            }
        spec["affinity"] = {"podAntiAffinity": anti}
    if affinity_topo:
        # required colocate-with-self: every replica must share a domain
        # with a pod matching the workload's own labels
        aff_term = {
            "labelSelector": {"matchLabels": labels},
            "topologyKey": affinity_topo,
        }
        spec.setdefault("affinity", {})["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [aff_term]
        }
    if spread_topo:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": 1,
                "topologyKey": spread_topo,
                "whenUnsatisfiable": (
                    "DoNotSchedule" if spread_hard else "ScheduleAnyway"
                ),
                "labelSelector": {"matchLabels": labels},
            }
        ]
    # pod labels/annotations come from the OWNER's metadata, not the
    # template's (SetObjectMetaFromObject copies owner.GetLabels()/
    # GetAnnotations(), utils.go:336-346; the gpushare example carries its
    # gpu annotations on the workload metadata accordingly)
    annotations = {}
    if gpu_mem_mib:
        annotations["alibabacloud.com/gpu-mem"] = f"{gpu_mem_mib}Mi"
        annotations["alibabacloud.com/gpu-count"] = str(gpu_count)
        if gpu_index:
            annotations["alibabacloud.com/gpu-index"] = gpu_index
    volumes = []
    for gib in (lvm_gib,) if isinstance(lvm_gib, int) else tuple(lvm_gib):
        if gib:
            # unnamed-VG LVM volumes → binpack across node VGs
            # (common.go:59-107); a tuple makes a multi-claim pod
            volumes.append(
                {"kind": "LVM", "scName": "open-local-lvm", "size": gib * (1 << 30)}
            )
    if device_gib:
        # exclusive-device claim (media resolved via the SC catalog)
        volumes.append(
            {
                "kind": "SSD",
                "scName": "open-local-device-ssd",
                "size": device_gib * (1 << 30),
            }
        )
    if volumes:
        annotations["simon/pod-local-storage"] = json.dumps({"volumes": volumes})
    meta = {"name": name, "namespace": namespace, "labels": dict(labels)}
    if annotations:
        meta["annotations"] = annotations
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta,
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": labels},
            "template": {"metadata": {"labels": dict(labels)}, "spec": spec},
        },
    }


def synth_cluster(
    n_nodes: int,
    seed: int = 0,
    zones: int = 8,
    taint_frac: float = 0.1,
    gpu_frac: float = 0.0,
    storage_frac: float = 0.0,
    racks_per_zone: int = 4,
) -> ResourceTypes:
    """A cluster of `n_nodes` heterogeneous nodes across `zones` zones,
    each node also labeled with a rack failure domain nested in its zone
    (`simtpu.io/rack`, the key `simtpu/faults` domain scenarios target)."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        zone = f"zone-{i % zones}"
        labels = {
            "topology.kubernetes.io/zone": zone,
            "kubernetes.io/hostname": f"node-{i:06d}",
        }
        taints = None
        if rng.random() < taint_frac:
            taints = [
                {"key": "dedicated", "value": "infra", "effect": "NoSchedule"}
            ]
        gpu = None
        if rng.random() < gpu_frac:
            gpu = (int(rng.integers(2, 9)), 16384)
        storage = ()
        devices = ()
        if rng.random() < storage_frac:
            # 1-2 VGs exercises the multi-container binpack fill
            storage = tuple(
                int(rng.integers(200, 1000)) for _ in range(int(rng.integers(1, 3)))
            )
            if rng.random() < 0.5:
                devices = tuple(
                    (int(rng.integers(100, 500)), "ssd")
                    for _ in range(int(rng.integers(1, 4)))
                )
        cpu = int(rng.choice([16000, 32000, 64000, 96000]))
        mem = int(rng.choice([64, 128, 256, 384]))
        nodes.append(
            make_node(f"node-{i:06d}", cpu, mem, labels, taints, gpu, storage, devices)
        )
    if racks_per_zone > 0:
        # rack failure-domain labels, drawn AFTER the whole per-node stream
        # so every pre-existing seed's draws (and the placements/fuzz
        # scenarios pinned to them) are unchanged — append-only RNG use
        rack_of = rng.integers(racks_per_zone, size=n_nodes)
        for i, node in enumerate(nodes):
            node["metadata"]["labels"]["simtpu.io/rack"] = (
                f"zone-{i % zones}-rack-{int(rack_of[i])}"
            )
    res = ResourceTypes()
    res.nodes = nodes
    if storage_frac > 0:
        # the device SCs the pod claims name (media resolved from parameters)
        res.storage_classes = [
            {
                "kind": "StorageClass",
                "metadata": {"name": "open-local-device-ssd"},
                "parameters": {"mediaType": "ssd"},
            },
            {
                "kind": "StorageClass",
                "metadata": {"name": "open-local-device-hdd"},
                "parameters": {"mediaType": "hdd"},
            },
        ]
    return res


def synth_apps(
    n_pods: int,
    seed: int = 1,
    zones: int = 8,
    pods_per_deployment: int = 50,
    selector_frac: float = 0.2,
    toleration_frac: float = 0.1,
    anti_affinity_frac: float = 0.2,
    anti_affinity_hard_frac: float = 0.0,  # fraction OF anti workloads required
    spread_frac: float = 0.0,
    spread_hard_frac: float = 0.0,  # fraction OF spread workloads DoNotSchedule
    gpu_frac: float = 0.0,
    gpu_multi_frac: float = 0.0,  # fraction OF gpu workloads with count 2-4
    storage_frac: float = 0.0,
    storage_device_frac: float = 0.3,  # fraction OF storage workloads claiming
    # an exclusive device (the rest binpack LVM)
    lvm_multi_frac: float = 0.0,  # fraction OF LVM workloads with 2-3 claims
    affinity_frac: float = 0.0,  # required colocate-with-self workloads
) -> List[AppResource]:
    """App list totalling ~n_pods pods across deployments with mixed
    constraints (the `complicate` example writ large)."""
    rng = np.random.default_rng(seed)
    apps: List[AppResource] = []
    made = 0
    d = 0
    resources = ResourceTypes()
    while made < n_pods:
        replicas = min(pods_per_deployment, n_pods - made)
        kw = {}
        roll = rng.random()
        if roll < gpu_frac:
            kw["gpu_mem_mib"] = int(rng.choice([4096, 8192, 16384]))
            # draw only when enabled so pre-existing seeds' streams (and the
            # fuzz scenarios pinned to them) are unchanged
            if gpu_multi_frac and rng.random() < gpu_multi_frac:
                kw["gpu_count"] = int(rng.integers(2, 5))
                kw["gpu_mem_mib"] = 4096
        elif roll < gpu_frac + storage_frac:
            if rng.random() < storage_device_frac:
                kw["device_gib"] = int(rng.integers(50, 200))
            else:
                kw["lvm_gib"] = int(rng.integers(5, 40))
                if lvm_multi_frac and rng.random() < lvm_multi_frac:
                    kw["lvm_gib"] = tuple(
                        int(rng.integers(5, 30))
                        for _ in range(int(rng.integers(2, 4)))
                    )
        if rng.random() < selector_frac:
            kw["node_selector"] = {
                "topology.kubernetes.io/zone": f"zone-{int(rng.integers(zones))}"
            }
        if rng.random() < toleration_frac:
            kw["tolerations"] = [
                {"key": "dedicated", "operator": "Exists", "effect": "NoSchedule"}
            ]
        if rng.random() < anti_affinity_frac:
            kw["anti_affinity_topo"] = "kubernetes.io/hostname"
            # draw only when enabled so pre-existing seeds' streams (and the
            # fuzz scenarios pinned to them) are unchanged
            if anti_affinity_hard_frac and rng.random() < anti_affinity_hard_frac:
                kw["anti_affinity_required"] = True
        if affinity_frac and rng.random() < affinity_frac:
            kw["affinity_topo"] = "topology.kubernetes.io/zone"
        # draw only when enabled so pre-existing seeds' random streams (and
        # the scenarios fuzz tests pinned to them) are unchanged
        if spread_frac and rng.random() < spread_frac:
            kw["spread_topo"] = "topology.kubernetes.io/zone"
            kw["spread_hard"] = bool(spread_hard_frac) and rng.random() < spread_hard_frac
        resources.deployments.append(
            make_deployment(
                f"dep-{d:05d}",
                replicas,
                int(rng.choice([250, 500, 1000, 2000])),
                int(rng.choice([256, 512, 1024, 4096])),
                **kw,
            )
        )
        made += replicas
        d += 1
    apps.append(AppResource(name="synthetic", resource=resources))
    return apps


def make_trace(
    n_nodes: int,
    n_pods: int,
    seed: int = 0,
    days: float = 1.0,
    zones: int = 8,
    mean_gang: int = 8,
    duration_mean_s: float = 3600.0,
    duration_sigma: float = 0.8,
    priority_classes: Tuple[int, ...] = (0, 10, 100),
    priority_weights: Tuple[float, ...] = (0.7, 0.2, 0.1),
    cron_jobs: int = 2,
    elastic_frac: float = 0.0,
    node_event_frac: float = 0.0,
    forever_frac: float = 0.05,
    autoscale_pool: int = 0,
    autoscale_interval_s: float = 1800.0,
    autoscale_target_util: float = 0.6,
    selector_frac: float = 0.1,
    anti_affinity_frac: float = 0.15,
) -> dict:
    """A seeded Alibaba-shaped arrival trace for `simtpu replay`
    (timeline/events.py `trace_from_doc` consumes the returned document;
    `json.dumps` of it is a valid trace file).

    Shape: Poisson-ish gang arrivals (exponential inter-arrival gaps)
    over a `days`-long horizon, lognormal service durations, geometric-ish
    gang sizes around `mean_gang`, a priority-class mix, `cron_jobs`
    CronJob entries firing real cron schedules, and (opt-in) elastic
    HPA-scalable workloads, node maintenance windows, and a template-node
    autoscaler pool.

    Determinism: every choice derives from `seed` via one Generator, and
    optional features draw ONLY when enabled (the same append-only RNG
    discipline as `synth_cluster`'s rack labels) — enabling a new knob
    never perturbs the arrival stream an existing seed already pinned.
    Workload constraint mixes stay soft (preferred anti-affinity, node
    selectors): admission pressure comes from capacity, which keeps the
    end-state audit exact under out-of-order admissions
    (docs/timeline.md §determinism).
    """
    rng = np.random.default_rng(seed)
    horizon = float(days) * 86400.0
    jobs = []
    t = 0.0
    made = 0
    est_gangs = max(n_pods // max(mean_gang, 1), 1)
    mean_gap = horizon * 0.8 / est_gangs
    j = 0
    while made < n_pods:
        t += float(rng.exponential(mean_gap))
        if t >= horizon:
            break
        size = int(min(1 + rng.geometric(1.0 / max(mean_gang, 1)),
                       4 * mean_gang, n_pods - made))
        dur = float(rng.lognormal(np.log(duration_mean_s), duration_sigma))
        prio = int(rng.choice(priority_classes, p=priority_weights))
        kw = {}
        if rng.random() < selector_frac:
            kw["node_selector"] = {
                "topology.kubernetes.io/zone": f"zone-{int(rng.integers(zones))}"
            }
        if rng.random() < anti_affinity_frac:
            kw["anti_affinity_topo"] = "kubernetes.io/hostname"
        dep = make_deployment(
            f"tj-{j:05d}",
            size,
            int(rng.choice([250, 500, 1000, 2000])),
            int(rng.choice([256, 512, 1024, 4096])),
            priority=prio,
            **kw,
        )
        job = {
            "name": f"tj-{j:05d}",
            "t_s": round(t, 3),
            "priority": prio,
            "workload": dep,
        }
        if rng.random() >= forever_frac:
            job["duration_s"] = round(max(dur, 60.0), 3)
        # draw only when enabled: pre-existing seeds' streams (and the
        # replays pinned to them) are unchanged when the knob is off
        if elastic_frac and rng.random() < elastic_frac:
            lo = max(1, size // 2)
            hi = min(2 * size, 4 * mean_gang)
            usage = [
                [0.0, round(float(rng.uniform(0.3, 0.5)), 3)],
                [round(horizon * 0.3, 3), round(float(rng.uniform(0.7, 0.95)), 3)],
                [round(horizon * 0.7, 3), round(float(rng.uniform(0.35, 0.6)), 3)],
            ]
            job["elastic"] = {"min": lo, "max": hi, "usage": usage}
        jobs.append(job)
        made += size
        j += 1

    crons = []
    for c in range(int(cron_jobs)):
        expr = str(rng.choice(
            ["*/15 * * * *", "0 * * * *", "30 */2 * * *", "0 */6 * * *"]
        ))
        completions = int(rng.integers(1, max(mean_gang // 2, 2)))
        cj = {
            "apiVersion": "batch/v1",
            "kind": "CronJob",
            "metadata": {"name": f"cron-{c:03d}", "namespace": "bench"},
            "spec": {
                "schedule": expr,
                "jobTemplate": {
                    "spec": {
                        "completions": completions,
                        "template": {
                            "spec": {
                                "containers": [
                                    {
                                        "name": "c",
                                        "image": "app",
                                        "resources": {
                                            "requests": {
                                                "cpu": f"{int(rng.choice([250, 500]))}m",
                                                "memory": f"{int(rng.choice([256, 512]))}Mi",
                                            }
                                        },
                                    }
                                ]
                            }
                        },
                    }
                },
            },
        }
        crons.append(
            {
                "cron_job": cj,
                "duration_s": round(float(rng.uniform(300.0, 1200.0)), 3),
                "priority": 0,
            }
        )

    node_events = []
    if node_event_frac:
        k = max(1, int(node_event_frac * n_nodes))
        victims = rng.choice(n_nodes, size=min(k, n_nodes), replace=False)
        for v in sorted(int(x) for x in victims):
            t_down = float(rng.uniform(0.1, 0.7)) * horizon
            window = float(rng.lognormal(np.log(3600.0), 0.5))
            name = f"node-{v:06d}"
            node_events.append(
                {"t_s": round(t_down, 3), "down": [name]}
            )
            t_up = t_down + max(window, 300.0)
            if t_up < horizon:
                node_events.append({"t_s": round(t_up, 3), "up": [name]})

    doc = {
        "version": 1,
        "seed": int(seed),
        "horizon_s": horizon,
        "cluster": {
            "synth": {"n_nodes": int(n_nodes), "seed": int(seed),
                      "zones": int(zones)}
        },
        "jobs": jobs,
        "cron_jobs": crons,
        "node_events": node_events,
    }
    if autoscale_pool:
        doc["autoscale"] = {
            "interval_s": float(autoscale_interval_s),
            "target_util": float(autoscale_target_util),
            "pool": int(autoscale_pool),
            "node": make_node(
                "timeline-pool-template",
                32000,
                128,
                labels={"topology.kubernetes.io/zone": "zone-0"},
            ),
        }
    return doc
