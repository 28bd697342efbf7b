"""The smoke problems: one definition for the golden files, the tests and
`chip_smoke.py`.

**Serial smoke problem** — 1000 nodes × 10 000 pods: `bench.py
build_problem`'s "hard" constraint mix (zone spread, half of it
DoNotSchedule; preferred and required pod anti-affinity; node selectors;
tolerations) without Open-Local storage or GPU-share pods, at the top of the
serial path's range (under 1024 nodes and 16 384 pods).

**Extended problem** (`EXT_*`) — the same mix with the storage and GPU
knobs on, at the same scale: 1000 nodes (30% with Open-Local VGs, half of
those with exclusive SSDs; 40% with 2-8 GPUs of 16 GiB) × 10 000 pods (25%
GPU-share, 60% of those multi-GPU; 25% Open-Local, 30% of those on an
exclusive device, 60% of the LVM ones with 2-3 claims; 15% zone
self-affinity), then a priority tier at priority 1000 as one more app:
`EXT_TIER` = 400 CPU-heavy pods (60 cores), 400 GPU-share pods (two 16 GiB
GPUs) and 150 LVM pods (two claims, 250 and 150 GiB). The tier outgrows
the capacity the ordinary pods leave, so part of it fails and preempts: on
the JAX package (simtpu.simulate on the CPU, wavefront off) the tier's first
attempt fails 55 pods for resources and 163 for GPU memory, preemption
evicts 500 pods, and every tier pod ends up placed (the golden file records
each placement, eviction and annotation). 10 950 pods in all, under the
serial path's limits. Cut from bench.py's 100 000 nodes × 1 000 000 pods to
the serial path's range; the widths (constraint mix, resource kinds) are
bench.py's.

**Capacity problem** (`CAP_*`) — the `apply` path at the top of the serial
planner's range: the serial smoke mix on `synth_cluster(900, **CLUSTER_KW)`
plus a "burst" app of three plain Deployments (no spread, no affinity;
3 × 780 pods of 8 cores and 32 GiB), and a template node of 64 cores and
256 GiB in zone-0. 12 340 declared pods (under 16 384) on 900 nodes plus
at most 99 clones (under 1024), so `_resolve_engines` keeps the serial
engine. Sized on the JAX package (`plan_capacity` on the CPU, the numpy
audit twin, pod names seeded): the plan adds 43 nodes after 13 candidates
(the doubling to 64, then the bisection 48, 40, 44, 42, 43), every
candidate audited, the winner's 12 340 placements certified clean. The
golden file keeps the verdict, the probes, the audit counters and the
winner's placement record.

**Rack problem** (`RACK_*`) — the lean wave kernel's count carry on a key
of many small domains, at the serial path's width: the smoke cluster's
1000 nodes with a `rack` label of 400 racks (2-3 nodes each: more than
DOM_SMALL domains and not unique per node, the JAX package's lean
verifier's generic route), and Deployments with soft spread and
preferred anti-affinity on `rack` and soft spread on the zone.

**Keys problem** (`KEYS_*`) — more topology keys than a fixed per-key
table would hold: the smoke cluster's 1000 nodes with 20 extra labels
`topo-k` (node i in domain i mod (2 + 3k)), and one Deployment per key
with, in turn, soft spread, preferred anti-affinity and hard spread on
it (22 topology keys with hostname and zone). No golden file for these
two: `chip_smoke.py` holds the wave kernels against their plain versions
on their runs.

**Bulk problem** (`BULK_*`) — the bulk rounds engine at the size of a
large cluster: `bench.py build_problem`'s "hard" mix as it stands there
(16 zones, 30% of the nodes with Open-Local VGs; 1000-replica
Deployments, zone spread with half of it DoNotSchedule, preferred and
required pod anti-affinity, node selectors, tolerations, 20% Open-Local
pods, 30% of those on an exclusive device) at 5000 nodes × 150 000 pods,
the limits Kubernetes documents a cluster for ("Considerations for large
clusters", kubernetes.io/docs/setup/best-practices/cluster-large/).
`simulate(bulk=True)` plans 150 runs: 124 plain rounds (124 000 pods),
25 domain-quota rounds (25 000 pods) and one serial segment (1000 pods).
The golden record (`bulk_record`) keeps per-node placed counts, per-reason
counts, sha256 digests of every (pod, node, reason) and of the
annotations, and the first `BULK_HEAD` entries in key order.

**Matrix cut** (`MATRIX_*`) — bench.py's "matrix" mix (multi-GPU shares,
multi-claim LVM, required colocate-with-self) at 2000 nodes × 20 000 pods:
`chip_smoke.py` holds the matrix and self-affinity rounds against their
plain versions on it. No golden file.

**Large capacity problem** (`LCAP_*`) — the `apply` front door above the
serial planner's range, where the JAX package auto-selects bulk placement
and the incremental search: the soft ("north") mix without storage pods
on 2000 nodes (30% with VGs) × 40 000 pods, a burst app of 3 × 1100 plain
pods (8 cores, 32 GiB) and the capacity template (64 cores, 256 GiB,
zone-0). On the JAX package (the CPU, numpy audit twin, pod names seeded)
the plan adds 38 nodes: probes {0: 300, 37: 4, 38: 0}, then the fresh
verify run at 38, audited clean. The golden file keeps the plan record.

Pod-name suffixes are seeded (`seed_name_hashes`), so a placement record
keyed by pod name compares across runs and packages.
"""

from __future__ import annotations

import gzip
import hashlib
import json
from pathlib import Path

from .constants import ANNO_NODE_GPU_SHARE, ANNO_NODE_LOCAL_STORAGE, ANNO_POD_GPU_INDEX

N_NODES = 1000
N_PODS = 10000
CLUSTER_KW = dict(seed=3, zones=16, taint_frac=0.1, storage_frac=0, gpu_frac=0)
APPS_KW = dict(
    seed=4,
    zones=16,
    pods_per_deployment=50,
    selector_frac=0.2,
    toleration_frac=0.1,
    anti_affinity_frac=0.2,
    anti_affinity_hard_frac=0.34,
    spread_frac=0.3,
    spread_hard_frac=0.5,
    storage_frac=0,
    gpu_frac=0,
)
NAME_SEED = 2026
DATA = Path(__file__).resolve().parent.parent / "tests" / "data"
#: placements and reasons of the JAX package's simtpu.simulate on the CPU
#: (written by tests/test_torch_golden.py)
GOLDEN = DATA / "torch_serial_smoke.json.gz"

EXT_CLUSTER_KW = dict(CLUSTER_KW, storage_frac=0.3, gpu_frac=0.4)
EXT_APPS_KW = dict(
    APPS_KW,
    gpu_frac=0.25,
    gpu_multi_frac=0.6,
    storage_frac=0.25,
    storage_device_frac=0.3,
    lvm_multi_frac=0.6,
    affinity_frac=0.15,
)
#: the priority tier: (name, replicas, make_deployment keywords)
EXT_TIER = (
    ("tier-cpu", 400, dict(cpu_milli=60000, mem_mib=8192)),
    ("tier-gpu", 400, dict(cpu_milli=2000, mem_mib=4096, gpu_mem_mib=16384, gpu_count=2)),
    ("tier-lvm", 150, dict(cpu_milli=2000, mem_mib=4096, lvm_gib=(250, 150))),
)
EXT_PRIORITY = 1000
EXT_GOLDEN = DATA / "torch_extended_smoke.json.gz"

CAP_NODES = 900
#: the burst app: (name, replicas, cpu millicores, memory MiB), plain pods
CAP_BURST = tuple((f"burst-{k}", 780, 8000, 32768) for k in "abc")
CAP_TEMPLATE = dict(name="simon-template", cpu_milli=64000, mem_gib=256)
CAP_ZONE = "zone-0"
CAP_GOLDEN = DATA / "torch_capacity_smoke.json.gz"

#: the JAX package's compact carry on each main path, its default: the
#: state.compress / state.expand / state.delta_direct counts over the run
#: and the final carry's bytes beside the dense layout's (written by
#: tests/test_torch_golden.py compute_compact_carry, on the CPU)
COMPACT_CARRY = {
    "serial": dict(compress=1, expand=0, delta_direct=0, carried_bytes=1719452, dense_bytes=2731004),
    "extended": dict(compress=3, expand=1, delta_direct=1, carried_bytes=1865964, dense_bytes=3637164),
    "capacity": dict(compress=26, expand=0, delta_direct=0, carried_bytes=1634027, dense_bytes=2598107),
    "bulk": dict(compress=1, expand=0, delta_direct=0, carried_bytes=6149184, dense_bytes=10096512),
    "large_capacity": dict(compress=4, expand=2, delta_direct=0, carried_bytes=715297, dense_bytes=1148561),
}


BULK_NODES = 5000
BULK_PODS = 150000
BULK_CLUSTER_KW = dict(seed=3, zones=16, taint_frac=0.1, storage_frac=0.3, gpu_frac=0.0)
BULK_APPS_KW = dict(
    seed=4,
    zones=16,
    pods_per_deployment=1000,
    selector_frac=0.2,
    toleration_frac=0.1,
    anti_affinity_frac=0.2,
    anti_affinity_hard_frac=0.34,
    spread_frac=0.3,
    spread_hard_frac=0.5,
    gpu_frac=0.0,
    gpu_multi_frac=0.0,
    storage_frac=0.2,
    storage_device_frac=0.3,
    lvm_multi_frac=0.0,
    affinity_frac=0.0,
)
#: entries of the bulk record kept in full (the first in key order)
BULK_HEAD = 200
BULK_GOLDEN = DATA / "torch_bulk_smoke.json.gz"
#: the JAX package's segment plan of the bulk problem (kind: (runs, pods))
BULK_SEGMENTS = {"bulk": (124, 124000), "bulkq": (25, 25000), "scan": (1, 1000)}

MATRIX_NODES = 2000
MATRIX_PODS = 20000
MATRIX_CLUSTER_KW = dict(BULK_CLUSTER_KW, gpu_frac=0.4)
MATRIX_APPS_KW = dict(
    BULK_APPS_KW,
    anti_affinity_hard_frac=0.0,
    spread_hard_frac=0.0,
    gpu_frac=0.25,
    gpu_multi_frac=0.6,
    storage_frac=0.25,
    storage_device_frac=0.0,
    lvm_multi_frac=0.6,
    affinity_frac=0.15,
)

LCAP_NODES = 2000
LCAP_PODS = 40000
LCAP_APPS_KW = dict(BULK_APPS_KW, anti_affinity_hard_frac=0.0, spread_hard_frac=0.0,
                    storage_frac=0.0, storage_device_frac=0.0)
LCAP_BURST = tuple((f"burst-{k}", 1100, 8000, 32768) for k in "abc")
LCAP_GOLDEN = DATA / "torch_large_capacity_smoke.json.gz"
#: the JAX package's auto-selection notice on the large capacity problem
#: (simtpu/plan/capacity.py _resolve_engines, on stderr)
LCAP_AUTO_LINE = (
    "simtpu: large problem (2000 nodes, ~43300 declared pods) — auto-selected bulk placement + "
    "incremental search; pass --search binary/linear or --no-bulk for the serial reference-exact engines"
)


def template_node(synth) -> dict:
    """The capacity template node (CAP_TEMPLATE in CAP_ZONE) from a
    package's own synth module."""
    return synth.make_node(
        CAP_TEMPLATE["name"], CAP_TEMPLATE["cpu_milli"], CAP_TEMPLATE["mem_gib"],
        labels={"topology.kubernetes.io/zone": CAP_ZONE,
                "kubernetes.io/hostname": CAP_TEMPLATE["name"]})


def bulk_problem(synth, n_nodes=BULK_NODES, n_pods=BULK_PODS):
    """(cluster, apps) of the bulk problem from a package's own synth module."""
    return synth.synth_cluster(n_nodes, **BULK_CLUSTER_KW), synth.synth_apps(n_pods, **BULK_APPS_KW)


def matrix_problem(synth, n_nodes=MATRIX_NODES, n_pods=MATRIX_PODS):
    """(cluster, apps) of the matrix cut from a package's own synth module."""
    return (synth.synth_cluster(n_nodes, **MATRIX_CLUSTER_KW),
            synth.synth_apps(n_pods, **MATRIX_APPS_KW))


def large_capacity_problem(synth, app_cls, resources_cls, n_nodes=LCAP_NODES, n_pods=LCAP_PODS,
                           burst=LCAP_BURST):
    """(cluster, apps, new_node) of the large capacity problem from a
    package's own synth module, AppResource and ResourceTypes."""
    cluster = synth.synth_cluster(n_nodes, **BULK_CLUSTER_KW)
    apps = synth.synth_apps(n_pods, **LCAP_APPS_KW)
    res = resources_cls(deployments=[synth.make_deployment(name, replicas, cpu, mem)
                                     for name, replicas, cpu, mem in burst])
    template = template_node(synth)
    return cluster, apps + [app_cls(name="burst", resource=res)], template


def smoke_problem(synth_cluster, synth_apps, n_nodes=N_NODES, n_pods=N_PODS):
    """(cluster, apps) from a package's own synth module functions."""
    return synth_cluster(n_nodes, **CLUSTER_KW), synth_apps(n_pods, **APPS_KW)


def extended_problem(synth, app_cls, resources_cls, n_nodes=N_NODES, n_pods=N_PODS):
    """(cluster, apps) of the extended problem from a package's own synth
    module, AppResource and ResourceTypes: the storage/GPU mix, then the
    priority tier as one more app."""
    cluster = synth.synth_cluster(n_nodes, **EXT_CLUSTER_KW)
    apps = synth.synth_apps(n_pods, **EXT_APPS_KW)
    tier = resources_cls(
        deployments=[
            synth.make_deployment(name, replicas, priority=EXT_PRIORITY, **kw)
            for name, replicas, kw in EXT_TIER
        ]
    )
    return cluster, apps + [app_cls(name="tier", resource=tier)]


#: the wide problem: one node with WIDE_GPUS GPU devices and one with
#: WIDE_VGS volume groups and as many SSDs, past 32 on every per-node axis
#: (the JAX package caps none of them)
WIDE_GPUS, WIDE_VGS = 40, 36
WIDE_CLUSTER_KW = dict(seed=21, zones=2, taint_frac=0.0)
#: (name, replicas, make_deployment keywords): a 36-GPU pod (one share on
#: each of devices 0-35; the second replica fails), single-GPU pods on the
#: devices left (two fail), 4 GiB pods into the leftovers, two-claim LVM
#: pods into VGs 32-35 (the third fails), a three-claim LVM pod into VGs 0,
#: 18 and 19 (its per-VG usages fall into both parts of the raw score's
#: 36-column row sum, where its order shows), 345 GiB SSD claims on
#: devices 34 and 35 (one fails), and plain pods
WIDE_APPS = (
    ("gpu-stack", 2, dict(cpu_milli=1000, mem_mib=1024, gpu_mem_mib=12288, gpu_count=WIDE_VGS)),
    ("gpu-one", 6, dict(cpu_milli=500, mem_mib=512, gpu_mem_mib=15360)),
    ("gpu-small", 10, dict(cpu_milli=200, mem_mib=256, gpu_mem_mib=4096)),
    ("lvm-wide", 5, dict(cpu_milli=500, mem_mib=512, lvm_gib=(340, 330))),
    ("lvm-three", 1, dict(cpu_milli=500, mem_mib=512, lvm_gib=(3, 185, 195))),
    ("ssd-wide", 3, dict(cpu_milli=500, mem_mib=512, device_gib=345)),
    ("plain", 24, dict(cpu_milli=500, mem_mib=512)),
)


def wide_problem(synth, app_cls, resources_cls):
    """(cluster, apps) of the wide problem from a package's own synth
    module, AppResource and ResourceTypes: 8 plain nodes, `gpu-wide`
    (WIDE_GPUS devices of 16 GiB) and `disk-wide` (WIDE_VGS VGs of 10, 20,
    ..., 360 GiB and as many SSDs of the same sizes)."""
    cluster = synth.synth_cluster(8, **WIDE_CLUSTER_KW)

    def labels(name):
        return {"kubernetes.io/hostname": name, "topology.kubernetes.io/zone": "zone-0"}

    sizes = tuple(10 * (j + 1) for j in range(WIDE_VGS))
    cluster.nodes.append(synth.make_node("gpu-wide", 96000, 512, labels("gpu-wide"), gpu=(WIDE_GPUS, 16384)))
    cluster.nodes.append(synth.make_node("disk-wide", 64000, 256, labels("disk-wide"), storage_gib=sizes,
                                         device_gib=tuple((g, "ssd") for g in sizes)))
    cluster.storage_classes = [
        {"kind": "StorageClass", "metadata": {"name": "open-local-device-ssd"}, "parameters": {"mediaType": "ssd"}},
    ]
    res = resources_cls(deployments=[synth.make_deployment(name, replicas, namespace="wide", **kw)
                                     for name, replicas, kw in WIDE_APPS])
    return cluster, [app_cls(name="wide", resource=res)]


RACKS = 400
#: the rack problem's apps: (name, replicas, make_deployment keywords)
RACK_APPS = (
    ("rack-spread", 400, dict(cpu_milli=500, mem_mib=512, spread_topo="rack")),
    ("rack-shy", 300, dict(cpu_milli=700, mem_mib=256, anti_affinity_topo="rack")),
    ("zonal", 300, dict(cpu_milli=300, mem_mib=128, spread_topo="topology.kubernetes.io/zone")),
)


def rack_problem(synth, app_cls, resources_cls, n_nodes=N_NODES, racks=RACKS):
    """(cluster, apps) of the rack problem from a package's own synth
    module, AppResource and ResourceTypes."""
    cluster = synth.synth_cluster(n_nodes, **CLUSTER_KW)
    for i, node in enumerate(cluster.nodes):
        node["metadata"]["labels"]["rack"] = f"rack-{i * racks // n_nodes}"
    res = resources_cls(deployments=[synth.make_deployment(name, replicas, **kw)
                                     for name, replicas, kw in RACK_APPS])
    return cluster, [app_cls(name="racks", resource=res)]


KEYS = 20
KEYS_REPLICAS = 60


def keys_problem(synth, app_cls, resources_cls, n_nodes=N_NODES, keys=KEYS, replicas=KEYS_REPLICAS):
    """(cluster, apps) of the keys problem from a package's own synth
    module, AppResource and ResourceTypes."""
    cluster = synth.synth_cluster(n_nodes, **CLUSTER_KW)
    for i, node in enumerate(cluster.nodes):
        for k in range(keys):
            node["metadata"]["labels"][f"topo-{k}"] = f"d{i % (2 + 3 * k)}"
    shapes = (dict(spread_topo="{}"), dict(anti_affinity_topo="{}"), dict(spread_topo="{}", spread_hard=True))
    deps = []
    for k in range(keys):
        kw = {key: (v.format(f"topo-{k}") if isinstance(v, str) else v) for key, v in shapes[k % 3].items()}
        deps.append(synth.make_deployment(f"key-{k}", replicas, 300, 256, **kw))
    return cluster, [app_cls(name="keys", resource=resources_cls(deployments=deps))]


#: the many-keys problem: more topology keys than a packed 12-bit key
#: field holds. Every node carries MANY_KEYS label keys (`mk-<k>`, three
#: domains each); deployment d owns MANY_KEYS_PER_GROUP preferred
#: anti-affinity terms over keys [d * per, (d + 1) * per), each selecting
#: the deployment's own pods, so every group's Tc stays at 64 while the
#: problem has MANY_KEYS keys.
MANY_KEYS = 4100
MANY_KEYS_PER_GROUP = 50


def many_keys_problem(synth, app_cls, resources_cls, n_nodes: int, replicas: int, keys=MANY_KEYS,
                      per_group=MANY_KEYS_PER_GROUP):
    """(cluster, apps) of the many-keys problem from a package's own synth
    module, AppResource and ResourceTypes."""
    cluster = synth.synth_cluster(n_nodes, **CLUSTER_KW)
    for i, node in enumerate(cluster.nodes):
        node["metadata"]["labels"].update({f"mk-{k}": f"d{(i + k) % 3}" for k in range(keys)})
    deps = []
    for d in range(-(-keys // per_group)):
        dep = synth.make_deployment(f"mk-{d}", replicas, 200, 128, anti_affinity_topo="mk-0")
        dep["spec"]["template"]["spec"]["affinity"]["podAntiAffinity"][
            "preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": 1 + k % 100, "podAffinityTerm": {"labelSelector": {"matchLabels": {"app": f"mk-{d}"}},
                                                       "topologyKey": f"mk-{k}"}}
            for k in range(d * per_group, min(keys, (d + 1) * per_group))]
        deps.append(dep)
    return cluster, [app_cls(name="many-keys", resource=resources_cls(deployments=deps))]


#: the terms problem: any number of term columns per group (Tc). One app
#: ("many") carries TERMS preferred anti-affinity terms, term i selecting
#: `tier In [web, x<i>]` over the hostname, zone or rack key (i mod 3), so
#: the labels `tier: web` match every one of them; beside them a required
#: anti-affinity term per host and a DoNotSchedule zone spread of its own
#: (its runs are hard: K10). "web" carries the labels and no term of its
#: own (plain bulk rounds over those columns: K14-K16), "webq" the labels
#: and one required anti-affinity term per host (quota rounds). Every
#: group of the three sees terms + 2 or more relevant columns, so Tc is the
#: next power of two: 300 terms give Tc = 512, 600 give 1024.
TERMS_CLUSTER_KW = dict(zones=8, taint_frac=0.0)
TERMS_KEYS = ("kubernetes.io/hostname", "topology.kubernetes.io/zone", "simtpu.io/rack")


def terms_problem(synth, app_cls, resources_cls, n_nodes: int, terms: int, replicas=(40, 400, 40), seed: int = 7):
    """(cluster, apps) of the terms problem from a package's own synth
    module, AppResource and ResourceTypes: `n_nodes` nodes from `seed`,
    `terms` preferred terms, (many, web, webq) replicas."""
    cluster = synth.synth_cluster(n_nodes, seed=seed, **TERMS_CLUSTER_KW)
    many = synth.make_deployment("many", replicas[0], 200, 256, anti_affinity_topo=TERMS_KEYS[0],
                                 anti_affinity_required=True, spread_topo=TERMS_KEYS[1], spread_hard=True)
    many["spec"]["template"]["spec"]["affinity"]["podAntiAffinity"]["preferredDuringSchedulingIgnoredDuringExecution"] = [
        {"weight": 1 + i % 100, "podAffinityTerm": {
            "labelSelector": {"matchExpressions": [{"key": "tier", "operator": "In", "values": ["web", f"x{i}"]}]},
            "topologyKey": TERMS_KEYS[i % 3]}}
        for i in range(terms)]
    web = synth.make_deployment("web", replicas[1], 300, 512)
    webq = synth.make_deployment("webq", replicas[2], 250, 384, anti_affinity_topo=TERMS_KEYS[0],
                                 anti_affinity_required=True)
    for dep in (many, web, webq):
        dep["metadata"]["labels"]["tier"] = "web"
        dep["spec"]["template"]["metadata"]["labels"]["tier"] = "web"
    return cluster, [app_cls(name="terms", resource=resources_cls(deployments=[many, web, webq]))]


def capacity_problem(synth, app_cls, resources_cls, n_nodes=CAP_NODES, n_pods=N_PODS, burst=CAP_BURST):
    """(cluster, apps, new_node) of the capacity problem from a package's own
    synth module, AppResource and ResourceTypes: the serial smoke mix on
    `n_nodes` nodes, then the burst app, and the template node."""
    cluster = synth.synth_cluster(n_nodes, **CLUSTER_KW)
    apps = synth.synth_apps(n_pods, **APPS_KW)
    res = resources_cls(deployments=[synth.make_deployment(name, replicas, cpu, mem)
                                     for name, replicas, cpu, mem in burst])
    template = template_node(synth)
    return cluster, apps + [app_cls(name="burst", resource=res)], template


def write_capacity_config(root, cluster, apps, template) -> str:
    """Write (cluster, apps, template) as a simon Config under `root` — one
    multi-document YAML file per kind and directory, objects in list order
    (the cluster's storage classes beside its nodes) — so the `apply` front
    door loads exactly these objects. Returns the config's path."""
    import yaml

    dumper = getattr(yaml, "CSafeDumper", yaml.SafeDumper)
    root = Path(root)

    def dump(path: Path, objs) -> str:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.dump_all(list(objs), f, Dumper=dumper, sort_keys=False)
        return str(path.parent)

    cluster_dir = dump(root / "cluster" / "nodes.yaml", cluster.nodes)
    if cluster.storage_classes:
        dump(root / "cluster" / "storageclasses.yaml", cluster.storage_classes)
    app_list = [{"name": a.name, "path": dump(root / "apps" / a.name / "deployments.yaml",
                                              a.resource.deployments)} for a in apps]
    new_node = dump(root / "newnode" / "node.yaml", [template])
    config = {"apiVersion": "simon/v1alpha1", "kind": "Config",
              "metadata": {"name": "capacity"},
              "spec": {"cluster": {"customConfig": cluster_dir}, "appList": app_list,
                       "newNode": new_node}}
    path = root / "config.yaml"
    with open(path, "w") as f:
        yaml.dump(config, f, Dumper=dumper, sort_keys=False)
    return str(path)


def _key(pod: dict) -> str:
    meta = pod["metadata"]
    return f"{meta.get('namespace', '')}/{meta['name']}"


_NODE_ANNOS = (ANNO_NODE_LOCAL_STORAGE, ANNO_NODE_GPU_SHARE)


def placement_record(result) -> dict:
    """A SimulateResult (either package's) as plain data: "nodes" (node
    names), "placed" ({pod: node index}), "failed" ({pod: reason string}),
    "preempted" (sorted evicted pods), "gpu_index" ({placed pod: its GPU
    device assignment}) and "node_ext" ({node: its Open-Local and GPU-share
    annotations, as the simulation wrote them})."""
    nodes = [st.node["metadata"]["name"] for st in result.node_status]
    placed = {
        _key(pod): i for i, st in enumerate(result.node_status) for pod in st.pods
    }
    gpu_index = {
        _key(pod): (pod["metadata"].get("annotations") or {})[ANNO_POD_GPU_INDEX]
        for st in result.node_status
        for pod in st.pods
        if ANNO_POD_GPU_INDEX in (pod["metadata"].get("annotations") or {})
    }
    node_ext = {}
    for st in result.node_status:
        annos = st.node["metadata"].get("annotations") or {}
        ext = {k: annos[k] for k in _NODE_ANNOS if k in annos}
        if ext:
            node_ext[st.node["metadata"]["name"]] = ext
    failed = {_key(u.pod): u.reason for u in result.unscheduled_pods}
    return {
        "nodes": nodes,
        "placed": dict(sorted(placed.items())),
        "failed": dict(sorted(failed.items())),
        "preempted": sorted(_key(p.pod) for p in result.preempted_pods),
        "gpu_index": dict(sorted(gpu_index.items())),
        "node_ext": dict(sorted(node_ext.items())),
    }


#: the audit counters a plan record keeps (wall time and mode vary by run)
AUDIT_KEYS = ("ok", "checked", "violations", "by_class")


def plan_record(plan) -> dict:
    """A PlanResult (either package's) as plain data: its verdict, the
    probes map, the shipped candidate's audit counters and the winning
    candidate's placement record."""
    return {
        "success": plan.success,
        "nodes_added": plan.nodes_added,
        "message": plan.message,
        "probes": {str(k): v for k, v in sorted(plan.probes.items())},
        "audit": {k: plan.audit[k] for k in AUDIT_KEYS if k in plan.audit},
        "record": placement_record(plan.result),
    }


def plan_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two plan records (empty = equal)."""
    out = [f"{k}: {got[k]!r} != golden {want[k]!r}"
           for k in ("success", "nodes_added", "message", "probes", "audit") if got[k] != want[k]]
    return out + record_differences(got["record"], want["record"], limit)


def record_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two placement records (empty =
    identical): node list, every pod's node, every failed pod's reason, the
    preempted pods, GPU assignments and node annotations."""
    out = []
    if got["nodes"] != want["nodes"]:
        out.append("node lists differ")
    if got["preempted"] != want["preempted"]:
        only_got = sorted(set(got["preempted"]) - set(want["preempted"]))
        only_want = sorted(set(want["preempted"]) - set(got["preempted"]))
        out.append(f"preempted differ: {len(got['preempted'])} vs golden {len(want['preempted'])}, "
                   f"only here {only_got[:3]}, only in golden {only_want[:3]}")
    for field in ("placed", "failed", "gpu_index", "node_ext"):
        for key in sorted(set(got[field]) | set(want[field])):
            a, b = got[field].get(key), want[field].get(key)
            if a != b:
                out.append(f"{field} {key}: {a!r} != golden {b!r}")
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


def _digest(rows) -> str:
    h = hashlib.sha256()
    for row in rows:
        h.update(json.dumps(row, separators=(",", ":")).encode())
        h.update(b"\n")
    return h.hexdigest()


def bulk_record(result, head: int = BULK_HEAD) -> dict:
    """A large SimulateResult (either package's) as compact plain data: the
    node names, per-node placed counts, failure counts per reason text (the
    scheduler's message without the pod name), the
    number of preempted pods, a sha256 of every (pod, node index, reason)
    sorted by pod key (node -1 and the reason string for a failed pod, ""
    for a placed one), a sha256 of the annotations written (the pods' GPU
    assignments and the nodes' extended annotations, sorted by key), and
    the first `head` entries in key order in full."""
    entries = {}
    for i, st in enumerate(result.node_status):
        for pod in st.pods:
            entries[_key(pod)] = (i, "")
    for u in result.unscheduled_pods:
        entries[_key(u.pod)] = (-1, u.reason)
    rows = [[k, n, r] for k, (n, r) in sorted(entries.items())]
    full = placement_record(result)
    annos = sorted(full["gpu_index"].items()) + sorted(
        (k, sorted(v.items())) for k, v in full["node_ext"].items())
    reasons = {}
    for u in result.unscheduled_pods:
        why = u.reason.split("are available: ", 1)[-1]
        reasons[why] = reasons.get(why, 0) + 1
    return {
        "nodes": full["nodes"],
        "per_node": [len(st.pods) for st in result.node_status],
        "reasons": dict(sorted(reasons.items())),
        "preempted": len(result.preempted_pods),
        "pods": len(rows),
        "digest": _digest(rows),
        "annotations": _digest(annos),
        "head": rows[:head],
    }


def bulk_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two bulk records (empty = equal)."""
    out = [f"{k}: {got[k]!r} != golden {want[k]!r}"
           for k in ("nodes", "reasons", "preempted", "pods", "digest", "annotations") if got[k] != want[k]]
    diff_nodes = [i for i, (a, b) in enumerate(zip(got["per_node"], want["per_node"])) if a != b]
    if diff_nodes or len(got["per_node"]) != len(want["per_node"]):
        out.append(f"per-node counts differ on {len(diff_nodes)} nodes, first {diff_nodes[:5]}")
    for a, b in zip(got["head"], want["head"]):
        if a != b:
            out.append(f"first differing entry: {a!r} != golden {b!r}")
            break
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


def _array_digest(arr) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(np.asarray(arr), dtype="<i8").tobytes()).hexdigest()


#: keys of a fault sweep's or resilience plan's JSON document that time the
#: run (dropped from its record)
TIMING_KEYS = ("timings", "fault_scenarios_per_s", "plan_resilience_s")


def sweep_record(sweep) -> dict:
    """A fault sweep's SweepResult (either package's) as plain data: the
    counters without the rate, the worst scenarios, the critical nodes,
    the per-scenario evicted / lost / requeued / unplaced counts, and
    sha256 digests of the scenario labels and of the [S, Rq] requeue rows,
    landing nodes and reasons."""
    counters = {k: v for k, v in sweep.counters().items() if k not in TIMING_KEYS}
    return {
        "counters": counters,
        "worst": [[lbl, n] for lbl, n in sweep.worst()],
        "critical_nodes": [[node, n] for node, n in sweep.critical_nodes()],
        **{k: [int(x) for x in getattr(sweep, k)] for k in ("evicted", "lost", "requeued", "unplaced")},
        "labels": _digest(list(sweep.scenarios.labels)),
        "rq_shape": list(sweep.requeue_rows.shape),
        "requeue_rows": _array_digest(sweep.requeue_rows),
        "requeue_nodes": _array_digest(sweep.requeue_nodes),
        "requeue_reasons": _array_digest(sweep.requeue_reasons),
    }


def sweep_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two sweep records (empty = equal)."""
    out = []
    for key in sorted(set(got) | set(want)):
        a, b = got.get(key), want.get(key)
        if a == b:
            continue
        if isinstance(a, list) and isinstance(b, list) and len(a) == len(b) and key != "worst":
            bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            out.append(f"{key}: {len(bad)} entries differ, first {[(i, a[i], b[i]) for i in bad[:3]]}")
        else:
            out.append(f"{key}: {a!r} != golden {b!r}")
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


def audit_doc_record(doc: dict) -> dict:
    """An audit document cut to AUDIT_KEYS, the fallback flag and the
    divergence record (the fallback's own audit cut the same way)."""
    out = {k: doc[k] for k in AUDIT_KEYS + ("fallback", "divergence") if k in doc}
    if isinstance(doc.get("fallback_audit"), dict):
        out["fallback_audit"] = {k: doc["fallback_audit"][k] for k in AUDIT_KEYS
                                 if k in doc["fallback_audit"]}
    return out


def doc_record(doc: dict) -> dict:
    """A `resilience` (or `apply --faults`) JSON document without its
    timings, its audit records cut by `audit_doc_record`."""
    out = {k: v for k, v in doc.items() if k not in TIMING_KEYS}
    if isinstance(out.get("audit"), dict):
        out["audit"] = audit_doc_record(out["audit"])
    if isinstance(out.get("resilience"), dict):
        out["resilience"] = doc_record(out["resilience"])
    return out


def placed_digest(nodes) -> str:
    """sha256 of a base placement's [P] landing-node vector."""
    return _array_digest(nodes)


#: the fault sweeps of chip_smoke.py phases 8-11 and their golden records,
#: written by tests/test_torch_golden.py --write --faults-only from the JAX
#: package on the CPU
FAULT_GOLDEN = DATA / "torch_serial_faults.json.gz"
FAULT_ZONE_SPEC = "zone"
FAULT_K1_SPEC = "k=1"
BULK_FAULT_SPEC = "k=2:256"
BULK_FAULT_GOLDEN = DATA / "torch_bulk_faults.json.gz"
#: the batched capacity sweep's candidates whose failure counts the golden
#: record keeps (each candidate's row is independent of the others)
CAP_SWEEP_CANDIDATES = (0, 21, 42, 43, 64, 99)
CAP_RESIL_SPEC = "k=2:64"
CAP_FAULT_GOLDEN = DATA / "torch_capacity_faults.json.gz"


def run_cli_json(main, argv) -> tuple:
    """(exit code, the JSON document on the last line of stdout) of a CLI
    `main(argv)` run with --json."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


class capture_sweeps:
    """Context manager: while it is open, `module.sweep_scenarios` (a
    package's `faults` module) also records each (PlacedCluster,
    SweepResult) it returns into the list the manager yields."""

    def __init__(self, module):
        self.module = module
        self.orig = module.sweep_scenarios
        self.got = []

    def __enter__(self):
        def recording(pc, scenarios, *a, **kw):
            out = self.orig(pc, scenarios, *a, **kw)
            self.got.append((pc, out))
            return out

        self.module.sweep_scenarios = recording
        return self.got

    def __exit__(self, *exc):
        self.module.sweep_scenarios = self.orig
        return False


#: the decision-observability records of chip_smoke.py phases 12 and 13
#: (`tests/test_torch_golden.py compute_explain_golden`): the extended
#: problem's `simulate(explain=True)`, the bulk problem's breakdown, score
#: attribution of EXPLAIN_SCORES pods on the serial smoke config, the
#: capacity problem's plan capped at EXPLAIN_MAX_NEW nodes, and the
#: mutation-kill counters
EXPLAIN_GOLDEN = DATA / "torch_explain.json.gz"
EXPLAIN_SCORES = 8
EXPLAIN_MAX_NEW = 20
#: the attribution's tolerances: raw terms to rtol/atol (they follow the
#: standalone plugin functions, whose last bits XLA's fusion may move);
#: margins to two f32 ulps at scores below 2048 (the JAX package's own
#: evaluation may sit one ulp off the engine's score)
TERMS_RTOL, TERMS_ATOL, MARGIN_ATOL = 1e-6, 1e-5, 2.5e-4


def explain_doc_record(doc: dict) -> dict:
    """An explain document (or any document holding one) without what the
    port records differently — the pass's `mode` — and the `wall_s`
    timings."""
    doc = json.loads(json.dumps(doc))

    def walk(d):
        if isinstance(d, dict):
            d.pop("mode", None)
            d.pop("wall_s", None)
            for v in d.values():
                walk(v)
        elif isinstance(d, list):
            for v in d:
                walk(v)

    walk(doc)
    return doc


def breakdown_record(bd, nodes) -> dict:
    """A FailureBreakdown (either package's) of a placement's unplaced pods
    as digests of its rows, per-stage counts, feasible counts, witnesses
    and fail codes, with the placement's digest."""
    return {"unplaced": int(len(bd.rows)), "base": placed_digest(nodes),
            **{k: _array_digest(getattr(bd, k)) for k in ("rows", "counts", "feasible", "witnesses",
                                                           "fail_code")}}


def _close(a, b, rtol: float, atol: float) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= atol + rtol * abs(b)


def explain_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two explain documents (empty =
    equal): equal apart from `mode` and the timings, and — in a `scores`
    list — pod, row, node, winner, runner-up, consistent, plugins and
    weights exactly, margins and raw terms to the stated tolerances."""
    got, want = explain_doc_record(got), explain_doc_record(want)
    gs, ws = got.pop("scores", None), want.pop("scores", None)
    out = [] if got == want else [f"document {json.dumps(got)[:400]} != golden {json.dumps(want)[:400]}"]
    if (gs is None) != (ws is None) or (gs is not None and len(gs) != len(ws)):
        out.append(f"scores: {gs!r} != golden {ws!r}")
        gs = ws = None
    for a, b in zip(gs or (), ws or ()):
        exact = ("pod", "row", "node", "winner", "runner_up", "consistent")
        if any(a[k] != b[k] for k in exact) or not _close(a["margin"], b["margin"], TERMS_RTOL, MARGIN_ATOL):
            out.append(f"score of {b['pod']}: {[a[k] for k in exact + ('margin',)]} != golden "
                       f"{[b[k] for k in exact + ('margin',)]}")
            continue
        for ta, tb in zip(a["terms"], b["terms"]):
            if (ta["plugin"], ta["weight"]) != (tb["plugin"], tb["weight"]) or not all(
                    _close(ta[k], tb[k], TERMS_RTOL, TERMS_ATOL if k != "delta" else MARGIN_ATOL)
                    for k in ("winner_raw", "runner_up_raw", "delta")):
                out.append(f"term of {b['pod']}: {ta} != golden {tb}")
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


#: the solver paths of chip_smoke.py phase 14 and their golden record
#: (`tests/test_torch_golden.py compute_solve_golden`): `apply --solver
#: --json` on the capacity and the large capacity configs, and `resilience
#: --plan --faults CAP_RESIL_SPEC --seed 0 --solver --json` on the capacity
#: config (the relax-only lower bound), each with the relaxation's
#: per-candidate residuals, the fractional assignments the planner fetched
#: and the rounded counts
SOLVE_GOLDEN = DATA / "torch_solve.json.gz"
#: projected-gradient iterations of every relaxation on those paths
SOLVE_ITERS = 400
#: the relaxation's tolerances against the JAX package and between a
#: kernel and its plain version: y (scaled units) and the residual, absolute
SOLVE_Y_ATOL, SOLVE_RES_ATOL = 1e-4, 1e-5


def pack_array(arr) -> dict:
    """A numpy array as plain data: dtype, shape and its bytes, zlib'd and
    base64'd (little-endian), with a sha256 of the bytes."""
    import base64
    import zlib

    import numpy as np

    a = np.ascontiguousarray(arr)
    a = a.astype(a.dtype.newbyteorder("<"))
    raw = a.tobytes()
    return {"dtype": a.dtype.str, "shape": list(a.shape), "sha256": hashlib.sha256(raw).hexdigest(),
            "data": base64.b64encode(zlib.compress(raw, 9)).decode()}


def unpack_array(rec: dict):
    """The numpy array `pack_array` recorded."""
    import base64
    import zlib

    import numpy as np

    raw = zlib.decompress(base64.b64decode(rec["data"]))
    return np.frombuffer(raw, dtype=np.dtype(rec["dtype"])).reshape(rec["shape"])


class record_solver:
    """Context manager: while it is open, a package's `solve.planner`
    module records each relaxation it runs (the problem's sizes, step and
    per-candidate residuals), each fractional assignment it fetches (by
    candidate) and each rounding (the counts `m`, or the reason it failed)
    into the dict the manager yields."""

    def __init__(self, planner):
        self.planner = planner
        self.orig = (planner.relax_candidates, planner.fetch_y, planner.round_candidate)
        self.got = {"relax": [], "y": {}, "round": []}

    def __enter__(self):
        import numpy as np

        relax0, fetch0, round0 = self.orig

        def relax(prob, valid_s, *a, **kw):
            v = relax0(prob, valid_s, *a, **kw)
            self.got["relax"].append({
                "s": int(len(v.residual)), "c": int(v.c), "n": int(v.n), "r": int(prob.cap.shape[1]),
                "lr": float(np.float32(prob.lr)), "cnt": [int(x) for x in prob.cnt],
                "residual": [float(x) for x in np.asarray(v.residual)]})
            return v

        def fetch(verd, s):
            y = fetch0(verd, s)
            self.got["y"][str(int(s))] = pack_array(np.asarray(y, np.float32))
            return y

        def rounding(prob, y, valid):
            m, why = round0(prob, y, valid)
            self.got["round"].append({"m": None if m is None else pack_array(np.asarray(m, np.int64)),
                                      "why": why})
            return m, why

        self.planner.relax_candidates, self.planner.fetch_y, self.planner.round_candidate = (
            relax, fetch, rounding)
        return self.got

    def __exit__(self, *exc):
        self.planner.relax_candidates, self.planner.fetch_y, self.planner.round_candidate = self.orig
        return False


class capture_plans:
    """Context manager: while it is open, a package's `plan.capacity`
    `Applier.run` also records each PlanResult it returns into the list
    the manager yields."""

    def __init__(self, module):
        self.cls = module.Applier
        self.orig = module.Applier.run
        self.got = []

    def __enter__(self):
        orig = self.orig

        def recording(applier, *a, **kw):
            out = orig(applier, *a, **kw)
            self.got.append(out)
            return out

        self.cls.run = recording
        return self.got

    def __exit__(self, *exc):
        self.cls.run = self.orig
        return False


def _without_wall(doc):
    return {k: v for k, v in doc.items() if k != "wall_s"} if isinstance(doc, dict) else doc


def solve_doc_record(doc: dict) -> dict:
    """A solver run's `--json` document as the packages share it: for
    `apply`, the verdict, probes and unscheduled count with the engine's
    search, bulk, `solve` (without `wall_s`), `audit` (cut by
    `audit_doc_record`) and `grow` records; for `resilience`, `doc_record`
    with its `solve` record without `wall_s`."""
    if "engine" not in doc:
        out = doc_record(doc)
        if "solve" in out:
            out["solve"] = _without_wall(out["solve"])
        return out
    eng = doc["engine"]
    out = {k: doc.get(k) for k in ("success", "nodes_added", "message", "partial", "probes", "unscheduled")}
    out["engine"] = {"search": eng.get("search"), "bulk": eng.get("bulk"),
                     "solve": _without_wall(eng.get("solve")),
                     "audit": audit_doc_record(eng.get("audit") or {}), "grow": eng.get("grow")}
    return out


def plan_digest(plan) -> dict:
    """A PlanResult's winning placement as counts and a sha256 of its
    placement record (None when the plan carries no result)."""
    if plan.result is None:
        return {"placed": None, "failed": None, "digest": None}
    rec = placement_record(plan.result)
    return {"placed": len(rec["placed"]), "failed": len(rec["failed"]),
            "digest": _digest(sorted((k, json.dumps(v, sort_keys=True)) for k, v in rec.items()))}


#: the grow problem of chip_smoke.py phase 15 and its golden record
#: (`tests/test_torch_golden.py compute_grow_golden`): the serial smoke
#: problem's 200 Deployments cut at GROW_CUTS into four waves (122, 249,
#: 377 and 501 terms: the second wave promotes the 128-term bucket to 256,
#: the third crosses 256 into 512), placed wave by wave on one grow-mode
#: engine, with GROW_CLONES clones of the capacity template joining the
#: node axis before the last wave
GROW_GOLDEN = DATA / "torch_grow.json.gz"
GROW_CUTS = (50, 100, 150)
GROW_CLONES = 2


def grow_problem(synth, app_cls, resources_cls):
    """(cluster, waves, template) of the grow problem from a package's own
    synth module, AppResource and ResourceTypes: each wave one app named
    like the serial smoke app, holding its slice of the Deployments."""
    cluster, apps = smoke_problem(synth.synth_cluster, synth.synth_apps)
    (app,) = apps
    deps = app.resource.deployments
    cuts = (0,) + GROW_CUTS + (len(deps),)
    waves = [app_cls(name=app.name, resource=resources_cls(deployments=deps[a:b]))
             for a, b in zip(cuts[:-1], cuts[1:])]
    return cluster, waves, template_node(synth)


def run_grow(pkg, make_engine, grow: bool = True) -> dict:
    """Place the grow problem wave by wave with a package (`pkg`, the
    simtpu or simtpu_torch module) on the engine `make_engine(tensorizer)`
    returns (in grow mode when `grow`), growing the node axis by
    GROW_CLONES template clones before the last wave. Returns
    {"nodes": per-wave landing nodes, "state": the final dense carried
    state's planes as numpy arrays, "engine": the engine}."""
    import importlib

    import numpy as np

    mod = {name: importlib.import_module(f"{pkg.__name__}.{name}")
           for name in ("synth", "api", "constants", "core.objects", "workloads.expand", "parallel.sweep",
                        "plan.capacity", "engine.state")}
    cluster, waves, template = grow_problem(mod["synth"], pkg.AppResource, pkg.ResourceTypes)

    def expand(app, nodes):
        pods = mod["workloads.expand"].get_valid_pods_exclude_daemonset(app.resource)
        for ds in app.resource.daemon_sets:
            pods.extend(mod["workloads.expand"].make_valid_pods_by_daemonset(ds, nodes))
        for pod in pods:
            mod["core.objects"].set_label(pod, mod["constants"].LABEL_APP_NAME, app.name)
        return mod["api"]._sort_app_pods(pods)

    tz, all_nodes, _nb, ordered = mod["parallel.sweep"].assemble_planning_problem(cluster, [waves[0]], template, 0)
    eng = make_engine(tz)
    if grow:
        eng.enable_grow()
    nodes = [np.asarray(eng.place(tz.add_pods(ordered))[0])]
    for i, wave in enumerate(waves[1:], 1):
        if i == len(waves) - 1:
            clones = mod["plan.capacity"].new_fake_nodes(template, GROW_CLONES)
            tz.add_clone_nodes(clones)
            all_nodes = all_nodes + clones
            if grow and not eng.grow_nodes():
                raise AssertionError("grow_nodes() refused to extend the carry")
        nodes.append(np.asarray(eng.place(tz.add_pods(expand(wave, all_nodes)))[0]))
    state = mod["engine.state"].ensure_dense(eng.carried_state(), tz.freeze())
    planes = {}
    for name in state._fields:
        x = getattr(state, name)
        planes[name] = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return {"nodes": nodes, "state": planes, "engine": eng}


def grow_record(run: dict, counts: dict) -> dict:
    """A grow run as plain data: per wave the pod count, placed count and a
    sha256 of the landing nodes; per final plane its shape, dtype and a
    sha256 of its bytes; and the grow counts the run added."""
    def plane(x):
        return {"shape": list(x.shape), "dtype": str(x.dtype),
                "sha256": hashlib.sha256(x.tobytes()).hexdigest()}

    return {"waves": [{"pods": int(len(n)), "placed": int((n >= 0).sum()), "digest": _array_digest(n)}
                      for n in run["nodes"]],
            "planes": {name: plane(x) for name, x in run["state"].items()},
            "grow": {k: int(v) for k, v in sorted(counts.items())}}


def grow_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two grow records (empty = equal)."""
    out = [f"wave {i}: {a} != golden {b}" for i, (a, b) in enumerate(zip(got["waves"], want["waves"])) if a != b]
    out += [f"plane {k}: {got['planes'].get(k)} != golden {v}" for k, v in want["planes"].items()
            if got["planes"].get(k) != v]
    if got["grow"] != want["grow"]:
        out.append(f"grow counts {got['grow']} != golden {want['grow']}")
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


def save_record(record: dict, path: Path = GOLDEN) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8", compresslevel=9) as f:
        json.dump(record, f, separators=(",", ":"), sort_keys=True)


def load_record(path: Path = GOLDEN) -> dict:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)
