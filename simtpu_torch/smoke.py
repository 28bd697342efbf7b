"""The serial smoke problem: one definition for the golden file, the tests
and `chip_smoke.py`.

1000 nodes × 10 000 pods: `bench.py build_problem`'s "hard" constraint mix
(zone spread, half of it DoNotSchedule; preferred and required pod
anti-affinity; node selectors; tolerations) without Open-Local storage or
GPU-share pods, at the top of the serial path's range (under 1024 nodes
and 16 384 pods). Pod-name suffixes are seeded (`seed_name_hashes`), so a
placement record keyed by pod name compares across runs and packages.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

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
#: placements and reasons of the JAX package's simtpu.simulate on the CPU
#: (written by tests/test_torch_golden.py)
GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "data" / "torch_serial_smoke.json.gz"


def smoke_problem(synth_cluster, synth_apps, n_nodes=N_NODES, n_pods=N_PODS):
    """(cluster, apps) from a package's own synth module functions."""
    return synth_cluster(n_nodes, **CLUSTER_KW), synth_apps(n_pods, **APPS_KW)


def _key(pod: dict) -> str:
    meta = pod["metadata"]
    return f"{meta.get('namespace', '')}/{meta['name']}"


def placement_record(result) -> dict:
    """{"nodes": node names, "placed": {pod: node index}, "failed": {pod:
    reason string}} of a SimulateResult (either package's)."""
    nodes = [st.node["metadata"]["name"] for st in result.node_status]
    placed = {
        _key(pod): i for i, st in enumerate(result.node_status) for pod in st.pods
    }
    failed = {_key(u.pod): u.reason for u in result.unscheduled_pods}
    return {"nodes": nodes, "placed": dict(sorted(placed.items())), "failed": dict(sorted(failed.items()))}


def record_differences(got: dict, want: dict, limit: int = 5) -> list:
    """Human-readable differences between two placement records (empty =
    identical): node list, every pod's node, every failed pod's reason."""
    out = []
    if got["nodes"] != want["nodes"]:
        out.append("node lists differ")
    for field in ("placed", "failed"):
        for pod in sorted(set(got[field]) | set(want[field])):
            a, b = got[field].get(pod), want[field].get(pod)
            if a != b:
                out.append(f"{field} {pod}: {a!r} != golden {b!r}")
    return out[:limit] + ([f"... {len(out) - limit} more"] if len(out) > limit else [])


def save_record(record: dict, path: Path = GOLDEN) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8", compresslevel=9) as f:
        json.dump(record, f, separators=(",", ":"), sort_keys=True)


def load_record(path: Path = GOLDEN) -> dict:
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)
