"""Workload → Pod expansion (kube-controller-manager emulation).

Host-side pass that turns every workload kind into the concrete pods the
scheduler will see, mirroring `pkg/utils/utils.go:133-497`:

- Deployment → synthetic ReplicaSet → pods (`utils.go:133-136,185-195`)
- ReplicaSet / ReplicationController → pods, replicas default 1 (`:138-183`)
- CronJob → synthetic Job → pods (`:197-241`)
- Job → pods, completions default 1 (`:202-227`)
- StatefulSet → pods named `{name}-{ordinal}` with local-storage annotations
  from volumeClaimTemplates (`:243-316`)
- DaemonSet → one pod per matching node, pinned via a `metadata.name`
  MatchFields node-affinity term (`:356-395,861-906`)

Pod metadata comes from the *owner's* metadata (labels/annotations of the
workload object, not the pod template — `SetObjectMetaFromObject`,
`utils.go:318-347`), with a random hash suffix on the name.
"""

from __future__ import annotations

import contextlib
import json
import random
import re
from typing import List, Optional

from .. import constants as C
from ..core.match import node_should_run_pod
from ..core.objects import (
    ResourceTypes,
    annotations_of,
    deep_copy,
    ensure_meta,
    labels_of,
    name_of,
    namespace_of,
    set_annotation,
)
from ..core.quantity import parse_quantity
from .validate import SpecError, ValidationError, validate_node, validate_pod

_rng = random.Random()


@contextlib.contextmanager
def spec_context(kind: str, obj: dict):
    """Attach ingest context to spec failures raised while expanding one
    workload (docs/robustness.md, structured ingest diagnostics).

    A `SpecError` raised deeper (it knows the field path, not the
    workload) gains the kind/name/source-file; a plain ValidationError or
    ValueError (bad quantity in a storage template, malformed JSON
    annotation...) is wrapped whole.  The result renders as ONE
    actionable line in `simtpu apply` instead of a mid-tensorize
    traceback."""
    name = f"{namespace_of(obj)}/{name_of(obj)}"
    source = obj.get(SOURCE_KEY)
    try:
        yield
    except SpecError as exc:
        raise exc.attach(source=source, kind=kind, name=name)
    except (ValidationError, ValueError) as exc:
        raise SpecError(
            str(exc), source=source, kind=kind, name=name
        ) from exc


#: top-level key the YAML loader stamps each decoded object with so spec
#: diagnostics can name the manifest file; never part of the k8s object
#: model, and nothing downstream iterates top-level keys
SOURCE_KEY = "__simtpu_source__"


def seed_name_hashes(seed: Optional[int]) -> None:
    """Make generated pod-name suffixes reproducible (tests, planner sweeps)."""
    global _rng
    _rng = random.Random(seed)


class _RecordingRandom(random.Random):
    """RNG stand-in that notes the bit width of every draw (the widths
    vary: workload-level suffixes are longer than pod-level ones)."""

    def __init__(self):
        super().__init__(0)
        self.widths = []

    def getrandbits(self, k: int) -> int:
        self.widths.append(k)
        return super().getrandbits(k)


def record_name_draws(fn) -> tuple:
    """Run `fn` (an expansion) against a throwaway recording RNG and
    return the bit widths of every name-suffix draw it made.  The draw
    STRUCTURE is deterministic — it depends on the workload tree, never
    on the drawn values — so the recording replays exactly via
    `advance_name_stream` under any seed.  The caller's stream is
    untouched (restored on exit)."""
    global _rng
    prev = _rng
    rec = _RecordingRandom()
    _rng = rec
    try:
        fn()
    finally:
        _rng = prev
    return tuple(rec.widths)


def advance_name_stream(widths) -> None:
    """Fast-forward the current name stream past `widths` (a
    `record_name_draws` recording) without expanding anything — the
    warm serve path's replacement for re-expanding the session base
    before each query app (serve/batching.py)."""
    for k in widths:
        _rng.getrandbits(k)


def _hash_suffix(digits: int) -> str:
    """Random hex suffix, shaped like the reference's sha256-of-random-token
    prefix (`utils.GetSHA256HashCode`, utils.go:531-536). Drawn directly from
    the RNG: hashing a 10-char random token per pod was ~90% of million-pod
    expansion time, and the hash of a random token is just a random hex
    string — same alphabet, same length, same independence."""
    return "%0*x" % (digits, _rng.getrandbits(digits * 4))


def _object_meta_from_owner(owner: dict, owner_kind: str, gen_pod: bool) -> dict:
    """Pod/workload metadata derived from its owner (`utils.go:318-347`)."""
    digits = C.POD_HASH_DIGITS if gen_pod else C.WORKLOAD_HASH_DIGITS
    m = {
        "name": f"{name_of(owner)}{C.SEPARATE_SYMBOL}{_hash_suffix(digits)}",
        "namespace": namespace_of(owner),
        "generateName": name_of(owner),
        "ownerReferences": [
            {
                "kind": owner_kind,
                "name": name_of(owner),
                "controller": True,
            }
        ],
    }
    if labels_of(owner):
        m["labels"] = dict(labels_of(owner))
    if annotations_of(owner):
        m["annotations"] = dict(annotations_of(owner))
    return m


def _pod_from_template(owner: dict, owner_kind: str) -> dict:
    spec = deep_copy(((owner.get("spec") or {}).get("template") or {}).get("spec") or {})
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": _object_meta_from_owner(owner, owner_kind, gen_pod=True),
        "spec": spec,
    }


def make_valid_pod(pod: dict) -> dict:
    """Normalize a pod the way the reference does (`utils.go:407-489`).

    Defaults namespace/DNSPolicy/RestartPolicy/SchedulerName, strips probes,
    env, volume mounts and image-pull secrets (irrelevant to scheduling),
    converts PVC volumes to hostPath, then validates.
    """
    pod = deep_copy(pod)
    pod.pop(SOURCE_KEY, None)  # ingest-only provenance, not pod model
    m = ensure_meta(pod)
    m.setdefault("labels", {})
    m.setdefault("annotations", {})
    if not m.get("namespace"):
        m["namespace"] = "default"
    spec = pod.setdefault("spec", {})
    spec.setdefault("dnsPolicy", "ClusterFirst")
    spec.setdefault("restartPolicy", "Always")
    if not spec.get("schedulerName"):
        spec["schedulerName"] = C.DEFAULT_SCHEDULER_NAME
    spec.pop("imagePullSecrets", None)
    for clist in ("initContainers", "containers"):
        for c in spec.get(clist) or []:
            c.setdefault("terminationMessagePolicy", "FallbackToLogsOnError")
            c.setdefault("imagePullPolicy", "IfNotPresent")
            c.pop("volumeMounts", None)
            c.pop("env", None)
            c.pop("livenessProbe", None)
            c.pop("readinessProbe", None)
            c.pop("startupProbe", None)
    for vol in spec.get("volumes") or []:
        if "persistentVolumeClaim" in vol:
            vol.pop("persistentVolumeClaim")
            vol["hostPath"] = {"path": "/tmp"}
    validate_pod(pod)
    return pod


def add_workload_info(pod: dict, kind: str, name: str, namespace: str) -> dict:
    """Annotate the pod with its source workload (`utils.go:492-497`)."""
    set_annotation(pod, C.ANNO_WORKLOAD_KIND, kind)
    set_annotation(pod, C.ANNO_WORKLOAD_NAME, name)
    set_annotation(pod, C.ANNO_WORKLOAD_NAMESPACE, namespace)
    return pod


def _replicas(obj: dict, field: str = "replicas", default: int = 1) -> int:
    val = (obj.get("spec") or {}).get(field)
    return default if val is None else int(val)


def _clone_pod(proto: dict, name: str) -> dict:
    """Cheap per-replica instance of a normalized prototype pod.

    Replicas of one workload share their (immutable after normalization)
    nested spec structure — containers, tolerations, selectors — and get
    fresh metadata plus a fresh top-level spec dict (placement recording sets
    `spec.nodeName` per pod). This replaces a per-replica deep copy, which
    dominated expansion time at 100k+ pods.
    """
    m = proto["metadata"]
    meta = dict(m)
    meta["name"] = name
    meta["labels"] = dict(m.get("labels") or {})
    meta["annotations"] = dict(m.get("annotations") or {})
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": dict(proto["spec"]),
    }


def _prototype(owner: dict, owner_kind: str) -> dict:
    """Normalize + annotate one pod for the workload; replicas clone it."""
    pod = make_valid_pod(_pod_from_template(owner, owner_kind))
    return add_workload_info(pod, owner_kind, name_of(owner), namespace_of(owner))


def _expand_run(owner: dict, kind: str, count: int) -> List[dict]:
    """`count` clones of the owner's normalized prototype, hash-named."""
    proto = _prototype(owner, kind)
    base = name_of(owner)
    return [
        _clone_pod(proto, f"{base}{C.SEPARATE_SYMBOL}{_hash_suffix(C.POD_HASH_DIGITS)}")
        for _ in range(count)
    ]


def make_valid_pods_by_replica_set(rs: dict) -> List[dict]:
    return _expand_run(rs, C.KIND_RS, _replicas(rs))


def generate_replica_set_from_deployment(deploy: dict) -> dict:
    """Deployment → its ReplicaSet (`utils.go:185-195`)."""
    return {
        "apiVersion": "apps/v1",
        "kind": "ReplicaSet",
        "metadata": _object_meta_from_owner(deploy, C.KIND_DEPLOYMENT, gen_pod=False),
        "spec": {
            "selector": (deploy.get("spec") or {}).get("selector"),
            "replicas": _replicas(deploy),
            "template": (deploy.get("spec") or {}).get("template"),
        },
    }


def make_valid_pods_by_deployment(deploy: dict) -> List[dict]:
    return make_valid_pods_by_replica_set(generate_replica_set_from_deployment(deploy))


def make_valid_pods_by_replication_controller(rc: dict) -> List[dict]:
    return _expand_run(rc, C.KIND_RC, _replicas(rc))


def make_valid_pods_by_job(job: dict) -> List[dict]:
    return _expand_run(job, C.KIND_JOB, _replicas(job, "completions"))


def generate_job_from_cron_job(cronjob: dict) -> dict:
    """CronJob → one Job instance (`utils.go:229-241`).

    Job metadata (incl. annotations) comes from the CronJob's own metadata via
    SetObjectMetaFromObject — the reference builds an `instantiate=manual`
    annotation map at `utils.go:230-234` but never attaches it, so we mirror
    the observable behavior and attach nothing extra.
    """
    job_template = (cronjob.get("spec") or {}).get("jobTemplate") or {}
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": _object_meta_from_owner(cronjob, C.KIND_CRON_JOB, gen_pod=False),
        "spec": deep_copy(job_template.get("spec") or {}),
    }


def make_valid_pods_by_cron_job(cronjob: dict) -> List[dict]:
    """Static CronJob expansion: one Job instance, UNLESS the CronJob is
    suspended (`spec.suspend: true` — the controller creates no Jobs while
    set, so the static snapshot must not schedule one either; the old
    behavior emitted a Job regardless, ISSUE 15 satellite).  The schedule
    is validated through the shared cron parser (`workloads/cron.py`) —
    the same grammar the timeline's firing generator walks, so a spec the
    static path accepts can never blow up mid-replay."""
    from .cron import cron_job_schedule, cron_job_suspended

    if (cronjob.get("spec") or {}).get("schedule") is not None:
        cron_job_schedule(cronjob)  # SpecError (one line) on malformed
    if cron_job_suspended(cronjob):
        return []
    return make_valid_pods_by_job(generate_job_from_cron_job(cronjob))


def make_valid_pods_by_stateful_set(sts: dict) -> List[dict]:
    """STS pods are named `{sts}-{ordinal}` and carry the volume-claim storage
    annotation (`utils.go:243-316`)."""
    proto = _prototype(sts, C.KIND_STS)
    pods = [
        _clone_pod(proto, f"{name_of(sts)}-{ordinal}")
        for ordinal in range(_replicas(sts))
    ]
    set_storage_annotation_on_pods(
        pods, (sts.get("spec") or {}).get("volumeClaimTemplates") or [], name_of(sts)
    )
    return pods


def set_storage_annotation_on_pods(pods: List[dict], vcts: List[dict], sts_name: str) -> None:
    """Translate volumeClaimTemplates into the `simon/pod-local-storage`
    annotation (`utils.go:273-316`). Unrecognized storage classes are skipped."""
    volumes = []
    for pvc in vcts:
        sc = (pvc.get("spec") or {}).get("storageClassName")
        if sc is None:
            continue
        size = parse_quantity(
            (((pvc.get("spec") or {}).get("resources") or {}).get("requests") or {}).get("storage")
        )
        if sc in C.SC_LVM:
            kind = "LVM"
        elif sc in C.SC_DEVICE_SSD:
            kind = "SSD"
        elif sc in C.SC_DEVICE_HDD:
            kind = "HDD"
        else:
            continue
        volumes.append({"size": str(int(size)), "kind": kind, "scName": sc})
    payload = json.dumps({"volumes": volumes})
    for pod in pods:
        set_annotation(pod, C.ANNO_POD_LOCAL_STORAGE, payload)


def set_daemonset_node_affinity(pod: dict, node_name: str) -> None:
    """Pin a daemon pod to its node via a `metadata.name` MatchFields term
    (`utils.go:861-906`), replacing any existing required terms' fields."""
    req = {"key": "metadata.name", "operator": "In", "values": [node_name]}
    spec = pod.setdefault("spec", {})
    affinity = spec.setdefault("affinity", {})
    node_aff = affinity.setdefault("nodeAffinity", {})
    required = node_aff.get("requiredDuringSchedulingIgnoredDuringExecution")
    if not required or not required.get("nodeSelectorTerms"):
        node_aff["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": [{"matchFields": [req]}]
        }
        return
    for term in required["nodeSelectorTerms"]:
        term["matchFields"] = [req]


def _pin_daemon_clone(proto: dict, node_name: str) -> dict:
    """Clone the DaemonSet prototype and pin it to one node: the affinity
    subtree is the only per-node spec difference, so it alone is deep-copied."""
    pod = _clone_pod(
        proto,
        f"{proto['metadata']['generateName']}{C.SEPARATE_SYMBOL}"
        f"{_hash_suffix(C.POD_HASH_DIGITS)}",
    )
    if "affinity" in pod["spec"]:
        pod["spec"]["affinity"] = deep_copy(pod["spec"]["affinity"])
    set_daemonset_node_affinity(pod, node_name)
    return pod


def new_daemon_pod(ds: dict, node_name: str) -> dict:
    """One DaemonSet pod pinned to node_name (`utils.go:372-385`)."""
    return _pin_daemon_clone(_prototype(ds, C.KIND_DS), node_name)


def make_valid_pods_by_daemonset(ds: dict, nodes: List[dict]) -> List[dict]:
    """One pod per node that should run it (`utils.go:356-370`)."""
    with spec_context(C.KIND_DS, ds):
        proto = _prototype(ds, C.KIND_DS)
    pods = []
    for node in nodes:
        pod = _pin_daemon_clone(proto, name_of(node))
        if node_should_run_pod(node, pod):
            pods.append(pod)
    return pods


def make_valid_pod_by_pod(pod: dict) -> dict:
    return make_valid_pod(pod)


def make_valid_node_by_node(node: dict, node_name: str) -> dict:
    """Clone a template node under a new hostname (`utils.go:499-513`)."""
    node = deep_copy(node)
    ensure_meta(node)["name"] = node_name
    ensure_meta(node).setdefault("labels", {})[C.LABEL_HOSTNAME] = node_name
    ensure_meta(node).setdefault("annotations", {})
    validate_node(node)
    return node


def check_duplicate_workloads(resources: ResourceTypes) -> None:
    """Reject duplicate workload names within one ingest at VALIDATE time.

    Two Deployments both named `foo` (one ResourceTypes — e.g. two files
    under the same app directory) would silently shadow each other during
    tensorize: both expand, their pods land in one group vocabulary, and
    nothing downstream can tell which manifest produced which pod.  A
    `SpecError` naming BOTH source files is the actionable surface
    (docs/robustness.md, structured ingest diagnostics)."""
    seen: dict = {}
    buckets = [
        ("Pod", resources.pods),
        (C.KIND_DEPLOYMENT, resources.deployments),
        (C.KIND_RS, resources.replica_sets),
        (C.KIND_RC, resources.replication_controllers),
        (C.KIND_STS, resources.stateful_sets),
        (C.KIND_DS, resources.daemon_sets),
        (C.KIND_JOB, resources.jobs),
        (C.KIND_CRON_JOB, resources.cron_jobs),
    ]
    for kind, items in buckets:
        for item in items:
            full = f"{namespace_of(item)}/{name_of(item)}"
            src = item.get(SOURCE_KEY) or "<in-memory>"
            prev = seen.get((kind, full))
            if prev is not None:
                raise SpecError(
                    f"duplicate {kind} name within one ingest (also "
                    f"defined in {prev}); later definitions would "
                    "silently shadow during tensorize — rename one",
                    source=src,
                    kind=kind,
                    name=full,
                )
            seen[(kind, full)] = src


def get_valid_pods_exclude_daemonset(resources: ResourceTypes) -> List[dict]:
    """Expand every non-DaemonSet workload (`pkg/simulator/utils.go:111-135`).

    Order matters and matches the reference: bare pods, deployments, replica
    sets, replication controllers, stateful sets, jobs, cron jobs.
    """
    check_duplicate_workloads(resources)
    pods: List[dict] = []
    pod_src: dict = {}  # "ns/name" -> source file of the producing workload
    expanders = [
        (resources.pods, "Pod", lambda it: [make_valid_pod_by_pod(it)]),
        (resources.deployments, C.KIND_DEPLOYMENT, make_valid_pods_by_deployment),
        (resources.replica_sets, C.KIND_RS, make_valid_pods_by_replica_set),
        (
            resources.replication_controllers,
            C.KIND_RC,
            make_valid_pods_by_replication_controller,
        ),
        (resources.stateful_sets, C.KIND_STS, make_valid_pods_by_stateful_set),
        (resources.jobs, C.KIND_JOB, make_valid_pods_by_job),
        (resources.cron_jobs, C.KIND_CRON_JOB, make_valid_pods_by_cron_job),
    ]
    for items, kind, expander in expanders:
        for item in items:
            with spec_context(kind, item):
                new = expander(item)
            src = item.get(SOURCE_KEY) or "<in-memory>"
            for pod in new:
                full = f"{namespace_of(pod)}/{name_of(pod)}"
                prev = pod_src.get(full)
                if prev is not None:
                    # only names that really came from the random-suffix
                    # scheme (`<generateName>-<POD_HASH_DIGITS hex>`) may
                    # re-draw: STS ordinal pods also CARRY generateName
                    # but are named `{name}-{ordinal}` deterministically —
                    # renaming one would break the ordinal identity its
                    # volume claims were computed against
                    gen = (pod.get("metadata") or {}).get("generateName")
                    if gen and not re.fullmatch(
                        re.escape(f"{gen}{C.SEPARATE_SYMBOL}")
                        + f"[0-9a-f]{{{C.POD_HASH_DIGITS}}}",
                        name_of(pod),
                    ):
                        gen = None
                    if not gen:
                        # explicitly-named pods (bare Pods, STS ordinals)
                        # colliding is a spec bug — shadowing during
                        # tensorize would silently drop one
                        raise SpecError(
                            "pod name collides within one ingest (a pod "
                            f"of the same name comes from {prev}); "
                            "rename one of the workloads",
                            source=src,
                            kind=kind,
                            name=f"{namespace_of(item)}/{name_of(item)}",
                            field=f"pod {full}",
                        )
                    # random-suffix collision on a GENERATED name — a
                    # birthday certainty at million-pod scale (5 hex
                    # digits per owner), not a user error: re-draw from
                    # the same deterministic stream until unique, so
                    # nothing downstream (preemption keys, audit logs,
                    # checkpoints) ever sees two pods shadowing one name
                    while full in pod_src:
                        pod["metadata"]["name"] = (
                            f"{gen}{C.SEPARATE_SYMBOL}"
                            f"{_hash_suffix(C.POD_HASH_DIGITS)}"
                        )
                        full = f"{namespace_of(pod)}/{name_of(pod)}"
                pod_src[full] = src
            pods.extend(new)
    return pods
