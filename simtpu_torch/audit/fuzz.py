"""Differential fuzz harness, mutation-kill, and placement corruptions in
every constraint class the auditor checks.

The port of the JAX package's `simtpu/audit/fuzz.py` (`fuzz` in the CLI),
two modes, both seeded and deterministic:

- **differential** (`run_differential`): generate gnarly spec/cluster
  cases (mixed hard/soft affinity + spread + selectors + tolerations +
  GPU + Open-Local storage + host-port collisions — `gen_case` draws the
  feature mix from the seed), place each with the serial-exact baseline
  (the wavefront and the compact carry off), then replay it across the
  engine-config matrix (`engine_configs`: the wavefront, the compact
  carry, both) asserting BIT-IDENTICAL landing-node vectors and an
  audit-clean verdict on every config — the runtime check of the
  contracts the wave kernels (K9/K10) and the compact-carry kernels
  (K11-K13) inherit. A failing case shrinks (drop workloads, halve
  replicas, halve nodes — greedily, while the failure reproduces) into a
  minimal reproducer YAML under `out_dir`. The JAX matrix's injected-OOM
  backoff cell waits for the durable layer (ROADMAP queue 1 #8) and its
  GSPMD-sharded cell for multi-device (#10): asking for either raises.

- **mutation-kill** (`run_mutation_kill`): corrupt ACCEPTED placements —
  move a pod to an invalid/full node, collide a host port, double-book a
  hard-anti domain, overfill a spread domain, strand a required-affinity
  pod, forge an illegal eviction — and assert the auditor flags every one.

`_mutation_fixture`, `MUTATION_CLASSES` and `_mutate_nodes` are the
mutation helpers: a placed problem with a target for every engine-level
corruption, and the corruption of the landing-node vector for each class.
The illegal-eviction class corrupts a preemption record, not a placement,
and has no node mutation (`_mutate_nodes` returns None for it).

`BULK_CORRUPTIONS` / `corrupt` add what the bulk pass (K8) checks beyond
those classes: exclusive-volume, attach-limit, Open-Local storage and
GPU-share violations, forced and pinned entries, and a node filled exactly
(and one just past it). They corrupt the audit's inputs — the frozen
ClusterTensors and the placement-order entries (`checker._Entries`) — as
numpy, so the same corrupted inputs reach every version of the bulk pass.
`bulk_fixture` is a small placed problem with a target for each.

Every placement and audit runs on `device` (None = the CUDA card).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.objects import AppResource, PreemptedPod, ResourceTypes
from ..synth import make_deployment, make_node, synth_apps, synth_cluster

#: what the port's matrix cannot run yet, named where it refuses
NOT_PORTED_OOM = ("the injected-OOM backoff cell needs the durable layer's chunk halving "
                  "(durable/backoff.py), not ported (ROADMAP queue 1 #8)")
NOT_PORTED_SHARD = ("the sharded cell needs node-axis sharding over a device mesh, not ported "
                    "(ROADMAP queue 1 #10)")


# ---------------------------------------------------------------------------
# Case generation
# ---------------------------------------------------------------------------


def gen_case(
    seed: int, n_nodes: int = 32, n_pods: int = 160
) -> Tuple[ResourceTypes, List[AppResource], Dict[str, object]]:
    """One seeded gnarly case: cluster + apps + the drawn feature mix."""
    rng = np.random.default_rng(seed)
    mix = {
        "zones": int(rng.integers(2, 6)),
        "taint_frac": float(rng.choice([0.0, 0.1, 0.3])),
        "gpu_frac": float(rng.choice([0.0, 0.2])),
        "storage_frac": float(rng.choice([0.0, 0.2])),
        "selector_frac": float(rng.choice([0.1, 0.4])),
        "toleration_frac": float(rng.choice([0.0, 0.2])),
        "anti_affinity_frac": float(rng.choice([0.2, 0.5])),
        "anti_affinity_hard_frac": float(rng.choice([0.3, 0.8])),
        "spread_frac": float(rng.choice([0.2, 0.5])),
        "spread_hard_frac": float(rng.choice([0.3, 0.8])),
        "affinity_frac": float(rng.choice([0.0, 0.3])),
        "ports": bool(rng.random() < 0.6),
    }
    cluster = synth_cluster(
        n_nodes,
        seed=seed,
        zones=mix["zones"],
        taint_frac=mix["taint_frac"],
        gpu_frac=mix["gpu_frac"],
        storage_frac=mix["storage_frac"],
    )
    apps = synth_apps(
        n_pods,
        seed=seed + 1,
        zones=mix["zones"],
        pods_per_deployment=max(4, n_pods // 12),
        selector_frac=mix["selector_frac"],
        toleration_frac=mix["toleration_frac"],
        anti_affinity_frac=mix["anti_affinity_frac"],
        anti_affinity_hard_frac=mix["anti_affinity_hard_frac"],
        spread_frac=mix["spread_frac"],
        spread_hard_frac=mix["spread_hard_frac"],
        gpu_frac=mix["gpu_frac"] * 0.5,
        storage_frac=mix["storage_frac"] * 0.5,
        affinity_frac=mix["affinity_frac"],
    )
    if mix["ports"]:
        # host-port collision pressure: replicas of one (protocol, port)
        # pair, so the engine must spread them one per node and a corrupted
        # placement (or a diverging config) trips the audit
        port_reps = int(rng.integers(2, min(8, n_nodes)))
        apps[0].resource.deployments.append(
            make_deployment(
                "porty", port_reps, 100, 128, host_port=int(rng.integers(7000, 9000))
            )
        )
    return cluster, apps, mix


# ---------------------------------------------------------------------------
# Engine-config matrix
# ---------------------------------------------------------------------------


def engine_configs(include_shard: Optional[bool] = None) -> List[Dict]:
    """The matrix cells beyond the serial baseline. One card shows no
    mesh, so `include_shard=None` adds nothing; True raises (the sharded
    cell is not ported)."""
    if include_shard:
        raise NotImplementedError(NOT_PORTED_SHARD)
    return [
        {"name": "wavefront", "speculate": True, "compact": False},
        {"name": "compact", "speculate": False, "compact": True},
        {"name": "wavefront+compact", "speculate": True, "compact": True},
    ]


def _place_with(cluster, apps, cfg: Dict, device=None):
    """Engine-level placement of one case under one matrix cell, through
    `faults/drain.py place_cluster`; returns the `PlacedCluster`."""
    from ..engine.scan import Engine
    from ..faults.drain import place_cluster

    if cfg.get("oom"):
        raise NotImplementedError(NOT_PORTED_OOM)
    if cfg.get("shard"):
        raise NotImplementedError(NOT_PORTED_SHARD)

    def factory(tz, dev):
        eng = Engine(tz, dev)
        eng.compact = bool(cfg.get("compact"))
        return eng

    return place_cluster(
        cluster,
        apps,
        bulk=False,
        engine_factory=factory,
        speculate=bool(cfg.get("speculate")),
        device=device,
    )


@dataclass
class FuzzFailure:
    seed: int
    config: str
    kind: str  # "divergence" | "audit" | "error"
    detail: str
    reproducer: str = ""  # path of the shrunk YAML, when written


@dataclass
class FuzzResult:
    cases: int = 0
    configs_run: int = 0
    failures: List[FuzzFailure] = field(default_factory=list)
    audits_clean: int = 0

    @property
    def ok(self) -> bool:
        return not self.failures

    def counters(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "cases": self.cases,
            "configs_run": self.configs_run,
            "audits_clean": self.audits_clean,
            "failures": [
                {"seed": f.seed, "config": f.config, "kind": f.kind,
                 "detail": f.detail, "reproducer": f.reproducer}
                for f in self.failures
            ],
        }


def _check_case(cluster, apps, cells, device=None) -> Optional[Tuple[str, str, str]]:
    """Run one case across the matrix. Returns None when every config is
    bit-identical to the serial baseline and audit-clean, else (config,
    kind, detail)."""
    from .checker import audit_placement, extras_from_log

    base = _place_with(cluster, apps, {"name": "serial"}, device)
    rep = audit_placement(base.tensors, base.batch, base.nodes, extras_from_log(base), device=device)
    if not rep.ok:
        return ("serial", "audit", rep.summary())
    base_nodes = np.asarray(base.nodes)
    for cfg in cells:
        try:
            pc = _place_with(cluster, apps, cfg, device)
        except Exception as exc:  # an engine config crashing IS a finding
            return (cfg["name"], "error", f"{type(exc).__name__}: {exc}")
        if not np.array_equal(np.asarray(pc.nodes), base_nodes):
            diff = np.flatnonzero(np.asarray(pc.nodes) != base_nodes)
            return (
                cfg["name"],
                "divergence",
                f"{len(diff)} divergent pod(s), first row {int(diff[0])}",
            )
        rep = audit_placement(pc.tensors, pc.batch, pc.nodes, extras_from_log(pc), device=device)
        if not rep.ok:
            return (cfg["name"], "audit", rep.summary())
    return None


# ---------------------------------------------------------------------------
# Shrinking + reproducers
# ---------------------------------------------------------------------------


def _shrink(cluster, apps, cells, still_fails, rounds: int = 6):
    """Greedy structural shrink while the failure reproduces: drop
    deployments one at a time, halve replica counts, halve the node
    list."""
    import copy

    cur_c, cur_a = cluster, apps
    for _ in range(rounds):
        shrunk = False
        deps = cur_a[0].resource.deployments
        for i in range(len(deps) - 1, -1, -1):
            trial_a = copy.deepcopy(cur_a)
            del trial_a[0].resource.deployments[i]
            if not trial_a[0].resource.deployments:
                continue
            if still_fails(cur_c, trial_a, cells):
                cur_a, shrunk = trial_a, True
        trial_a = copy.deepcopy(cur_a)
        for d in trial_a[0].resource.deployments:
            d["spec"]["replicas"] = max(1, int(d["spec"].get("replicas", 1)) // 2)
        if still_fails(cur_c, trial_a, cells):
            cur_a, shrunk = trial_a, True
        if len(cur_c.nodes) > 2:
            trial_c = ResourceTypes(**{k: list(v) for k, v in vars(cur_c).items()})
            trial_c.nodes = list(cur_c.nodes[: max(2, len(cur_c.nodes) // 2)])
            if still_fails(trial_c, cur_a, cells):
                cur_c, shrunk = trial_c, True
        if not shrunk:
            break
    return cur_c, cur_a


def write_reproducer(cluster, apps, path: str) -> str:
    """One multi-document YAML reproducing the case (nodes, storage
    classes, workloads) — re-runnable through `fuzz --replay`."""
    import yaml

    docs: List[dict] = []
    docs.extend(cluster.nodes)
    docs.extend(cluster.storage_classes)
    for app in apps:
        docs.extend(app.resource.deployments)
        docs.extend(app.resource.pods)
        docs.extend(app.resource.daemon_sets)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump_all(docs, f, sort_keys=False)
    return path


def load_reproducer(path: str):
    """Load a `write_reproducer` YAML back into (cluster, apps): nodes and
    StorageClasses form the cluster; every workload kind lands in one
    replay app."""
    from ..io.yaml_loader import load_resources

    res = load_resources(path)
    cluster = ResourceTypes(nodes=list(res.nodes), storage_classes=list(res.storage_classes))
    work = ResourceTypes(
        pods=list(res.pods),
        deployments=list(res.deployments),
        replica_sets=list(res.replica_sets),
        replication_controllers=list(res.replication_controllers),
        stateful_sets=list(res.stateful_sets),
        daemon_sets=list(res.daemon_sets),
        jobs=list(res.jobs),
        cron_jobs=list(res.cron_jobs),
    )
    return cluster, [AppResource(name="replay", resource=work)]


def replay_case(path: str, include_shard: Optional[bool] = None,
                device=None) -> Optional[Tuple[str, str, str]]:
    """Re-run one shrunk reproducer across the engine-config matrix;
    returns None when clean, else (config, kind, detail) — the same
    contract as `_check_case`."""
    cells = engine_configs(include_shard)
    cluster, apps = load_reproducer(path)
    return _check_case(cluster, apps, cells, device)


def run_differential(
    cases: int = 16,
    seed: int = 0,
    n_nodes: int = 32,
    n_pods: int = 160,
    out_dir: str = "",
    include_shard: Optional[bool] = None,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> FuzzResult:
    """The differential fuzz loop (the module docstring)."""
    say = progress or (lambda s: None)
    cells = engine_configs(include_shard)
    result = FuzzResult(cases=cases)
    for c in range(cases):
        case_seed = seed + c * 1000
        cluster, apps, mix = gen_case(case_seed, n_nodes, n_pods)
        say(f"case {c + 1}/{cases} (seed {case_seed}): " + ", ".join(k for k, v in mix.items() if v))
        bad = _check_case(cluster, apps, cells, device)
        result.configs_run += 1 + len(cells)
        if bad is None:
            result.audits_clean += 1 + len(cells)
            continue
        config, kind, detail = bad
        failure = FuzzFailure(case_seed, config, kind, detail)
        if out_dir:
            say(f"  FAILURE ({kind} on {config}) — shrinking ...")

            def still_fails(cl, ap, cs):
                got = _check_case(cl, ap, cs, device)
                return got is not None and got[1] == kind

            s_cluster, s_apps = _shrink(cluster, apps, cells, still_fails)
            failure.reproducer = write_reproducer(
                s_cluster, s_apps,
                os.path.join(out_dir, f"fuzz_{case_seed}_{config}_{kind}.yaml"),
            )
        result.failures.append(failure)
    return result


# ---------------------------------------------------------------------------
# Mutation-kill
# ---------------------------------------------------------------------------


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


def run_mutation_kill(
    seed: int = 0,
    per_class: int = 4,
    n_nodes: int = 16,
    progress: Optional[Callable[[str], None]] = None,
    device=None,
) -> Dict[str, object]:
    """Corrupt accepted placements across every MUTATION_CLASSES entry and
    count auditor detections. The contract is 100% kill."""
    from ..faults.drain import place_cluster
    from .checker import audit_placement, extras_from_log

    say = progress or (lambda s: None)
    cluster, apps = _mutation_fixture(seed, n_nodes)
    pc = place_cluster(cluster, apps, bulk=False, device=device)
    ext = extras_from_log(pc)
    base = audit_placement(pc.tensors, pc.batch, pc.nodes, ext, device=device)
    if not base.ok:
        raise AssertionError(f"mutation fixture must start audit-clean: {base.summary()}")
    tried: Dict[str, int] = {}
    killed: Dict[str, int] = {}
    missed: List[str] = []
    for kind in MUTATION_CLASSES:
        if kind == "illegal-eviction":
            t, k = _run_eviction_mutations(seed, per_class, say, device)
            tried[kind], killed[kind] = t, k
            if k < t:
                missed.append(kind)
            continue
        tried[kind] = killed[kind] = 0
        for trial in range(per_class):
            mut = _mutate_nodes(kind, pc.tensors, pc.batch, pc.nodes, np.random.default_rng(seed + trial))
            if mut is None:
                continue
            tried[kind] += 1
            rep = audit_placement(pc.tensors, pc.batch, mut, ext, device=device)
            if not rep.ok:
                killed[kind] += 1
            else:
                missed.append(f"{kind}#{trial}")
        say(f"mutation {kind}: {killed[kind]}/{tried[kind]} killed")
    # a class whose mutator never found a target is a FIXTURE hole, not a
    # pass — it lands in `missed`, or the 100%-kill contract would shrink
    # to "100% of whatever happened to be tried"
    for kind in MUTATION_CLASSES:
        if not tried.get(kind):
            missed.append(f"{kind}#untried")
    total_t = sum(tried.values())
    total_k = sum(killed.values())
    return {
        "classes": len([k for k in tried if tried[k]]),
        "classes_total": len(MUTATION_CLASSES),
        "tried": total_t,
        "killed": total_k,
        "kill_rate": (total_k / total_t) if total_t else 1.0,
        "by_class": {k: f"{killed[k]}/{tried[k]}" for k in tried},
        "missed": missed,
    }


def _run_eviction_mutations(seed: int, per_class: int, say, device=None):
    """Preemption-legality mutations on a Simulator run that genuinely
    preempts: (a) forge a priority inversion on a reported eviction, (b)
    report an eviction whose victim is still placed."""
    from ..api import Simulator
    from ..core.objects import name_of, namespace_of
    from ..workloads.expand import get_valid_pods_exclude_daemonset
    from .checker import audit_simulation

    cluster = ResourceTypes()
    # fixed small nodes so the filler saturates the cluster and the
    # high-priority app MUST preempt
    cluster.nodes = [
        make_node(f"ev-{i}", 16000, 32, {"kubernetes.io/hostname": f"ev-{i}"})
        for i in range(4)
    ]
    filler = ResourceTypes(deployments=[make_deployment("low", 30, 2000, 1024, priority=0)])
    cluster.pods = get_valid_pods_exclude_daemonset(filler)
    apps = [
        AppResource(
            name="high",
            resource=ResourceTypes(deployments=[make_deployment("high", 6, 4000, 2048, priority=100)]),
        )
    ]
    sim = Simulator(device=device)
    sim.run_cluster(cluster)
    for app in apps:
        sim.schedule_app(app)
    if not sim._preempted:
        raise AssertionError("eviction fixture produced no preemptions")
    base = audit_simulation(sim)
    if not base.ok:
        raise AssertionError(f"eviction fixture must start audit-clean: {base.summary()}")
    tried = killed = 0
    # (a) priority inversion: claim the victim outranked its preemptor
    for pre in sim._preempted[:per_class]:
        tried += 1
        saved = pre.pod
        forged = {**saved, "spec": {**(saved.get("spec") or {}), "priority": 10_000}}
        pre.pod = forged
        rep = audit_simulation(sim)
        pre.pod = saved
        if not rep.ok and "preemption" in rep.by_class:
            killed += 1
    # (b) evicted-but-placed: report a still-placed pod as a victim
    victim = sim._scheduled[0]
    by = f"{namespace_of(sim._scheduled[-1])}/{name_of(sim._scheduled[-1])}"
    forged = PreemptedPod(pod=victim, preempted_by=by, node=victim["spec"].get("nodeName", ""))
    sim._preempted.append(forged)
    tried += 1
    rep = audit_simulation(sim)
    sim._preempted.pop()
    if not rep.ok and "preemption" in rep.by_class:
        killed += 1
    say(f"mutation illegal-eviction: {killed}/{tried} killed")
    return tried, killed


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
