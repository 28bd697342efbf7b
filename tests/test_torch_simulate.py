"""`simtpu_torch.simulate(device="cpu")` against `simtpu.simulate`.

Each case builds the same inputs twice, once with each package's own
modules (the port's are copies), seeds the pod-name suffixes identically,
and requires identical results: every pod's node, every unscheduled pod's
reason string, and the final carried state planes. SIMTPU_WAVEFRONT=0
comes from conftest (the JAX package's placements are bit-identical with
it on or off).

The cases cover preemption (priority waves), Open-Local storage and
GPU-share pods, and the repo's gpushare and local-storage examples; the
records compare preempted pods, GPU device assignments and the nodes'
extended annotations too.

Also here: the port imports neither JAX nor simtpu (nor does
chip_smoke.py), and `device=None` refuses to run without a CUDA card.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simtpu
import simtpu_torch
import simtpu_torch.api as tapi
from simtpu.engine.scan import Engine as JaxEngine
from simtpu.engine.state import diff_state_planes
from simtpu_torch.engine import state as torch_state
from simtpu_torch.engine.scan import Engine as TorchEngine
from simtpu_torch.engine.state import state_to_numpy
from simtpu_torch.smoke import APPS_KW, placement_record
from ._threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pod(name, cpu="100m", mem="64Mi", **spec):
    body = {"containers": [{"name": "c", "image": "x",
                            "resources": {"requests": {"cpu": cpu, "memory": mem}}}]}
    body.update(spec)
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "edge", "labels": {"app": name}},
            "spec": body}


def _demo(pkg):
    from importlib import import_module

    cl = import_module(f"{pkg.__name__}.io.cluster")
    yl = import_module(f"{pkg.__name__}.io.yaml_loader")
    cluster = cl.create_cluster_resource_from_cluster_config(os.path.join(REPO, "examples/cluster/demo"))
    web = yl.load_resources(os.path.join(REPO, "examples/application/web"))
    return cluster, [pkg.AppResource(name="web", resource=web)]


def _synth(pkg):
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    return synth.synth_cluster(64, zones=4), synth.synth_apps(600, **dict(APPS_KW, zones=4))


def _unschedulable(pkg):
    """12 nodes under ~420 pods: resources, spread, inter-pod, ports,
    volume, static and missing-node failures next to placements."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(12, seed=5, zones=3, taint_frac=0.3)
    apps = synth.synth_apps(
        360, seed=6, zones=3, pods_per_deployment=30, selector_frac=0.3, toleration_frac=0.2,
        anti_affinity_frac=0.4, anti_affinity_hard_frac=0.6, spread_frac=0.5, spread_hard_frac=0.7,
    )
    edge = pkg.ResourceTypes(
        deployments=[synth.make_deployment("hostport", 20, 200, 128, host_port=9000)],
        pods=[
            _pod("ghost", nodeName="no-such-node"),
            _pod("nowhere", nodeSelector={"disktype": "unobtainium"}),
        ] + [
            _pod(f"disk-{k}", volumes=[{"name": "d", "gcePersistentDisk": {"pdName": f"pd-{k % 2}"}}])
            for k in range(30)
        ],
    )
    return cluster, apps + [pkg.AppResource(name="edge", resource=edge)]


def _overload(pkg):
    """Pods that cannot fit at the priority of the placed ones: inside the
    preemption gate, so recorded failed exactly as the JAX package does."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(4, seed=1, zones=2, taint_frac=0.0)
    apps = synth.synth_apps(200, seed=2, zones=2, anti_affinity_frac=0.0, selector_frac=0.0,
                            toleration_frac=0.0)
    big = pkg.ResourceTypes(deployments=[synth.make_deployment("big", 8, 16000, 65536)])
    return cluster, apps + [pkg.AppResource(name="big", resource=big)]


def _preempt(pkg):
    """A priority app that does not fit at the priority of the placed pods:
    preemption evicts them, in waves."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(4, seed=1, zones=2, taint_frac=0.0)
    low = synth.synth_apps(200, seed=2, zones=2, anti_affinity_frac=0.0, selector_frac=0.0,
                           toleration_frac=0.0)
    high = pkg.ResourceTypes(deployments=[synth.make_deployment("vip", 8, 16000, 65536, priority=1000)])
    return cluster, low + [pkg.AppResource(name="vip", resource=high)]


def _storage(pkg):
    """Open-Local LVM (several claims) and exclusive-device pods on a
    cluster where every node has storage."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(12, seed=1, zones=2, storage_frac=1.0)
    apps = synth.synth_apps(160, seed=2, zones=2, pods_per_deployment=10, storage_frac=0.8,
                            storage_device_frac=0.4, lvm_multi_frac=0.5)
    return cluster, apps


def _gpushare(pkg):
    """GPU-share pods, one and several GPUs each, and a priority tier of
    two-GPU pods that preempts GPU users."""
    from importlib import import_module

    synth = import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(12, seed=1, zones=2, gpu_frac=1.0)
    apps = synth.synth_apps(200, seed=2, zones=2, pods_per_deployment=10, gpu_frac=0.8,
                            gpu_multi_frac=0.5)
    tier = pkg.ResourceTypes(deployments=[
        synth.make_deployment("vip", 16, 500, 512, gpu_mem_mib=16384, gpu_count=2, priority=100)])
    return cluster, apps + [pkg.AppResource(name="tier", resource=tier)]


def _example(cluster_dir, app_dir, name, extended):
    def build(pkg):
        from importlib import import_module

        cl = import_module(f"{pkg.__name__}.io.cluster")
        yl = import_module(f"{pkg.__name__}.io.yaml_loader")
        cluster = cl.create_cluster_resource_from_cluster_config(os.path.join(REPO, cluster_dir))
        app = pkg.AppResource(name=name, resource=yl.load_resources(os.path.join(REPO, app_dir)))
        return cluster, [app], {"extended_resources": [extended]}

    return build


CASES = {
    "demo": _demo,
    "synth": _synth,
    "unschedulable": _unschedulable,
    "overload": _overload,
    "preempt": _preempt,
    "storage": _storage,
    "gpushare": _gpushare,
    "gpushare-example": _example("examples/cluster/gpushare", "examples/application/gpushare",
                                 "inference", "gpu"),
    "local-storage-example": _example("examples/cluster/demo", "examples/application/local-storage",
                                      "database", "open-local"),
}


def _carried(engine):
    """The engine's final dense state as numpy, or None where the engine
    refuses to hand one out (the JAX package and the port refuse alike)."""
    try:
        state = engine.carried_state()
    except ValueError:
        return None
    if state is None:
        return None
    if isinstance(state, torch_state.SchedState):
        return state_to_numpy(state)
    return type(state)(*(np.asarray(x) for x in state))


def _run_jax(cluster, apps, **kw):
    engines = []

    def factory(t):
        engines.append(JaxEngine(t))
        return engines[-1]

    simtpu.workloads.expand.seed_name_hashes(17)
    try:
        result = simtpu.simulate(cluster, apps, engine_factory=factory, **kw)
    finally:
        simtpu.workloads.expand.seed_name_hashes(None)
    return placement_record(result), _carried(engines[-1])


def _run_torch(cluster, apps, monkeypatch, **kw):
    engines = []

    class Recording(TorchEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(tapi, "Engine", Recording)
    simtpu_torch.workloads.expand.seed_name_hashes(17)
    try:
        result = simtpu_torch.simulate(cluster, apps, device="cpu", **kw)
    finally:
        simtpu_torch.workloads.expand.seed_name_hashes(None)
    return placement_record(result), _carried(engines[-1])


def _problem(built):
    return built if len(built) == 3 else (*built, {})


def assert_same_simulation(build, monkeypatch):
    """Run the problem `build(pkg)` through `simtpu.simulate` and
    `simtpu_torch.simulate(device="cpu")` and require identical results:
    every pod's node, every unscheduled pod's reason, the preempted pods,
    the GPU device assignments and node annotations, and the final carried
    state planes. Returns the two placement records."""
    j_cluster, j_apps, j_kw = _problem(build(simtpu))
    want, j_state = _run_jax(j_cluster, j_apps, **j_kw)
    t_cluster, t_apps, t_kw = _problem(build(simtpu_torch))
    got, t_state = _run_torch(t_cluster, t_apps, monkeypatch, **t_kw)
    for field in ("nodes", "placed", "failed", "preempted", "gpu_index", "node_ext"):
        assert got[field] == want[field], field
    assert (t_state is None) == (j_state is None)
    if j_state is not None:
        assert diff_state_planes(t_state, j_state) == []
    return want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulate_bit_identical(case, monkeypatch):
    want, _ = assert_same_simulation(CASES[case], monkeypatch)
    if case in ("demo", "gpushare-example", "local-storage-example"):
        assert not want["failed"] and len(want["placed"]) > 5
    if case == "overload":
        assert want["failed"]
    if case == "unschedulable":
        texts = {r.split("nodes are available: ")[1] for r in want["failed"].values()}
        assert len(want["placed"]) > 50 and len(texts) >= 4, texts
    if case in ("preempt", "gpushare"):
        assert want["preempted"]
    if case in ("gpushare", "gpushare-example"):
        assert want["gpu_index"]
    if case in ("storage", "local-storage-example"):
        assert want["node_ext"]


def test_default_device_is_cuda_and_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster, apps = _demo(simtpu_torch)
    with pytest.raises(RuntimeError, match="CUDA"):
        simtpu_torch.simulate(cluster, apps)


@pytest.mark.parametrize("module", ["simtpu_torch", "chip_smoke", "simtpu_torch.cli", "simtpu_torch.explain",
                                    "simtpu_torch.solve"])
def test_port_imports_neither_jax_nor_simtpu(module):
    # the import reaches every module of the port's main paths — simulate()
    # and the apply front door, the kernels' wrappers included — so the
    # check covers them
    ported = ("simtpu_torch.api", "simtpu_torch.engine.scan", "simtpu_torch.engine.state",
              "simtpu_torch.kernels.cuda", "simtpu_torch.kernels.storage",
              "simtpu_torch.kernels.gpushare", "simtpu_torch.smoke",
              "simtpu_torch.cli", "simtpu_torch.plan.capacity", "simtpu_torch.audit.checker",
              "simtpu_torch.audit.fuzz", "simtpu_torch.kernels.audit", "simtpu_torch.chart",
              "simtpu_torch.report", "simtpu_torch.config", "simtpu_torch.explain.breakdown",
              "simtpu_torch.explain.scores", "simtpu_torch.explain.bottleneck",
              "simtpu_torch.solve.relax", "simtpu_torch.solve.rounding", "simtpu_torch.solve.planner")
    code = (
        f"import sys; import {module}; import simtpu_torch.smoke, simtpu_torch.cli, "
        "simtpu_torch.plan.capacity, simtpu_torch.audit.checker, simtpu_torch.audit.fuzz, "
        "simtpu_torch.chart, simtpu_torch.explain, simtpu_torch.solve; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
        "or m == 'simtpu' or m.startswith('simtpu.')]; "
        f"bad += [m for m in {ported!r} if m not in sys.modules]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_copied_host_modules_unchanged_in_behaviour():
    """The copies tensorize the same problem into the same arrays."""
    from simtpu.core.tensorize import Tensorizer as JT
    from simtpu_torch.core.tensorize import Tensorizer as TT

    def tensors(pkg, tz_cls):
        cluster, apps = _synth(pkg)
        pkg.workloads.expand.seed_name_hashes(3)
        try:
            pods = pkg.workloads.expand.get_valid_pods_exclude_daemonset(apps[0].resource)
        finally:
            pkg.workloads.expand.seed_name_hashes(None)
        tz = tz_cls(copy.deepcopy(cluster.nodes))
        batch = tz.add_pods(pods)
        return tz.freeze(), batch

    (jt, jb), (tt, tb) = tensors(simtpu, JT), tensors(simtpu_torch, TT)
    for name in ("alloc", "static_mask", "node_dom", "s_match", "spread_hard", "ss_zone", "term_topo_key"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)
    np.testing.assert_array_equal(tb.group, jb.group)
    np.testing.assert_array_equal(tb.req, jb.req)
    assert [p["metadata"]["name"] for p in tb.pods] == [p["metadata"]["name"] for p in jb.pods]
