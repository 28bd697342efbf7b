"""Open-Local storage, GPU-share and signed log deltas: the port against the
JAX package, bit for bit.

1. `lvm_plan`, `device_plan`, `open_local_score` (simtpu_torch/kernels/
   storage.py) and `gpu_plan` (kernels/gpushare.py): the jitted JAX
   function against the port's plain version on the same seeded numpy
   inputs, over named, unnamed and missing-VG claims, several claims, device
   media, 1-GPU tight fit, multi-GPU, preset and gpu-mem-without-count
   cases. Tolerance 0: equal bools and bit-identical f32.
2. `placement_delta_step` / `apply_placement_deltas` (engine/state.py)
   against the JAX package's on a placed log with ports, volumes, storage,
   GPU and term rows: eviction (w = -1), the undo (w = +1; every
   integer-valued plane back to the state before, bit for bit) and padding
   rows (w = 0, no-ops).
3. The K1→K6 plain chain against the JAX package's compiled serial scan
   with the storage and GPU flags live: every pod's node, reason, LVM
   allocation, devices taken and GPU shares, every state plane, and every
   pod's scores (the default and custom score weights); the evictions of
   2. take their entries from this chain's placements.
4. The port's mirror of each case of tests/test_extended.py (the
   GPU-share and Open-Local fixtures; the in-repo examples stand in for the
   reference checkout's), through both packages' `simulate`: placements,
   reasons, GPU-index and node annotations, and the final state planes.

All inputs come from numpy seeds and reach both packages as numpy arrays.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simtpu.kernels.gpushare as jg
import simtpu.kernels.storage as js
from simtpu.core.tensorize import Tensorizer
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.synth import make_deployment, synth_apps, synth_cluster
from simtpu.workloads.expand import get_valid_pods_exclude_daemonset, seed_name_hashes
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import gpushare as tg
from simtpu_torch.kernels import storage as ts

from .fixtures import (
    make_fake_node,
    make_fake_pod,
    with_node_allocatable,
    with_node_labels,
    with_node_local_storage,
    with_pod_annotations,
)
from .test_torch_kernels import (
    CUSTOM_WEIGHTS,
    _jax_scan_with_eval,
    _numpy_tree,
    _port_flags,
    _volume_pod,
)
from .test_torch_simulate import REPO, assert_same_simulation

F32 = np.float32
GI = 2**30
N = 33

# -- 1. the plan functions --------------------------------------------------


def _vg_inputs(rng, kind):
    v = 3
    name = rng.integers(-1, 4, (N, v)).astype(np.int32)
    name[::6] = -1  # nodes without any VG
    free = (rng.integers(0, 80, (N, v)) * F32(1.25 * GI)).astype(F32)
    n_claims = {"named": 1, "unnamed": 1, "missing-vg": 2, "multi-claim": 3}[kind]
    sizes = (rng.integers(1, 40, n_claims) * F32(1.25 * GI)).astype(F32)
    vids = {
        "named": np.array([2], np.int32),
        "unnamed": np.array([-1], np.int32),
        "missing-vg": np.array([-1, -2], np.int32),
        "multi-claim": np.array([1, -1, -1], np.int32),
    }[kind]
    if kind == "multi-claim":
        sizes = np.append(sizes, F32(0))  # a padding claim
        vids = np.append(vids, np.int32(-1))
    return free, name, sizes, vids


def _dev_inputs(rng):
    sd = 4
    free = rng.random((N, sd)) < 0.7
    cap = (rng.integers(1, 12, (N, sd)) * F32(50 * GI)).astype(F32)
    media = rng.integers(0, 3, (N, sd)).astype(np.int32)
    sizes = np.sort((rng.integers(1, 8, 3) * F32(50 * GI)).astype(F32))
    medias = np.array([1, 2, 1], np.int32)
    return free, cap, media, np.append(sizes, F32(0)), np.append(medias, np.int32(0))


def _gpu_inputs(rng, kind):
    gd = 6
    free = (rng.integers(0, 17, (N, gd)) * F32(1024)).astype(F32)
    exists = rng.random((N, gd)) < 0.8
    exists[::7] = False  # nodes without GPUs
    total = np.where(exists, F32(16384), F32(0)).sum(axis=1).astype(F32)
    mem, count = {
        "gpu-tight-fit": (F32(3072), 1),
        "gpu-multi": (F32(4096), 3),
        "gpu-preset": (F32(6144), 2),
        "gpu-mem-without-count": (F32(8192), 0),
    }[kind]
    preset = np.zeros(gd, np.int32)
    if kind == "gpu-preset":
        preset[[0, 3]] = 1
    return free, exists, total, mem, np.int32(count), preset


PLAN_CASES = ["named", "unnamed", "missing-vg", "multi-claim", "device-media",
              "gpu-tight-fit", "gpu-multi", "gpu-preset", "gpu-mem-without-count"]


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", PLAN_CASES)
def test_plan_functions_bit_identical(kind):
    rng = np.random.default_rng(len(kind) * 7)
    t = torch.as_tensor
    if kind.startswith("gpu"):
        free, exists, total, mem, count, preset = _gpu_inputs(rng, kind)
        want = jax.jit(jg.gpu_plan)(free, exists, total, mem, count, preset)
        got = tg.gpu_plan(t(free), t(exists), t(total), float(mem), int(count), t(preset))
        for a, b in zip(got, want):
            _equal(a, b)
        assert np.asarray(want[0]).any() or kind == "gpu-mem-without-count"
        return
    if kind == "device-media":
        args = _dev_inputs(rng)
        want = jax.jit(js.device_plan)(*args)
        got = ts.device_plan(*map(t, args))
        for a, b in zip(got, want):
            _equal(a, b)
        take, tight = got[1], got[2]
        assert take.any() and not got[0].all()
        n_dev = int((args[3] > 0).sum())
        alloc = torch.zeros((N, 2))
        cap = torch.full((N, 2), 1.0)
        want_score = jax.jit(js.open_local_score)(np.zeros((N, 2), F32), np.ones((N, 2), F32),
                                                  tight.numpy(), 0, n_dev)
        _equal(ts.open_local_score(alloc, cap, tight, 0, n_dev), want_score)
        return
    free, name, sizes, vids = _vg_inputs(rng, kind)
    want = jax.jit(js.lvm_plan)(free, name, sizes, vids)
    got = ts.lvm_plan(t(free), t(name), t(sizes), t(vids))
    for a, b in zip(got, want):
        _equal(a, b)
    cap = (free + rng.integers(1, 50, free.shape) * F32(GI)).astype(F32)
    n_lvm = int((sizes > 0).sum())
    tight = (rng.random(N) * 2).astype(F32)
    for n_dev in (0, 2):
        want_score = jax.jit(js.open_local_score)(np.asarray(want[1]), cap, tight, n_lvm, n_dev)
        _equal(ts.open_local_score(got[1], t(cap), t(tight), n_lvm, n_dev), want_score)


# -- a small problem with every extended family ------------------------------


@pytest.fixture(scope="module")
def ext_problem():
    """40 nodes (storage, GPUs, taints, 4 zones) and ~330 pods: Open-Local
    LVM (several claims) and device pods, GPU-share pods (multi-GPU and a
    preset assignment), host ports, exclusive volumes, spread and
    (anti-)affinity; pins, forced pods and invalid nodes; a seeded log."""
    seed_name_hashes(5)
    try:
        cluster = synth_cluster(40, seed=8, zones=4, taint_frac=0.2, storage_frac=0.5,
                                gpu_frac=0.5)
        apps = synth_apps(
            240, seed=9, zones=4, pods_per_deployment=20, selector_frac=0.3,
            toleration_frac=0.3, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.5,
            affinity_frac=0.15, spread_frac=0.5, spread_hard_frac=0.5, gpu_frac=0.3,
            gpu_multi_frac=0.6, storage_frac=0.35, storage_device_frac=0.4, lvm_multi_frac=0.6,
        )
        pods = []
        for app in apps:
            pods.extend(get_valid_pods_exclude_daemonset(app.resource))
        extra = [make_deployment(f"port-{k}", 10, 300, 256, host_port=8080 + (k % 2))
                 for k in range(2)]
        extra.append(make_deployment("preset", 6, 300, 256, gpu_mem_mib=4096, gpu_count=2,
                                     gpu_index="0-1"))
        extra.append(make_deployment("gpu-big", 30, 300, 256, gpu_mem_mib=16384, gpu_count=3))
        res = type(apps[0].resource)(deployments=extra)
        pods.extend(get_valid_pods_exclude_daemonset(res))
        pods += [_volume_pod(f"vol-{k}", f"disk-{k % 3}", k % 4 == 0) for k in range(16)]
    finally:
        seed_name_hashes(None)
    tz = Tensorizer(cluster.nodes, storage_classes=list(cluster.storage_classes))
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, pods_t = jscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    pods_t = [np.array(x) for x in pods_t]
    rng = np.random.default_rng(3)
    n_p = len(pods_t[0])
    pinned = rng.choice(n_p, 10, replace=False)
    pods_t[2][pinned[:5]] = rng.integers(0, tensors.n_nodes, 5)
    pods_t[2][pinned[5:]] = -2
    pods_t[3][pinned[::3]] = True
    log_n = 50
    log_g = rng.integers(0, len(tensors.groups), log_n).astype(np.int32)
    log_node = rng.integers(0, tensors.n_nodes, log_n).astype(np.int32)
    log_req = pods_t[1][rng.integers(0, n_p, log_n)] * F32(0.5)
    state = jstate.build_state(tensors, log_g, log_node, log_req, None)
    statics = jscan.statics_from(tensors)
    node_valid = np.ones(tensors.n_nodes, bool)
    node_valid[rng.choice(tensors.n_nodes, 3, replace=False)] = False
    statics = statics._replace(node_valid=jnp.asarray(node_valid))
    return tensors, batch, statics, state, tuple(pods_t)


def _jax_run(statics, state, pods, jflags):
    return jscan._run_scan(statics, jax.tree_util.tree_map(jnp.copy, state), pods, jflags)


def _port_run(statics, state, pods, flags):
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods, flags)
    tscan.run_batch(buf)
    return buf


# -- 3. the K1→K7 chain -------------------------------------------------------

CHAIN_FLAGS = {
    "derived": lambda t, b: jscan.flags_from(t, b.ext),
    "general": lambda t, b: jscan.StepFlags(),
    "general-unfused": lambda t, b: jscan.StepFlags(fused=False),
    "no-storage-flag": lambda t, b: jscan.flags_from(t, b.ext)._replace(storage=False),
    "no-gpu-flag": lambda t, b: jscan.flags_from(t, b.ext)._replace(gpu=False),
}


@pytest.mark.parametrize("flag_set", sorted(CHAIN_FLAGS) + ["derived-custom-weights"])
def test_k1_to_k6_plain_chain_matches_jax_scan(ext_problem, flag_set):
    tensors, batch, statics, state, pods = ext_problem
    if flag_set == "derived-custom-weights":
        statics = statics._replace(score_w=jnp.asarray(CUSTOM_WEIGHTS))
        flag_set = "derived"
    jflags = CHAIN_FLAGS[flag_set](tensors, batch)
    j_state, (j_node, j_reason, j_lvm, j_take, j_gpu) = _jax_run(statics, state, pods, jflags)
    buf = _port_run(statics, state, pods, _port_flags(jflags))
    np.testing.assert_array_equal(buf.out_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(buf.reason.numpy(), np.asarray(j_reason))
    np.testing.assert_array_equal(buf.out_lvm.numpy(), np.asarray(j_lvm))
    np.testing.assert_array_equal(buf.out_take.numpy(), np.asarray(j_take))
    np.testing.assert_array_equal(buf.out_gpu.numpy(), np.asarray(j_gpu))
    assert jstate.diff_state_planes(tstate.state_to_numpy(buf.state), _numpy_tree(j_state)) == []
    reasons = set(np.asarray(j_reason).tolist())
    if jflags.storage and jflags.gpu:
        assert {0, jscan.FAIL_STORAGE, jscan.FAIL_GPU} <= reasons, reasons
        assert np.asarray(j_lvm).any() and np.asarray(j_take).any() and np.asarray(j_gpu).any()
        assert buf.storage_live.any() and buf.gpu_live.any()


@pytest.mark.parametrize("weights", ["default", "custom"])
def test_scores_bit_identical_with_storage_and_gpu(ext_problem, weights):
    """Every pod's scores — the Open-Local term included — against the
    compiled scan's own, for a seeded sample of 120 pods, half of them
    storage or GPU pods, in batch order."""
    tensors, batch, statics, state, pods = ext_problem
    if weights == "custom":
        statics = statics._replace(score_w=jnp.asarray(CUSTOM_WEIGHTS))
    ext = (pods[4] > 0).any(1) | (pods[6] > 0).any(1) | (pods[8] > 0)
    rng = np.random.default_rng(12)
    sel = np.sort(np.concatenate([rng.choice(np.flatnonzero(ext), 60, replace=False),
                                  rng.choice(np.flatnonzero(~ext), 60, replace=False)]))
    pods = tuple(x[sel] for x in pods)
    jflags = jscan.flags_from(tensors, batch.ext)
    _, (j_node, _, _, j_score) = _jax_scan_with_eval(statics, state, pods, jflags)
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods,
                            _port_flags(jflags))
    for i in range(buf.n_pods):
        tscan.filter_pod(buf, i)
        if buf.storage_live[i]:
            tscan.storage_pod(buf, i)
        if buf.gpu_live[i]:
            tscan.gpu_pod(buf, i)
        tscan.topology_pod(buf, i)
        tscan.score_argmax_pod(buf, i)
        np.testing.assert_array_equal(buf.score.numpy(), np.asarray(j_score[i]), err_msg=f"pod {i}")
        tscan.commit_pod(buf, i)
    np.testing.assert_array_equal(buf.out_node.numpy(), np.asarray(j_node))
    assert buf.storage_live.sum() >= 10 and buf.gpu_live.sum() >= 10


def test_filter_and_score_matches_with_extended_demands(ext_problem):
    """The textbook `filter_and_score` (the storage and GPU masks, the plans,
    both scores) and `schedule_step` pod by pod against the JAX package's
    functions on the same state, for the storage and GPU pods."""
    tensors, batch, statics, state, pods = ext_problem
    jflags = jscan.flags_from(tensors, batch.ext)
    flags = _port_flags(jflags)
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(state), "cpu")
    j_state = jax.tree_util.tree_map(jnp.copy, state)
    step = jax.jit(lambda stc, st, pod: (jscan.filter_and_score(stc, st, pod, jflags),
                                         jscan.schedule_step(stc, st, pod, jflags)))
    ext_pods = np.flatnonzero((pods[4] > 0).any(1) | (pods[6] > 0).any(1) | (pods[8] > 0))
    for i in ext_pods[:40]:
        pod = tuple(x[i] for x in pods)
        j_ev, (j_state, (j_node, j_reason, *_)) = step(statics, j_state, pod)
        ev = tscan.filter_and_score(t_statics, t_state, (pod[0], torch.as_tensor(pod[1]), *pod[2:]),
                                    flags)
        for field in tuple(f for f, _ in tscan.FILTER_CASCADE) + ("lvm_alloc", "dev_take", "gpu_shares"):
            np.testing.assert_array_equal(getattr(ev, field).numpy(), np.asarray(getattr(j_ev, field)),
                                          err_msg=f"pod {i} {field}")
        got = tscan.schedule_step(t_statics, t_state, (pod[0], torch.as_tensor(pod[1]), *pod[2:]),
                                  flags)
        assert got == (int(j_node), int(j_reason))
    assert jstate.diff_state_planes(tstate.state_to_numpy(t_state), _numpy_tree(j_state)) == []


# -- 2. signed log deltas -----------------------------------------------------


def _placed_entries(tensors, pods, j_node, j_lvm, j_take, j_gpu, rng, k):
    """`k` seeded placed pods of a scan as remove_placements-style records."""
    nodes = np.asarray(j_node)
    placed = np.flatnonzero(nodes >= 0)
    ext = (pods[4] > 0).any(1) | (pods[6] > 0).any(1) | (pods[8] > 0)
    pick = np.concatenate([rng.choice(placed[ext[placed]], k // 2, replace=False),
                           rng.choice(placed[~ext[placed]], k - k // 2, replace=False)])
    return [
        (int(pods[0][i]), int(nodes[i]), pods[1][i], int(nodes[i]), np.asarray(j_lvm)[i],
         np.asarray(j_take)[i], np.asarray(j_gpu)[i], float(pods[8][i]))
        for i in pick
    ]


@pytest.mark.parametrize("pad_to", [None, 64], ids=["pow2-padding", "wide-padding"])
def test_apply_placement_deltas_evict_and_undo(ext_problem, pad_to):
    tensors, batch, statics, state, pods = ext_problem
    jflags = jscan.flags_from(tensors, batch.ext)
    j_state, (j_node, _, j_lvm, j_take, j_gpu) = _jax_run(statics, state, pods, jflags)
    entries = _placed_entries(tensors, pods, j_node, j_lvm, j_take, j_gpu,
                              np.random.default_rng(4), 24)
    ext = tensors.ext
    widths = (tensors.alloc.shape[1], ext.vg_cap.shape[1], ext.sdev_cap.shape[1],
              ext.gpu_dev_total.shape[1])
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    before = _numpy_tree(j_state)
    t_state = tstate.state_from_numpy(before, "cpu")
    j_cur = j_state
    for sign in (-1.0, 1.0):
        packed = tstate.pack_delta_entries(entries, *widths, sign, pad_to=pad_to)
        want_packed = jstate.pack_delta_entries(entries, *widths, sign, pad_to=pad_to)
        for a, b in zip(packed, want_packed):
            _equal(a, b)
        assert (packed[2] == 0).sum() == len(packed[2]) - len(entries)
        j_cur = jstate.apply_placement_deltas(statics, jax.tree_util.tree_map(jnp.copy, j_cur),
                                              tuple(map(jnp.asarray, want_packed)))
        tstate.apply_placement_deltas(t_statics, t_state, packed)
        assert jstate.diff_state_planes(tstate.state_to_numpy(t_state), _numpy_tree(j_cur)) == []
        if sign < 0:
            evicted = tstate.state_to_numpy(t_state)
            assert not np.array_equal(evicted.vg_free, before.vg_free)
            assert not np.array_equal(evicted.gpu_free, before.gpu_free)
            assert not np.array_equal(evicted.sdev_free, before.sdev_free)
    # the undo restores every integer-valued plane exactly; `free` holds
    # fractional cores, whose f32 sums need not round-trip (in either package)
    after = tstate.state_to_numpy(t_state)
    for name in tstate.SchedState._fields:
        if name != "free":
            np.testing.assert_array_equal(getattr(after, name), getattr(before, name), err_msg=name)


def test_placement_delta_step_one_entry_at_a_time(ext_problem):
    """Each entry applied alone, with w = -1, +1 and 0 (a no-op)."""
    tensors, batch, statics, state, pods = ext_problem
    jflags = jscan.flags_from(tensors, batch.ext)
    j_state, (j_node, _, j_lvm, j_take, j_gpu) = _jax_run(statics, state, pods, jflags)
    entries = _placed_entries(tensors, pods, j_node, j_lvm, j_take, j_gpu,
                              np.random.default_rng(8), 8)
    ext = tensors.ext
    packed = jstate.pack_delta_entries(entries, tensors.alloc.shape[1], ext.vg_cap.shape[1],
                                       ext.sdev_cap.shape[1], ext.gpu_dev_total.shape[1], -1.0)
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(j_state), "cpu")
    step = jax.jit(jstate.placement_delta_step)
    j_cur = j_state
    for e in range(len(entries)):
        for w in (-1.0, 0.0, 1.0, -1.0):
            entry = tuple(np.asarray(x[e]) for x in packed)
            entry = entry[:2] + (np.float32(w),) + entry[3:]
            j_cur, _ = step(statics, j_cur, entry)
            tstate.placement_delta_step(t_statics, t_state, tuple(torch.as_tensor(x) for x in entry))
        assert jstate.diff_state_planes(tstate.state_to_numpy(t_state), _numpy_tree(j_cur)) == []


# -- 4. the extended fixtures through simulate --------------------------------


def _gpu_node(name="g0"):
    return make_fake_node(
        name, "64", "256Gi", with_node_labels({"kubernetes.io/hostname": name}),
        with_node_allocatable({"alibabacloud.com/gpu-mem": "32Gi", "alibabacloud.com/gpu-count": "2"}),
    )


def _gpu_pod(name, mem, count=None, index=None, cpu="100m"):
    annos = {"alibabacloud.com/gpu-mem": mem}
    if count is not None:
        annos["alibabacloud.com/gpu-count"] = count
    if index is not None:
        annos["alibabacloud.com/gpu-index"] = index
    return make_fake_pod(name, "default", cpu, "128Mi", with_pod_annotations(annos))


STORAGE = {
    "vgs": [{"name": "pool0", "capacity": 100 * GI}, {"name": "pool1", "capacity": 200 * GI}],
    "devices": [
        {"name": "/dev/vdd", "device": "/dev/vdd", "capacity": 100 * GI, "isAllocated": False,
         "mediaType": "hdd"},
        {"name": "/dev/vde", "device": "/dev/vde", "capacity": 50 * GI, "isAllocated": False,
         "mediaType": "ssd"},
    ],
}


def _sc(name, media=None):
    return {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass", "metadata": {"name": name},
            "parameters": {"mediaType": media} if media else {}}


def _storage_pod(name, volumes):
    return make_fake_pod(name, "default", "100m", "128Mi", with_pod_annotations(
        {"simon/pod-local-storage": json.dumps({"volumes": volumes})}))


def _storage_cluster(pkg):
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node("s0", "8", "16Gi", with_node_local_storage(STORAGE)),
                     make_fake_node("plain", "8", "16Gi")]
    cluster.storage_classes = [_sc("open-local-lvm"), _sc("open-local-device-hdd", "hdd"),
                               _sc("open-local-device-ssd", "ssd")]
    return cluster


def _one_app(pkg, cluster, pods, **kw):
    res = pkg.ResourceTypes()
    res.pods = pods
    return cluster, [pkg.AppResource(name="app", resource=res)], kw


def _example(pkg, cluster_dir, app_dir, app_name, extended):
    from importlib import import_module

    cl = import_module(f"{pkg.__name__}.io.cluster")
    yl = import_module(f"{pkg.__name__}.io.yaml_loader")
    cluster = cl.create_cluster_resource_from_cluster_config(os.path.join(REPO, cluster_dir))
    app = pkg.AppResource(name=app_name, resource=yl.load_resources(os.path.join(REPO, app_dir)))
    return cluster, [app], {"extended_resources": [extended]}


def _gpu_cluster(pkg, pods=()):
    cluster = pkg.ResourceTypes()
    cluster.nodes = [_gpu_node()]
    cluster.pods = list(pods)
    return cluster


def _preexisting(pkg):
    running = _gpu_pod("running", "6Gi", "2", "0-1", cpu="1")
    running["spec"]["nodeName"] = "g0"
    return _one_app(pkg, _gpu_cluster(pkg, [running]), [_gpu_pod("newpod", "12Gi", "1", cpu="1")])


def _no_gpu_nodes(pkg):
    cluster = pkg.ResourceTypes()
    cluster.nodes = [make_fake_node("plain", "8", "16Gi")]
    return _one_app(pkg, cluster, [_gpu_pod("gp", "1Gi", "1")])


EXTENDED_CASES = {
    "gpushare-example-device-assignments": lambda pkg: _example(
        pkg, "examples/cluster/gpushare", "examples/application/gpushare", "inference", "gpu"),
    "multi-gpu-pod-stacks-onto-devices": lambda pkg: _one_app(
        pkg, _gpu_cluster(pkg), [_gpu_pod("multi", "8Gi", "4", cpu="1")]),
    "tightest-fit-single-gpu": lambda pkg: _one_app(
        pkg, _gpu_cluster(pkg), [_gpu_pod("big", "12Gi", "1"), _gpu_pod("small", "3Gi", "1")]),
    "preexisting-gpu-index-honored": _preexisting,
    "gpu-mem-without-count-unschedulable": lambda pkg: _one_app(
        pkg, _gpu_cluster(pkg), [_gpu_pod("no-count", "8Gi")]),
    "gpu-pod-without-gpu-nodes": _no_gpu_nodes,
    "lvm-binpack-smallest-fitting-vg": lambda pkg: _one_app(pkg, _storage_cluster(pkg), [
        _storage_pod("lvm-pod", [{"size": str(60 * GI), "kind": "LVM", "scName": "open-local-lvm"}])]),
    "device-exclusive-allocation": lambda pkg: _one_app(pkg, _storage_cluster(pkg), [
        _storage_pod(f"dev-pod-{k}", [{"size": str(30 * GI), "kind": "HDD",
                                       "scName": "open-local-device-hdd"}]) for k in (1, 2)]),
    "storage-pod-avoids-storageless-node": lambda pkg: _one_app(pkg, _storage_cluster(pkg), [
        _storage_pod("p", [{"size": str(10 * GI), "kind": "LVM", "scName": "open-local-lvm"}])]),
    "local-storage-example": lambda pkg: _example(
        pkg, "examples/cluster/demo", "examples/application/local-storage", "database",
        "open-local"),
}


@pytest.mark.parametrize("case", sorted(EXTENDED_CASES))
def test_extended_fixture_bit_identical(case, monkeypatch):
    want, got = assert_same_simulation(EXTENDED_CASES[case], monkeypatch)
    if case.startswith(("gpushare", "multi", "tightest", "preexisting")):
        assert want["gpu_index"], "no GPU device assignment recorded"
    if case in ("lvm-binpack-smallest-fitting-vg", "device-exclusive-allocation", "local-storage-example"):
        assert want["node_ext"], "no Open-Local node annotation recorded"
    if case in ("gpu-mem-without-count-unschedulable", "gpu-pod-without-gpu-nodes",
                "device-exclusive-allocation", "preexisting-gpu-index-honored"):
        assert len(want["failed"]) == 1
