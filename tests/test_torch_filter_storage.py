"""K1 `filter_pod` and K5 `storage_pod`: their launch plans, their argument
blocks, and their plain versions against the JAX package.

1. `cuda.filter_plan` and `cuda.storage_plan` at every template boundary
   (K1: the register template up to FILTER_REG entries a live row, the
   group's rows staged up to FILTER_SMEM bytes; K5: the register template
   of 4 VGs and devices, the running rows in shared memory, then in
   the StepCtx scratch rows; the claims staged up to STORAGE_CLAIMS_SMEM
   bytes), with every node on exactly one thread at N = 1 ... 100 000 and
   at every swept thread count: no width of P, W, C, V or SD is refused.
2. The argument blocks: the plans as `filter_plan_struct` /
   `storage_plan_struct` build them from a StepCtx at N = 120 ... 100 000,
   the wrapper passing the pod's group and pin as the buffers hold them,
   the ctypes mirrors and constants against the CUDA sources, and the stage
   and plan arithmetic found only in the shared headers.
3. `filter_pod_plain` against the JAX package's `filter_and_score` masks
   (m_static ... m_bind) on an edge problem — host ports, exclusive
   volumes, attach classes, pods pinned to a node, to no node and forced —
   with the derived flags, every flag, and seeded state rows of widths
   within and past K1's register template (each stage failing first
   somewhere); `storage_pod_plain` against `simtpu/kernels/storage.py
   lvm_plan :25`, `device_plan :66` and `open_local_score :100` composed
   as the JAX package's fused cascade composes them, at V = SD = 1, 4
   (K5's register template), 5, 8, 9 and 36: named, unnamed binpack, missing-VG, failing and padding
   claims, exclusive devices of two media, a node with no VG, nodes
   without storage. Tolerance 0: equal bools, bit-identical f32.

All inputs come from numpy seeds; nothing here needs a card.
"""

import ctypes
import re
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simtpu.kernels.storage as js
from simtpu.core.tensorize import Tensorizer
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.synth import make_deployment, synth_apps, synth_cluster
from simtpu.workloads.expand import get_valid_pods_exclude_daemonset, seed_name_hashes
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from simtpu_torch.kernels import storage as tstorage

from .test_torch_kernels import _numpy_tree, _port_flags, _volume_pod
from .test_torch_launch_plans import _cuda_int, _struct_fields
from ._threads import one_torch_thread  # noqa: F401 (autouse)

F32 = np.float32
GI = 2**30
NODES = (1, 31, 32, 120, 1000, 1024, 1025, 2000, 5000, 9000, 16385, 100000)
ALL_GROUP = cuda.F_PORTS | cuda.F_VOLS | cuda.F_ATTACH


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


# -- 1. the launch plans ------------------------------------------------------


def _covers(plan: dict, n: int) -> None:
    n1 = max(n, 1)
    t = plan["threads"]
    assert 32 <= t <= 1024 and t % 32 == 0
    assert plan["blocks"] * t >= n1 and (plan["blocks"] - 1) * t < n1


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("threads", [None, 32, 64, 128, 256, 512, 1024])
def test_filter_and_storage_plans_cover_every_node_once(n, threads):
    fp = cuda.filter_plan(n, 3, 0, 0, 4, 0, threads)
    sp = cuda.storage_plan(n, 2, 3, 3, 1, threads)
    _covers(fp, n)
    _covers(sp, n)
    assert fp["threads"] <= cuda.FILTER_MAX_THREADS and sp["threads"] <= cuda.STORAGE_MAX_THREADS
    if threads is None:
        want = min(cuda.FILTER_THREADS, max(-(-max(n, 1) // 32) * 32, 32))
        assert cuda.filter_plan(n, 3, 0, 0, 4, 0)["threads"] == want


# (R, P, W, C, flags) -> register template or not: a row counts only where
# its stage is live
FILTER_WIDTHS = [
    ((8, 0, 0, 0, 0), True), ((9, 0, 0, 0, 0), False), ((3, 40, 40, 40, 0), True),
    ((3, 8, 0, 0, cuda.F_PORTS), True), ((3, 9, 0, 0, cuda.F_PORTS), False),
    ((3, 0, 8, 0, cuda.F_VOLS), True), ((3, 0, 9, 0, cuda.F_VOLS), False),
    ((3, 0, 9, 9, cuda.F_PORTS), True), ((3, 0, 8, 9, cuda.F_VOLS), True),
    ((3, 0, 8, 8, cuda.F_ATTACH), True), ((3, 0, 8, 9, cuda.F_ATTACH), False),
    ((3, 0, 9, 1, cuda.F_ATTACH), False), ((5, 8, 8, 8, ALL_GROUP), True), ((5, 9, 1, 1, ALL_GROUP), False),
]


@pytest.mark.parametrize("widths, regs", FILTER_WIDTHS)
def test_filter_plan_templates(widths, regs):
    r, p, w, c, flags = widths
    plan = cuda.filter_plan(1000, r, p, w, c, flags)
    assert plan["regs"] == int(regs) and plan["template"] == ("registers" if regs else "global")
    smem = p + 3 * w + (w if regs else c * w)
    assert cuda.filter_smem_bytes(p, w, c, regs) == smem
    staged = bool(flags & ALL_GROUP)
    assert plan["staged"] == int(staged) and plan["smem"] == (smem if staged else 0)


@pytest.mark.parametrize("w, c, staged", [(12000, 0, True), (16384, 0, True), (16385, 0, False), (4096, 9, True),
                                          (4096, 10, False), (100000, 64, False)])
def test_filter_plan_reads_wide_group_rows_in_place(w, c, staged):
    # past FILTER_SMEM bytes the group's rows are read in place, at any W and C
    plan = cuda.filter_plan(5000, 3, 0, w, c, ALL_GROUP)
    assert plan["staged"] == int(staged)
    assert (plan["smem"] <= cuda.FILTER_SMEM) and (plan["smem"] == 0) == (not staged)
    _covers(plan, 5000)


# max(V, SD) -> K5's template by default
STORAGE_WIDTHS = [(1, 1, 4), (4, 1, 4), (1, 4, 4), (4, 4, 4), (5, 1, cuda.STORAGE_SHARED),
                  (4, 5, cuda.STORAGE_SHARED), (9, 1, cuda.STORAGE_SHARED), (36, 36, cuda.STORAGE_SHARED),
                  (190, 2, cuda.STORAGE_SHARED), (200, 2, cuda.STORAGE_GLOBAL), (4000, 4000, cuda.STORAGE_GLOBAL)]


@pytest.mark.parametrize("v, sd, template", STORAGE_WIDTHS)
def test_storage_plan_templates(v, sd, template):
    plan = cuda.storage_plan(5000, v, sd, 3, 2)
    assert plan["tmpl"] == template
    assert plan["staged"] == 1 and plan["off_rows"] == 48 and plan["off_rows"] % 16 == 0
    if template == cuda.STORAGE_SHARED:
        assert plan["smem"] == 48 + plan["threads"] * (8 * v + sd) <= cuda.WAVE_SMEM
        assert plan["template"] == "shared"
    else:
        assert plan["smem"] == 40
    if template == cuda.STORAGE_GLOBAL:
        assert plan["template"] == "global"
        # the shared rows would pass the budget at this plan's threads
        assert 48 + plan["threads"] * (8 * v + sd) > cuda.WAVE_SMEM
    _covers(plan, 5000)


@pytest.mark.parametrize("claims, staged", [(1, True), (2048, True), (2049, False), (100000, False)])
def test_storage_plan_stages_claims_within_the_budget(claims, staged):
    l = claims // 2
    k = claims - l
    plan = cuda.storage_plan(1000, 2, 3, l, k)
    assert plan["staged"] == int(staged)
    bytes_ = 8 * claims
    if staged:
        assert plan["off_rows"] >= bytes_ and plan["smem"] == bytes_
    else:
        assert plan["off_rows"] == 0 and plan["smem"] == 0
    shared = cuda.storage_plan(1000, 36, 36, l, k, template=cuda.STORAGE_SHARED)
    assert shared["smem"] == shared["off_rows"] + shared["threads"] * (8 * 36 + 36)


# -- 2. the argument blocks ---------------------------------------------------


class _Ctx:
    """A buffer as the plans read it: the StepCtx's widths, no tensors."""

    def __init__(self, n, r=3, p=0, w=0, c=4, flags=0, v=2, sd=3, l=3, k=1):
        self.ctx = cuda.StepCtx(n=n, r=r, p_ports=p, w=w, c=c, flags=flags, v=v, sd=sd, l=l, k=k)
        self.filter_plan = None
        self.storage_plan = None


@pytest.mark.parametrize("n", [120, 1000, 2000, 5000, 9000, 100000])
@pytest.mark.parametrize("widths", [dict(), dict(p=2, w=3, c=2, flags=ALL_GROUP), dict(p=12, w=12, c=12, flags=ALL_GROUP),
                                    dict(v=36, sd=36, l=2, k=1), dict(v=300, sd=1)])
def test_plans_as_the_argument_blocks_carry_them(n, widths):
    buf = _Ctx(n, **widths)
    x = buf.ctx
    fp = cuda.filter_plan_struct(buf)
    want = cuda.filter_plan(n, x.r, x.p_ports, x.w, x.c, x.flags)
    assert {f: getattr(fp, f) for f, _ in cuda.FilterPlan._fields_} == {f: want[f] for f, _ in cuda.FilterPlan._fields_}
    assert cuda.filter_plan_struct(buf) is fp  # built once per buffer
    assert cuda.filter_plan_struct(buf, 32).threads == 32 and buf.filter_plan is fp
    sp = cuda.storage_plan_struct(buf)
    want = cuda.storage_plan(n, x.v, x.sd, x.l, x.k)
    assert {f: getattr(sp, f) for f, _ in cuda.StoragePlan._fields_} == {f: want[f] for f, _ in cuda.StoragePlan._fields_}
    assert cuda.storage_plan_struct(buf) is sp
    other = cuda.storage_plan_struct(buf, 64, cuda.STORAGE_GLOBAL)
    assert (other.threads, other.tmpl) == (64, cuda.STORAGE_GLOBAL) and buf.storage_plan is sp


class _FakeLib:
    """Stands in for a kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0

        return entry


def test_the_wrapper_passes_the_group_and_pin_the_buffers_hold(monkeypatch, edge_problem):
    tensors, batch, statics, state, pods = edge_problem
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods,
                            _port_flags(jscan.StepFlags()))
    assert buf.group_host == buf.group.tolist() and buf.pin_host == buf.pin.tolist()
    assert {-2, -1} <= set(buf.pin_host) and any(p >= 0 for p in buf.pin_host)
    libs = {name: _FakeLib() for name in cuda.KERNELS}
    monkeypatch.setattr(cuda, "build", lambda: libs)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    # the launches counted on a counter of the test's own: the process's
    # stays as the other modules' tests find it
    monkeypatch.setattr(cuda, "LAUNCHES", Counter())
    for i in range(buf.n_pods):
        cuda.launch("filter_pod", buf, i)
        cuda.launch("storage_pod", buf, i)
    assert cuda.LAUNCHES["filter_pod"] == buf.n_pods
    fplan = cuda.filter_plan(buf.ctx.n, buf.ctx.r, buf.ctx.p_ports, buf.ctx.w, buf.ctx.c, buf.ctx.flags)
    for i, (name, (ctx, pod, g, pin, plan, stream)) in enumerate(libs["filter_pod"].calls):
        assert name == "simtpu_filter_pod" and (pod, g, pin, stream) == (i, int(buf.group[i]), int(buf.pin[i]), 7)
        got = ctypes.cast(plan, ctypes.POINTER(cuda.FilterPlan)).contents if isinstance(plan, int) else plan._obj
        assert {f: getattr(got, f) for f, _ in cuda.FilterPlan._fields_} == {f: fplan[f] for f, _ in
                                                                           cuda.FilterPlan._fields_}
    for i, (name, (ctx, pod, plan, stream)) in enumerate(libs["storage_pod"].calls):
        assert name == "simtpu_storage_pod" and (pod, stream) == (i, 7)
        assert plan._obj is buf.storage_plan


def test_filter_and_storage_blocks_mirror_the_cuda_sources():
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    for source, struct in (("filter_pod.cu", "FilterPlan"), ("storage_pod.cu", "StoragePlan")):
        mirror = [(f, ctypes_kind[t]) for f, t in getattr(cuda, struct)._fields_]
        assert mirror == _struct_fields((cuda.CSRC / source).read_text(), struct)
    k1 = (cuda.CSRC / "filter_pod.cu").read_text()
    k5 = (cuda.CSRC / "storage_pod.cu").read_text()
    step = (cuda.CSRC / "step_ctx.cuh").read_text()
    for name in ("FILTER_MAX_THREADS", "FILTER_REG", "FILTER_SMEM"):
        assert _cuda_int(k1, name) == getattr(cuda, name), name
    assert "(regs ? static_cast<long long>(w) : static_cast<long long>(c) * w)" in k1
    for reg in ("true", "false"):
        for staged in ("true", "false"):
            assert f"launch_filter<{reg}, {staged}>" in k1
    for name, bit in (("F_PORTS", cuda.F_PORTS), ("F_VOLS", cuda.F_VOLS), ("F_ATTACH", cuda.F_ATTACH)):
        assert re.search(rf"\b{name} = 1 << {bit.bit_length() - 1},", step), name
    for name in ("STORAGE_MAX_THREADS", "STORAGE_SHARED", "STORAGE_GLOBAL", "STORAGE_CLAIMS_SMEM"):
        assert _cuda_int(k5, name) == getattr(cuda, name), name
    assert _cuda_int(k5, "STORAGE_REG") == cuda.STORAGE_REG
    for tmpl in ("STORAGE_REG", "STORAGE_SHARED", "STORAGE_GLOBAL"):
        for staged in ("true", "false"):
            assert f"launch_storage<{tmpl}, {staged}>" in k5
    assert "8LL * x.v + x.sd" in k5


def test_the_arithmetic_lives_once_in_the_headers():
    # K1 and K5 call the stages and the plan of node_stages.cuh and
    # ext_plans.cuh, which K9, K10, K19 and K20 call too: no FMA, division,
    # slack constant or argmin of their own
    k1 = (cuda.CSRC / "filter_pod.cu").read_text()
    k5 = (cuda.CSRC / "storage_pod.cu").read_text()
    stages = (cuda.CSRC / "node_stages.cuh").read_text()
    plans = (cuda.CSRC / "ext_plans.cuh").read_text()
    for src in (k1, k5):
        code = re.sub(r"//[^\n]*", "", src)
        for token in ("__fmaf_rn", "__fdiv_rn", "1e-5f", "best_key", "attach_add(", "> 0.0f"):
            assert token not in code, token
    assert "stage_bits(x, s)" in k1 and "stage_bits(x, st)" in k1
    assert k5.count("storage_plan(x, ") == 3
    assert "__fmaf_rn(1e-5f" in stages and stages.count("__fmaf_rn") == 1
    assert plans.count("__fmaf_rn") == 1 and "best_key" in plans
    for caller in ("explain_pass.cu", "sweep_place.cu", "wave_hard.cu"):
        assert "storage_node(x, i, n)" in (cuda.CSRC / caller).read_text(), caller
    assert "filter_bits(x, i, n)" in (cuda.CSRC / "explain_pass.cu").read_text()


# -- 3. the plain versions against the JAX package ---------------------------


def _pod(name: str, **spec) -> dict:
    body = {"containers": [{"name": "c", "image": "x",
                            "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}
    body.update(spec)
    return {"apiVersion": "v1", "kind": "Pod", "spec": body,
            "metadata": {"name": name, "namespace": "edge", "labels": {"app": name}}}


@pytest.fixture(scope="module")
def edge_problem():
    """30 tainted nodes in 3 zones and ~230 pods: host ports, exclusive
    volumes (read-write, read-only, attachable), a pod forced onto a
    missing node, an impossible selector, spread and anti-affinity; pods
    pinned to a node, to no node, and forced; a seeded log."""
    seed_name_hashes(5)
    try:
        cluster = synth_cluster(30, seed=5, zones=3, taint_frac=0.3)
        apps = synth_apps(120, seed=6, zones=3, pods_per_deployment=30, selector_frac=0.3,
                          toleration_frac=0.2, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.6,
                          spread_frac=0.5, spread_hard_frac=0.7)
        pods = []
        for app in apps:
            pods.extend(get_valid_pods_exclude_daemonset(app.resource))
        res = type(apps[0].resource)(deployments=[make_deployment("hostport", 10, 200, 128, host_port=9000),
                                                  make_deployment("hostport2", 8, 200, 128, host_port=9001)])
        pods.extend(get_valid_pods_exclude_daemonset(res))
        pods += [_pod("ghost", nodeName="no-such-node"), _pod("nowhere", nodeSelector={"disktype": "unobtainium"})]
        pods += [_volume_pod(f"vol-{k}", f"disk-{k % 3}", k % 4 == 0) for k in range(24)]
    finally:
        seed_name_hashes(None)
    tz = Tensorizer(cluster.nodes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, pods_t = jscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    pods_t = [np.array(x) for x in pods_t]
    rng = np.random.default_rng(3)
    n_p = len(pods_t[0])
    pinned = rng.choice(n_p, 16, replace=False)
    pods_t[2][pinned[:8]] = rng.integers(0, tensors.n_nodes, 8)
    pods_t[2][pinned[8:]] = -2
    pods_t[3][pinned[::3]] = True
    log_n = 60
    log_g = rng.integers(0, len(tensors.groups), log_n).astype(np.int32)
    log_node = rng.integers(0, tensors.n_nodes, log_n).astype(np.int32)
    log_req = pods_t[1][rng.integers(0, n_p, log_n)] * F32(0.5)
    state = jstate.build_state(tensors, log_g, log_node, log_req, None)
    statics = jscan.statics_from(tensors)
    node_valid = np.ones(tensors.n_nodes, bool)
    node_valid[rng.choice(tensors.n_nodes, 3, replace=False)] = False
    statics = statics._replace(node_valid=jnp.asarray(node_valid))
    return tensors, batch, statics, state, tuple(pods_t)


def _edge_state(statics, state, widths, seed):
    """Seeded group and node rows of widths (P, W, C) and a volume-binding
    mask failing one node in five, on both packages' statics and state."""
    p, w, c = widths
    rng = np.random.default_rng(seed)
    g, n = np.asarray(statics.static_mask).shape
    free = np.asarray(state.free).copy()
    free[rng.random(n) < 0.2] *= F32(0.01)  # nodes short of resources
    s = statics._replace(
        ports_req=jnp.asarray(rng.random((g, p)) < 0.2), vol_rw_req=jnp.asarray(rng.random((g, w)) < 0.15),
        vol_ro_req=jnp.asarray(rng.random((g, w)) < 0.15), vol_att_req=jnp.asarray(rng.random((g, w)) < 0.3),
        vol_class_mask=jnp.asarray(rng.random((c, w)) < 0.4),
        attach_limits=jnp.asarray(rng.integers(0, 4, (n, c)).astype(F32)),
        vol_mask=jnp.asarray(rng.random((g, n)) < 0.8))
    st = state._replace(
        free=jnp.asarray(free), ports_used=jnp.asarray((rng.random((n, p)) < 0.1).astype(F32)),
        vols_any=jnp.asarray((rng.random((n, w)) < 0.2).astype(F32)),
        vols_rw=jnp.asarray((rng.random((n, w)) < 0.1).astype(F32)))
    return s, st


FILTER_CASES = ["derived", "all-flags", "state P2 W3 C2", "state P8 W8 C8", "state P12 W12 C12", "state P1 W9 C3"]
MASKS = ("m_static", "m_ports", "m_res", "m_vol", "m_att", "m_bind")


@pytest.mark.parametrize("case", FILTER_CASES)
def test_filter_plain_equals_the_jax_filter_and_score_masks(edge_problem, case):
    tensors, batch, statics, state, pods = edge_problem
    jflags = jscan.flags_from(tensors, batch.ext) if case == "derived" else jscan.StepFlags()
    if case.startswith("state"):
        widths = tuple(int(d) for d in re.findall(r"\d+", case))
        statics, state = _edge_state(statics, state, widths, sum(widths))
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods, _port_flags(jflags))
    masks = jax.jit(jscan.filter_and_score, static_argnums=3)
    seen = set()
    for i in range(len(pods[0])):
        ev = masks(statics, state, tuple(x[i] for x in pods), jflags)
        want = sum(np.asarray(getattr(ev, m)).astype(np.uint8) << b for b, m in enumerate(MASKS))
        tscan.filter_pod_plain(buf, i)
        np.testing.assert_array_equal(buf.stage.numpy(), want, err_msg=f"pod {i}")
        seen |= set(want.tolist())
    # every stage fails first somewhere on the seeded states
    if case.startswith("state"):
        assert {0, 1, 3, 7, 15, 31, 63} <= seen, seen


STORAGE_V = [1, 4, 5, 8, 9, 36]


def _storage_inputs(rng, n, v):
    """Seeded VG and device rows of width V = SD over N nodes (node 0 with
    no VG, node 1 with no storage, VG ids 0..5 with -1 pads), and the claims
    of 9 pods: named, unnamed binpack, several, missing VG, failing, padding,
    devices of media 1 and 2, LVM and devices together."""
    name = rng.integers(-1, 6, (n, v)).astype(np.int32)
    name[0] = -1
    free = (rng.integers(0, 60, (n, v)) * F32(1.25 * GI)).astype(F32)
    cap = (free + rng.integers(1, 40, (n, v)) * F32(GI)).astype(F32)
    has = rng.random(n) < 0.9
    has[1] = False
    sfree = rng.random((n, v)) < 0.7
    scap = (rng.integers(1, 12, (n, v)) * F32(50 * GI)).astype(F32)
    media = rng.integers(0, 3, (n, v)).astype(np.int32)
    g = lambda k: F32(k * 1.25 * GI)  # noqa: E731
    lvm = [([g(8)], [2]), ([g(20)], [-1]), ([g(6), g(30), g(4)], [-1, 1, -1]), ([g(4), g(4)], [-1, -2]),
           ([g(500)], [-1]), ([F32(0)], [-1]), ([F32(0)], [-1]), ([F32(0)], [-1]), ([g(10), g(10)], [-1, -1])]
    dev = [[], [], [], [], [], [(F32(100 * GI), 1)], [(F32(50 * GI), 2), (F32(300 * GI), 1)],
           [(F32(5000 * GI), 1)], [(F32(50 * GI), 1)]]
    l, k = 3, 2
    lvm_size = np.zeros((len(lvm), l), F32)
    lvm_vg = np.full((len(lvm), l), -1, np.int32)
    dev_size = np.zeros((len(lvm), k), F32)
    dev_media = np.zeros((len(lvm), k), np.int32)
    for j, ((sizes, vids), devs) in enumerate(zip(lvm, dev)):
        lvm_size[j, :len(sizes)] = sizes
        lvm_vg[j, :len(vids)] = vids
        for q, (size, m) in enumerate(devs):
            dev_size[j, q], dev_media[j, q] = size, m
    return (free, name, cap, has, sfree, scap, media), (lvm_size, lvm_vg, dev_size, dev_media)


def _storage_case(edge_problem, v):
    """The edge problem's statics and state with _storage_inputs' rows at
    V = SD = v, its 9 storage pods in a batch, and the JAX package's plans
    and raw scores of each: [(pod, ok, alloc, take, raw)]."""
    tensors, batch, statics, state, pods = edge_problem
    rng = np.random.default_rng(v)
    (free, name, cap, has, sfree, scap, media), claims = _storage_inputs(rng, tensors.n_nodes, v)
    p = len(claims[0])
    stc = tscan.statics_from_numpy(_numpy_tree(statics._replace(
        vg_name_id=jnp.asarray(name), vg_cap=jnp.asarray(cap), has_storage=jnp.asarray(has),
        sdev_cap=jnp.asarray(scap), sdev_media=jnp.asarray(media))), "cpu")
    st = tstate.state_from_numpy(_numpy_tree(state._replace(vg_free=jnp.asarray(free),
                                                            sdev_free=jnp.asarray(sfree))), "cpu")
    gd = st.gpu_free.shape[1]
    batch_pods = (pods[0][:p], pods[1][:p], np.full(p, -1, np.int32), np.zeros(p, bool), *claims,
                  np.zeros(p, F32), np.zeros(p, np.int32), np.zeros((p, gd), np.int32))
    buf = tscan.StepBuffers(stc, st, batch_pods, tscan.StepFlags())
    assert buf.storage_live.all()
    lvm_plan, device_plan, score = jax.jit(js.lvm_plan), jax.jit(js.device_plan), jax.jit(js.open_local_score)
    lvm_size, lvm_vg, dev_size, dev_media = claims
    want = []
    for i in range(p):
        lvm_ok, alloc = lvm_plan(free, name, lvm_size[i], lvm_vg[i])
        dev_ok, take, tight = device_plan(sfree, scap, media, dev_size[i], dev_media[i])
        raw = score(alloc, cap, tight, jnp.sum(lvm_size[i] > 0), jnp.sum(dev_size[i] > 0))
        want.append((i, has & np.asarray(lvm_ok) & np.asarray(dev_ok), np.asarray(alloc), np.asarray(take),
                     np.asarray(raw)))
    return buf, want


@pytest.mark.parametrize("v", STORAGE_V)
def test_storage_plain_equals_the_jax_storage_plans(edge_problem, v):
    buf, want = _storage_case(edge_problem, v)
    fits = 0
    for i, ok, alloc, take, _ in want:
        tscan.storage_pod_plain(buf, i)
        np.testing.assert_array_equal(buf.st_ok.numpy(), ok, err_msg=f"pod {i}")
        np.testing.assert_array_equal(buf.st_alloc.numpy().view(np.int32), alloc.view(np.int32), err_msg=f"pod {i}")
        np.testing.assert_array_equal(buf.st_take.numpy(), take, err_msg=f"pod {i}")
        fits += int(ok.sum())
        if i == 4:  # the failing claim fits nowhere
            assert not ok.any()
    assert 0 < fits < buf.st_ok.numel() * len(want)


@pytest.mark.parametrize("v", STORAGE_V)
def test_storage_plain_raw_score_equals_the_jax_open_local_score(edge_problem, v):
    # the raw Open-Local score bit for bit (pod 2 takes three VGs on a node:
    # its per-VG usages sum in the reference's order)
    buf, want = _storage_case(edge_problem, v)
    for i, _, _, _, raw in want:
        tscan.storage_pod_plain(buf, i)
        np.testing.assert_array_equal(buf.st_raw.numpy().view(np.int32), raw.view(np.int32), err_msg=f"pod {i}")


# -- 4. the raw score's row sum in XLA's order --------------------------------

#: VG widths past XLA_ROW_PART: one split point (33, 36, 48, 64), three parts
#: (65, 72), four (100, 128)
STORAGE_V_WIDE = [33, 48, 64, 65, 72, 100, 128]


def _wide_storage_case(edge_problem, v):
    """_storage_case's rows at V = SD = v with a tenth pod of eight
    unnamed LVM claims, which binpack into eight VGs of a node wherever
    they fit: the per-VG usages fall into several of the row sum's parts."""
    tensors, batch, statics, state, pods = edge_problem
    rng = np.random.default_rng(1000 + v)
    (free, name, cap, has, sfree, scap, media), (lsz, lvg, dsz, dmd) = _storage_inputs(rng, tensors.n_nodes, v)
    name = np.where(name < 0, rng.integers(0, 6, name.shape), name).astype(np.int32)  # every VG live
    name[0] = -1
    p, l = len(lsz) + 1, 8
    lvm_size = np.zeros((p, l), F32)
    lvm_vg = np.full((p, l), -1, np.int32)
    lvm_size[:-1, :lsz.shape[1]], lvm_vg[:-1, :lvg.shape[1]] = lsz, lvg
    lvm_size[-1] = [F32(k * 1.25 * GI) for k in (3, 1, 7, 2, 5, 4, 6, 1)]
    dev_size = np.zeros((p, dsz.shape[1]), F32)
    dev_media = np.zeros((p, dmd.shape[1]), np.int32)
    dev_size[:-1], dev_media[:-1] = dsz, dmd
    stc = tscan.statics_from_numpy(_numpy_tree(statics._replace(
        vg_name_id=jnp.asarray(name), vg_cap=jnp.asarray(cap), has_storage=jnp.asarray(has),
        sdev_cap=jnp.asarray(scap), sdev_media=jnp.asarray(media))), "cpu")
    st = tstate.state_from_numpy(_numpy_tree(state._replace(vg_free=jnp.asarray(free),
                                                            sdev_free=jnp.asarray(sfree))), "cpu")
    gd = st.gpu_free.shape[1]
    batch_pods = (pods[0][:p], pods[1][:p], np.full(p, -1, np.int32), np.zeros(p, bool), lvm_size, lvm_vg,
                  dev_size, dev_media, np.zeros(p, F32), np.zeros(p, np.int32), np.zeros((p, gd), np.int32))
    buf = tscan.StepBuffers(stc, st, batch_pods, tscan.StepFlags())
    lvm_plan, device_plan, score = jax.jit(js.lvm_plan), jax.jit(js.device_plan), jax.jit(js.open_local_score)
    want = []
    for i in range(p):
        _, alloc = lvm_plan(free, name, lvm_size[i], lvm_vg[i])
        _, _, tight = device_plan(sfree, scap, media, dev_size[i], dev_media[i])
        raw = score(alloc, cap, tight, jnp.sum(lvm_size[i] > 0), jnp.sum(dev_size[i] > 0))
        want.append((i, np.asarray(alloc), np.asarray(raw)))
    return buf, cap, want


def _left_to_right(x):
    out = np.zeros(x.shape[0], F32)
    for j in range(x.shape[1]):
        out = (out + x[:, j]).astype(F32)
    return out


@pytest.fixture(scope="module")
def wide_storage_cases(edge_problem):
    return {v: _wide_storage_case(edge_problem, v) for v in STORAGE_V_WIDE}


@pytest.mark.parametrize("v", STORAGE_V_WIDE)
def test_storage_plain_raw_score_equals_the_jax_open_local_score_past_32_vgs(wide_storage_cases, v):
    buf, _, want = wide_storage_cases[v]
    spread = 0
    for i, alloc, raw in want:
        tscan.storage_pod_plain(buf, i)
        np.testing.assert_array_equal(buf.st_raw.numpy().view(np.int32), raw.view(np.int32), err_msg=f"pod {i}")
        np.testing.assert_array_equal(buf.st_alloc.numpy().view(np.int32), alloc.view(np.int32), err_msg=f"pod {i}")
        # nodes whose used VGs lie in two or more of the row sum's parts
        used = alloc > 0
        bounds = np.array([b for _, b in tstorage.xla_row_parts(v)])
        part_of = np.searchsorted(bounds, np.arange(v), side="right")
        spread += int(sum(len(set(part_of[row])) >= 2 for row in used if row.sum() >= 3))
    assert spread > 0


def test_the_xla_order_differs_from_left_to_right_on_the_wide_cases(wide_storage_cases):
    # the cases have teeth: on some node the reference's order gives
    # another last bit than a left-to-right sum would
    differs = 0
    for v, (_, cap, want) in wide_storage_cases.items():
        for _, alloc, _ in want:
            used = alloc > 0
            per_vg = np.where(used, alloc / np.maximum(cap, F32(1e-30)), F32(0)).astype(F32)
            lr = _left_to_right(per_vg)
            xla = tstorage.xla_row_sum(torch.from_numpy(per_vg)).numpy()
            differs += int((lr.view(np.int32) != xla.view(np.int32)).sum())
    assert differs > 0


@pytest.mark.parametrize("first", range(1, 301, 30))
def test_xla_row_sum_equals_the_jitted_jnp_sum(first):
    # every V in [first, first + 30), on 300 seeded rows whose exponents
    # spread over 2^-20 ... 2^20, three in ten zero; one jitted function
    # sums the 30 widths (one compile)
    widths = range(first, first + 30)
    xs = []
    for v in widths:
        rng = np.random.default_rng(v)
        x = (rng.random((300, v)) * np.exp2(rng.integers(-20, 21, (300, v)))).astype(F32)
        x[rng.random((300, v)) < 0.3] = 0
        xs.append(x)
    sums = jax.jit(lambda arrays: [jnp.sum(a, axis=1) for a in arrays])(xs)
    for v, x, want in zip(widths, xs, sums):
        got = tstorage.xla_row_sum(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32), np.asarray(want).view(np.int32), err_msg=f"V={v}")


def _device_parts(v: int) -> list:
    """ext_plans.cuh xla_row_sum's walk over a row of V columns, line for
    line: the column ranges it sums as one part."""
    part = tstorage.XLA_ROW_PART
    if v <= part:
        return [(0, v)]
    k = (v + part - 1) // part
    r = v - part * (k - 2)
    out, j = [], 0
    for p in range(k):
        n = (r + 1) // 2 if p == 0 else r // 2 if p == k - 1 else part
        out.append((j, j + n))
        j += n
    return out


def test_xla_row_split_mirrors_the_cuda_source():
    src = (cuda.CSRC / "ext_plans.cuh").read_text()
    assert _cuda_int(src, "XLA_ROW_PART") == tstorage.XLA_ROW_PART == 32
    for line in ("const int k = (n + XLA_ROW_PART - 1) / XLA_ROW_PART;",
                 "const int r = n - XLA_ROW_PART * (k - 2);",
                 "const int len = p == 0 ? (r + 1) / 2 : p == k - 1 ? r / 2 : XLA_ROW_PART;",
                 "const float per_sum = xla_row_sum<M>(V, "):
        assert line in src, line
    for v in range(1, 1025):
        assert _device_parts(v) == tstorage.xla_row_parts(v), v
    assert [b - a for a, b in tstorage.xla_row_parts(65)] == [17, 32, 16]
    assert [b - a for a, b in tstorage.xla_row_parts(72)] == [20, 32, 20]
    assert [b - a for a, b in tstorage.xla_row_parts(128)] == [32] * 4
