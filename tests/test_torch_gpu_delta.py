"""K6 `gpu_pod` and K13 `compact_delta`: their launch plans, their argument
blocks, and their plain versions against the JAX package.

1. `cuda.gpu_plan` at every template boundary (the register templates of
   1, 2, 4 and 8 devices, then the rows read in place; the preset row
   staged up to GPU_PRESET_SMEM bytes) and
   `cuda.compact_delta_plan` at its boundary (the grouping scratch in
   shared memory up to WAVE_SMEM, then in global scratch), with every node,
   (entry, slot) pair or (entry, element) walker on exactly one thread at
   N = 1 ... 100 000 and at every swept thread count: no width of GD, N,
   E or Tc is refused.
2. The argument blocks: the plans as `gpu_plan_struct` /
   `delta_plan_struct` build them, the ctypes mirrors and constants
   against the CUDA sources, the K6 wrapper passing each pod's GPU request
   as the buffers hold it and the K13 wrapper passing its plan, the
   domains' node lists and the entries uploaded in one copy (a recording
   stand-in for the library).
3. `gpu_pod_plain` against the JAX package's `simtpu/kernels/gpushare.py
   gpu_plan :25` at GD = 1, 2, 4, 5, 8, 9 and 40 on seeded rows: one-GPU
   pods on a grid of free memory (ties), multi-GPU stacking, several
   shares a device, preset rows, missing devices, nodes without a device,
   a request larger than every device, a count of 0.
4. `apply_placement_deltas_compact_plain` against the JAX package's
   `apply_placement_deltas_compact` at E = 1, 200 and 2000 entries drawn
   with repeats from a placed log (repeated nodes, w = 0 padding), evicted
   then restored, on a carry with tabular rows only and on one with dense
   rows. Tolerance 0: equal bools and ints, bit-identical f32.

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

import simtpu
import simtpu_torch
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.kernels import gpushare as jgpu
from simtpu_torch import synth
from simtpu_torch.core.tensorize import Tensorizer
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import cuda
from simtpu_torch.workloads.expand import get_valid_pods_exclude_daemonset

from .test_torch_compact import _assert_equal, _entries_of, _pack, _place
from .test_torch_filter_storage import _FakeLib
from .test_torch_launch_plans import _cuda_int, _struct_fields
from ._threads import one_torch_thread  # noqa: F401 (autouse)

F32 = np.float32
NODES = (1, 31, 32, 120, 1000, 1024, 1025, 2000, 5000, 9000, 16385, 100000)
GPU_WIDTHS = (1, 2, 4, 5, 8, 9, 40)
#: (per-GPU memory MiB, count, preset devices; -1 the last device)
GPU_REQS = ((4096, 1, ()), (8192, 1, ()), (16384, 1, ()), (2048, 2, ()), (4096, 3, ()), (1024, 7, ()),
            (4096, 2, (0, 1)), (4096, 1, (-1,)), (1 << 30, 1, ()), (1 << 30, 3, ()), (4096, 0, ()), (0, 0, ()))


# -- 1. the launch plans ------------------------------------------------------


def _covers(threads: int, blocks: int, work: int) -> None:
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert blocks * threads >= work and (blocks - 1) * threads < max(work, 1)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("threads", [None, 32, 64, 128, 256, 512, 1024])
def test_gpu_plan_covers_every_node_once(n, threads):
    for gd in GPU_WIDTHS:
        plan = cuda.gpu_plan(n, gd, threads)
        _covers(plan["threads"], plan["blocks"], max(n, 1))
        assert plan["threads"] <= cuda.GPU_MAX_THREADS
        if threads is None:
            assert plan["threads"] == min(cuda.GPU_THREADS, max(-(-n // 32) * 32, 32))


@pytest.mark.parametrize("gd, template, reg", [(0, "registers", 1), (1, "registers", 1), (2, "registers", 2),
                                               (3, "registers", 4), (4, "registers", 4), (5, "registers", 8),
                                               (8, "registers", 8), (9, "global", 0), (40, "global", 0),
                                               (4096, "global", 0), (4097, "global", 0)])
def test_gpu_plan_templates(gd, template, reg):
    plan = cuda.gpu_plan(1000, gd)
    assert (plan["template"], plan["reg"]) == (template, reg)
    # the register templates stage the preset row in static shared memory,
    # the rows read in place in dynamic shared memory up to GPU_PRESET_SMEM
    staged = bool(reg) or 4 * gd <= cuda.GPU_PRESET_SMEM
    assert (plan["staged"], plan["smem"]) == (int(staged), 4 * gd if staged and not reg else 0)
    assert plan["smem"] <= cuda.GPU_PRESET_SMEM < 48 * 1024


def test_gpu_plan_takes_any_template_that_holds_the_width():
    for threads in (32, 64, 128, 256, 512):
        for template in ("registers", "global"):
            plan = cuda.gpu_plan(5000, 8, threads, template)
            assert plan["template"] == template and plan["threads"] == threads
    assert cuda.gpu_plan(5000, 3, None, "global")["reg"] == 0


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("e, tc, width", [(0, 4, 20), (1, 0, 20), (1, 4, 5), (200, 4, 20), (2048, 4, 27),
                                          (200, 512, 9), (150000, 1, 3)])
def test_delta_plan_covers_every_pair_and_walker_once(n, e, tc, width):
    for threads in (None, 32, 256, 1024):
        plan = cuda.compact_delta_plan(n, e, tc, width, threads)
        t = plan["threads"]
        assert 32 <= t <= cuda.DELTA_MAX_THREADS and t % 32 == 0
        for blocks, per, work in ((plan["pair_blocks"], t, e * tc),
                                  (plan["walk_blocks"], cuda.DELTA_WALK_THREADS, e * width)):
            assert blocks * per >= work and (blocks == 0 or (blocks - 1) * per < work)
        # a segment a warp at most, and a chunk of 32 entries; in shared
        # memory as many as fit
        segs = plan["segs"]
        assert 1 <= segs <= max(min(t // 32, -(-e // 32)), 1)
        group = 4 * n + 12 * e + 8 * e * segs
        shared = 4 * n + 20 * e <= cuda.WAVE_SMEM
        assert (plan["shared"], plan["smem"]) == ((1, group) if shared else (0, 0))
        assert group <= cuda.WAVE_SMEM or not shared
        if shared and segs < min(t // 32, -(-e // 32)):
            assert group + 8 * e > cuda.WAVE_SMEM  # one more does not fit
        if not shared:
            assert segs == max(min(t // 32, -(-e // 32)), 1)
        assert plan["scratch_words"] == 4 + 7 * e + (0 if shared else group // 4)


def test_delta_plan_moves_the_grouping_scratch_to_global_memory_past_the_budget():
    e = 2048
    n = (cuda.WAVE_SMEM - 20 * e) // 4
    assert cuda.compact_delta_plan(n, e, 4, 20)["group"] == "shared"
    assert cuda.compact_delta_plan(n, e, 4, 20)["segs"] == 1
    assert cuda.compact_delta_plan(n + 1, e, 4, 20)["group"] == "global"
    assert cuda.compact_delta_plan(1000, e, 4, 20, budget=0)["group"] == "global"
    # the segments: as many as fit, a warp each at most
    fit = (cuda.WAVE_SMEM - 4000 - 24000) // 16000
    assert fit == 11 and cuda.compact_delta_plan(1000, 2000, 4, 20, 1024)["segs"] == fit
    assert cuda.compact_delta_plan(1000, 2000, 4, 20, 256)["segs"] == 8
    assert cuda.compact_delta_plan(1000, 200, 4, 20, 1024)["segs"] == 7
    assert cuda.compact_delta_plan(1000, 2000, 4, 20, 1024, budget=0)["segs"] == 32


# -- 2. the argument blocks ---------------------------------------------------


def test_gpu_and_delta_blocks_mirror_the_cuda_sources():
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    k6 = (cuda.CSRC / "gpu_pod.cu").read_text()
    k13 = (cuda.CSRC / "compact_delta.cu").read_text()
    runs = (cuda.CSRC / "delta_runs.cuh").read_text()  # K13's plan, grouping and walk, shared with K7
    step = (cuda.CSRC / "step_ctx.cuh").read_text()
    for text, struct in ((k6, "GpuRequest"), (k6, "GpuPlan"), (runs, "DeltaPlan"), (step, "CompactCtx")):
        assert [(f, kinds[t]) for f, t in getattr(cuda, struct)._fields_] == _struct_fields(text, struct), struct
    for name in ("GPU_MAX_THREADS", "GPU_REG", "GPU_PRESET_SMEM"):
        assert _cuda_int(k6, name) == getattr(cuda, name), name
    assert _cuda_int(runs, "DELTA_MAX_THREADS") == cuda.DELTA_MAX_THREADS
    assert _cuda_int(runs, "DELTA_WALK_THREADS") == cuda.DELTA_WALK_THREADS
    for w in cuda.GPU_REG_WIDTHS[:-1]:
        assert f"case {w}: return launch_gpu<{w}>" in k6
    assert "case GPU_REG: return launch_gpu<GPU_REG>" in k6 and "default: return launch_gpu<0>" in k6
    assert "q.smem >= 4LL * n + 4LL * e * (3 + 2 * q.segs)" in runs and "q.segs <= q.threads / 32" in runs
    assert "p.scratch + 4 + 7 * static_cast<size_t>(x.e)" in runs
    # the dense adds walk the chosen node's domain, the node rows take K7's
    # arithmetic element by element (delta_rows.cuh, as K18 does)
    assert "x.dom_start[dom]" in k13 and "delta_node_operand(rows, en.x, en.y, __int_as_float(en.z), i)" in runs


def test_the_gpu_arithmetic_lives_once_in_the_header():
    # K6 calls gpu_plan, which K10, K19 and K20 call through gpu_node: no
    # division, floor or tightest-fit key of its own
    k6 = (cuda.CSRC / "gpu_pod.cu").read_text()
    plans = (cuda.CSRC / "ext_plans.cuh").read_text()
    code = re.sub(r"//[^\n]*", "", k6)
    for token in ("__fdiv_rn", "floorf", "tight_key", "count_f"):
        assert token not in code, token
    assert code.count("gpu_plan(q, ") == 2 and plans.count("floorf(") == 1
    for caller in ("explain_pass.cu", "sweep_place.cu", "wave_hard.cu"):
        assert "gpu_node(x, i, n)" in (cuda.CSRC / caller).read_text(), caller


class _Ctx:
    def __init__(self, n, gd):
        self.ctx = cuda.StepCtx(n=n, gd=gd)
        self.gpu_host = [(4096.0, 1, 0)]
        self.gpu_plan = self.gpu_plan_ptr = self.gpu_reqs = None


@pytest.mark.parametrize("n", [120, 1000, 5000, 100000])
@pytest.mark.parametrize("gd", [1, 3, 8, 9, 40, 400])
def test_gpu_plan_as_the_argument_block_carries_it(n, gd):
    buf = _Ctx(n, gd)
    got = cuda.gpu_plan_struct(buf)
    want = cuda.gpu_plan(n, gd)
    fields = [f for f, _ in cuda.GpuPlan._fields_ if f != "reqs"]
    assert {f: getattr(got, f) for f in fields} == {f: want[f] for f in fields}
    assert got.reqs == ctypes.addressof(buf.gpu_reqs) and buf.gpu_plan_ptr == ctypes.addressof(got)
    assert cuda.gpu_plan_struct(buf) is got  # built once per buffer
    other = cuda.gpu_plan_struct(buf, 128, "global")
    assert (other.threads, other.reg) == (128, 0) and buf.gpu_plan is got


@pytest.fixture(scope="module")
def gpu_problem():
    """A small cluster of the port (40 nodes, GPU nodes among them) and a
    batch of its pods, tensorized: (statics, state, pod arrays, flags)."""
    cluster = synth.synth_cluster(40, seed=8, zones=2, taint_frac=0.0, gpu_frac=0.5)
    apps = synth.synth_apps(12, seed=9, zones=2, pods_per_deployment=4, gpu_frac=0.5)
    pods = [p for a in apps for p in get_valid_pods_exclude_daemonset(a.resource)]
    tz = Tensorizer(cluster.nodes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, arrays = tscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    statics = tscan.statics_from(tensors, None, "cpu")
    state = tstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), F32), None, "cpu")
    return statics, state, [np.asarray(a) for a in arrays], tscan.flags_from(tensors, batch.ext)


def _gpu_inputs(n, gd, seed):
    """Seeded GPU rows of GD devices on N nodes — 8, 16 or 24 GiB a device,
    free memory on a grid of quarters, one device in five missing, every
    7th node without a device, every 5th node's total short of one device,
    every 3rd node's last device a twin of its first — and the GPU_REQS'
    mem, count and preset rows."""
    rng = np.random.default_rng(seed)
    exists = rng.random((n, gd)) < 0.8
    exists[::7] = False
    cap = rng.choice(np.array([8192, 16384, 24576], F32), (n, gd))
    free = np.where(exists, cap * rng.choice(np.array([0, 0.25, 0.5, 0.75, 1], F32), (n, gd)), 0).astype(F32)
    # every third node's last device a twin of its first: ties
    exists[::3, -1], free[::3, -1] = exists[::3, 0], free[::3, 0]
    total = (cap * exists).sum(axis=1, dtype=F32)
    total[::5] = 2048
    mem = np.array([m for m, _, _ in GPU_REQS], F32)
    count = np.array([c for _, c, _ in GPU_REQS], np.int32)
    preset = np.zeros((len(GPU_REQS), gd), np.int32)
    for j, (_, _, devs) in enumerate(GPU_REQS):
        for d in devs:
            preset[j, d % gd] = 1
    return exists, free, total, mem, count, preset


def _gpu_buffers(gpu_problem, gd, seed):
    statics, state, arrays, flags = gpu_problem
    n = statics.alloc.shape[0]
    exists, free, total, mem, count, preset = _gpu_inputs(n, gd, seed)
    p = len(GPU_REQS)
    base = [np.resize(a, (p,) + a.shape[1:]) for a in arrays[:8]]
    s = statics._replace(gpu_dev_exists=torch.from_numpy(exists), gpu_total=torch.from_numpy(total))
    st = state._replace(gpu_free=torch.from_numpy(free))
    buf = tscan.StepBuffers(s, st, (*base, mem, count, preset), flags)
    return buf, (exists, free, total, mem, count, preset)


def test_the_gpu_wrapper_passes_each_pods_request(monkeypatch, gpu_problem):
    buf, (_, _, _, mem, count, preset) = _gpu_buffers(gpu_problem, 5, 3)
    assert buf.gpu_host == [(float(m), int(c), int(p.sum() > 0)) for m, c, p in zip(mem, count, preset)]
    assert {h[2] for h in buf.gpu_host} == {0, 1}
    libs = {name: _FakeLib() for name in cuda.KERNELS}
    monkeypatch.setattr(cuda, "build", lambda: libs)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(cuda, "LAUNCHES", Counter())  # the process's counter untouched
    for i in range(buf.n_pods):
        cuda.launch("gpu_pod", buf, i)
    assert cuda.LAUNCHES == {"gpu_pod": buf.n_pods}
    plan = buf.gpu_plan
    for i, (name, (ctx, pod, plan_ptr, stream)) in enumerate(libs["gpu_pod"].calls):
        assert name == "simtpu_gpu_pod" and (pod, plan_ptr, stream) == (i, ctypes.addressof(plan), 7)
    assert plan.reg == 8 and plan.blocks * plan.threads >= buf.ctx.n
    # the entry reads pod i's request from the plan's host array
    reqs = ctypes.cast(plan.reqs, ctypes.POINTER(cuda.GpuRequest))
    for i, (m, c, ps) in enumerate(buf.gpu_host):
        r = reqs[i]
        assert (r.mem, r.count, r.preset_set) == (m, c, ps) and F32(r.mem) == mem[i]
    assert cuda.gpu_plan_struct(buf, 64, "global").reqs == plan.reqs


@pytest.fixture(scope="module")
def placed():
    """The JAX package's and the port's engines placing the tabular and the
    wide problems of tests/test_torch_compact.py in one batch each."""
    return {name: (_place(simtpu, name, compact=True, batches=1)[0],
                   _place(simtpu_torch, name, compact=True, batches=1)[0]) for name in ("tabular", "wide")}


def _delta_inputs(placed, name, e, seed, sign=-1.0):
    j_eng, t_eng = placed[name]
    tensors = t_eng.tensorizer.freeze()
    n = tensors.n_nodes
    idx = np.random.default_rng(seed).choice(len(t_eng.placed_node), e, replace=True).tolist()
    return (j_eng, t_eng, tensors, n, idx, _pack(simtpu_torch, tensors, _entries_of(t_eng, idx), sign))


def test_the_delta_wrapper_passes_its_plan_and_one_upload(monkeypatch, placed):
    _, t_eng, tensors, n, _, packed = _delta_inputs(placed, "wide", 200, 5)
    statics = tscan.statics_from(tensors, None, "cpu")
    dspec = tstate.compact_delta_spec(tensors)
    ndom, nds = tstate.node_dom_for(tensors, n, "cpu"), tstate.node_dom_small_for(tensors, n, "cpu")
    cstate = tstate.compress_state_plain(tstate.compact_spec(tensors).dev, t_eng.carried_state())
    libs = {name: _FakeLib() for name in cuda.KERNELS}
    monkeypatch.setattr(cuda, "build", lambda: libs)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 7, raising=False)
    monkeypatch.setattr(cuda, "LAUNCHES", Counter())  # the process's counter untouched
    cuda.launch_compact_delta(statics, dspec, ndom, nds, cstate, packed)
    assert cuda.LAUNCHES == {"compact_delta": 1}
    (name, (ctx, plan, stream)), = libs["compact_delta"].calls
    ctx, plan = ctx._obj, plan._obj
    width = ctx.r + ctx.p + 2 * ctx.w + ctx.v + ctx.sd + ctx.gd
    want = cuda.compact_delta_plan(n, 256, statics.g_terms.shape[1], width)
    assert name == "simtpu_compact_delta" and stream == 7 and ctx.e == 256 and cuda.delta_plan_of(ctx) == want
    fields = ("threads", "pair_blocks", "walk_blocks", "segs", "shared", "smem")
    assert {f: getattr(plan, f) for f in fields} == {f: want[f] for f in fields} and want["walk_blocks"] > 0
    assert plan.scratch == cuda._DELTA_SCRATCH["cpu"].data_ptr()
    start, nodes = cuda.domain_nodes(ndom)
    assert cuda.domain_nodes(ndom) is ndom._domain_nodes and ctx.dom_start == start.data_ptr()
    assert ctx.dom_nodes == nodes.data_ptr() and ctx.node_dom == ndom.data_ptr()
    # the seven entry arrays in one buffer, 16-byte aligned
    ptrs = [getattr(ctx, f) for f, _ in cuda.ENTRY_FIELDS]
    assert all(p % 16 == 0 for p in ptrs) and ptrs == sorted(ptrs)
    assert ptrs[-1] - ptrs[0] < 256 * 64
    # past the budget the grouping scratch joins the runs in the wrapper's
    glob = cuda.delta_plan_struct(ctx, torch.device("cpu"), budget=0)
    assert glob.shared == 0 and glob.smem == 0 and glob.scratch
    assert glob.segs == cuda.compact_delta_plan(n, 256, statics.g_terms.shape[1], width, budget=0)["segs"]
    assert cuda._DELTA_SCRATCH["cpu"].numel() >= 4 + 7 * 256 + n + 256 * (3 + 2 * glob.segs)


def test_domain_nodes_list_every_domain_once(placed):
    _, t_eng = placed["wide"]
    tensors = t_eng.tensorizer.freeze()
    ndom = tstate.node_dom_for(tensors, tensors.n_nodes + 3, "cpu")  # padded nodes have no domain
    start, nodes = (t.numpy() for t in cuda.domain_nodes(ndom))
    dom = ndom.numpy()
    assert start[0] == 0 and start[-1] == (dom >= 0).sum() == len(nodes)
    for d in range(len(start) - 1):
        key, want = np.nonzero(dom == d)
        assert len(set(key)) <= 1 and nodes[start[d]:start[d + 1]].tolist() == want.tolist(), d


def test_upload_entries_round_trips_the_packed_arrays(placed):
    *_, packed = _delta_inputs(placed, "wide", 37, 6)
    got = cuda.upload_entries(packed, torch.device("cpu"))
    assert list(got) == [f for f, _ in cuda.ENTRY_FIELDS]
    for (name, dt), want in zip(cuda.ENTRY_FIELDS, packed):
        assert got[name].dtype == dt and got[name].is_contiguous()
        assert np.array_equal(got[name].numpy(), np.asarray(want)), name
    assert len({t.untyped_storage().data_ptr() for t in got.values()}) == 1


# -- 3. the GPU plan against the JAX package ---------------------------------


@pytest.mark.parametrize("gd", GPU_WIDTHS)
def test_gpu_plain_equals_the_jax_gpu_plan(gpu_problem, gd):
    buf, (exists, free, total, mem, count, preset) = _gpu_buffers(gpu_problem, gd, 100 + gd)
    plan = jax.jit(jgpu.gpu_plan)
    seen = {"ties": 0, "stacked": 0, "preset": 0, "none": 0}
    for i in range(buf.n_pods):
        fits, shares = plan(free, exists, total, jnp.float32(mem[i]), jnp.int32(count[i]), preset[i])
        fits, shares = np.asarray(fits), np.asarray(shares)
        tscan.gpu_pod_plain(buf, i)
        np.testing.assert_array_equal(buf.gpu_ok.numpy(), fits, err_msg=f"pod {i}")
        np.testing.assert_array_equal(buf.gpu_sh.numpy().view(np.int32), shares.view(np.int32), err_msg=f"pod {i}")
        fit_free = np.where(exists & (free >= mem[i]), free, np.inf)
        if count[i] == 1 and mem[i] > 0:
            best = fit_free.min(axis=1, keepdims=True)
            seen["ties"] += int(((fit_free == best) & np.isfinite(best)).sum(axis=1).max() > 1)
        seen["stacked"] += int((shares > 1).any() or ((shares > 0).sum(axis=1) > 1).any())
        seen["preset"] += int(preset[i].sum() > 0 and fits.any())
        seen["none"] += int(not fits.any())
    # the cases the requests are there for happen: ties (past one device),
    # stacking, honoured presets, requests that fit nowhere
    assert seen["stacked"] and seen["preset"] and seen["none"], seen
    assert gd == 1 or seen["ties"], seen


# -- 4. the compact delta against the JAX package -----------------------------


@pytest.mark.parametrize("e", [1, 200, 2000])
@pytest.mark.parametrize("name, expect_dense", [("tabular", False), ("wide", True)])
def test_compact_delta_plain_equals_the_jax_delta(placed, name, expect_dense, e):
    j_eng, t_eng, tensors, n, idx, _ = _delta_inputs(placed, name, e, e)
    j_tensors = j_eng.tensorizer.freeze()
    j_statics = jscan.statics_from(j_tensors, None)
    t_statics = tscan.statics_from(tensors, None, "cpu")
    dspec = tstate.compact_delta_spec(tensors)
    ndom, nds = tstate.node_dom_for(tensors, n, "cpu"), tstate.node_dom_small_for(tensors, n, "cpu")
    j_maps = (jstate.compact_delta_spec(j_tensors), jstate.node_dom_for(j_tensors, n),
              jstate.node_dom_small_for(j_tensors, n))
    want = jstate.compress_state(jstate.compact_spec(j_tensors).dev, j_eng.carried_state())
    got = tstate.compress_state_plain(tstate.compact_spec(tensors).dev, t_eng.carried_state())
    assert (got.cm_dense.shape[0] > 0) == expect_dense
    nodes = np.asarray(t_eng.placed_node)[idx]
    assert e == 1 or len(np.unique(nodes)) < e  # repeated nodes
    # the long batch is evicted only (the plain walk is slow on one thread)
    signs = (-1.0,) if e == 2000 else (-1.0, 1.0)
    for sign in signs:
        j_packed = _pack(simtpu, j_tensors, _entries_of(j_eng, idx), sign)
        packed = _pack(simtpu_torch, tensors, _entries_of(t_eng, idx), sign)
        assert len(packed[0]) == 1 << max(e - 1, 0).bit_length() and (e in (1,) or (packed[2] == 0).any())
        want = jstate.apply_placement_deltas_compact(j_statics, *j_maps, want, j_packed)
        tstate.apply_placement_deltas_compact_plain(t_statics, dspec, ndom, nds, got, packed)
        _assert_equal(got, want, f"{name}, E={e}, w = {sign:+.0f}")
