"""simtpu_torch's plain PyTorch step against the JAX package, bit for bit.

1. Every function of `kernels/filters.py` and `kernels/scores.py`: the
   JAX function, jitted as the compiled step runs it, against the port's
   plain version on the same seeded numpy inputs, including degenerate
   lanes (empty mask, zero range, no term rows, all rows -1). Masks and
   scores must be exactly equal. Jitted, not eager: XLA's CPU backend
   contracts `a * b + c` into one FMA inside a fusion, and the port
   reproduces the compiled form (simtpu_torch/kernels/fp.py).
2. The row helpers `take_rows`, `take_rows_i32`, `add_rows` (index ops in
   the port, one-hot matmuls in the JAX package).
3. The composed step: the JAX package's serial scan against the port's
   K1→K4 plain chain over a few hundred pods of a small problem with host
   ports, exclusive volumes, hard and soft spread, required and preferred
   (anti-)affinity, pins (-2 included), forced pods and invalid nodes, for
   several StepFlags combinations. Node, reason and every state plane must
   be equal (`diff_state_planes` on the port's planes carried back).

All inputs come from numpy seeds and reach both packages as numpy arrays.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simtpu.kernels.filters as jf
import simtpu.kernels.scores as js
from simtpu.core.tensorize import Tensorizer
from simtpu.engine import scan as jscan
from simtpu.engine import state as jstate
from simtpu.synth import make_deployment, synth_apps, synth_cluster
from simtpu.workloads.expand import get_valid_pods_exclude_daemonset, seed_name_hashes
from simtpu_torch.engine import scan as tscan
from simtpu_torch.engine import state as tstate
from simtpu_torch.kernels import filters as tf
from simtpu_torch.kernels import scores as ts
from simtpu_torch.kernels.fp import fma
from ._threads import one_torch_thread  # noqa: F401 (autouse)

N, R, T, P, W, C = 37, 4, 6, 3, 5, 2
F32 = np.float32


def _inputs(kind: str, seed: int):
    """Seeded inputs for every function; `kind` picks a degenerate lane."""
    rng = np.random.default_rng(seed)
    t = 0 if kind == "no_terms" else T
    free = (rng.integers(0, 4000, (N, R)) * rng.choice([1.0, 1e-3, 1e6], (N, R))).astype(F32)
    alloc = (free + rng.integers(0, 4000, (N, R))).astype(F32)
    alloc[::7, 1] = 0
    free[::5, 0] = alloc[::5, 0]  # exact fits
    req = rng.integers(0, 500, R).astype(F32)
    req[::3] = 0
    mask = rng.random(N) < 0.6
    score = (rng.standard_normal(N) * 50).astype(F32)
    cnt = rng.integers(0, 40, (t, N)).astype(F32)
    if kind == "empty_mask":
        mask[:] = False
    if kind == "zero_range":
        score[:] = F32(7.0)
        cnt[:] = F32(3.0)
    return dict(
        free=free, alloc=alloc, req=req, mask=mask, score=score,
        intol=rng.integers(0, 4, N).astype(F32) * (kind != "zero_range"),
        cnt=cnt, valid=rng.random((t, N)) < 0.85,
        own=(rng.random((t, N)) < 0.2).astype(F32),
        wown=rng.integers(0, 9, (t, N)).astype(F32),
        soft=rng.integers(0, 3, t).astype(F32),
        skew=rng.integers(0, 3, t).astype(F32),
        flags_t=[rng.random(t) < 0.5 for _ in range(5)],
        wt=[rng.integers(0, 100, t).astype(F32) for _ in range(2)],
        ports_used=(rng.random((N, P)) < 0.3).astype(F32),
        want_p=rng.random(P) < 0.4,
        vols=[(rng.random((N, W)) < 0.3).astype(F32) for _ in range(2)],
        want_w=[rng.random(W) < 0.3 for _ in range(3)],
        class_mask=rng.random((C, W)) < 0.6,
        limits=rng.integers(0, 4, (N, C)).astype(F32),
        hosts=rng.integers(0, 9, N).astype(F32),
        zones=rng.integers(0, 40, N).astype(F32),
    )


def _args(name, a):
    ft = a["flags_t"]
    return {
        "resources_fit": (a["free"], a["req"]),
        "ports_conflict_free": (a["ports_used"], a["want_p"]),
        "volume_conflict_free": (a["vols"][0], a["vols"][1], a["want_w"][0], a["want_w"][1]),
        "attach_limits_ok": (a["vols"][0], a["want_w"][2], a["class_mask"], a["limits"]),
        "topology_spread_filter": (a["cnt"], a["valid"], a["skew"], a["mask"]),
        "interpod_filter": (a["cnt"], a["own"], a["valid"], a["cnt"].sum(1), ft[0], ft[1], ft[2]),
        "minmax_normalize": (a["score"], a["mask"]),
        "maxabs_normalize": (a["score"], a["mask"]),
        "least_allocated": (a["free"], a["alloc"], a["req"]),
        "balanced_allocation": (a["free"], a["alloc"], a["req"]),
        "simon_share": (a["alloc"], a["req"]),
        "taint_toleration_score": (a["intol"], a["mask"]),
        "spread_score_from_raw": (a["soft"] @ a["cnt"], a["mask"]),
        "topology_spread_score": (a["cnt"], a["soft"], a["mask"]),
        "selector_spread_compose": (
            a["hosts"], a["zones"], a["hosts"][a["mask"]].max(initial=0),
            a["zones"][a["mask"]].max(initial=0), bool(ft[4].any()),
        ),
        "selector_spread_from_counts": (a["hosts"], a["zones"], bool(ft[4].any()), a["mask"]),
        "selector_spread_score": (a["cnt"], ft[3], ft[4], a["mask"]),
        "interpod_score": (a["cnt"], a["own"], a["wown"], a["wown"][::-1].copy(), ft[0], a["wt"][0], a["wt"][1]),
    }[name]


FILTERS = ("resources_fit", "ports_conflict_free", "volume_conflict_free",
           "attach_limits_ok", "topology_spread_filter", "interpod_filter")
SCORES = ("minmax_normalize", "maxabs_normalize", "least_allocated", "balanced_allocation",
          "simon_share", "taint_toleration_score", "spread_score_from_raw",
          "topology_spread_score", "selector_spread_compose", "selector_spread_from_counts",
          "selector_spread_score", "interpod_score")
TERM_FNS = {"topology_spread_filter", "interpod_filter", "topology_spread_score",
            "selector_spread_score", "interpod_score"}
MASK_FNS = {"topology_spread_filter", "minmax_normalize", "maxabs_normalize",
            "taint_toleration_score", "spread_score_from_raw", "topology_spread_score",
            "selector_spread_from_counts", "selector_spread_score"}
RANGE_FNS = {"minmax_normalize", "taint_toleration_score", "spread_score_from_raw",
             "topology_spread_score", "selector_spread_score"}
CASES = (
    [(f, "random") for f in FILTERS + SCORES]
    + [(f, "empty_mask") for f in sorted(MASK_FNS)]
    + [(f, "zero_range") for f in sorted(RANGE_FNS)]
    + [(f, "no_terms") for f in sorted(TERM_FNS)]
)


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{f}-{k}" for f, k in CASES])
def test_function_bit_identical(name, kind):
    args = _args(name, _inputs(kind, seed=len(name) * 31 + len(kind)))
    jmod, tmod = (jf, tf) if name in FILTERS else (js, ts)
    want = np.asarray(jax.jit(getattr(jmod, name))(*[jnp.asarray(x) for x in args]))
    got = getattr(tmod, name)(*[torch.as_tensor(np.asarray(x)) for x in args]).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fma_is_single_rounding():
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(20000).astype(F32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    exact = (a.astype(np.float64) * b + c).astype(F32)  # agrees off ties
    got = fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == exact).mean() > 0.999


@pytest.mark.parametrize("rows", [[2, -1, 0, 5], [-1, -1, -1], []], ids=["mixed", "all_pad", "empty"])
@pytest.mark.parametrize("height", [0, 7, 600], ids=["h0", "h7", "h600"])
def test_row_ops(rows, height):
    rng = np.random.default_rng(height)
    rows = np.asarray([r for r in rows if r < height] if height else [-1] * len(rows), np.int32)
    plane = rng.integers(0, 50, (height, 9)).astype(F32)
    delta = rng.integers(0, 5, (len(rows), 9)).astype(F32)
    np.testing.assert_array_equal(
        tstate.take_rows(torch.as_tensor(plane), torch.as_tensor(rows)).numpy(),
        np.asarray(jstate.take_rows(jnp.asarray(plane), jnp.asarray(rows))),
    )
    np.testing.assert_array_equal(
        tstate.take_rows_i32(torch.as_tensor(plane.astype(np.int32)), torch.as_tensor(rows)).numpy(),
        np.asarray(jstate.take_rows_i32(jnp.asarray(plane.astype(np.int32)), jnp.asarray(rows))),
    )
    mine = torch.as_tensor(plane.copy())
    tstate.add_rows(mine, torch.as_tensor(rows), torch.as_tensor(delta))
    if height:
        want = np.asarray(jstate.add_rows(jnp.asarray(plane), jnp.asarray(rows), jnp.asarray(delta)))
        np.testing.assert_array_equal(mine.numpy(), want)


# -- the composed step ------------------------------------------------------


def _volume_pod(name: str, disk: str, read_only: bool) -> dict:
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "vols", "labels": {"app": name}},
        "spec": {
            "containers": [{"name": "c", "image": "x",
                            "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}],
            "volumes": [{"name": "d", "gcePersistentDisk": {"pdName": disk, "readOnly": read_only}}],
        },
    }


@pytest.fixture(scope="module")
def problem():
    """A small JAX-tensorized problem: 40 nodes in 4 zones, ~300 pods."""
    seed_name_hashes(5)
    try:
        cluster = synth_cluster(40, seed=8, zones=4, taint_frac=0.2)
        apps = synth_apps(
            220, seed=9, zones=4, pods_per_deployment=20, selector_frac=0.3,
            toleration_frac=0.3, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.5,
            affinity_frac=0.15, spread_frac=0.5, spread_hard_frac=0.5,
        )
        pods = []
        for app in apps:
            pods.extend(get_valid_pods_exclude_daemonset(app.resource))
        for k in range(3):
            dep = make_deployment(f"port-{k}", 14, 300, 256, host_port=8080 + (k % 2))
            res = type(apps[0].resource)(deployments=[dep])
            pods.extend(get_valid_pods_exclude_daemonset(res))
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
    pin = pods_t[2]
    pinned = rng.choice(n_p, 12, replace=False)
    pin[pinned[:6]] = rng.integers(0, tensors.n_nodes, 6)
    pin[pinned[6:]] = -2
    pods_t[3][pinned[::3]] = True  # a few forced (two of them to no node)
    # a prefix placement log (ignoring feasibility) seeds every count plane
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


def _numpy_tree(nt):
    return type(nt)(*(np.asarray(x) for x in nt))


def _port_flags(jflags):
    return tscan.StepFlags(**{k: v for k, v in jflags._asdict().items() if k in tscan.StepFlags._fields})


FLAG_SETS = {
    "derived": lambda t, b: jscan.flags_from(t, b.ext),
    "general": lambda t, b: jscan.StepFlags(),
    "general-unfused": lambda t, b: jscan.StepFlags(fused=False),
    "pruned-scores": lambda t, b: jscan.flags_from(t, b.ext)._replace(
        taint_pref=False, selector_spread=False, interpod_pref=False, static_score=False
    ),
    "no-ports-vols": lambda t, b: jscan.StepFlags(ports=False, vols=False, attach=False),
}


#: non-default score weights (--default-scheduler-config): placements,
#: reasons and planes still match; the last bit of a score may not (PERF.md)
CUSTOM_WEIGHTS = np.array([1.3, 0.7, 2.1, 0.9, 1.7, 3.3, 0.45, 2.6, 1.15, 0.8, 1.9, 1.05], F32)


def _plain_chain(problem, statics, jflags):
    """The port's K1→K4 plain chain over the whole batch from the problem's
    state: (buffers, the plain calls and the launches it made)."""
    from simtpu_torch.kernels import cuda

    _, _, _, state, pods = problem
    buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                            tstate.state_from_numpy(_numpy_tree(state), "cpu"), pods, _port_flags(jflags))
    before_plain, before_launch = dict(cuda.PLAIN_CALLS), dict(cuda.LAUNCHES)
    tscan.run_batch(buf)
    plain = {k: cuda.PLAIN_CALLS[k] - before_plain.get(k, 0) for k in cuda.KERNELS}
    launched = {k: cuda.LAUNCHES.get(k, 0) - before_launch.get(k, 0) for k in cuda.KERNELS}
    return buf, plain, launched


@pytest.fixture(scope="module")
def derived_chain(problem):
    """The plain chain with the derived flags, run once for the two tests
    that read it (the scan comparison and the wrappers' counts)."""
    tensors, batch, statics, _, _ = problem
    return _plain_chain(problem, statics, FLAG_SETS["derived"](tensors, batch))


@pytest.mark.parametrize("flag_set", sorted(FLAG_SETS) + ["general-custom-weights"])
def test_k1_to_k4_plain_chain_matches_jax_scan(problem, derived_chain, flag_set):
    tensors, batch, statics, state, pods = problem
    derived = flag_set == "derived"
    if flag_set == "general-custom-weights":
        statics = statics._replace(score_w=jnp.asarray(CUSTOM_WEIGHTS))
        flag_set = "general"
    jflags = FLAG_SETS[flag_set](tensors, batch)
    j_state, (j_node, j_reason, *_) = jscan._run_scan(
        statics, jax.tree_util.tree_map(jnp.copy, state), pods, jflags
    )
    buf = derived_chain[0] if derived else _plain_chain(problem, statics, jflags)[0]
    np.testing.assert_array_equal(buf.out_node.numpy(), np.asarray(j_node))
    np.testing.assert_array_equal(buf.reason.numpy(), np.asarray(j_reason))
    assert jstate.diff_state_planes(tstate.state_to_numpy(buf.state), _numpy_tree(j_state)) == []
    reasons = set(np.asarray(j_reason).tolist())
    assert {0, jscan.FAIL_NO_NODE} <= reasons and len(reasons) >= 4, reasons


def _jax_scan_with_eval(statics, state, pods, flags):
    """The JAX package's serial scan, also returning each step's StepEval
    masks and score. XLA shares the step's filter/score computation between
    the argmax and the extra outputs, so these are the values the compiled
    scan ranks (a standalone `jax.jit(filter_and_score)` fuses — and so
    rounds — differently). The statics are an argument of the compiled
    function, as in the engine's `_run_scan`: closed over, they would be
    constants, and XLA folds constant weights into other roundings."""

    def step(stc, st, pod):
        new, (node, reason, *_) = jscan.schedule_step(stc, st, pod, flags)
        ev = jscan.filter_and_score(stc, st, pod, flags)
        masks = jnp.stack([getattr(ev, f) for f in [f for f, _ in tscan.FILTER_CASCADE]])
        return new, (node, reason, masks, ev.score)

    run = jax.jit(lambda stc, s, p: jax.lax.scan(lambda a, b: step(stc, a, b), s, p))
    return run(statics, jax.tree_util.tree_map(jnp.copy, state), pods)


def test_filter_and_score_and_schedule_step_match(problem):
    """The textbook `filter_and_score` (every StepEval mask, the score) and
    `schedule_step` pod by pod against the compiled scan's own values,
    over the first 160 pods with every step flag on."""
    tensors, batch, statics, state, pods = problem
    pods = tuple(x[:160] for x in pods)
    jflags = jscan.StepFlags()
    j_state, (j_node, j_reason, j_masks, j_score) = _jax_scan_with_eval(statics, state, pods, jflags)
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    t_state = tstate.state_from_numpy(_numpy_tree(state), "cpu")
    flags = _port_flags(jflags)
    for i in range(len(pods[0])):
        pod = (pods[0][i], torch.as_tensor(pods[1][i]), *(x[i] for x in pods[2:]))
        ev = tscan.filter_and_score(t_statics, t_state, pod, flags)
        for k, field in enumerate([f for f, _ in tscan.FILTER_CASCADE]):
            np.testing.assert_array_equal(getattr(ev, field).numpy(), np.asarray(j_masks[i, k]),
                                          err_msg=f"pod {i} {field}")
        np.testing.assert_array_equal(ev.score.numpy(), np.asarray(j_score[i]), err_msg=f"pod {i}")
        assert tscan.schedule_step(t_statics, t_state, pod, flags) == (int(j_node[i]), int(j_reason[i]))
    assert jstate.diff_state_planes(tstate.state_to_numpy(t_state), _numpy_tree(j_state)) == []


def test_build_state_planes_match(problem):
    tensors, batch, _, _, pods = problem
    rng = np.random.default_rng(11)
    k = 400
    g = rng.integers(0, len(tensors.groups), k).astype(np.int32)
    node = rng.integers(0, tensors.n_nodes, k).astype(np.int32)
    req = pods[1][rng.integers(0, len(pods[0]), k)]
    want = _numpy_tree(jstate.build_state(tensors, g, node, req, None))
    got = tstate.state_to_numpy(tstate.build_state(tensors, g, node, req, None, "cpu"))
    assert jstate.diff_state_planes(got, want) == []


def test_statics_carried_across_expand_collapsed_planes(problem):
    tensors, _, statics, _, _ = problem
    collapsed = [f for f in tscan._GROUP_NODE_PLANES if np.asarray(getattr(statics, f)).shape[0] == 1]
    assert collapsed, "the JAX statics should collapse some constant plane"
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    g = len(tensors.groups)
    for f in tscan._GROUP_NODE_PLANES:
        plane = getattr(t_statics, f).numpy()
        assert plane.shape == (g, tensors.n_nodes)
        np.testing.assert_array_equal(plane, np.broadcast_to(np.asarray(getattr(statics, f)), plane.shape))
    fresh = jscan.statics_from(copy.copy(tensors))  # no node_valid override
    want = tscan.statics_from_numpy(_numpy_tree(fresh), "cpu")
    mine = tscan.statics_from(copy.copy(tensors), None, torch.device("cpu"))
    for f in tscan.StaticArrays._fields:
        np.testing.assert_array_equal(getattr(mine, f).numpy(), getattr(want, f).numpy(), err_msg=f)


def test_ctypes_step_ctx_mirrors_the_cuda_header():
    """The kernels' argument blocks are passed by value: each ctypes
    structure (StepCtx of K1-K6, DeltaCtx of K7, AuditCtx of K8,
    CompactCtx of K11-K13) must list the header's fields in the header's
    order."""
    import ctypes
    import re

    from simtpu_torch.kernels import cuda

    for source, struct, int_fields, ptr_fields, mirror in (
        ("step_ctx.cuh", "StepCtx", cuda._INT_FIELDS, cuda._PTR_FIELDS, cuda.StepCtx),
        ("step_ctx.cuh", "DeltaCtx", cuda._DELTA_INT_FIELDS, cuda._DELTA_PTR_FIELDS, cuda.DeltaCtx),
        ("audit_bulk.cu", "AuditCtx", cuda._AUDIT_INT_FIELDS,
         cuda._AUDIT_PTR_FIELDS + (("flags",),), cuda.AuditCtx),
        ("step_ctx.cuh", "CompactCtx", cuda._COMPACT_INT_FIELDS, cuda._COMPACT_PTR_FIELDS,
         cuda.CompactCtx),
    ):
        header = (cuda.CSRC / source).read_text()
        body = header[header.index(f"struct {struct} {{"):]
        body = body[: body.index("};")]
        ints = re.search(r"int ([\w, ]+);", body).group(1).replace(" ", "").split(",")
        longs = re.findall(r"long long (\w+);", body)  # DeltaCtx's `work`, after its ints
        ptrs = re.findall(r"\*\s*(\w+);", body)
        assert ints == list(int_fields), struct
        assert ptrs == [f for f, *_ in ptr_fields], struct
        assert [f for f, _ in mirror._fields_] == ints + longs + ptrs, struct
        assert all(t is ctypes.c_longlong for f, t in mirror._fields_ if f in longs), struct


def test_wrappers_take_the_plain_version_only_for_cpu_tensors(derived_chain):
    """On CPU tensors each wrapper runs its plain version (counted as such)
    and launches nothing: the counts of the derived-flags chain."""
    from simtpu_torch.kernels import cuda

    buf, plain, launched = derived_chain
    calls = {"storage_pod": int(buf.storage_live.sum()), "gpu_pod": int(buf.gpu_live.sum()),
             "delta_apply": 0, "audit_bulk": 0, "wave_lean": 0, "wave_hard": 0,
             "compact_compress": 0, "compact_expand": 0, "compact_delta": 0,
             "round_score": 0, "round_pick": 0, "round_commit": 0, "carry_copy": 0,
             "sweep_drain": 0, "sweep_place": 0, "explain_pass": 0, "pod_terms": 0,
             "relax_load": 0, "relax_project": 0, "grow_terms": 0, "grow_nodes": 0}
    for name in cuda.KERNELS:
        assert plain[name] == calls.get(name, buf.n_pods)
        assert launched[name] == 0


def test_kernel_argument_block_checks_its_tensors(problem):
    """make_ctx takes every tensor's address only after checking its device,
    dtype, contiguity and shape."""
    from simtpu_torch.kernels import cuda

    tensors, batch, statics, state, pods = problem
    t_statics = tscan.statics_from_numpy(_numpy_tree(statics), "cpu")
    buf = tscan.StepBuffers(t_statics, tstate.state_from_numpy(_numpy_tree(state), "cpu"),
                            pods, tscan.StepFlags())
    ctx = cuda.make_ctx(buf)
    assert (ctx.n, ctx.r, ctx.tc) == (tensors.n_nodes, tensors.alloc.shape[1], t_statics.g_terms.shape[1])
    assert ctx.flags == (1 << len(tscan.StepFlags._fields)) - 1
    assert ctx.free == buf.state.free.data_ptr()
    bad = tscan.StepBuffers(t_statics._replace(node_pref=t_statics.node_pref.double()),
                            buf.state, pods, tscan.StepFlags())
    with pytest.raises(ValueError, match="node_pref"):
        cuda.make_ctx(bad)
    short = tscan.StepBuffers(t_statics._replace(static_mask=t_statics.static_mask[:1].contiguous()),
                              buf.state, pods, tscan.StepFlags())
    with pytest.raises(ValueError, match="static_mask"):
        cuda.make_ctx(short)


@pytest.mark.slow
@pytest.mark.parametrize(
    "n_nodes,weights",
    [(64, None), (257, None), (1000, None), (257, "custom")],
    ids=["64", "257", "1000", "257-custom-weights"],
)
def test_scores_bit_identical_at_the_smoke_mix(n_nodes, weights):
    """The smoke problem's constraint mix at several node counts: the port's
    K1→K4 plain chain yields the compiled scan's own scores for 200 pods
    (XLA's fusion, and so its FMA contraction, can change with shape), with
    the default score weights and with the custom weights of
    `test_k1_to_k4_plain_chain_matches_jax_scan[general-custom-weights]`
    given through a scheduler configuration."""
    from simtpu_torch import smoke
    from simtpu.schedconfig import SchedulerConfig

    cluster, apps = smoke.smoke_problem(synth_cluster, synth_apps, n_nodes, smoke.N_PODS)
    seed_name_hashes(1)
    try:
        pods = [p for a in apps for p in get_valid_pods_exclude_daemonset(a.resource)]
    finally:
        seed_name_hashes(None)
    tz = Tensorizer(cluster.nodes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, arrays = jscan.build_pod_arrays(batch, tensors.alloc.shape[1])
    rng = np.random.default_rng(0)
    sel = np.sort(rng.choice(len(arrays[0]), 200, replace=False))
    arrays = tuple(np.asarray(x)[sel] for x in arrays)
    k = 3000
    state = jstate.build_state(
        tensors, rng.integers(0, len(tensors.groups), k).astype(np.int32),
        rng.integers(0, tensors.n_nodes, k).astype(np.int32), arrays[1][rng.integers(0, 200, k)], None,
    )
    config = SchedulerConfig(score_weights=CUSTOM_WEIGHTS.copy()) if weights else None
    statics = jscan.statics_from(tensors, config)
    for jflags in (jscan.flags_from(tensors, batch.ext), jscan.StepFlags()):
        _, (j_node, _, _, j_score) = _jax_scan_with_eval(statics, state, arrays, jflags)
        buf = tscan.StepBuffers(tscan.statics_from_numpy(_numpy_tree(statics), "cpu"),
                                tstate.state_from_numpy(_numpy_tree(state), "cpu"), arrays,
                                _port_flags(jflags))
        for i in range(buf.n_pods):
            tscan.filter_pod(buf, i)
            tscan.topology_pod(buf, i)
            tscan.score_argmax_pod(buf, i)
            np.testing.assert_array_equal(buf.score.numpy(), np.asarray(j_score[i]), err_msg=f"pod {i}")
            tscan.commit_pod(buf, i)
        np.testing.assert_array_equal(buf.out_node.numpy(), np.asarray(j_node))
