"""Any number of term columns, and the launch plans of K20 and K22.

1. The launch plans at Tc = 512, 1024 and 4096 term columns a group
   (`simtpu_torch/kernels/cuda.py`): K16's `round_plan`, K10's
   `wave_hard_plan`, K19's `sweep_place_plan` and K18's `sweep_drain_plan`
   stay within a block's 227 KB of shared memory, take global scratch for
   what does not fit (mode "global"), and still put every node on one
   thread once; at Tc = 4 they keep everything on chip.
2. K20's `explain_plan` (one thread-block cluster a pod) at N = 1, 31,
   120, 1000, 3001, 5000 and 9000: the cluster's blocks, tiles and threads,
   and that both of its walks visit every node once; K22's
   `relax_load_plan` at R = 1, 3, 8, 9 and 12; the argument blocks'
   ctypes mirrors against the CUDA sources.
3. The terms problem (`simtpu_torch/smoke.py terms_problem`, Tc = 512 on
   24 nodes) through both packages' `simulate`: placements, reasons and
   every final state plane equal.
4. The breakdown (K20's plain version) against the JAX package's
   `_explain_call` on a pod whose witnesses lie past the first 1024
   nodes.

Nothing here needs a card; the JAX side runs on the CPU.
"""

import ctypes
import importlib

import numpy as np
import pytest

import simtpu
import simtpu_torch
from simtpu_torch import smoke
from simtpu_torch.kernels import cuda

from .test_torch_explain import _assert_breakdowns_equal, _breakdowns, _place
from .test_torch_launch_plans import _cluster_nodes, _cuda_int, _struct_fields
from .test_torch_simulate import assert_same_simulation
from ._threads import one_torch_thread  # noqa: F401 (autouse)

BLOCK_SMEM = 227 * 1024
WIDE_TC = (512, 1024, 4096)
PLAN_NODES = (1000, 5000)


@pytest.fixture(autouse=True)
def _numpy_twin(monkeypatch):
    monkeypatch.setenv("SIMTPU_AUDIT_JIT", "0")


def _rows_words(tc: int) -> int:
    """K16's words before the tile's prefix (round_commit.cu)."""
    return 2 * (tc * (cuda.ROUND_DOM_SMALL + 1) + 1) + cuda.ROUND_CLUSTER_MAX + cuda.ROUND_TERM_WORDS * tc


@pytest.mark.parametrize("n", PLAN_NODES)
@pytest.mark.parametrize("tc", WIDE_TC)
def test_round_plan_takes_any_term_columns(tc, n):
    plan = cuda.round_plan(n, tc)
    assert plan["mode"] == "global" and plan["shared_bytes"] == 4 * plan["tile"] <= BLOCK_SMEM
    assert plan["row_words"] == (_rows_words(tc) + 3) & ~3 and plan["row_words"] % 4 == 0
    assert (_cluster_nodes(plan, n) == 1).all()
    # below the budget the shared layout and its formula stand
    small = cuda.round_plan(n, 4)
    assert small["mode"] == "shared" and small["row_words"] == 0
    assert small["shared_bytes"] == 4 * (_rows_words(4) + small["tile"])


@pytest.mark.parametrize("n", PLAN_NODES)
@pytest.mark.parametrize("tc", WIDE_TC)
def test_wave_hard_plan_takes_any_term_columns(tc, n):
    r, kmax, pods = 3, 3, 200
    plan = cuda.wave_hard_plan(n, r, tc, kmax, pods)
    assert 0 < plan["shared_bytes"] <= cuda.WAVE_SMEM <= BLOCK_SMEM
    assert plan["threads"] * plan["nodes_per_thread"] >= n
    # the minima (64 words a column) fit at Tc = 512 and not from 1024;
    # what is in the slab lies in it, 16-byte aligned, and what is shared
    # inside the shared bytes
    scratch = {"off_cols": 8 * tc * 4, "off_keys": kmax * 4, "off_flags": pods * 4, "off_mins": 64 * tc * 4}
    assert plan["mode"] == ("shared" if tc == 512 else "global") and (plan["off_mins"] < 0) == (tc > 512)
    for key, size in scratch.items():
        off = plan[key]
        if off >= 0:
            assert off % 16 == 0 and off + size <= plan["shared_bytes"], key
        else:
            assert (-1 - off) % 16 == 0 and -1 - off + size <= plan["slab_bytes"], key
    # the copies of state rows past the budget are read in place
    assert plan["off_own"] == -1 and plan["off_cm"] == -1
    small = cuda.wave_hard_plan(n, r, 4, kmax, pods)
    assert small["mode"] == "shared" and small["slab_bytes"] == 0
    assert min(small[k] for k in scratch) >= 0


@pytest.mark.parametrize("n", PLAN_NODES)
@pytest.mark.parametrize("tc", WIDE_TC)
def test_sweep_plans_take_any_term_columns(tc, n):
    r = 3
    plan = cuda.sweep_place_plan(n, r, tc)
    assert plan["threads"] * plan["nodes_per_thread"] >= n
    assert plan["shared_bytes"] <= cuda.WAVE_SMEM
    pods, mins = 2 * plan["pod_words"] * 4, 2 * 32 * tc * 4
    fits = pods + mins <= cuda.WAVE_SMEM
    assert plan["mode"] == ("shared" if fits else "global") and (plan["slab_bytes"] > 0) == (not fits)
    for off, size in ((plan["off_pod"], pods), (plan["off_min"], mins)):
        if off < 0:
            assert -1 - off + size <= plan["slab_bytes"]
    assert plan["mode"] == ("shared" if tc == 512 else "global")
    drain = cuda.sweep_drain_plan(32, n, tc, width=20)
    per_entry = 5 + cuda.DRAIN_PAIR_WORDS * tc + 20
    assert drain["shared_bytes"] <= 200 * 1024 and drain["stage_entries"] >= 1
    if drain["staging"] == "shared":
        assert drain["shared_bytes"] == 4 * drain["stage_entries"] * per_entry
    else:
        assert drain["stage_entries"] == 1 and drain["slab_stride"] >= 4 * per_entry
        assert drain["slab_bytes"] == drain["blocks"] * drain["slab_stride"]
    # one entry of Tc = 4096 columns still fits the opt-in shared bytes
    assert drain["staging"] == "shared"
    assert cuda.sweep_drain_plan(32, n, 8192, width=20)["staging"] == "global"


# blocks a pod of K20's plan by N: for a chunk of 64 pods (each pod's
# share of one wave of the card, 2112 threads), and for one pod
EXPLAIN_WANT = {1: (1, 1), 31: (1, 1), 120: (1, 1), 1000: (2, 2), 3001: (2, 8), 5000: (2, 16), 9000: (2, 16)}


@pytest.mark.parametrize("pods", [64, 1])
@pytest.mark.parametrize("n", sorted(EXPLAIN_WANT))
def test_explain_plan_tiles_every_node_once(n, pods):
    plan = cuda.explain_plan(n, tc=6, pods=pods)
    b, tile, threads = plan["blocks"], plan["tile"], plan["threads"]
    assert b == EXPLAIN_WANT[n][pods == 1] and b & (b - 1) == 0 and b <= cuda.EXPLAIN_CLUSTER_MAX
    # within the pod's share of one wave of the card and the smallest
    # tile, unless one block
    assert b == 1 or (b * threads <= cuda.H100_SMS * cuda.EXPLAIN_SM_THREADS // pods
                      and tile >= cuda.EXPLAIN_MIN_TILE)
    assert tile % 32 == 0 and b * tile >= n > (b - 1) * tile
    assert threads % 32 == 0 and threads <= min(tile, cuda.EXPLAIN_THREADS)
    assert plan["shared_bytes"] == 2 * 6 * 4
    strided, runs = np.zeros(n, np.int64), np.zeros(n, np.int64)
    per = plan["nodes_per_thread"]
    for blk in range(b):
        lo, hi = blk * tile, min(n, (blk + 1) * tile)
        assert lo < hi, "an empty tile"
        for t in range(threads):
            strided[lo + t:hi:threads] += 1
            runs[lo + min(hi - lo, t * per):lo + min(hi - lo, (t + 1) * per)] += 1
    assert (strided == 1).all() and (runs == 1).all()
    # the sweep's cluster sizes
    for blocks in (1, 2, 4, 8, 16):
        p = cuda.explain_plan(n, blocks=blocks)
        assert p["blocks"] <= blocks and p["blocks"] * p["tile"] >= n > (p["blocks"] - 1) * p["tile"]


@pytest.mark.parametrize("r", [1, 3, 8, 9, 12])
def test_relax_load_plan(r):
    plan = cuda.relax_load_plan(100, 999, r)
    assert plan["template"] == ("r4" if r <= 4 else "r8")
    assert plan["r_chunks"] == -(-r // (4 if r <= 4 else 8)) and plan["rereads_y"] == (r > 8)
    assert plan["threads"] % 32 == 0 and plan["threads"] <= cuda.RELAX_LOAD_THREADS
    assert plan["nodes_per_thread"] in (1, 2, 4) and plan["unroll"] in (4, 8, 16)
    tiles, s = plan["grid"]
    assert s == 100 and tiles * plan["threads"] * plan["nodes_per_thread"] >= 999
    assert (tiles - 1) * plan["threads"] * plan["nodes_per_thread"] < 999
    assert cuda.relax_load_plan(3, 0, r)["grid"] == (1, 3)


def test_new_plans_mirror_the_cuda_sources():
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
    for source, struct in (("wave_hard.cu", "HardPlan"), ("explain_pass.cu", "ExplainPlan")):
        mirror = [(f, ctypes_kind[t]) for f, t in getattr(cuda, struct)._fields_]
        assert mirror == _struct_fields((cuda.CSRC / source).read_text(), struct), struct
    explain = (cuda.CSRC / "explain_pass.cu").read_text()
    assert _cuda_int(explain, "EXPLAIN_CLUSTER_MAX") == cuda.EXPLAIN_CLUSTER_MAX
    assert _cuda_int(explain, "EXPLAIN_THREADS") == cuda.EXPLAIN_THREADS
    assert _cuda_int((cuda.CSRC / "relax.cuh").read_text(), "RELAX_LOAD_THREADS") == cuda.RELAX_LOAD_THREADS
    assert _cuda_int((cuda.CSRC / "sweep_drain.cu").read_text(), "DRAIN_SMEM_MAX") == cuda.DRAIN_SMEM_MAX
    # the K22 templates the C entry dispatches on
    load = (cuda.CSRC / "relax_load.cu").read_text()
    for npt in (1, 2, 4):
        assert f"case {npt}: return launch_load_u<RMAX, {npt}>" in load
    for unroll in (4, 8, 16):
        assert f"case {unroll}: return launch_load<RMAX, NPT, {unroll}>" in load
    assert _cuda_int((cuda.CSRC / "relax.cuh").read_text(), "RELAX_LOAD_REQ_ROWS") == cuda.RELAX_LOAD_REQ_ROWS


def _terms(pkg, terms=300):
    synth = importlib.import_module(f"{pkg.__name__}.synth")
    return smoke.terms_problem(synth, pkg.AppResource, pkg.ResourceTypes, 24, terms, (8, 40, 8))


def test_terms_problem_reaches_wide_term_columns():
    from simtpu_torch.core.tensorize import Tensorizer
    from simtpu_torch.engine import scan
    from simtpu_torch.workloads.expand import get_valid_pods_exclude_daemonset

    for terms, tc in ((300, 512), (600, 1024)):
        cluster, apps = _terms(simtpu_torch, terms)
        tz = Tensorizer(cluster.nodes, storage_classes=cluster.storage_classes)
        tz.add_pods(get_valid_pods_exclude_daemonset(apps[0].resource))
        assert scan.statics_from(tz.freeze(), None, "cpu").g_terms.shape[1] == tc


def test_terms_problem_simulate_equals_jax(monkeypatch):
    want, _ = assert_same_simulation(_terms, monkeypatch)
    assert len(want["placed"]) == 56


def _tile_problem(pkg):
    """1100 nodes, the first 1050 in pool a: a pod that selects pool b and
    asks for more CPU than any node has, and one that selects pool a the
    same way, so that the static stage's lowest witnesses lie past node
    1024 for the first and the resource stage's for the second."""
    synth = importlib.import_module(f"{pkg.__name__}.synth")
    cluster = synth.synth_cluster(1100, seed=4, zones=4, taint_frac=0.0)
    for i, node in enumerate(cluster.nodes):
        node["metadata"]["labels"]["pool"] = "a" if i < 1050 else "b"
    deps = [synth.make_deployment("in-b", 1, 10_000_000, 64, node_selector={"pool": "a"}),
            synth.make_deployment("fits-b", 1, 10_000_000, 64, node_selector={"pool": "b"})]
    return cluster, [pkg.AppResource(name="tiles", resource=pkg.ResourceTypes(deployments=deps))]


def test_breakdown_witnesses_past_one_node_tile_equal_jax():
    jb, tb = _breakdowns(_place(simtpu, *_tile_problem(simtpu)), _place(simtpu_torch, *_tile_problem(simtpu_torch)))
    _assert_breakdowns_equal(jb, tb)
    assert len(tb) == 2
    assert (tb.witnesses[:, 0] >= 1024).any() and (tb.witnesses >= 1050).any()
