"""The launch plans of K23 `relax_project`, K19 `sweep_place`, K18
`sweep_drain`, K15 `round_pick`, K14 / K16 `round_score` /
`round_commit` and K2 `topology_pod`.

The wrappers take their launch arithmetic from plain Python functions in
`simtpu_torch/kernels/cuda.py` (`relax_project_plan`, `sweep_place_plan`,
`sweep_drain_plan`, `round_pick_plan`, `round_plan`, `topology_plan`), which K2's, K14's, K16's,
K18's and K19's CUDA entries follow and K15's and K23's compute alike. Here, at node counts on both
sides of every boundary (N = 999, 1024, 1025, 4096, 4097, 16 384, 16 385
and 100 000): K23's path, threads per row, keys per thread, rows per
block, shared bytes and slab switch; K19's threads, nodes per thread,
register template and shared-memory plan; K18's node tiles (every node in
exactly one tile of every scenario, one cnt_total owner a scenario, at
least two blocks an SM on the main paths' chunks); K15's threads, register
template or global rows, and the quota ranking's shared or global buffers;
K14/K16's cluster (every node in exactly one tile and on one thread, at
N = 1, 31, 1000, 2000, 5000, 9000, 16 385 and 100 000 and at every
cluster size); K2's (`topology_plan`: one plain block up to 1024 nodes, a
cluster above, every node on one thread at every cluster size; its
scratch in shared memory within a block's 227 KB or past the budget in a
slab, at Tc up to 4096).
Then the plans as the argument blocks carry them, the constants they
mirror in the CUDA sources, and the argument blocks' fields against the
CUDA headers. Nothing here needs a card.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simtpu_torch.kernels import cuda
from simtpu_torch.solve import relax as trelax

NODES = (999, 1024, 1025, 4096, 4097, 16384, 16385, 100000)

# (path, threads, keys per thread) of K23 by N
RELAX_WANT = {
    999: ("registers", 256, 4),
    1024: ("registers", 256, 4),
    1025: ("registers", 256, 8),
    4096: ("registers", 512, 8),
    4097: ("shared", 1024, 8),
    16384: ("shared", 1024, 16),
    16385: ("slab", 1024, 32),
    100000: ("slab", 1024, 128),
}

# (threads, nodes per thread, template) of K19 by N
SWEEP_WANT = {
    999: (1024, 1, "1"),
    1024: (1024, 1, "1"),
    1025: (1024, 2, "2"),
    4096: (1024, 4, "4"),
    4097: (1024, 5, "global"),
    16384: (1024, 16, "global"),
    16385: (1024, 17, "global"),
    100000: (1024, 98, "global"),
}


@pytest.mark.parametrize("n", NODES)
def test_relax_project_plan(n):
    rows, sms = 6100, 132
    plan = cuda.relax_project_plan(n, rows, sms)
    np2 = 1 << (n - 1).bit_length()
    path, threads, kpt = RELAX_WANT[n]
    assert (plan["np2"], plan["path"], plan["threads"], plan["keys_per_thread"]) == (np2, path, threads, kpt)
    assert plan["rows_per_block"] == 1
    assert plan["width"] >= np2 and plan["width"] == plan["threads"] * plan["keys_per_thread"]
    if path == "registers":
        # a fraction of an SM: at most 512 threads and the two exchange buffers
        assert plan["threads"] <= cuda.RELAX_ROW_THREADS and plan["threads"] % 32 == 0
        assert plan["shared_bytes"] == 2 * plan["width"] * 4 <= 48 * 1024
        assert plan["slabs"] == plan["scratch_bytes"] == 0
    elif path == "shared":
        assert plan["shared_bytes"] == np2 * 12 <= 227 * 1024 and plan["slabs"] == 0
    else:
        assert plan["shared_bytes"] == 0
        assert plan["slabs"] == min(rows, cuda.RELAX_SLABS_PER_SM * sms)
        assert plan["scratch_bytes"] == plan["slabs"] * np2 * 12


def test_relax_project_plan_small_rows():
    # under 128 padded nodes the register path keeps one full warp
    for n, width in ((1, 128), (32, 128), (33, 128), (129, 256), (513, 1024)):
        plan = cuda.relax_project_plan(n, 4)
        assert (plan["path"], plan["keys_per_thread"], plan["width"]) == ("registers", 4, width), n
        assert plan["threads"] == max(32, width // 4)


@pytest.mark.parametrize("n", NODES)
def test_sweep_place_plan(n):
    r, tc = 4, 6
    plan = cuda.sweep_place_plan(n, r, tc)
    threads, npt, template = SWEEP_WANT[n]
    assert (plan["threads"], plan["nodes_per_thread"], plan["template"]) == (threads, npt, template)
    assert plan["threads"] * plan["nodes_per_thread"] >= n
    assert plan["carry_rows"] == (cuda.SWEEP_ROWS if template == "global" else 0)
    # the staged pods, then the minima, then the free rows where they fit
    assert plan["pod_words"] == cuda.SWEEP_POD_HEAD + r + 8 * tc
    assert plan["off_pod"] == 0
    assert plan["off_min"] % 16 == 0 and plan["off_min"] >= 2 * plan["pod_words"] * 4
    end_min = plan["off_min"] + 2 * 32 * tc * 4
    if plan["off_free"] >= 0:
        assert plan["off_free"] % 16 == 0 and plan["off_free"] >= end_min
        assert plan["shared_bytes"] == plan["off_free"] + r * n * 4 <= cuda.WAVE_SMEM
    else:
        assert plan["shared_bytes"] == end_min
        assert ((end_min + 15) & ~15) + r * n * 4 > cuda.WAVE_SMEM
    # the free rows stay on chip up to the bulk problem's 5000 nodes
    assert (plan["off_free"] >= 0) == (n <= 12000)


def test_sweep_place_plan_without_terms():
    plan = cuda.sweep_place_plan(500, 3, 0)
    assert plan["threads"] == 512 and plan["template"] == "1"
    assert plan["pod_words"] == cuda.SWEEP_POD_HEAD + 3
    assert plan["off_min"] == (plan["pod_words"] * 8 + 15) & ~15
    assert plan["shared_bytes"] == plan["off_free"] + 3 * 500 * 4


# (threads, nodes per thread, template) of K15 by N
PICK_WANT = {
    999: (1024, 1, "1"),
    1024: (1024, 1, "1"),
    1025: (1024, 2, "2"),
    4096: (1024, 4, "4"),
    4097: (1024, 5, "8"),
    16384: (1024, 16, "global"),
    16385: (1024, 17, "global"),
    100000: (1024, 98, "global"),
}


def _drain_tiles(plan, n):
    """The node ranges of one scenario's blocks under a K18 plan, as the
    kernel computes them from the tile (csrc/sweep_drain.cu)."""
    tiles = max(1, -(-n // plan["tile"])) if n else 1
    assert tiles == plan["tiles"]
    return [(j * plan["tile"], min(n, (j + 1) * plan["tile"])) for j in range(tiles)]


@pytest.mark.parametrize("n", NODES + (1, 31, 33, 1000, 5000, 5001))
@pytest.mark.parametrize("s", [1, 16, 32, 100, 128, 1000])
def test_sweep_drain_plan_covers_every_node_once(s, n):
    plan = cuda.sweep_drain_plan(s, n, tc=6, width=20)
    seen = np.zeros(n, np.int64)
    for lo, hi in _drain_tiles(plan, n):
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan["grid"] == (s, plan["tiles"]) and plan["blocks"] == s * plan["tiles"]
    # one cnt_total owner a scenario: the tile-0 block
    assert plan["total_owner_tile"] == 0
    assert plan["tile"] % 32 == 0 and plan["tile"] >= cuda.DRAIN_MIN_TILE
    assert plan["threads"] == cuda.DRAIN_THREADS
    # the entry staging fits its shared bytes, within 48 KB
    assert 1 <= plan["stage_entries"] <= cuda.DRAIN_STAGE_ENTRIES
    assert plan["shared_bytes"] == 4 * plan["stage_entries"] * (5 + 10 * 6 + 20) <= 4 * cuda.DRAIN_STAGE_WORDS
    # the tiles as large as still put DRAIN_BLOCKS_PER_SM blocks on every
    # SM: one tile less would leave some SM fewer
    want = cuda.DRAIN_BLOCKS_PER_SM * cuda.H100_SMS
    if plan["tile"] > cuda.DRAIN_MIN_TILE and n:
        assert plan["blocks"] >= want or plan["tiles"] == -(-n // plan["tile"])


def test_sweep_drain_plan_stages_no_sort_key():
    # an (entry, term) pair stages its rank, term, key, domain, interpod row
    # and five increments: 40 bytes, no packed 64-bit sort key
    for tc, width in ((4, 20), (64, 20), (64, 136)):
        plan = cuda.sweep_drain_plan(16, 1000, tc, width)
        assert plan["shared_bytes"] == 4 * plan["stage_entries"] * (5 + cuda.DRAIN_PAIR_WORDS * tc + width)
    assert 4 * cuda.DRAIN_PAIR_WORDS == 40


@pytest.mark.parametrize("keys", [1, 4095, 4096, 4100, 70000])
def test_sweep_drain_checks_refuse_no_count_of_keys(keys):
    # K18's input checks (run by its wrapper before the launch) take any
    # number of topology keys; they still refuse a malformed index
    from types import SimpleNamespace

    from simtpu_torch.engine import state as tstate

    s, n, t, ti = 3, 40, 7, 2
    shapes = {"free": (n, 4), "cnt_match": (t, n), "cnt_total": (t,), "cnt_own_anti": (ti, n),
              "cnt_own_aff": (ti, n), "w_own_aff_pref": (ti, n), "w_own_anti_pref": (ti, n),
              "ports_used": (n, 1), "vols_any": (n, 1), "vols_rw": (n, 1), "vg_free": (n, 0),
              "sdev_free": (n, 0), "gpu_free": (n, 0)}
    base = tstate.SchedState(**{f: torch.zeros(shapes[f]) for f in tstate.SchedState._fields})
    reps = tstate.SchedState(**{f: torch.zeros((s,) + shapes[f]) for f in tstate.SchedState._fields})
    statics = SimpleNamespace(node_dom=torch.zeros((keys, n), dtype=torch.int32))
    idx = torch.full((s, 5), -1, dtype=torch.int32)
    assert cuda.check_sweep_drain(statics, base, reps, idx) == (s, t, ti)
    with pytest.raises(ValueError, match="idx"):
        cuda.check_sweep_drain(statics, base, reps, idx.long())


SCORE_NODES = (1, 31, 943, 1024, 1025, 5000, 9000)
# (threads, nodes per thread, template) of K3 by N
SCORE_WANT = {1: (32, 1, "registers"), 31: (32, 1, "registers"), 943: (960, 1, "registers"),
              1024: (1024, 1, "registers"), 1025: (1024, 2, "global"), 5000: (1024, 5, "global"),
              9000: (1024, 9, "global")}


@pytest.mark.parametrize("n", SCORE_NODES)
def test_score_plan(n):
    plan = cuda.score_plan(n)
    assert (plan["threads"], plan["nodes_per_thread"], plan["template"]) == SCORE_WANT[n]
    assert plan["npt"] == (cuda.SCORE_REG_NPT if n <= cuda.SCORE_BLOCK else 0)
    # node m is thread m % threads's (m // threads)-th node: each node on
    # one thread, within the nodes a thread walks
    m = np.arange(n)
    assert (m // plan["threads"] < plan["nodes_per_thread"]).all()
    assert plan["threads"] % 32 == 0 and plan["threads"] <= cuda.SCORE_BLOCK
    assert plan["threads"] * plan["nodes_per_thread"] >= n


@pytest.mark.parametrize("n", SCORE_NODES)
@pytest.mark.parametrize("m", [0, 1, 2047, 2049, 12340, 150000])
def test_audit_plan(n, m):
    s, w = 11, 3
    plan = cuda.audit_plan(n, m, s, w)
    # the node ids 0..N (N: a node outside [0, N)) fit the passes' digits
    assert plan["passes"] * plan["digit_bits"] >= max(1, n.bit_length())
    assert 1 <= plan["digit_bits"] <= cuda.AUDIT_MAX_DIGIT_BITS
    assert plan["passes"] == (1 if n < 1 << cuda.AUDIT_MAX_DIGIT_BITS else 2)
    assert plan["buckets"] == 1 << plan["digit_bits"]
    assert plan["kernels"] == 2 * plan["passes"] + 2
    assert plan["sort_tiles"] * cuda.AUDIT_SORT_TILE >= m > (plan["sort_tiles"] - 1) * cuda.AUDIT_SORT_TILE or m == 0
    assert plan["scan_tiles"] * cuda.AUDIT_SCAN_TILE >= m > (plan["scan_tiles"] - 1) * cuda.AUDIT_SCAN_TILE or m == 0
    assert plan["words"] == 1 and plan["s"] == s
    # the scratch arrays in AuditPlan's order, 16-byte aligned, apart
    sizes = {"keys": 8 * m, "vals": 8 * m, "hist": 4 * plan["sort_tiles"] * plan["buckets"],
             "tail": 8 * plan["scan_tiles"] * s, "carry": 8 * plan["scan_tiles"] * s,
             "starts": 4 * plan["scan_tiles"], "onw": 4 * m, "done": 4 * (plan["passes"] + 1)}
    offs = plan["offsets"]
    assert list(offs) == [f for f, _ in cuda.AuditPlan._fields_ if f in sizes]
    ends = [offs[f] + sizes[f] for f in offs]
    assert all(o % 16 == 0 for o in offs.values())
    assert all(e <= nxt for e, nxt in zip(ends, list(offs.values())[1:])) and ends[-1] <= plan["scratch_bytes"]


def test_audit_plan_is_linear_in_the_log():
    # no part scans the log once per node: the scratch and the blocks grow
    # with M, not with N x M
    small, large = cuda.audit_plan(5000, 15000, 9), cuda.audit_plan(5000, 150000, 9)
    assert large["scratch_bytes"] < 11 * small["scratch_bytes"]
    assert large["sort_tiles"] <= 10 * small["sort_tiles"] + 1
    wide = cuda.audit_plan(50000, 15000, 9)
    assert wide["scratch_bytes"] < 2 * small["scratch_bytes"]


@pytest.mark.parametrize("s, n", [(128, 1000), (32, 5000)])
def test_sweep_drain_plan_fills_the_card_on_the_main_chunks(s, n):
    # the k=1 chunk of the serial smoke problem and the bulk k=2:256 chunk
    plan = cuda.sweep_drain_plan(s, n, tc=4)
    assert plan["blocks"] >= 264
    assert plan["tiles"] * plan["tile"] >= n > (plan["tiles"] - 1) * plan["tile"]


@pytest.mark.parametrize("n", NODES)
def test_round_pick_plan(n):
    threads, per, template = PICK_WANT[n]
    plan = cuda.round_pick_plan(n)
    assert (plan["threads"], plan["nodes_per_thread"], plan["template"]) == (threads, per, template)
    assert plan["path"] == ("global" if template == "global" else "registers")
    assert plan["threads"] * plan["nodes_per_thread"] >= n and plan["kernel"] == "threshold"
    q = cuda.round_pick_plan(n, tc=6, quota=True)
    assert q["kernel"] == "quota" and q["sort"] == ("shared" if n <= cuda.PICK_SORT_SMEM_N else "global")
    ints = 8 + cuda.PICK_BUCKETS * (threads // 32 + 1) + (4 * n if q["sort"] == "shared" else 0)
    assert q["shared_bytes"] == 4 * ints <= 227 * 1024


def test_round_pick_plan_small_rounds():
    for n, threads in ((1, 32), (32, 32), (33, 64), (500, 512)):
        plan = cuda.round_pick_plan(n)
        assert (plan["threads"], plan["nodes_per_thread"], plan["template"]) == (threads, 1, "1"), n


ROUND_NODES = (1, 31, 1000, 2000, 5000, 9000, 16385, 100000)


def _cluster_nodes(plan, n):
    """How many times each node is visited under a K14/K16 plan, as the
    kernels walk it (csrc/rounds.cuh for_tile): block b's tile [b * tile,
    min(N, (b + 1) * tile)), thread t's nodes tile start + t + j * threads
    for j < npt, or every threads-th node with npt 0."""
    seen = np.zeros(n, np.int64)
    for b in range(plan["blocks"]):
        lo, hi = b * plan["tile"], min(n, (b + 1) * plan["tile"])
        assert lo < hi or n == 0, "an empty tile"
        for t in range(plan["threads"]):
            if plan["npt"]:
                nodes = [lo + t + j * plan["threads"] for j in range(plan["npt"])]
            else:
                nodes = range(lo + t, hi, plan["threads"])
            for node in nodes:
                if node < hi:
                    seen[node] += 1
    return seen


@pytest.mark.parametrize("blocks", [None, 1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("n", ROUND_NODES)
def test_round_plan_covers_every_node_once(n, blocks):
    plan = cuda.round_plan(n, tc=4, blocks=blocks)
    assert (_cluster_nodes(plan, n) == 1).all()
    assert 1 <= plan["blocks"] <= cuda.ROUND_CLUSTER_MAX
    assert blocks is None or plan["blocks"] <= blocks
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= min(cuda.ROUND_CLUSTER_THREADS, 1024)
    assert plan["tile"] % 32 == 0 and plan["blocks"] * plan["tile"] >= n > (plan["blocks"] - 1) * plan["tile"]
    assert plan["template"] == (str(plan["npt"]) if plan["npt"] else "global")
    assert plan["npt"] in (0, 1, 2, cuda.ROUND_NPT)
    assert plan["nodes_per_thread"] * plan["threads"] >= plan["tile"]
    if plan["npt"]:
        assert plan["nodes_per_thread"] == plan["npt"]
    # the last tile is ragged wherever the nodes do not fill it
    assert (n % plan["tile"] != 0) == (n - (plan["blocks"] - 1) * plan["tile"] < plan["tile"])


@pytest.mark.parametrize("tc", [0, 1, 4, 22, 64, 200])
def test_round_plan_shared_bytes(tc):
    # K16's published words (bins, dots, tile total), their fold, the
    # ranks' tile totals, the staged term columns and the tile's prefix,
    # within a block's 227 KB
    for n in ROUND_NODES:
        plan = cuda.round_plan(n, tc)
        words = (2 * (tc * (cuda.ROUND_DOM_SMALL + 1) + 1) + cuda.ROUND_CLUSTER_MAX
                 + cuda.ROUND_TERM_WORDS * tc + plan["tile"])
        assert plan["shared_bytes"] == 4 * words <= 227 * 1024


TOPO_NODES = (1, 31, 120, 1000, 1024, 1025, 2000, 3001, 5000, 9000, 16384, 16385, 100000)


def _topology_nodes(plan, n):
    """How many times each node is visited under a K2 plan, as the kernel
    walks it (csrc/topology_pod.cu): block b's tile [b * tile, min(N, (b +
    1) * tile)), thread t's node tile start + t (npt 1) or every
    threads-th node of the tile (npt 0)."""
    seen = np.zeros(n, np.int64)
    for b in range(plan["blocks"]):
        lo, hi = b * plan["tile"], min(n, (b + 1) * plan["tile"])
        assert lo < hi, "an empty tile"
        for t in range(plan["threads"]):
            nodes = [lo + t] if plan["npt"] else range(lo + t, hi, plan["threads"])
            for node in nodes:
                if node < hi:
                    seen[node] += 1
    return seen


@pytest.mark.parametrize("cluster", [None, False, True])
@pytest.mark.parametrize("blocks", [None, 1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("n", TOPO_NODES)
def test_topology_plan_covers_every_node_once(n, blocks, cluster):
    plan = cuda.topology_plan(n, 4, blocks, cluster=cluster)
    assert (_topology_nodes(plan, n) == 1).all()
    assert plan["blocks"] >= 1 and (blocks is None or plan["blocks"] <= blocks)
    assert plan["tile"] % 32 == 0 and plan["blocks"] * plan["tile"] >= n > (plan["blocks"] - 1) * plan["tile"]
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= cuda.TOPO_THREADS == 1024
    # one node a thread where a tile fits a block, the walk above
    assert plan["npt"] == (1 if plan["tile"] <= cuda.TOPO_THREADS else 0)
    assert plan["threads"] == (plan["tile"] if plan["npt"] else cuda.TOPO_THREADS)
    assert plan["nodes_per_thread"] * plan["threads"] >= plan["tile"]
    # a cluster never passes 16 blocks, nor is one of a single block
    assert plan["cluster"] in (0, 1) and plan["launch"] == ("cluster" if plan["cluster"] else "plain")
    if plan["cluster"]:
        assert 2 <= plan["blocks"] <= cuda.TOPO_CLUSTER_MAX == 16
    if cluster is None:
        # a plain launch up to 1024 nodes, a cluster above, of tiles of at
        # most TOPO_NODES_PER_BLOCK nodes (rounded to 32) where 16 blocks allow
        assert plan["cluster"] == (n > cuda.TOPO_THREADS and plan["blocks"] > 1)
        if blocks is None and n > cuda.TOPO_THREADS and plan["blocks"] < cuda.TOPO_CLUSTER_MAX:
            assert plan["tile"] <= -(-cuda.TOPO_NODES_PER_BLOCK // 32) * 32
        if blocks is None and n <= cuda.TOPO_THREADS:
            assert plan["tile"] <= -(-cuda.TOPO_SMALL_NODES // 32) * 32


@pytest.mark.parametrize("tc", [0, 1, 3, 4, 512, 1024, 1536, 4096])
def test_topology_plan_shared_bytes(tc):
    # the staged column records, the block's minima and the warps' minima:
    # in shared memory within a block's 227 KB while they fit the plan's
    # budget, past it in a slab of global scratch a block, each segment
    # 16-byte aligned (the records are read as int4)
    words = {"off_cols": cuda.TOPO_REC_WORDS * tc, "off_bmin": tc, "off_mins": 32 * tc}
    for n in (1000, 5000):
        plan = cuda.topology_plan(n, tc)
        assert plan["shared_bytes"] <= cuda.WAVE_SMEM < 227 * 1024
        shared = sum(4 * w for k, w in words.items() if plan[k] >= 0)
        slab = sum(4 * w for k, w in words.items() if plan[k] < 0)
        assert plan["shared_bytes"] >= shared and plan["slab_bytes"] >= slab
        assert plan["mode"] == ("global" if slab else "shared")
        assert (plan["mode"] == "global") == (4 * sum(words.values()) > cuda.WAVE_SMEM)
        for k in words:
            at = plan[k] if plan[k] >= 0 else -1 - plan[k]
            assert at % 16 == 0
            if plan[k] < 0:  # a slab segment's byte offset, past the ones before it
                assert at + 4 * words[k] <= plan["slab_bytes"]
        assert plan["slab_bytes"] % 16 == 0
        # with no shared budget every segment moves to the slab
        bare = cuda.topology_plan(n, tc, budget=0)
        assert bare["shared_bytes"] == 0 and all(bare[k] < 0 for k in words if words[k])
        assert bare["slab_bytes"] >= 4 * sum(words.values()) and bare["slab_bytes"] % 16 == 0
    assert cuda.topology_plan(1000, tc)["mode"] == ("global" if tc >= 1536 else "shared")


def test_round_plan_by_nodes():
    # one block for small rounds; a cluster on the bulk problem's 5000
    # nodes; never past the non-portable cluster size
    assert cuda.round_plan(31)["blocks"] == 1 and cuda.round_plan(120)["blocks"] == 1
    assert cuda.round_plan(5000)["blocks"] > 1
    assert cuda.round_plan(100000)["blocks"] == cuda.ROUND_CLUSTER_MAX
    assert [cuda.round_plan(n)["blocks"] for n in ROUND_NODES] == sorted(
        cuda.round_plan(n)["blocks"] for n in ROUND_NODES)
    for n in ROUND_NODES:
        assert cuda.round_plan(n)["blocks"] == cuda.round_blocks(n) or n <= 32


@pytest.mark.parametrize("n", NODES)
def test_relax_argument_block_carries_the_plan(n):
    rng = np.random.default_rng(n)
    s, c, r = 2, 3, 3
    args = (rng.random((c, n)) < 0.8, rng.random((c, r)).astype(np.float32), np.float32([5, 0, 7]),
            np.zeros((n, r), np.float32), np.ones((n, r), np.float32), rng.random((s, n)) < 0.9, np.float32(0.1))
    rb = trelax.relax_buffers(*args, "cpu")
    ctx = cuda.relax_ctx(rb)
    plan = cuda.relax_project_plan(n, s * c)
    assert (ctx.np2, ctx.threads, ctx.kpt, ctx.slabs) == (plan["np2"], plan["threads"], plan["keys_per_thread"],
                                                           plan["slabs"])
    assert ("scratch" in rb.cache) == (plan["path"] == "slab")


def _cuda_int(text: str, name: str) -> int:
    m = re.search(rf"\b{name}\s*=\s*([0-9]+)(?:\s*\*\s*([0-9]+))?", text)
    assert m, name
    return int(m.group(1)) * (int(m.group(2)) if m.group(2) else 1)


def test_plan_constants_mirror_the_cuda_sources():
    relax = (cuda.CSRC / "relax.cuh").read_text()
    wave = (cuda.CSRC / "wave.cuh").read_text()
    place = (cuda.CSRC / "sweep_place.cu").read_text()
    assert _cuda_int(relax, "RELAX_REG_ROW") == cuda.RELAX_REG_ROW
    assert _cuda_int(relax, "RELAX_ROW_THREADS") == cuda.RELAX_ROW_THREADS
    assert _cuda_int(relax, "RELAX_SHARED_ROW") == cuda.RELAX_SHARED_ROW
    assert _cuda_int(wave, "WAVE_BLOCK") == cuda.WAVE_BLOCK
    assert _cuda_int(wave, "WAVE_REG_NPT") == cuda.WAVE_REG_NPT
    assert _cuda_int(wave, "WAVE_SMEM") == cuda.WAVE_SMEM
    assert _cuda_int(place, "POD_HEAD") == cuda.SWEEP_POD_HEAD
    # SWEEP_ROWS = S_RAW + N_RAWS
    assert _cuda_int(place, "S_RAW") + 4 == cuda.SWEEP_ROWS
    for n in NODES:
        assert cuda.wave_threads(n) == min(max(-(-n // 32) * 32, 32), 1024)
    drain = (cuda.CSRC / "sweep_drain.cu").read_text()
    assert _cuda_int(drain, "DRAIN_THREADS") == cuda.DRAIN_THREADS
    assert _cuda_int(drain, "DRAIN_MIN_TILE") == cuda.DRAIN_MIN_TILE
    assert _cuda_int(drain, "DRAIN_BLOCKS_PER_SM") == cuda.DRAIN_BLOCKS_PER_SM
    assert _cuda_int(drain, "DRAIN_STAGE_ENTRIES") == cuda.DRAIN_STAGE_ENTRIES
    assert _cuda_int(drain, "DRAIN_STAGE_WORDS") == cuda.DRAIN_STAGE_WORDS
    # 5 words per staged entry, 10 per entry and term, 1 per entry and element
    assert "return en * (5 + 10 * tc + width);" in drain
    assert cuda.DRAIN_PAIR_WORDS == 10
    # K2: the block, the cluster, the staged column words, the templates
    # its entry dispatches on
    topo = (cuda.CSRC / "topology_pod.cu").read_text()
    step = (cuda.CSRC / "step_ctx.cuh").read_text()
    assert _cuda_int(topo, "TOPO_THREADS") == cuda.TOPO_THREADS
    assert _cuda_int(topo, "TOPO_CLUSTER_MAX") == cuda.TOPO_CLUSTER_MAX
    assert _cuda_int((cuda.CSRC / "topology.cuh").read_text(), "TOPO_REC_WORDS") == cuda.TOPO_REC_WORDS
    # the term columns' table: its words and flag bits (cuda.column_table)
    assert _cuda_int(step, "TOPO_COL_WORDS") == cuda.TOPO_COL_WORDS
    words = ("COL_TERM", "COL_KEY", "COL_IP", "COL_FLAGS", "COL_W_AFF", "COL_W_ANTI", "COL_HARD", "COL_SOFT")
    assert [_cuda_int(step, w) for w in words] == list(range(cuda.TOPO_COL_WORDS))
    for (field, bit), name in zip(cuda.TOPO_FLAG_BITS, ("TOPO_SMATCH", "TOPO_AFF", "TOPO_ANTI", "TOPO_SSHOST",
                                                        "TOPO_SSZONE")):
        assert _cuda_int(step, name) == bit, field
    for npt in (0, 1):
        for slab in ("true", "false"):
            assert f"launch_topology<{npt}, {slab}>" in topo
    assert "q.smem > WAVE_SMEM" in topo
    # K3: the block, the register and global templates its entry dispatches on
    score3 = (cuda.CSRC / "score_argmax_pod.cu").read_text()
    assert _cuda_int(score3, "SCORE_BLOCK") == cuda.SCORE_BLOCK
    assert _cuda_int(score3, "SCORE_REG_NPT") == cuda.SCORE_REG_NPT
    assert _cuda_int(score3, "SCORE_GLOBAL_NPT") == 0
    assert score3.count("return launch_score<") == 2
    assert "case SCORE_REG_NPT: return launch_score<SCORE_REG_NPT>" in score3
    assert "case SCORE_GLOBAL_NPT: return launch_score<SCORE_GLOBAL_NPT>" in score3
    # K8: threads, tiles, the widest digit
    audit = (cuda.CSRC / "audit_bulk.cu").read_text()
    for name in ("AUDIT_THREADS", "AUDIT_SORT_TILE", "AUDIT_SCAN_TILE", "AUDIT_MAX_DIGIT_BITS"):
        assert _cuda_int(audit, name) == getattr(cuda, name), name
    pick = (cuda.CSRC / "round_pick.cu").read_text()
    rounds_h = (cuda.CSRC / "rounds.cuh").read_text()
    assert _cuda_int(rounds_h, "ROUND_THREADS") == cuda.ROUND_THREADS
    assert _cuda_int(pick, "PICK_REG_NPT") == cuda.PICK_REG_NPT
    assert _cuda_int(pick, "PICK_LEVELS") == cuda.PICK_LEVELS
    assert _cuda_int(pick, "PICK_SORT_SMEM_N") == cuda.PICK_SORT_SMEM_N
    assert 1 << _cuda_int(pick, "PICK_RADIX_BITS") == cuda.PICK_BUCKETS
    assert _cuda_int(pick, "PICK_WARP_LADDER") == cuda.PICK_WARP_LADDER
    # the profile slots: one per phase, then the steps and the levels
    slots = re.search(r"enum : int \{\s*(PP_LOAD[^}]*)\}", pick).group(1)
    names = [w.split("=")[0].strip() for w in slots.split(",") if w.strip()]
    assert names[-1] == "PICK_PROF_SLOTS" and len(names) - 1 == cuda.PICK_PROF_SLOTS
    assert len(cuda.PICK_PHASES) == cuda.PICK_PROF_SLOTS - 2
    # the threshold templates the C entry dispatches on
    assert re.search(r"case PICK_REG_NPT: return launch_threshold<PICK_REG_NPT>", pick)
    for npt in (1, 2, 4):
        assert f"case {npt}: return launch_threshold<{npt}>" in pick
    # K14 / K16: the cluster plan, K16's shared words, the profile slots
    score = (cuda.CSRC / "round_score.cu").read_text()
    commit = (cuda.CSRC / "round_commit.cu").read_text()
    assert _cuda_int(rounds_h, "ROUND_CLUSTER_MAX") == cuda.ROUND_CLUSTER_MAX
    assert _cuda_int(rounds_h, "ROUND_CLUSTER_THREADS") == cuda.ROUND_CLUSTER_THREADS
    assert _cuda_int(rounds_h, "ROUND_NPT") == cuda.ROUND_NPT
    assert _cuda_int(rounds_h, "DOM_SMALL") == cuda.ROUND_DOM_SMALL
    assert _cuda_int(rounds_h, "ROUND_PROF_SLOTS") == cuda.ROUND_PROF_SLOTS
    assert "return tc * (DOM_SMALL + 1) + 1;" in commit
    assert "return 2 * commit_pub_words(tc) + ROUND_CLUSTER_MAX + COMMIT_TERM_WORDS * tc + tile;" in commit
    assert _cuda_int(commit, "COMMIT_TERM_WORDS") == cuda.ROUND_TERM_WORDS
    for src, enum, phases in ((score, "SP_PASS1", cuda.SCORE_PHASES), (commit, "CP_ZERO", cuda.COMMIT_PHASES)):
        slots = re.search(rf"enum : int \{{\s*({enum}[^}}]*)\}}", src).group(1)
        names = [w.split("=")[0].strip() for w in slots.split(",") if w.strip()]
        assert len(names) - 1 == len(phases) <= cuda.ROUND_PROF_SLOTS
    # the register templates K14's entry dispatches on
    for npt in (1, 2):
        assert f"case {npt}: return launch_score<{npt}>" in score
    assert "case ROUND_NPT: return launch_score<ROUND_NPT>" in score


def _struct_fields(text: str, struct: str) -> list:
    """(name, kind) of each field of `struct` in a CUDA source, in order:
    kind "ptr", "int", "long" (long long) or "float"."""
    body = text[text.index(f"struct {struct} {{") :]
    body = re.sub(r"//[^\n]*", "", body[: body.index("};")].split("{", 1)[1])
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        ptr = "*" in first
        kind = "ptr" if ptr else ("float" if re.match(r"float\b", first) else
                                  "long" if re.match(r"long long\b", first) else "int")
        out += [(n.strip(" *"), kind) for n in [first.split()[-1], *rest]]
    return out


@pytest.mark.parametrize("source, struct", [("step_ctx.cuh", "SweepCtx"), ("relax.cuh", "RelaxCtx"),
                                            ("rounds.cuh", "RoundPlan"), ("audit_bulk.cu", "AuditPlan"),
                                            ("score_argmax_pod.cu", "ScorePlan"),
                                            ("topology_pod.cu", "TopoPlan"), ("delta_runs.cuh", "DeltaPlan"),
                                            ("step_ctx.cuh", "DeltaCtx"), ("compact_compress.cu", "CompressPlan")])
def test_plan_argument_blocks_mirror_the_cuda_headers(source, struct):
    # both blocks are passed by address and read field by field: the ctypes
    # mirror lists the header's fields in its order, with their C types
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_longlong: "long",
                   ctypes.c_float: "float"}
    mirror = [(f, ctypes_kind[t]) for f, t in getattr(cuda, struct)._fields_]
    assert mirror == _struct_fields((cuda.CSRC / source).read_text(), struct)


def test_importing_the_port_builds_nothing():
    # every module of the port imported in a fresh interpreter: no kernel
    # built or loaded, no CUDA context, no triton
    code = (
        "import importlib, pkgutil, sys, torch, simtpu_torch\n"
        "for m in pkgutil.walk_packages(simtpu_torch.__path__, 'simtpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from simtpu_torch.kernels import cuda\n"
        "print(len(cuda._LIBS), torch.cuda.is_initialized(), 'triton' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "False", "False"]
