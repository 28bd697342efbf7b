"""The launch plans of K23 `relax_project` and K19 `sweep_place`.

Both wrappers take their launch arithmetic from plain Python functions in
`simtpu_torch/kernels/cuda.py` (`relax_project_plan`, `sweep_place_plan`),
which K19's CUDA entry follows and K23's checks. Here, at node counts on
both sides of every boundary (N = 999, 1024, 1025, 4096, 4097, 16 384,
16 385 and 100 000): K23's path, threads per row, keys per thread, rows per
block, shared bytes and slab switch; K19's threads, nodes per thread,
register template and shared-memory plan. Then the plans as the argument
blocks carry them, the constants they mirror in the CUDA sources, and the
argument blocks' fields against the CUDA headers. Nothing here needs a
card.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

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


def _struct_fields(text: str, struct: str) -> list:
    """(name, kind) of each field of `struct` in a CUDA source, in order:
    kind "ptr", "int" or "float"."""
    body = text[text.index(f"struct {struct} {{") :]
    body = re.sub(r"//[^\n]*", "", body[: body.index("};")].split("{", 1)[1])
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        ptr = "*" in first
        kind = "ptr" if ptr else ("float" if re.match(r"float\b", first) else "int")
        out += [(n.strip(" *"), kind) for n in [first.split()[-1], *rest]]
    return out


@pytest.mark.parametrize("source, struct", [("step_ctx.cuh", "SweepCtx"), ("relax.cuh", "RelaxCtx")])
def test_plan_argument_blocks_mirror_the_cuda_headers(source, struct):
    # both blocks are passed by address and read field by field: the ctypes
    # mirror lists the header's fields in its order, with their C types
    ctypes_kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_float: "float"}
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
