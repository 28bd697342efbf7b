"""Build, bind and launch the hand-written CUDA kernels.

K1-K6 make up the per-pod scheduling step (`engine/scan.py`), K7 applies
signed placement-log deltas (`engine/state.py`), K8 is the placement
auditor's bulk pass (`kernels/audit.py`), K9/K10 place a whole same-group
run of pods in one launch (`engine/wavefront.py`), K11-K13 compress,
expand and update the compact carried state (`engine/state.py`), K14-K16
score, pick and commit one bulk round (`engine/rounds.py`), K17 copies a
carried state for the incremental planner's probes
(`plan/incremental.py`), K18/K19 drain and requeue every scenario of a
batched sweep chunk, one block per scenario (`engine/batched.py`), K20
explains a chunk of unplaced pods' failures, one block per pod
(`explain/breakdown.py`), K21 decomposes one pod's score into its
plugin terms (`explain/scores.py`), K22/K23 run the solve backend's
relaxation, one load pass and one projection pass per iteration
(`solve/relax.py`), and K24/K25 grow a grow-mode carry along its term and
node axes (`engine/state.py`). The sources live in
`kernels/csrc/` (one `.cu` per kernel; the argument blocks in
`step_ctx.cuh`, the per-node device code that K1-K6 and K9/K10 share in
the other `.cuh` headers). On first use each source is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface under
`kernels/_build/` — all sources at once, one `nvcc` process each — and
loaded with ctypes. Nothing is built or imported at module import: the CPU
path never touches this machinery.

Flags: `-fmad=false` (no silent FMA contraction; the kernels write
`__fmaf_rn` where the reference contracts), IEEE division and square root,
no flush-to-zero. A build or launch failure raises; there is no fallback.

Counts: `LAUNCHES[name]` is bumped where a kernel is launched and nowhere
else; `PLAIN_CALLS[name]` where a kernel's plain PyTorch version runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

KERNELS = (
    "filter_pod", "topology_pod", "score_argmax_pod", "commit_pod",
    "storage_pod", "gpu_pod", "delta_apply", "audit_bulk", "wave_lean", "wave_hard",
    "compact_compress", "compact_expand", "compact_delta",
    "round_score", "round_pick", "round_commit", "carry_copy",
    "sweep_drain", "sweep_place", "explain_pass", "pod_terms",
    "relax_load", "relax_project", "grow_terms", "grow_nodes",
)
#: the per-pod kernels, launched as simtpu_<name>(StepCtx*, pod, stream)
STEP_KERNELS = KERNELS[:6]
#: the wave kernels, launched as simtpu_<name>(StepCtx*, WaveCtx*, stream)
WAVE_KERNELS = KERNELS[8:10]
#: the round kernels, launched as simtpu_<name>(StepCtx*, RoundCtx*, stream)
ROUND_KERNELS = KERNELS[13:16]
#: the sweep kernels, launched as simtpu_<name>(DeltaCtx* or StepCtx*,
#: SweepCtx*, stream)
SWEEP_KERNELS = KERNELS[17:19]
#: the explain pass, launched as simtpu_explain_pass(StepCtx*, ExplainCtx*,
#: stream); the score terms as simtpu_pod_terms(StepCtx*, pod, terms, stream)
EXPLAIN_KERNELS = KERNELS[19:21]
#: widest VG / device / GPU axis the kernels keep per thread (MAX_EXT)
MAX_EXT = 32
#: K9's carried [N] rows (step_ctx.cuh WAVE_ROWS)
WAVE_ROWS = 9
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
_LIBS: dict = {}
#: seconds the last build took and ptxas' report per kernel (for logs)
BUILD_INFO: dict = {}


def count_plain(name: str) -> None:
    PLAIN_CALLS[name] += 1


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source on first use")
    return nvcc


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel library that is not built yet (in parallel) and
    load all of them. Returns {name: ctypes.CDLL}."""
    if len(_LIBS) == len(KERNELS):
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in KERNELS:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    for name in KERNELS:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"simtpu_{name}")
        if name in STEP_KERNELS:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        elif name in WAVE_KERNELS or name in ROUND_KERNELS or name in SWEEP_KERNELS:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "explain_pass":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "pod_terms":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    first = _LIBS[KERNELS[0]]
    first.simtpu_noop.argtypes = [ctypes.c_void_p]
    first.simtpu_noop.restype = ctypes.c_int
    first.simtpu_error_string.argtypes = [ctypes.c_int]
    first.simtpu_error_string.restype = ctypes.c_char_p
    return _LIBS


_INT_FIELDS = ("n", "r", "p_ports", "w", "c", "tc", "flags", "v", "sd", "gd", "l", "k")
# (field, owner, attribute, dtype) in step_ctx.cuh order
_PTR_FIELDS = (
    ("group", "buf", "group", torch.int32),
    ("req", "buf", "req", torch.float32),
    ("pin", "buf", "pin", torch.int32),
    ("forced", "buf", "forced", torch.bool),
    ("lvm_size", "buf", "lvm_size", torch.float32),
    ("lvm_vg", "buf", "lvm_vg", torch.int32),
    ("dev_size", "buf", "dev_size", torch.float32),
    ("dev_media", "buf", "dev_media", torch.int32),
    ("gpu_mem", "buf", "gpu_mem", torch.float32),
    ("gpu_count", "buf", "gpu_count", torch.int32),
    ("gpu_preset", "buf", "gpu_preset", torch.int32),
    ("ext_live", "buf", "ext_live", torch.uint8),
    ("alloc", "statics", "alloc", torch.float32),
    ("static_mask", "statics", "static_mask", torch.bool),
    ("vol_mask", "statics", "vol_mask", torch.bool),
    ("node_pref", "statics", "node_pref", torch.float32),
    ("taint_intol", "statics", "taint_intol", torch.float32),
    ("static_score", "statics", "static_score", torch.float32),
    ("avoid_pen", "statics", "avoid_pen", torch.float32),
    ("node_dom", "statics", "node_dom", torch.int32),
    ("term_topo", "statics", "term_topo", torch.int32),
    ("ip_of", "statics", "ip_of", torch.int32),
    ("g_terms", "statics", "g_terms", torch.int32),
    ("s_match", "statics", "s_match", torch.bool),
    ("a_aff_req", "statics", "a_aff_req", torch.bool),
    ("a_anti_req", "statics", "a_anti_req", torch.bool),
    ("w_aff_pref", "statics", "w_aff_pref", torch.float32),
    ("w_anti_pref", "statics", "w_anti_pref", torch.float32),
    ("spread_hard", "statics", "spread_hard", torch.float32),
    ("spread_soft", "statics", "spread_soft", torch.float32),
    ("ss_host", "statics", "ss_host", torch.bool),
    ("ss_zone", "statics", "ss_zone", torch.bool),
    ("ports_req", "statics", "ports_req", torch.bool),
    ("vol_rw_req", "statics", "vol_rw_req", torch.bool),
    ("vol_ro_req", "statics", "vol_ro_req", torch.bool),
    ("vol_att_req", "statics", "vol_att_req", torch.bool),
    ("vol_class_mask", "statics", "vol_class_mask", torch.bool),
    ("attach_limits", "statics", "attach_limits", torch.float32),
    ("has_storage", "statics", "has_storage", torch.bool),
    ("vg_cap", "statics", "vg_cap", torch.float32),
    ("vg_name_id", "statics", "vg_name_id", torch.int32),
    ("sdev_cap", "statics", "sdev_cap", torch.float32),
    ("sdev_media", "statics", "sdev_media", torch.int32),
    ("gpu_dev_exists", "statics", "gpu_dev_exists", torch.bool),
    ("gpu_total", "statics", "gpu_total", torch.float32),
    ("score_w", "statics", "score_w", torch.float32),
    ("node_valid", "statics", "node_valid", torch.bool),
    ("free", "state", "free", torch.float32),
    ("cnt_match", "state", "cnt_match", torch.float32),
    ("cnt_total", "state", "cnt_total", torch.float32),
    ("cnt_own_anti", "state", "cnt_own_anti", torch.float32),
    ("cnt_own_aff", "state", "cnt_own_aff", torch.float32),
    ("w_own_aff_pref", "state", "w_own_aff_pref", torch.float32),
    ("w_own_anti_pref", "state", "w_own_anti_pref", torch.float32),
    ("ports_used", "state", "ports_used", torch.float32),
    ("vols_any", "state", "vols_any", torch.float32),
    ("vols_rw", "state", "vols_rw", torch.float32),
    ("vg_free", "state", "vg_free", torch.float32),
    ("sdev_free", "state", "sdev_free", torch.bool),
    ("gpu_free", "state", "gpu_free", torch.float32),
    ("stage", "buf", "stage", torch.uint8),
    ("raw", "buf", "raw", torch.float32),
    ("score", "buf", "score", torch.float32),
    ("st_ok", "buf", "st_ok", torch.bool),
    ("st_alloc", "buf", "st_alloc", torch.float32),
    ("st_take", "buf", "st_take", torch.bool),
    ("st_raw", "buf", "st_raw", torch.float32),
    ("gpu_ok", "buf", "gpu_ok", torch.bool),
    ("gpu_sh", "buf", "gpu_sh", torch.float32),
    ("chosen", "buf", "chosen", torch.int32),
    ("placed", "buf", "placed", torch.bool),
    ("reason", "buf", "reason", torch.int32),
    ("out_node", "buf", "out_node", torch.int32),
    ("out_lvm", "buf", "out_lvm", torch.float32),
    ("out_take", "buf", "out_take", torch.bool),
    ("out_gpu", "buf", "out_gpu", torch.float32),
)


class StepCtx(ctypes.Structure):
    """ctypes mirror of `struct StepCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _, _ in _PTR_FIELDS
    ]


def _checked(field: str, t: torch.Tensor, device, dtype) -> torch.Tensor:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{field}: need a contiguous {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    return t


def _check_shapes(tensors: dict, want: dict) -> None:
    for field, shape in want.items():
        if tuple(tensors[field].shape) != shape:
            raise ValueError(f"{field}: shape {tuple(tensors[field].shape)}, want {shape}")


def make_ctx(buf, out_rows: int = None) -> StepCtx:
    """The kernels' argument block for a StepBuffers: checks every tensor's
    device, dtype, contiguity and shape, then takes its address. The
    buffers keep the tensors alive as long as the block is in use.
    `out_rows` is the per-pod outputs' row count when it is not the
    batch's (the sweep's output rows follow its pod lists)."""
    owners = {"buf": buf, "statics": buf.statics, "state": buf.state}
    tensors = {
        field: _checked(f"{owner}.{attr}", getattr(owners[owner], attr), buf.device, dtype)
        for field, owner, attr, dtype in _PTR_FIELDS
    }
    st = buf.statics
    n, r = st.alloc.shape
    g, tc = st.g_terms.shape
    p, w, c = st.ports_req.shape[1], st.vol_rw_req.shape[1], st.vol_class_mask.shape[0]
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], buf.state.gpu_free.shape[1]
    l, k = buf.lvm_size.shape[1], buf.dev_size.shape[1]
    if max(v, sd, gd) > MAX_EXT:
        raise ValueError(f"VG/device/GPU axes ({v}, {sd}, {gd}) wider than {MAX_EXT}")
    pods = buf.n_pods
    rows = pods if out_rows is None else out_rows
    _check_shapes(tensors, {
        "req": (pods, r), "free": (n, r), "ports_used": (n, p), "vols_any": (n, w),
        "vols_rw": (n, w), "attach_limits": (n, c), "stage": (n,), "raw": (4, n),
        "lvm_size": (pods, l), "lvm_vg": (pods, l), "dev_size": (pods, k), "dev_media": (pods, k),
        "gpu_preset": (pods, gd), "vg_name_id": (n, v), "vg_free": (n, v), "sdev_free": (n, sd),
        "sdev_media": (n, sd), "gpu_dev_exists": (n, gd), "gpu_free": (n, gd),
        "st_alloc": (n, v), "st_take": (n, sd), "gpu_sh": (n, gd),
        "out_lvm": (rows, v), "out_take": (rows, sd), "out_gpu": (rows, gd),
        **{f: (g, n) for f in ("static_mask", "vol_mask", "node_pref", "taint_intol",
                                "static_score", "avoid_pen")},
        **{f: (g, tc) for f in ("s_match", "a_aff_req", "a_anti_req", "w_aff_pref",
                                 "w_anti_pref", "spread_hard", "spread_soft", "ss_host", "ss_zone")},
    })
    return StepCtx(
        n=n, r=r, p_ports=p, w=w, c=c, tc=tc, flags=buf.flag_bits, v=v, sd=sd, gd=gd, l=l, k=k,
        **{f: t.data_ptr() for f, t in tensors.items()},
    )


def launch(name: str, buf, i: int) -> None:
    """Launch kernel `name` for pod i of `buf` on the current CUDA stream;
    raises if the launch is refused. No synchronization."""
    if not 0 <= i < buf.n_pods:
        raise IndexError(f"pod {i} outside the batch of {buf.n_pods}")
    libs = build()
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = getattr(libs[name], f"simtpu_{name}")(ctypes.byref(buf.ctx), i, stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


_WAVE_INT_FIELDS = ("a", "b", "mode", "k")
# (field, attribute of the StepBuffers, dtype) in step_ctx.cuh WaveCtx order
_WAVE_PTR_FIELDS = (
    ("bits", "wave_bits", torch.uint8),
    ("carry", "wave_rows", torch.float32),
)
# WaveCtx.mode bits (step_ctx.cuh): K9's inter-pod preference carry; the
# run's heavy stage bits from WAVE_HEAVY_SHIFT up
WAVE_PREF = 1
WAVE_HEAVY_SHIFT = 4


class WaveCtx(ctypes.Structure):
    """ctypes mirror of `struct WaveCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _WAVE_INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _ in _WAVE_PTR_FIELDS
    ]


def make_wave_ctx(buf, a: int, b: int, mode) -> WaveCtx:
    """The wave kernels' argument block for the run [a, b) of `buf` under
    the wave's `mode` (hard, pref, heavy bits; engine/wavefront.py
    plan_waves): checks the range and every tensor as make_ctx does. Any
    number of topology keys: K9 sizes its per-key table at the launch."""
    if not 0 <= a < b <= buf.n_pods:
        raise IndexError(f"run [{a}, {b}) outside the batch of {buf.n_pods}")
    _, pref, heavy = mode
    tensors = {
        field: _checked(f"buf.{attr}", getattr(buf, attr), buf.device, dtype)
        for field, attr, dtype in _WAVE_PTR_FIELDS
    }
    n = buf.statics.alloc.shape[0]
    _check_shapes(tensors, {"bits": (n,), "carry": (WAVE_ROWS, n)})
    k, n_dom = buf.statics.node_dom.shape
    if n_dom != n:
        raise ValueError(f"node_dom: shape {(k, n_dom)}, want {(k, n)}")
    bits = (WAVE_PREF if pref else 0) | int(heavy) << WAVE_HEAVY_SHIFT
    return WaveCtx(a=a, b=b, mode=bits, k=k, **{f: t.data_ptr() for f, t in tensors.items()})


def launch_wave(name: str, buf, a: int, b: int, mode) -> None:
    """Launch wave kernel `name` for the run [a, b) of `buf` on the current
    CUDA stream; raises if the launch is refused. No synchronization."""
    libs = build()
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    ctx = make_wave_ctx(buf, a, b, mode)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = getattr(libs[name], f"simtpu_{name}")(ctypes.byref(buf.ctx), ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


_DELTA_INT_FIELDS = ("n", "r", "p_ports", "w", "v", "sd", "gd", "tc", "e", "pad_")
# (field, owner, dtype) in step_ctx.cuh DeltaCtx order
_DELTA_PTR_FIELDS = (
    ("g", "entries", torch.int32),
    ("node", "entries", torch.int32),
    ("wgt", "entries", torch.float32),
    ("req", "entries", torch.float32),
    ("vg", "entries", torch.float32),
    ("sd_take", "entries", torch.bool),
    ("gp", "entries", torch.float32),
    ("ports_req", "statics", torch.bool),
    ("vol_rw_req", "statics", torch.bool),
    ("vol_ro_req", "statics", torch.bool),
    ("vol_att_req", "statics", torch.bool),
    ("node_dom", "statics", torch.int32),
    ("term_topo", "statics", torch.int32),
    ("ip_of", "statics", torch.int32),
    ("g_terms", "statics", torch.int32),
    ("s_match", "statics", torch.bool),
    ("a_aff_req", "statics", torch.bool),
    ("a_anti_req", "statics", torch.bool),
    ("w_aff_pref", "statics", torch.float32),
    ("w_anti_pref", "statics", torch.float32),
    ("free", "state", torch.float32),
    ("cnt_match", "state", torch.float32),
    ("cnt_total", "state", torch.float32),
    ("cnt_own_anti", "state", torch.float32),
    ("cnt_own_aff", "state", torch.float32),
    ("w_own_aff_pref", "state", torch.float32),
    ("w_own_anti_pref", "state", torch.float32),
    ("vg_free", "state", torch.float32),
    ("sdev_free", "state", torch.bool),
    ("gpu_free", "state", torch.float32),
    ("ports_used", "state", torch.float32),
    ("vols_any", "state", torch.float32),
    ("vols_rw", "state", torch.float32),
)


class DeltaCtx(ctypes.Structure):
    """ctypes mirror of `struct DeltaCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _DELTA_INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _ in _DELTA_PTR_FIELDS
    ]


def make_delta_ctx(statics, state, entries: dict) -> DeltaCtx:
    """K7's argument block: `entries` maps g, node, wgt, req, vg, sd_take,
    gp to device tensors (which the caller keeps alive until the launch is
    enqueued; the stream orders any reuse of their memory after it)."""
    device = state.free.device
    owners = {"entries": entries, "statics": statics._asdict(), "state": state._asdict()}
    tensors = {
        f: _checked(f"{owner}.{f}", owners[owner][f], device, dtype)
        for f, owner, dtype in _DELTA_PTR_FIELDS
    }
    n, r = state.free.shape
    e = tensors["g"].shape[0]
    v, sd, gd = state.vg_free.shape[1], state.sdev_free.shape[1], state.gpu_free.shape[1]
    _check_shapes(tensors, {"node": (e,), "wgt": (e,), "req": (e, r), "vg": (e, v),
                            "sd_take": (e, sd), "gp": (e, gd)})
    return DeltaCtx(
        n=n, r=r, p_ports=state.ports_used.shape[1], w=state.vols_any.shape[1], v=v, sd=sd,
        gd=gd, tc=statics.g_terms.shape[1], e=e, pad_=0,
        **{f: t.data_ptr() for f, t in tensors.items()},
    )


def launch_delta(statics, state, packed) -> None:
    """K7 over the packed entries (`engine/state.py pack_delta_entries`) on
    the current CUDA stream, in one launch; raises if it is refused."""
    libs = build()
    device = state.free.device
    names = ("g", "node", "wgt", "req", "vg", "sd_take", "gp")
    entries = {
        name: torch.as_tensor(np.ascontiguousarray(arr), device=device)
        for name, arr in zip(names, packed)
    }
    ctx = make_delta_ctx(statics, state, entries)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["delta_apply"].simtpu_delta_apply(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel delta_apply failed to launch: {msg} ({err})")
    LAUNCHES["delta_apply"] += 1


_COMPACT_INT_FIELDS = ("n", "t", "ti", "rt", "rd", "rti", "rdi", "d", "k", "r", "p", "w", "v",
                       "sd", "gd", "tc", "e", "pad_")
# (field, owner, attribute, dtype) in step_ctx.cuh CompactCtx order; a
# launch fills the fields of the owners it is given and leaves the rest null
_COMPACT_PTR_FIELDS = (
    *((f, "spec", f, torch.int32) for f in ("t_tab", "t_dense", "t_keys", "t_rep", "ip_tab",
                                             "ip_dense", "ip_keys", "ip_rep")),
    ("nds", "nds", "nds", torch.int32),
    *((f, "dspec", f, torch.int32) for f in ("t_tab_of", "t_dense_of", "ip_tab_of", "ip_dense_of")),
    ("node_dom", "ndom", "node_dom", torch.int32),
    *((f, "entries", f, dt) for f, _, dt in _DELTA_PTR_FIELDS[:7]),
    *((f, "statics", f, dt) for f, _, dt in _DELTA_PTR_FIELDS[7:11]),
    *((f, "statics", f, dt) for f, _, dt in _DELTA_PTR_FIELDS[12:20]),
    ("free", "dense", "free", torch.float32),
    ("cnt_match", "dense", "cnt_match", torch.float32),
    ("cnt_total", "dense", "cnt_total", torch.float32),
    ("cnt_own_anti", "dense", "cnt_own_anti", torch.float32),
    ("cnt_own_aff", "dense", "cnt_own_aff", torch.float32),
    ("w_own_aff_pref", "dense", "w_own_aff_pref", torch.float32),
    ("w_own_anti_pref", "dense", "w_own_anti_pref", torch.float32),
    ("vg_free", "dense", "vg_free", torch.float32),
    ("sdev_free", "dense", "sdev_free", torch.bool),
    ("gpu_free", "dense", "gpu_free", torch.float32),
    ("ports_used", "dense", "ports_used", torch.float32),
    ("vols_any", "dense", "vols_any", torch.float32),
    ("vols_rw", "dense", "vols_rw", torch.float32),
    ("c_free", "compact", "free", torch.float32),
    ("cm_tab", "compact", "cm_tab", torch.int32),
    ("cm_dense", "compact", "cm_dense", torch.int32),
    ("c_cnt_total", "compact", "cnt_total", torch.int32),
    *((f, "compact", f, torch.int32) for f in ("oa_tab", "oa_dense", "of_tab", "of_dense", "wa_tab",
                                                "wa_dense", "wn_tab", "wn_dense")),
    ("c_vg_free", "compact", "vg_free", torch.float32),
    ("c_sdev_free", "compact", "sdev_free", torch.bool),
    ("c_gpu_free", "compact", "gpu_free", torch.float32),
    ("c_ports_used", "compact", "ports_used", torch.int32),
    ("c_vols_any", "compact", "vols_any", torch.int32),
    ("c_vols_rw", "compact", "vols_rw", torch.int32),
)
#: SchedState's fields (engine/state.py), in order
DENSE_FIELDS = ("free", "cnt_match", "cnt_total", "cnt_own_anti", "cnt_own_aff", "w_own_aff_pref",
                "w_own_anti_pref", "vg_free", "sdev_free", "gpu_free", "ports_used", "vols_any",
                "vols_rw")


class CompactCtx(ctypes.Structure):
    """ctypes mirror of `struct CompactCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _COMPACT_INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _, _ in _COMPACT_PTR_FIELDS
    ]


def make_compact_ctx(device, owners: dict, dims: dict, want: dict) -> CompactCtx:
    """The compact kernels' argument block: `owners` maps an owner name of
    _COMPACT_PTR_FIELDS to a mapping of its tensors (owners not given stay
    null); every tensor's device, dtype and contiguity is checked, and the
    shapes in `want` (field -> shape)."""
    tensors = {
        f: _checked(f"{owner}.{attr}", owners[owner][attr], device, dtype)
        for f, owner, attr, dtype in _COMPACT_PTR_FIELDS if owner in owners
    }
    _check_shapes(tensors, want)
    return CompactCtx(**dims, **{f: t.data_ptr() for f, t in tensors.items()})


def _compact_dims(spec, n: int, d: int, t: int, ti: int, widths) -> dict:
    r, p, w, v, sd, gd = widths
    return dict(n=n, t=t, ti=ti, rt=spec.t_tab.shape[0], rd=spec.t_dense.shape[0],
                rti=spec.ip_tab.shape[0], rdi=spec.ip_dense.shape[0], d=d, r=r, p=p, w=w, v=v,
                sd=sd, gd=gd)


def _spec_shapes(spec, d: int) -> dict:
    rt, rd, rti, rdi = (x.shape[0] for x in (spec.t_tab, spec.t_dense, spec.ip_tab, spec.ip_dense))
    return {"t_dense": (rd,), "t_keys": (rt,), "t_rep": (rt, d), "ip_dense": (rdi,),
            "ip_keys": (rti,), "ip_rep": (rti, d)}


def _compact_shapes(dims: dict) -> dict:
    n, d = dims["n"], dims["d"]
    return {"c_free": (n, dims["r"]), "cm_tab": (dims["rt"], d), "cm_dense": (dims["rd"], n),
            "c_cnt_total": (dims["t"],),
            **{f: (dims["rti"], d) for f in ("oa_tab", "of_tab", "wa_tab", "wn_tab")},
            **{f: (dims["rdi"], n) for f in ("oa_dense", "of_dense", "wa_dense", "wn_dense")},
            "c_vg_free": (n, dims["v"]), "c_sdev_free": (n, dims["sd"]),
            "c_gpu_free": (n, dims["gd"]), "c_ports_used": (n, dims["p"]),
            "c_vols_any": (n, dims["w"]), "c_vols_rw": (n, dims["w"])}


def _dense_shapes(dims: dict) -> dict:
    n = dims["n"]
    return {"free": (n, dims["r"]), "cnt_match": (dims["t"], n), "cnt_total": (dims["t"],),
            **{f: (dims["ti"], n) for f in ("cnt_own_anti", "cnt_own_aff", "w_own_aff_pref",
                                            "w_own_anti_pref")},
            "vg_free": (n, dims["v"]), "sdev_free": (n, dims["sd"]), "gpu_free": (n, dims["gd"]),
            "ports_used": (n, dims["p"]), "vols_any": (n, dims["w"]), "vols_rw": (n, dims["w"])}


def _launch_compact(name: str, ctx: CompactCtx, device) -> None:
    libs = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(libs[name], f"simtpu_{name}")(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


def compress_ctx(spec, state):
    """K11's argument block for the dense `state` (an engine/state.py
    SchedState) under `spec` (a CompactSpecDev on the same device), and
    CompactState's fields: the narrowed planes allocated here for the
    kernel to write, free / vg_free / gpu_free the dense tensors themselves."""
    device = state.free.device
    n = state.free.shape[0]
    d = spec.t_rep.shape[1]
    widths = (state.free.shape[1], state.ports_used.shape[1], state.vols_any.shape[1],
              state.vg_free.shape[1], state.sdev_free.shape[1], state.gpu_free.shape[1])
    dims = _compact_dims(spec, n, d, state.cnt_match.shape[0], state.cnt_own_anti.shape[0], widths)

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {
        "free": state.free, "cm_tab": empty(dims["rt"], d), "cm_dense": empty(dims["rd"], n),
        "cnt_total": empty(dims["t"]),
        **{f: empty(dims["rti"], d) for f in ("oa_tab", "of_tab", "wa_tab", "wn_tab")},
        **{f: empty(dims["rdi"], n) for f in ("oa_dense", "of_dense", "wa_dense", "wn_dense")},
        "vg_free": state.vg_free, "sdev_free": empty(n, dims["sd"], dtype=torch.bool),
        "gpu_free": state.gpu_free, "ports_used": empty(n, dims["p"]),
        "vols_any": empty(n, dims["w"]), "vols_rw": empty(n, dims["w"]),
    }
    ctx = make_compact_ctx(device, {"spec": spec._asdict(), "dense": state._asdict(), "compact": out},
                           dims, {**_spec_shapes(spec, d), **_dense_shapes(dims), **_compact_shapes(dims)})
    return ctx, out


def expand_ctx(spec, cstate, nds):
    """K12's argument block for the compact carry `cstate` under `spec`,
    node_dom_small `nds` [K, N], and SchedState's fields, every plane
    allocated here for the kernel to write."""
    device = cstate.free.device
    n = cstate.free.shape[0]
    d = spec.t_rep.shape[1]
    t = cstate.cnt_total.shape[0]
    ti = cstate.oa_tab.shape[0] + cstate.oa_dense.shape[0]
    widths = (cstate.free.shape[1], cstate.ports_used.shape[1], cstate.vols_any.shape[1],
              cstate.vg_free.shape[1], cstate.sdev_free.shape[1], cstate.gpu_free.shape[1])
    dims = _compact_dims(spec, n, d, t, ti, widths)
    dims["k"] = nds.shape[0]
    shapes = _dense_shapes(dims)
    out = {f: torch.empty(shapes[f], dtype=torch.bool if f == "sdev_free" else torch.float32,
                          device=device) for f in DENSE_FIELDS}
    ctx = make_compact_ctx(device, {"spec": spec._asdict(), "nds": {"nds": nds},
                                    "compact": cstate._asdict(), "dense": out}, dims,
                           {**_spec_shapes(spec, d), "nds": (dims["k"], n), **shapes,
                            **_compact_shapes(dims)})
    return ctx, out


def delta_ctx(statics, dspec, ndom, nds, cstate, packed):
    """K13's argument block for folding the packed entries
    (`engine/state.py pack_delta_entries`) into the compact carry `cstate`;
    `dspec` is its CompactDeltaSpec, `ndom` / `nds` node_dom and
    node_dom_small at the carry's width. Returns (block, the entries on the
    device), which the caller keeps alive until the launch is enqueued."""
    device = cstate.free.device
    names = ("g", "node", "wgt", "req", "vg", "sd_take", "gp")
    entries = {
        name: torch.as_tensor(np.ascontiguousarray(arr), device=device)
        for name, arr in zip(names, packed)
    }
    n, r = cstate.free.shape
    t = cstate.cnt_total.shape[0]
    e = entries["g"].shape[0]
    dims = dict(n=n, t=t, ti=dspec.ip_tab_of.shape[0], rt=cstate.cm_tab.shape[0],
                rd=cstate.cm_dense.shape[0], rti=cstate.oa_tab.shape[0], rdi=cstate.oa_dense.shape[0],
                d=cstate.cm_tab.shape[1], k=ndom.shape[0], r=r, p=cstate.ports_used.shape[1],
                w=cstate.vols_any.shape[1], v=cstate.vg_free.shape[1], sd=cstate.sdev_free.shape[1],
                gd=cstate.gpu_free.shape[1], tc=statics.g_terms.shape[1], e=e)
    ctx = make_compact_ctx(
        device,
        {"dspec": dspec._asdict(), "nds": {"nds": nds}, "ndom": {"node_dom": ndom}, "entries": entries,
         "statics": statics._asdict(), "compact": cstate._asdict()},
        dims,
        {"nds": (dims["k"], n), "node_dom": (dims["k"], n), "t_tab_of": (t,), "t_dense_of": (t,),
         "ip_dense_of": (dims["ti"],), "node": (e,), "wgt": (e,), "req": (e, r),
         "vg": (e, dims["v"]), "sd_take": (e, dims["sd"]), "gp": (e, dims["gd"]),
         **_compact_shapes(dims)},
    )
    return ctx, entries


def launch_compact_compress(spec, state) -> dict:
    """K11 (see compress_ctx) in one launch on the current stream; returns
    CompactState's fields."""
    ctx, out = compress_ctx(spec, state)
    _launch_compact("compact_compress", ctx, state.free.device)
    return out


def launch_compact_expand(spec, cstate, nds) -> dict:
    """K12 (see expand_ctx) in one launch on the current stream; returns
    SchedState's fields, every plane a fresh tensor."""
    ctx, out = expand_ctx(spec, cstate, nds)
    _launch_compact("compact_expand", ctx, cstate.free.device)
    return out


def launch_compact_delta(statics, dspec, ndom, nds, cstate, packed) -> None:
    """K13 (see delta_ctx): the entries folded into `cstate` in place, in
    one launch on the current stream."""
    ctx, entries = delta_ctx(statics, dspec, ndom, nds, cstate, packed)
    _launch_compact("compact_delta", ctx, cstate.free.device)


def launch_noop(device) -> None:
    """An empty kernel launch: the per-launch floor (for measurements)."""
    libs = build()
    err = libs[KERNELS[0]].simtpu_noop(torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"empty kernel failed to launch ({err})")


_AUDIT_INT_FIELDS = ("n", "m", "r", "p", "w", "c", "v", "sd", "gd", "pad_")
# (field, AuditInputs attribute, dtype) in audit_bulk.cu AuditCtx order
_AUDIT_PTR_FIELDS = (
    ("alloc", "alloc", torch.float64),
    ("node_valid", "node_valid", torch.bool),
    ("attach_limits", "attach_limits", torch.float64),
    ("vg_avail0", "vg_avail0", torch.float64),
    ("sdev_free0", "sdev_free0", torch.bool),
    ("gpu_total", "gpu_total", torch.float64),
    ("static_mask", "static_mask", torch.bool),
    ("vol_mask", "vol_mask", torch.bool),
    ("ports", "ports", torch.bool),
    ("vol_rw", "vol_rw", torch.bool),
    ("vol_ro", "vol_ro", torch.bool),
    ("vol_att", "vol_att", torch.bool),
    ("vol_class_mask", "vol_class_mask", torch.float64),
    ("g", "g", torch.int64),
    ("node", "n", torch.int64),
    ("pin", "pin", torch.int64),
    ("forced", "forced", torch.bool),
    ("req", "req", torch.float64),
    ("lvm", "lvm", torch.float64),
    ("sdev", "sdev", torch.bool),
    ("gpu", "gpu", torch.float64),
)


class AuditCtx(ctypes.Structure):
    """ctypes mirror of `struct AuditCtx` in csrc/audit_bulk.cu."""

    _fields_ = [(f, ctypes.c_int) for f in _AUDIT_INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _ in _AUDIT_PTR_FIELDS
    ] + [("acc", ctypes.c_void_p), ("flags", ctypes.c_void_p)]


def launch_audit(x) -> torch.Tensor:
    """K8 over `x` (a kernels/audit.py AuditInputs on one CUDA device) on
    the current stream, in one launch; returns the flag words [M] int32.
    Raises if an input is malformed or the launch is refused."""
    libs = build()
    device = x.alloc.device
    tensors = {
        f: _checked(f"audit.{attr}", getattr(x, attr), device, dtype)
        for f, attr, dtype in _AUDIT_PTR_FIELDS
    }
    n, r = x.alloc.shape
    g = x.static_mask.shape[0]
    m = x.g.shape[0]
    p, w, c = x.ports.shape[1], x.vol_rw.shape[1], x.vol_class_mask.shape[0]
    v, sd, gd = x.vg_avail0.shape[1], x.sdev_free0.shape[1], x.gpu_total.shape[1]
    _check_shapes(tensors, {
        "node_valid": (n,), "attach_limits": (n, c), "vg_avail0": (n, v), "sdev_free0": (n, sd),
        "gpu_total": (n, gd), "static_mask": (g, n), "vol_mask": (g, n), "ports": (g, p),
        "vol_rw": (g, w), "vol_ro": (g, w), "vol_att": (g, w), "vol_class_mask": (c, w),
        "node": (m,), "pin": (m,), "forced": (m,), "req": (m, r), "lvm": (m, v),
        "sdev": (m, sd), "gpu": (m, gd),
    })
    # the walkers' running sums: written (zeroed first) by the kernel itself
    acc = torch.empty((n, r + p + 2 * w + v + sd + gd), dtype=torch.float64, device=device)
    flags = torch.zeros(m, dtype=torch.int32, device=device)
    ctx = AuditCtx(n=n, m=m, r=r, p=p, w=w, c=c, v=v, sd=sd, gd=gd, pad_=0,
                   acc=acc.data_ptr(), flags=flags.data_ptr(),
                   **{f: t.data_ptr() for f, t in tensors.items()})
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["audit_bulk"].simtpu_audit_bulk(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel audit_bulk failed to launch: {msg} ({err})")
    LAUNCHES["audit_bulk"] += 1
    return flags


_ROUND_INT_FIELDS = ("i", "k", "mode", "row", "n_dom", "k_cap")
# (field, attribute of the RoundBuffers, dtype) in rounds.cuh RoundCtx order
_ROUND_PTR_FIELDS = (
    ("cap", "cap", torch.float32),
    ("s0", "s0", torch.float32),
    ("slope", "slope", torch.float32),
    ("m_n", "m_n", torch.float32),
    ("m_all", "m_all", torch.bool),
    ("ord_vg", "ord_vg", torch.int32),
    ("cs_vg", "cs_vg", torch.float32),
    ("cum_vg", "cum_vg", torch.float32),
    ("ord_dev", "ord_dev", torch.int32),
    ("cs_dev", "cs_dev", torch.float32),
    ("cum_dev", "cum_dev", torch.float32),
    ("ord_gpu", "ord_gpu", torch.int32),
    ("cs_gpu", "cs_gpu", torch.float32),
    ("cum_gpu", "cum_gpu", torch.float32),
    ("c_gpu", "c_gpu", torch.float32),
    ("cum_gidx", "cum_gidx", torch.float32),
    ("dom_sums", "dom_sums", torch.float32),
    ("key_kind", "key_kind", torch.int32),
    ("node_dom_small", "node_dom_small", torch.int32),
    ("scr", "scr", torch.float32),
    ("dscr", "dscr", torch.float32),
    ("iscr", "iscr", torch.int32),
    ("assign", "assign", torch.int32),
    ("vg_idx", "vg_idx", torch.int32),
    ("dev_idx", "dev_idx", torch.int32),
    ("gpu_idx", "gpu_idx", torch.int32),
    ("lvm_mat", "lvm_mat", torch.float32),
    ("gpu_mat", "gpu_mat", torch.float32),
)
#: rows of RoundBuffers.scr / .dscr (rounds.cuh SCR_ROWS / DSCR_ROWS)
ROUND_SCR_ROWS = 8
ROUND_DSCR_ROWS = 6


class RoundCtx(ctypes.Structure):
    """ctypes mirror of `struct RoundCtx` in csrc/rounds.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _ROUND_INT_FIELDS] + [
        (f, ctypes.c_void_p) for f, _, _ in _ROUND_PTR_FIELDS
    ]


def _round_pointers(rb) -> dict:
    """RoundCtx's pointer fields for a RoundBuffers (engine/rounds.py):
    every tensor's device, dtype, contiguity and shape checked."""
    buf = rb.buf
    tensors = {
        field: _checked(f"rb.{attr}", getattr(rb, attr), rb.device, dtype)
        for field, attr, dtype in _ROUND_PTR_FIELDS
    }
    st = buf.statics
    n = st.alloc.shape[0]
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], buf.state.gpu_free.shape[1]
    rows, k_cap = rb.assign.shape
    d = rb.n_domains
    k_n = st.node_dom.shape[0]
    _check_shapes(tensors, {
        **{f: (n,) for f in ("cap", "s0", "slope", "m_n", "m_all")},
        **{f: (n, v) for f in ("ord_vg", "cs_vg", "cum_vg")},
        **{f: (n, sd) for f in ("ord_dev", "cs_dev", "cum_dev")},
        **{f: (n, gd) for f in ("ord_gpu", "cs_gpu", "cum_gpu", "c_gpu", "cum_gidx")},
        "dom_sums": (max(st.g_terms.shape[1], 1), d), "key_kind": (k_n,), "node_dom_small": (k_n, n),
        "scr": (ROUND_SCR_ROWS, n), "dscr": (ROUND_DSCR_ROWS, d + 1), "iscr": (2 * n + d + 2,),
        **{f: (rows, k_cap) for f in ("assign", "vg_idx", "dev_idx", "gpu_idx")},
        "lvm_mat": (rows, k_cap, v), "gpu_mat": (rows, k_cap, gd),
    })
    return {f: t.data_ptr() for f, t in tensors.items()}


def launch_round(name: str, rb, i: int, k: int, mode: int, row: int) -> None:
    """Launch round kernel `name` (K14-K16) for the round of pod i of the
    batch, run length k, variant `mode` (engine/rounds.py V_*), output row
    `row`, on the current CUDA stream; raises if the launch is refused. No
    synchronization."""
    buf = rb.buf
    if not 0 <= i < buf.n_pods:
        raise IndexError(f"pod {i} outside the batch of {buf.n_pods}")
    if not 0 <= row < rb.assign.shape[0]:
        raise IndexError(f"output row {row} outside {rb.assign.shape[0]} rows")
    libs = build()
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    if rb.ctx is None:
        rb.ctx = _round_pointers(rb)
    ctx = RoundCtx(i=i, k=k, mode=mode, row=row, n_dom=rb.n_domains, k_cap=rb.assign.shape[1], **rb.ctx)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = getattr(libs[name], f"simtpu_{name}")(ctypes.byref(buf.ctx), ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


class CopyCtx(ctypes.Structure):
    """ctypes mirror of `struct CopyCtx` in csrc/carry_copy.cu."""

    _fields_ = [("n_seg", ctypes.c_int), ("pad_", ctypes.c_int), ("segs", ctypes.c_void_p)]


def launch_carry_copy(planes) -> list:
    """K17 over `planes` (the fields of a SchedState or CompactState on one
    CUDA device, in order): fresh tensors of the same shapes and dtypes,
    filled in one launch on the current stream. Raises if a plane is not a
    contiguous tensor on that device or the launch is refused."""
    device = planes[0].device
    out = []
    segs = []
    for j, t in enumerate(planes):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"plane {j}: need a contiguous tensor on {device}, got {t.device}")
        dst = torch.empty_like(t)
        out.append(dst)
        nbytes = t.numel() * t.element_size()
        if nbytes:
            segs.append((t.data_ptr(), dst.data_ptr(), nbytes))
    libs = build()
    table = torch.as_tensor(np.asarray(segs, np.int64).reshape(-1, 3), device=device)
    ctx = CopyCtx(n_seg=len(segs), pad_=0, segs=table.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["carry_copy"].simtpu_carry_copy(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel carry_copy failed to launch: {msg} ({err})")
    LAUNCHES["carry_copy"] += 1
    # the table's storage is released to the caching allocator only after
    # the copy is enqueued; the stream orders any reuse after the kernel
    del table
    return out


class SweepCtx(ctypes.Structure):
    """ctypes mirror of `struct SweepCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in ("s", "cols", "t", "ti")] + [
        (f, ctypes.c_void_p) for f in ("idx",) + DENSE_FIELDS
    ]


def _replica_dims(base, reps, s: int) -> tuple:
    """(T, Ti) of a replicated state `reps` ([S, ...] planes) whose replica
    shapes must equal `base`'s (a SchedState, or None to skip that check)."""
    for f, r in zip(DENSE_FIELDS, reps):
        if r.shape[0] != s or not r.is_contiguous():
            raise ValueError(f"replicas.{f}: need a contiguous [{s}, ...] tensor, got {tuple(r.shape)}")
    if base is not None:
        for f, b, r in zip(DENSE_FIELDS, base, reps):
            if tuple(r.shape[1:]) != tuple(b.shape):
                raise ValueError(f"replicas.{f}: replica shape {tuple(r.shape[1:])} != base {tuple(b.shape)}")
    return reps[2].shape[1], reps[3].shape[1]


def launch_sweep_drain(statics, base, reps, log: dict, idx: torch.Tensor) -> None:
    """K18 on the current stream, in one launch of idx.shape[0] blocks:
    replica s of `reps` (a SchedState of [S, ...] planes, written here)
    becomes `base` (a SchedState, read only) with the placement-log entries
    of row s of `idx` ([S, E] int32, -1 = trailing padding) applied in
    order; `log` maps g, node, wgt, req, vg, sd_take, gp to the packed
    whole log on the device. Raises if an input is malformed or the launch
    is refused."""
    libs = build()
    device = base.free.device
    s, cols = idx.shape
    _checked("idx", idx, device, torch.int32)
    t, ti = _replica_dims(base, reps, s)
    rep0 = type(base)(*(r[0] for r in reps))
    ctx = make_delta_ctx(statics, rep0, log)
    planes = {f: _checked(f"base.{f}", b, device, b.dtype).data_ptr() for f, b in zip(DENSE_FIELDS, base)}
    sw = SweepCtx(s=s, cols=cols, t=t, ti=ti, idx=idx.data_ptr(), **planes)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["sweep_drain"].simtpu_sweep_drain(ctypes.byref(ctx), ctypes.byref(sw), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel sweep_drain failed to launch: {msg} ({err})")
    LAUNCHES["sweep_drain"] += 1


def launch_sweep_place(sb) -> None:
    """K19 on the current stream, in one launch of one block per scenario
    of `sb` (an engine/batched.py SweepBuffers): block s places the batch
    rows of row s of `sb.rows` on replica s of `sb.reps` under row s of
    `sb.valid_s`, writing output row j for pod list entry j. Raises if an
    input is malformed or the launch is refused."""
    libs = build()
    s, cols = sb.rows.shape
    _checked("rows", sb.rows, sb.device, torch.int32)
    t, ti = _replica_dims(None, sb.reps, s)
    if sb.ctx is None:
        sb.ctx = make_ctx(sb, out_rows=cols)
    sw = SweepCtx(s=s, cols=cols, t=t, ti=ti, idx=sb.rows.data_ptr())
    stream = torch.cuda.current_stream(sb.device).cuda_stream
    err = libs["sweep_place"].simtpu_sweep_place(ctypes.byref(sb.ctx), ctypes.byref(sw), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel sweep_place failed to launch: {msg} ({err})")
    LAUNCHES["sweep_place"] += 1


class ExplainCtx(ctypes.Structure):
    """ctypes mirror of `struct ExplainCtx` in csrc/explain_pass.cu."""

    _fields_ = [("p", ctypes.c_int), ("k", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("counts", "feasible", "witnesses", "fail_code")
    ]


def launch_explain_pass(eb) -> None:
    """K20 on the current stream, in one launch of one block per pod of
    `eb` (an explain/breakdown.py ExplainBuffers): block p explains pod p
    of the chunk against the shared state, in its own scratch, and writes
    row p of the counts, feasible, witnesses and fail codes. Raises if an
    input is malformed or the launch is refused."""
    libs = build()
    buf = eb.buf
    p, n = buf.n_pods, buf.statics.alloc.shape[0]
    v, sd, gd = buf.statics.vg_cap.shape[1], buf.statics.sdev_cap.shape[1], buf.state.gpu_free.shape[1]
    outs = {f: _checked(f"eb.{f}", getattr(eb, f), eb.device, torch.int32)
            for f in ("counts", "feasible", "witnesses", "fail_code")}
    planes = {f: _checked(f"eb.{f}", getattr(eb, f), eb.device, getattr(eb, f).dtype)
              for f in ("stage_s", "raw_s", "st_ok_s", "st_alloc_s", "st_take_s", "st_raw_s",
                        "gpu_ok_s", "gpu_sh_s")}
    s_n = eb.counts.shape[1]
    _check_shapes({**outs, **planes}, {
        "counts": (p, s_n), "feasible": (p,), "witnesses": (p, s_n, eb.k), "fail_code": (p,),
        "stage_s": (p, n), "raw_s": (p, 4, n), "st_ok_s": (p, n), "st_alloc_s": (p, n, v),
        "st_take_s": (p, n, sd), "st_raw_s": (p, n), "gpu_ok_s": (p, n), "gpu_sh_s": (p, n, gd),
    })
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    ctx = ExplainCtx(p=p, k=eb.k, **{f: t.data_ptr() for f, t in outs.items()})
    stream = torch.cuda.current_stream(eb.device).cuda_stream
    err = libs["explain_pass"].simtpu_explain_pass(ctypes.byref(buf.ctx), ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel explain_pass failed to launch: {msg} ({err})")
    LAUNCHES["explain_pass"] += 1


def launch_pod_terms(buf, i: int) -> None:
    """K21 for pod i of `buf` (an explain/scores.py TermsBuffers, after K1
    -> (K5) -> (K6) -> K2 for the pod) on the current stream: the score
    into `buf.score`, the 12 raw term rows into `buf.terms`. Raises if an
    input is malformed or the launch is refused. No synchronization."""
    if not 0 <= i < buf.n_pods:
        raise IndexError(f"pod {i} outside the batch of {buf.n_pods}")
    libs = build()
    terms = _checked("buf.terms", buf.terms, buf.device, torch.float32)
    _check_shapes({"terms": terms}, {"terms": (12, buf.statics.alloc.shape[0])})
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = libs["pod_terms"].simtpu_pod_terms(ctypes.byref(buf.ctx), i, terms.data_ptr(), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel pod_terms failed to launch: {msg} ({err})")
    LAUNCHES["pod_terms"] += 1


class RelaxCtx(ctypes.Structure):
    """ctypes mirror of `struct RelaxCtx` in csrc/relax.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in ("s", "c", "n", "r", "mode", "np2")] + [
        ("lr", ctypes.c_float), ("pad_", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("feas", "req", "cnt", "fixed", "cap", "valid", "y", "over",
                                       "residual", "stuck")
    ]


#: widest node row K23 sorts in one block (csrc/relax.cuh RELAX_MAX_ROW):
#: the keys and their f64 prefix sums of the next power of two >= N fill
#: 12 bytes each of the block's shared memory (227 KB)
RELAX_MAX_ROW = 16384


def relax_ctx(rb) -> RelaxCtx:
    """K22/K23's argument block for a solve/relax.py RelaxBuffers on one
    CUDA device: every tensor's device, dtype, contiguity and shape
    checked. Raises ValueError for a node row wider than RELAX_MAX_ROW."""
    device = rb.y.device
    s, c, n = rb.y.shape
    r = rb.req.shape[1]
    if n > RELAX_MAX_ROW:
        raise ValueError(f"relax_project sorts a node row in one block: N={n} exceeds {RELAX_MAX_ROW}")
    fields = {"feas": torch.bool, "req": torch.float32, "cnt": torch.float32, "fixed": torch.float32,
              "cap": torch.float32, "valid": torch.bool, "y": torch.float32, "over": torch.float32,
              "residual": torch.float32, "stuck": torch.int32}
    tensors = {f: _checked(f"relax.{f}", getattr(rb, f), device, dt) for f, dt in fields.items()}
    _check_shapes(tensors, {"feas": (c, n), "req": (c, r), "cnt": (c,), "fixed": (n, r), "cap": (n, r),
                            "valid": (s, n), "over": (s, n, r), "residual": (s,), "stuck": (s,)})
    np2 = max(32, 1 << max(n - 1, 0).bit_length())
    return RelaxCtx(s=s, c=c, n=n, r=r, mode=0, np2=np2, lr=float(rb.lr), pad_=0,
                    **{f: t.data_ptr() for f, t in tensors.items()})


def _launch_relax(name: str, rb, mode: int) -> None:
    libs = build()
    ctx = rb.cache.get("ctx")
    if ctx is None:
        ctx = rb.cache["ctx"] = relax_ctx(rb)
    ctx.mode = mode
    stream = torch.cuda.current_stream(rb.y.device).cuda_stream
    err = getattr(libs[name], f"simtpu_{name}")(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


def launch_relax_load(rb, residual: bool = False) -> None:
    """K22 on the current stream, one launch over every (candidate, node)
    of `rb` (a solve/relax.py RelaxBuffers): rb.over from rb.y, and in
    residual mode rb.residual. No synchronization."""
    _launch_relax("relax_load", rb, 1 if residual else 0)


def launch_relax_project(rb, init: bool = False) -> None:
    """K23 on the current stream, one launch of one block per (class,
    candidate) row of `rb`: the projected-gradient step of rb.y in place,
    or in init mode its start point and rb.stuck. No synchronization."""
    _launch_relax("relax_project", rb, 1 if init else 0)


class GrowTermsCtx(ctypes.Structure):
    """ctypes mirror of `struct GrowTermsCtx` in csrc/grow_terms.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("n", "t_old", "t_cap", "ti_old", "ti_cap", "pad_")] + [
        ("cm", ctypes.c_void_p), ("ct", ctypes.c_void_p), ("own", ctypes.c_void_p * 4),
        ("inv", ctypes.c_void_p), ("rows", ctypes.c_void_p), ("tot", ctypes.c_void_p),
        ("perm", ctypes.c_void_p), ("out_cm", ctypes.c_void_p), ("out_ct", ctypes.c_void_p),
        ("out_own", ctypes.c_void_p * 4),
    ]


_OWN_PLANES = ("cnt_own_anti", "cnt_own_aff", "w_own_aff_pref", "w_own_anti_pref")


def launch_grow_terms(state, g) -> dict:
    """K24 on the current stream, in one launch: the six term planes of
    `state` (a SchedState on one CUDA device) written into fresh bucketed
    planes from `g` (an engine/state.py GrowTerms). Returns {plane name:
    fresh tensor}. Raises if an input is malformed or the launch is
    refused."""
    device = state.free.device
    n = state.free.shape[0]
    t_old, ti_old = state.cnt_match.shape[0], state.cnt_own_anti.shape[0]
    planes = {f: _checked(f"state.{f}", getattr(state, f), device, torch.float32)
              for f in ("cnt_match", "cnt_total") + _OWN_PLANES}
    ins = {f: _checked(f"grow.{f}", getattr(g, f), device, dt)
           for f, dt in (("inv", torch.int32), ("rows", torch.float32), ("tot", torch.float32),
                         ("perm", torch.int32))}
    m = ins["rows"].shape[0]
    _check_shapes({**planes, **ins}, {
        "cnt_match": (t_old, n), "cnt_total": (t_old,), **{f: (ti_old, n) for f in _OWN_PLANES},
        "inv": (g.t_cap,), "rows": (m, n), "tot": (m,), "perm": (g.ti_cap,)})
    if g.t_cap < t_old:
        raise ValueError(f"grow_terms: bucket {g.t_cap} below the carried {t_old} term rows")
    out = {"cnt_match": torch.empty((g.t_cap, n), dtype=torch.float32, device=device),
           "cnt_total": torch.empty(g.t_cap, dtype=torch.float32, device=device),
           **{f: torch.empty((g.ti_cap, n), dtype=torch.float32, device=device) for f in _OWN_PLANES}}
    ctx = GrowTermsCtx(
        n=n, t_old=t_old, t_cap=g.t_cap, ti_old=ti_old, ti_cap=g.ti_cap, pad_=0,
        cm=planes["cnt_match"].data_ptr(), ct=planes["cnt_total"].data_ptr(),
        own=(ctypes.c_void_p * 4)(*(planes[f].data_ptr() for f in _OWN_PLANES)),
        inv=ins["inv"].data_ptr(), rows=ins["rows"].data_ptr(), tot=ins["tot"].data_ptr(),
        perm=ins["perm"].data_ptr(), out_cm=out["cnt_match"].data_ptr(),
        out_ct=out["cnt_total"].data_ptr(),
        out_own=(ctypes.c_void_p * 4)(*(out[f].data_ptr() for f in _OWN_PLANES)))
    libs = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["grow_terms"].simtpu_grow_terms(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel grow_terms failed to launch: {msg} ({err})")
    LAUNCHES["grow_terms"] += 1
    return out


class GrowNodesCtx(ctypes.Structure):
    """ctypes mirror of `struct GrowNodesCtx` in csrc/grow_nodes.cu."""

    _fields_ = [("n_planes", ctypes.c_int), ("pad_", ctypes.c_int), ("planes", ctypes.c_void_p)]


def launch_grow_nodes(state, add: dict, a: int) -> dict:
    """K25 on the current stream, in one launch: every plane of `state` (a
    SchedState on one CUDA device) but cnt_total widened from N to N + a
    nodes in fresh storage — [N, X] planes along their rows, the [T, N]
    count planes along their columns — with the new nodes' part from `add`
    ({plane name: tensor, or None = zeros}). Returns {plane name: fresh
    tensor}. Raises if an input is malformed or the launch is refused."""
    from ..engine.state import NODE_GROWTH

    device = state.free.device
    n = state.free.shape[0]
    out, table, keep = {}, [], []
    for name, kind in NODE_GROWTH:
        plane = _checked(f"state.{name}", getattr(state, name), device, getattr(state, name).dtype)
        extra = add[name]
        if plane.element_size() not in (1, 4):
            raise ValueError(f"grow_nodes: {name} has {plane.element_size()}-byte elements")
        if kind == "cols":
            want = (plane.shape[0], a)
            dst = torch.empty((plane.shape[0], n + a), dtype=plane.dtype, device=device)
        else:
            want = (a, plane.shape[1])
            dst = torch.empty((n + a, plane.shape[1]), dtype=plane.dtype, device=device)
        if kind == "cols" and plane.shape[1] != n or kind != "cols" and plane.shape[0] != n:
            raise ValueError(f"grow_nodes: {name} shape {tuple(plane.shape)} is not on the {n}-node axis")
        if extra is not None:
            _checked(f"grow.{name}", extra, device, plane.dtype)
            _check_shapes({name: extra}, {name: want})
            keep.append(extra)
        rows, cols = plane.shape
        table.append((plane.data_ptr(), 0 if extra is None else extra.data_ptr(), dst.data_ptr(),
                      rows | (cols << 32), (a if kind != "cols" else 0) | ((a if kind == "cols" else 0) << 32),
                      plane.element_size()))
        out[name] = dst
    libs = build()
    packed = torch.as_tensor(np.asarray(table, np.int64).reshape(-1, 6), device=device)
    ctx = GrowNodesCtx(n_planes=len(table), pad_=0, planes=packed.data_ptr())
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["grow_nodes"].simtpu_grow_nodes(ctypes.byref(ctx), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel grow_nodes failed to launch: {msg} ({err})")
    LAUNCHES["grow_nodes"] += 1
    # the table's and the new parts' storage return to the caching
    # allocator only after the launch is enqueued; the stream orders reuse
    del packed, keep
    return out
