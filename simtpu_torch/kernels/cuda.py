"""Build, bind and launch the hand-written CUDA kernels.

K1-K6 make up the per-pod scheduling step (`engine/scan.py`), K7 applies
signed placement-log deltas (`engine/state.py`), K8 is the placement
auditor's bulk pass (`kernels/audit.py`), K9/K10 place a whole same-group
run of pods in one launch (`engine/wavefront.py`). The sources live in
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
)
#: the per-pod kernels, launched as simtpu_<name>(StepCtx*, pod, stream)
STEP_KERNELS = KERNELS[:6]
#: the wave kernels, launched as simtpu_<name>(StepCtx*, WaveCtx*, stream)
WAVE_KERNELS = KERNELS[8:]
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
        elif name in WAVE_KERNELS:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
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


def make_ctx(buf) -> StepCtx:
    """The kernels' argument block for a StepBuffers: checks every tensor's
    device, dtype, contiguity and shape, then takes its address. The
    buffers keep the tensors alive as long as the block is in use."""
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
    _check_shapes(tensors, {
        "req": (pods, r), "free": (n, r), "ports_used": (n, p), "vols_any": (n, w),
        "vols_rw": (n, w), "attach_limits": (n, c), "stage": (n,), "raw": (4, n),
        "lvm_size": (pods, l), "lvm_vg": (pods, l), "dev_size": (pods, k), "dev_media": (pods, k),
        "gpu_preset": (pods, gd), "vg_name_id": (n, v), "vg_free": (n, v), "sdev_free": (n, sd),
        "sdev_media": (n, sd), "gpu_dev_exists": (n, gd), "gpu_free": (n, gd),
        "st_alloc": (n, v), "st_take": (n, sd), "gpu_sh": (n, gd),
        "out_lvm": (pods, v), "out_take": (pods, sd), "out_gpu": (pods, gd),
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
