"""Build, bind and launch the hand-written CUDA kernels.

K1-K6 make up the per-pod scheduling step (`engine/scan.py`), K7 applies
signed placement-log deltas (`engine/state.py`), K8 is the placement
auditor's bulk pass (`kernels/audit.py`), K9/K10 place a whole same-group
run of pods in one launch (`engine/wavefront.py`), K11-K13 compress,
expand and update the compact carried state (`engine/state.py`), K14-K16
score, pick and commit one bulk round (`engine/rounds.py`), K17 copies a
carried state for the incremental planner's probes
(`plan/incremental.py`), K18/K19 drain and requeue every scenario of a
batched sweep chunk (`engine/batched.py`), K20
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
#: (K1 as simtpu_filter_pod(StepCtx*, pod, group, pin, FilterPlan*,
#: stream), K2 as simtpu_topology_pod(StepCtx*, group, TopoPlan*, stream),
#: K3 as simtpu_score_argmax_pod(StepCtx*, pod, ScorePlan*, stream), K4 as
#: simtpu_commit_pod(StepCtx*, pod, group, stream), K5 as
#: simtpu_storage_pod(StepCtx*, pod, StoragePlan*, stream), K6 as
#: simtpu_gpu_pod(StepCtx*, pod, GpuPlan*, stream): the pod's group and
#: pin, and its GPU request, from the host)
STEP_KERNELS = KERNELS[:6]
STEP_PLANNED = ("topology_pod", "score_argmax_pod", "storage_pod", "gpu_pod")
#: the wave kernels, launched as simtpu_<name>(StepCtx*, WaveCtx*, stream)
WAVE_KERNELS = KERNELS[8:10]
#: the round kernels, launched as simtpu_<name>(StepCtx*, RoundCtx*, stream)
#: (K15) or simtpu_<name>(StepCtx*, RoundCtx*, RoundPlan*, stream) (K14,
#: K16: one thread-block cluster each)
ROUND_KERNELS = KERNELS[13:16]
CLUSTER_KERNELS = ("round_score", "round_commit")
#: kernels whose launch plan the wrapper passes as a third argument block:
#: simtpu_<name>(StepCtx*, WaveCtx* or ExplainCtx*, plan*, stream)
PLANNED_KERNELS = ("wave_hard", "explain_pass")
#: the sweep kernels, launched as simtpu_<name>(DeltaCtx* or StepCtx*,
#: SweepCtx*, stream)
SWEEP_KERNELS = KERNELS[17:19]
#: the signed log-delta kernels, launched as simtpu_<name>(DeltaCtx* or
#: CompactCtx*, DeltaPlan*, stream) (K7, K13)
DELTA_KERNELS = ("delta_apply", "compact_delta")
#: the explain pass, launched as simtpu_explain_pass(StepCtx*, ExplainCtx*,
#: stream); the score terms as simtpu_pod_terms(StepCtx*, pod, terms, stream)
EXPLAIN_KERNELS = KERNELS[19:21]
#: the wave kernels' carried [N] rows past what registers hold
#: (step_ctx.cuh WAVE_ROWS)
WAVE_ROWS = 15
#: the profile build's phase-cycle slots of a wave launch (WAVE_PROF_SLOTS)
WAVE_PROF_SLOTS = 10
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
        if name in STEP_PLANNED:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "filter_pod":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p]
        elif name == "commit_pod":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        elif name in STEP_KERNELS:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        elif name in CLUSTER_KERNELS or name in PLANNED_KERNELS:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        elif (name in WAVE_KERNELS or name in ROUND_KERNELS or name in SWEEP_KERNELS or name in DELTA_KERNELS
              or name == "compact_compress"):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "pod_terms":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "audit_bulk":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        else:
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    occupancy = _LIBS["relax_project"].simtpu_relax_project_rows_per_sm
    occupancy.argtypes = [ctypes.c_void_p]
    occupancy.restype = ctypes.c_int
    first = _LIBS[KERNELS[0]]
    first.simtpu_noop.argtypes = [ctypes.c_void_p]
    first.simtpu_noop.restype = ctypes.c_int
    first.simtpu_error_string.argtypes = [ctypes.c_int]
    first.simtpu_error_string.restype = ctypes.c_char_p
    return _LIBS


#: the profile build: the same sources with per-phase clock64() stamps
#: compiled in (csrc/wave.cuh's SIMTPU_WAVE_PROFILE for K9/K10,
#: csrc/round_pick.cu's SIMTPU_PICK_PROFILE for K15, csrc/rounds.cuh's
#: SIMTPU_ROUND_PROFILE for K14/K16), in libraries of their own that the
#: main path never loads
PROFILE_FLAGS = ("-DSIMTPU_WAVE_PROFILE", "-DSIMTPU_PICK_PROFILE", "-DSIMTPU_ROUND_PROFILE")
PROFILE_KERNELS = WAVE_KERNELS + ROUND_KERNELS
_PROFILE_LIBS: dict = {}


def build_profile() -> dict:
    """Compile the profile build of K9, K10 and K14-K16 (in parallel) and
    load it. Returns {name: ctypes.CDLL}; wave_lean's library also exports
    simtpu_wave_barrier_cycles, each round kernel's simtpu_<name>_prof."""
    if _PROFILE_LIBS:
        return _PROFILE_LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PROFILE_KERNELS:
        out = _lib_path(name).with_name(_lib_path(name).stem + "-profile.so")
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *PROFILE_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
        _PROFILE_LIBS[name] = out
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[f"{name}-profile"] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the profile build of {name}:\n{log}")
        os.replace(tmp, _PROFILE_LIBS[name])
    for name in PROFILE_KERNELS:
        lib = ctypes.CDLL(str(_PROFILE_LIBS[name]))
        fn = getattr(lib, f"simtpu_{name}")
        fn.argtypes = [ctypes.c_void_p] * (4 if name in CLUSTER_KERNELS or name in PLANNED_KERNELS else 3)
        fn.restype = ctypes.c_int
        _PROFILE_LIBS[name] = lib
    bar = _PROFILE_LIBS["wave_lean"].simtpu_wave_barrier_cycles
    bar.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    bar.restype = ctypes.c_int
    for name in ROUND_KERNELS:
        prof = getattr(_PROFILE_LIBS[name], f"simtpu_{name}_prof")
        prof.argtypes = [ctypes.c_void_p]
        prof.restype = ctypes.c_int
    return _PROFILE_LIBS


def launch_wave_profile(name: str, buf, a: int, b: int, mode) -> None:
    """Launch the profile build of wave kernel `name` for the run [a, b)
    of `buf`, its phase cycles added into `buf.wave_prof` (zero it first).
    A measurement launch: not counted in LAUNCHES. No synchronization."""
    err = _launch_wave_with(build_profile(), name, buf, a, b, mode)
    if err:
        msg = build()[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} (profile build) failed to launch: {msg} ({err})")


def barrier_cycles(threads: int, iters: int = 4096) -> float:
    """Cycles of one block-wide barrier (__syncthreads) in a block of
    `threads` threads, the mean over `iters` back-to-back barriers, on the
    current CUDA device (the profile build's micro-kernel)."""
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = build_profile()["wave_lean"].simtpu_wave_barrier_cycles(
        threads, iters, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA barrier micro-kernel failed to launch ({err})")
    return float(out.item()) / iters


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
    ("g_cols", "buf", "g_cols", torch.int32),
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
    ("st_fr", "buf", "st_fr", torch.float32),
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


#: the words of a term column in the table K2 and K4 stage
#: (csrc/step_ctx.cuh TOPO_COL_WORDS, COL_*), and its flag bits (TOPO_*)
TOPO_COL_WORDS = 8
TOPO_FLAG_BITS = (("s_match", 1), ("a_aff_req", 2), ("a_anti_req", 4), ("ss_host", 8), ("ss_zone", 16))


def column_table(statics) -> torch.Tensor:
    """The term columns' table of csrc/step_ctx.cuh (StepCtx g_cols):
    [G, TOPO_COL_WORDS, Tc] int32, for group g and column t the term
    g_terms[g, t] (-1 = pad), its key row term_topo[term] and interpod row
    ip_of[term] (-1 for a pad), the flag bits of s_match, a_aff_req,
    a_anti_req, ss_host and ss_zone, and the bits of w_aff_pref,
    w_anti_pref, spread_hard and spread_soft."""
    terms = statics.g_terms
    live = terms >= 0
    safe = terms.clamp(min=0).long()

    def of_term(row):
        if not row.numel():
            return torch.full_like(terms, -1)
        return torch.where(live, row[safe], torch.full_like(terms, -1))

    flags = torch.zeros_like(terms)
    for name, bit in TOPO_FLAG_BITS:
        flags |= getattr(statics, name).to(torch.int32) * bit
    bits = [getattr(statics, f).contiguous().view(torch.int32)
            for f in ("w_aff_pref", "w_anti_pref", "spread_hard", "spread_soft")]
    return torch.stack([terms, of_term(statics.term_topo), of_term(statics.ip_of), flags, *bits], dim=1).contiguous()


def make_ctx(buf, out_rows: int = None) -> StepCtx:
    """The kernels' argument block for a StepBuffers: checks every tensor's
    device, dtype, contiguity and shape, then takes its address; builds the
    term columns' table (`column_table`, kept as `buf.g_cols`) first. The
    buffers keep the tensors alive as long as the block is in use.
    `out_rows` is the per-pod outputs' row count when it is not the
    batch's (the sweep's output rows follow its pod lists)."""
    if getattr(buf, "g_cols", None) is None:
        buf.g_cols = column_table(buf.statics)
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
    pods = buf.n_pods
    rows = pods if out_rows is None else out_rows
    _check_shapes(tensors, {
        "req": (pods, r), "free": (n, r), "ports_used": (n, p), "vols_any": (n, w),
        "vols_rw": (n, w), "attach_limits": (n, c), "stage": (n,), "raw": (4, n),
        "lvm_size": (pods, l), "lvm_vg": (pods, l), "dev_size": (pods, k), "dev_media": (pods, k),
        "gpu_preset": (pods, gd), "vg_name_id": (n, v), "vg_free": (n, v), "sdev_free": (n, sd),
        "sdev_media": (n, sd), "gpu_dev_exists": (n, gd), "gpu_free": (n, gd),
        "st_alloc": (n, v), "st_fr": (n, v), "st_take": (n, sd), "gpu_sh": (n, gd),
        "out_lvm": (rows, v), "out_take": (rows, sd), "out_gpu": (rows, gd),
        **{f: (g, n) for f in ("static_mask", "vol_mask", "node_pref", "taint_intol",
                                "static_score", "avoid_pen")},
        **{f: (g, tc) for f in ("s_match", "a_aff_req", "a_anti_req", "w_aff_pref",
                                 "w_anti_pref", "spread_hard", "spread_soft", "ss_host", "ss_zone")},
        "g_cols": (g, TOPO_COL_WORDS, tc),
    })
    return StepCtx(
        n=n, r=r, p_ports=p, w=w, c=c, tc=tc, flags=buf.flag_bits, v=v, sd=sd, gd=gd, l=l, k=k,
        **{f: t.data_ptr() for f, t in tensors.items()},
    )


#: K1's launch plan (csrc/filter_pod.cu): threads a block (the measured
#: sweep, PERF.md), the entries of a node's row held in registers at most
#: (FILTER_REG; also the attach classes of the one-pass count), the shared
#: bytes the group's staged rows may take, and the StepCtx flag bits of the
#: stages that read the group's rows (ports, volumes, attach)
FILTER_THREADS = 128
FILTER_MAX_THREADS = 512
FILTER_REG = 8
FILTER_SMEM = 48 * 1024
F_PORTS, F_VOLS, F_ATTACH = 1, 2, 4


class FilterPlan(ctypes.Structure):
    """ctypes mirror of `struct FilterPlan` in csrc/filter_pod.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "regs", "staged", "smem")]


def filter_smem_bytes(p: int, w: int, c: int, regs: bool) -> int:
    """K1's staged group rows (csrc/filter_pod.cu filter_smem_bytes): ports
    [P], rw, ro, att [W], then a class-bits byte a volume (the register
    template) or the class mask [C, W]."""
    return p + 3 * w + (w if regs else c * w)


def filter_plan(n: int, r: int, p: int, w: int, c: int, flags: int, threads: int = None) -> dict:
    """K1's launch plan for N nodes, R resources, P ports, W volumes, C
    attach classes and the StepCtx flag bits: blocks of `threads` threads
    (FILTER_THREADS, fewer for a small N; at most FILTER_MAX_THREADS), one
    node a thread; the register template ("registers") where every live
    row (free; ports under F_PORTS; the volume rows under F_VOLS /
    F_ATTACH; the limits and classes under F_ATTACH) has at most FILTER_REG
    entries, else the rows read in place ("global"); the group's rows
    staged in shared memory where a stage that reads them is live and they
    take at most FILTER_SMEM bytes, else read in place."""
    n1 = max(n, 1)
    live_p = p if flags & F_PORTS else 0
    live_w = w if flags & (F_VOLS | F_ATTACH) else 0
    live_c = c if flags & F_ATTACH else 0
    regs = max(r, live_p, live_w, live_c) <= FILTER_REG
    smem = filter_smem_bytes(p, w, c, regs)
    staged = bool(flags & (F_PORTS | F_VOLS | F_ATTACH)) and smem <= FILTER_SMEM
    t = min(int(threads or FILTER_THREADS), FILTER_MAX_THREADS, max(-(-n1 // 32) * 32, 32))
    return {"blocks": -(-n1 // t), "threads": t, "regs": int(regs), "staged": int(staged),
            "smem": smem if staged else 0, "template": "registers" if regs else "global",
            "group_rows": "shared" if staged else "in place"}


def filter_plan_struct(buf, threads: int = None) -> FilterPlan:
    """K1's plan for `buf` (of `threads` threads where given); the default
    plan is built once per buffer and kept (`buf.filter_plan`)."""
    if threads is None and buf.filter_plan is not None:
        return buf.filter_plan
    x = buf.ctx
    plan = filter_plan(x.n, x.r, x.p_ports, x.w, x.c, x.flags, threads)
    struct = FilterPlan(**{f: plan[f] for f, _ in FilterPlan._fields_})
    if threads is None:
        buf.filter_plan = struct
    return struct


#: K5's launch plan (csrc/storage_pod.cu): threads a block (the measured
#: sweep, PERF.md), the register template (VGs and devices a node holds in
#: registers, also its code), the codes of the shared and global
#: templates, and the bytes of claims a block stages at most
STORAGE_THREADS = 128
STORAGE_MAX_THREADS = 256
STORAGE_REG = 4
STORAGE_SHARED = 1
STORAGE_GLOBAL = 0
STORAGE_CLAIMS_SMEM = 16 * 1024


class StoragePlan(ctypes.Structure):
    """ctypes mirror of `struct StoragePlan` in csrc/storage_pod.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "tmpl", "staged", "smem", "off_rows")]


def storage_plan(n: int, v: int, sd: int, l: int, k: int, threads: int = None, template: int = None) -> dict:
    """K5's launch plan for N nodes, V VGs, SD devices, L LVM and K device
    claims: blocks of `threads` threads (STORAGE_THREADS, fewer for a small
    N; at most STORAGE_MAX_THREADS), one node a thread; the pod's 8 (L + K)
    claim bytes staged in shared memory while they take at most
    STORAGE_CLAIMS_SMEM; the template `template` where given, else the
    register template ("registers") where max(V, SD) <= STORAGE_REG, past
    it the plan's running rows in shared memory ("shared", 8 V + SD bytes
    a thread after the claims) while they fit in WAVE_SMEM, else in the
    StepCtx scratch rows ("global")."""
    n1 = max(n, 1)
    t = min(int(threads or STORAGE_THREADS), STORAGE_MAX_THREADS, max(-(-n1 // 32) * 32, 32))
    claims = 8 * (l + k)
    staged = claims <= STORAGE_CLAIMS_SMEM
    off_rows = ((claims + 15) & ~15) if staged else 0
    rows = t * (8 * v + sd)
    width = max(v, sd)
    if template is None:
        template = (STORAGE_REG if width <= STORAGE_REG else
                    STORAGE_SHARED if off_rows + rows <= WAVE_SMEM else STORAGE_GLOBAL)
    smem = (off_rows + rows) if template == STORAGE_SHARED else (claims if staged else 0)
    name = {STORAGE_REG: "registers", STORAGE_SHARED: "shared"}.get(template, "global")
    return {"blocks": -(-n1 // t), "threads": t, "tmpl": int(template), "staged": int(staged), "smem": smem,
            "off_rows": off_rows, "template": name}


def storage_plan_struct(buf, threads: int = None, template: int = None) -> StoragePlan:
    """K5's plan for `buf` (of `threads` threads and template `template`
    where given); the default plan is built once per buffer and kept
    (`buf.storage_plan`)."""
    default = threads is None and template is None
    if default and buf.storage_plan is not None:
        return buf.storage_plan
    x = buf.ctx
    plan = storage_plan(x.n, x.v, x.sd, x.l, x.k, threads, template)
    struct = StoragePlan(**{f: plan[f] for f, _ in StoragePlan._fields_})
    if default:
        buf.storage_plan = struct
    return struct


#: K6's launch plan (csrc/gpu_pod.cu): threads a block (the measured sweep,
#: PERF.md), the register templates' widths (devices a node holds in
#: registers), and the bytes of the preset row a block stages at most past
#: them
GPU_THREADS = 64
GPU_MAX_THREADS = 512
GPU_REG_WIDTHS = (1, 2, 4, 8)
GPU_REG = GPU_REG_WIDTHS[-1]
GPU_PRESET_SMEM = 16 * 1024


class GpuRequest(ctypes.Structure):
    """ctypes mirror of `struct GpuRequest` in csrc/gpu_pod.cu."""

    _fields_ = [("mem", ctypes.c_float), ("count", ctypes.c_int), ("preset_set", ctypes.c_int)]


class GpuPlan(ctypes.Structure):
    """ctypes mirror of `struct GpuPlan` in csrc/gpu_pod.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "reg", "staged", "smem")] + [
        ("reqs", ctypes.c_void_p)]


def gpu_plan(n: int, gd: int, threads: int = None, template: str = None) -> dict:
    """K6's launch plan for N nodes of GD devices: blocks of `threads`
    threads (GPU_THREADS, fewer for a small N; at most GPU_MAX_THREADS), one
    node a thread; the template `template` where given ("registers" or
    "global"), else the register template of the narrowest width in
    GPU_REG_WIDTHS that holds GD ("registers", `reg` that width; the preset
    row in static shared memory), past GPU_REG the rows read in place
    ("global"; the pod's preset row, 4 GD bytes, staged in dynamic shared
    memory while it takes at most GPU_PRESET_SMEM bytes)."""
    n1 = max(n, 1)
    t = min(int(threads or GPU_THREADS), GPU_MAX_THREADS, max(-(-n1 // 32) * 32, 32))
    if template is None:
        template = "registers" if gd <= GPU_REG else "global"
    reg = next(w for w in GPU_REG_WIDTHS if w >= gd) if template == "registers" else 0
    staged = bool(reg) or 4 * gd <= GPU_PRESET_SMEM
    return {"blocks": -(-n1 // t), "threads": t, "reg": reg, "staged": int(staged),
            "smem": 0 if reg or not staged else 4 * gd, "template": template}


def gpu_requests(buf):
    """The batch's GPU requests as K6's entry reads them (`buf.gpu_host`
    in a host array of GpuRequest), built once per buffer and kept
    (`buf.gpu_reqs`)."""
    if buf.gpu_reqs is None:
        buf.gpu_reqs = (GpuRequest * max(len(buf.gpu_host), 1))(*(GpuRequest(*r) for r in buf.gpu_host))
    return buf.gpu_reqs


def gpu_plan_struct(buf, threads: int = None, template: str = None) -> GpuPlan:
    """K6's plan for `buf` (of `threads` threads and template `template`
    where given), pointing at its requests (`gpu_requests`); the default
    plan is built once per buffer and kept (`buf.gpu_plan`, its address
    `buf.gpu_plan_ptr`, which the launch passes)."""
    default = threads is None and template is None
    if default and buf.gpu_plan is not None:
        return buf.gpu_plan
    plan = gpu_plan(buf.ctx.n, buf.ctx.gd, threads, template)
    struct = GpuPlan(reqs=ctypes.addressof(gpu_requests(buf)),
                     **{f: plan[f] for f, _ in GpuPlan._fields_ if f != "reqs"})
    if default:
        buf.gpu_plan, buf.gpu_plan_ptr = struct, ctypes.addressof(struct)
    return struct


#: K3's launch plan (csrc/score_argmax_pod.cu): threads a block at most,
#: and the nodes a thread keeps in registers (one; past SCORE_BLOCK nodes
#: the inputs are read again in pass 2: 2 and 4 nodes a thread in
#: registers measured no faster than that on the card)
SCORE_BLOCK = 1024
SCORE_REG_NPT = 1


class ScorePlan(ctypes.Structure):
    """ctypes mirror of `struct ScorePlan` in csrc/score_argmax_pod.cu."""

    _fields_ = [("threads", ctypes.c_int), ("npt", ctypes.c_int)]


def score_plan(n: int) -> dict:
    """K3's launch plan for N nodes: one block of `threads` threads, node n
    on thread n % threads; up to SCORE_BLOCK nodes each thread keeps its
    node's inputs in registers between its two passes (npt 1), and past
    that reads its `nodes_per_thread` nodes' inputs again in pass 2 (npt 0,
    "global")."""
    threads = min(max(-(-n // 32) * 32, 32), SCORE_BLOCK)
    npt = SCORE_REG_NPT if n <= SCORE_BLOCK else 0
    return {"threads": threads, "npt": npt, "nodes_per_thread": npt or -(-n // threads),
            "template": "registers" if npt else "global"}


#: K2's launch plan (csrc/topology_pod.cu): up to TOPO_THREADS nodes a
#: plain launch (one node a thread; TOPO_SMALL_NODES nodes a block, each
#: block taking the hard-spread minima over every node itself), past that
#: a thread-block cluster of at most TOPO_CLUSTER_MAX blocks (above 8 the
#: non-portable size), one node tile a block, TOPO_NODES_PER_BLOCK nodes a
#: block where the cluster allows (the measured sweeps, PERF.md); the staged
#: columns take TOPO_REC_WORDS words a column
TOPO_THREADS = 1024
TOPO_CLUSTER_MAX = 16
TOPO_SMALL_NODES = 256
TOPO_NODES_PER_BLOCK = 256
TOPO_REC_WORDS = 8


class TopoPlan(ctypes.Structure):
    """ctypes mirror of `struct TopoPlan` in csrc/topology_pod.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "tile", "npt", "cluster", "off_cols", "off_bmin",
                                            "off_mins", "smem", "slab_stride")] + [("slab", ctypes.c_void_p)]


def topology_plan(n: int, tc: int = 0, blocks: int = None, budget: int = None, cluster: bool = None) -> dict:
    """K2's launch plan for a pod over N nodes and Tc term columns, with
    `blocks` blocks, a shared `budget` and a `cluster` launch where given
    (the sweeps; the slab path at any Tc): else up to TOPO_THREADS nodes a
    plain launch of blocks of TOPO_SMALL_NODES nodes, each taking the
    hard-spread minima over every node itself, and past that a cluster of
    the fewest blocks (at most TOPO_CLUSTER_MAX) that give each
    TOPO_NODES_PER_BLOCK nodes or fewer, the blocks trading their minima.
    Block b owns the nodes [b * tile, min(N, (b + 1) * tile)) (the tile a
    multiple of 32, the last one ragged, none empty); under npt 1 thread t
    owns node tile start + t, under npt 0 (a tile past TOPO_THREADS nodes)
    the nodes tile start + t + j * threads. A block's scratch — the staged
    columns (TOPO_REC_WORDS words a column), its minima (one word a column,
    which its cluster peers read) and its warps' minima (32 words a column)
    — takes shared memory while it fits in WAVE_SMEM (or `budget`) and past
    it a slab of global scratch, `slab_bytes` a block (`mode` "global")."""
    n1 = max(n, 1)
    if cluster is None:
        cluster = n1 > TOPO_THREADS
    per = TOPO_NODES_PER_BLOCK if cluster else TOPO_SMALL_NODES
    b = int(blocks) if blocks else -(-n1 // per)
    b = max(b, 1)
    if cluster:
        b = min(b, TOPO_CLUSTER_MAX)
    tile = -(-(-(-n1 // b)) // 32) * 32
    b = -(-n1 // tile)
    cluster = bool(cluster and b > 1)
    npt = 1 if tile <= TOPO_THREADS else 0
    plan = _SmemPlan(WAVE_SMEM if budget is None else budget)
    offs = {"off_cols": plan.add(TOPO_REC_WORDS * tc * 4, True), "off_bmin": plan.add(tc * 4, True),
            "off_mins": plan.add(32 * tc * 4, True)}
    return {"blocks": b, "tile": tile, "threads": tile if npt else TOPO_THREADS, "npt": npt,
            "nodes_per_thread": 1 if npt else -(-tile // TOPO_THREADS), "template": "1" if npt else "global",
            "cluster": int(cluster), "launch": "cluster" if cluster else "plain", **offs,
            "shared_bytes": plan.used, "slab_bytes": (plan.slab + 15) & ~15, "mode": "global" if plan.slab else "shared"}


def topology_plan_struct(buf, blocks: int = None, budget: int = None, cluster: bool = None) -> TopoPlan:
    """K2's plan for `buf` (`topology_plan`'s, of `blocks` blocks, a shared
    `budget` and a `cluster` launch where given), its slab allocated (one
    per block) where the plan needs one; the default plan is built once per
    buffer and kept (`buf.topo_plan`), the slab with it."""
    default = blocks is None and budget is None and cluster is None
    if default and buf.topo_plan is not None:
        return buf.topo_plan[0]
    plan = topology_plan(buf.ctx.n, buf.ctx.tc, blocks, budget, cluster)
    slab = None
    if plan["slab_bytes"]:
        slab = torch.empty(plan["blocks"] * plan["slab_bytes"], dtype=torch.uint8, device=buf.device)
    struct = TopoPlan(smem=plan["shared_bytes"], slab_stride=plan["slab_bytes"],
                      slab=slab.data_ptr() if slab is not None else 0,
                      **{f: plan[f] for f in ("blocks", "threads", "tile", "npt", "cluster", "off_cols", "off_bmin",
                                              "off_mins")})
    if default:
        buf.topo_plan = (struct, slab)
    else:
        buf.topo_sweep = (struct, slab)  # alive until the next swept plan
    return struct


def launch(name: str, buf, i: int) -> None:
    """Launch kernel `name` for pod i of `buf` on the current CUDA stream
    (K1 on `filter_plan`, K2 on `topology_plan`, K3 on `score_plan`, K5 on
    `storage_plan`, K6 on `gpu_plan`; K1, K2 and K4 take the pod's group
    from `buf.group_host`, K1 its pin from `buf.pin_host`, K6 its GPU
    request from `buf.gpu_host`); raises if the launch is refused. No
    synchronization."""
    if not 0 <= i < buf.n_pods:
        raise IndexError(f"pod {i} outside the batch of {buf.n_pods}")
    libs = build()
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    # the current stream's handle on the buffers' device, as
    # torch.cuda.current_stream(device).cuda_stream gives it but without
    # building a Stream object, which took about 6 of a launch's 16 µs on
    # the host (PERF.md)
    stream = torch._C._cuda_getCurrentRawStream(buf.device.index)
    fn = getattr(libs[name], f"simtpu_{name}")
    if name == "filter_pod":
        plan = buf.filter_plan or filter_plan_struct(buf)
        err = fn(ctypes.byref(buf.ctx), i, buf.group_host[i], buf.pin_host[i], ctypes.byref(plan), stream)
    elif name == "storage_pod":
        plan = buf.storage_plan or storage_plan_struct(buf)
        err = fn(ctypes.byref(buf.ctx), i, ctypes.byref(plan), stream)
    elif name == "gpu_pod":
        if buf.gpu_plan is None:
            gpu_plan_struct(buf)
        err = fn(ctypes.byref(buf.ctx), i, buf.gpu_plan_ptr, stream)
    elif name == "topology_pod":
        plan = buf.topo_plan[0] if buf.topo_plan is not None else topology_plan_struct(buf)
        err = fn(ctypes.byref(buf.ctx), buf.group_host[i], ctypes.byref(plan), stream)
    elif name == "commit_pod":
        err = fn(ctypes.byref(buf.ctx), i, buf.group_host[i], stream)
    elif name == "score_argmax_pod":
        plan = score_plan(buf.ctx.n)
        err = fn(ctypes.byref(buf.ctx), i, ctypes.byref(ScorePlan(threads=plan["threads"], npt=plan["npt"])), stream)
    else:
        err = fn(ctypes.byref(buf.ctx), i, stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


_WAVE_INT_FIELDS = ("a", "b", "mode", "k")
# (field, attribute of the StepBuffers, dtype) in step_ctx.cuh WaveCtx order
_WAVE_PTR_FIELDS = (
    ("carry", "wave_rows", torch.float32),
    ("prof", "wave_prof", torch.int64),
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
    _check_shapes(tensors, {"carry": (WAVE_ROWS, n), "prof": (WAVE_PROF_SLOTS,)})
    k, n_dom = buf.statics.node_dom.shape
    if n_dom != n:
        raise ValueError(f"node_dom: shape {(k, n_dom)}, want {(k, n)}")
    bits = (WAVE_PREF if pref else 0) | int(heavy) << WAVE_HEAVY_SHIFT
    return WaveCtx(a=a, b=b, mode=bits, k=k, **{f: t.data_ptr() for f, t in tensors.items()})


#: the dynamic shared memory the plans of the one-thread-per-node kernels
#: and of K16 take at most (csrc/wave.cuh WAVE_SMEM; of the 227 KB a block
#: may take, less the static reduction slots)
WAVE_SMEM = 200 * 1024


class _SmemPlan:
    """csrc/wave.cuh's shared-memory plan: segments in priority order, each
    16-byte aligned where it still fits in WAVE_SMEM. A staged copy of
    state rows that does not fit is read in place (offset -1); a scratch
    segment that does not fit goes to the block's slab of global scratch,
    its offset encoded as -1 - its byte offset in the slab (wave.cuh
    wave_seg)."""

    def __init__(self, budget: int = WAVE_SMEM):
        self.used = 0
        self.slab = 0
        self.budget = budget

    def add(self, nbytes: int, scratch: bool = False) -> int:
        at = (self.used + 15) & ~15
        if at + nbytes <= self.budget:
            self.used = at + nbytes
            return at
        if not scratch:
            return -1
        at = (self.slab + 15) & ~15
        self.slab = at + nbytes
        return -1 - at


class HardPlan(ctypes.Structure):
    """ctypes mirror of `struct HardPlan` in csrc/wave_hard.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("kmax", "off_cols", "off_mins", "off_keys", "off_flags", "off_dom",
                                            "off_cm", "off_free", "off_req", "off_own", "smem")] + [
        ("slab", ctypes.c_void_p)]


def wave_hard_plan(n: int, r: int, tc: int, kmax: int, pods: int) -> dict:
    """K10's launch plan for a run of `pods` pods over N nodes, R resources,
    Tc term columns and `kmax` key slots: one block of `threads` threads,
    `nodes_per_thread` nodes each (the register template `template`,
    "global" where the carried rows live in WaveCtx.carry), and its
    segments in wave.cuh's priority order. The block's own scratch — the
    staged columns (8 words a column), the key slots, the pod flags, the
    per-warp minima (64 words a column) — takes shared memory while it
    fits and past it the slab (`slab_bytes` of global scratch; `mode`
    "global"); then the staged copies of the key slots' node_dom rows, the
    count rows, the free rows, the run's request rows and the own planes,
    each where it still fits, else read in place (-1)."""
    plan = _SmemPlan()
    offs = {
        "off_cols": plan.add(8 * tc * 4, True),
        "off_keys": plan.add(kmax * 4, True),
        "off_flags": plan.add(pods * 4, True),
        "off_mins": plan.add(64 * tc * 4, True),
        "off_dom": plan.add(kmax * n * 4),
        "off_cm": plan.add(tc * n * 4),
        "off_free": plan.add(r * n * 4),
        "off_req": plan.add(pods * r * 4),
        "off_own": plan.add(4 * tc * n * 4),
    }
    threads, npt = wave_threads(n), wave_npt(n)
    return {"threads": threads, "npt": npt, "nodes_per_thread": npt or -(-n // threads),
            "template": str(npt) if npt else "global", "kmax": kmax, **offs, "shared_bytes": plan.used,
            "slab_bytes": plan.slab, "mode": "global" if plan.slab else "shared"}


def _hard_plan_struct(buf, ctx: WaveCtx) -> HardPlan:
    """K10's plan for the run of `ctx` on `buf`, its slab (buf.wave_slab)
    grown where the plan needs more than it holds."""
    n, r, tc = buf.ctx.n, buf.ctx.r, buf.ctx.tc
    plan = wave_hard_plan(n, r, tc, max(1, min(tc, ctx.k)), ctx.b - ctx.a)
    slab = 0
    if plan["slab_bytes"]:
        if buf.wave_slab is None or buf.wave_slab.numel() < plan["slab_bytes"]:
            buf.wave_slab = torch.empty(plan["slab_bytes"], dtype=torch.uint8, device=buf.device)
        slab = buf.wave_slab.data_ptr()
    return HardPlan(smem=plan["shared_bytes"], slab=slab,
                    **{f: plan[f] for f, _ in HardPlan._fields_ if f not in ("smem", "slab")})


def _launch_wave_with(libs, name: str, buf, a: int, b: int, mode) -> int:
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    ctx = make_wave_ctx(buf, a, b, mode)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    fn = getattr(libs[name], f"simtpu_{name}")
    if name == "wave_hard":
        return fn(ctypes.byref(buf.ctx), ctypes.byref(ctx), ctypes.byref(_hard_plan_struct(buf, ctx)), stream)
    return fn(ctypes.byref(buf.ctx), ctypes.byref(ctx), stream)


def launch_wave(name: str, buf, a: int, b: int, mode) -> None:
    """Launch wave kernel `name` for the run [a, b) of `buf` on the current
    CUDA stream (K10 on `wave_hard_plan`); raises if the launch is refused.
    No synchronization."""
    libs = build()
    err = _launch_wave_with(libs, name, buf, a, b, mode)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


_DELTA_INT_FIELDS = ("n", "r", "p_ports", "w", "v", "sd", "gd", "tc", "e", "ti", "pref", "pad_")
# (field, owner, dtype) in step_ctx.cuh DeltaCtx order, after its ints and
# `work`; K7 fills every owner, K18 leaves "pairs" and "seen" null
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
    ("dom_start", "domains", torch.int32),
    ("dom_nodes", "domains", torch.int32),
    ("pair_start", "pairs", torch.int64),
    ("pair_hint", "pairs", torch.int32),
    ("pref_seen", "seen", torch.int32),
)
_DELTA_STATICS = tuple(f for f, owner, _ in _DELTA_PTR_FIELDS if owner == "statics")
_STATE_FIELDS = tuple(f for f, owner, _ in _DELTA_PTR_FIELDS if owner == "state")


class DeltaCtx(ctypes.Structure):
    """ctypes mirror of `struct DeltaCtx` in csrc/step_ctx.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in _DELTA_INT_FIELDS] + [("work", ctypes.c_longlong)] + [
        (f, ctypes.c_void_p) for f, _, _ in _DELTA_PTR_FIELDS
    ]


#: the setups (`_delta_setup`) kept on one g_terms tensor at most: statics
#: that share it and differ in a field DeltaCtx reads (other weights, another
#: node_dom); the oldest goes first
DELTA_SETUPS = 4


def _delta_setup(statics, state) -> dict:
    """What a DeltaCtx takes from the statics, per statics and state shape:
    the statics' tensors it reads, checked once; a template block with the
    dims, their pointers and the domain node lists of their node_dom
    (`domain_nodes`); the state planes' dtypes and shapes; and the host
    maps K7's pair sizes read (`pair_starts`: each slot's key row's offset
    in node_dom flattened with a row of -1 below, padding's group row G
    after the groups', the domains' sizes with a 0 after). Kept on the
    statics' g_terms tensor, keyed by the ids of the tensors it reads (a
    statics that differs only in another field, such as node_valid, shares
    its entry), the planes' shapes and the device; at most DELTA_SETUPS
    entries there."""
    device = state.free.device
    reads = tuple(getattr(statics, f) for f in _DELTA_STATICS)
    key = (tuple(map(id, reads)), tuple(tuple(t.shape) for t in state), str(device))
    cache = getattr(statics.g_terms, "_delta_setup", None)
    if cache is None:
        cache = statics.g_terms._delta_setup = {}
    if key in cache:
        return cache[key]
    tensors = {f: _checked(f"statics.{f}", t, device, dtype)
               for (f, _, dtype), t in zip((x for x in _DELTA_PTR_FIELDS if x[1] == "statics"), reads)}
    n = state.free.shape[0]
    _check_shapes(tensors, {"node_dom": (statics.node_dom.shape[0], n)})
    dom_start, dom_nodes = domain_nodes(statics.node_dom)
    k = statics.node_dom.shape[0]
    # each slot's key row's offset in node_dom flattened with a row of -1
    # below (an empty slot's, and a padding entry's: its group row G)
    topo = np.append(statics.term_topo.cpu().numpy().astype(np.int64), -1)
    rows = topo[statics.g_terms.cpu().numpy()]
    rows = np.vstack([np.where(rows >= 0, rows, k), np.full((1, rows.shape[1]), k)]) * n
    template = DeltaCtx(
        n=n, r=state.free.shape[1], p_ports=state.ports_used.shape[1], w=state.vols_any.shape[1],
        v=state.vg_free.shape[1], sd=state.sdev_free.shape[1], gd=state.gpu_free.shape[1],
        tc=statics.g_terms.shape[1], ti=state.cnt_own_anti.shape[0], pref=-1,
        dom_start=dom_start.data_ptr(), dom_nodes=dom_nodes.data_ptr(),
        **{f: t.data_ptr() for f, t in tensors.items()})
    shapes = dict(zip(state._fields, (t.shape for t in state)))
    setup = {"reads": reads, "template": template,
             "state": {f: (dtype, shapes[f]) for f, owner, dtype in _DELTA_PTR_FIELDS if owner == "state"},
             "rows": rows.astype(np.int32) if (k + 1) * n < 2 ** 31 else rows,
             "ndom": np.append(statics.node_dom.cpu().numpy().ravel(), np.full(n, -1, np.int32)),
             "sizes": np.append(np.diff(dom_start.cpu().numpy()), np.int32(0))}
    while len(cache) >= DELTA_SETUPS:
        cache.pop(next(iter(cache)))
    cache[key] = setup
    return setup


def _delta_block(statics, state) -> tuple:
    """A DeltaCtx for `state` (K7's carry, K18's replica): `_delta_setup`'s
    template with the state's planes, checked every call. Returns (block,
    setup); the caller sets the entries and `e`."""
    setup = _delta_setup(statics, state)
    ctx = DeltaCtx.from_buffer_copy(setup["template"])
    device = state.free.device
    for f, (dtype, shape) in setup["state"].items():
        t = getattr(state, f)
        if t.device != device or t.dtype != dtype or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"state.{f}: need a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        setattr(ctx, f, t.data_ptr())
    return ctx, setup


def _check_entry_widths(ctx: DeltaCtx, shapes: list) -> int:
    """E, where `shapes` are the entries' arrays' shapes in ENTRY_FIELDS
    order: E rows each, of the block's widths."""
    e = shapes[0][0] if shapes[0] else 0
    widths = (ctx.r, ctx.v, ctx.sd, ctx.gd)
    if list(shapes) != [(e,), (e,), (e,)] + [(e, k) for k in widths]:
        raise ValueError(f"entries: shapes {list(shapes)}, want E = {e} rows of widths {widths}")
    return e


def make_delta_ctx(statics, state, entries: dict) -> DeltaCtx:
    """K18's argument block (its single-scenario DeltaCtx): `_delta_block`'s
    with `entries` mapping ENTRY_FIELDS' names to device tensors (which the
    caller keeps alive until the launch is enqueued; the stream orders any
    reuse of their memory after it); K7's pair starts and hints and
    pref_seen stay null, its preference mode -1."""
    ctx, _ = _delta_block(statics, state)
    device = state.free.device
    tensors = [_checked(f"entries.{f}", entries[f], device, dtype) for f, dtype in ENTRY_FIELDS]
    ctx.e = _check_entry_widths(ctx, [tuple(t.shape) for t in tensors])
    for (f, _), t in zip(ENTRY_FIELDS, tensors):
        setattr(ctx, f, t.data_ptr())
    return ctx


#: 2^24: f32 holds every integer up to it exactly
F32_EXACT = 1 << 24


def pref_weights(statics) -> tuple:
    """(any nonzero, integer-valued, largest |weight|) over the statics'
    two preference weight planes w_aff_pref / w_anti_pref; computed once
    per pair of planes and kept on the w_aff_pref tensor beside the
    w_anti_pref it was computed with."""
    cached = getattr(statics.w_aff_pref, "_pref_weights", None)
    if cached is not None and cached[0] is statics.w_anti_pref:
        return cached[1]
    w = np.concatenate([statics.w_aff_pref.cpu().numpy().ravel(), statics.w_anti_pref.cpu().numpy().ravel()])
    out = (bool((w != 0).any()), bool(np.all(np.isfinite(w) & (w == np.trunc(w)))),
           float(np.abs(w).max(initial=0.0)))
    statics.w_aff_pref._pref_weights = (statics.w_anti_pref, out)
    return out


def pref_mode(statics, e: int) -> int:
    """K7's preference-plane mode for E entries (DeltaCtx.pref): -1 where
    the statics hold no preference weight (the planes take only +-0), 0
    for the adds in log order (a weight that is not an integer, or E times
    the largest |weight| past 2^24), else the bound 2^24 - E x the largest
    |weight| under which every touched value must lie for atomic adds to
    be exact."""
    nonzero, integer, most = pref_weights(statics)
    if not nonzero:
        return -1
    if not integer:
        return 0
    return max(int(F32_EXACT - e * most), 0)


def pair_starts(setup: dict, g: np.ndarray, node: np.ndarray, w: np.ndarray) -> np.ndarray:
    """K7's pair threads: int64 [E Tc + 1], the running sum over the (entry,
    slot) pairs, entry-major, of each pair's nodes, the size of the chosen
    node's domain under the slot's key (node < 0 reads node 0); 0 for
    padding, an empty slot or a node without the key. Pair i's threads are
    start[i] .. start[i + 1] - 1, the k-th adding at the k-th node of the
    domain. `setup` is `_delta_setup`'s."""
    rows = setup["rows"]
    at = rows.take(np.where(w != 0, g, rows.shape[0] - 1), axis=0)
    at += np.maximum(node, 0).astype(at.dtype)[:, None]
    size = setup["sizes"].take(setup["ndom"].take(at))
    start = np.zeros(size.size + 1, np.int64)
    np.cumsum(size.ravel(), dtype=np.int64, out=start[1:])
    return start


#: K7's pair threads a search hint covers (`pair_hints`; delta_apply.cu)
DELTA_PAIR_CHUNK = 256


def pair_hints(start: np.ndarray) -> np.ndarray:
    """int32 [ceil(work / DELTA_PAIR_CHUNK) + 1] for `pair_starts`' running
    sum `start`: the pair of every DELTA_PAIR_CHUNK-th pair thread, then
    the last pair. Pair thread j's pair lies between hint[c] and
    hint[c + 1] (c = j / DELTA_PAIR_CHUNK), so that its binary search
    starts from a few pairs rather than all E Tc."""
    work = int(start[-1])
    hint = np.empty(-(-work // DELTA_PAIR_CHUNK) + 1, np.int32)
    hint[:-1] = np.searchsorted(start, np.arange(0, work, DELTA_PAIR_CHUNK), side="right") - 1
    hint[-1] = len(start) - 2
    return hint


def launch_delta(statics, state, packed) -> None:
    """K7 over the packed entries (`engine/state.py pack_delta_entries`,
    each w in {-1, 0, +1}) on `compact_delta_plan`, in one call (its two
    kernels) on the current CUDA stream; raises if the weights are not
    signs or the launch is refused."""
    libs = build()
    device = state.free.device
    ctx, plan, _ = delta_apply_call(statics, state, packed)
    err = libs["delta_apply"].simtpu_delta_apply(ctypes.byref(ctx), ctypes.byref(plan),
                                                 torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel delta_apply failed to launch: {msg} ({err})")
    LAUNCHES["delta_apply"] += 1


def delta_apply_call(statics, state, packed):
    """K7's argument block and plan for folding the packed entries into the
    dense `state`: `_delta_block`'s (the statics checked once), the
    entries, their pair starts and hints (`pair_starts`, `pair_hints`) and
    a zeroed pref_seen word uploaded in one copy (`_upload`), the
    preference mode (`pref_mode`).
    Returns (block, plan, the upload), which the caller keeps alive until
    the launch is enqueued."""
    device = state.free.device
    arrays = [np.ascontiguousarray(a, dtype=dt) for a, dt in zip(packed, _ENTRY_NP)]
    g, node, w = arrays[:3]
    if np.count_nonzero((w != 0) & (w != 1) & (w != -1)):
        raise ValueError("K7 takes entries of weight -1, 0 or +1 (pack_delta_entries)")
    ctx, setup = _delta_block(statics, state)
    e = _check_entry_widths(ctx, [a.shape for a in arrays])
    start = pair_starts(setup, g, node, w)
    offsets, dev = _upload(arrays + [start, pair_hints(start), np.zeros(1, np.int32)], device)
    base = dev.data_ptr()
    for (f, _), at in zip(ENTRY_FIELDS, offsets):
        setattr(ctx, f, base + at)
    ctx.pair_start, ctx.pair_hint, ctx.pref_seen = (base + at for at in offsets[-3:])
    ctx.e, ctx.work, ctx.pref = e, int(start[-1]), pref_mode(statics, e)
    return ctx, delta_plan_struct(ctx, device), dev


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
    ("dom_start", "domains", "dom_start", torch.int32),
    ("dom_nodes", "domains", "dom_nodes", torch.int32),
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


#: K11's grid (csrc/compact_compress.cu): threads a block, the task kinds
COMPRESS_THREADS = 256
CT_GATHER, CT_DENSE, CT_CAST, CT_BYTES = range(4)
#: CompactState's narrowed planes (int32 but the bool sdev_free), in order
NARROW_FIELDS = ("cm_tab", "cm_dense", "cnt_total", "oa_tab", "oa_dense", "of_tab", "of_dense", "wa_tab",
                 "wa_dense", "wn_tab", "wn_dense", "sdev_free", "ports_used", "vols_any", "vols_rw")
#: the CompactCtx field each narrowed plane fills
_NARROW_CTX = {"cnt_total": "c_cnt_total", "sdev_free": "c_sdev_free", "ports_used": "c_ports_used",
               "vols_any": "c_vols_any", "vols_rw": "c_vols_rw"}


class CompressPlan(ctypes.Structure):
    """ctypes mirror of `struct CompressPlan` in csrc/compact_compress.cu."""

    _fields_ = [("n_tasks", ctypes.c_int), ("tiles", ctypes.c_int), ("tasks", ctypes.c_void_p),
                ("gather", ctypes.c_void_p)]


def compress_plan(spec: dict, n: int, t: int, p: int, w: int, sd: int) -> dict:
    """K11's row-task table for a carry of N nodes, T terms and P / W / SD
    wide under `spec` (CompactSpecDev's fields as numpy). `gather`: each
    tabular element's source offset in its dense plane (row ids_tab[r] x N
    + rep[r, d], -1 where the domain has no node), cnt_match's [Rt, D]
    then the own planes' [Rti, D] (the four share their rows). `tasks`: one
    per output row or chunk, as (kind * 8 + plane, source offset,
    destination offset, length) in elements: CT_GATHER a chunk of a
    tabular plane (its source offset into `gather`), CT_DENSE a dense row
    (row ids_dense[r] cast), CT_CAST a chunk of cnt_total / ports_used /
    vols_any / vols_rw (plane 0-3) cast, CT_BYTES a chunk of sdev_free.
    `tiles` blocks of COMPRESS_THREADS along a row give every thread of a
    row of N elements at most one 16-byte vector; a chunk holds that many
    elements (casts and gathers) or bytes x 4 (sdev_free)."""
    d = spec["t_rep"].shape[1]
    tiles = max(-(-max(n, 1) // (4 * COMPRESS_THREADS)), 1)
    chunk = 4 * COMPRESS_THREADS * tiles

    def offsets(ids, rep):
        return np.where(rep >= 0, ids.astype(np.int64)[:, None] * n + rep, -1).reshape(-1)

    gather = np.concatenate([offsets(spec["t_tab"], spec["t_rep"]), offsets(spec["ip_tab"], spec["ip_rep"])])
    if gather.size and gather.max() >= 1 << 31:
        raise ValueError(f"K11 indexes its planes in 32 bits: {gather.max()} elements")
    ip_at = spec["t_tab"].shape[0] * d

    def chunks(kind, q, size, at=0, step=chunk):
        return [(kind * 8 + q, at + k, k, min(step, size - k)) for k in range(0, size, step)]

    tasks = []
    for q in range(5):
        ids_tab, ids_dense = (spec["t_tab"], spec["t_dense"]) if q == 0 else (spec["ip_tab"], spec["ip_dense"])
        tasks += chunks(CT_GATHER, q, len(ids_tab) * d, 0 if q == 0 else ip_at)
        tasks += [(CT_DENSE * 8 + q, int(i) * n, r * n, n) for r, i in enumerate(ids_dense)]
    for q, size in enumerate((t, n * p, n * w, n * w)):
        tasks += chunks(CT_CAST, q, size)
    tasks += chunks(CT_BYTES, 0, n * sd, step=4 * chunk)
    return {"tasks": np.asarray(tasks, np.int32).reshape(-1, 4), "tiles": tiles,
            "gather": np.ascontiguousarray(gather, np.int32)}


def _narrow_layout(dims: dict) -> tuple:
    """The narrowed planes in one buffer: ((field, byte offset, shape,
    dtype), ...) in NARROW_FIELDS order, each at a 16-byte aligned offset,
    and the buffer's bytes."""
    n, d = dims["n"], dims["d"]
    shapes = {"cm_tab": (dims["rt"], d), "cm_dense": (dims["rd"], n), "cnt_total": (dims["t"],),
              **{f"{q}_tab": (dims["rti"], d) for q in ("oa", "of", "wa", "wn")},
              **{f"{q}_dense": (dims["rdi"], n) for q in ("oa", "of", "wa", "wn")},
              "sdev_free": (n, dims["sd"]), "ports_used": (n, dims["p"]), "vols_any": (n, dims["w"]),
              "vols_rw": (n, dims["w"])}
    out, at = [], 0
    for f in NARROW_FIELDS:
        dtype = torch.bool if f == "sdev_free" else torch.int32
        out.append((f, at, shapes[f], dtype))
        at += (int(np.prod(shapes[f])) * (1 if dtype == torch.bool else 4) + 15) & ~15
    return tuple(out), at


def _compress_setup(spec, state) -> dict:
    """What K11 keeps per CompactSpecDev and shape, on the spec's t_tab
    tensor, keyed by the spec's tensors and the shape: the spec's tensors
    checked once, the argument block with the dims and the spec's pointers
    (a template each call copies), the dense planes' shapes, the narrowed
    planes' layout, and the task and gather tables (`compress_plan`) on
    the device."""
    n = state.free.shape[0]
    d = spec.t_rep.shape[1]
    widths = (state.free.shape[1], state.ports_used.shape[1], state.vols_any.shape[1],
              state.vg_free.shape[1], state.sdev_free.shape[1], state.gpu_free.shape[1])
    key = (tuple(id(t) for t in spec), n, state.cnt_match.shape[0], state.cnt_own_anti.shape[0], widths)
    cache = getattr(spec.t_tab, "_compress", None)
    if cache is None:
        cache = spec.t_tab._compress = {}
    if key in cache:
        return cache[key]
    device = state.free.device
    dims = _compact_dims(spec, n, d, key[2], key[3], widths)
    template = make_compact_ctx(device, {"spec": spec._asdict()}, dims, _spec_shapes(spec, d))
    plan = compress_plan({f: t.cpu().numpy() for f, t in spec._asdict().items()}, n, dims["t"], dims["p"],
                         dims["w"], dims["sd"])
    tasks = torch.as_tensor(plan["tasks"], device=device)
    gather = torch.as_tensor(plan["gather"], device=device)
    layout, nbytes = _narrow_layout(dims)
    shapes = _dense_shapes(dims)
    dense = {f: (torch.bool if f == "sdev_free" else torch.float32, shapes[f]) for f in DENSE_FIELDS}
    # the entry keeps the spec's tensors alive, so the ids in its key stay theirs
    cache[key] = {"spec": spec, "template": template, "dense": dense, "layout": layout, "nbytes": nbytes,
                  "tasks": tasks, "gather": gather,
                  "plan": CompressPlan(n_tasks=len(plan["tasks"]), tiles=plan["tiles"], tasks=tasks.data_ptr(),
                                       gather=gather.data_ptr())}
    return cache[key]


def compress_ctx(spec, state):
    """K11's argument block and plan for the dense `state` (an
    engine/state.py SchedState) under `spec` (a CompactSpecDev on the same
    device), and CompactState's fields: the narrowed planes views of one
    buffer allocated here for the kernel to write (16-byte aligned, in
    NARROW_FIELDS order), free / vg_free / gpu_free the dense tensors
    themselves. The spec's tensors are checked once per spec and shape
    (`_compress_setup`), the state's planes every call."""
    device = state.free.device
    setup = _compress_setup(spec, state)
    ctx = CompactCtx.from_buffer_copy(setup["template"])
    for f, t in zip(DENSE_FIELDS, state):
        dtype, shape = setup["dense"][f]
        if t.device != device or t.dtype != dtype or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"dense.{f}: need a contiguous {dtype} tensor of shape {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")
        setattr(ctx, f, t.data_ptr())
    buf = torch.empty(max(setup["nbytes"] // 4, 1), dtype=torch.int32, device=device)
    flags = buf.view(torch.bool)
    base = buf.data_ptr()
    out = {"free": state.free, "vg_free": state.vg_free, "gpu_free": state.gpu_free}
    for f, at, shape, dtype in setup["layout"]:
        setattr(ctx, _NARROW_CTX.get(f, f), base + at)
        if dtype == torch.bool:
            out[f] = flags.as_strided(shape, (shape[1], 1), at)
        else:
            out[f] = buf.as_strided(shape, (shape[1], 1) if len(shape) == 2 else (1,), at // 4)
    ctx.c_free, ctx.c_vg_free, ctx.c_gpu_free = (t.data_ptr() for t in (state.free, state.vg_free, state.gpu_free))
    return ctx, setup["plan"], out


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


#: the packed entries' fields (engine/state.py pack_delta_entries), in order
ENTRY_FIELDS = (("g", torch.int32), ("node", torch.int32), ("wgt", torch.float32), ("req", torch.float32),
                ("vg", torch.float32), ("sd_take", torch.bool), ("gp", torch.float32))


#: ENTRY_FIELDS' numpy dtypes
_ENTRY_NP = tuple(torch.empty(0, dtype=dt).numpy().dtype for _, dt in ENTRY_FIELDS)


def _upload(arrays: list, device) -> tuple:
    """The numpy `arrays` on `device` in one copy: each one's bytes at a
    16-byte aligned offset of one byte buffer. Returns (offsets, buffer)."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += (a.nbytes + 15) & ~15
    host = np.zeros(max(total, 16), np.uint8)
    for a, at in zip(arrays, offsets):
        host[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
    return offsets, torch.from_numpy(host).to(device)


def upload_entries(packed, device) -> dict:
    """The packed entries on `device` in one copy (`_upload`), each viewed
    back as its field."""
    arrays = [np.ascontiguousarray(a, dtype=dt) for a, dt in zip(packed, _ENTRY_NP)]
    offsets, dev = _upload(arrays, device)
    return {name: dev[at:at + a.nbytes].view(dt).view(a.shape)
            for (name, dt), a, at in zip(ENTRY_FIELDS, arrays, offsets)}


def domain_nodes(ndom: torch.Tensor) -> tuple:
    """The nodes of each domain of the node_dom map `ndom` [K, N] (-1 where
    a node misses the key; a domain id names one key's value): (dom_start
    [D + 1], dom_nodes) int32 on its device, domain d's nodes ascending at
    dom_nodes[dom_start[d]:dom_start[d + 1]]. Built once per map and kept
    on it."""
    cached = getattr(ndom, "_domain_nodes", None)
    if cached is not None:
        return cached
    n = ndom.shape[1]
    flat = ndom.reshape(-1).cpu().numpy()
    live = np.flatnonzero(flat >= 0)
    doms = flat[live]
    nodes = (live % max(n, 1))[np.argsort(doms, kind="stable")].astype(np.int32)
    start = np.zeros(int(doms.max(initial=-1)) + 2, np.int32)
    np.cumsum(np.bincount(doms, minlength=len(start) - 1), out=start[1:])
    out = (torch.from_numpy(start).to(ndom.device), torch.from_numpy(nodes).to(ndom.device))
    ndom._domain_nodes = out
    return out


def delta_ctx(statics, dspec, ndom, nds, cstate, packed):
    """K13's argument block for folding the packed entries
    (`engine/state.py pack_delta_entries`) into the compact carry `cstate`;
    `dspec` is its CompactDeltaSpec, `ndom` / `nds` node_dom and
    node_dom_small at the carry's width (ndom's domain node lists,
    `domain_nodes`, built at its first use). Returns (block, the entries
    on the device, uploaded in one copy), which the caller keeps alive until
    the launch is enqueued."""
    device = cstate.free.device
    entries = upload_entries(packed, device)
    dom_start, dom_nodes = domain_nodes(ndom)
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
         "statics": statics._asdict(), "compact": cstate._asdict(),
         "domains": {"dom_start": dom_start, "dom_nodes": dom_nodes}},
        dims,
        {"nds": (dims["k"], n), "node_dom": (dims["k"], n), "t_tab_of": (t,), "t_dense_of": (t,),
         "ip_dense_of": (dims["ti"],), "node": (e,), "wgt": (e,), "req": (e, r),
         "vg": (e, dims["v"]), "sd_take": (e, dims["sd"]), "gp": (e, dims["gd"]),
         **_compact_shapes(dims)},
    )
    return ctx, entries


#: K13's and K7's launch plan (csrc/delta_runs.cuh): threads a block of the
#: grouping and pair kernel (the measured sweep, PERF.md) and at most, of
#: the walk, and K7's preference blocks at most (delta_apply.cu)
DELTA_THREADS = 512
DELTA_MAX_THREADS = 1024
DELTA_WALK_THREADS = 256
DELTA_PREF_BLOCKS = 2048


class DeltaPlan(ctypes.Structure):
    """ctypes mirror of `struct DeltaPlan` in csrc/delta_runs.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in ("threads", "pair_blocks", "walk_blocks", "pref_blocks", "segs", "shared",
                                            "smem")] + [("scratch", ctypes.c_void_p)]


def compact_delta_plan(n: int, e: int, tc: int, width: int, threads: int = None, budget: int = None,
                       work: int = None, pref_rows: int = None) -> dict:
    """K13's and K7's launch plan for a carry of N nodes whose rows are
    `width` elements a node (R + P + 2 W + V + SD + GD), E entries and Tc
    term slots: blocks of `threads` threads (DELTA_THREADS, fewer for a
    small batch; whole warps, at most DELTA_MAX_THREADS): the grouping block
    and `pair_blocks` blocks of pair threads, `work` of them (K13: E Tc,
    one an (entry, slot) pair; K7: one a node of each pair's domain,
    `pair_starts`), then `walk_blocks` blocks of DELTA_WALK_THREADS, one
    (element, run) a thread, and with `pref_rows` (K7 on statics with a
    preference weight: its own planes' ip rows) `pref_blocks` more of that
    size: none without pair threads, else as many as the atomic path's
    threads fill or the log order's rows take, at most DELTA_PREF_BLOCKS
    (both loop past them). The grouping block walks the entries' chunks of
    32 in `segs` segments at once, a warp a segment; its scratch (4 N + 12
    E + 8 E segs bytes: a word per segment and head, the nodes' slots, the
    entries' nodes and positions, the heads) in shared memory while it
    fits in WAVE_SMEM (or `budget`) with one segment or more — as many as
    fit, at most one a warp and one a chunk — else in global scratch
    ("global"; a segment a warp); `scratch_words` ints of global scratch:
    the runs (4 + 7 E: the entries in run order as 16-byte words, the
    heads' nodes, starts and counts) and, past the budget, the grouping
    scratch."""
    pairs, walkers = e * tc if work is None else work, e * width
    t = min(int(threads or DELTA_THREADS), DELTA_MAX_THREADS, max(-(-max(pairs, e, 1) // 32) * 32, 32))
    most = max(min(t // 32, -(-e // 32)), 1)
    room = (WAVE_SMEM if budget is None else budget) - 4 * n - 12 * e
    shared = room >= 8 * e
    segs = max(min(most, room // (8 * e) if e else most), 1) if shared else most
    group = 4 * n + 12 * e + 8 * e * segs
    pref = 0 if pref_rows is None or pairs == 0 else \
        min(max(-(-pairs // DELTA_WALK_THREADS), pref_rows), DELTA_PREF_BLOCKS)
    return {"threads": t, "pair_blocks": -(-pairs // t), "walk_blocks": -(-walkers // DELTA_WALK_THREADS),
            "pref_blocks": pref, "segs": segs, "shared": int(shared), "smem": group if shared else 0,
            "scratch_words": 4 + 7 * e + (0 if shared else group // 4), "group": "shared" if shared else "global"}


_DELTA_SCRATCH: dict = {}


def delta_plan_of(ctx, threads: int = None, budget: int = None) -> dict:
    """compact_delta_plan for the argument block `ctx`, K13's CompactCtx or
    K7's DeltaCtx (its node rows' width R + P + 2 W + V + SD + GD; K7's
    pair threads `work`, its preference blocks where its mode is not -1)."""
    if not isinstance(ctx, DeltaCtx):
        width = ctx.r + ctx.p + 2 * ctx.w + ctx.v + ctx.sd + ctx.gd
        return compact_delta_plan(ctx.n, ctx.e, ctx.tc, width, threads, budget)
    width = ctx.r + ctx.p_ports + 2 * ctx.w + ctx.v + ctx.sd + ctx.gd
    return compact_delta_plan(ctx.n, ctx.e, ctx.tc, width, threads, budget, ctx.work,
                              ctx.ti if ctx.pref >= 0 else None)


def delta_plan_struct(ctx, device, threads: int = None, budget: int = None) -> DeltaPlan:
    """K13's or K7's plan for the argument block `ctx` (of `threads` threads and a
    shared `budget` where given), its scratch taken from a buffer per
    device, grown as needed (the stream orders its reuse)."""
    plan = delta_plan_of(ctx, threads, budget)
    key = str(device)
    buf = _DELTA_SCRATCH.get(key)
    if buf is None or buf.numel() < plan["scratch_words"]:
        buf = _DELTA_SCRATCH[key] = torch.empty(plan["scratch_words"], dtype=torch.int32, device=device)
    return DeltaPlan(scratch=buf.data_ptr(), **{f: plan[f] for f, _ in DeltaPlan._fields_ if f != "scratch"})


def launch_compact_compress(spec, state) -> dict:
    """K11 (see compress_ctx) in one launch of its row-task grid on the
    current stream; returns CompactState's fields."""
    ctx, plan, out = compress_ctx(spec, state)
    libs = build()
    err = libs["compact_compress"].simtpu_compact_compress(
        ctypes.byref(ctx), ctypes.byref(plan), torch._C._cuda_getCurrentRawStream(state.free.device.index))
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel compact_compress failed to launch: {msg} ({err})")
    LAUNCHES["compact_compress"] += 1
    return out


def launch_compact_expand(spec, cstate, nds) -> dict:
    """K12 (see expand_ctx) in one launch on the current stream; returns
    SchedState's fields, every plane a fresh tensor."""
    ctx, out = expand_ctx(spec, cstate, nds)
    _launch_compact("compact_expand", ctx, cstate.free.device)
    return out


def launch_compact_delta(statics, dspec, ndom, nds, cstate, packed) -> None:
    """K13 (see delta_ctx) on `compact_delta_plan`: the entries folded into
    `cstate` in place, in one call (its two kernels) on the current
    stream."""
    device = cstate.free.device
    ctx, entries = delta_ctx(statics, dspec, ndom, nds, cstate, packed)
    libs = build()
    plan = delta_plan_struct(ctx, device)
    err = libs["compact_delta"].simtpu_compact_delta(ctypes.byref(ctx), ctypes.byref(plan),
                                                     torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel compact_delta failed to launch: {msg} ({err})")
    LAUNCHES["compact_delta"] += 1


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
    ] + [("flags", ctypes.c_void_p)]


#: K8's launch plan (csrc/audit_bulk.cu): threads a block, the entries a
#: radix block ranks, the sorted positions a scan block holds (one a
#: thread), the widest radix digit
AUDIT_THREADS = 256
AUDIT_SORT_TILE = 2048
AUDIT_SCAN_TILE = 256
AUDIT_MAX_DIGIT_BITS = 10
#: the scratch arrays of `struct AuditPlan`, in its order: (name, bytes of
#: one element, elements as a function of the plan)
_AUDIT_SCRATCH = (
    ("keys", 4, lambda p: 2 * p["m"]),
    ("vals", 4, lambda p: 2 * p["m"]),
    ("hist", 4, lambda p: p["buckets"] * p["sort_tiles"]),
    ("tail", 8, lambda p: p["scan_tiles"] * p["s"]),
    ("carry", 8, lambda p: p["scan_tiles"] * p["s"]),
    ("starts", 4, lambda p: p["scan_tiles"]),
    ("onw", 4, lambda p: p["words"] * p["m"]),
    ("done", 4, lambda p: p["passes"] + 1),
)


class AuditPlan(ctypes.Structure):
    """ctypes mirror of `struct AuditPlan` in csrc/audit_bulk.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("passes", "digit_bits", "sort_tiles", "scan_tiles", "s", "words")] + [
        (f, ctypes.c_void_p) for f, _, _ in _AUDIT_SCRATCH]


def audit_plan(n: int, m: int, s: int, w: int = 0) -> dict:
    """K8's launch plan for M entries on N nodes, S prefix columns (R + P +
    2W + V + SD + GD) and W volumes: the node ids (N for one outside [0,
    N)) sorted by `passes` LSD radix passes of `digit_bits` bits
    (`buckets` digits; one pass up to 1023 nodes), each a count and a place
    kernel over `sort_tiles` blocks of AUDIT_SORT_TILE entries, then the
    tails and the flags kernels over `scan_tiles` blocks of
    AUDIT_SCAN_TILE sorted positions: `kernels` launches an audit, none
    scanning the log once per node. `offsets` / `scratch_bytes` lay the
    scratch arrays out in one slab, each 16-byte aligned."""
    key_bits = max(1, int(n).bit_length())
    passes = -(-key_bits // AUDIT_MAX_DIGIT_BITS)
    digit_bits = -(-key_bits // passes)
    plan = {"n": n, "m": m, "s": s, "words": -(-w // 32), "passes": passes, "digit_bits": digit_bits,
            "buckets": 1 << digit_bits, "threads": AUDIT_THREADS,
            "sort_tiles": max(1, -(-m // AUDIT_SORT_TILE)), "scan_tiles": max(1, -(-m // AUDIT_SCAN_TILE)),
            "kernels": 2 * passes + 2}
    at, offsets = 0, {}
    for name, size, count in _AUDIT_SCRATCH:
        offsets[name] = at
        at = (at + size * count(plan) + 15) & ~15
    plan.update(offsets=offsets, scratch_bytes=at)
    return plan


def launch_audit(x) -> torch.Tensor:
    """K8 over `x` (a kernels/audit.py AuditInputs on one CUDA device) on
    the current stream, in one call of its C entry (`audit_plan`'s kernels
    and the memset of their finish counters); returns the flag words [M]
    int32. Raises if an input is malformed or the launch is refused."""
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
    plan = audit_plan(n, m, r + p + 2 * w + v + sd + gd, w)
    # every flag word and scratch element is written by the kernels
    flags = torch.empty(m, dtype=torch.int32, device=device)
    slab = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=device)
    ctx = AuditCtx(n=n, m=m, r=r, p=p, w=w, c=c, v=v, sd=sd, gd=gd, pad_=0, flags=flags.data_ptr(),
                   **{f: t.data_ptr() for f, t in tensors.items()})
    block = AuditPlan(passes=plan["passes"], digit_bits=plan["digit_bits"], sort_tiles=plan["sort_tiles"],
                      scan_tiles=plan["scan_tiles"], s=plan["s"], words=plan["words"],
                      **{f: slab.data_ptr() + off for f, off in plan["offsets"].items()})
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["audit_bulk"].simtpu_audit_bulk(ctypes.byref(ctx), ctypes.byref(block), stream)
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
        "scr": (ROUND_SCR_ROWS, n), "dscr": (ROUND_DSCR_ROWS, d + 1), "iscr": (4 * n + 2 * (d + 1),),
        **{f: (rows, k_cap) for f in ("assign", "vg_idx", "dev_idx", "gpu_idx")},
        "lvm_mat": (rows, k_cap, v), "gpu_mat": (rows, k_cap, gd),
    })
    return {f: t.data_ptr() for f, t in tensors.items()}


#: K14's and K16's launch plan (csrc/rounds.cuh): one thread-block cluster
#: of at most ROUND_CLUSTER_MAX blocks (above 8 the non-portable size), at
#: most ROUND_CLUSTER_THREADS threads a block, up to ROUND_NPT nodes a
#: thread in registers (templates 1, 2, ROUND_NPT; "global" above, the
#: nodes re-read); the cluster aims at ROUND_NODES_PER_BLOCK nodes a block
#: (the measured sweep, PERF.md), the tile a multiple of 32 nodes
ROUND_CLUSTER_MAX = 16
ROUND_CLUSTER_THREADS = 512
ROUND_NPT = 4
ROUND_NODES_PER_BLOCK = 128
#: the small-key domain bins of K16's blocks (rounds.cuh DOM_SMALL) and
#: the shared words of one term column it stages (round_commit.cu
#: COMMIT_TERM_WORDS)
ROUND_DOM_SMALL = 64
ROUND_TERM_WORDS = 9


class RoundPlan(ctypes.Structure):
    """ctypes mirror of `struct RoundPlan` in csrc/rounds.cuh."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "npt", "tile", "smem", "pad_")] + [
        ("pub", ctypes.c_void_p)]


def round_blocks(n: int) -> int:
    """The blocks of K14's / K16's cluster for N nodes: the power of two
    that gives each block at most ROUND_NODES_PER_BLOCK nodes, at most
    ROUND_CLUSTER_MAX."""
    want = -(-max(n, 1) // ROUND_NODES_PER_BLOCK)
    return min(ROUND_CLUSTER_MAX, 1 << (want - 1).bit_length())


def round_plan(n: int, tc: int = 0, blocks: int = None) -> dict:
    """K14's and K16's launch plan for a round over N nodes (`tc` term
    columns of the batch), with `blocks` blocks where given (the sweep),
    `round_blocks(n)` otherwise: block b owns the nodes [b * tile, min(N,
    (b + 1) * tile)) (the tile a multiple of 32, the last one ragged, none
    empty), thread t of a block the nodes tile start + t + j * threads for j
    < nodes_per_thread (kept in registers under template "1", "2" or "4",
    re-read under "global"), and K16's dynamic shared bytes (its published
    bins, dots and tile total, their fold, the ranks' tile totals, the
    staged term columns, the tile's prefix). Where those pass WAVE_SMEM
    (from Tc = 512) K16's `mode` is "global": each block keeps all but the
    prefix in its own row of `row_words` floats of global scratch
    (round_commit.cu commit_row_words) and its shared bytes are the
    prefix's."""
    b = min(max(int(blocks or round_blocks(n)), 1), ROUND_CLUSTER_MAX)
    tile = -(-(-(-max(n, 1) // b)) // 32) * 32
    b = -(-max(n, 1) // tile)
    per = -(-tile // ROUND_CLUSTER_THREADS)
    threads = -(-(-(-tile // per)) // 32) * 32
    npt = next((t for t in (1, 2, ROUND_NPT) if per <= t), 0)
    if npt:
        threads = -(-(-(-tile // npt)) // 32) * 32
    region = 2 * (tc * (ROUND_DOM_SMALL + 1) + 1) + ROUND_CLUSTER_MAX + ROUND_TERM_WORDS * tc
    mode = "shared" if 4 * (region + tile) <= WAVE_SMEM else "global"
    return {"blocks": b, "threads": threads, "nodes_per_thread": npt or per, "npt": npt,
            "template": str(npt) if npt else "global", "tile": tile, "mode": mode,
            "shared_bytes": 4 * (tile + (region if mode == "shared" else 0)),
            "row_words": (region + 3) & ~3 if mode == "global" else 0}


def _round_plan_struct(name: str, rb, n: int, tc: int, blocks: int = None) -> RoundPlan:
    """K14's / K16's plan; K16's global mode points at `rb.pub` (one row
    per block of the largest cluster, allocated at its first use)."""
    plan = round_plan(n, tc, blocks)
    commit = name == "round_commit"
    pub = 0
    if commit and plan["mode"] == "global":
        need = ROUND_CLUSTER_MAX * plan["row_words"]
        if rb.pub is None or rb.pub.numel() < need:
            rb.pub = torch.empty(need, dtype=torch.float32, device=rb.device)
        pub = rb.pub.data_ptr()
    return RoundPlan(blocks=plan["blocks"], threads=plan["threads"], npt=plan["npt"], tile=plan["tile"],
                     smem=plan["shared_bytes"] if commit else 0, pad_=0, pub=pub)


def _launch_round_with(libs, name: str, rb, i: int, k: int, mode: int, row: int, blocks: int = None) -> None:
    buf = rb.buf
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    if rb.ctx is None:
        rb.ctx = _round_pointers(rb)
    ctx = RoundCtx(i=i, k=k, mode=mode, row=row, n_dom=rb.n_domains, k_cap=rb.assign.shape[1], **rb.ctx)
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    fn = getattr(libs[name], f"simtpu_{name}")
    if name in CLUSTER_KERNELS:
        plan = _round_plan_struct(name, rb, buf.ctx.n, buf.ctx.tc, blocks)
        err = fn(ctypes.byref(buf.ctx), ctypes.byref(ctx), ctypes.byref(plan), stream)
    else:
        err = fn(ctypes.byref(buf.ctx), ctypes.byref(ctx), stream)
    if err:
        msg = build()[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


def launch_round(name: str, rb, i: int, k: int, mode: int, row: int, blocks: int = None) -> None:
    """Launch round kernel `name` (K14-K16) for the round of pod i of the
    batch, run length k, variant `mode` (engine/rounds.py V_*), output row
    `row`, on the current CUDA stream (K14/K16 on `round_plan`'s cluster,
    of `blocks` blocks where given); raises if the launch is refused. No
    synchronization."""
    buf = rb.buf
    if not 0 <= i < buf.n_pods:
        raise IndexError(f"pod {i} outside the batch of {buf.n_pods}")
    if not 0 <= row < rb.assign.shape[0]:
        raise IndexError(f"output row {row} outside {rb.assign.shape[0]} rows")
    _launch_round_with(build(), name, rb, i, k, mode, row, blocks)
    LAUNCHES[name] += 1


#: K15's launch plan (csrc/round_pick.cu): one block of up to
#: ROUND_THREADS threads, thread t owning the contiguous nodes [t * per,
#: (t + 1) * per); the threshold round keeps up to PICK_REG_NPT nodes a
#: thread in registers (templates 1, 2, 4, PICK_REG_NPT), re-reads them from
#: global memory above; PICK_LEVELS bisection levels per block reduction;
#: the quota round's ranking buffers sit in shared memory up to
#: PICK_SORT_SMEM_N nodes, in RoundCtx.iscr above; its ladder runs on one
#: warp up to PICK_WARP_LADDER listed domains (decided by the data)
ROUND_THREADS = 1024
PICK_REG_NPT = 8
PICK_LEVELS = 1
PICK_SORT_SMEM_N = 8192
PICK_BUCKETS = 256
PICK_WARP_LADDER = 32
#: the profile builds' phases by slot (csrc/round_pick.cu PICK_PROF_SLOTS:
#: cycles per phase, then the bisection steps (threshold) or radix passes
#: (quota) and the ladder levels; round_score.cu SCORE_PROF_PHASES,
#: round_commit.cu COMMIT_PROF_PHASES: cycles per phase, of
#: ROUND_PROF_SLOTS slots)
PICK_PHASES = ("load", "bisection", "clamp scans", "spread minima + base", "aggregates + compaction",
               "ladder", "ranking", "split scans")
PICK_PROF_SLOTS = len(PICK_PHASES) + 2
SCORE_PHASES = ("pass 1 + raws", "cluster fold", "pass 2", "bootstrap", "pass 4", "end wait")
COMMIT_PHASES = ("zero + barrier", "sums, dots, tile prefix", "cluster fold", "state update", "slots",
                 "end wait")
ROUND_PROF_SLOTS = 8
PROF_SLOTS = {"round_pick": PICK_PROF_SLOTS, "round_score": ROUND_PROF_SLOTS, "round_commit": ROUND_PROF_SLOTS}


def round_pick_plan(n: int, tc: int = 0, quota: bool = False) -> dict:
    """K15's launch plan for a round over N nodes (`tc` term columns, a
    quota round or a threshold round): threads, nodes per thread, the
    threshold template ("1", "2", "4", "8", or "global" where the nodes'
    rows are re-read from global memory) and, for a quota round, where the
    ranking's buffers sit and the dynamic shared bytes."""
    threads = min(max(-(-n // 32) * 32, 32), ROUND_THREADS)
    per = -(-n // threads)
    npt = next((t for t in (1, 2, 4, PICK_REG_NPT) if per <= t), 0)
    plan = {"threads": threads, "nodes_per_thread": per, "template": str(npt) if npt else "global",
            "path": "registers" if npt else "global", "levels": PICK_LEVELS, "kernel": "threshold"}
    if quota:
        sort_smem = n <= PICK_SORT_SMEM_N
        ints = ((tc + 3) & ~3) + PICK_BUCKETS * (threads // 32 + 1) + (4 * n if sort_smem else 0)
        plan.update(kernel="quota", sort="shared" if sort_smem else "global", shared_bytes=4 * ints)
    return plan


def launch_round_profile(name: str, rb, i: int, k: int, mode: int, row: int = 0) -> None:
    """Launch the profile build of round kernel `name` (K14-K16) for the
    round of pod i, run length k, variant `mode`; its phase cycles add into
    the library's counters (`round_prof`). A measurement launch: not
    counted in LAUNCHES. No synchronization."""
    _launch_round_with(build_profile(), name, rb, i, k, mode, row)


def round_prof(name: str) -> list:
    """The profile build's counters of round kernel `name` since the last
    read (its phases' cycles, and for K15 the steps or passes and the
    ladder levels), zeroed. Synchronizes the device."""
    out = (ctypes.c_ulonglong * PROF_SLOTS[name])()
    err = getattr(build_profile()[name], f"simtpu_{name}_prof")(out)
    if err:
        raise RuntimeError(f"reading {name}'s profile counters failed ({err})")
    return list(out)


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
    ] + [(f, ctypes.c_int) for f in ("threads", "npt", "smem", "pod_words", "off_pod", "off_min", "off_free",
                                     "slab_stride")] + [("carry", ctypes.c_void_p), ("slab", ctypes.c_void_p)]


#: the one-thread-per-node layout of csrc/wave.cuh (K9, K10, K19): threads
#: of a block at most, nodes per thread in registers at most (the shared
#: memory a block plans with: WAVE_SMEM)
WAVE_BLOCK = 1024
WAVE_REG_NPT = 4
#: K19's step rows per node past the register templates (csrc/sweep_place.cu
#: SWEEP_ROWS) and the scalar words heading a staged pod (POD_HEAD)
SWEEP_ROWS = 10
SWEEP_POD_HEAD = 8


def wave_threads(n: int) -> int:
    """Threads of a one-thread-per-node block for N nodes (wave.cuh)."""
    return min(max(-(-n // 32) * 32, 32), WAVE_BLOCK)


def wave_npt(n: int) -> int:
    """Nodes per thread of the register template for N nodes, 0 where the
    step rows live in global memory (wave.cuh wave_npt)."""
    per = -(-n // WAVE_BLOCK)
    if per <= 1:
        return 1
    if per <= 2:
        return 2
    return WAVE_REG_NPT if per <= WAVE_REG_NPT else 0


def sweep_place_plan(n: int, r: int, tc: int) -> dict:
    """K19's launch plan for N nodes, R resources and Tc term columns: one
    block per scenario of `threads` threads, `nodes_per_thread` nodes each
    (the register template `template`, "global" where the step rows live
    in `carry_rows` rows of global memory per scenario), and the dynamic
    shared memory in wave.cuh's priority order — the two staged-pod
    buffers and the hard-spread minima while they fit in WAVE_SMEM, past
    it in the scenario's slab (`slab_bytes` of global scratch a scenario,
    `mode` "global"; wave.cuh wave_seg), then the replica's free rows
    where they still fit (`off_free` -1 otherwise)."""
    pod_words = SWEEP_POD_HEAD + r + 8 * tc
    plan = _SmemPlan()
    off_pod = plan.add(2 * pod_words * 4, True)
    off_min = plan.add(2 * 32 * tc * 4, True)
    off_free = plan.add(r * n * 4)
    threads, npt = wave_threads(n), wave_npt(n)
    return {"threads": threads, "npt": npt, "nodes_per_thread": npt or -(-n // threads),
            "template": str(npt) if npt else "global", "pod_words": pod_words, "off_pod": off_pod,
            "off_min": off_min, "off_free": off_free, "shared_bytes": plan.used,
            "carry_rows": 0 if npt else SWEEP_ROWS, "slab_bytes": plan.slab,
            "mode": "global" if plan.slab else "shared"}


#: K18's launch plan (csrc/sweep_drain.cu): threads a block at most, the
#: smallest node tile, the blocks per SM the tiles aim at, and the SMs of
#: the card the plan is made for where none is given (an H100 SXM)
DRAIN_THREADS = 256
DRAIN_MIN_TILE = 64
DRAIN_BLOCKS_PER_SM = 2
H100_SMS = 132
#: the entries K18 stages in shared memory at a time at most, and the
#: shared words the staging may take (5 per entry, 10 per entry and term,
#: one per entry and element of a node's rows)
DRAIN_STAGE_ENTRIES = 64
DRAIN_STAGE_WORDS = 12 * 1024
#: the staged words of one (entry, term) pair: its domain, key, term and
#: interpod row, its rank and five increments (the pairs are ranked on
#: those fields as staged, so no packed sort key is staged and no count of
#: keys, domains or terms is refused)
DRAIN_PAIR_WORDS = 10
#: where one entry of a group's term columns passes DRAIN_STAGE_WORDS: the
#: shared bytes the staging may take with the opt-in attribute, and past
#: them one entry at a time in each block's slab of global scratch
DRAIN_SMEM_MAX = 200 * 1024


_SMS: dict = {}


def _sm_count(device) -> int:
    """The SMs of CUDA device `device` (asked once per device)."""
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def sweep_drain_plan(s: int, n: int, tc: int = 0, width: int = 0, sms: int = H100_SMS) -> dict:
    """K18's launch plan for S scenarios over N nodes (groups of `tc` term
    columns, node rows `width` elements wide) on a card of `sms` SMs: a grid of S x `tiles` blocks, block
    (s, j) the nodes [j * tile, min(N, (j + 1) * tile)) of scenario s,
    DRAIN_THREADS threads (the copy takes every thread a block has, the
    walk one per node of the tile); the tile a multiple of 32 nodes (every plane's tile
    part starts 16-byte aligned where N is a multiple of 4), as large as
    still puts DRAIN_BLOCKS_PER_SM blocks on every SM, never under
    DRAIN_MIN_TILE (the kernel holds one more block an SM, so the main
    paths' chunks run in one wave). The tile-0 block of each scenario also owns its
    cnt_total. Each block stages `stage_entries` entries at a time in
    `shared_bytes` of shared memory (`staging` "shared"), or where one
    entry passes DRAIN_SMEM_MAX one at a time in its own `slab_stride`
    bytes of a global slab of `slab_bytes` (`staging` "global")."""
    want = -(-DRAIN_BLOCKS_PER_SM * sms // max(s, 1))
    tile = max(DRAIN_MIN_TILE, -(-(-(-max(n, 1) // want)) // 32) * 32)
    tiles = max(1, -(-n // tile))
    threads = DRAIN_THREADS
    per_entry = 5 + DRAIN_PAIR_WORDS * tc + width
    budget = DRAIN_STAGE_WORDS if per_entry <= DRAIN_STAGE_WORDS else DRAIN_SMEM_MAX // 4
    entries = max(1, min(DRAIN_STAGE_ENTRIES, budget // per_entry))
    plan = {"tile": tile, "tiles": tiles, "threads": threads, "blocks": s * tiles, "grid": (s, tiles),
            "total_owner_tile": 0, "stage_entries": entries, "shared_bytes": 4 * entries * per_entry,
            "staging": "shared", "slab_stride": 0, "slab_bytes": 0}
    if per_entry > budget:
        stride = (4 * per_entry + 15) & ~15
        plan.update(shared_bytes=0, staging="global", slab_stride=stride, slab_bytes=s * tiles * stride)
    return plan


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


def check_sweep_drain(statics, base, reps, idx: torch.Tensor) -> tuple:
    """K18's input checks, on any device: `idx` a contiguous [S, E] int32
    tensor on the base's device, `reps` S contiguous replicas of `base`'s
    planes, the statics' node_dom a contiguous int32 [K, N] tensor there.
    Returns (S, T, Ti). No count of topology keys (node_dom's rows),
    domains or terms is refused."""
    device = base.free.device
    _checked("idx", idx, device, torch.int32)
    _checked("statics.node_dom", statics.node_dom, device, torch.int32)
    if idx.dim() != 2:
        raise ValueError(f"idx: need an [S, E] tensor, got {tuple(idx.shape)}")
    s = idx.shape[0]
    t, ti = _replica_dims(base, reps, s)
    return s, t, ti


def launch_sweep_drain(statics, base, reps, log: dict, idx: torch.Tensor) -> None:
    """K18 on the current stream, in one launch of idx.shape[0] x tiles
    blocks (`sweep_drain_plan` for the card's SM count): replica s of
    `reps` (a SchedState of [S, ...] planes, written here) becomes `base`
    (a SchedState, read only) with the placement-log entries of row s of
    `idx` ([S, E] int32, -1 = trailing padding) applied in order; `log`
    maps g, node, wgt, req, vg, sd_take, gp to the packed whole log on the
    device. Raises if an input is malformed or the launch is refused."""
    s, t, ti = check_sweep_drain(statics, base, reps, idx)
    libs = build()
    device = base.free.device
    cols = idx.shape[1]
    rep0 = type(base)(*(r[0] for r in reps))
    ctx = make_delta_ctx(statics, rep0, log)
    planes = {f: _checked(f"base.{f}", b, device, b.dtype).data_ptr() for f, b in zip(DENSE_FIELDS, base)}
    width = ctx.r + ctx.p_ports + 2 * ctx.w + ctx.v + ctx.sd + ctx.gd
    plan = sweep_drain_plan(s, ctx.n, ctx.tc, width, _sm_count(device))
    slab = torch.empty(plan["slab_bytes"], dtype=torch.uint8, device=device) if plan["slab_bytes"] else None
    sw = SweepCtx(s=s, cols=cols, t=t, ti=ti, idx=idx.data_ptr(), **planes, threads=plan["threads"],
                  npt=plan["tile"], pod_words=plan["stage_entries"], smem=plan["shared_bytes"],
                  slab_stride=plan["slab_stride"], slab=slab.data_ptr() if slab is not None else 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = libs["sweep_drain"].simtpu_sweep_drain(ctypes.byref(ctx), ctypes.byref(sw), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel sweep_drain failed to launch: {msg} ({err})")
    LAUNCHES["sweep_drain"] += 1


def launch_sweep_place(sb) -> None:
    """K19 on the current stream, in one launch of one block per scenario
    of `sb` (an engine/batched.py SweepBuffers; `sweep_place_plan`): block
    s places the batch rows of row s of `sb.rows` on replica s of
    `sb.reps` under row s of `sb.valid_s`, writing output row j for pod
    list entry j. Past 4096 nodes the step rows' scratch `sb.carry_s` ([S,
    SWEEP_ROWS, N]) is allocated here, and where the plan's staged pods or
    minima pass the shared budget the slab `sb.slab_s` ([S, stride] bytes).
    Raises if an input is malformed or the launch is refused."""
    libs = build()
    s, cols = sb.rows.shape
    _checked("rows", sb.rows, sb.device, torch.int32)
    t, ti = _replica_dims(None, sb.reps, s)
    if sb.ctx is None:
        sb.ctx = make_ctx(sb, out_rows=cols)
    ctx = sb.ctx
    plan = sweep_place_plan(ctx.n, ctx.r, ctx.tc)
    carry = 0
    if plan["carry_rows"]:
        sb.carry_s = torch.empty((s, plan["carry_rows"], ctx.n), dtype=torch.float32, device=sb.device)
        carry = sb.carry_s.data_ptr()
    stride = (plan["slab_bytes"] + 15) & ~15
    slab = 0
    if stride:
        sb.slab_s = torch.empty((s, stride), dtype=torch.uint8, device=sb.device)
        slab = sb.slab_s.data_ptr()
    sw = SweepCtx(s=s, cols=cols, t=t, ti=ti, idx=sb.rows.data_ptr(), threads=plan["threads"], npt=plan["npt"],
                  smem=plan["shared_bytes"], pod_words=plan["pod_words"], off_pod=plan["off_pod"],
                  off_min=plan["off_min"], off_free=plan["off_free"], carry=carry, slab_stride=stride, slab=slab)
    stream = torch.cuda.current_stream(sb.device).cuda_stream
    err = libs["sweep_place"].simtpu_sweep_place(ctypes.byref(ctx), ctypes.byref(sw), stream)
    if err:
        msg = libs[KERNELS[0]].simtpu_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel sweep_place failed to launch: {msg} ({err})")
    LAUNCHES["sweep_place"] += 1


class ExplainCtx(ctypes.Structure):
    """ctypes mirror of `struct ExplainCtx` in csrc/explain_pass.cu."""

    _fields_ = [("p", ctypes.c_int), ("k", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("counts", "feasible", "witnesses", "fail_code")
    ]


class ExplainPlan(ctypes.Structure):
    """ctypes mirror of `struct ExplainPlan` in csrc/explain_pass.cu."""

    _fields_ = [(f, ctypes.c_int) for f in ("blocks", "threads", "tile", "smem")]


#: K20's launch plan (csrc/explain_pass.cu): one thread-block cluster a pod
#: of at most EXPLAIN_CLUSTER_MAX blocks (above 8 the non-portable size),
#: at most EXPLAIN_THREADS threads a block, and the threads an SM holds at
#: once (its registers: 64 a thread), which the launch's clusters share
EXPLAIN_CLUSTER_MAX = 16
EXPLAIN_THREADS = 1024
EXPLAIN_SM_THREADS = 1024
#: the fewest nodes a block of K20 takes where the pod could use more blocks
EXPLAIN_MIN_TILE = 256


def explain_plan(n: int, tc: int = 0, blocks: int = None, pods: int = 64, sms: int = H100_SMS) -> dict:
    """K20's launch plan for `pods` pods over N nodes (`tc` term columns) on
    a card of `sms` SMs, with `blocks` blocks a pod where given (the
    sweep): else the most blocks (a power of two, at most
    EXPLAIN_CLUSTER_MAX) that still keep every pod's threads within its
    share of one wave (sms x EXPLAIN_SM_THREADS / pods) and every tile
    at EXPLAIN_MIN_TILE nodes or more. Block b of a pod's cluster owns the nodes [b
    * tile, min(N, (b + 1) * tile)) (the tile a multiple of 32, the last
    one ragged, none empty); in steps 1 and 2 thread t of a block takes
    the tile's nodes t, t + threads, ...; in the cascade walk the
    contiguous run [t * nodes_per_thread, (t + 1) * nodes_per_thread) of
    the tile. The dynamic shared bytes hold two [tc] minima (the tile's,
    the cluster's)."""
    n1 = max(n, 1)

    def threads_of(b):
        return min(EXPLAIN_THREADS, -(-(-(-n1 // b)) // 32) * 32)

    if blocks:
        b = min(max(int(blocks), 1), EXPLAIN_CLUSTER_MAX)
    else:
        budget = sms * EXPLAIN_SM_THREADS // max(pods, 1)
        b = 1
        while (b < EXPLAIN_CLUSTER_MAX and -(-n1 // (2 * b)) >= EXPLAIN_MIN_TILE
               and 2 * b * threads_of(2 * b) <= budget):
            b *= 2
    tile = -(-(-(-n1 // b)) // 32) * 32
    b = -(-n1 // tile)
    threads = min(EXPLAIN_THREADS, tile)
    return {"blocks": b, "tile": tile, "threads": threads, "nodes_per_thread": -(-tile // threads),
            "shared_bytes": 2 * tc * 4}


def launch_explain_pass(eb, blocks: int = None) -> None:
    """K20 on the current stream, in one launch of one thread-block cluster
    per pod of `eb` (an explain/breakdown.py ExplainBuffers; `explain_plan`,
    of `blocks` blocks a pod where given): the cluster explains pod p of
    the chunk against the shared state, in the pod's own scratch, and
    writes row p of the counts, feasible, witnesses and fail codes. Raises
    if an input is malformed or the launch is refused."""
    libs = build()
    buf = eb.buf
    p, n = buf.n_pods, buf.statics.alloc.shape[0]
    v, sd, gd = buf.statics.vg_cap.shape[1], buf.statics.sdev_cap.shape[1], buf.state.gpu_free.shape[1]
    outs = {f: _checked(f"eb.{f}", getattr(eb, f), eb.device, torch.int32)
            for f in ("counts", "feasible", "witnesses", "fail_code")}
    planes = {f: _checked(f"eb.{f}", getattr(eb, f), eb.device, getattr(eb, f).dtype)
              for f in ("stage_s", "raw_s", "st_ok_s", "st_alloc_s", "st_fr_s", "st_take_s", "st_raw_s",
                        "gpu_ok_s", "gpu_sh_s")}
    s_n = eb.counts.shape[1]
    _check_shapes({**outs, **planes}, {
        "counts": (p, s_n), "feasible": (p,), "witnesses": (p, s_n, eb.k), "fail_code": (p,),
        "stage_s": (p, n), "raw_s": (p, 4, n), "st_ok_s": (p, n), "st_alloc_s": (p, n, v), "st_fr_s": (p, n, v),
        "st_take_s": (p, n, sd), "st_raw_s": (p, n), "gpu_ok_s": (p, n), "gpu_sh_s": (p, n, gd),
    })
    if buf.ctx is None:
        buf.ctx = make_ctx(buf)
    ctx = ExplainCtx(p=p, k=eb.k, **{f: t.data_ptr() for f, t in outs.items()})
    plan = explain_plan(n, buf.ctx.tc, blocks, p, _sm_count(eb.device))
    ep = ExplainPlan(blocks=plan["blocks"], threads=plan["threads"], tile=plan["tile"], smem=plan["shared_bytes"])
    stream = torch.cuda.current_stream(eb.device).cuda_stream
    err = libs["explain_pass"].simtpu_explain_pass(ctypes.byref(buf.ctx), ctypes.byref(ctx), ctypes.byref(ep),
                                                    stream)
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
        ("lr", ctypes.c_float), ("slabs", ctypes.c_int)] + [
        (f, ctypes.c_void_p) for f in ("feas", "req", "cnt", "fixed", "cap", "valid", "y", "over",
                                       "residual", "stuck", "scratch")
    ] + [(f, ctypes.c_int) for f in ("threads", "kpt", "load_threads", "load_npt", "load_unroll", "pad_")]


#: K22's launch plan (csrc/relax_load.cu): threads a block at most, the
#: classes of req it stages at a time; the threads, nodes a thread (1, 2,
#: 4) and classes unrolled (4, 8, 16) it takes, from the sweep on the card
#: (PERF.md)
RELAX_LOAD_THREADS = 256
RELAX_LOAD_REQ_ROWS = 1024
RELAX_LOAD_BLOCK = 128
RELAX_LOAD_NPT = 1
RELAX_LOAD_UNROLL = 8


def relax_load_plan(s: int, n: int, r: int, threads: int = None, npt: int = None, unroll: int = None) -> dict:
    """K22's launch plan for S candidates over N nodes and R resources (the
    sweep's `threads`, `npt`, `unroll` where given): a grid of (node tiles,
    S) blocks of `threads` threads, each thread `nodes_per_thread` nodes
    (tile start + t + j * threads) and the class loop unrolled `unroll`
    deep; the R sums of a node in registers under the "r4" (R <= 4) or
    "r8" template, in `r_chunks` chunks of 8 above 8 (each re-reading y)."""
    threads = int(threads or RELAX_LOAD_BLOCK)
    npt = int(npt or RELAX_LOAD_NPT)
    unroll = int(unroll or RELAX_LOAD_UNROLL)
    rmax = 4 if r <= 4 else 8
    return {"threads": threads, "nodes_per_thread": npt, "unroll": unroll, "template": f"r{rmax}",
            "r_chunks": max(1, -(-r // rmax)), "rereads_y": r > 8,
            "grid": (max(1, -(-n // (threads * npt))), s)}


#: K23's paths by the padded node row (the next power of two >= N,
#: csrc/relax.cuh): up to RELAX_REG_ROW the row sorts in registers, one
#: block of at most RELAX_ROW_THREADS threads per row; up to
#: RELAX_SHARED_ROW its keys and f64 prefix sums sit in shared memory, 12
#: bytes each of the block's 227 KB; a wider row sorts in a slab of global
#: scratch
RELAX_REG_ROW = 4096
RELAX_ROW_THREADS = 512
RELAX_SHARED_ROW = 16384
#: K23's wide-row path: persistent blocks per SM, one scratch slab each
RELAX_SLABS_PER_SM = 2


def relax_project_plan(n: int, rows: int, sms: int = 1) -> dict:
    """K23's launch plan for `rows` (class, candidate) rows of `n` nodes on
    a card of `sms` SMs: the padded row `np2`, the path ("registers",
    "shared" or "slab"), threads per row, keys per thread, the sorted
    width (threads x keys, at least np2), rows per block, the dynamic
    shared bytes of a block, and the wide-row path's slabs and scratch
    bytes (0 on the other paths)."""
    np2 = max(32, 1 << max(n - 1, 0).bit_length())
    plan = {"np2": np2, "rows_per_block": 1, "slabs": 0, "scratch_bytes": 0}
    if np2 <= RELAX_REG_ROW:
        # 4 keys a thread up to 1024 padded nodes (256 threads), 8 above
        kpt = 4 if np2 <= 1024 else 8
        threads = max(32, np2 // kpt)
        # two buffers of the cross-warp exchanges (the second holds t after the sort)
        return {**plan, "path": "registers", "threads": threads, "keys_per_thread": kpt,
                "width": threads * kpt, "shared_bytes": 2 * threads * kpt * 4}
    if np2 <= RELAX_SHARED_ROW:
        return {**plan, "path": "shared", "threads": 1024, "keys_per_thread": np2 // 1024, "width": np2,
                "shared_bytes": np2 * 12}
    slabs = min(rows, RELAX_SLABS_PER_SM * sms)
    return {**plan, "path": "slab", "threads": 1024, "keys_per_thread": np2 // 1024, "width": np2,
            "shared_bytes": 0, "slabs": slabs, "scratch_bytes": slabs * np2 * 12}


def relax_ctx(rb) -> RelaxCtx:
    """K22/K23's argument block for a solve/relax.py RelaxBuffers on one
    device: every tensor's device, dtype, contiguity and shape checked,
    K23's launch plan (`relax_project_plan`; a block built from CPU
    tensors plans for one SM) and K22's (`relax_load_plan`). Rows wider than RELAX_SHARED_ROW get the
    wide-row path, each slab in `rb.cache["scratch"]`."""
    device = rb.y.device
    s, c, n = rb.y.shape
    r = rb.req.shape[1]
    fields = {"feas": torch.bool, "req": torch.float32, "cnt": torch.float32, "fixed": torch.float32,
              "cap": torch.float32, "valid": torch.bool, "y": torch.float32, "over": torch.float32,
              "residual": torch.float32, "stuck": torch.int32}
    tensors = {f: _checked(f"relax.{f}", getattr(rb, f), device, dt) for f, dt in fields.items()}
    _check_shapes(tensors, {"feas": (c, n), "req": (c, r), "cnt": (c,), "fixed": (n, r), "cap": (n, r),
                            "valid": (s, n), "over": (s, n, r), "residual": (s,), "stuck": (s,)})
    sms = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 1
    plan = relax_project_plan(n, s * c, sms)
    slabs = plan["slabs"]
    if slabs:
        rb.cache["scratch"] = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=device)
    scratch = rb.cache["scratch"].data_ptr() if slabs else 0
    load = relax_load_plan(s, n, r)
    return RelaxCtx(s=s, c=c, n=n, r=r, mode=0, np2=plan["np2"], lr=float(rb.lr), slabs=slabs, scratch=scratch,
                    threads=plan["threads"], kpt=plan["keys_per_thread"], load_threads=load["threads"],
                    load_npt=load["nodes_per_thread"], load_unroll=load["unroll"],
                    **{f: t.data_ptr() for f, t in tensors.items()})


def relax_project_rows_per_sm(rb) -> int:
    """(class, candidate) rows of K23's launch on `rb` resident on one SM
    at once, from the card's occupancy calculator."""
    ctx = rb.cache.get("ctx")
    if ctx is None:
        ctx = rb.cache["ctx"] = relax_ctx(rb)
    return int(build()["relax_project"].simtpu_relax_project_rows_per_sm(ctypes.byref(ctx)))


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
    candidate) row of `rb` (`relax_project_plan`): the projected-gradient
    step of rb.y in place, or in init mode its start point and rb.stuck.
    No synchronization."""
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
