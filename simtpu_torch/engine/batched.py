"""The scenario-batched step: K18 `sweep_drain` and K19 `sweep_place`.

The JAX package evaluates a whole chunk of what-if scenarios as one
vmapped program: per scenario a signed-delta scan drains the failed nodes'
pods from the shared base carry, then a `schedule_step` scan requeues them
against the scenario's surviving nodes (`simtpu/faults/sweep.py
_fault_sweep`); the batched capacity sweep is the same requeue over every
pod with no drain (`simtpu/parallel/sweep.py _sweep_scan`). Here the
scenario axis is a kernel's grid:

- K18 `sweep_drain` (`kernels/csrc/sweep_drain.cu`): block s copies the
  base carry into replica s of a `[S, ...]` state and applies row s of an
  `[S, E]` table of placement-log entries (-1 = padding) in log order,
  the arithmetic of K7 `delta_apply`. The base carry is only read.
- K19 `sweep_place` (`kernels/csrc/sweep_place.cu`): block s walks row s
  of an `[S, R]` table of batch rows (-1 = padding, which only trails)
  over replica s, the chain K1 -> (K5) -> (K6) -> K2 -> K3 -> K4 pod by
  pod, under row s of the `[S, N]` surviving-node masks, and writes the
  landing node and reason of entry j at output row j.

Each wrapper chooses by the device of its tensors: CPU tensors go to the
plain PyTorch version (the textbook `placement_delta_step` and
`schedule_step`, scenario by scenario), CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import cuda
from .scan import StaticArrays, StepBuffers, schedule_step
from .state import SchedState, placement_delta_step

#: the packed log's fields, in engine/state.py pack_delta_entries order
LOG_FIELDS = ("g", "node", "wgt", "req", "vg", "sd_take", "gp")
#: the pod arrays a StepBuffers holds for the whole batch
POD_FIELDS = ("group", "req", "pin", "forced", "lvm_size", "lvm_vg", "dev_size", "dev_media",
              "gpu_mem", "gpu_count", "gpu_preset", "ext_live")


def log_entries(eng, tensors) -> tuple:
    """The engine's whole placement log packed as eviction entries (w = -1)
    in `pack_delta_entries`' layout: group, node, weight, request [M, R],
    LVM allocation [M, V], devices taken [M, SD] and GPU shares times the
    per-GPU memory [M, GD] — the columns the JAX sweep gathers per
    scenario."""
    r = tensors.alloc.shape[1]
    ext = tensors.ext
    m = len(eng.placed_node)
    log = eng.ext_log
    return (
        np.asarray(eng.placed_group, np.int32).reshape(m),
        np.asarray(eng.placed_node, np.int32).reshape(m),
        np.full(m, -1.0, np.float32),
        eng.log_req_matrix(r),
        np.asarray(log["vg_alloc"], np.float32).reshape(m, ext.vg_cap.shape[1]),
        np.asarray(log["sdev_take"], bool).reshape(m, ext.sdev_cap.shape[1]),
        (np.asarray(log["gpu_shares"], np.float32).reshape(m, ext.gpu_dev_total.shape[1])
         * np.asarray(log["gpu_mem"], np.float32).reshape(m, 1)),
    )


def upload_log(entries, device) -> dict:
    """Packed entries as contiguous tensors on `device`, keyed LOG_FIELDS."""
    return {name: torch.as_tensor(np.ascontiguousarray(arr), device=device)
            for name, arr in zip(LOG_FIELDS, entries)}


def empty_log_like(state: SchedState) -> dict:
    """A log of no entries at `state`'s widths, on its device (the capacity
    sweep's drain, which is the broadcast alone)."""
    r, v = state.free.shape[1], state.vg_free.shape[1]
    sd, gd = state.sdev_free.shape[1], state.gpu_free.shape[1]
    return upload_log((np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32),
                       np.zeros((0, r), np.float32), np.zeros((0, v), np.float32),
                       np.zeros((0, sd), bool), np.zeros((0, gd), np.float32)), state.free.device)


def replicas(base: SchedState, s: int, fill: bool = False) -> SchedState:
    """Fresh [S, ...] planes shaped like `base`'s (copies of it with
    `fill`, else uninitialised)."""
    if fill:
        return SchedState(*(t.unsqueeze(0).repeat(s, *([1] * t.dim())).contiguous() for t in base))
    return SchedState(*(torch.empty((s,) + tuple(t.shape), dtype=t.dtype, device=t.device)
                        for t in base))


def replica(reps: SchedState, s: int) -> SchedState:
    """Replica s of a replicated state, as views (updates write through)."""
    return SchedState(*(t[s] for t in reps))


def sweep_drain_plain(statics: StaticArrays, base: SchedState, log: dict, idx: torch.Tensor) -> SchedState:
    """Plain version of K18: the base broadcast to S replicas, then row s of
    `idx`'s entries folded into replica s by `placement_delta_step`, in
    order (w = 0 rows are exact no-ops)."""
    cuda.count_plain("sweep_drain")
    s_n = idx.shape[0]
    reps = replicas(base, s_n, fill=True)
    rows = idx.cpu().numpy()
    for s in range(s_n):
        state = replica(reps, s)
        for e in rows[s]:
            if e < 0:
                break
            entry = tuple(log[f][int(e)] for f in LOG_FIELDS)
            if float(entry[2]) == 0.0:
                continue
            placement_delta_step(statics, state, entry)
    return reps


def sweep_drain(statics: StaticArrays, base: SchedState, log: dict, idx: torch.Tensor) -> SchedState:
    """K18 (`kernels/csrc/sweep_drain.cu`): S replicas of `base` ([S, ...]
    planes, fresh storage; `base` is only read), replica s drained by the
    log entries of row s of `idx` ([S, E] int32, -1 = trailing padding),
    in one launch for a state on the card; the plain version for one on
    the CPU."""
    if base.free.device.type == "cpu":
        return sweep_drain_plain(statics, base, log, idx)
    reps = replicas(base, idx.shape[0])
    cuda.launch_sweep_drain(statics, base, reps, log, idx)
    return reps


class SweepBuffers:
    """What K19 reads and writes for one chunk of S scenarios: the whole
    batch's pod arrays (from a StepBuffers of the batch), the statics, the
    replicated state (updated in place), the [S, N] surviving masks, the
    [S, R] batch rows, and per-scenario copies of K1-K6's scratch and of
    the per-pod outputs (row j = entry j of the scenario's list).

    `statics`, `state` and every scratch and output attribute are the
    views of scenario 0, which the kernel's argument block points at
    (`kernels/cuda.py make_ctx`); the `*_s` tensors are the whole planes."""

    def __init__(self, batch: StepBuffers, pods_host, statics: StaticArrays, reps: SchedState,
                 valid_s: torch.Tensor, rows: torch.Tensor):
        dev = batch.device
        s, cols = rows.shape
        n = statics.alloc.shape[0]
        v, sd = statics.vg_cap.shape[1], statics.sdev_cap.shape[1]
        gd = reps.gpu_free.shape[2]
        self.device = dev
        self.pods_host = pods_host
        self.flags = batch.flags
        self.flag_bits = batch.flag_bits
        self.n_pods = batch.n_pods
        for name in POD_FIELDS:
            setattr(self, name, getattr(batch, name))
        self.reps = reps
        self.valid_s = valid_s.contiguous()
        self.rows = rows.contiguous()
        self.base_statics = statics

        def z(*shape, dtype=torch.float32, fill=0):
            return torch.full((s,) + shape, fill, dtype=dtype, device=dev)

        self.stage_s = z(n, dtype=torch.uint8)
        self.raw_s = z(4, n)
        self.score_s = z(n)
        self.st_ok_s = z(n, dtype=torch.bool, fill=1)
        self.st_alloc_s = z(n, v)
        self.st_take_s = z(n, sd, dtype=torch.bool)
        self.st_raw_s = z(n)
        self.gpu_ok_s = z(n, dtype=torch.bool, fill=1)
        self.gpu_sh_s = z(n, gd)
        self.chosen_s = z(cols, dtype=torch.int32)
        self.placed_s = z(cols, dtype=torch.bool)
        self.reason_s = z(cols, dtype=torch.int32)
        self.out_node_s = z(cols, dtype=torch.int32, fill=-1)
        self.out_lvm_s = z(cols, v)
        self.out_take_s = z(cols, sd, dtype=torch.bool)
        self.out_gpu_s = z(cols, gd)
        # scenario 0's views: what the argument block points at
        self.statics = statics._replace(node_valid=self.valid_s[0])
        self.state = replica(reps, 0)
        for name in ("stage", "raw", "score", "st_ok", "st_alloc", "st_take", "st_raw", "gpu_ok",
                     "gpu_sh", "chosen", "placed", "reason", "out_node", "out_lvm", "out_take",
                     "out_gpu"):
            setattr(self, name, getattr(self, name + "_s")[0])
        self.ctx = None

    def outputs(self):
        """(nodes, reasons) [S, R] on the host: the landing node (-1 =
        unplaced or padding) and reason code of each list entry."""
        return (self.out_node_s.cpu().numpy().astype(np.int64),
                self.reason_s.cpu().numpy().astype(np.int32))


def sweep_place_plain(sb: SweepBuffers) -> None:
    """Plain version of K19: per scenario, `schedule_step` over its pod list
    on its replica under its surviving mask, to the first padded row."""
    cuda.count_plain("sweep_place")
    rows = sb.rows.cpu().numpy()
    valid = sb.valid_s
    host = sb.pods_host
    for s in range(rows.shape[0]):
        statics = sb.base_statics._replace(node_valid=valid[s])
        state = replica(sb.reps, s)
        for j, i in enumerate(rows[s]):
            if i < 0:
                break
            pod = (host[0][i], torch.as_tensor(host[1][i], device=sb.device)) + tuple(a[i] for a in host[2:])
            node, reason = schedule_step(statics, state, pod, sb.flags)
            sb.out_node_s[s, j] = node
            sb.reason_s[s, j] = reason


def sweep_place(sb: SweepBuffers) -> None:
    """K19 (`kernels/csrc/sweep_place.cu`) over every scenario of `sb`, in
    one launch for buffers on the card; the plain version on the CPU."""
    if sb.device.type == "cpu":
        sweep_place_plain(sb)
    else:
        cuda.launch_sweep_place(sb)
