"""Batched failure-scenario sweep: thousands of what-if outages at once.

The port of the JAX package's `simtpu/faults/sweep.py`. The serial oracle
(faults/drain.py) answers one scenario with three engine round-trips —
drain deltas, a requeue placement, the undo. Here the scenario axis is the
grid of two hand-written kernels (`engine/batched.py`):

1. per scenario, the DRAIN is the scenario's placement-log entries
   (original log order, w = -1) folded into its own replica of the shared
   base carry — K18 `sweep_drain`, one block per scenario, the arithmetic
   of K7 `delta_apply`, so drained states are bit-identical to the serial
   path's `remove_placements`;
2. the REQUEUE is the scenario's evicted pods (original placement order)
   placed on its replica against its surviving nodes — K19 `sweep_place`,
   one block per scenario, the per-pod chain K1 -> (K5) -> (K6) -> K2 ->
   K3 -> K4;
3. scenarios run in chunks of `s_chunk` (the JAX package's dense-byte
   budget, so the dispatch count is the same); `fault_sweep` launches K18
   then K19 once per chunk, the counterpart of the JAX `_fault_sweep` (on
   CPU tensors it runs their plain versions).

Padding is trailing: a scenario's entry and pod lists are padded with -1
to the chunk's widths (`e_pad`, `r_pad`, global over the sweep as in the
JAX package), and both kernels stop at the first padded row — in JAX the
padded delta rows are exact no-ops and the phantom pods come after every
real pod with their outputs masked on the host, so skipping them is exact.

Not ported: `mesh` and `pipeline` raise NotImplementedError (ROADMAP queue
1 #10), and the JAX package's OOM halving of a chunk (durable/backoff.py)
is absent: a CUDA out-of-memory error raises (queue 1 #8).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine import batched
from ..engine.scan import StepBuffers, build_pod_arrays, flags_from, statics_from
from ..engine.state import build_state, state_nbytes
from .drain import PlacedCluster, drain_requeue
from .scenarios import ScenarioSet


def fault_sweep(statics, valid_s, state, log: dict, ev_idx, batch_buf: StepBuffers, pods_host, rq_idx):
    """One chunk of scenarios: K18 drains replica s of the base carry
    `state` (only read) by the log entries of row s of `ev_idx`, then K19
    requeues the batch rows of row s of `rq_idx` on it under row s of
    `valid_s` (the SURVIVING-node masks), one launch each; the plain
    versions for inputs on the CPU. Returns (landing nodes, reasons)
    [S, R] on the host (-1 / 0 on padded rows)."""
    reps = batched.sweep_drain(statics, state, log, ev_idx)
    sb = batched.SweepBuffers(batch_buf, pods_host, statics, reps, valid_s, rq_idx)
    batched.sweep_place(sb)
    return sb.outputs()


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _state_bytes(state) -> int:
    # chunk sizing is keyed to the DENSE state's bytes even under the
    # compact carried layout: each scenario's replica is the dense [., N]
    # expansion, so dense bytes are what a replica costs on the device
    return sum(state_nbytes(state).values())


def _base_state(pc: PlacedCluster):
    """The base carry every scenario drains from. `place_cluster` leaves
    the engine's carried state valid; a dirtied engine (log surgery without
    a following place) rebuilds from the log the way Engine.place would.
    The carry is read through `Engine.carried_state` — a compact carry is
    expanded into fresh planes (K12), a dense one is the carry itself,
    which the sweep's kernels only read."""
    eng = pc.engine
    tensors = pc.tensors
    if (
        eng.last_state is not None
        and not eng._state_dirty
        and eng._last_vocab == eng.state_vocab(tensors)
    ):
        return eng.carried_state()
    r = tensors.alloc.shape[1]
    return build_state(
        tensors,
        np.asarray(eng.placed_group, np.int32),
        np.asarray(eng.placed_node, np.int32),
        eng.log_req_matrix(r),
        eng.ext_log,
        eng.device,
    )


@dataclass
class SweepResult:
    """Per-scenario outcomes of one batched sweep."""

    scenarios: ScenarioSet
    evicted: np.ndarray  # [S] pods drained off failed nodes
    lost: np.ndarray  # [S] forced pods that die with their node
    requeued: np.ndarray  # [S] requeue attempts (evicted - lost)
    unplaced: np.ndarray  # [S] requeued pods that found no surviving node
    requeue_rows: np.ndarray  # [S, Rq] batch rows (-1 padding)
    requeue_nodes: np.ndarray  # [S, Rq] landing nodes (-1 = unplaced)
    requeue_reasons: np.ndarray  # [S, Rq] failure codes
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def survived(self) -> np.ndarray:
        return self.unplaced == 0

    @property
    def survival_rate(self) -> float:
        s = len(self.scenarios)
        return float(self.survived.sum()) / s if s else 1.0

    def worst(self, top: int = 5) -> List[Tuple[str, int]]:
        """The `top` scenarios by unplaced-pod count (ties by index)."""
        order = np.argsort(-self.unplaced, kind="stable")[:top]
        return [
            (self.scenarios.labels[int(s)], int(self.unplaced[s]))
            for s in order
            if self.unplaced[s] > 0
        ]

    def critical_nodes(self, top: int = 10) -> List[Tuple[str, int]]:
        """For single-node scenarios: the nodes whose loss strands the most
        pods — the cluster's criticality ranking."""
        singles = [
            (self.scenarios.labels[s], int(self.unplaced[s]))
            for s in range(len(self.scenarios))
            if int(self.scenarios.masks[s].sum()) == 1
        ]
        singles.sort(key=lambda kv: -kv[1])
        return [(lbl.split(":", 1)[-1], n) for lbl, n in singles[:top] if n > 0]

    def counters(self) -> Dict[str, object]:
        """Machine-readable summary (CLI --json, bench)."""
        return {
            "scenarios": len(self.scenarios),
            "survived": int(self.survived.sum()),
            "survival_rate": round(self.survival_rate, 4),
            "evicted_total": int(self.evicted.sum()),
            "unplaced_max": int(self.unplaced.max()) if len(self.unplaced) else 0,
            "fault_scenarios_per_s": round(
                self.timings.get("scenarios_per_s", 0.0), 1
            ),
        }


def _chunk_default(state, n_scenarios: int) -> int:
    """Scenario rows per dispatch: bound the vmapped carry to ~256 MB of
    replicated state, clamped to [8, 128] and pow2 for shape stability."""
    per = max(_state_bytes(state), 1)
    budget = 256 << 20
    return int(min(128, max(8, _pow2(min(budget // per, n_scenarios) or 1))))


class SweepInputs:
    """Everything a sweep of `scenarios` over `pc` hands the kernels, built
    once: the statics, step flags and base carry on the engine's device,
    the whole placement log packed as eviction entries, the whole batch's
    pod arrays (host and device), and per scenario the placement-log
    entries on its failed nodes (`ev_lists`, log order), the batch rows
    that requeue (`rq_lists`: the evicted rows minus the pods that die with
    their node) and the count of those that die (`lost`). `e_pad` / `r_pad`
    are the pow2 widths over the whole sweep, as in the JAX package."""

    def __init__(self, pc: PlacedCluster, scenarios: ScenarioSet):
        eng = pc.engine
        tensors = pc.tensors
        n = pc.n_nodes
        if scenarios.n_nodes != n:
            raise ValueError(f"scenarios span {scenarios.n_nodes} nodes, cluster has {n}")
        self.device = eng.device
        self.flags = flags_from(tensors, pc.batch.ext)
        self.statics = statics_from(tensors, eng.sched_config, self.device)
        self.state = _base_state(pc)
        base_valid = np.ones(n, bool) if eng.node_valid is None else np.asarray(eng.node_valid, bool)
        self.base_valid = base_valid & self.statics.node_valid.cpu().numpy()
        self.masks = np.asarray(scenarios.masks, bool)
        log_nodes = np.asarray(eng.placed_node, np.int32)
        dies = pc.dies_with_node  # DS pods / nodeName pins die with their node
        self.ev_lists = [np.flatnonzero(m[log_nodes]) for m in self.masks]
        self.rq_lists = []
        self.lost = np.zeros(len(self.ev_lists), np.int64)
        for s, ev in enumerate(self.ev_lists):
            rows = pc.log_row[ev]  # log index -> batch row
            f = dies[rows]
            self.lost[s] = int(f.sum())
            self.rq_lists.append(rows[~f])
        self.e_pad = _pow2(max((len(v) for v in self.ev_lists), default=0) or 1)
        self.r_pad = _pow2(max((len(v) for v in self.rq_lists), default=0) or 1)
        # the kernels read rows of the whole log and the whole batch through
        # each scenario's index lists
        self.log = batched.upload_log(batched.log_entries(eng, tensors), self.device)
        _, self.pods = build_pod_arrays(pc.batch, tensors.alloc.shape[1])
        self.batch_buf = StepBuffers(self.statics, self.state, self.pods, self.flags)

    def chunk(self, s0: int, s1: int, sb: int):
        """Scenarios [s0, s1) as one chunk of `sb` rows (the rest empty,
        failure-free): (valid [sb, N], ev_idx [sb, E], rq_idx [sb, R]) on
        the device, -1 padding, and rq_idx on the host."""
        n = self.masks.shape[1]
        ev_idx = np.full((sb, self.e_pad), -1, np.int32)
        rq_idx = np.full((sb, self.r_pad), -1, np.int32)
        valid = np.ones((sb, n), bool) & self.base_valid[None, :]
        for j, s in enumerate(range(s0, s1)):
            ev_idx[j, : len(self.ev_lists[s])] = self.ev_lists[s]
            rq_idx[j, : len(self.rq_lists[s])] = self.rq_lists[s]
            valid[j] &= ~self.masks[s]
        dev = self.device
        return (torch.as_tensor(valid, device=dev), torch.as_tensor(ev_idx, device=dev),
                torch.as_tensor(rq_idx, device=dev), rq_idx)

    def run(self, valid, ev_idx, rq_idx):
        """`fault_sweep` on one chunk."""
        return fault_sweep(self.statics, valid, self.state, self.log, ev_idx, self.batch_buf, self.pods,
                           rq_idx)


def sweep_scenarios(
    pc: PlacedCluster,
    scenarios: ScenarioSet,
    s_chunk: Optional[int] = None,
    mesh=None,
    pipeline=None,
) -> SweepResult:
    """Evaluate every scenario's drain + requeue in chunks, K18 then K19
    once per chunk on the engine's device.

    Produces, for each scenario, the identical unplaced-pod set as the
    serial replay (`drain_requeue(pc, mask, restore=True)`). The engine
    itself is never touched: the base state is read once and only read,
    so the sweep composes with any engine (bulk, masked, a resilience
    candidate's `MaskedRoundsEngine`)."""
    for name, arg in (("mesh", mesh), ("pipeline", pipeline)):
        if arg is not None:
            raise NotImplementedError(f"sweep_scenarios({name}=...) is not ported (ROADMAP queue 1 #10)")
    t0 = time.perf_counter()
    inp = SweepInputs(pc, scenarios)
    s_total = len(scenarios)
    if s_chunk is None:
        s_chunk = _chunk_default(inp.state, s_total)
    timings = {"assemble_s": time.perf_counter() - t0, "sweep_s": 0.0}
    rq_rows = np.full((s_total, inp.r_pad), -1, np.int64)
    rq_nodes = np.full((s_total, inp.r_pad), -1, np.int64)
    rq_reasons = np.zeros((s_total, inp.r_pad), np.int32)
    t_sweep = 0.0
    for s0 in range(0, s_total, s_chunk):
        s1 = min(s0 + s_chunk, s_total)
        ta = time.perf_counter()
        valid, ev_idx, rq_dev, rq_idx = inp.chunk(s0, s1, s_chunk)
        timings["assemble_s"] += time.perf_counter() - ta
        td = time.perf_counter()
        nodes_b, reasons_b = inp.run(valid, ev_idx, rq_dev)
        t_sweep += time.perf_counter() - td
        keep = rq_idx[: s1 - s0] >= 0
        rq_rows[s0:s1] = rq_idx[: s1 - s0]
        rq_nodes[s0:s1] = np.where(keep, nodes_b[: s1 - s0], -1)
        rq_reasons[s0:s1] = np.where(keep, reasons_b[: s1 - s0], 0)
    timings["sweep_s"] = t_sweep
    timings["total_s"] = time.perf_counter() - t0
    timings["scenarios_per_s"] = s_total / t_sweep if t_sweep > 0 else 0.0
    timings["chunks"] = float(-(-s_total // s_chunk))

    evicted = np.asarray([len(v) for v in inp.ev_lists], np.int64)
    requeued = np.asarray([len(v) for v in inp.rq_lists], np.int64)
    unplaced = ((rq_nodes < 0) & (rq_rows >= 0)).sum(axis=1)
    return SweepResult(
        scenarios=scenarios,
        evicted=evicted,
        lost=inp.lost,
        requeued=requeued,
        unplaced=unplaced.astype(np.int64),
        requeue_rows=rq_rows,
        requeue_nodes=rq_nodes,
        requeue_reasons=rq_reasons,
        timings=timings,
    )


def serial_replay(
    pc: PlacedCluster,
    scenarios: ScenarioSet,
    limit: Optional[int] = None,
):
    """The serial oracle: drain + requeue + restore per scenario through
    the engine path (`faults/drain.py`).  Returns (unplaced counts,
    per-scenario unplaced batch-row sets) for the first `limit` scenarios —
    the floor the batched sweep is benchmarked (and pinned) against."""
    s_n = len(scenarios) if limit is None else min(limit, len(scenarios))
    counts = np.zeros(s_n, np.int64)
    row_sets = []
    for s in range(s_n):
        res = drain_requeue(pc, scenarios.masks[s], restore=True)
        counts[s] = res.unplaced
        row_sets.append(frozenset(int(x) for x in res.unplaced_rows))
    return counts, row_sets
