#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (simtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

(`--parent DIR`: a `git archive` of an earlier tree, whose K7 and K11
phase 22 builds and times in turns against this tree's.)

Phases (each failure ends the run with a non-zero exit; none is caught):

1. the card's name and power limit (nvidia-smi); build the twenty-five CUDA
   kernels from `simtpu_torch/kernels/csrc/` and the profile build of K9,
   K10 and K14-K16 (nvcc, sm_90a, one process per source, all at once);
2. each kernel against its plain PyTorch version on the card, pod by pod:
   K1-K4 on the tensorized serial smoke problem (1000 nodes x 10 000 pods,
   a seeded placement log) and a small edge problem; K1-K6 on the
   tensorized extended problem with the storage and GPU flags live, on a
   sample of storage, multi-claim, device, GPU, multi-GPU and preset pods
   (stage bits, plans, scores, argmax, reason, state planes and per-pod
   allocations must be equal); K7 on a seeded set of eviction entries
   (w = -1, then the same entries with w = +1: every state plane equal to
   the plain version's after each, and back to the state before the
   eviction); K8 on the placement logs of the fixtures of
   `simtpu_torch/audit/fuzz.py` run on the card — clean, with the optional
   families cut to width 0, under every mutation class and every bulk
   corruption (forced and pinned entries, an exact fill included): the flag
   words must be equal. K9 and K10 (the wave kernels) on runs of the wave
   plans of the serial smoke and extended problems — a lean run, one with
   the inter-pod preference carry, a hard-spread run, a required
   anti-affinity run, a storage run, a GPU run — on the rack problem's
   runs (a key of 400 small domains) and on the keys problem's runs (22
   topology keys: lean, preference and hard-spread runs) and, above 1024
   nodes, on the serial smoke workload at 2000, 3000 and 6000 nodes (two
   and three nodes per thread in registers, then the carried rows in
   global memory: lean, preference and hard-spread runs), the pods
   between the runs through K1-K6: nodes, reasons, plans and every
   state plane equal to the plain versions'. K11 and K12 (the compact
   carried state's compression and expansion) on the states those wave
   runs left on the serial smoke, extended, rack and keys problems: every
   compact field equal to the plain version's, the expansion equal to the
   state compressed (state_diff 0) and sharing no storage with the carry;
   K13 (the direct compact delta) on K7's eviction and restore batches:
   equal to its plain version and to the expand -> K7 -> compress route
   after each, the round trip back to the carry bit for bit. Then each
   kernel's time per launch, its plain version's and the bytes bound, and
   the device time per kernel (torch.profiler), K9/K10 per launch and per
   pod step; then K9/K10's step phase by phase on the 50-pod lean,
   preference, hard-spread, required anti-affinity and storage runs: the
   main build's time per launch and per pod step (CUDA events), the
   profile build's (`cuda.build_profile`: the same sources with
   clock64() stamps around each phase, never the main path's build)
   cycles per phase per step, the barriers per step and their floor (the
   measured cost of one block barrier at the block's size), ptxas'
   registers and spills per template instance and path of K9, K10,
   K14-K16, K18, K19 and K23;
3. the serial main path: `simtpu_torch.simulate(device="cuda")` on the
   serial smoke problem, the speculative wavefront and the compact carry
   on (the defaults). K9 and K10 must have launched once per wave of the
   batches' wave plans, K1-K4 once per pod outside the waves, K11/K12/K13
   exactly as often as the JAX package's state.compress / state.expand /
   state.delta_direct counters on the same path (smoke.COMPACT_CARRY), the
   carried-state gauge must equal the JAX package's, no plain version may
   have run, and the record (placements, reasons, preempted pods,
   annotations) must equal the golden file the JAX package produced on the
   CPU;
3b. the extended main path: the same on the extended problem (Open-Local
   storage, GPU-share, a priority tier that preempts), against its golden
   file. K9/K10 once per planned wave, K1-K4 once per pod step outside the
   waves (preemptor retries included), K5 once per storage-pod step and K6
   once per GPU-pod step outside the waves (counted on the host from the
   batches), K11/K12/K13 as the JAX counters (K13 at least once: the
   preemption deltas go straight into the compact carry) and K7 never; no
   plain version may have run;
3d. the serial and extended main paths once more in the JAX package's
   serial-exact engine configuration, the wavefront and the compact carry
   off (`Engine.speculate = Engine.compact = False`): the same golden
   records, K1-K4 once per pod step, no wave and no K11-K13 launched, K7
   at least once on the extended path — the end-to-end reading beside
   phase 3's;
3c. K8 against its plain version on the placement logs of phases 3 and 3b,
   clean and under the same corruptions;
4. the demo example (examples/cluster/demo + application/web): every pod
   placed, as on the CPU path;
4b. the gpushare example (examples/cluster/gpushare + application/
   gpushare) and the local-storage example (examples/cluster/demo +
   application/local-storage): every pod placed, as on the CPU path;
4c. the three example configs through the `apply` front door
   (`simtpu_torch.cli apply`, `-e gpu` / `-e open-local` as
   tests/test_examples.py runs them) on the card and on the CPU path: the
   same exit code and report text, apart from the timing and engine lines;
5. the capacity main path: the capacity problem (smoke.py: 900 nodes, the
   serial smoke mix plus a burst app, a 64-core template) written as a
   simon Config and planned by `Applier.run` on the card. The plan — count,
   probes, the winning candidate's placements, reasons and annotations, a
   clean audit — must equal the golden record the JAX package produced; K8
   must have launched once per candidate, K9/K10 once per planned wave,
   K1-K4 once per pod step outside the waves of every candidate and
   K11/K12 as the JAX package's counters on the same plan. Prints the
   plan's wall, each candidate's wall, the audit's split (upload, K8, host
   interpod/spread checks), and one candidate (the winner) simulated again
   with its wall split on the host around the port's own functions
   (expansion and sorting, tensorize, statics and state, the place loop,
   K11/K12, results and annotations, the audit);
5b. the divergence fallback: a cut of the capacity problem planned clean
   and with the audit's view corrupted (`_audit_inject`): the injected plan
   ships the certified re-run, with the clean plan's count, and the re-run
   places with the wavefront off (no wave pod) while the primary
   candidates ran waves;
6. the bulk main path: `simulate(bulk=True, device="cuda")` on the bulk
   problem (smoke.py: 5000 nodes x 150 000 pods, bench.py's "hard" mix)
   under the profiler, with every count set to 0 just before. The record
   (per-node counts, per-reason counts, digests of every placement and of
   the annotations) must equal the golden file; K14-K16 must have launched
   once per round of the JAX segment plan (149), K3/K4 once per serial pod
   step outside the waves and per leftover probe, K1/K2 once per such step
   and once per round, K5/K6 once per storage / GPU step or round, K9/K10
   once per planned wave, K11/K12 as the JAX package's compact-carry
   counters (smoke.COMPACT_CARRY); no plain version. Prints the wall,
   pods/s, the rounds and their device share; then K14, K15 and K16 phase
   by phase at the bulk problem's first plain, quota-spread and quota-anti
   rounds and K14 / K16 at the matrix cut's first `bulkm` round (the main
   build's time per launch, CUDA events; the profile build's clock64()
   cycles per phase, `cuda.launch_round_profile`, never the main path's
   build);
7. the large capacity problem (smoke.py: 2000 nodes, 43 300 pods) written
   as a simon Config and planned by `Applier.run` on the card: the auto-
   selection must print the JAX package's notice (bulk + incremental), the
   plan (38 nodes, the probes, the verify, a clean audit, the winner's
   record) must equal the golden record, K17 must have launched once per
   probe's snapshot copy, K11/K12 as the JAX package's counters, and no
   plain version may run. Prints the plan's phase timings.
8. the fault sweep's main path: the serial smoke problem written as a
   simon Config, `simtpu_torch.cli resilience --faults zone --json` (bulk
   placement, the audit and its serial-exact fallback, 16 zone outages),
   then a k=1 sweep (1000 scenarios) over the same PlacedCluster: the CLI
   document (without timings), the per-scenario counts and the digests of
   every requeue row, landing node and reason must equal the golden record
   the JAX package produced; K18 and K19 once per chunk of each sweep, no
   plain version. Prints scenarios/s, the chunk count and K18/K19's
   device share;
9. `place_cluster` + a k=2:256 sweep on the bulk problem (5000 nodes x
   150 000 pods): the base placement's digest and the sweep record equal
   to the golden record, K18/K19 once per chunk, the engine's carry
   unchanged by the sweep;
10. `plan_capacity_batched` on the capacity problem (all 100 candidates in
   one K18 + K19 pair): the count and the winner's record equal the
   capacity golden record (43 nodes), the failures at six candidates the
   JAX package's batched sweep's;
11. `simtpu_torch.cli resilience --plan --faults k=2:64 --seed 0 --json` on
   the capacity problem's config: the plan document equal to the golden
   record (count, probes, the winner's sweep counters and worst list, the
   audit with its fallback), K18/K19 once per candidate sweep;
12. decision observability against `tests/data/torch_explain.json.gz`,
   each path with every count set to 0 just before and read just after:
   (a) `simulate(explain=True, device="cuda")` on the extended problem
   (521 unscheduled pods explained; K20 once per chunk of 64 runnable
   unplaced pods, K12 as the carry is read), (b) `build_explain_doc` over
   every unplaced pod of phase 9's bulk placement (the document and the
   per-pod counts, feasible counts, witnesses and fail codes), (c) `cli
   explain --scores 8 --json --no-bulk` on the serial smoke config (K21
   once per attributed pod, every attribution consistent; margins and
   terms to the stated tolerances), (d) `plan_capacity(max_new_nodes=20,
   explain=True)` on the capacity problem, which fails and carries the
   block; no plain version on any of them. Then K20 against its plain
   version on the first chunk of (a) and of (b), K21 against its plain
   version (and its score against K3's) on each of (c)'s pods, and their
   times; each path's explain wall split into the device pass and the host
   assembly;
13. `cli fuzz --cases 4 --json` (every case bit-identical across the
   wavefront / compact / both cells and audit-clean, K8 once per audit)
   and `cli fuzz --mutation-kill --json` against the golden counters;
14. the solver paths, each with the counts zeroed just before, against
   `tests/data/torch_solve.json.gz` (the JAX package's, on the CPU): (a)
   `cli apply --solver --json` on the capacity problem's config (the
   consult rejected at k = 0 after the fallback, then the exact search),
   (b) the same on the large capacity problem's (accepted at k = 0), (c)
   `cli resilience --plan --faults k=2:64 --seed 0 --solver --json` on the
   capacity config (the relax-only lower bound): each document without
   timings and `wall_s` equal, the relaxation's per-candidate residuals
   and the fetched y to smoke.SOLVE_RES_ATOL / SOLVE_Y_ATOL with the
   feasible sets equal, the rounded counts and the shipped plan exactly;
   K22 and K23 iters + 1 times per relaxation, no plain version; the relax
   wall and the rounding / audit / fallback split beside phases 5, 7 and
   11's solver-off walls;
15. the grow problem (`smoke.run_grow`: the serial smoke problem's pods in
   four waves, two template clones before the last) on
   `Engine(device="cuda")` in grow mode, counts zeroed just before: the
   placements per wave and digests of every final plane equal to
   `tests/data/torch_grow.json.gz` and to a non-grow engine's run on the
   card, the grow counts equal the JAX package's, K24 once on entry and
   once per term extension, K25 once per node growth, no K11/K12 and no
   plain version;
16. the wide problem (`smoke.wide_problem`: a node with 40 GPU devices,
   one with 36 VGs and 36 SSDs, pods that reach past index 32 on each
   axis) on the card against the CPU path, each with every count set to 0
   just before: simulate with the wavefront on (K9/K10) and off (K1-K6),
   simulate(bulk=True) (K14-K16), place_cluster + a k=1 sweep (K18/K19),
   simulate(explain=True) (K20) and `cli explain --scores 4` (K21): every
   record equal to the CPU path's, each of those kernels launched, no
   plain version on the card;
18. K18 past the 4096 topology keys its packed sort keys held: the
   many-keys problem (`smoke.many_keys_problem`, 4100 keys every node
   carries, Tc = 64 a group) placed on the card, 16 single-node scenarios
   on the nodes whose pods own the highest key ids: K18 and K19 equal to
   their plain versions, the keys and K18's staging plan printed; K8
   equal to its plain version on phase 7's large-capacity winner's log
   and on seeded 150 000-entry logs of the bulk problem's pods on its 5000
   nodes (seeded nodes, every entry on one node, half of them on one
   node), each one's device time (the sum of its kernels) and the kernels
   a launch the profiler saw, held against `cuda.audit_plan`, and the
   seeded log's prefixes; K3 equal to its plain version (the score row bit
   for bit, chosen, placed, reason, out_node) at N = 120, 943, 1000, 2000,
   3001, 5000 and 9000 on the serial mix, custom score weights, forced
   and pinned pods and the extended mix (storage and GPU pods), its
   device time at each N, and up to 1024 nodes its global path equal to
   and timed in turns against its register path;
19. K2 and K4 against their plain versions, bit for bit, on phase 18's
   cases at N = 120 ... 9000 (K2 on its plan — up to 1024 nodes a plain
   launch of blocks of 256 nodes, each block taking the hard-spread minima
   over every node itself, past that a thread-block cluster — and on every
   plan of its sweeps, `k2_plans`; the stage bytes and the four raw rows;
   then every state plane and the pod's output rows after K4) and on the
   terms problem at Tc = 512 and 1024 (K2 also with every scratch segment
   in the global slab: one block, a cluster, a plain launch of four); per N
   on a serial pod K2's and K4's device time (profiler), host time per
   back-to-back launch, plain time and bound, and at N = 1000, 2000, 3001,
   5000 and 9000 K2's device time on each plan of its sweep, on a pod with
   a hard-spread column and on one without (the sweeps behind
   `cuda.TOPO_SMALL_NODES` and `cuda.TOPO_NODES_PER_BLOCK`);
20. K1 and K5 against their plain versions, bit for bit, at N = 120,
   1000, 2000, 5000 and 9000: K1 (the stage bytes) on phase 18's serial
   and forced cases (pods pinned to a node and to no node, forced) and on
   two edge states of the serial case (every flag on, seeded ports, volume
   and attach rows within and past K1's register template, a
   volume-binding mask: each stage failing first somewhere), K1 and K5
   (st_ok, st_alloc, st_take, st_raw) on the extended case and on a tight
   state of it (VGs cut, devices taken); K1 on the edge batch and its edge
   state; K5 on the wide problem (V = SD = 36) — each on the wrapper's
   plan (`cuda.filter_plan`, `cuda.storage_plan`) and on every plan of its
   sweep (K1 by threads, K5 by threads x template); per N K1's device time
   at a serial pod and K5's at an extended storage pod (profiler), host
   time per back-to-back launch, plain time and bound; K1's sweep at each
   N and K5's at N = 1000 and 5000 and on the wide problem (device time
   per launch, the variants launched in turns in one profiler window);
21. K6 and K13 against their plain versions, bit for bit: K6 (gpu_ok,
   gpu_sh) at N = 120 ... 9000 on the extended case's GPU pods and on
   seeded GPU states of GD = 1, 2, 4, 5, 8, 9 and 40 (one-GPU pods on a
   grid of free memory, multi-GPU stacking, preset rows, missing devices,
   requests past every device, a count of 0) and on the wide problem (GD
   = 40), each on its launch plan (`cuda.gpu_plan`) and every plan of its
   sweep (threads x template); K13 (every compact field) on 200- and
   2000-entry batches of phase 2's extended run evicted and restored, on
   the extended carry and on its tabular-only and dense-only variants,
   and on the terms problem at Tc = 512, each on its launch plan
   (`cuda.compact_delta_plan`) and every plan of its sweep (the plain
   version on CPU copies of the inputs); per N K6's device / host / plain
   time and bound, its sweep at N = 1000 and 5000 (also at GD = 9 and 40)
   and on the wide problem; K13's device time by kernel, host time, bound
   and its sweep.
22. K7 and K11 against their plain versions, bit for bit: K7 (every state
   plane, evicted then restored) on phase 2's 200-entry batch and a
   2000-entry batch of its extended run, on that state's hostname-only
   variant (every key a per-node key) at 2000 entries, on its region
   variant (each zone key one domain of all its nodes, the per-node keys
   kept) at 1000 entries, with integer preference weights (1-100: the
   atomic path of the preference planes), with those weights and
   preference planes past `cuda.pref_mode`'s bound and with fractional
   weights (the log-order path), the integer cases back to the state
   before, each on its launch plan (`cuda.compact_delta_plan`, a thread
   per node of each pair's domain: `cuda.pair_starts`) and every plan of
   its sweep (the plain version on CPU copies); K11 (every
   compact field, the narrowed planes aligned and apart) on the serial
   and extended carries of phase 2, the capacity winner's, the bulk
   problem's and a 1001-node serial cut (N % 4 != 0), on its task plan
   (`cuda.compress_plan`) and at 1 and 3 times its tiles; K7's device
   time by kernel, host time and bound at 200 and 2000 entries and on the
   region batch, K11's at
   the serial and bulk carries; with `--parent DIR` the parent's K7 and
   K11 paths equal to this tree's and timed in turns (`vs_parent`: device
   µs in one profiler window, host µs in seven turns).
Phase 2 also holds K14-K16 against their plain versions on rounds of the
bulk problem (plain, storage, quota-spread with t*'s 16 zones — K15's
one-warp ladder — and quota-anti with its 5000 hostnames), of the matrix
cut (2000 x 20 000, bench.py's "matrix" mix: multi-GPU, self-affinity and
GPU rounds) and of the bulk mix at 9000 nodes x 20 000 pods (plain,
quota-spread, quota-anti: K15's nodes re-read from global memory, its
ranking buffers in RoundCtx.iscr), of the large capacity problem (its
first plain round, N = 2000) and at 3001 and 120 nodes (K14/K16's
cluster with a ragged last tile, and one block), each from the state the
earlier rounds left, printing the K14/K16 plan each takes; K14 and K16 on
clusters of 1, 2, 4, 8 and 16 blocks at the bulk plain and quota-spread,
matrix `bulkm`, 9000-, 3001- and 120-node plain rounds (bit for bit, then
each block count's time in turns: the sweep behind
`cuda.ROUND_NODES_PER_BLOCK`); K17 on the bulk carry, dense and compact;
then their times at named rounds (the bulk plain, quota-spread and
quota-anti rounds, the matrix round and the large capacity problem's
plain round). And
K18/K19 against their plain versions on the extended problem's
`place_cluster` (a chunk of 16 single-node scenarios and one of 4 zone
outages, storage and GPU pods in the requeue) and on 16 single-node
scenarios of the extended mix at 2000 and at 3000 nodes (K19's two- and
four-nodes-per-thread templates): every replica plane, nodes and reasons;
K18 alone on the extended mix at 999 nodes (tiles and plane parts
ragged): 16 scenarios, S = 1, and the broadcast alone on that carry and
the extended one (no entry column, padding columns only), the u8
sdev_free plane among the planes; then their times (K19 per launch and
per pod step of each chunk, K18 per launch beside its bytes bound and the
copy-only yardstick `replicas(fill=True)`, CUDA events; phases 8 and 9
hold the k=1 chunk (128 x 1000) and the bulk chunk (32 x 5000, the step
rows in global memory) the same way, and phases 8-11 time every K19
launch of their main paths). And K22/K23 against their plain versions on
the relaxations of the capacity and the large capacity problems (100
candidates, 400 iterations; the start point and the first 5 iterations
step by step, y equal, then y and the residual to the stated tolerances
and the feasible sets equal), K23 at each boundary of its launch plan
(N = 1024, 1025, 4096, 4097, 16 384: the register path's keys per
thread, the shared-memory path) and on rows of ties, -0.0 beside +0.0,
a = 0 and all masked (N = 999, 2099, 5000, 20 000), equal; K23's
wide-row path (rows past shared memory at N = 20 000: a persistent grid
of global scratch slabs) against its plain version exactly at the start
point and 5 steps; K23's time per launch at both relaxations and its
rows resident per SM; K24/K25
against theirs on every growth of
the grow problem's carry (entry, extension, promotions, node growth), bit
for bit; then their times.
Last, K8's time at the capacity winner's log (device time and kernels a
launch from the profiler, back-to-back launches from Python, the plain
version's).

The line before the last is the JSON `{"kernels": [...], "plans": {...}}`
(`plans`: the launch plans of phases 18's to 22's shapes, the wrappers' choices
beside the run's readings); the last line is
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
no CUDA device is available.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import ctypes
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import simtpu_torch
import simtpu_torch.api as tapi
from simtpu_torch.api import Simulator
from simtpu_torch import smoke, synth
from simtpu_torch import cli as tcli
from simtpu_torch.audit import checker, fuzz
from simtpu_torch.constants import LABEL_APP_NAME
from simtpu_torch.core.objects import set_label
from simtpu_torch.core.tensorize import Tensorizer
from simtpu_torch.device import configure_numerics
from simtpu_torch.engine import rounds, scan
from simtpu_torch.engine import batched, wavefront
from simtpu_torch.engine import state as sstate
from simtpu_torch.explain import breakdown as tbd
from simtpu_torch.explain import scores as tscores
from simtpu_torch.io.cluster import create_cluster_resource_from_cluster_config
from simtpu_torch.io.yaml_loader import load_resources
from simtpu_torch.kernels import audit as kaudit
from simtpu_torch.kernels import cuda
from simtpu_torch import faults as tfaults
from simtpu_torch.faults import sweep as tsweep
from simtpu_torch.parallel import sweep as tpsweep
from simtpu_torch.plan import capacity as tcap
from simtpu_torch.plan import incremental as tinc
from simtpu_torch.plan import resilience as tresil
from simtpu_torch.plan.capacity import Applier, ApplierOptions, plan_capacity
from simtpu_torch.solve import planner as tplanner
from simtpu_torch.solve import relax as trelax
from simtpu_torch.synth import make_deployment, synth_apps, synth_cluster
from simtpu_torch.workloads.expand import get_valid_pods_exclude_daemonset, seed_name_hashes

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
KERNELS = {
    # name: (the JAX function it replaces, file:line)
    "filter_pod": "simtpu/engine/scan.py:765",
    "topology_pod": "simtpu/engine/scan.py:898",
    "score_argmax_pod": "simtpu/engine/scan.py:595",
    "commit_pod": "simtpu/engine/scan.py:1059",
    "storage_pod": "simtpu/kernels/storage.py:25",
    "gpu_pod": "simtpu/kernels/gpushare.py:25",
    "delta_apply": "simtpu/engine/state.py:339",
    "audit_bulk": "simtpu/audit/checker.py:388",
    "wave_lean": "simtpu/engine/scan.py:2422",
    "wave_hard": "simtpu/engine/scan.py:2035",
    "compact_compress": "simtpu/engine/state.py:1027",
    "compact_expand": "simtpu/engine/state.py:1061",
    "compact_delta": "simtpu/engine/state.py:1205",
    "round_score": "simtpu/engine/rounds.py:363",
    "round_pick": "simtpu/engine/rounds.py:525",
    "round_commit": "simtpu/engine/rounds.py:565",
    "carry_copy": "simtpu/plan/incremental.py:119",
    "sweep_drain": "simtpu/faults/sweep.py:61",
    "sweep_place": "simtpu/faults/sweep.py:61",
    "explain_pass": "simtpu/explain/breakdown.py:94",
    "pod_terms": "simtpu/explain/scores.py:95",
    "relax_load": "simtpu/solve/relax.py:218",
    "relax_project": "simtpu/solve/relax.py:200",
    "grow_terms": "simtpu/engine/state.py:543",
    "grow_nodes": "simtpu/engine/state.py:585",
}
RELAX_KERNELS = ("relax_load", "relax_project")
GROW_KERNELS = ("grow_terms", "grow_nodes")
EXPLAIN_KERNELS = ("explain_pass", "pod_terms")
SWEEP_KERNELS = ("sweep_drain", "sweep_place")
#: requeue rows per scenario in phase 9's comparison (the plain K19's time
#: grows with rows, not with N)
BULK_COMPARE_ROWS = 8
ROUND_KERNELS = ("round_score", "round_pick", "round_commit")
#: the K1/K2/K5/K6 scratch a round's K14 reads
ROUND_SCRATCH = ("stage", "raw", "st_ok", "st_alloc", "st_take", "st_raw", "gpu_ok", "gpu_sh")
FP32_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet)
WAVES = ("wave_lean", "wave_hard")
COMPACT = ("compact_compress", "compact_expand", "compact_delta")
#: the JAX package's counter behind each compact kernel
COMPACT_COUNTER = {"compact_compress": "compress", "compact_expand": "expand",
                   "compact_delta": "delta_direct"}
STEP = ("filter_pod", "topology_pod", "score_argmax_pod", "commit_pod")
WRAPPERS = {
    "filter_pod": (scan.filter_pod, scan.filter_pod_plain),
    "topology_pod": (scan.topology_pod, scan.topology_pod_plain),
    "score_argmax_pod": (scan.score_argmax_pod, scan.score_argmax_pod_plain),
    "commit_pod": (scan.commit_pod, scan.commit_pod_plain),
    "storage_pod": (scan.storage_pod, scan.storage_pod_plain),
    "gpu_pod": (scan.gpu_pod, scan.gpu_pod_plain),
}
N_SAMPLE = 48


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _pod(name: str, **spec) -> dict:
    body = {"containers": [{"name": "c", "image": "x",
                            "resources": {"requests": {"cpu": "100m", "memory": "64Mi"}}}]}
    body.update(spec)
    return {"apiVersion": "v1", "kind": "Pod", "spec": body,
            "metadata": {"name": name, "namespace": "edge", "labels": {"app": name}}}


def tensorized_batch(cluster, apps, device, log_len: int):
    """A problem tensorized (app pods only), its statics, and a state rebuilt
    from a seeded placement log of `log_len` entries, on `device`."""
    seed_name_hashes(smoke.NAME_SEED)
    pods = []
    for app in apps:
        for pod in get_valid_pods_exclude_daemonset(app.resource):
            set_label(pod, LABEL_APP_NAME, app.name)
            pods.append(pod)
    seed_name_hashes(None)
    tz = Tensorizer(cluster.nodes, storage_classes=list(cluster.storage_classes))
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, pod_arrays = scan.build_pod_arrays(batch, tensors.alloc.shape[1])
    rng = np.random.default_rng(7)
    k = log_len
    log_g = rng.integers(0, len(tensors.groups), k).astype(np.int32)
    log_n = rng.integers(0, tensors.n_nodes, k).astype(np.int32)
    log_r = pod_arrays[1][rng.integers(0, len(pod_arrays[0]), k)]
    state = sstate.build_state(tensors, log_g, log_n, log_r, None, device)
    statics = scan.statics_from(tensors, None, device)
    return tensors, batch, statics, state, pod_arrays


def smoke_batch(device):
    """The smoke problem (1000 nodes x 10 000 pods), 3000 logged placements."""
    return tensorized_batch(*smoke.smoke_problem(synth_cluster, synth_apps), device, 3000)


def extended_batch(device):
    """The extended problem (1000 nodes x 10 950 pods) plus a deployment
    with a preset GPU assignment, 3000 logged placements."""
    cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource,
                                           simtpu_torch.ResourceTypes)
    preset = simtpu_torch.ResourceTypes(deployments=[
        make_deployment("preset", 20, 500, 512, gpu_mem_mib=4096, gpu_count=2, gpu_index="0-1")])
    return tensorized_batch(cluster, apps + [simtpu_torch.AppResource(name="preset", resource=preset)],
                            device, 3000)


def edge_batch(device):
    """A small problem that reaches the kernels' other stages: host ports,
    exclusive volumes, a pod forced onto a missing node, an impossible node
    selector, hard spread and anti-affinity on 12 tainted nodes."""
    cluster = synth_cluster(12, seed=5, zones=3, taint_frac=0.3)
    apps = synth_apps(120, seed=6, zones=3, pods_per_deployment=30, selector_frac=0.3,
                      toleration_frac=0.2, anti_affinity_frac=0.4, anti_affinity_hard_frac=0.6,
                      spread_frac=0.5, spread_hard_frac=0.7)
    edge = simtpu_torch.ResourceTypes(
        deployments=[make_deployment("hostport", 10, 200, 128, host_port=9000)],
        pods=[_pod("ghost", nodeName="no-such-node"),
              _pod("nowhere", nodeSelector={"disktype": "unobtainium"})]
        + [_pod(f"disk-{k}", volumes=[{"name": "d", "gcePersistentDisk": {"pdName": f"pd-{k % 2}"}}])
           for k in range(12)],
    )
    return tensorized_batch(cluster, apps + [simtpu_torch.AppResource(name="edge", resource=edge)],
                            device, 40)


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def copy_state(dst, src):
    for a, b in zip(dst, src):
        a.copy_(b)


def tensor_diff(a, b) -> float:
    if not a.numel():
        return 0.0
    if a.dtype in (torch.bool, torch.uint8):
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max())


def state_diff(a, b) -> float:
    return max(tensor_diff(x, y) for x, y in zip(a, b))


def score_diff(a, b) -> float:
    fin = torch.isfinite(a)
    if not torch.equal(fin, torch.isfinite(b)) or not torch.equal(a[~fin], b[~fin]):
        raise AssertionError("score_argmax_pod: -inf lanes differ from the plain version")
    return float((a[fin].double() - b[fin].double()).abs().max()) if fin.any() else 0.0


def phase_compare(statics, state, pods, flags, sample, err):
    """Each kernel against its plain version on identical inputs, pod by
    pod along `sample` (batch indices, ascending); `err` collects the
    largest difference per kernel. Returns the kernel side's buffers."""
    kbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    pbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    for i in map(int, sample):
        copy_state(pbuf.state, kbuf.state)
        scan.filter_pod(kbuf, i)
        scan.filter_pod_plain(pbuf, i)
        torch.cuda.synchronize()
        if not torch.equal(kbuf.stage & 0x3F, pbuf.stage & 0x3F):
            raise AssertionError(f"filter_pod: stage bits differ at pod {i}")
        for name, live, fields in (("storage_pod", kbuf.storage_live, ("st_ok", "st_alloc", "st_take", "st_raw")),
                                   ("gpu_pod", kbuf.gpu_live, ("gpu_ok", "gpu_sh"))):
            if not live[i]:
                continue
            WRAPPERS[name][0](kbuf, i)
            WRAPPERS[name][1](pbuf, i)
            torch.cuda.synchronize()
            for field in fields:
                err[name] = max(err[name], tensor_diff(getattr(kbuf, field), getattr(pbuf, field)))
            if err[name]:
                raise AssertionError(f"{name}: plan differs from the plain version at pod {i}")
        scan.topology_pod(kbuf, i)
        scan.topology_pod_plain(pbuf, i)
        torch.cuda.synchronize()
        if not torch.equal(kbuf.stage, pbuf.stage):
            raise AssertionError(f"topology_pod: stage bits differ at pod {i}")
        err["topology_pod"] = max(err["topology_pod"], float((kbuf.raw - pbuf.raw).abs().max()))
        scan.score_argmax_pod(kbuf, i)
        scan.score_argmax_pod_plain(pbuf, i)
        torch.cuda.synchronize()
        for field in ("chosen", "placed", "reason", "out_node"):
            if getattr(kbuf, field)[i] != getattr(pbuf, field)[i]:
                raise AssertionError(f"score_argmax_pod: {field} differs at pod {i}")
        err["score_argmax_pod"] = max(err["score_argmax_pod"], score_diff(kbuf.score, pbuf.score))
        scan.commit_pod(kbuf, i)
        scan.commit_pod_plain(pbuf, i)
        torch.cuda.synchronize()
        err["commit_pod"] = max(err["commit_pod"], state_diff(kbuf.state, pbuf.state),
                                *(tensor_diff(getattr(kbuf, f)[i], getattr(pbuf, f)[i])
                                  for f in ("out_lvm", "out_take", "out_gpu")))
    if err["commit_pod"] or err["topology_pod"]:
        raise AssertionError(f"state or raw counts differ from the plain versions: {err}")
    return kbuf


def extended_sample(kbuf, rng, per_kind: int = 8):
    """Batch indices of storage pods (several LVM claims, exclusive
    devices), GPU pods (one GPU, several, a preset assignment) and plain
    pods, ascending."""
    lvm = kbuf.lvm_size.cpu().numpy()
    dev = kbuf.dev_size.cpu().numpy()
    count = kbuf.gpu_count.cpu().numpy()
    preset = kbuf.gpu_preset.cpu().numpy().sum(axis=1) > 0
    gpu = kbuf.gpu_live
    kinds = {
        "multi-claim": (lvm > 0).sum(axis=1) >= 2,
        "one-claim": (lvm > 0).sum(axis=1) == 1,
        "device": (dev > 0).any(axis=1),
        "one-gpu": gpu & (count == 1),
        "multi-gpu": gpu & (count >= 2) & ~preset,
        "preset": gpu & preset,
        "plain": ~(kbuf.storage_live | gpu),
    }
    picks = []
    for name, mask in kinds.items():
        idx = np.flatnonzero(mask)
        if not len(idx):
            raise AssertionError(f"the extended batch has no {name} pod")
        picks.append(rng.choice(idx, min(per_kind, len(idx)), replace=False))
    return np.unique(np.concatenate(picks)), {k: int(v.sum()) for k, v in kinds.items()}


def rack_batch(device):
    """The rack problem (1000 nodes, a rack key of 400 small domains), 3000
    logged placements."""
    return tensorized_batch(*smoke.rack_problem(synth, simtpu_torch.AppResource,
                                                simtpu_torch.ResourceTypes), device, 3000)


def keys_batch(device):
    """The keys problem (1000 nodes, 22 topology keys), 3000 logged
    placements."""
    return tensorized_batch(*smoke.keys_problem(synth, simtpu_torch.AppResource,
                                                simtpu_torch.ResourceTypes), device, 3000)


#: node counts above 1024 at which phase 2 holds K9/K10 to their plain
#: versions: two and three nodes per thread (the 2- and 4-node register
#: templates) and past what registers hold (the rows in global memory;
#: csrc/wave.cuh), each on the serial smoke problem's workload
WAVE_BIG_NODES = (2000, 3000, 6000)
WAVE_BIG_PODS = 600


def big_batch(device, n_nodes: int):
    """The serial smoke problem's workload (WAVE_BIG_PODS pods) on
    `n_nodes` nodes, 3000 logged placements."""
    return tensorized_batch(*smoke.smoke_problem(synth_cluster, synth_apps, n_nodes=n_nodes,
                                                 n_pods=WAVE_BIG_PODS), device, 3000)


def wave_kind(tensors, g: int, hard: bool, pref: bool, heavy: int) -> str:
    """The phase-2 class of a planned wave."""
    if heavy & wavefront.WAVE_HEAVY_STORAGE:
        return "storage"
    if heavy & wavefront.WAVE_HEAVY_GPU:
        return "gpu"
    if heavy:
        return "heavy-other"
    if hard:
        if (tensors.spread_hard[g] > 0).any():
            return "hard-spread"
        return "anti-req" if tensors.a_anti_req[g].any() else "hard-other"
    return "lean-pref" if pref else "lean"


def wave_pair(hard_or_heavy: bool):
    """(name, kernel wrapper, plain version) of the wave kernel of a run."""
    if hard_or_heavy:
        return "wave_hard", wavefront.wave_hard, wavefront.wave_hard_plain
    return "wave_lean", wavefront.wave_lean, wavefront.wave_lean_plain


def phase_waves(label, tensors, batch, statics, state, pods, flags, wanted, err, per_kind: int = 2):
    """K9 and K10 against their plain versions on the runs of the batch's
    wave plan, until every kind in `wanted` has been compared `per_kind`
    times. The pods between runs go through K1-K6 and the runs not compared
    through the wave kernels, so each compared run starts from the state the
    main path would give it. Returns ({kind: runs compared}, [(kind, a, b,
    mode, the run's start state)], the kernel side's buffers)."""
    groups = np.asarray(batch.group)
    ok = wavefront.wave_eligibility(pods, groups, tensors)
    kbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    pbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    done = dict.fromkeys(wanted, 0)
    runs = []
    segments = [seg for c0, c1, waves in wavefront.plan_waves(groups, tensors, flags, ok)
                for seg in wavefront.flatten_wave_segments(c0, c1, waves)]
    for kind, a, b, mode in segments:
        if min(done.values()) >= per_kind:
            break
        if kind == "scan":
            scan.run_pods(kbuf, a, b)
            continue
        hard, pref, heavy = mode
        k = wave_kind(tensors, int(groups[a]), hard, pref, heavy)
        name, kernel, plain = wave_pair(hard or heavy)
        if done.get(k, per_kind) >= per_kind:
            kernel(kbuf, a, b, mode)
            continue
        start = clone_state(kbuf.state)
        copy_state(pbuf.state, start)
        kernel(kbuf, a, b, mode)
        plain(pbuf, a, b, mode)
        torch.cuda.synchronize()
        for field in ("out_node", "reason", "out_lvm", "out_take", "out_gpu"):
            err[name] = max(err[name], tensor_diff(getattr(kbuf, field)[a:b], getattr(pbuf, field)[a:b]))
        err[name] = max(err[name], state_diff(kbuf.state, pbuf.state))
        if err[name]:
            bad = [n for n, x, y in zip(kbuf.state._fields, kbuf.state, pbuf.state) if tensor_diff(x, y)]
            raise AssertionError(f"{name}: {label} {k} run [{a}, {b}) differs from the plain version "
                                 f"(state planes {bad})")
        done[k] += 1
        runs.append((k, a, b, mode, start))
    missing = [k for k, v in done.items() if v < per_kind]
    if missing:
        raise AssertionError(f"phase 2: the {label} has too few waves of kinds {missing}")
    return done, runs, kbuf


def wave_bytes(buf, a: int, b: int) -> int:
    """Bytes a wave kernel must move for the run [a, b) (each input read
    once, each output written once), from this run's shapes and result:
    the per-node planes the flags keep (free, alloc, the occupancy planes,
    the group's six rows, the domain rows), the group's count and own-plane
    rows read and written, the storage and GPU planes where the run's pods
    demand them, the pods' inputs and outputs, and the free rows of the
    nodes the run chose."""
    st, s, f = buf.statics, buf.state, buf.flags
    n, r = st.alloc.shape
    p, w, c = st.ports_req.shape[1], st.vol_rw_req.shape[1], st.vol_class_mask.shape[0]
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], s.gpu_free.shape[1]
    k = st.node_dom.shape[0]
    g = int(buf.group[a])
    terms = st.g_terms[g]
    terms = terms[terms >= 0]
    tv = int(terms.numel())
    ti = int((st.ip_of[terms.long()] >= 0).sum()) if tv else 0
    f4 = 4
    node_b = n * (2 * r * f4 + 4 * f4 + 3 + 2 * k * f4)
    if f.ports:
        node_b += n * p * f4
    if f.vols or f.attach:
        node_b += n * (2 * w * f4 + c * f4)
    count_b = 2 * (tv + 4 * ti) * n * f4 + 2 * tv * f4
    live = buf.ext_live[a:b].cpu().numpy()
    ext_b = 0
    if (live & 1).any():
        ext_b += n * (2 * v * f4 + 2 * v * 4 + 2 * sd + sd * 8 + 1) + (b - a) * (v * f4 + sd)
    if (live & 2).any():
        ext_b += n * (2 * gd * f4 + gd + f4) + (b - a) * gd * f4
    pod_b = (b - a) * (r * f4 + 4 + 1 + 4 * 4 + 1)
    chosen = buf.out_node[a:b]
    rows_b = int(torch.unique(chosen[chosen >= 0]).numel()) * r * f4
    return int(node_b + count_b + ext_b + pod_b + rows_b)


#: the breakdown phase's runs: phase 2's 50-pod runs at N = 1000, (batch, kind)
BREAKDOWN_RUNS = (("serial", "lean"), ("serial", "lean-pref"), ("serial", "hard-spread"),
                  ("serial", "anti-req"), ("extended", "storage"))
#: the profile build's phases (csrc/wave_lean.cu, wave_hard.cu), by slot
WAVE_PHASES = {
    "wave_lean": ("score", "fold A: argmax + cascade OR", "commit", "fold B: extremes + flip", "refresh",
                  "setup", "end"),
    "wave_hard": ("stage, plans, term rows, normalizers", "fold B: normalizers + cascade OR", "score",
                  "fold C: argmax", "commit", "fold A: spread minima", "setup", "end"),
}
#: K9's profile slot counting refreshes; the slot counting steps
WAVE_PROF_REFRESHES, WAVE_PROF_STEPS = 7, 9


def ptxas_entries(name: str) -> dict:
    """{entry function: registers, spill bytes, stack} of kernel `name`'s
    library as ptxas reported them when this process built it (each
    template instantiation of K9/K10 is an entry)."""
    out, cur = {}, None
    for line in cuda.BUILD_INFO.get(name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"), ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"), ("stack", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m:
                out[cur][key] = int(m.group(1))
    return {k: v for k, v in out.items() if "kernel" in k}


def wave_barriers(name: str, buf, a: int, prof) -> float:
    """Block barriers per step of a wave launch, counted from the code: K9
    two (folds A and B) plus one per refresh; K10 two (folds B and C) plus
    one where the flags keep hard spread and the run's group has a
    DoNotSchedule column (fold A)."""
    steps = max(prof[WAVE_PROF_STEPS], 1)
    if name == "wave_lean":
        return 2.0 + prof[WAVE_PROF_REFRESHES] / steps
    g = int(buf.group[a])
    spread = buf.flags.spread_hard and bool((buf.statics.spread_hard[g] > 0).any())
    return 3.0 if spread else 2.0


def events_per_launch(buf, run, launch, iters: int) -> float:
    """Device ms per launch of `launch(buf, a, b, mode)` from the run's start
    state: CUDA events around each launch alone, the median of `iters`."""
    kind, a, b, mode, start = run
    times = []
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(iters + 1):
        copy_state(buf.state, start)
        e0.record()
        launch(buf, a, b, mode)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times[1:]))


def phase_wave_breakdown(runs_by_batch: dict) -> list:
    """K9/K10's step, phase by phase, on BREAKDOWN_RUNS: the main build's
    device time per launch and per pod step (CUDA events), the profile
    build's cycles per phase per step (thread 0's clock64() stamps; the
    cycles scaled to µs by the profile build's own time per launch), the
    barriers per step and the floor they set (barriers x the measured cost
    of one barrier at the block's size), beside the bytes bound. The
    profile build's launches are measurements, not counted."""
    cuda.build_profile()
    out = []
    for batch_label, kind in BREAKDOWN_RUNS:
        buf, runs = runs_by_batch[batch_label]
        run = next(r for r in runs if r[0] == kind)
        _, a, b, mode, start = run
        name, kernel, _ = wave_pair(mode[0] or mode[2])
        main_ms = events_per_launch(buf, run, kernel, 20)
        prof_ms = events_per_launch(buf, run, lambda *r: cuda.launch_wave_profile(name, *r), 20)
        copy_state(buf.state, start)
        buf.wave_prof.zero_()
        cuda.launch_wave_profile(name, buf, a, b, mode)
        torch.cuda.synchronize()
        prof = buf.wave_prof.tolist()
        steps = max(prof[WAVE_PROF_STEPS], 1)
        phases = WAVE_PHASES[name]
        total = sum(prof[: len(phases)])
        us_per_cycle = prof_ms * 1e3 / max(total, 1)
        threads = min(1024, max(32, -(-int(buf.statics.alloc.shape[0]) // 32) * 32))
        bar_cyc = cuda.barrier_cycles(threads)
        bars = wave_barriers(name, buf, a, prof)
        per_step = {ph: prof[q] / steps * us_per_cycle for q, ph in enumerate(phases) if ph not in ("setup", "end")}
        row = {"name": name, "kind": kind, "pods": b - a, "steps": prof[WAVE_PROF_STEPS],
               "ms_per_launch": main_ms, "us_per_pod_step": main_ms * 1e3 / (b - a),
               "profile_build_ms_per_launch": prof_ms,
               "phase_us_per_step": per_step,
               "setup_us": prof[phases.index("setup")] * us_per_cycle,
               "end_us": prof[phases.index("end")] * us_per_cycle,
               "refreshes": prof[WAVE_PROF_REFRESHES] if name == "wave_lean" else 0,
               "threads": threads, "barriers_per_step": bars, "barrier_cycles": bar_cyc,
               "barrier_us": bar_cyc * us_per_cycle,
               "barrier_floor_us_per_step": bars * bar_cyc * us_per_cycle,
               "bytes_bound_us": wave_bytes(buf, a, b) / HBM_BYTES_PER_S * 1e6}
        out.append(row)
        log(f"  breakdown {name} ({kind} run of {b - a} pods, {threads} threads): {main_ms * 1e3:.2f} us per "
            f"launch, {row['us_per_pod_step']:.3f} us per pod step (CUDA events; profile build "
            f"{prof_ms * 1e3:.2f} us); per step " + ", ".join(f"{k} {v:.3f} us" for k, v in per_step.items())
            + f"; setup {row['setup_us']:.2f} us, end {row['end_us']:.2f} us; {bars:.2f} barriers per step x "
            f"{bar_cyc:.1f} cycles = floor {row['barrier_floor_us_per_step']:.3f} us per step; bytes bound "
            f"{row['bytes_bound_us']:.3f} us per launch")
    return out


def time_wave(kbuf, run, iters: int):
    """One compared run's wave kernel, relaunched from the run's start
    state: device time per launch (profiler), host time to enqueue one
    launch, the plain version's time per call (CUDA events) and the bytes
    bound. Leaves the run's result in `kbuf`."""
    kind, a, b, mode, start = run
    name, kernel, plain = wave_pair(mode[0] or mode[2])

    def once():
        copy_state(kbuf.state, start)
        kernel(kbuf, a, b, mode)

    once()
    torch.cuda.synchronize()
    per, _, _ = profile_kernels(lambda: [once() for _ in range(iters)], {name: once})
    host = 0.0
    for _ in range(iters):
        copy_state(kbuf.state, start)
        t0 = time.perf_counter()
        kernel(kbuf, a, b, mode)
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    plain_ms = time_call(lambda: copy_state(kbuf.state, start) or plain(kbuf, a, b, mode), 2)
    once()
    torch.cuda.synchronize()
    return {"name": name, "kind": kind, "pods": b - a, "device_us": per[name][0],
            "host_us": host / iters * 1e6, "plain_ms": plain_ms, "bytes": wave_bytes(kbuf, a, b)}


def profile_waves(tensors, batch, statics, state, pods, flags, n_pods: int):
    """The wave dispatcher over the batch's first `n_pods` pods under the
    profiler: K9/K10 device µs per launch, the pods they placed, the busy
    share and the wall."""
    cut = tuple(x[:n_pods] for x in pods)
    groups = np.asarray(batch.group)[:n_pods]
    buf = scan.StepBuffers(statics, clone_state(state), cut, flags)
    per, busy, wall = profile_kernels(lambda: wavefront.run_batch_waves(buf, tensors, groups, cut), tries=1)
    return per, busy, wall


def delta_entries(kbuf, placed_pods, rng, k: int):
    """`k` seeded placements of a kernel run as remove_placements-style
    records, half of them storage or GPU pods."""
    node = kbuf.out_node.cpu().numpy()
    ext = kbuf.storage_live | kbuf.gpu_live
    ok = placed_pods[node[placed_pods] >= 0]
    pick = np.concatenate([rng.choice(ok[ext[ok]], k // 2, replace=False),
                           rng.choice(ok[~ext[ok]], k - k // 2, replace=False)])
    return placement_records(kbuf, pick)


def placement_records(kbuf, pick):
    """The placements `pick` of a kernel run as remove_placements-style
    records."""
    node = kbuf.out_node.cpu().numpy()
    g, req = kbuf.group.cpu().numpy(), kbuf.req.cpu().numpy()
    lvm, take = kbuf.out_lvm.cpu().numpy(), kbuf.out_take.cpu().numpy()
    shares, mem = kbuf.out_gpu.cpu().numpy(), kbuf.gpu_mem.cpu().numpy()
    return [(int(g[i]), int(node[i]), req[i], int(node[i]), lvm[i], take[i], shares[i], float(mem[i]))
            for i in pick]


def phase_delta(statics, state, entries, tensors, err):
    """K7 against its plain version: evict `entries` (w = -1), then restore
    them (w = +1). Every plane must equal the plain version's after each
    step and the state before the eviction after the round trip. Returns
    the packed eviction entries."""
    ext = tensors.ext
    widths = (tensors.alloc.shape[1], ext.vg_cap.shape[1], ext.sdev_cap.shape[1],
              ext.gpu_dev_total.shape[1])
    before = clone_state(state)
    kstate, pstate = clone_state(state), clone_state(state)
    packed = {}
    for sign in (-1.0, 1.0):
        packed[sign] = sstate.pack_delta_entries(entries, *widths, sign)
        sstate.apply_placement_deltas(statics, kstate, packed[sign])
        sstate.apply_placement_deltas_plain(statics, pstate, packed[sign])
        torch.cuda.synchronize()
        err["delta_apply"] = max(err["delta_apply"], state_diff(kstate, pstate))
        if err["delta_apply"]:
            raise AssertionError(f"delta_apply (w = {sign:+.0f}) differs from the plain version")
        if sign < 0:
            moved = [n for n, a, b in zip(state._fields, kstate, before) if not torch.equal(a, b)]
            if not {"free", "vg_free", "sdev_free", "gpu_free", "cnt_match"} <= set(moved):
                raise AssertionError(f"the eviction left planes unchanged: moved {moved}")
    off = [n for n, a, b in zip(state._fields, kstate, before) if not torch.equal(a, b)]
    if off:
        raise AssertionError(f"delta_apply round trip differs from the state before: {off}")
    return packed


def compact_diff(a, b) -> float:
    """The largest difference between two compact states, every field."""
    return max(tensor_diff(x, y) for x, y in zip(a, b))


def compact_maps(tensors, device):
    """(CompactSpecDev, node_dom_small) of `tensors` on `device`."""
    return (sstate.compact_spec_dev(tensors, device),
            sstate.node_dom_small_for(tensors, tensors.n_nodes, device))


def phase_compact(label, tensors, state, device, err):
    """K11 and K12 against their plain versions on a placed state: every
    compact field equal, the expansion equal to the state it came from
    (state_diff 0) and sharing no storage with the carry. Returns the
    kernel's compact state and the problem's partition."""
    spec = sstate.compact_spec(tensors)
    if not spec.enabled:
        raise AssertionError(f"phase 2: the {label} has no tabular count row")
    dev, nds = compact_maps(tensors, device)
    got = sstate.compress_state(dev, clone_state(state))
    want = sstate.compress_state_plain(dev, clone_state(state))
    torch.cuda.synchronize()
    err["compact_compress"] = max(err["compact_compress"], compact_diff(got, want))
    if err["compact_compress"]:
        bad = [f for f, x, y in zip(got._fields, got, want) if tensor_diff(x, y)]
        raise AssertionError(f"compact_compress: {label}: fields {bad} differ from the plain version")
    back = sstate.expand_state(dev, got, nds)
    plain_back = sstate.expand_state_plain(dev, want, nds)
    torch.cuda.synchronize()
    err["compact_expand"] = max(err["compact_expand"], state_diff(back, plain_back), state_diff(back, state))
    if err["compact_expand"]:
        bad = [f for f, x, y in zip(back._fields, back, state) if tensor_diff(x, y)]
        raise AssertionError(f"compact_expand: {label}: planes {bad} differ from the state compressed")
    shared = {t.untyped_storage().data_ptr() for t in got if t.numel()}
    if any(t.untyped_storage().data_ptr() in shared for t in back if t.numel()):
        raise AssertionError(f"compact_expand: {label}: the expansion shares storage with the carry")
    part = {"Rt": int(dev.t_tab.shape[0]), "Rd": int(dev.t_dense.shape[0]),
            "Rti": int(dev.ip_tab.shape[0]), "Rdi": int(dev.ip_dense.shape[0]), "D": spec.d,
            "tab_keys": int(torch.unique(dev.t_keys).numel()),
            "carried_bytes": sum(sstate.state_nbytes(got).values()),
            "dense_bytes": sum(sstate.state_nbytes(state).values())}
    return got, part


def phase_compact_delta(tensors, statics, state, packed, device, err):
    """K13 against its plain version and against the expand -> K7 ->
    compress route: evict (the packed w = -1 entries), then restore them.
    Every compact field must be equal after each step, and equal to the
    compressed start after the round trip."""
    dev, nds = compact_maps(tensors, device)
    n = tensors.n_nodes
    dspec = sstate.compact_delta_spec_dev(tensors, device)
    ndom = sstate.node_dom_for(tensors, n, device)
    start = sstate.compress_state_plain(dev, clone_state(state))
    kstate = sstate.compress_state_plain(dev, clone_state(state))
    pstate = sstate.compress_state_plain(dev, clone_state(state))
    dense = clone_state(state)
    for sign in (-1.0, 1.0):
        sstate.apply_placement_deltas_compact(statics, dspec, ndom, nds, kstate, packed[sign])
        sstate.apply_placement_deltas_compact_plain(statics, dspec, ndom, nds, pstate, packed[sign])
        sstate.apply_placement_deltas(statics, dense, packed[sign])
        route = sstate.compress_state_plain(dev, clone_state(dense))
        torch.cuda.synchronize()
        err["compact_delta"] = max(err["compact_delta"], compact_diff(kstate, pstate),
                                   compact_diff(kstate, route))
        if err["compact_delta"]:
            bad = [f for f, x, y, z in zip(kstate._fields, kstate, pstate, route)
                   if tensor_diff(x, y) or tensor_diff(x, z)]
            raise AssertionError(f"compact_delta (w = {sign:+.0f}): fields {bad} differ from the plain "
                                 "version or the expand -> K7 -> compress route")
        if sign < 0:
            moved = [f for f, a, b in zip(start._fields, kstate, start) if not torch.equal(a, b)]
            if not {"free", "vg_free", "sdev_free", "gpu_free", "cm_tab", "cnt_total"} <= set(moved):
                raise AssertionError(f"compact_delta: the eviction left planes unchanged: moved {moved}")
    off = [f for f, a, b in zip(start._fields, kstate, start) if not torch.equal(a, b)]
    if off:
        raise AssertionError(f"compact_delta round trip differs from the carry before: {off}")
    return start


def compact_bytes(tensors, state, cstate) -> dict:
    """Bytes K11, K12 and K13's inputs and outputs must move at this carry
    (each input read once, each output written once): K11 reads the dense
    elements it narrows (the representative nodes of the tabular rows, the
    dense rows, the cast planes) with the representative ids and writes
    the narrowed planes (free, vg_free and gpu_free move without a copy);
    K12 reads the compact carry and the node_dom_small rows of the tabular
    keys and writes the dense state."""
    spec = sstate.compact_spec(tensors).dev
    n = tensors.n_nodes
    planes = sstate.state_nbytes(cstate)
    moved = planes["free"] + planes["vg_free"] + planes["gpu_free"]
    reps = sum(int((r >= 0).sum()) for r in (spec.t_rep, spec.ip_rep, spec.ip_rep, spec.ip_rep,
                                                 spec.ip_rep))
    k11 = (sum(planes.values()) - moved) + reps * 4 + (spec.t_rep.numel() + spec.ip_rep.numel()) * 4
    for name in ("cm_dense", "oa_dense", "of_dense", "wa_dense", "wn_dense", "cnt_total", "ports_used",
                 "vols_any", "vols_rw"):
        k11 += getattr(cstate, name).numel() * 4
    k11 += cstate.sdev_free.numel()
    keys = torch.unique(torch.cat([spec.t_keys, spec.ip_keys])).numel()
    k12 = sum(planes.values()) + keys * n * 4 + sum(sstate.state_nbytes(state).values())
    return {"compact_compress": int(k11), "compact_expand": int(k12)}


def compact_delta_bytes(statics, cstate, packed, dspec, ndom, nds) -> int:
    """Bytes K13 must move for these entries into the carry `cstate` under
    the row maps `dspec` and the maps `ndom` / `nds`: the entries read once,
    the chosen nodes' rows read and written, each tabular bucket and
    cnt_total entry the entries touch read and written, and the dense count
    rows' elements they touch read and written."""
    g, node, wgt, req, vg, sd, gp = (np.asarray(x) for x in packed)
    live = wgt != 0
    e, r = req.shape
    entry_bytes = e * (12 + 4 * r + 4 * vg.shape[1] + sd.shape[1] + 4 * gp.shape[1])
    rows = np.unique(node[live])
    row_bytes = len(rows) * (4 * r + 4 * cstate.ports_used.shape[1] + 8 * cstate.vols_any.shape[1]
                             + 4 * cstate.vg_free.shape[1] + cstate.sdev_free.shape[1]
                             + 4 * cstate.gpu_free.shape[1])
    g_terms = statics.g_terms.cpu().numpy()
    node_dom = ndom.cpu().numpy()
    term_topo = statics.term_topo.cpu().numpy()
    ip_of = statics.ip_of.cpu().numpy()
    t_tab_of, t_dense_of = dspec.t_tab_of.cpu().numpy(), dspec.t_dense_of.cpu().numpy()
    ip_tab_of, ip_dense_of = dspec.ip_tab_of.cpu().numpy(), dspec.ip_dense_of.cpu().numpy()
    small = nds.cpu().numpy()
    n = node_dom.shape[1]
    buckets, ip_buckets, totals = set(), set(), set()
    dense = np.zeros((cstate.cm_dense.shape[0], n), bool)
    ip_dense = np.zeros((cstate.oa_dense.shape[0], n), bool)
    for gi, c in zip(g[live], node[live]):
        for term in g_terms[gi]:
            if term < 0 or node_dom[term_topo[term], c] < 0:
                continue
            key = term_topo[term]
            totals.add(term)
            ip = ip_of[term]
            if small[key, c] >= 0:
                if t_tab_of[term] >= 0:
                    buckets.add((term, small[key, c]))
                if ip >= 0 and ip_tab_of[ip] >= 0:
                    ip_buckets.add((ip, small[key, c]))
            if t_dense_of[term] < 0 and (ip < 0 or ip_dense_of[ip] < 0):
                continue
            same = node_dom[key] == node_dom[key, c]
            if t_dense_of[term] >= 0:
                dense[t_dense_of[term]] |= same
            if ip >= 0 and ip_dense_of[ip] >= 0:
                ip_dense[ip_dense_of[ip]] |= same
    count_bytes = 2 * 4 * (len(buckets) + 4 * len(ip_buckets) + len(totals) + int(dense.sum())
                           + 4 * int(ip_dense.sum()))
    return int(entry_bytes + 2 * row_bytes + count_bytes)


def time_call(fn, iters: int) -> float:
    """Milliseconds per call: CUDA events around `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_bytes(buf, i: int) -> dict:
    """Bytes each per-pod kernel must move for pod i (each input read once,
    each output written once), from this run's shapes and this pod's terms
    and demands."""
    st, s = buf.statics, buf.state
    n, r = st.alloc.shape
    p, w, c = st.ports_req.shape[1], st.vol_rw_req.shape[1], st.vol_class_mask.shape[0]
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], s.gpu_free.shape[1]
    g = int(buf.group[i])
    terms = st.g_terms[g]
    terms = terms[terms >= 0]
    tv = int(terms.numel())
    ti = int((st.ip_of[terms.long()] >= 0).sum()) if tv else 0
    live = int(buf.ext_live[i])
    st_live, gpu_live = live & 1, (live >> 1) & 1
    f4 = 4
    # K1 reads the rows of the stages its flags make live
    fl = buf.flag_bits
    k1 = (n * r * f4 + (n * p * f4 if fl & cuda.F_PORTS else 0)
          + (n * w * f4 if fl & (cuda.F_VOLS | cuda.F_ATTACH) else 0) + (n * w * f4 if fl & cuda.F_VOLS else 0)
          + (n * c * f4 if fl & cuda.F_ATTACH else 0) + 3 * n + n)  # + stage out
    k2 = n + tv * 2 * n * f4 + ti * 4 * n * f4 + n + 4 * n * f4
    k3 = (n + 4 * n * f4 + n * r * f4 + n * 2 * f4 + 4 * n * f4 + n * f4
          + st_live * (n + n * f4) + gpu_live * n)
    k4 = (tv * n * f4 + 2 * tv * n * f4 + 2 * ti * 4 * n * f4 + 2 * r * f4 + 2 * (p + 2 * w) * f4
          + st_live * (3 * v * f4 + 3 * sd) + gpu_live * 3 * gd * f4)
    claims = buf.lvm_size.shape[1] * 8 + buf.dev_size.shape[1] * 8
    k5 = (n * v * (3 * f4) + n * sd * (1 + 2 * f4) + n + claims
          + n + n * v * f4 + n * sd + n * f4)
    k6 = n * gd * (f4 + 1) + n * f4 + gd * 4 + 8 + n + n * gd * f4
    return {"filter_pod": k1, "topology_pod": k2, "score_argmax_pod": k3, "commit_pod": k4,
            "storage_pod": k5, "gpu_pod": k6}


def delta_bytes(statics, state, packed) -> int:
    """Bytes K7 must move for these entries: the entries read once, and
    every state element they touch read and written once."""
    g, node, wgt, req, vg, sd, gp = (np.asarray(x) for x in packed)
    live = wgt != 0
    g, node = g[live], node[live]
    e, r = req.shape[0], req.shape[1]
    entry_bytes = e * (12 + 4 * r + 4 * vg.shape[1] + sd.shape[1] + 4 * gp.shape[1])
    rows = np.unique(node)
    row_bytes = len(rows) * (4 * r + 4 * state.ports_used.shape[1] + 8 * state.vols_any.shape[1]
                             + 4 * state.vg_free.shape[1] + state.sdev_free.shape[1]
                             + 4 * state.gpu_free.shape[1])
    g_terms = statics.g_terms.cpu().numpy()
    node_dom = statics.node_dom.cpu().numpy()
    term_topo = statics.term_topo.cpu().numpy()
    ip_of = statics.ip_of.cpu().numpy()
    t_n = state.cnt_match.shape[0]
    touched = np.zeros((t_n, node_dom.shape[1]), bool)
    for gi, c in zip(g, node):
        for term in g_terms[gi]:
            if term < 0:
                continue
            dom = node_dom[term_topo[term]]
            if dom[c] >= 0:
                touched[term] |= dom == dom[c]
    own = touched[ip_of >= 0].sum() if t_n else 0
    count_bytes = 2 * 4 * (int(touched.sum()) + 4 * int(own) + int(touched.any(axis=1).sum()))
    return int(entry_bytes + 2 * row_bytes + count_bytes)


def phase_timing(kbuf, i: int, names):
    """Per-launch time of each named kernel and of its plain version on the
    card, at pod i of `kbuf`."""
    scratch = scan.StepBuffers(kbuf.statics, clone_state(kbuf.state),
                               tuple(getattr(kbuf, f).cpu() for f in (
                                   "group", "req", "pin", "forced", "lvm_size", "lvm_vg", "dev_size",
                                   "dev_media", "gpu_mem", "gpu_count", "gpu_preset")), kbuf.flags)
    for name in ("filter_pod", "storage_pod", "gpu_pod", "topology_pod", "score_argmax_pod"):
        if name in ("storage_pod", "gpu_pod") and not (
                scratch.storage_live if name == "storage_pod" else scratch.gpu_live)[i]:
            continue
        WRAPPERS[name][0](scratch, i)  # the scratch the timed kernels read
    out = {}
    for name in names:
        wrapper, plain = WRAPPERS[name]
        ms = time_call(lambda: wrapper(scratch, i), 2000)
        plain_ms = time_call(lambda: plain(scratch, i), 20)
        out[name] = (ms, plain_ms)
    return out, kernel_bytes(scratch, i)


def phase_profile(statics, state, pods, flags, n_pods: int):
    """Device time per kernel and the device's busy share over the per-pod
    loop of `n_pods` pods (torch.profiler's CUDA activity). Returns
    ({kernel: (device us per launch, launches)}, busy share, wall s)."""
    buf = scan.StepBuffers(statics, clone_state(state), tuple(x[:n_pods] for x in pods), flags)
    scan.run_batch(scan.StepBuffers(statics, clone_state(state), tuple(x[:8] for x in pods), flags))
    torch.cuda.synchronize()
    return profile_kernels(lambda: scan.run_batch(buf), tries=1)


def kernel_of(key: str):
    """The KERNELS entry a profiler key is a kernel of: "<name>_kernel" or a
    path of it, "<name>_<path>_kernel" (K23's register and slab paths),
    template instances included. A template instance demangles as "void
    (anonymous namespace)::wave_lean_kernel<1>(...)", a plain kernel as
    "filter_pod_kernel(...)"."""
    fn = part_of(key).split("<")[0]
    for name in KERNELS:
        if fn == f"{name}_kernel" or (fn.startswith(f"{name}_") and fn.endswith("_kernel")):
            return name
    return None


#: kernels whose one launch is several CUDA kernels (K8: cuda.audit_plan's
#: radix passes and scans; K7 and K13: the grouping and pair kernel, then
#: the walk), each mapped to its part that runs exactly once a launch; the
#: profiler's device time of a launch is the sum of its parts, its
#: launches the count of that part
MULTI_KERNEL = {"audit_bulk": "audit_bulk_flags_kernel", "compact_delta": "compact_delta_kernel",
                "delta_apply": "delta_apply_kernel"}

# kernels whose device time came from CUDA events because the profiler's
# windows lost their device events
PROFILER_MISSED = set()
#: seconds a profiler window waits, after an empty kernel, before the
#: calls it measures
PROFILER_LEAD_S = 0.005


def part_of(key: str) -> str:
    """The CUDA kernel a profiler key names, template arguments kept:
    "audit_bulk_count_kernel<true>"."""
    return key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def window_events(fn):
    """Run `fn` in one profiler window: [(KERNELS name, part_of, device us,
    count)] for each CUDA kernel of KERNELS it ran, and the window's wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # an empty kernel, a synchronisation and a pause open the window
        # before `fn`: without them a run's windows of short kernels came
        # back with no device events at all (one run with them saw none)
        torch.cuda.synchronize()
        cuda.launch_noop(torch.device("cuda"))
        torch.cuda.synchronize()
        time.sleep(PROFILER_LEAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []
    for ev in prof.key_averages():
        name = kernel_of(ev.key)
        if name is not None:
            dev_us = getattr(ev, "device_time_total", None)
            events.append((name, part_of(ev.key), ev.cuda_time_total if dev_us is None else dev_us, ev.count))
    return events, wall


def profile_window(fn):
    events, wall = window_events(fn)
    total = {}
    for name, part, dev_us, count in events:
        us, n = total.get(name, (0.0, 0))
        if name in MULTI_KERNEL and part != MULTI_KERNEL[name]:
            count = 0
        total[name] = (us + dev_us, n + count)
    busy_us = sum(us for us, _ in total.values())
    # a several-kernel launch whose once-a-launch part lost its events is
    # missing from the window
    per = {name: (us / count, count) for name, (us, count) in total.items() if count}
    return per, busy_us / 1e6 / wall, wall


def profile_kernels(fn, alone=None, tries: int = 3):
    """Device µs per launch and launches of each kernel `fn` ran (profiler),
    the device's busy share of the window, and its wall. The profiler's
    CUPTI trace now and then comes back without some or all device events:
    a window that shows no kernel, or none of a kernel named in `alone`, is
    profiled again, up to `tries` windows. `alone` maps kernel names to a
    callable that launches that kernel by itself, or to (callable, its
    launches per call); a name still missing after the last window is timed
    by CUDA events around 20 back-to-back calls of its callable (launches
    0), and noted in PROFILER_MISSED. A window that drives a main path
    under its counts takes `tries=1`."""
    alone = alone or {}
    for attempt in range(1, tries + 1):
        per, busy, wall = profile_window(fn)
        missing = [name for name in alone if name not in per]
        if per and not missing:
            return per, busy, wall
        log(f"  the profiler's window {attempt} of {tries} shows no device time for "
            f"{missing or 'any kernel'}")
    for name in missing:
        call, n = alone[name] if isinstance(alone[name], tuple) else (alone[name], 1)
        per[name] = (time_call(call, 20) * 1e3 / n, 0)
        PROFILER_MISSED.add(name)
        log(f"  {name}: device time from CUDA events around back-to-back launches")
    return per, busy, wall


def ms_from(name: str) -> str:
    return "cuda events" if name in PROFILER_MISSED else "profiler"


def device_ms_per_call(fn, iters: int) -> float:
    """Device ms per call of `fn` (a PyTorch library call): the profiler's
    duration of every CUDA kernel it launched, summed over `iters` calls
    after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)  # as window_events, without the empty kernel this sum would take in
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    # a profiler window without device events: CUDA events around the calls
    return us / iters / 1e3 if us else time_call(fn, iters)


def new_steps() -> dict:
    return dict.fromkeys(("pods", "wave_pods", "storage", "gpu", "wave_lean", "wave_hard"), 0)


class CountingEngine(scan.Engine):
    """The engine, counting on the host from each batch and its wave plan
    (`engine/wavefront.py plan_waves`): the pod steps outside the waves
    and how many of them need K5 (storage) and K6 (GPU), the pods inside
    the waves, and the waves that take K9 and K10."""

    steps = new_steps()
    speculate_default = True
    compact_default = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.speculate = CountingEngine.speculate_default
        self.compact = CountingEngine.compact_default

    def place(self, batch):
        tensors = self.tensorizer.freeze()
        flags = scan.flags_from(tensors, batch.ext)
        _, pods = scan.build_pod_arrays(batch, tensors.alloc.shape[1])
        groups = np.asarray(batch.group)
        in_wave = np.zeros(len(groups), bool)
        steps = CountingEngine.steps
        if self.speculate and len(groups):
            ok = wavefront.wave_eligibility(pods, groups, tensors)
            for _, _, waves in wavefront.plan_waves(groups, tensors, flags, ok):
                for a, b, hard, _, heavy in waves:
                    in_wave[a:b] = True
                    steps["wave_hard" if hard or heavy else "wave_lean"] += 1
        out = ~in_wave
        steps["pods"] += int(out.sum())
        steps["wave_pods"] += int(in_wave.sum())
        steps["storage"] += int((scan.storage_demand(pods[4], pods[6]) & out).sum()) if flags.storage else 0
        steps["gpu"] += int(((np.asarray(pods[8]) > 0) & out).sum()) if flags.gpu else 0
        return super().place(batch)


def check_launches(label: str, launches: dict, steps: dict, plain_calls: int, speculate: bool) -> None:
    """K1-K4 once per pod step outside the waves, K5/K6 once per storage /
    GPU step outside them, K9/K10 once per planned wave, no plain call."""
    short = [k for k in STEP if launches.get(k, 0) != steps["pods"]]
    waves = [k for k in WAVES if launches.get(k, 0) != steps[k]]
    if short or waves or plain_calls:
        raise AssertionError(f"{label}: launches {launches} for {steps}, plain calls {plain_calls}")
    if launches.get("storage_pod", 0) != steps["storage"] or launches.get("gpu_pod", 0) != steps["gpu"]:
        raise AssertionError(f"{label}: K5/K6 launches {launches} != host-counted steps {steps}")
    if speculate and not all(launches.get(k, 0) for k in WAVES):
        raise AssertionError(f"{label}: the wavefront is on but K9 or K10 never launched ({launches})")
    if not speculate and steps["wave_pods"]:
        raise AssertionError(f"{label}: the wavefront is off but {steps['wave_pods']} pods rode waves")


def check_compact(label: str, launches: dict, want) -> None:
    """K11/K12/K13 launched exactly as often as the JAX package's
    state.compress / state.expand / state.delta_direct counted on the same
    path (`want`, smoke.COMPACT_CARRY), or never (`want` None: the carry
    is dense)."""
    got = {k: launches.get(k, 0) for k in COMPACT}
    expect = {k: (want[COMPACT_COUNTER[k]] if want else 0) for k in COMPACT}
    if got != expect:
        raise AssertionError(f"{label}: compact kernels launched {got}, the JAX package's counts {expect}")


def check_gauge(label: str, want) -> dict:
    """The port's carried-state gauge after a main path: equal to the JAX
    package's (`want`, smoke.COMPACT_CARRY) with the compact carry on."""
    gauge = {k: sstate.STATE_GAUGE[k] for k in ("carried_bytes", "dense_bytes", "compact")}
    if want is not None and (not gauge["compact"] or gauge["carried_bytes"] != want["carried_bytes"]
                             or gauge["dense_bytes"] != want["dense_bytes"]):
        raise AssertionError(f"{label}: carried-state gauge {gauge}, the JAX package's {want}")
    if want is None and gauge["compact"]:
        raise AssertionError(f"{label}: the compact carry is off but the carry stored is compact")
    return gauge


def run_main_path(problem, golden, card: str, label: str, path: str, speculate: bool = True,
                  compact: bool = True):
    """`simulate(device="cuda")` on a smoke problem with every count set to
    0 just before and read just after, the wavefront and the compact carry
    on or off; the record must equal the golden file, K11/K12/K13 must
    have launched as often as the JAX package's counters on `path`. Returns
    (launches, host step counts, wall s, pods, record, the closed
    simulator's copy, wave counters, the carried-state gauge)."""
    cluster, apps = problem
    CountingEngine.steps = new_steps()
    CountingEngine.speculate_default = speculate
    CountingEngine.compact_default = compact
    tapi.Engine = tcap.Engine = CountingEngine
    cuda.reset_counts()
    waves0 = wavefront.wave_counts()
    tapi.Simulator = CapturingSimulator
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = simtpu_torch.simulate(cluster, apps, device="cuda")
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        seed_name_hashes(None)
        tapi.Engine = tcap.Engine = scan.Engine
        tapi.Simulator = Simulator
        CountingEngine.speculate_default = True
        CountingEngine.compact_default = True
    launches, steps = dict(cuda.LAUNCHES), dict(CountingEngine.steps)
    waves = {k: v - waves0[k] for k, v in wavefront.wave_counts().items()}
    plain_calls = sum(cuda.PLAIN_CALLS.values())
    record = smoke.placement_record(result)
    n_pods = len(record["placed"]) + len(record["failed"]) + len(record["preempted"])
    check_launches(label, launches, steps, plain_calls, speculate)
    check_compact(label, launches, smoke.COMPACT_CARRY[path] if compact else None)
    gauge = check_gauge(label, smoke.COMPACT_CARRY[path] if compact else None)
    if steps["pods"] + steps["wave_pods"] < n_pods or waves["pods"] != steps["wave_pods"]:
        raise AssertionError(f"{label}: {steps} pod steps for {n_pods} pods, wave counters {waves}")
    diffs = smoke.record_differences(record, smoke.load_record(golden))
    if diffs:
        raise AssertionError(f"{label} differs from the golden record:\n" + "\n".join(diffs))
    log(f"{label}: simulate(device='cuda'), wavefront {'on' if speculate else 'off'}, "
        f"compact carry {'on' if compact else 'off'} (carried {gauge['carried_bytes']} B, dense "
        f"{gauge['dense_bytes']} B), "
        f"{len(record['nodes'])} nodes x {n_pods} pods ({steps['pods']} pod steps outside waves, "
        f"{steps['wave_pods']} in {steps['wave_lean']} + {steps['wave_hard']} waves, {steps['storage']} "
        f"storage, {steps['gpu']} GPU): {wall:.2f} s, {n_pods / wall:.0f} pods/s, "
        f"{len(record['failed'])} unscheduled, {len(record['preempted'])} preempted, record == golden; "
        f"launches {launches}; wave counters {waves} [{card}]")
    return launches, steps, wall, n_pods, record, CapturingSimulator.last, waves, gauge


class CapturingSimulator(tapi.Simulator):
    """The simulator, keeping a shallow copy of its last instance as it
    closes, so its placement log can be audited after the timed run."""

    last = None

    def close(self) -> None:
        CapturingSimulator.last = copy.copy(self)
        super().close()


def k8_cases(tensors, e, seed: int):
    """(label, tensors, entries) for K8's comparisons: clean, the optional
    families cut to width 0, every mutation class and bulk corruption with
    a target in this log."""
    cases = [("clean", tensors, e), ("zero-widths", *fuzz.zero_widths(tensors, e))]
    for kind in fuzz.MUTATION_CLASSES:
        mut = fuzz.mutate_entries(kind, tensors, e, np.random.default_rng(seed))
        if mut is not None:
            cases.append((kind, tensors, mut))
    for kind in fuzz.BULK_CORRUPTIONS:
        got = fuzz.corrupt(kind, tensors, e, np.random.default_rng(seed))
        if got is not None:
            cases.append((kind, *got))
    return cases


def compare_k8(label: str, tensors, e, node_valid, device, err, seed: int = 0) -> dict:
    """K8 against its plain version on the card, on every case of k8_cases;
    the flag words must be equal. Returns {case: entries flagged}."""
    nv = np.ones(tensors.alloc.shape[0], bool) if node_valid is None else np.asarray(node_valid, bool)
    out = {}
    for case, t, x_e in k8_cases(tensors, e, seed):
        x = checker._upload(t, x_e, nv, device)
        got = kaudit.audit_bulk(x)
        want = kaudit.audit_bulk_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"audit_bulk: {label} {case}: {bad} flag words differ from the plain version")
        err["audit_bulk"] = max(err["audit_bulk"], float((got != want).sum()))
        out[case] = int((want != 0).sum())
    if out["clean"] or out["zero-widths"]:
        raise AssertionError(f"audit_bulk: {label}: the clean log is flagged ({out})")
    return out


def audit_bytes(x) -> int:
    """Bytes K8 must move: the per-node planes and the entries read once,
    the group planes' rows the entries gather, the flag words written."""
    n, r = x.alloc.shape
    m = x.g.shape[0]
    p, w, c = x.ports.shape[1], x.vol_rw.shape[1], x.vol_class_mask.shape[0]
    v, sd, gd = x.vg_avail0.shape[1], x.sdev_free0.shape[1], x.gpu_total.shape[1]
    node_b = n * (8 * r + 1 + 8 * c + 8 * v + sd + 8 * gd)
    group_b = m * (2 + p + 3 * w) + 8 * c * w
    entry_b = m * (3 * 8 + 1 + 8 * r + 8 * v + sd + 8 * gd)
    return int(node_b + group_b + entry_b + 4 * m)


def plan_on_card(cluster, apps, template, **kw):
    """plan_capacity on the card with the counts set to 0 just before and
    read just after, pod names seeded as in the golden run."""
    CountingEngine.steps = new_steps()
    tapi.Engine = tcap.Engine = CountingEngine
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    try:
        plan = plan_capacity(cluster, apps, template, device="cuda", **kw)
    finally:
        seed_name_hashes(None)
        tapi.Engine = tcap.Engine = scan.Engine
    return plan, dict(cuda.LAUNCHES), dict(CountingEngine.steps), sum(cuda.PLAIN_CALLS.values())


def run_capacity(card: str):
    """The capacity problem through the apply front door on the card: a
    simon Config in a temp dir, `Applier.run`. Returns (plan, launches,
    steps, wall, the winner's (tensors, entries, node_valid))."""
    cluster, apps, template = smoke.capacity_problem(synth, simtpu_torch.AppResource,
                                                     simtpu_torch.ResourceTypes)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke.write_capacity_config(tmp, cluster, apps, template)
        applier = Applier(ApplierOptions(simon_config=cfg, device="cuda"))
        CountingEngine.steps = new_steps()
        tapi.Engine = tcap.Engine = CountingEngine
        tapi.Simulator = CapturingSimulator
        cuda.reset_counts()
        seed_name_hashes(smoke.NAME_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            plan = applier.run()
            torch.cuda.synchronize()
        finally:
            seed_name_hashes(None)
            tapi.Engine = tcap.Engine = scan.Engine
            tapi.Simulator = Simulator
        wall = time.perf_counter() - t0
    launches, steps = dict(cuda.LAUNCHES), dict(CountingEngine.steps)
    plain_calls = sum(cuda.PLAIN_CALLS.values())
    diffs = smoke.plan_differences(smoke.plan_record(plan), smoke.load_record(smoke.CAP_GOLDEN))
    if diffs:
        raise AssertionError("phase 5: the plan differs from the golden record:\n" + "\n".join(diffs))
    n_cand = len(plan.candidates)
    if launches.get("audit_bulk", 0) != n_cand or plain_calls:
        raise AssertionError(f"phase 5: K8 launched {launches.get('audit_bulk', 0)} times for "
                             f"{n_cand} candidates; plain calls {plain_calls}")
    check_launches("phase 5", launches, steps, plain_calls, True)
    check_compact("phase 5", launches, smoke.COMPACT_CARRY["capacity"])
    gauge = check_gauge("phase 5", smoke.COMPACT_CARRY["capacity"])
    dd = plan.engine["delta_direct"]
    if (dd["compress"], dd["expand"], dd["applied"]) != tuple(launches.get(k, 0) for k in COMPACT):
        raise AssertionError(f"phase 5: plan.engine delta_direct {dd} != launches {launches}")
    if not (plan.engine["compact"] and all(c["compact"] for c in plan.candidates)):
        raise AssertionError(f"phase 5: a candidate ran without the compact carry: {plan.candidates}")
    if steps["pods"] + steps["wave_pods"] < n_cand * (smoke.N_PODS + sum(b[1] for b in smoke.CAP_BURST)):
        raise AssertionError(f"phase 5: launches {launches} for {steps} pod steps over {n_cand} candidates")
    if plan.engine["audit"].get("fallback") or not plan.engine["audit"].get("ok"):
        raise AssertionError(f"phase 5: the audit is not clean: {plan.engine['audit']}")
    sim = CapturingSimulator.last
    winner = (*checker.simulation_entries(sim), sim._engine.node_valid)
    splits = [c["audit_split"] for c in plan.candidates]
    mean = {k: sum(sp[k] for sp in splits) / n_cand for k in ("upload", "bulk", "host")}
    log(f"phase 5: apply (Applier.run, {plan.engine['search']} search) on the capacity problem: "
        f"{plan.nodes_added} nodes added, {n_cand} candidates, plan {plan.timings['plan']:.2f} s "
        f"(ingest {plan.timings['ingest']:.2f} s, wall {wall:.2f} s); plan == golden, audit clean "
        f"({plan.audit['checked']} placements); launches {launches}; wave counters "
        f"{plan.engine['wavefront']}; compact carry {plan.engine['delta_direct']}, final carry "
        f"{gauge['carried_bytes']} B (dense {gauge['dense_bytes']} B) [{card}]")
    for c in plan.candidates:
        sp = c["audit_split"]
        log(f"  candidate +{c['count']}: {c['wall_s']:.3f} s, audit {c['audit_wall_s'] * 1e3:.1f} ms "
            f"(upload {sp['upload'] * 1e3:.2f}, K8 {sp['bulk'] * 1e3:.2f}, host {sp['host'] * 1e3:.2f} ms)")
    log("  audit split, mean per candidate: " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in mean.items()))
    return plan, launches, steps, wall, winner, mean, gauge


class HostSplit:
    """Exclusive host wall time per part of one simulation: each wrapped
    function's time less that of the wrapped functions it calls (host
    clock, no synchronization: a part that waits for the card, as the
    batch's fetch at the end of Engine.place does, carries that wait)."""

    def __init__(self):
        self.parts: dict = {}
        self._stack = [0.0]
        self._undo = []

    def wrap(self, owner, name: str, part: str) -> None:
        fn = getattr(owner, name)
        split = self

        def timed(*a, **kw):
            split._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                took = time.perf_counter() - t0
                inner = split._stack.pop()
                split.parts[part] = split.parts.get(part, 0.0) + took - inner
                split._stack[-1] += took

        setattr(owner, name, timed)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


def capacity_host_split(card: str, count: int) -> dict:
    """One capacity candidate (the plan's winner: `count` template nodes
    added) simulated and audited on the card, its wall time split on the
    host around the port's own functions: workload expansion and sorting,
    the node copies, the Tensorizer (its node tensors, add_pods, freeze),
    statics_from and build_state, Engine.place's loop (the wave and per-pod
    launches and the batch's fetch), K11/K12's wrappers, results and
    annotations, preemption, the audit, and the rest of simulate()."""
    from simtpu_torch.core import tensorize as ttz

    cluster, apps, template = smoke.capacity_problem(synth, simtpu_torch.AppResource,
                                                     simtpu_torch.ResourceTypes)
    trial = simtpu_torch.ResourceTypes(**{k: list(v) for k, v in vars(cluster).items()})
    trial.nodes = list(cluster.nodes) + tcap.new_fake_nodes(template, count)
    split = HostSplit()
    for owner, name, part in (
            (tapi, "get_valid_pods_exclude_daemonset", "expansion and sorting"),
            (tapi, "make_valid_pods_by_daemonset", "expansion and sorting"),
            (tapi, "_sort_app_pods", "expansion and sorting"),
            (tapi, "deep_copy", "node copies"),
            (ttz.Tensorizer, "__init__", "Tensorizer() / add_pods / freeze"),
            (ttz.Tensorizer, "add_pods", "Tensorizer() / add_pods / freeze"),
            (ttz.Tensorizer, "freeze", "Tensorizer() / add_pods / freeze"),
            (scan, "statics_from", "statics_from / build_state"),
            (scan, "build_state", "statics_from / build_state"),
            (scan.Engine, "place", "Engine.place loop"),
            (scan, "compress_state", "K11/K12"),
            (scan, "expand_state", "K11/K12"),
            (Simulator, "_schedule_pods", "results and annotations"),
            (Simulator, "_result", "results and annotations"),
            (Simulator, "_preempt_failed_batch", "preemption"),
            (checker, "audit_simulation", "audit")):
        split.wrap(owner, name, part)
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = simtpu_torch.simulate(trial, apps, device="cuda", audit=True)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        seed_name_hashes(None)
        split.restore()
    if result.unscheduled_pods or not result.audit.ok:
        raise AssertionError(f"phase 5: the split candidate (+{count}) left "
                             f"{len(result.unscheduled_pods)} pods or failed its audit")
    parts = dict(split.parts)
    parts["other"] = wall - sum(parts.values())
    log(f"phase 5: host split of one candidate (+{count} nodes, simulate + audit on the card): "
        f"{wall:.3f} s; " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; launches {dict(cuda.LAUNCHES)} [{card}]")
    return {"wall_s": wall, "parts_s": parts}


def run_injected(card: str):
    """A cut of the capacity problem planned clean and with the audit's view
    of every primary candidate corrupted: the injected plan must ship the
    certified re-run with the clean plan's count."""
    burst = tuple((name, replicas // 10, cpu, mem) for name, replicas, cpu, mem in smoke.CAP_BURST)
    problem = smoke.capacity_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes,
                                     n_nodes=90, n_pods=1000, burst=burst)
    clean, _, _, _ = plan_on_card(*problem)
    # the wave pods of each simulation of the injected plan
    sims = []
    orig = tcap.simulate

    def recording(*a, **kw):
        before = wavefront.wave_counts()["pods"]
        out = orig(*a, **kw)
        sims.append(wavefront.wave_counts()["pods"] - before)
        return out

    tcap.simulate = recording
    try:
        injected, launches, _, plain_calls = plan_on_card(*problem, _audit_inject=True)
    finally:
        tcap.simulate = orig
    doc = injected.audit
    cands = injected.candidates
    fallback = [n for n, c in zip(sims, cands) if c["fallback"]]
    primary = [n for n, c in zip(sims, cands) if not c["fallback"]]
    if not (len(sims) == len(cands) and all(c["speculate"] != c["fallback"] for c in cands)
            and injected.success and clean.success and injected.nodes_added == clean.nodes_added
            and doc.get("fallback") is True and doc.get("ok") is True
            and doc["fallback_audit"]["ok"] and doc["violations"] >= 1
            and injected.candidates[-1]["fallback"] and not plain_calls
            and launches.get("audit_bulk", 0) == len(injected.candidates)
            and fallback == [0] and primary and all(primary)):
        raise AssertionError(f"phase 5b: injected plan {injected.nodes_added} (clean {clean.nodes_added}), "
                             f"audit {doc}, launches {launches}, wave pods per simulation {sims}")
    log(f"phase 5b: injected divergence on a cut (90 nodes, {1000 + sum(b[1] for b in burst)} pods): "
        f"the audit caught {doc['violations']} violation(s) {doc['by_class']}, the certified re-run "
        f"shipped {injected.nodes_added} nodes added == the clean plan's; "
        f"{len(injected.candidates)} audits, K8 launched {launches.get('audit_bulk', 0)} times; wave pods "
        f"per primary candidate {primary}, in the re-run {fallback[0]} (wavefront off) [{card}]")
    return injected


_AUDIT_TIME = re.compile(r", [0-9.]+s, \w+ mode\)")


def cli_report(argv) -> tuple:
    """(exit code, report lines) of `simtpu_torch.cli apply`, pod names
    seeded, the timing and engine lines dropped."""
    out = io.StringIO()
    seed_name_hashes(23)
    try:
        with contextlib.redirect_stdout(out):
            rc = tcli.main(argv)
    finally:
        seed_name_hashes(None)
    lines = [_AUDIT_TIME.sub(")", line) for line in out.getvalue().splitlines()
             if not line.startswith(("phase timings:", "engine selection:"))]
    return rc, lines


def run_cli_examples(card: str) -> list:
    """The three example configs through the apply front door on the card
    and on the CPU path: the same exit code and report text."""
    os.chdir(REPO)
    done = []
    for config, extra in (("examples/simtpu-config.yaml", []),
                          ("examples/simtpu-gpushare-config.yaml", ["-e", "gpu"]),
                          ("examples/simtpu-storage-config.yaml", ["-e", "open-local"])):
        argv = ["apply", "-f", config, *extra]
        got = cli_report(argv + ["--device", "cuda"])
        want = cli_report(argv + ["--device", "cpu"])
        if got != want or got[0] != 0 or not any("Audit: clean (" in line for line in got[1]):
            diff = [(a, b) for a, b in zip(got[1], want[1]) if a != b][:3]
            raise AssertionError(f"phase 4c: {config}: exit {got[0]} vs {want[0]}, differing lines {diff}")
        done.append((config, len(got[1])))
    log(f"phase 4c: apply on the three example configs, report text equal to the CPU path's "
        f"({', '.join(f'{c}: {n} lines' for c, n in done)}) [{card}]")
    return done


def run_example(cluster_dir: str, app_dir: str, name: str, extended=()):
    """An example on the card and on the CPU path: equal, none unscheduled."""
    cluster = create_cluster_resource_from_cluster_config(str(REPO / cluster_dir))
    app = simtpu_torch.AppResource(name=name, resource=load_resources(str(REPO / app_dir)))
    records = []
    for dev in ("cuda", "cpu"):
        seed_name_hashes(1)
        records.append(smoke.placement_record(
            simtpu_torch.simulate(cluster, [app], extended_resources=list(extended), device=dev)))
        seed_name_hashes(None)
    got, want = records
    if got["failed"] or got != want:
        raise AssertionError(f"{cluster_dir} + {app_dir}: {len(got['failed'])} unscheduled, "
                             f"equal to CPU: {got == want}")
    return got


# -- the bulk rounds (K14-K16) and the carry copy (K17) ------------------------


def problem_batch(cluster, apps, device):
    """A problem's app pods tensorized (names seeded), its statics and an
    empty state on `device`."""
    tensors, batch, statics, _, pods = tensorized_batch(cluster, apps, device, 0)
    state = sstate.build_state(tensors, np.zeros(0, np.int32), np.zeros(0, np.int32),
                               np.zeros((0, tensors.alloc.shape[1]), np.float32), None, device)
    return tensors, batch, statics, state, pods


def round_class(tensors, pods, seg) -> str:
    """The phase-2 class of a bulk segment: plain, storage, gpu (plain
    rounds by demand), quota-spread / quota-anti (by t*'s term), or the
    segment kind itself (bulkm, bulka, ...)."""
    kind, a, _ = seg
    if kind == "bulkq":
        g = int(pods[0][a])
        s_match = tensors.s_match[g]
        spread = s_match & (tensors.spread_hard[g] > 0)
        return "quota-spread" if spread.any() else "quota-anti"
    if kind != "bulk":
        return kind
    if float(pods[8][a]) > 0:
        return "gpu"
    if scan.storage_demand(pods[4][a], pods[6][a]):
        return "storage"
    return "plain"


def round_diff(krb, prb, fields) -> float:
    return max(tensor_diff(getattr(krb, f), getattr(prb, f)) for f in fields)


def phase_rounds(label, tensors, batch, statics, state, pods, flags, wanted, err, per_kind: int = 1):
    """K14-K16 against their plain versions on rounds of the problem's JAX
    segment plan: the plan is walked with the kernels (serial segments
    through the wave path), and at the first `per_kind` rounds of each
    wanted class the plain versions run from the same state and scratch
    (K1/K5/K6/K2's, handed over from the kernel side): caps, m_all, s0,
    slope, the fill orders, m_n, every state plane and the slot outputs
    must be equal. Returns ({class: rounds compared}, the first compared
    round of each class as (pod, k, mode, state before), the walk's
    buffers)."""
    eng = rounds.RoundsEngine.__new__(rounds.RoundsEngine)
    segments = eng._segments(batch, tensors)
    groups = np.asarray(batch.group)
    kbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    pbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    krb, prb = rounds.RoundBuffers(kbuf, tensors), rounds.RoundBuffers(pbuf, tensors)
    done, first = {}, {}
    ext_fields = []
    if flags.storage:
        ext_fields += ["ord_vg", "cs_vg", "cum_vg", "ord_dev", "cs_dev", "cum_dev"]
    if flags.gpu:
        ext_fields += ["ord_gpu", "cs_gpu", "cum_gpu"]
    for seg in segments:
        kind, a, b = seg
        if kind == "scan":
            wavefront.run_batch_waves(kbuf, tensors, groups, pods, a, b)
            continue
        quota, self_aff, mats = eng._kind_flags(kind)
        mode = rounds.variant_mode(quota, self_aff, mats)
        k = b - a
        k_cap = rounds._pow2(k)
        krb.alloc_outputs(1, k_cap)
        cls = round_class(tensors, pods, seg)
        if cls not in wanted or done.get(cls, 0) >= per_kind:
            rounds.run_round(krb, a, k, mode, 0)
            continue
        copy_state(pbuf.state, kbuf.state)
        first.setdefault(cls, (a, k, mode, clone_state(kbuf.state)))
        scan.filter_pod(kbuf, a)
        if kbuf.storage_live[a]:
            scan.storage_pod(kbuf, a)
        if kbuf.gpu_live[a]:
            scan.gpu_pod(kbuf, a)
        scan.topology_pod(kbuf, a)
        for f in ROUND_SCRATCH:
            getattr(pbuf, f).copy_(getattr(kbuf, f))
        prb.alloc_outputs(1, k_cap)
        rounds.round_score(krb, a, mode)
        rounds.round_score_plain(prb, a, mode)
        torch.cuda.synchronize()
        fields = ["cap", "m_all"] + ext_fields + (["c_gpu", "cum_gidx"] if mats and flags.gpu else [])
        if not quota:
            fields += ["s0", "slope"]
        e14 = round_diff(krb, prb, fields)
        rounds.round_pick(krb, a, k, mode)
        rounds.round_pick_plain(prb, a, k, mode)
        torch.cuda.synchronize()
        e15 = tensor_diff(krb.m_n, prb.m_n)
        rounds.round_commit(krb, a, k, mode, 0)
        rounds.round_commit_plain(prb, a, k, mode, 0)
        torch.cuda.synchronize()
        outs = ("assign", "dev_idx", "lvm_mat", "gpu_mat") if mats else ("assign", "vg_idx", "dev_idx", "gpu_idx")
        e16 = max(state_diff(kbuf.state, pbuf.state), round_diff(krb, prb, outs))
        err["round_score"] = max(err["round_score"], e14)
        err["round_pick"] = max(err["round_pick"], e15)
        err["round_commit"] = max(err["round_commit"], e16)
        if e14 or e15 or e16:
            bad = [f for f in fields if tensor_diff(getattr(krb, f), getattr(prb, f))]
            raise AssertionError(f"phase 2: the {label}'s {cls} round at pod {a} (k={k}) differs from the "
                                 f"plain versions: K14 {e14} {bad}, K15 {e15}, K16 {e16}")
        done[cls] = done.get(cls, 0) + 1
    missing = [w for w in wanted if not done.get(w)]
    if missing:
        raise AssertionError(f"phase 2: the {label} has no round of classes {missing}")
    return done, first, kbuf


def round_bytes(buf, rb, i: int, mode: int) -> dict:
    """Bytes K14-K16 must move for the round of pod i (each input read once,
    each output written once), and the float operations of K15's search."""
    st, s = buf.statics, buf.state
    n, r = st.alloc.shape
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], s.gpu_free.shape[1]
    f = buf.flags
    g = int(buf.group[i])
    terms = st.g_terms[g]
    terms = terms[terms >= 0]
    tv = int(terms.numel()) if scan.uses_topology(f) else 0
    ti = int((st.ip_of[terms.long()] >= 0).sum()) if tv else 0
    live = int(buf.ext_live[i])
    f4 = 4
    ext_in = (f.storage * n * (v * 2 * f4 + sd * (1 + 2 * f4) + (live & 1) * v * f4)
              + f.gpu * n * gd * (f4 + 1))
    ext_orders = f.storage * n * 3 * (v + sd) * f4 + f.gpu * n * 3 * gd * f4
    k14 = (n + 4 * n * f4 + 2 * n + n * f4 + 2 * n * r * f4 + 4 * n * f4 + ext_in
           + tv * n * 2 * f4 + ti * 3 * n * f4 + 3 * n * f4 + n + ext_orders)
    quota = mode & rounds.V_QUOTA
    k15 = 3 * n * f4 + n + n * f4 + (quota and (n + 2 * n + tv * n * 2 * f4 + ti * n * f4))
    k16 = (n * f4 + 2 * n * r * f4 + tv * n * (f4 + 2 * f4) + ti * 4 * 2 * n * f4
           + ext_orders + f.storage * n * (2 * v * f4 + 2 * sd) + f.gpu * n * 2 * gd * f4
           + rb.k_cap * 4 * 4)
    ops15 = (rounds.BISECT_STEPS + 3) * n * 6
    return {"round_score": k14, "round_pick": k15, "round_commit": k16, "ops_round_pick": ops15}


def time_rounds(tensors, statics, pods, flags, at, label: str) -> dict:
    """K14-K16 at a named round: the device time per launch (profiler), the
    back-to-back launch time from Python, the plain versions' time and the
    bound, from the round's start state."""
    i, k, mode, _ = at
    rb = round_at(tensors, statics, pods, flags, at)
    buf = rb.buf
    calls = {
        "round_score": (lambda: rounds.round_score(rb, i, mode), lambda: rounds.round_score_plain(rb, i, mode)),
        "round_pick": (lambda: rounds.round_pick(rb, i, k, mode), lambda: rounds.round_pick_plain(rb, i, k, mode)),
        "round_commit": (lambda: rounds.round_commit(rb, i, k, mode, 0),
                         lambda: rounds.round_commit_plain(rb, i, k, mode, 0)),
    }
    per, _, _ = profile_kernels(lambda: [(calls["round_score"][0](), calls["round_pick"][0](),
                                          calls["round_commit"][0]()) for _ in range(20)],
                                {name: kern for name, (kern, _) in calls.items()})
    nbytes = round_bytes(buf, rb, i, mode)
    out = {}
    for name, (kern, plain) in calls.items():
        host_ms = time_call(kern, 200)
        plain_ms = time_call(plain, 3)
        bytes_ms = nbytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = nbytes.get(f"ops_{name}", 0) / FP32_OPS_PER_S * 1e3
        out[name] = {"ms": per[name][0] / 1e3, "host_ms": host_ms, "plain_ms": plain_ms,
                     "bytes": nbytes[name], "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "operations" if ops_ms > bytes_ms else "bytes", "round": label}
        if name in cuda.CLUSTER_KERNELS:
            out[name]["plan"] = cuda.round_plan(int(tensors.n_nodes), int(statics.g_terms.shape[1]))
        log(f"  {name} at the {label} round (pod {i}, k={k}, N={tensors.n_nodes}): {out[name]['ms'] * 1e3:.2f} us "
            f"device (profiler), {host_ms * 1e3:.2f} us per back-to-back launch from Python, plain "
            f"{plain_ms * 1e3:.1f} us, {nbytes[name]} B, bound {out[name]['bound_ms'] * 1e3:.3f} us "
            f"({out[name]['bound_by']})")
    return out


def phase_carry_copy(tensors, state, device, err) -> dict:
    """K17 against its plain version on a dense and a compact carry: every
    plane equal, fresh storage, and the source untouched when the copy is
    written. Returns its time and bound at the compact carry."""
    spec = sstate.compact_spec_dev(tensors, device)
    dense = clone_state(state)
    compact = sstate.compress_state(spec, clone_state(state))
    out = {}
    for label, carry in (("dense", dense), ("compact", compact)):
        before = type(carry)(*(t.clone() for t in carry))
        got = tinc._copy_state(carry)
        want = tinc.copy_carry_plain(carry)
        torch.cuda.synchronize()
        e = max(tensor_diff(a, b) for a, b in zip(got, want) if a.numel())
        err["carry_copy"] = max(err["carry_copy"], e)
        ptrs = {t.untyped_storage().data_ptr() for t in carry if t.numel()}
        if e or any(t.untyped_storage().data_ptr() in ptrs for t in got if t.numel()):
            raise AssertionError(f"phase 2: K17 on the {label} carry differs or shares storage ({e})")
        for t in got:
            if t.numel() and t.dtype != torch.bool:
                t.add_(1)
        torch.cuda.synchronize()
        if any(tensor_diff(a, b) for a, b in zip(carry, before) if a.numel()):
            raise AssertionError(f"phase 2: writing K17's copy moved the {label} snapshot")
        nbytes = 2 * sum(t.numel() * t.element_size() for t in carry)
        per, _, _ = profile_kernels(lambda: [tinc._copy_state(carry) for _ in range(20)],
                                    {"carry_copy": lambda: tinc._copy_state(carry)})
        # the one PyTorch call that computes the same copy (into planes
        # allocated beforehand), timed here and used nowhere in the port
        dst = [torch.empty_like(t) for t in carry]
        out[label] = {"ms": per["carry_copy"][0] / 1e3,
                      "host_ms": time_call(lambda: tinc._copy_state(carry), 200),
                      "plain_ms": time_call(lambda: tinc.copy_carry_plain(carry), 20),
                      "library_ms": device_ms_per_call(lambda: torch._foreach_copy_(dst, list(carry)), 20),
                      "library_host_ms": time_call(lambda: torch._foreach_copy_(dst, list(carry)), 200),
                      "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"  carry_copy ({label} carry, {len(carry)} planes): {out[label]['ms'] * 1e3:.2f} us device "
            f"(profiler), {out[label]['host_ms'] * 1e3:.2f} us per back-to-back call from Python, plain "
            f"{out[label]['plain_ms'] * 1e3:.1f} us, torch._foreach_copy_ {out[label]['library_ms'] * 1e3:.2f} us "
            f"device (profiler, every kernel it launched) and {out[label]['library_host_ms'] * 1e3:.2f} us per "
            f"back-to-back call, {nbytes} B, bound {out[label]['bound_ms'] * 1e3:.3f} us")
    return out


def new_round_steps() -> dict:
    return dict(new_steps(), rounds=0, round_storage=0, round_gpu=0, probe_pods=0, place_s=0.0)


class CountingRoundsEngine(rounds.RoundsEngine):
    """The rounds engine, counting on the host: the rounds it dispatches
    (and how many need K5 / K6), and the pod steps of its serial ranges
    (their wave plans, as CountingEngine) and of its leftover probes."""

    steps = new_round_steps()

    def _run_range(self, buf, pods, a, b):
        steps = CountingRoundsEngine.steps
        groups = np.asarray(self._current_batch.group)[a:b]
        sub = tuple(np.asarray(x)[a:b] for x in pods)
        in_wave = np.zeros(b - a, bool)
        if self.speculate and b > a:
            ok = wavefront.wave_eligibility(sub, groups, self._current_tensors)
            for _, _, waves in wavefront.plan_waves(groups, self._current_tensors, buf.flags, ok):
                for wa, wb, hard, _, heavy in waves:
                    in_wave[wa:wb] = True
                    steps["wave_hard" if hard or heavy else "wave_lean"] += 1
        self._count_pods(buf, np.arange(a, b)[~in_wave])
        steps["wave_pods"] += int(in_wave.sum())
        return super()._run_range(buf, pods, a, b)

    def _run_scan_segment_idx(self, buf, pods, idx):
        CountingRoundsEngine.steps["probe_pods"] += len(idx)
        self._count_pods(buf, np.asarray(idx))
        return super()._run_scan_segment_idx(buf, pods, idx)

    @staticmethod
    def _count_pods(buf, idx) -> None:
        steps = CountingRoundsEngine.steps
        steps["pods"] += len(idx)
        steps["storage"] += int(buf.storage_live[idx].sum())
        steps["gpu"] += int(buf.gpu_live[idx].sum())

    def place(self, batch):
        t0 = time.perf_counter()
        try:
            return super().place(batch)
        finally:
            CountingRoundsEngine.steps["place_s"] += time.perf_counter() - t0

    def _bulk_chunk(self, rb, chunk, quota, self_aff, ext_mats):
        steps = CountingRoundsEngine.steps
        firsts = np.array([i0 for _, i0, _ in chunk])
        steps["rounds"] += len(chunk)
        steps["round_storage"] += int(rb.buf.storage_live[firsts].sum())
        steps["round_gpu"] += int(rb.buf.gpu_live[firsts].sum())
        return super()._bulk_chunk(rb, chunk, quota, self_aff, ext_mats)


def check_round_launches(label: str, launches: dict, steps: dict, plain_calls: int) -> None:
    """K14-K16 once per round; K3/K4 once per serial pod step outside the
    waves and per probe; K1/K2 once per such step and once per round; K5
    / K6 once per storage / GPU step or round; K9/K10 once per planned
    wave; no plain call."""
    want = {"round_score": steps["rounds"], "round_pick": steps["rounds"], "round_commit": steps["rounds"],
            "score_argmax_pod": steps["pods"], "commit_pod": steps["pods"],
            "filter_pod": steps["pods"] + steps["rounds"], "topology_pod": steps["pods"] + steps["rounds"],
            "storage_pod": steps["storage"] + steps["round_storage"],
            "gpu_pod": steps["gpu"] + steps["round_gpu"],
            "wave_lean": steps["wave_lean"], "wave_hard": steps["wave_hard"]}
    bad = {k: (launches.get(k, 0), v) for k, v in want.items() if launches.get(k, 0) != v}
    if bad or plain_calls:
        raise AssertionError(f"{label}: launches (got, want) {bad}, plain calls {plain_calls}; steps {steps}")


def run_bulk(card: str):
    """The bulk main path: `simulate(bulk=True, device="cuda")` on the bulk
    problem with every count set to 0 just before and read just after,
    under the profiler. The record must equal the golden file, K14-K16
    must have launched once per round of the JAX segment plan, the serial
    kernels only on the serial segments and the probes, no plain version.
    Returns (launches, steps, wall, pods, device busy per kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cluster, apps = smoke.bulk_problem(synth)
    CountingRoundsEngine.steps = new_round_steps()
    real = rounds.RoundsEngine
    rounds.RoundsEngine = CountingRoundsEngine
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = simtpu_torch.simulate(cluster, apps, bulk=True, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        seed_name_hashes(None)
        rounds.RoundsEngine = real
    launches, steps = dict(cuda.LAUNCHES), dict(CountingRoundsEngine.steps)
    plain_calls = sum(cuda.PLAIN_CALLS.values())
    check_round_launches("phase 6", launches, steps, plain_calls)
    check_compact("phase 6", launches, smoke.COMPACT_CARRY["bulk"])
    gauge = check_gauge("phase 6", smoke.COMPACT_CARRY["bulk"])
    want_rounds = sum(r for kind, (r, _) in smoke.BULK_SEGMENTS.items() if kind != "scan")
    if steps["rounds"] != want_rounds:
        raise AssertionError(f"phase 6: {steps['rounds']} rounds, the JAX segment plan has {want_rounds}")
    record = smoke.bulk_record(result)
    diffs = smoke.bulk_differences(record, smoke.load_record(smoke.BULK_GOLDEN))
    if diffs:
        raise AssertionError("phase 6: the bulk run differs from the golden record:\n" + "\n".join(diffs))
    dev = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        name = kernel_of(ev.key)
        if name is not None:
            dev[name] = dev.get(name, 0.0) + dev_us / 1e6
    round_s = sum(dev.get(k, 0.0) for k in ROUND_KERNELS)
    busy_s = sum(dev.values())
    n_pods = record["pods"]
    log(f"phase 6: simulate(bulk=True, device='cuda') on the bulk problem, {len(record['nodes'])} nodes x "
        f"{n_pods} pods: {wall:.2f} s under the profiler, {n_pods / wall:.0f} pods/s "
        f"({steps['place_s']:.3f} s in Engine.place, the rest expansion, tensorize and results on the host), "
        f"{steps['rounds']} rounds "
        f"({round_s:.4f} s of device time in K14-K16, {round_s / wall:.4f} of the wall; all kernels "
        f"{busy_s:.4f} s, {busy_s / wall:.4f}), {steps['pods']} serial pod steps ({steps['probe_pods']} in "
        f"leftover probes), {steps['wave_pods']} pods in {steps['wave_lean']} + {steps['wave_hard']} waves, "
        f"{sum(record['reasons'].values())} unscheduled, record == golden; carried {gauge['carried_bytes']} B "
        f"(dense {gauge['dense_bytes']} B); launches {launches} [{card}]")
    return launches, steps, wall, n_pods, {"rounds_device_s": round_s, "device_s": busy_s}


def run_large_capacity(card: str):
    """The large capacity problem through the apply front door on the card:
    the auto-selection must pick bulk placement and the incremental search
    with the JAX package's notice, the plan must equal the golden record,
    K17 must have launched once per probe's snapshot copy, and no plain
    version may run. Returns (plan, launches, wall, the last audit's K8
    inputs: the winner's log)."""
    cluster, apps, template = smoke.large_capacity_problem(synth, simtpu_torch.AppResource,
                                                           simtpu_torch.ResourceTypes)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke.write_capacity_config(tmp, cluster, apps, template)
        applier = Applier(ApplierOptions(simon_config=cfg, device="cuda"))
        cuda.reset_counts()
        seed_name_hashes(smoke.NAME_SEED)
        err_text = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(err_text), AuditCapture() as audits:
                plan = applier.run()
            torch.cuda.synchronize()
        finally:
            seed_name_hashes(None)
        wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    plain_calls = sum(cuda.PLAIN_CALLS.values())
    if smoke.LCAP_AUTO_LINE not in err_text.getvalue().splitlines():
        raise AssertionError(f"phase 7: the auto-selection notice differs: {err_text.getvalue()!r}")
    diffs = smoke.plan_differences(smoke.plan_record(plan), smoke.load_record(smoke.LCAP_GOLDEN))
    if diffs:
        raise AssertionError("phase 7: the plan differs from the golden record:\n" + "\n".join(diffs))
    check_compact("phase 7", launches, smoke.COMPACT_CARRY["large_capacity"])
    check_gauge("phase 7", smoke.COMPACT_CARRY["large_capacity"])
    n_probes = sum(c["phase"] == "probes" for c in plan.candidates)
    if (plan.engine["search"], plan.engine["bulk"]) != ("incremental", True) or plain_calls \
            or launches.get("carry_copy", 0) != n_probes or not all(launches.get(k, 0) for k in ROUND_KERNELS):
        raise AssertionError(f"phase 7: engine {plan.engine['search']}/{plan.engine['bulk']}, launches "
                             f"{launches} for {n_probes} probes, plain calls {plain_calls}")
    phases = " ".join(f"{k}={v:.3f}s" for k, v in plan.timings.items())
    runs = ", ".join("%s +%d %.3fs" % (c["phase"], c["count"], c["wall_s"]) for c in plan.candidates)
    n_all = smoke.LCAP_PODS + sum(b[1] for b in smoke.LCAP_BURST)
    log(f"phase 7: apply (Applier.run, auto: {plan.engine['search']} search, bulk) on the large capacity "
        f"problem ({len(cluster.nodes)} nodes, {n_all} pods): {plan.nodes_added} nodes added, probes "
        f"{plan.probes}, audit {plan.audit.get('ok')}, plan == golden; {wall:.2f} s; phases {phases}; "
        f"{len(plan.candidates)} placements ({runs}); launches {launches} [{card}]")
    if audits.last is None:
        raise AssertionError(f"phase 7: no audit reached K8 (launches {launches})")
    return plan, launches, wall, audits.last


def quota_key_domains(statics, pods, a: int) -> int:
    """The domains on t*'s key (the first self-matching hard term of the
    round's group, engine/rounds.py _quota_fill): the most K15's quota
    ladder can list."""
    g = int(pods[0][a])
    terms = statics.g_terms[g].cpu().numpy()
    hard = (statics.s_match[g] & (statics.a_anti_req[g] | (statics.spread_hard[g] > 0))).cpu().numpy() & (terms >= 0)
    term = int(terms[int(np.argmax(hard))])
    dom = statics.node_dom[int(statics.term_topo[term])].cpu().numpy()
    return len(np.unique(dom[dom >= 0]))


#: the round above K15's register path: the bulk mix at this many nodes
#: (cuda.round_pick_plan: the nodes' rows re-read from global memory, the
#: quota ranking's buffers in RoundCtx.iscr)
PICK_GLOBAL_CUT = (9000, 20000)
#: the bulk mix at two more node counts for K14/K16's plans: a cluster
#: whose last tile is ragged, and one block (cuda.round_plan)
ROUND_RAGGED_CUT = (3001, 20000)
ROUND_ONE_BLOCK_CUT = (120, 20000)


def plan_line(tensors, statics) -> str:
    plan = cuda.round_plan(int(tensors.n_nodes), int(statics.g_terms.shape[1]))
    last = int(tensors.n_nodes) - (plan["blocks"] - 1) * plan["tile"]
    return (f"K14/K16 plan B={plan['blocks']} x {plan['threads']} threads, tile {plan['tile']} (last {last}), "
            f"template {plan['template']}, K16 {plan['shared_bytes']} B shared")


def phase_bulk_kernels(device, err):
    """Phase 2 for K14-K17: the rounds of the bulk problem (plain,
    quota-spread with t*'s 16 zones, quota-anti with its 5000 hostnames,
    storage), of the matrix cut (matrix, self-affinity, GPU rounds) and of
    the bulk mix at 9000 nodes (plain, quota-spread, quota-anti: K15's
    global-memory paths) against their plain versions, K17 on the bulk
    carry, dense and compact; then their times at named rounds. Returns
    the times and the named rounds' inputs (phase 6 splits K15 on them)."""
    b_tensors, b_batch, b_statics, b_state, b_pods = problem_batch(*smoke.bulk_problem(synth), device)
    b_flags = scan.flags_from(b_tensors, b_batch.ext)
    log(f"phase 2: bulk shape N={b_tensors.n_nodes} T={b_tensors.n_terms} G={len(b_tensors.groups)} "
        f"Tc={b_statics.g_terms.shape[1]} domains={b_tensors.n_domains} pods={len(b_pods[0])} flags={b_flags}")
    b_done, b_first, b_buf = phase_rounds("bulk problem", b_tensors, b_batch, b_statics, b_state, b_pods,
                                          b_flags, ("plain", "quota-spread", "quota-anti", "storage"), err)
    log(f"phase 2: bulk problem: {plan_line(b_tensors, b_statics)}")
    if cuda.round_plan(int(b_tensors.n_nodes), int(b_statics.g_terms.shape[1]))["blocks"] < 2:
        raise AssertionError("phase 2: the bulk problem's rounds take one block")
    doms = {cls: quota_key_domains(b_statics, b_pods, b_first[cls][0]) for cls in ("quota-spread", "quota-anti")}
    if not (doms["quota-spread"] <= cuda.PICK_WARP_LADDER < doms["quota-anti"]):
        raise AssertionError(f"phase 2: the bulk quota rounds' keys have {doms} domains")
    m_tensors, m_batch, m_statics, m_state, m_pods = problem_batch(*smoke.matrix_problem(synth), device)
    m_flags = scan.flags_from(m_tensors, m_batch.ext)
    log(f"phase 2: matrix cut N={m_tensors.n_nodes} V={m_statics.vg_cap.shape[1]} "
        f"GD={m_state.gpu_free.shape[1]} pods={len(m_pods[0])} flags={m_flags}")
    m_done, m_first, _ = phase_rounds("matrix cut", m_tensors, m_batch, m_statics, m_state, m_pods, m_flags,
                                      ("bulkm", "bulka", "gpu"), err)
    log(f"phase 2: matrix cut: {plan_line(m_tensors, m_statics)}")
    # the large capacity problem's rounds (phase 7 plans on its 2000 nodes)
    l_cluster, l_apps, _ = smoke.large_capacity_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    l_tensors, l_batch, l_statics, l_state, l_pods = problem_batch(l_cluster, l_apps, device)
    l_flags = scan.flags_from(l_tensors, l_batch.ext)
    l_done, l_first, _ = phase_rounds("large capacity problem", l_tensors, l_batch, l_statics, l_state, l_pods,
                                      l_flags, ("plain",), err)
    log(f"phase 2: large capacity problem: {plan_line(l_tensors, l_statics)}")
    w_tensors, w_batch, w_statics, w_state, w_pods = problem_batch(
        *smoke.bulk_problem(synth, *PICK_GLOBAL_CUT), device)
    w_flags = scan.flags_from(w_tensors, w_batch.ext)
    w_plan = cuda.round_pick_plan(w_tensors.n_nodes, w_statics.g_terms.shape[1], quota=True)
    if w_plan["template"] != "global" or w_plan["sort"] != "global":
        raise AssertionError(f"phase 2: the {PICK_GLOBAL_CUT[0]}-node rounds take K15's plan {w_plan}")
    w_done, w_first, _ = phase_rounds(f"bulk mix at {PICK_GLOBAL_CUT[0]} nodes", w_tensors, w_batch, w_statics,
                                      w_state, w_pods, w_flags, ("plain", "quota-spread", "quota-anti"), err)
    log(f"phase 2: bulk mix at {PICK_GLOBAL_CUT[0]} nodes: {plan_line(w_tensors, w_statics)}")
    edge_done, edge_sweeps = {}, {}
    for cut in (ROUND_RAGGED_CUT, ROUND_ONE_BLOCK_CUT):
        e_tensors, e_batch, e_statics, e_state, e_pods = problem_batch(*smoke.bulk_problem(synth, *cut), device)
        e_plan = cuda.round_plan(int(e_tensors.n_nodes), int(e_statics.g_terms.shape[1]))
        ragged = e_tensors.n_nodes % e_plan["tile"] != 0
        if (cut == ROUND_ONE_BLOCK_CUT) != (e_plan["blocks"] == 1) or not ragged:
            raise AssertionError(f"phase 2: the bulk mix at {cut[0]} nodes takes the plan {e_plan}")
        e_flags = scan.flags_from(e_tensors, e_batch.ext)
        edge_done[cut[0]], e_first, _ = phase_rounds(f"bulk mix at {cut[0]} nodes", e_tensors, e_batch, e_statics,
                                                     e_state, e_pods, e_flags, ("plain", "quota-spread", "quota-anti"),
                                                     err)
        log(f"phase 2: bulk mix at {cut[0]} nodes: {plan_line(e_tensors, e_statics)}")
        edge_sweeps[f"{cut[0]} plain"] = round_sweep(f"{cut[0]}-node plain", e_tensors, e_statics, e_pods, e_flags,
                                                     e_first["plain"], err)
        del e_tensors, e_batch, e_statics, e_state, e_pods
    log(f"phase 2: K14-K16 equal to their plain versions (caps, s0, slope, fill orders, m_n, every state "
        f"plane, the slot outputs) on rounds of the bulk problem {b_done} (t*'s key: {doms['quota-spread']} "
        f"domains on the quota-spread round, {doms['quota-anti']} on the quota-anti round), the matrix cut "
        f"{m_done}, the large capacity problem {l_done}, the bulk mix at {w_tensors.n_nodes} nodes x "
        f"{PICK_GLOBAL_CUT[1]} pods {w_done} (K15's "
        f"plan: {w_plan['template']} rows, {w_plan['sort']} ranking buffers) and at "
        + ", ".join(f"{n_} nodes {d}" for n_, d in edge_done.items()))
    sweep = {"bulk plain": round_sweep("bulk plain", b_tensors, b_statics, b_pods, b_flags, b_first["plain"], err),
             "bulk quota-spread": round_sweep("bulk quota-spread", b_tensors, b_statics, b_pods, b_flags,
                                              b_first["quota-spread"], err),
             "matrix bulkm": round_sweep("matrix bulkm", m_tensors, m_statics, m_pods, m_flags, m_first["bulkm"],
                                         err),
             f"{PICK_GLOBAL_CUT[0]} plain": round_sweep(f"{PICK_GLOBAL_CUT[0]}-node plain", w_tensors, w_statics,
                                                        w_pods, w_flags, w_first["plain"], err), **edge_sweeps}
    copy_times = phase_carry_copy(b_tensors, b_buf.state, device, err)
    # the bulk problem's carry, for phase 22's K11
    copy_times["bulk_carry"] = (b_tensors, clone_state(b_buf.state))
    log("phase 2: K17 equal to its plain version on the bulk carry, dense and compact: fresh storage, "
        "the snapshot untouched when the copy is written")
    times = time_rounds(b_tensors, b_statics, b_pods, b_flags, b_first["plain"], "bulk plain")
    q_times = time_rounds(b_tensors, b_statics, b_pods, b_flags, b_first["quota-spread"], "bulk quota-spread")
    a_times = time_rounds(b_tensors, b_statics, b_pods, b_flags, b_first["quota-anti"], "bulk quota-anti")
    x_times = time_rounds(m_tensors, m_statics, m_pods, m_flags, m_first["bulkm"], "matrix bulkm")
    l_times = time_rounds(l_tensors, l_statics, l_pods, l_flags, l_first["plain"], "large capacity plain")
    named = {f"bulk {cls}": (b_tensors, b_statics, b_pods, b_flags, b_first[cls])
             for cls in ("plain", "quota-spread", "quota-anti")}
    named["matrix bulkm"] = (m_tensors, m_statics, m_pods, m_flags, m_first["bulkm"])
    return times, q_times, a_times, x_times, l_times, copy_times, named, sweep


def round_at(tensors, statics, pods, flags, at):
    """The round buffers of a named round (pod i, run length k, variant
    mode, start state): K1/K2 (K5/K6) run for its pod from a copy of the
    start state, K14 and K15 once."""
    i, k, mode, start = at
    buf = scan.StepBuffers(statics, clone_state(start), pods, flags)
    rb = rounds.RoundBuffers(buf, tensors)
    rb.alloc_outputs(1, rounds._pow2(k))
    scan.filter_pod(buf, i)
    if buf.storage_live[i]:
        scan.storage_pod(buf, i)
    if buf.gpu_live[i]:
        scan.gpu_pod(buf, i)
    scan.topology_pod(buf, i)
    rounds.round_score(rb, i, mode)
    rounds.round_pick(rb, i, k, mode)
    torch.cuda.synchronize()
    return rb


#: the phases of each round kernel's profile build, by slot
ROUND_PHASES = {"round_score": cuda.SCORE_PHASES, "round_pick": cuda.PICK_PHASES,
                "round_commit": cuda.COMMIT_PHASES}


def round_split(name: str, tensors, statics, pods, flags, at) -> dict:
    """Round kernel `name` (K14-K16) phase by phase at a named round: the
    main build's device time per launch (CUDA events), the profile build's
    cycles per phase (thread 0 of block 0's clock64() stamps) scaled to µs
    by the profile build's own time per launch, and for K15 the bisection
    steps (threshold) or radix passes (quota) and the ladder levels. K16's
    launches start from the round's state each time. The profile build's
    launches are measurements, not counted."""
    i, k, mode, _ = at
    rb = round_at(tensors, statics, pods, flags, at)
    start = clone_state(rb.buf.state)
    setup = (lambda: copy_state(rb.buf.state, start)) if name == "round_commit" else (lambda: None)
    main = {"round_score": lambda _: rounds.round_score(rb, i, mode),
            "round_pick": lambda _: rounds.round_pick(rb, i, k, mode),
            "round_commit": lambda _: rounds.round_commit(rb, i, k, mode, 0)}[name]
    main_ms = in_turns({name: main}, setup, per_turn=10)[name]
    prof_ms = in_turns({name: lambda _: cuda.launch_round_profile(name, rb, i, k, mode)}, setup,
                       per_turn=10)[name]
    cuda.round_prof(name)
    setup()
    cuda.launch_round_profile(name, rb, i, k, mode)
    torch.cuda.synchronize()
    prof = cuda.round_prof(name)
    phases = ROUND_PHASES[name]
    us_per_cycle = prof_ms * 1e3 / max(sum(prof[:len(phases)]), 1)
    n = int(tensors.n_nodes)
    tc = int(statics.g_terms.shape[1])
    out = {"pod": i, "k": k, "n": n, "us_per_launch": main_ms * 1e3, "profile_build_us": prof_ms * 1e3,
           "phase_us": {ph: prof[q] * us_per_cycle for q, ph in enumerate(phases) if prof[q]}}
    if name == "round_pick":
        out.update(steps_or_passes=prof[len(phases)], ladder_levels=prof[len(phases) + 1],
                   plan=cuda.round_pick_plan(n, tc, quota=bool(mode & rounds.V_QUOTA)))
    else:
        out["plan"] = cuda.round_plan(n, tc)
    if name == "round_commit":
        copy_state(rb.buf.state, start)
    return out


#: phase 2's cluster sweep: K14 / K16 at these blocks a cluster
SWEEP_BLOCKS = (1, 2, 4, 8, 16)


def round_sweep(label: str, tensors, statics, pods, flags, at, err) -> dict:
    """K14 and K16 at a named round on a cluster of each of SWEEP_BLOCKS
    blocks (the plan's tile and template follow): each equal to the plain
    versions bit for bit (K14's rows, then K15 and K16 from the same state:
    every state plane and the slot outputs), then each block count's device
    time per launch in turns (CUDA events; K16 from the round's state each
    launch). Returns {blocks: {plan, K14 µs, K16 µs}} and the plan's own
    block count."""
    i, k, mode, start = at
    rb = round_at(tensors, statics, pods, flags, at)
    base = clone_state(rb.buf.state)
    pbuf = scan.StepBuffers(statics, clone_state(base), pods, flags)
    for f in ROUND_SCRATCH:
        getattr(pbuf, f).copy_(getattr(rb.buf, f))
    prb = rounds.RoundBuffers(pbuf, tensors)
    prb.alloc_outputs(1, rb.k_cap)
    rounds.round_score_plain(prb, i, mode)
    rounds.round_pick_plain(prb, i, k, mode)
    rounds.round_commit_plain(prb, i, k, mode, 0)
    quota = bool(mode & rounds.V_QUOTA)
    mats = bool(mode & rounds.V_MATS)
    fields14 = ["cap", "m_all"] + ([] if quota else ["s0", "slope"])
    if flags.storage:
        fields14 += ["ord_vg", "cs_vg", "cum_vg", "ord_dev", "cs_dev", "cum_dev"]
    if flags.gpu:
        fields14 += ["ord_gpu", "cs_gpu", "cum_gpu"] + (["c_gpu", "cum_gidx"] if mats else [])
    outs = ("assign", "dev_idx", "lvm_mat", "gpu_mat") if mats else ("assign", "vg_idx", "dev_idx", "gpu_idx")
    n, tc = int(tensors.n_nodes), int(statics.g_terms.shape[1])
    res = {}
    for b in SWEEP_BLOCKS:
        copy_state(rb.buf.state, base)
        cuda.launch_round("round_score", rb, i, 0, mode, 0, blocks=b)
        torch.cuda.synchronize()
        e14 = round_diff(rb, prb, fields14)
        rounds.round_pick(rb, i, k, mode)
        cuda.launch_round("round_commit", rb, i, k, mode, 0, blocks=b)
        torch.cuda.synchronize()
        e16 = max(state_diff(rb.buf.state, pbuf.state), round_diff(rb, prb, outs), tensor_diff(rb.m_n, prb.m_n))
        err["round_score"] = max(err["round_score"], e14)
        err["round_commit"] = max(err["round_commit"], e16)
        if e14 or e16:
            raise AssertionError(f"phase 2: the {label} round at {b} blocks differs from the plain versions: "
                                 f"K14 {e14}, K16 {e16}")
        res[b] = {"plan": cuda.round_plan(n, tc, b)}
    copy_state(rb.buf.state, base)
    t14 = in_turns({b: (lambda _, b=b: cuda.launch_round("round_score", rb, i, 0, mode, 0, blocks=b))
                    for b in SWEEP_BLOCKS}, lambda: None, per_turn=5)
    t16 = in_turns({b: (lambda _, b=b: cuda.launch_round("round_commit", rb, i, k, mode, 0, blocks=b))
                    for b in SWEEP_BLOCKS}, lambda: copy_state(rb.buf.state, base), per_turn=5)
    copy_state(rb.buf.state, base)
    for b in SWEEP_BLOCKS:
        res[b].update(round_score_us=t14[b] * 1e3, round_commit_us=t16[b] * 1e3)
    chosen = cuda.round_plan(n, tc)["blocks"]
    log(f"phase 2: K14/K16 cluster sweep at the {label} round (pod {i}, k={k}, N={n}): equal to the plain "
        f"versions at every block count; " + ", ".join(
            f"B={b} ({r['plan']['template']}, {r['plan']['threads']} threads) {r['round_score_us']:.2f} / "
            f"{r['round_commit_us']:.2f} us" for b, r in res.items()) + f"; the plan takes B={chosen}")
    return {"rounds": {str(b): r for b, r in res.items()}, "plan_blocks": chosen, "n": n}


# -- the batched sweeps (K18 sweep_drain, K19 sweep_place) --------------------


class PlaceTimer:
    """Context manager: while open, every K19 launch is bracketed by CUDA
    events on its stream and its chunk's longest pod list is kept (K19's
    block time follows the longest list of its chunk). `summary()` gives
    the launches, their device ms, µs per launch and µs per pod step."""

    def __enter__(self):
        self.orig = cuda.launch_sweep_place
        self.marks = []

        def timed(sb):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            self.orig(sb)
            e1.record()
            self.marks.append((e0, e1, sb.rows))

        cuda.launch_sweep_place = timed
        return self

    def __exit__(self, *exc):
        cuda.launch_sweep_place = self.orig
        return False

    def summary(self) -> dict:
        torch.cuda.synchronize()
        ms = [e0.elapsed_time(e1) for e0, e1, _ in self.marks]
        steps = [int((rows >= 0).sum(dim=1).max()) for _, _, rows in self.marks]
        total = sum(ms)
        return {"launches": len(ms), "device_ms": total,
                "us_per_launch": total / len(ms) * 1e3 if ms else None, "pod_steps": sum(steps),
                "us_per_pod_step": total * 1e3 / sum(steps) if sum(steps) else None}


def in_turns(launchers: dict, setup, per_turn: int = 2) -> dict:
    """Median device ms per launch of each of `launchers` ({label: fn},
    each launching one kernel on setup()'s argument): CUDA events around
    each launch, three turns of `per_turn` launches a side, the sides'
    order reversed every other turn (a, b, b, a, a, b)."""
    sides = list(launchers)
    order = [k for turn in range(3) for k in (sides if turn % 2 == 0 else sides[::-1])]
    got = {k: [] for k in launchers}
    for side in order:
        for _ in range(per_turn):
            arg = setup()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            # the card kept busy (~0.5 ms) while the host builds the launch,
            # so the events hold the kernel and not the host's call
            torch.cuda._sleep(1_000_000)
            e0.record()
            launchers[side](arg)
            e1.record()
            torch.cuda.synchronize()
            got[side].append(e0.elapsed_time(e1))
    return {k: float(np.median(v)) for k, v in got.items()}


def time_place(inp, valid, ev_idx, rq_idx) -> dict:
    """K19's device time per launch on a chunk (CUDA events; each launch on
    replicas freshly drained by K18), and per pod step of the chunk's
    longest list."""
    steps = int((rq_idx >= 0).sum(dim=1).max())
    ms = in_turns({"K19": batched.sweep_place}, lambda: batched.SweepBuffers(
        inp.batch_buf, inp.pods, inp.statics, batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx),
        valid, rq_idx))["K19"]
    return {"longest_list": steps, "us_per_launch": ms * 1e3, "us_per_pod_step": ms * 1e3 / max(steps, 1)}


def place_rates(t: dict) -> str:
    return (f"K19 {t['us_per_launch']:.2f} us per launch, {t['us_per_pod_step']:.2f} us per pod step of the longest "
            f"list of {t['longest_list']} (CUDA events)")


def sweep_bytes(inp, valid, ev_idx, rq_idx) -> dict:
    """Bytes K18 and K19 must move for one chunk (each input read once,
    each output written once): K18 reads the base carry and its entries'
    log rows and writes S replicas; K19 reads the S replicas, the statics,
    the masks, its index rows and their pod arrays, and writes two words
    per row. K19's commits update the replicas in place and nothing reads
    them after the chunk, so the replicas count once, as reads."""
    s = valid.shape[0]
    dense = sum(t.numel() * t.element_size() for t in inp.state)
    ev = ev_idx[ev_idx >= 0].long()
    log_row = sum(t[0].numel() * t.element_size() for t in inp.log.values() if t.shape[0]) if ev.numel() else 0
    rows = rq_idx[rq_idx >= 0].long()
    buf = inp.batch_buf
    pod_row = sum(getattr(buf, f)[0].numel() * getattr(buf, f).element_size() for f in batched.POD_FIELDS)
    statics = sum(t.numel() * t.element_size() for t in inp.statics)
    return {
        "sweep_drain": dense + s * dense + int(ev.numel()) * (log_row + 4),
        "sweep_place": s * dense + statics + valid.numel() + int(rows.numel()) * (pod_row + 4 + 8),
    }


def time_drain(inp, ev_idx) -> dict:
    """K18's device time per launch on a chunk (CUDA events around the
    launch alone, on replicas allocated before; in turns), its plan, the
    bytes bound, and the copy-only yardstick: `batched.replicas(base, S,
    fill=True)`, one `repeat` per plane (device time, the profiler)."""
    s = ev_idx.shape[0]
    reps = batched.replicas(inp.state, s)
    us = in_turns({"K18": lambda _: cuda.launch_sweep_drain(inp.statics, inp.state, reps, inp.log, ev_idx)},
                  lambda: None, per_turn=5)["K18"] * 1e3
    dense = sum(t.numel() * t.element_size() for t in inp.state)
    ev = ev_idx[ev_idx >= 0].long()
    log_row = sum(t[0].numel() * t.element_size() for t in inp.log.values() if t.shape[0]) if ev.numel() else 0
    nbytes = dense + s * dense + int(ev.numel()) * (log_row + 4)
    st = inp.state
    width = (st.free.shape[1] + st.ports_used.shape[1] + 2 * st.vols_any.shape[1] + st.vg_free.shape[1]
             + st.sdev_free.shape[1] + st.gpu_free.shape[1])
    return {"us": us, "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "scenarios": s,
            "entries": int(ev.numel()), "replicas_us": device_ms_per_call(lambda: batched.replicas(st, s, fill=True),
                                                                           3) * 1e3,
            "plan": cuda.sweep_drain_plan(s, st.free.shape[0], inp.statics.g_terms.shape[1], width,
                                          torch.cuda.get_device_properties(0).multi_processor_count)}


def drain_rates(t: dict) -> str:
    return (f"K18 {t['us']:.2f} us per launch (CUDA events; {t['plan']['blocks']} blocks of {t['plan']['tile']}-node "
            f"tiles), bound {t['bound_us']:.2f} us ({t['us'] / t['bound_us']:.2f}x), copy-only yardstick "
            f"replicas(fill=True) {t['replicas_us']:.2f} us")


def compare_sweep_chunk(phase, label, inp, s0, s1, err, rq_cols=None, sb=None):
    """K18 and K19 against their plain versions on scenarios [s0, s1) of
    `inp` (an faults/sweep.py SweepInputs on the card), the pod lists cut
    to their first `rq_cols` rows, in a chunk of `sb` rows (default: just
    those scenarios): every replica plane after the drain and
    after the requeue, the landing nodes and the reasons. The base carry
    must be untouched. Returns (chunk tensors, requeue rows compared, the
    kernel's landing nodes, the plain versions' seconds)."""
    valid, ev_idx, rq_idx, _ = inp.chunk(s0, s1, sb or s1 - s0)
    if rq_cols is not None:
        rq_idx = rq_idx[:, :rq_cols].contiguous()
    base = clone_state(inp.state)
    reps_k = batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx)
    torch.cuda.synchronize()
    t = time.perf_counter()
    reps_p = batched.sweep_drain_plain(inp.statics, inp.state, inp.log, ev_idx)
    torch.cuda.synchronize()
    plain = {"sweep_drain": time.perf_counter() - t}
    d = state_diff(reps_k, reps_p)
    err["sweep_drain"] = max(err["sweep_drain"], d)
    if d:
        raise AssertionError(f"{phase}: K18 on the {label} differs from its plain version by {d}")
    sb_k = batched.SweepBuffers(inp.batch_buf, inp.pods, inp.statics, reps_k, valid, rq_idx)
    sb_p = batched.SweepBuffers(inp.batch_buf, inp.pods, inp.statics, reps_p, valid, rq_idx)
    batched.sweep_place(sb_k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    batched.sweep_place_plain(sb_p)
    torch.cuda.synchronize()
    plain["sweep_place"] = time.perf_counter() - t
    (nk, rk), (np_, rp) = sb_k.outputs(), sb_p.outputs()
    d = state_diff(sb_k.reps, sb_p.reps)
    err["sweep_place"] = max(err["sweep_place"], d)
    if d or not np.array_equal(nk, np_) or not np.array_equal(rk, rp):
        raise AssertionError(f"{phase}: K19 on the {label} differs from its plain version "
                             f"(planes {d}, nodes {int((nk != np_).sum())}, reasons {int((rk != rp).sum())})")
    if state_diff(base, inp.state):
        raise AssertionError(f"{phase}: K18/K19 on the {label} wrote into the base carry")
    return (valid, ev_idx, rq_idx), int((rq_idx >= 0).sum()), nk, plain


def phase_sweep_kernels(device, err) -> dict:
    """K18/K19 against their plain versions on the extended problem's
    `place_cluster` (storage and GPU pods in the requeue): a chunk of 16
    single-node scenarios and a chunk of 4 zone outages (pod lists cut to
    48 rows, the plain version's time); then their times on the k=1 chunk
    (the profiler's device time, the host's enqueue, the plain versions')
    and the bytes bound."""
    cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        t0 = time.perf_counter()
        pc = tfaults.place_cluster(cluster, apps, device="cuda")
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
    finally:
        seed_name_hashes(None)
    inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "k=1"))
    # the 16 single-node scenarios that evict the most pods
    order = np.argsort([-len(v) for v in inp.rq_lists], kind="stable")[:16]
    keep = np.zeros(len(inp.masks), bool)
    keep[order] = True
    inp = tsweep.SweepInputs(pc, tfaults.ScenarioSet(masks=inp.masks[keep], labels=tuple(
        f"node:{i}" for i in np.flatnonzero(keep))))
    (valid, ev_idx, rq_idx), k_rows, nodes, plain = compare_sweep_chunk(
        "phase 2", "extended problem's k=1 chunk", inp, 0, 16, err)
    live = inp.batch_buf.ext_live.cpu().numpy()[rq_idx[rq_idx >= 0].cpu().numpy()]
    z_inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "zone"))
    (_, _, z_rq), z_rows, _, _ = compare_sweep_chunk("phase 2", "extended problem's zone chunk", z_inp, 0, 4,
                                                     err, rq_cols=48)
    z_idx = z_rq.cpu().numpy().ravel()
    z_live = z_inp.batch_buf.ext_live.cpu().numpy()[z_idx[z_idx >= 0]]
    n_storage = int((live & 1).sum() + (z_live & 1).sum())
    n_gpu = int((live & 2).sum() + (z_live & 2).sum())
    if not (n_storage and n_gpu):
        raise AssertionError(f"phase 2: the sweep chunks requeue {n_storage} storage and {n_gpu} GPU pods")
    log(f"phase 2: K18/K19 equal to their plain versions (every replica plane after the drain and the "
        f"requeue, nodes, reasons; the base carry untouched) on the extended problem's place_cluster "
        f"({place_s:.2f} s): 16 single-node scenarios ({k_rows} requeue rows, {int((nodes >= 0).sum())} "
        f"re-placed) and 4 zone outages ({z_rows} rows), {n_storage} storage and {n_gpu} GPU pods requeued")
    chunks = {"k1_16": time_place(inp, valid, ev_idx, rq_idx),
              "zone_4": time_place(z_inp, *z_inp.chunk(0, 4, 4)[:3])}
    log(f"  the 16-scenario chunk: {place_rates(chunks['k1_16'])}")
    log(f"  the zone chunk (full lists): {place_rates(chunks['zone_4'])}")
    for n_nodes, n_pods in MID_SWEEPS:
        chunks[f"nodes_{n_nodes}"] = phase_sweep_mid(err, n_nodes, n_pods)
    edges = phase_drain_edges(err, inp)
    drains = {"k1_16": time_drain(inp, ev_idx), "zone_4": time_drain(z_inp, z_inp.chunk(0, 4, 4)[1]),
              "ragged_16": edges["ragged_16"]}
    for label, t in drains.items():
        log(f"  K18 on the {label} chunk: {drain_rates(t)}")

    # times on the k=1 chunk
    sb = batched.SweepBuffers(inp.batch_buf, inp.pods, inp.statics,
                              batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx), valid, rq_idx)
    per, _, _ = profile_kernels(lambda: [inp.run(valid, ev_idx, rq_idx) for _ in range(5)],
                                {"sweep_drain": lambda: batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx),
                                 "sweep_place": lambda: batched.sweep_place(sb)})
    host = {"sweep_drain": [], "sweep_place": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reps = batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx)
        host["sweep_drain"].append(time.perf_counter() - t)
        sb = batched.SweepBuffers(inp.batch_buf, inp.pods, inp.statics, reps, valid, rq_idx)
        torch.cuda.synchronize()
        t = time.perf_counter()
        batched.sweep_place(sb)
        host["sweep_place"].append(time.perf_counter() - t)
    nbytes = sweep_bytes(inp, valid, ev_idx, rq_idx)
    steps = int((rq_idx >= 0).sum(dim=1).max())
    out = {}
    for name in SWEEP_KERNELS:
        dev_us = per[name][0]
        out[name] = {"ms": dev_us / 1e3, "plain_ms": plain[name] * 1e3,
                     "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                     "host_ms": float(np.median(host[name])) * 1e3, "bytes": nbytes[name],
                     "at": f"16 single-node scenarios of the extended problem, {k_rows} requeue rows",
                     "scenarios": 16, "rows": k_rows, "longest_list": steps,
                     "us_per_pod_step": dev_us / max(steps, 1),
                     **({"chunks": chunks} if name == "sweep_place" else {"chunks": drains, "edges": edges["cases"]})}
        log(f"  {name}: {dev_us:.2f} us device per launch (profiler, 16 blocks"
            + (f", {dev_us / max(steps, 1):.2f} us per pod step of the longest list of {steps}" if name == "sweep_place" else "")
            + f"), {out[name]['host_ms'] * 1e3:.2f} us to enqueue, plain {plain[name] * 1e3:.1f} ms, "
            f"{nbytes[name]} B, bound {out[name]['bound_ms'] * 1e3:.3f} us")
    return out


#: K18's edge chunks: the extended mix on (nodes, pods), N no multiple of
#: 4 (no plane's tile part 16-byte aligned) nor of the tile
DRAIN_RAGGED = (999, 4995)


def phase_drain_edges(err, x_inp) -> dict:
    """Phase 2: K18 against its plain version on a tile-ragged N (the
    extended mix at 999 nodes: 16 single-node scenarios), on S = 1, and on
    the broadcast alone (no entry column, and padding columns only) on the
    999-node and on the extended problem's carry; every replica plane,
    the u8 sdev_free among them."""
    cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes,
                                           n_nodes=DRAIN_RAGGED[0], n_pods=DRAIN_RAGGED[1])
    seed_name_hashes(smoke.NAME_SEED)
    try:
        pc = tfaults.place_cluster(cluster, apps, device="cuda")
    finally:
        seed_name_hashes(None)
    inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "k=1"))
    cases = {}

    def check(label, src, ev_idx):
        d = state_diff(batched.sweep_drain(src.statics, src.state, src.log, ev_idx),
                       batched.sweep_drain_plain(src.statics, src.state, src.log, ev_idx))
        err["sweep_drain"] = max(err["sweep_drain"], d)
        if d:
            raise AssertionError(f"phase 2: K18 on the {label} differs from its plain version by {d}")
        cases[label] = {"scenarios": int(ev_idx.shape[0]), "cols": int(ev_idx.shape[1]),
                        "entries": int((ev_idx >= 0).sum())}

    order = np.argsort([-len(v) for v in inp.rq_lists], kind="stable")
    check(f"{DRAIN_RAGGED[0]}-node chunk of 16", inp, inp.chunk(0, 16, 16)[1])
    one = int(order[0])
    check(f"{DRAIN_RAGGED[0]}-node chunk of 1 (S = 1)", inp, inp.chunk(one, one + 1, 1)[1])
    for label, src in ((f"{DRAIN_RAGGED[0]}-node", inp), ("extended", x_inp)):
        for cols in (0, 8):
            check(f"{label} carry, broadcast alone ({cols} padding columns)", src,
                  torch.full((4, cols), -1, dtype=torch.int32, device="cuda"))
    if not cases[f"{DRAIN_RAGGED[0]}-node chunk of 16"]["entries"]:
        raise AssertionError("phase 2: K18's ragged chunk drains no entry")
    sd = int(inp.state.sdev_free.shape[1]), int(x_inp.state.sdev_free.shape[1])
    if min(sd) < 1:
        raise AssertionError(f"phase 2: K18's edge carries have no sdev_free column ({sd})")
    log(f"phase 2: K18 equal to its plain version (every replica plane, sdev_free's u8 columns {sd} among "
        f"them) on {', '.join(cases)}")
    return {"cases": cases, "ragged_16": time_drain(inp, inp.chunk(0, 16, 16)[1])}


#: the chunks between 1024 and 4096 nodes (K19's two- and
#: four-nodes-per-thread templates): the extended problem's mix on (nodes,
#: pods), five pods a node as at 1000 nodes
MID_SWEEPS = ((2000, 10000), (3000, 15000))


def phase_sweep_mid(err, n_nodes: int, n_pods: int) -> dict:
    """Phase 2: K18/K19 against their plain versions on the extended
    problem's mix at `n_nodes` nodes (`place_cluster` on the card): the 16
    single-node scenarios that evict the most pods, the lists cut to 48
    rows for the plain version; then K19's time on the full lists."""
    cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes,
                                           n_nodes=n_nodes, n_pods=n_pods)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        pc = tfaults.place_cluster(cluster, apps, device="cuda")
    finally:
        seed_name_hashes(None)
    inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "k=1"))
    order = np.argsort([-len(v) for v in inp.rq_lists], kind="stable")[:16]
    keep = np.zeros(len(inp.masks), bool)
    keep[order] = True
    inp = tsweep.SweepInputs(pc, tfaults.ScenarioSet(masks=inp.masks[keep], labels=tuple(
        f"node:{i}" for i in np.flatnonzero(keep))))
    (_, _, rq_cut), rows, nodes, plain = compare_sweep_chunk(
        "phase 2", f"{n_nodes}-node chunk", inp, 0, 16, err, rq_cols=48)
    cut = rq_cut.cpu().numpy().ravel()
    live = inp.batch_buf.ext_live.cpu().numpy()[cut[cut >= 0]]
    valid, ev_idx, rq_idx, _ = inp.chunk(0, 16, 16)
    out = dict(time_place(inp, valid, ev_idx, rq_idx), nodes=n_nodes, rows=rows,
               placed=int((nodes >= 0).sum()), storage=int((live & 1).sum()), gpu=int((live & 2).sum()),
               plan=cuda.sweep_place_plan(pc.n_nodes, pc.tensors.alloc.shape[1], inp.statics.g_terms.shape[1]),
               plain_s=plain["sweep_place"])
    log(f"phase 2: K18/K19 equal to their plain versions on 16 single-node scenarios of the extended mix at "
        f"{n_nodes} nodes ({rows} requeue rows compared, {out['storage']} storage and {out['gpu']} GPU "
        f"pods among them; K19's {out['plan']['template']}-node template, {out['plan']['threads']} threads); "
        f"{place_rates(out)}")
    return out


def check_sweep_launches(label, launches: dict, plain: dict, chunks: int) -> None:
    """K18 and K19 once per chunk of the sweep, no plain version."""
    got = {k: launches.get(k, 0) for k in SWEEP_KERNELS}
    if got != dict.fromkeys(SWEEP_KERNELS, chunks) or any(plain.values()):
        raise AssertionError(f"{label}: sweep launches {got} for {chunks} chunks, plain calls {dict(plain)}")


def profiled_sweep(pc, scen):
    """`sweep_scenarios` on the card under the profiler, every count set to
    0 just before and read just after. Returns (sweep, launches, plain
    calls, wall s, K18/K19 device s)."""
    cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    with PlaceTimer() as timer:
        per, _, _ = profile_kernels(lambda: out.append(tfaults.sweep_scenarios(pc, scen)), tries=1)
    wall = time.perf_counter() - t0
    dev_s = sum(per[k][0] * per[k][1] for k in SWEEP_KERNELS if k in per) / 1e6
    per["sweep_place_events"] = timer.summary()
    return out[0], dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS), wall, dev_s, per


def sweep_summary(sw, wall, dev_s, launches, per) -> dict:
    """A main-path sweep's numbers: `scenarios_per_s` is SweepResult's
    (scenarios over the kernels' chunk calls, outputs to the host
    included), `wall_scenarios_per_s` over the whole `sweep_scenarios`
    call (the host assembly too); `sweep_host_s` is the part of the chunk
    calls that is not K18/K19 device time."""
    t = sw.timings
    return {"wall_s": wall, "scenarios": len(sw.scenarios), "chunks": t["chunks"], "sweep_s": t["sweep_s"],
            "scenarios_per_s": t["scenarios_per_s"], "assemble_s": t["assemble_s"], "total_s": t["total_s"],
            "wall_scenarios_per_s": len(sw.scenarios) / t["total_s"], "sweep_device_s": dev_s,
            "sweep_host_s": t["sweep_s"] - dev_s, "sweep_device_share": dev_s / wall, "launches": launches,
            "us_per_launch": {k: per[k][0] for k in SWEEP_KERNELS if k in per},
            "sweep_place_events": per["sweep_place_events"]}


def events_rates(t: dict) -> str:
    return (f"{t['launches']} launches, {t['device_ms']:.3f} ms device (CUDA events), "
            f"{t['us_per_launch']:.2f} us per launch, {t['us_per_pod_step']:.2f} us per pod step of "
            f"{t['pod_steps']} (each chunk's longest list)")


def sweep_rates(o: dict) -> str:
    return (f"{o['scenarios_per_s']:.1f} scenarios/s over the chunk calls ({o['sweep_s']:.4f} s: "
            f"{o['sweep_device_s']:.4f} s K18/K19 device, {o['sweep_host_s']:.4f} s the rest), "
            f"{o['wall_scenarios_per_s']:.1f} scenarios/s over the whole call ({o['total_s']:.4f} s, assembly "
            f"{o['assemble_s']:.4f} s; {o['wall_s']:.3f} s under the profiler)")


def compare_main_chunk(phase, label, pc, scen, err, rq_cols=None) -> dict:
    """K18 and K19 against their plain versions on the first chunk that the
    main path's sweep of `scen` over `pc` launched, at its shape (s_chunk
    scenarios, the sweep's e_pad and r_pad; the pod lists cut to `rq_cols`
    rows where given): every replica plane, nodes, reasons, the base carry
    untouched. Run after the main path's counts are read."""
    inp = tsweep.SweepInputs(pc, scen)
    s_chunk = tsweep._chunk_default(inp.state, len(scen))
    (_, ev_idx, rq_idx), rows, nodes, plain = compare_sweep_chunk(phase, label, inp, 0, min(s_chunk, len(scen)),
                                                                  err, rq_cols, sb=s_chunk)
    full = inp.chunk(0, min(s_chunk, len(scen)), s_chunk)
    out = {"scenarios": s_chunk, "e_pad": inp.e_pad, "r_pad": inp.r_pad, "cols": int(rq_idx.shape[1]),
           "entries": int((ev_idx >= 0).sum()), "rows": rows, "placed": int((nodes >= 0).sum()),
           "plain_s": plain, "timed": time_place(inp, *full[:3]), "drain": time_drain(inp, full[1])}
    log(f"{phase}: K18/K19 equal to their plain versions on the {label} ({s_chunk} scenarios x "
        f"N={pc.n_nodes}, e_pad {inp.e_pad} with {out['entries']} entries, r_pad {inp.r_pad}"
        + (f" cut to {out['cols']}" if rq_cols is not None else "")
        + f", {rows} requeue rows, {out['placed']} re-placed): every replica plane, nodes, reasons, the base "
        f"carry untouched; plain K18 {plain['sweep_drain']:.1f} s, K19 {plain['sweep_place']:.1f} s; the "
        f"chunk with its full lists: {place_rates(out['timed'])}; {drain_rates(out['drain'])}")
    return out


def run_serial_faults(card: str, err) -> dict:
    """Phase 8: `simtpu_torch.cli resilience --faults zone --json` on the
    serial smoke problem written as a simon Config, and a k=1 sweep over
    the same PlacedCluster, against their golden records."""
    golden = smoke.load_record(smoke.FAULT_GOLDEN)
    cluster, apps = smoke.smoke_problem(synth_cluster, synth_apps)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke.write_capacity_config(tmp, cluster, apps, smoke.template_node(synth))
        cuda.reset_counts()
        seed_name_hashes(smoke.NAME_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with smoke.capture_sweeps(tfaults) as got, contextlib.redirect_stderr(io.StringIO()):
                rc, doc = smoke.run_cli_json(tcli.main, ["resilience", "-f", cfg, "--faults",
                                                         smoke.FAULT_ZONE_SPEC, "--json"])
        finally:
            seed_name_hashes(None)
        wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    pc, zone = got[0]
    diffs = []
    if rc != golden["rc"] or smoke.doc_record(doc) != golden["cli"]:
        diffs.append(f"CLI exit {rc} (golden {golden['rc']}), document {smoke.doc_record(doc)} != "
                     f"golden {golden['cli']}")
    if smoke.placed_digest(pc.nodes) != golden["base"]:
        diffs.append("the base placement differs")
    diffs += smoke.sweep_differences(smoke.sweep_record(zone), golden["zone"])
    if diffs:
        raise AssertionError("phase 8: the zone sweep differs from the golden record:\n" + "\n".join(diffs))
    check_sweep_launches("phase 8 zone", launches, plain, int(zone.timings["chunks"]))
    out["zone"] = {"wall_s": wall, "rc": rc, "scenarios": len(zone.scenarios), "chunks": zone.timings["chunks"],
                   "sweep_s": zone.timings["sweep_s"], "scenarios_per_s": zone.timings["scenarios_per_s"],
                   "launches": launches, "audit_fallback": bool(doc.get("audit", {}).get("fallback"))}
    log(f"phase 8: cli resilience --faults zone on the serial smoke problem ({len(cluster.nodes)} nodes x "
        f"{len(pc.nodes)} pods): exit {rc}, audit fallback {out['zone']['audit_fallback']}, 16 scenarios in "
        f"{int(zone.timings['chunks'])} chunk(s), unplaced max {int(zone.unplaced.max())}, "
        f"{zone.timings['scenarios_per_s']:.1f} scenarios/s, {wall:.2f} s end to end; == golden; "
        f"launches {launches} [{card}]")

    scen = tfaults.generate_scenarios(cluster.nodes, smoke.FAULT_K1_SPEC)
    k1, launches, plain, wall, dev_s, per = profiled_sweep(pc, scen)
    diffs = smoke.sweep_differences(smoke.sweep_record(k1), golden["k1"])
    if diffs:
        raise AssertionError("phase 8: the k=1 sweep differs from the golden record:\n" + "\n".join(diffs))
    check_sweep_launches("phase 8 k=1", launches, plain, int(k1.timings["chunks"]))
    out["k1"] = sweep_summary(k1, wall, dev_s, launches, per)
    log(f"phase 8: sweep_scenarios k=1 on the same PlacedCluster: {len(k1.scenarios)} scenarios in "
        f"{int(k1.timings['chunks'])} chunks, {sweep_rates(out['k1'])}, K18/K19 device {dev_s:.4f} s = "
        f"{dev_s / wall:.1%} of the wall, {out['k1']['us_per_launch']} us per launch; K19 "
        f"{events_rates(out['k1']['sweep_place_events'])}; == golden")
    out["k1"]["compare"] = compare_main_chunk("phase 8", "serial smoke problem's first k=1 chunk", pc, scen, err)
    return out


def run_bulk_faults(card: str, err) -> dict:
    """Phase 9: `place_cluster` + `sweep_scenarios("k=2:256", seed=0)` on the
    bulk problem against its golden record; the engine's carry unchanged."""
    golden = smoke.load_record(smoke.BULK_FAULT_GOLDEN)
    cluster, apps = smoke.bulk_problem(synth)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc = tfaults.place_cluster(cluster, apps, device="cuda")
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
    finally:
        seed_name_hashes(None)
    if smoke.placed_digest(pc.nodes) != golden["base"] or int((pc.nodes < 0).sum()) != golden["base_unplaced"]:
        raise AssertionError(f"phase 9: the base placement differs from the golden record "
                             f"({int((pc.nodes < 0).sum())} unplaced, golden {golden['base_unplaced']})")
    carry = clone_state(pc.engine.last_state)
    scen = tfaults.generate_scenarios(cluster.nodes, smoke.BULK_FAULT_SPEC, seed=0)
    sweep, launches, plain, wall, dev_s, per = profiled_sweep(pc, scen)
    diffs = smoke.sweep_differences(smoke.sweep_record(sweep), golden["sweep"])
    if diffs:
        raise AssertionError("phase 9: the sweep differs from the golden record:\n" + "\n".join(diffs))
    check_sweep_launches("phase 9", launches, plain, int(sweep.timings["chunks"]))
    if state_diff(carry, pc.engine.last_state):
        raise AssertionError("phase 9: the sweep changed the engine's carry")
    out = dict(sweep_summary(sweep, wall, dev_s, launches, per), place_s=place_s,
               r_pad=int(sweep.requeue_rows.shape[1]))
    log(f"phase 9: place_cluster on the bulk problem ({len(cluster.nodes)} nodes x {len(pc.nodes)} pods, "
        f"{place_s:.2f} s) + sweep k=2:256: {int(sweep.timings['chunks'])} chunks, {sweep_rates(out)}, "
        f"K18/K19 device {dev_s:.4f} s = {dev_s / wall:.1%}, {out['us_per_launch']} us per launch; K19 "
        f"{events_rates(out['sweep_place_events'])}; == golden, the carry unchanged [{card}]")
    out["compare"] = compare_main_chunk("phase 9", "bulk problem's first k=2:256 chunk", pc, scen, err,
                                        rq_cols=BULK_COMPARE_ROWS)
    return out, pc


def run_batched_capacity(card: str) -> dict:
    """Phase 10: `plan_capacity_batched` on the capacity problem (all 100
    candidates): the count against the capacity golden record (the serial
    planner's), the failures at smoke.CAP_SWEEP_CANDIDATES and the
    winner's record against the JAX package's batched sweep and the
    simulation its planner runs next."""
    want = smoke.load_record(smoke.CAP_GOLDEN)
    sweep_golden = smoke.load_record(smoke.CAP_FAULT_GOLDEN)
    cluster, apps, template = smoke.capacity_problem(synth, simtpu_torch.AppResource,
                                                     simtpu_torch.ResourceTypes)
    walls = []
    scan_fn = tpsweep.sweep_scan

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = scan_fn(*a, **kw)
        walls.append(time.perf_counter() - t)
        return res

    cuda.reset_counts()
    tpsweep.sweep_scan = timed
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with PlaceTimer() as timer:
            plan = tpsweep.plan_capacity_batched(cluster, apps, template, device="cuda")
            torch.cuda.synchronize()
    finally:
        seed_name_hashes(None)
        tpsweep.sweep_scan = scan_fn
    wall = time.perf_counter() - t0
    k19 = timer.summary()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    failures = [plan.probes[c] for c in smoke.CAP_SWEEP_CANDIDATES]
    diffs = []
    if (plan.success, plan.nodes_added, plan.message) != (True, want["nodes_added"], want["message"]):
        diffs.append(f"plan {plan.success} {plan.nodes_added} {plan.message!r}, golden {want['nodes_added']}")
    if failures != sweep_golden["failures"]:
        diffs.append(f"failures at {smoke.CAP_SWEEP_CANDIDATES}: {failures}, golden {sweep_golden['failures']}")
    # the winner's simulation draws its pod names after the sweep's one
    # expansion, as in the JAX package's batched planner (whose next step
    # after the sweep the golden record ran)
    diffs += smoke.record_differences(smoke.placement_record(plan.result), sweep_golden["winner"])
    if diffs:
        raise AssertionError("phase 10: the batched plan differs from the golden records:\n" + "\n".join(diffs))
    check_sweep_launches("phase 10", launches, plain, 1)
    n_pods = len(want["record"]["placed"]) + len(want["record"]["failed"])
    out = {"wall_s": wall, "sweep_s": walls[0], "candidates": len(plan.probes), "nodes_added": plan.nodes_added,
           "pod_steps": n_pods, "us_per_pod_step": walls[0] / n_pods * 1e6, "launches": launches,
           "sweep_place_events": k19}
    log(f"phase 10: plan_capacity_batched on the capacity problem: {len(plan.probes)} candidates in one "
        f"K18 + K19 launch pair, sweep {walls[0]:.3f} s wall ({out['us_per_pod_step']:.2f} us per pod step "
        f"of {n_pods}), K19 {events_rates(k19)}; plan {wall:.2f} s, +{plan.nodes_added} nodes, failures "
        f"{failures} == golden, winner record == golden; launches {launches} [{card}]")
    return out


def run_resilience_plan(card: str) -> dict:
    """Phase 11: `simtpu_torch.cli resilience --plan --faults k=2:64 --seed 0
    --json` on the capacity problem's config against its golden record."""
    golden = smoke.load_record(smoke.CAP_FAULT_GOLDEN)
    cluster, apps, template = smoke.capacity_problem(synth, simtpu_torch.AppResource,
                                                     simtpu_torch.ResourceTypes)
    sweep_walls = []
    sweep_fn = tresil.sweep_scenarios

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = sweep_fn(*a, **kw)
        sweep_walls.append(time.perf_counter() - t)
        return res

    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke.write_capacity_config(tmp, cluster, apps, template)
        cuda.reset_counts()
        tresil.sweep_scenarios = timed
        seed_name_hashes(smoke.NAME_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stderr(io.StringIO()), PlaceTimer() as timer:
                rc, doc = smoke.run_cli_json(tcli.main, ["resilience", "-f", cfg, "--plan", "--faults",
                                                         smoke.CAP_RESIL_SPEC, "--seed", "0", "--json"])
        finally:
            seed_name_hashes(None)
            tresil.sweep_scenarios = sweep_fn
        wall = time.perf_counter() - t0
    k19 = timer.summary()
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if rc != golden["plan_rc"] or smoke.doc_record(doc) != golden["plan"]:
        raise AssertionError(f"phase 11: exit {rc} (golden {golden['plan_rc']}), plan "
                             f"{smoke.doc_record(doc)} != golden {golden['plan']}")
    if launches.get("sweep_drain", 0) != len(sweep_walls) or launches.get("sweep_place", 0) != len(sweep_walls) \
            or any(plain.values()):
        raise AssertionError(f"phase 11: {len(sweep_walls)} sweeps, launches {launches}, plain {plain}")
    out = {"wall_s": wall, "rc": rc, "nodes_added": doc["nodes_added"], "candidates": doc["candidates_probed"],
           "sweeps": len(sweep_walls), "sweep_wall_s": sweep_walls, "launches": launches,
           "sweep_place_events": k19}
    log(f"phase 11: cli resilience --plan --faults k=2:64 on the capacity problem: exit {rc}, "
        f"+{doc['nodes_added']} nodes after {doc['candidates_probed']} candidates, audit fallback "
        f"{bool(doc['audit'].get('fallback'))}; {wall:.2f} s, {len(sweep_walls)} sweeps of "
        f"{np.mean(sweep_walls) * 1e3:.1f} ms mean; K19 {events_rates(k19)}; == golden; launches {launches} "
        f"[{card}]")
    return out


# -- phases 12-13: decision observability and the fuzz harness ----------------


class ExplainCapture:
    """Context manager: while open, every K20 call (`breakdown.explain_pass`)
    is timed on the host with the card synchronized (the device pass of the
    explain wall), the first one's inputs are kept, every breakdown
    `explain_failures` returns is kept, every `scores.eval_pod_terms` call
    (the K1 -> (K5) -> (K6) -> K2 -> K21 chain) is timed and its inputs
    kept, and every `Simulator.explain_result` is timed (the explain wall
    of a simulation)."""

    def __enter__(self):
        self.orig = (tbd.explain_pass, tbd.explain_failures, tscores.eval_pod_terms,
                     tapi.Simulator.explain_result)
        self.first_pass, self.breakdowns, self.terms = None, [], []
        self.pass_s, self.passes, self.terms_s, self.result_s = 0.0, 0, 0.0, 0.0

        def explain_pass(statics, state, pods, flags, k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = self.orig[0](statics, state, pods, flags, k)
            self.pass_s += time.perf_counter() - t
            self.passes += 1
            if self.first_pass is None:
                self.first_pass = (statics, state, pods, flags, k)
            return res

        def explain_failures(*a, **kw):
            self.breakdowns.append(self.orig[1](*a, **kw))
            return self.breakdowns[-1]

        def eval_pod_terms(statics, state, pod, flags):
            self.terms.append((statics, state, pod, flags))
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = self.orig[2](statics, state, pod, flags)
            torch.cuda.synchronize()
            self.terms_s += time.perf_counter() - t
            return res

        def explain_result(sim, opts=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            doc = self.orig[3](sim, opts)
            self.result_s += time.perf_counter() - t
            return doc

        tbd.explain_pass, tbd.explain_failures, tscores.eval_pod_terms = (
            explain_pass, explain_failures, eval_pod_terms)
        tapi.Simulator.explain_result = explain_result
        return self

    def __exit__(self, *exc):
        tbd.explain_pass, tbd.explain_failures, tscores.eval_pod_terms, tapi.Simulator.explain_result = self.orig
        return False


def runnable_chunks(breakdowns) -> int:
    """K20 launches a breakdown's pods need: one per EXPLAIN_CHUNK of the
    pods that run the cascade (forced pods, FAIL_NO_NODE, never do)."""
    return sum(-(-int((bd.fail_code != scan.FAIL_NO_NODE).sum()) // tbd.EXPLAIN_CHUNK) for bd in breakdowns)


def check_explain_launches(label: str, launches: dict, plain: dict, cap: ExplainCapture, terms: int = 0) -> None:
    """K20 once per chunk of runnable unplaced pods, K21 once per attributed
    pod, no plain version."""
    want = runnable_chunks(cap.breakdowns)
    got = (launches.get("explain_pass", 0), launches.get("pod_terms", 0))
    if got != (want, terms) or cap.passes != want or not want or any(plain.values()):
        raise AssertionError(f"{label}: K20/K21 launched {got}, want ({want}, {terms}) for "
                             f"{[len(b) for b in cap.breakdowns]} pods; plain calls {plain}")


def explain_bytes(eb) -> int:
    """Bytes K20 must move for one chunk: the state planes and statics rows
    its stages read (each once: every block reads the one state), the
    chunk's pod arrays, and the outputs written once."""
    buf = eb.buf
    st, s, f = buf.statics, buf.state, buf.flags
    n, r = st.alloc.shape
    p, w, c = st.ports_req.shape[1], st.vol_rw_req.shape[1], st.vol_class_mask.shape[0]
    v, sd, gd = st.vg_cap.shape[1], st.sdev_cap.shape[1], s.gpu_free.shape[1]
    f4 = 4
    groups = np.unique(buf.group.cpu().numpy())
    terms = st.g_terms[torch.as_tensor(groups, device=st.g_terms.device).long()].flatten()
    terms = torch.unique(terms[terms >= 0])
    keys = int(torch.unique(st.term_topo[terms.long()]).numel()) if terms.numel() else 0
    own = int((st.ip_of[terms.long()] >= 0).sum()) if terms.numel() else 0
    node = n * r * f4 + n + (n * p * f4 if f.ports else 0) + (2 * n * w * f4 + n * c * f4 if (f.vols or f.attach) else 0)
    rows = len(groups) * 2 * n + int(terms.numel()) * n * f4 + keys * n * f4 + (own * n * f4 if f.interpod_req else 0)
    ext = (n * (v * 8 + sd * 9 + 1) if buf.storage_live.any() else 0) + (
        n * (gd * 5 + 4) if buf.gpu_live.any() else 0)
    k = eb.k
    pods = buf.n_pods * (4 * r + 16 + 8 * (buf.lvm_size.shape[1] + buf.dev_size.shape[1]) + 4 * gd)
    outs = buf.n_pods * (10 + 1 + 1 + 10 * k) * f4
    return int(node + rows + ext + pods + outs)


def compare_explain_chunk(label: str, inputs, err, phase: str = "phase 12") -> dict:
    """K20 against its plain version on `inputs` (a path's first chunk: its
    statics, state, pod rows, flags and k), on the card: every output
    equal. Returns the chunk's shape, the plain version's seconds and the
    ExplainBuffers the timing relaunches."""
    statics, state, pods, flags, k = inputs
    got = tbd.explain_pass(statics, state, pods, flags, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tbd.explain_pass_plain(statics, state, pods, flags, k)
    plain_s = time.perf_counter() - t0
    for name, a, b in zip(("counts", "feasible", "witnesses", "fail_code"), got, want):
        if not np.array_equal(a, b):
            raise AssertionError(f"{phase}: K20 differs from its plain version on the {label} ({name})")
    eb = tbd.ExplainBuffers(statics, state, pods, flags, k)
    log(f"{phase}: K20 equal to its plain version on the {label} ({len(pods[0])} pods x "
        f"N={statics.alloc.shape[0]}: counts, feasible, witnesses, fail codes; "
        f"{int(np.asarray(got[0]).sum())} eliminations); plain {plain_s:.2f} s")
    return {"pods": len(pods[0]), "n": int(statics.alloc.shape[0]), "plain_s": plain_s, "eb": eb, "want": want}


def compare_pod_terms(inputs, err) -> dict:
    """K21 against its plain version and K3 on each attributed pod's prefix
    state: the score bit for bit (both), the 12 term rows to the tolerance
    (NaN where the plain version has NaN). Returns the largest term
    difference, whether every row came out exact, and the last pod's
    buffer for the timing."""
    worst, exact, buf = 0.0, True, None
    for statics, state, pod, flags in inputs:
        buf = tscores.TermsBuffers(statics, state, tuple(np.asarray(a)[None] for a in pod), flags)
        scan.filter_pod(buf, 0)
        if buf.storage_live[0]:
            scan.storage_pod(buf, 0)
        if buf.gpu_live[0]:
            scan.gpu_pod(buf, 0)
        scan.topology_pod(buf, 0)
        tscores.pod_terms(buf, 0)
        s1, t1 = buf.score.clone(), buf.terms.clone()
        tscores.pod_terms_plain(buf, 0)
        s2, t2 = buf.score.clone(), buf.terms.clone()
        scan.score_argmax_pod(buf, 0)
        if not (torch.equal(s1, s2) and torch.equal(s1, buf.score)):
            raise AssertionError("phase 12: K21's score differs from its plain version's or K3's")
        nan1, nan2 = torch.isnan(t1), torch.isnan(t2)
        fin = ~nan2
        if not torch.equal(nan1, nan2) or not torch.allclose(t1[fin], t2[fin], rtol=smoke.TERMS_RTOL,
                                                               atol=smoke.TERMS_ATOL):
            raise AssertionError("phase 12: K21's term rows differ from its plain version's")
        d = float((t1[fin] - t2[fin]).abs().max()) if fin.any() else 0.0
        worst = max(worst, d)
        exact = exact and torch.equal(t1[fin], t2[fin])
        # rebuild the chain's scratch for the timing (K3 wrote the score)
        scan.topology_pod(buf, 0)
    err["pod_terms"] = max(err["pod_terms"], worst)
    return {"max_term_diff": worst, "terms_exact": exact, "buf": buf}


def explain_split(cap: ExplainCapture, wall: float) -> dict:
    return {"explain_wall_s": wall, "device_pass_s": cap.pass_s, "host_assembly_s": wall - cap.pass_s,
            "k20_launches": cap.passes}


def run_explain(card: str, bulk_pc, err) -> dict:
    """Phase 12: the decision-observability paths on the card against the
    golden record (`smoke.EXPLAIN_GOLDEN`), each with every count set to 0
    just before and read just after: (a) `simulate(explain=True)` on the
    extended problem, (b) `build_explain_doc` over every unplaced pod of
    phase 9's bulk placement, (c) `cli explain --scores 8 --json --no-bulk`
    on the serial smoke config, (d) the capacity plan capped at 20 nodes;
    then K20 and K21 against their plain versions on those paths' inputs,
    and their times."""
    golden = smoke.load_record(smoke.EXPLAIN_GOLDEN)
    out = {}

    # (a) the extended problem through simulate(explain=True)
    cluster, apps = smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with ExplainCapture() as cap:
            result = simtpu_torch.simulate(cluster, apps, device="cuda", explain=True)
            torch.cuda.synchronize()
    finally:
        seed_name_hashes(None)
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    want = golden["extended"]
    diffs = smoke.explain_differences(result.explain, want["doc"])
    if len(result.unscheduled_pods) != want["unscheduled"] or diffs:
        raise AssertionError("phase 12 (a): the extended problem's explain block differs from the golden "
                             "record:\n" + "\n".join(diffs))
    check_explain_launches("phase 12 (a)", launches, plain, cap)
    out["extended"] = {"wall_s": wall, "unscheduled": want["unscheduled"], "launches": launches,
                       "k12_launches": launches.get("compact_expand", 0), **explain_split(cap, cap.result_s)}
    log(f"phase 12 (a): simulate(explain=True, device='cuda') on the extended problem: "
        f"{want['unscheduled']} unscheduled pods explained, doc == golden; K20 {launches['explain_pass']} "
        f"launches (one per chunk of {tbd.EXPLAIN_CHUNK}), K12 {launches.get('compact_expand', 0)} "
        f"(the carry's expansions, carried_state() included); explain wall {cap.result_s:.4f} s = device pass "
        f"{cap.pass_s:.4f} s + host assembly {cap.result_s - cap.pass_s:.4f} s; simulate {wall:.2f} s [{card}]")
    a_first = cap.first_pass

    # (b) the bulk problem's unplaced pods, on phase 9's placement
    rows = np.flatnonzero(bulk_pc.nodes < 0)
    cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ExplainCapture() as cap:
        doc = tbd.build_explain_doc(bulk_pc.tensors, bulk_pc.batch, rows, bulk_pc.engine.carried_state(),
                                    bulk_pc.nodes, bulk_pc.reasons)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    want = golden["bulk"]
    diffs = smoke.explain_differences(doc, want["doc"])
    rec = smoke.breakdown_record(cap.breakdowns[0], bulk_pc.nodes)
    diffs += [f"{k}: {rec[k]} != golden {want[k]}" for k in rec if rec[k] != want[k]]
    if diffs:
        raise AssertionError("phase 12 (b): the bulk problem's breakdown differs from the golden record:\n"
                             + "\n".join(diffs))
    check_explain_launches("phase 12 (b)", launches, plain, cap)
    out["bulk"] = {"unplaced": int(len(rows)), "launches": launches,
                   "k12_launches": launches.get("compact_expand", 0), **explain_split(cap, wall)}
    log(f"phase 12 (b): build_explain_doc over the bulk problem's {len(rows)} unplaced pods "
        f"(N={bulk_pc.n_nodes}): doc and the per-pod counts, feasible, witnesses and fail codes == golden; "
        f"K20 {launches['explain_pass']} launches, K12 {launches.get('compact_expand', 0)}; explain wall "
        f"{wall:.4f} s = device pass {cap.pass_s:.4f} s + host assembly {wall - cap.pass_s:.4f} s [{card}]")
    b_first = cap.first_pass

    # (c) score attribution through the CLI on the serial smoke config
    cl, ap = smoke.smoke_problem(synth_cluster, synth_apps)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = smoke.write_capacity_config(tmp, cl, ap, smoke.template_node(synth))
        cuda.reset_counts()
        seed_name_hashes(smoke.NAME_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with ExplainCapture() as cap, contextlib.redirect_stderr(io.StringIO()):
                rc, doc = smoke.run_cli_json(tcli.main, ["explain", "-f", cfg, "--scores",
                                                         str(smoke.EXPLAIN_SCORES), "--json", "--no-bulk"])
        finally:
            seed_name_hashes(None)
        wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    want = golden["scores"]
    diffs = smoke.explain_differences(doc, want["doc"])
    if rc != want["rc"] or diffs or not all(x["consistent"] for x in doc["scores"]):
        raise AssertionError(f"phase 12 (c): explain --scores exit {rc}, differs from the golden record:\n"
                             + "\n".join(diffs))
    if cap.breakdowns:
        check_explain_launches("phase 12 (c)", launches, plain, cap, terms=smoke.EXPLAIN_SCORES)
    elif launches.get("pod_terms", 0) != smoke.EXPLAIN_SCORES or any(plain.values()):
        raise AssertionError(f"phase 12 (c): K21 launched {launches.get('pod_terms', 0)} times, plain {plain}")
    out["scores"] = {"wall_s": wall, "rc": rc, "placed": doc["placed"], "unplaced": doc["unplaced"],
                     "launches": launches, "attribution_s": cap.terms_s,
                     "device_pass_s": cap.pass_s, "k20_launches": cap.passes}
    log(f"phase 12 (c): cli explain --scores {smoke.EXPLAIN_SCORES} --json --no-bulk on the serial smoke "
        f"problem: exit {rc}, {doc['placed']}/{doc['pods']} placed, every attribution consistent, doc == "
        f"golden (margins and terms to the stated tolerances); K21 {launches.get('pod_terms', 0)} launches, "
        f"K20 {launches.get('explain_pass', 0)}; the {len(cap.terms)} evaluations (K1-K2, K21, the prefix "
        f"states) {cap.terms_s:.4f} s; {wall:.2f} s end to end [{card}]")
    c_terms = cap.terms

    # (d) the failing capped plan
    cluster, apps, template = smoke.capacity_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with ExplainCapture() as cap:
            plan = plan_capacity(cluster, apps, template, max_new_nodes=smoke.EXPLAIN_MAX_NEW, explain=True,
                                 device="cuda")
            torch.cuda.synchronize()
    finally:
        seed_name_hashes(None)
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    want = golden["plan"]
    got = {"success": plan.success, "nodes_added": plan.nodes_added, "message": plan.message,
           "probes": {str(k): v for k, v in sorted(plan.probes.items())}}
    diffs = [f"{k}: {got[k]!r} != golden {want[k]!r}" for k in got if got[k] != want[k]]
    diffs += smoke.explain_differences(plan.explain, want["explain"])
    if diffs:
        raise AssertionError("phase 12 (d): the capped plan differs from the golden record:\n" + "\n".join(diffs))
    check_explain_launches("phase 12 (d)", launches, plain, cap)
    out["plan"] = {"wall_s": wall, "candidates": len(plan.candidates), "launches": launches,
                   **explain_split(cap, cap.result_s)}
    log(f"phase 12 (d): plan_capacity(max_new_nodes={smoke.EXPLAIN_MAX_NEW}, explain=True) on the capacity "
        f"problem: fails as the golden record ({plan.message!r}), {len(plan.candidates)} candidates, the "
        f"block == golden; K20 {launches['explain_pass']} launches over {len(cap.breakdowns)} explained "
        f"candidates; explain wall {cap.result_s:.3f} s = device pass {cap.pass_s:.3f} s + host assembly "
        f"{cap.result_s - cap.pass_s:.3f} s; plan {wall:.2f} s [{card}]")

    # K20 and K21 against their plain versions, on the paths' own inputs
    a_cmp = compare_explain_chunk("extended problem's first chunk", a_first, err)
    b_cmp = compare_explain_chunk("bulk problem's first chunk", b_first, err)
    t_cmp = compare_pod_terms(c_terms, err)
    log(f"phase 12: K21 equal to its plain version on each of (c)'s {len(c_terms)} pods: score bit for bit "
        f"(and equal to K3's), terms {'exact' if t_cmp['terms_exact'] else 'within the tolerance'} (largest "
        f"difference {t_cmp['max_term_diff']})")

    # times: K20 at (b)'s and (a)'s first chunk, K21 at (c)'s last pod
    def device_time(name, launch, iters: int) -> dict:
        """The kernel's device µs per launch from the profiler, or from CUDA
        events around back-to-back launches when the profiler's window
        shows no device time for it; and the back-to-back launch time."""
        per, _, _ = profile_kernels(lambda: [launch() for _ in range(iters)])
        host_ms = time_call(launch, 5 * iters)
        got = per.get(name)
        return {"device_us": got[0] if got else host_ms * 1e3, "ms_from": "profiler" if got else "cuda events",
                "host_us": host_ms * 1e3}

    def k20_times(cmp):
        eb = cmp["eb"]
        nbytes = explain_bytes(eb)
        return {**device_time("explain_pass", lambda: cuda.launch_explain_pass(eb), 20),
                "plain_ms": cmp["plain_s"] * 1e3, "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
                "pods": cmp["pods"], "n": cmp["n"]}

    times = {"explain_pass": k20_times(b_cmp), "explain_pass_extended": k20_times(a_cmp)}
    buf = t_cmp["buf"]
    plain_ms = time_call(lambda: tscores.pod_terms_plain(buf, 0), 5)
    nbytes = kernel_bytes(buf, 0)["score_argmax_pod"] + len(tscores.PLUGIN_TERMS) * buf.statics.alloc.shape[0] * 4
    times["pod_terms"] = {**device_time("pod_terms", lambda: tscores.pod_terms(buf, 0), 40), "plain_ms": plain_ms,
                          "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "pods": 1,
                          "n": int(buf.statics.alloc.shape[0]), "terms_exact": t_cmp["terms_exact"]}
    for name, t in times.items():
        log(f"  {name}: {t['device_us']:.2f} us device per launch ({t['ms_from']}), {t['host_us']:.2f} us per "
            f"back-to-back launch from Python, plain {t['plain_ms'] * 1e3:.1f} us, {t['bytes']} B, bound "
            f"{t['bound_us']:.4f} us ({t['pods']} pod(s) x N={t['n']}) [{card}]")
    out["times"] = times
    out["launches"] = {k: sum(out[p]["launches"].get(k, 0) for p in ("extended", "bulk", "scores", "plan"))
                       for k in ("explain_pass", "pod_terms")}
    return out


def run_fuzz(card: str) -> dict:
    """Phase 13: `cli fuzz --cases 4 --json` on the card (every case
    bit-identical across the wavefront / compact / both cells and
    audit-clean, K8 on every audit), then `cli fuzz --mutation-kill --json`
    against the golden counters."""
    cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc, doc = smoke.run_cli_json(tcli.main, ["fuzz", "--cases", "4", "--json"])
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    runs = 4 * (1 + len(fuzz.engine_configs()))
    if (rc, doc["ok"], doc["failures"], doc["configs_run"], doc["audits_clean"]) != (0, True, [], runs, runs):
        raise AssertionError(f"phase 13: fuzz exit {rc}, {doc}")
    if launches.get("audit_bulk", 0) != runs or any(plain.values()) or not (
            launches.get("wave_lean", 0) + launches.get("wave_hard", 0)) or not launches.get("compact_compress"):
        raise AssertionError(f"phase 13: fuzz launches {launches}, plain {plain}")
    out = {"wall_s": wall, "configs_run": runs, "launches": launches}
    log(f"phase 13: cli fuzz --cases 4 --json: exit {rc}, {runs} engine-config runs, every case bit-identical "
        f"and audit-clean; K8 {launches['audit_bulk']} launches; {wall:.2f} s [{card}]")
    want = smoke.load_record(smoke.EXPLAIN_GOLDEN)["mutation_kill"]
    cuda.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        rc, mk = smoke.run_cli_json(tcli.main, ["fuzz", "--mutation-kill", "--json"])
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    ok = mk.pop("ok")
    if rc != 0 or not ok or mk != want or not launches.get("audit_bulk") or any(plain.values()):
        raise AssertionError(f"phase 13: mutation-kill exit {rc}, {mk} != golden {want}, launches {launches}")
    out["mutation_kill"] = {"wall_s": wall, "tried": mk["tried"], "killed": mk["killed"], "launches": launches}
    log(f"phase 13: cli fuzz --mutation-kill --json: exit {rc}, {mk['killed']}/{mk['tried']} corruptions "
        f"killed over {mk['classes']} classes == golden; K8 {launches['audit_bulk']} launches; {wall:.2f} s "
        f"[{card}]")
    return out


# -- the solve backend and grow mode: K22-K25 -----------------------------------


def relax_problem_of(problem_fn):
    """(RelaxProblem, [100, N] candidate masks) of a capacity problem,
    tensorized as the solver consult of `apply` tensorizes it."""
    cluster, apps, template = problem_fn(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    max_new = simtpu_torch.constants.MAX_NUM_NEW_NODE - 1
    tz, all_nodes, n_base, ordered = tpsweep.assemble_planning_problem(cluster, apps, template, max_new, ())
    batch = tz.add_pods(ordered)
    prob = trelax.build_relax_problem(tz.freeze(), batch)
    return prob, tplanner._candidate_masks(len(all_nodes), n_base, max_new)


def relax_bound(rb) -> dict:
    """K22's and K23's work for one launch on `rb`: the bytes each must
    move (each input read once, each output written once) and the f32
    operations each does (K22 the load's multiply-adds; K23 the gradient's
    and the step's, and the bitonic sort's compare-exchanges of its
    power-of-two rows), and the bound: the larger of bytes over the memory
    rate and operations over the f32 rate."""
    s, c, n = rb.y.shape
    r = rb.req.shape[1]
    np2 = max(32, 1 << max(n - 1, 0).bit_length())
    lg = np2.bit_length() - 1
    y_b, over_b, valid_b = 4 * s * c * n, 4 * s * n * r, s * n
    work = {
        "relax_load": (y_b + over_b + 4 * (2 * n * r + c * r) + valid_b + 4 * s,
                       2 * s * c * n * r),
        "relax_project": (2 * y_b + over_b + 4 * (c * r + c) + c * n + valid_b,
                          2 * s * c * n * r + 2 * s * c * n + s * c * (np2 // 2) * lg * (lg + 1) // 2),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        out[name] = {"bytes": int(nbytes), "ops": int(ops), "bound_ms": max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations"}
    return out


def phase_relax_kernels(device, err) -> dict:
    """Phase 2: K22/K23 against their plain versions on the card, on the
    relaxations of the capacity and the large capacity problems (every
    candidate, smoke.SOLVE_ITERS iterations): the start point and the first
    5 iterations step by step (y equal, over), then y and the residual to
    the stated tolerances and the feasible sets equal; then their times
    at both shapes, K23's launch plan and its rows resident per SM."""
    out, pair = {}, {}
    for label, fn in (("capacity", smoke.capacity_problem), ("large_capacity", smoke.large_capacity_problem)):
        prob, valid = relax_problem_of(fn)
        args = (prob.feas, prob.req, prob.cnt, prob.fixed, prob.cap, valid, np.float32(prob.lr), device)
        a, b = trelax.relax_buffers(*args), trelax.relax_buffers(*args)
        trelax.relax_project_plain(a, init=True)
        cuda.launch_relax_project(b, init=True)
        steps = [float((a.y - b.y).abs().max())]
        over_err = 0.0
        for it in range(smoke.SOLVE_ITERS):
            trelax.relax_load_plain(a)
            cuda.launch_relax_load(b)
            if it < 5:
                over_err = max(over_err, float((a.over - b.over).abs().max()))
            trelax.relax_project_plain(a)
            cuda.launch_relax_project(b)
            if it < 5:
                steps.append(float((a.y - b.y).abs().max()))
        trelax.relax_load_plain(a, residual=True)
        cuda.launch_relax_load(b, residual=True)
        torch.cuda.synchronize()
        y_err = float((a.y - b.y).abs().max())
        ra, rb_ = a.residual.cpu().numpy(), b.residual.cpu().numpy()
        fin = np.isfinite(ra)
        res_err = float(np.abs(ra[fin] - rb_[fin]).max()) if fin.any() else 0.0
        feas_a, feas_b = ra <= trelax.RESIDUAL_TOL, rb_ <= trelax.RESIDUAL_TOL
        # the start point and the first 5 launches from identical inputs:
        # equal (a launch that differed would show here), then the runs to
        # the stated tolerances
        if (max(steps) > 0.0 or y_err > smoke.SOLVE_Y_ATOL or res_err > smoke.SOLVE_RES_ATOL
                or not np.array_equal(fin, np.isfinite(rb_)) or not np.array_equal(feas_a, feas_b)
                or not torch.equal(a.stuck, b.stuck)):
            raise AssertionError(f"phase 2: K22/K23 on the {label} relaxation differ from their plain versions: "
                                 f"steps {steps}, over {over_err}, y {y_err}, residual {res_err}, feasible "
                                 f"{int(feas_a.sum())} vs {int(feas_b.sum())}")
        err["relax_load"] = max(err["relax_load"], over_err, res_err)
        err["relax_project"] = max(err["relax_project"], y_err, max(steps))
        s_, c_, n_ = b.y.shape
        out[label] = {"shape": [s_, c_, n_, b.req.shape[1]], "steps_max_abs": steps, "over_max_abs": over_err,
                      "y_max_abs": y_err, "residual_max_abs": res_err, "feasible": int(feas_b.sum())}
        log(f"phase 2: K22/K23 equal to their plain versions on the {label} relaxation (S, C, N, R) = "
            f"{tuple(out[label]['shape'])}, {smoke.SOLVE_ITERS} iterations: first 5 steps max |dy| "
            f"{max(steps):.3g}, over {over_err:.3g}; final y {y_err:.3g} (tolerance {smoke.SOLVE_Y_ATOL}), "
            f"residual {res_err:.3g} ({smoke.SOLVE_RES_ATOL}); {int(feas_b.sum())} candidates relax-feasible "
            "in both")
        out[label]["exact_after_400"] = y_err == 0.0
        pair[label] = (a, b)
    # times at both shapes: the profiler's device time per launch, K23's
    # rows resident per SM, the whole relaxation's wall
    for label, (a, b) in pair.items():
        bound = relax_bound(b)
        per, _, _ = profile_kernels(lambda: [(cuda.launch_relax_load(b), cuda.launch_relax_project(b))
                                             for _ in range(20)],
                                    {"relax_load": lambda: cuda.launch_relax_load(b),
                                     "relax_project": lambda: cuda.launch_relax_project(b)})
        plan = cuda.relax_project_plan(b.y.shape[2], b.y.shape[0] * b.y.shape[1])
        out[label].update({
            "device_us": {k: per[k][0] for k in RELAX_KERNELS}, "bound": bound,
            "relax_project_plan": plan, "rows_per_sm": cuda.relax_project_rows_per_sm(b),
            "run_ms": time_call(lambda: trelax.relax_run(b, smoke.SOLVE_ITERS), 2)})
        out[label]["events_us"] = in_turns({"K23": lambda _: cuda.launch_relax_project(b)}, lambda: None,
                                           per_turn=8)["K23"] * 1e3
        log(f"  {label} relaxation {tuple(out[label]['shape'])}: K22 {per['relax_load'][0]:.2f} us, K23 "
            f"{per['relax_project'][0]:.2f} us device per launch (profiler; {out[label]['events_us']:.2f} us "
            f"CUDA events; bound "
            f"{bound['relax_project']['bound_ms'] * 1e3:.2f} us, {bound['relax_project']['bound_by']}); K23's "
            f"{plan['path']} path, {plan['threads']} threads x {plan['keys_per_thread']} keys a row, "
            f"{out[label]['rows_per_sm']} rows resident per SM; relax_run ({smoke.SOLVE_ITERS} iterations, "
            f"{2 * smoke.SOLVE_ITERS + 2} launches) {out[label]['run_ms']:.2f} ms")
        if label == "capacity":
            times = {}
            for name, launch, plain in (("relax_load", cuda.launch_relax_load, trelax.relax_load_plain),
                                        ("relax_project", cuda.launch_relax_project, trelax.relax_project_plain)):
                times[name] = {"host_ms": time_call(lambda: launch(b), 200),
                               "plain_ms": time_call(lambda: plain(a), 3), "ms": per[name][0] / 1e3,
                               **bound[name]}
                t = times[name]
                log(f"  {name}: {per[name][0]:.2f} us device (profiler), {t['host_ms'] * 1e3:.2f} us per "
                    f"back-to-back launch from Python, plain {t['plain_ms'] * 1e3:.1f} us, {t['bytes']} B, "
                    f"{t['ops']} ops, bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}) at the capacity "
                    f"relaxation {tuple(out['capacity']['shape'])}")
    return {"problems": out, "times": times, "run_ms": out["capacity"]["run_ms"]}


#: K23's wide-row check: a relaxation of (S, C, N, R) = RELAX_WIDE nodes
#: past the shared-memory row (cuda.RELAX_SHARED_ROW), from a seed
RELAX_WIDE = (4, 3, 20000, 3)
#: K23's launch-plan boundaries (cuda.relax_project_plan): the register
#: path's widest keys-per-thread steps, its last row, the shared-memory
#: path's first and last
RELAX_EDGES = (1024, 1025, 4096, 4097, 16384)
#: the node counts of K23's edge-row set: each path and keys-per-thread step
RELAX_EDGE_ROWS = (999, 2099, 5000, 20000)


def relax_wide_problem(device, seed: int = 5, shape=RELAX_WIDE):
    """Two equal RelaxBuffers (plain side, kernel side) of a seeded
    relaxation of `shape` (S, C, N, R): classes feasible on ~80% of the
    nodes, candidates valid on ~90%, capacities in [0.5, 1), a pinned load
    up to 20% of them and per-pod requests that fill about 60% in all."""
    s, c, n, r = shape
    rng = np.random.default_rng(seed)
    feas = rng.random((c, n)) < 0.8
    valid = rng.random((s, n)) < 0.9
    cap = rng.uniform(0.5, 1.0, (n, r)).astype(np.float32)
    fixed = (cap * rng.uniform(0.0, 0.2, (n, r))).astype(np.float32)
    cnt = rng.integers(n // 4, n, c).astype(np.float32)
    req = (0.6 * cap.sum(axis=0) / cnt.sum() * rng.uniform(0.5, 1.5, (c, r))).astype(np.float32)
    args = (feas, req, cnt, fixed, cap, valid, np.float32(0.05), device)
    return trelax.relax_buffers(*args), trelax.relax_buffers(*args)


#: the wide phase's paths: (label, the kernels each must launch on the card)
WIDE_PATHS = (
    ("simulate, wavefront on", ("wave_lean", "wave_hard")),
    ("simulate, wavefront off", STEP + ("storage_pod", "gpu_pod")),
    ("simulate(bulk=True)", ROUND_KERNELS),
    ("place_cluster + k=1 sweep", SWEEP_KERNELS),
    ("simulate(explain=True)", ("explain_pass",)),
    ("cli explain --scores", ("pod_terms",)),
)


def run_wide(card: str) -> dict:
    """Phase 16: the wide problem (smoke.wide_problem: one node with 40 GPU
    devices, one with 36 VGs and 36 SSDs, pods that reach past index 32 on
    each axis) through every StepCtx kernel family on the card, each path
    against the same call on the CPU path (`device="cpu"`, the plain
    versions), every count set to 0 just before and read just after: the
    records equal, each kernel of WIDE_PATHS launched, no plain version on
    the card."""
    build = lambda: smoke.wide_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)

    def sim(dev, speculate=True, **kw):
        cluster, apps = build()
        CountingEngine.speculate_default = speculate
        tapi.Engine = tcap.Engine = CountingEngine
        try:
            return smoke.placement_record(simtpu_torch.simulate(cluster, apps, device=dev, **kw))
        finally:
            tapi.Engine = tcap.Engine = scan.Engine
            CountingEngine.speculate_default = True

    def sweep(dev):
        cluster, apps = build()
        pc = tfaults.place_cluster(cluster, apps, device=dev)
        return smoke.sweep_record(tfaults.sweep_scenarios(pc, tfaults.generate_scenarios(cluster.nodes, "k=1")))

    def explained(dev):
        cluster, apps = build()
        return simtpu_torch.simulate(cluster, apps, device=dev, explain=True).explain

    def scores(dev):
        cluster, apps = build()
        with tempfile.TemporaryDirectory() as tmp:
            cfg = smoke.write_capacity_config(tmp, cluster, apps, smoke.template_node(synth))
            with contextlib.redirect_stderr(io.StringIO()):
                return smoke.run_cli_json(tcli.main, ["explain", "-f", cfg, "--scores", "4", "--json",
                                                      "--no-bulk", "--device", dev])

    calls = (
        (sim, smoke.record_differences),
        (lambda dev: sim(dev, speculate=False), smoke.record_differences),
        (lambda dev: sim(dev, bulk=True), smoke.record_differences),
        (sweep, smoke.sweep_differences),
        (explained, smoke.explain_differences),
        (scores, lambda a, b: ([f"exit {a[0]} != {b[0]}"] if a[0] != b[0] else [])
         + smoke.explain_differences(a[1], b[1])),
    )
    out = {}
    for (label, kernels), (call, differ) in zip(WIDE_PATHS, calls):
        recs = {}
        for dev in ("cpu", "cuda"):
            cuda.reset_counts()
            seed_name_hashes(smoke.NAME_SEED)
            try:
                recs[dev] = call(dev)
                if dev == "cuda":
                    torch.cuda.synchronize()
            finally:
                seed_name_hashes(None)
        launches, plain = dict(cuda.LAUNCHES), sum(cuda.PLAIN_CALLS.values())
        missing = [k for k in kernels if not launches.get(k)]
        diffs = differ(recs["cuda"], recs["cpu"])
        if missing or plain or diffs:
            raise AssertionError(f"phase 16: {label} on the wide problem: kernels not launched {missing}, "
                                 f"{plain} plain calls on the card, differences from the CPU path:\n"
                                 + "\n".join(diffs))
        out[label] = {k: launches[k] for k in kernels}
        log(f"phase 16: {label} on the wide problem (V = SD = {smoke.WIDE_VGS}, GD = {smoke.WIDE_GPUS}): "
            f"equal to the CPU path; launches {out[label]} [{card}]")
    return out


def phase_relax_wide(device, err) -> dict:
    """Phase 2: K23 on rows wider than shared memory holds (its wide-row
    path: a persistent grid, one global scratch slab per block) against its
    plain version on RELAX_WIDE: the start point, then 5 iterations, each
    K23 step taken by both from the same y and the same overcommit (K22's,
    itself compared with K22's plain version): y exactly equal after each;
    then the residual; then K23's time per launch on this shape."""
    a, b = relax_wide_problem(device)
    trelax.relax_project_plain(a, init=True)
    cuda.launch_relax_project(b, init=True)
    torch.cuda.synchronize()
    y_errs = [float((a.y - b.y).abs().max())]
    over_err = 0.0
    for _ in range(5):
        trelax.relax_load_plain(a)
        cuda.launch_relax_load(b)
        torch.cuda.synchronize()
        over_err = max(over_err, float((a.over - b.over).abs().max()))
        a.over.copy_(b.over)
        a.y.copy_(b.y)
        trelax.relax_project_plain(a)
        cuda.launch_relax_project(b)
        torch.cuda.synchronize()
        y_errs.append(float((a.y - b.y).abs().max()))
    trelax.relax_load_plain(a, residual=True)
    cuda.launch_relax_load(b, residual=True)
    torch.cuda.synchronize()
    res_err = float((a.residual - b.residual).abs().max())
    if max(y_errs) or not torch.equal(a.stuck, b.stuck) or over_err > smoke.SOLVE_RES_ATOL or res_err > smoke.SOLVE_RES_ATOL:
        raise AssertionError(f"phase 2: K23's wide-row path differs from its plain version on {RELAX_WIDE}: "
                             f"y {y_errs}, over {over_err}, residual {res_err}")
    err["relax_project"] = max(err["relax_project"], max(y_errs))
    ctx = b.cache["ctx"]
    bound = relax_bound(b)["relax_project"]
    # a launch takes milliseconds: CUDA events around back-to-back launches
    out = {"shape": list(RELAX_WIDE), "np2": ctx.np2, "slabs": ctx.slabs, "y_max_abs": max(y_errs),
           "over_max_abs": over_err, "residual_max_abs": res_err,
           "ms": time_call(lambda: cuda.launch_relax_project(b), 20),
           "plain_ms": time_call(lambda: trelax.relax_project_plain(a), 3), **bound}
    log(f"phase 2: K23's wide-row path equal to its plain version on (S, C, N, R) = {RELAX_WIDE} (np2 "
        f"{ctx.np2}, {ctx.slabs} slabs): y exactly equal after the start point and 5 steps, K22's over "
        f"{over_err:.3g}, residual {res_err:.3g}; {out['ms'] * 1e3:.2f} us per launch (CUDA events), "
        f"plain {out['plain_ms'] * 1e3:.1f} us, bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']})")
    return out


def relax_steps_equal(a, b, steps: int) -> tuple:
    """K23 against its plain version from the same inputs: the start point,
    then `steps` iterations, each K23 step taken by both from the same y and
    the same overcommit (K22's on the card, itself compared with K22's
    plain version). Returns (the largest |dy| after each launch — 0 when
    every y is equal —, K22's largest |d over|)."""
    trelax.relax_project_plain(a, init=True)
    cuda.launch_relax_project(b, init=True)
    torch.cuda.synchronize()
    y_errs = [0.0 if torch.equal(a.y, b.y) and torch.equal(a.stuck, b.stuck)
              else float((a.y - b.y).abs().max()) or float("nan")]
    over_err = 0.0
    for _ in range(steps):
        trelax.relax_load_plain(a)
        cuda.launch_relax_load(b)
        torch.cuda.synchronize()
        over_err = max(over_err, float((a.over - b.over).abs().max()))
        a.over.copy_(b.over)
        a.y.copy_(b.y)
        trelax.relax_project_plain(a)
        cuda.launch_relax_project(b)
        torch.cuda.synchronize()
        y_errs.append(0.0 if torch.equal(a.y, b.y) else float((a.y - b.y).abs().max()) or float("nan"))
    return y_errs, over_err


def relax_edge_rows(device, n: int, seed: int = 9):
    """Two equal RelaxBuffers (plain side, kernel side) of (S, C) = (3, 6)
    rows of N nodes whose step values hold the projection's edge cases
    (the overcommit is 0, so the step value v is y itself): class 0 long
    runs of ties (three values), class 1 -0.0 and +0.0 in one row beside a
    few positives (a = 2: tau near 0), class 2 a = 0, class 3 one node on
    the mask, class 4 one value in the whole row (a row of ties), class 5
    normal values; candidate 2 has no valid node (every row all masked)."""
    s, c, r = 3, 6, 3
    rng = np.random.default_rng(seed)
    feas = np.ones((c, n), bool)
    feas[3] = False
    feas[3, n // 2] = True
    valid = rng.random((s, n)) < 0.9
    valid[2] = False
    y = np.zeros((s, c, n), np.float32)
    y[:, 0] = rng.choice(np.float32([0.5, 0.25, 0.125]), (s, n))
    y[:, 1] = np.where(rng.random((s, n)) < 0.5, np.float32(-0.0), np.float32(0.0))
    y[:, 1, ::97] = 0.75
    y[:, 2] = rng.random((s, n))
    y[:, 3] = rng.random((s, n))
    y[:, 4] = 0.375
    y[:, 5] = rng.standard_normal((s, n))
    cnt = np.float32([n / 8, 2.0, 0.0, 3.0, n / 3, n / 4])
    cap = rng.uniform(0.5, 1.0, (n, r)).astype(np.float32)
    req = rng.uniform(0.0, 0.01, (c, r)).astype(np.float32)
    args = (feas, req, cnt, np.zeros((n, r), np.float32), cap, valid, np.float32(0.05), device)
    pair = trelax.relax_buffers(*args), trelax.relax_buffers(*args)
    for rb in pair:
        rb.y.copy_(torch.as_tensor(y, device=device))
    return pair


def phase_relax_shapes(device, err) -> dict:
    """Phase 2: K23 against its plain version at each launch-plan boundary
    (RELAX_EDGES at (S, C, R) = (4, 3, 3): the start point and 3 steps
    from the same inputs, y equal after each) and on the edge-row set
    (RELAX_EDGE_ROWS: ties, -0.0 beside +0.0, a = 0, all-masked rows; one
    step from the same y, equal); K23's path and its µs per launch (CUDA
    events) at each."""
    out = {"edges": {}, "edge_rows": {}}
    for n in RELAX_EDGES:
        a, b = relax_wide_problem(device, seed=n, shape=(4, 3, n, 3))
        y_errs, over_err = relax_steps_equal(a, b, 3)
        if max(y_errs) or over_err > smoke.SOLVE_RES_ATOL:
            raise AssertionError(f"phase 2: K23 at N = {n} differs from its plain version: y {y_errs}, "
                                 f"over {over_err}")
        plan = cuda.relax_project_plan(n, 12)
        out["edges"][n] = {"path": plan["path"], "threads": plan["threads"],
                           "keys_per_thread": plan["keys_per_thread"],
                           "us": time_call(lambda: cuda.launch_relax_project(b), 50) * 1e3}
    for n in RELAX_EDGE_ROWS:
        a, b = relax_edge_rows(device, n)
        trelax.relax_project_plain(a)
        cuda.launch_relax_project(b)
        torch.cuda.synchronize()
        if not torch.equal(a.y, b.y):
            raise AssertionError(f"phase 2: K23 on the edge rows at N = {n} differs from its plain version by "
                                 f"{float((a.y - b.y).abs().max())}")
        # the edge cases held: a = 0 and all-masked rows zero, the ties' and
        # the signed zeros' rows summing to a
        sums = b.y.sum(dim=2).cpu().numpy()
        if b.y[:, 2].any() or b.y[2].any() or abs(sums[0, 1] - 2.0) > 1e-3 or abs(sums[0, 0] / (n / 8) - 1) > 1e-4:
            raise AssertionError(f"phase 2: K23's edge rows at N = {n}: sums {sums.tolist()}")
        plan = cuda.relax_project_plan(n, 18)
        out["edge_rows"][n] = {"path": plan["path"], "keys_per_thread": plan["keys_per_thread"]}
    log("phase 2: K23 equal to its plain version at the launch-plan boundaries " + ", ".join(
        f"N = {n} ({o['path']}, {o['threads']} x {o['keys_per_thread']}: {o['us']:.2f} us per launch of 12 rows)"
        for n, o in out["edges"].items()) + "; and on the edge rows (ties, -0.0 beside +0.0, a = 0, all "
        "masked) at N = " + ", ".join(f"{n} ({o['path']})" for n, o in out["edge_rows"].items()))
    return out


class GrowCompare:
    """Context manager: while open, every K24 / K25 launch is followed by
    its plain version on the same inputs, each output plane compared bit
    for bit; the inputs of each kind of growth are kept for the timing."""

    def __enter__(self):
        self.orig = (cuda.launch_grow_terms, cuda.launch_grow_nodes)
        self.calls = []

        def grow_terms(state, g):
            got = self.orig[0](state, g)
            want = sstate.grow_terms_plain(state, g)
            kind = ("entry" if not self.calls else
                    "promotion" if g.t_cap > state.cnt_match.shape[0] else "extend")
            self._check("grow_terms", kind, got, want)
            self.calls.append(("grow_terms", kind, state, g))
            return got

        def grow_nodes(state, add, a):
            got = self.orig[1](state, add, a)
            want = sstate.grow_nodes_plain(state, add, a)
            self._check("grow_nodes", "nodes", got, want)
            self.calls.append(("grow_nodes", "nodes", state, (add, a)))
            return got

        cuda.launch_grow_terms, cuda.launch_grow_nodes = grow_terms, grow_nodes
        return self

    @staticmethod
    def _check(name, kind, got, want):
        bad = [k for k in want if got[k].shape != want[k].shape or not torch.equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"phase 2: {name} ({kind}) differs from its plain version on planes {bad}")

    def __exit__(self, *exc):
        cuda.launch_grow_terms, cuda.launch_grow_nodes = self.orig
        return False


def grow_bytes(name: str, state, arg) -> int:
    """Bytes K24 / K25 must move for one growth: every old plane it reads,
    the host plan's new rows or columns, every plane it writes."""
    if name == "grow_terms":
        g = arg
        n = state.free.shape[0]
        old = sum(getattr(state, f).numel() for f in ("cnt_match", "cnt_total") + sstate.OWN_PLANES)
        new = (g.t_cap * (n + 1) + 4 * g.ti_cap * n)
        return int(4 * (old + new + g.rows.numel() + g.tot.numel() + g.inv.numel() + g.perm.numel()))
    add, a = arg
    total = 0
    for f, _kind in sstate.NODE_GROWTH:
        t = getattr(state, f)
        extra = add[f]
        total += t.numel() * t.element_size() * 2
        total += 2 * extra.numel() * extra.element_size() if extra is not None else 0
        if extra is None:
            total += a * t.shape[1] * t.element_size()
    return int(total)


def phase_grow_kernels(device) -> dict:
    """Phase 2: K24/K25 against their plain versions on the grow problem's
    carry on the card — the entry padding, the in-bucket extension, the
    bucket promotions and the node growth — bit for bit; then their times
    at the promotion and at the node growth."""
    with GrowCompare() as cmp:
        smoke.run_grow(simtpu_torch, lambda tz: scan.Engine(tz, device))
    kinds = [k for _, k, _, _ in cmp.calls]
    if "promotion" not in kinds or "nodes" not in kinds:
        raise AssertionError(f"phase 2: the grow problem grew by {kinds}: no promotion or node growth")
    log(f"phase 2: K24/K25 equal to their plain versions bit for bit on the grow problem's carry "
        f"({', '.join(kinds)})")
    times = {}
    for name, kind in (("grow_terms", "promotion"), ("grow_nodes", "nodes")):
        _, _, st, arg = next(c for c in reversed(cmp.calls) if c[1] == kind)
        if name == "grow_terms":
            launch = lambda: cuda.launch_grow_terms(st, arg)  # noqa: E731
            plain = lambda: sstate.grow_terms_plain(st, arg)  # noqa: E731
        else:
            launch = lambda: cuda.launch_grow_nodes(st, *arg)  # noqa: E731
            plain = lambda: sstate.grow_nodes_plain(st, *arg)  # noqa: E731
        host_ms = time_call(launch, 100)
        plain_ms = time_call(plain, 20)
        per, _, _ = profile_kernels(lambda: [launch() for _ in range(20)], {name: launch})
        nbytes = grow_bytes(name, st, arg)
        at = (f"t {st.cnt_match.shape[0]} -> {arg.t_cap}, ti {st.cnt_own_anti.shape[0]} -> {arg.ti_cap}, "
              f"N={st.free.shape[0]}" if name == "grow_terms" else f"N={st.free.shape[0]} + {arg[1]}")
        times[name] = {"ms": per[name][0] / 1e3, "host_ms": host_ms, "plain_ms": plain_ms, "bytes": nbytes,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "at": at}
        log(f"  {name}: {per[name][0]:.2f} us device (profiler), {host_ms * 1e3:.2f} us per back-to-back call "
            f"from Python, plain {plain_ms * 1e3:.1f} us, {nbytes} B, bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e6:.3f} us ({kind}: {at})")
    return times


class SolveSplit:
    """Context manager: while open, the host wall of each solver consult
    (`attempt_solve` / `solve_lower_bound`) and of its parts — the
    relaxation (K22/K23, synchronized by the residuals' copy), the
    certificate, the rounding, the audits and the fallback's placement
    inside it — is summed per part."""

    PARTS = (("relax_candidates", "relax"), ("infeasibility_certificate", "certificate"),
             ("round_candidate", "rounding"))

    def __enter__(self):
        self.parts = {}
        self.inside = False
        self.undo = []

        def timed(owner, attr, part, only_inside=False, outer=False):
            fn = getattr(owner, attr)

            def wrapper(*a, **kw):
                if only_inside and not self.inside:
                    return fn(*a, **kw)
                if outer:
                    self.inside = True
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.parts[part] = self.parts.get(part, 0.0) + time.perf_counter() - t
                    if outer:
                        self.inside = False

            setattr(owner, attr, wrapper)
            self.undo.append((owner, attr, fn))

        for attr, part in self.PARTS:
            timed(tplanner, attr, part)
        timed(checker, "audit_placement", "audit", only_inside=True)
        timed(scan.Engine, "place", "fallback", only_inside=True)
        # the planners reach the consult through the solve package
        import simtpu_torch.solve as tsolve

        # (the facade planner's consult calls the planner module's own
        # attempt_solve; the others import it from the package)
        timed(tplanner, "attempt_solve", "consult", outer=True)
        for attr in ("attempt_solve", "solve_lower_bound"):
            timed(tsolve, attr, "consult", outer=True)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.undo):
            setattr(owner, attr, fn)
        return False


def run_solver_path(label: str, cfg: str, argv: list, golden: dict) -> dict:
    """One solver CLI run on the card, counts zeroed just before, against
    its golden record: the document, the relaxation's residuals and
    fetched y to the stated tolerances (the feasible sets equal), the
    rounded counts and the shipped plan exactly; K22 and K23 iters + 1
    times per relaxation, no plain version."""
    sstate.GROW_COUNTS.clear()  # a one-shot CLI process starts with none
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with SolveSplit() as split, smoke.record_solver(tplanner) as got, smoke.capture_plans(tcap) as plans, \
                contextlib.redirect_stderr(io.StringIO()):
            rc, doc = smoke.run_cli_json(tcli.main, [argv[0], "-f", cfg, *argv[1:]])
    finally:
        seed_name_hashes(None)
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    diffs = []
    if rc != golden["rc"]:
        diffs.append(f"exit {rc} != golden {golden['rc']}")
    if smoke.solve_doc_record(doc) != golden["doc"]:
        diffs.append(f"document {json.dumps(smoke.solve_doc_record(doc))[:900]} != golden "
                     f"{json.dumps(golden['doc'])[:900]}")
    want = golden["solver"]
    res_err, y_err = 0.0, 0.0
    if len(got["relax"]) != len(want["relax"]):
        diffs.append(f"{len(got['relax'])} relaxations, golden {len(want['relax'])}")
    for a, b in zip(got["relax"], want["relax"]):
        if [a[k] for k in ("s", "c", "n", "r", "cnt")] != [b[k] for k in ("s", "c", "n", "r", "cnt")] \
                or np.float32(a["lr"]) != np.float32(b["lr"]):
            diffs.append("the relaxation's problem differs from the golden one")
        ra, rb_ = np.asarray(a["residual"]), np.asarray(b["residual"])
        fin = np.isfinite(rb_)
        if not np.array_equal(np.isfinite(ra), fin) or not np.array_equal(ra <= trelax.RESIDUAL_TOL,
                                                                             rb_ <= trelax.RESIDUAL_TOL):
            diffs.append("the relax-feasible candidates differ from the golden ones")
        res_err = max(res_err, float(np.abs(ra[fin] - rb_[fin]).max()) if fin.any() else 0.0)
    if set(got["y"]) != set(want["y"]):
        diffs.append(f"fetched candidates {sorted(got['y'])} != golden {sorted(want['y'])}")
    for k in set(got["y"]) & set(want["y"]):
        y_err = max(y_err, float(np.abs(smoke.unpack_array(got["y"][k]) - smoke.unpack_array(want["y"][k])).max()))
    if [r["m"] and r["m"]["sha256"] for r in got["round"]] != [r["m"] and r["m"]["sha256"] for r in want["round"]]:
        diffs.append("the rounded counts differ from the golden ones")
    if "plan" in golden and (not plans or smoke.plan_digest(plans[-1]) != golden["plan"]):
        diffs.append(f"the shipped plan {plans and smoke.plan_digest(plans[-1])} != golden {golden['plan']}")
    if res_err > smoke.SOLVE_RES_ATOL or y_err > smoke.SOLVE_Y_ATOL:
        diffs.append(f"residual {res_err} / y {y_err} beyond {smoke.SOLVE_RES_ATOL} / {smoke.SOLVE_Y_ATOL}")
    n_relax = len(got["relax"])
    want_launches = (smoke.SOLVE_ITERS + 1) * n_relax
    if launches.get("relax_load", 0) != want_launches or launches.get("relax_project", 0) != want_launches:
        diffs.append(f"K22/K23 launched {launches.get('relax_load', 0)}/{launches.get('relax_project', 0)} "
                     f"times for {n_relax} relaxation(s)")
    if any(plain.values()):
        diffs.append(f"plain versions ran: {plain}")
    if diffs:
        raise AssertionError(f"phase 14 {label}: " + "; ".join(diffs))
    solve = doc["engine"]["solve"] if "engine" in doc else doc.get("solve", {})
    return {"rc": rc, "wall_s": wall, "launches": launches, "split_s": split.parts,
            "residual_max_abs": res_err, "y_max_abs": y_err, "status": solve.get("status"),
            "k": solve.get("k"), "lower_bound": solve.get("lower_bound"),
            "nodes_added": doc.get("nodes_added"), "relaxations": n_relax,
            "plan_s": (plans[-1].timings.get("plan") if plans else None)}


def run_solver_paths(card: str, walls: dict) -> dict:
    """Phase 14: (a) `cli apply --solver --json` on the capacity problem's
    config, (b) the same on the large capacity problem's, (c) `cli
    resilience --plan --faults k=2:64 --seed 0 --solver --json` on the
    capacity config (the relax-only lower bound), each against
    tests/data/torch_solve.json.gz."""
    golden = smoke.load_record(smoke.SOLVE_GOLDEN)
    if golden["iters"] != smoke.SOLVE_ITERS:
        raise AssertionError(f"phase 14: the golden relaxations ran {golden['iters']} iterations")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cap = smoke.capacity_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
        cap_cfg = smoke.write_capacity_config(f"{tmp}/capacity", *cap)
        lcap = smoke.large_capacity_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
        lcap_cfg = smoke.write_capacity_config(f"{tmp}/large", *lcap)
        for key, cfg, argv in (
                ("capacity", cap_cfg, ["apply", "--solver", "--json"]),
                ("large_capacity", lcap_cfg, ["apply", "--solver", "--json"]),
                ("resilience", cap_cfg, ["resilience", "--plan", "--faults", smoke.CAP_RESIL_SPEC, "--seed", "0",
                                         "--solver", "--json"])):
            o = out[key] = run_solver_path(key, cfg, argv, golden[key])
            split = ", ".join(f"{k} {v:.3f} s" for k, v in o["split_s"].items())
            beside = {"capacity": f"; phase 5's solver-off plan {walls['capacity']:.2f} s",
                      "large_capacity": f"; phase 7's solver-off plan {walls['large_capacity']:.2f} s",
                      "resilience": f"; phase 11's solver-off run {walls['resilience']:.2f} s"}[key]
            log(f"phase 14 ({key}): cli {' '.join(argv)}: exit {o['rc']}, solve {o['status']} k={o['k']} "
                f"lower bound {o['lower_bound']}, +{o['nodes_added']} nodes; == golden (document, residuals "
                f"to {o['residual_max_abs']:.3g}, y to {o['y_max_abs']:.3g}, rounded counts, plan); K22/K23 "
                f"{o['launches'].get('relax_load', 0)}/{o['launches'].get('relax_project', 0)} launches, no "
                f"plain version; wall {o['wall_s']:.2f} s (plan {o['plan_s'] or 0.0:.2f} s): {split}{beside} "
                f"[{card}]")
    return out


def run_grow_path(card: str, device) -> dict:
    """Phase 15: the grow problem on `Engine(device="cuda")` in grow mode,
    counts zeroed just before, against tests/data/torch_grow.json.gz and
    against a non-grow engine's run on the same card: K24 once on entry and
    once per term extension, K25 once per node growth, no K11/K12 and no
    plain version."""
    golden = smoke.load_record(smoke.GROW_GOLDEN)
    keys = ("grow.extends", "grow.bucket_promotions", "grow.node_extends", "grow.rebuilds")
    before = {k: sstate.GROW_COUNTS[k] for k in keys}
    cuda.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = smoke.run_grow(simtpu_torch, lambda tz: scan.Engine(tz, device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    rec = smoke.grow_record(run, {k: sstate.GROW_COUNTS[k] - before[k] for k in keys})
    diffs = smoke.grow_differences(rec, golden)
    if diffs:
        raise AssertionError("phase 15: the grow run differs from the golden record:\n" + "\n".join(diffs))
    want_k24 = 1 + golden["grow"]["grow.extends"]
    want_k25 = golden["grow"]["grow.node_extends"]
    if launches.get("grow_terms", 0) != want_k24 or launches.get("grow_nodes", 0) != want_k25 \
            or launches.get("compact_compress", 0) or launches.get("compact_expand", 0) or any(plain.values()):
        raise AssertionError(f"phase 15: launches {launches} (want K24 {want_k24}, K25 {want_k25}, no K11/K12), "
                             f"plain {plain}")
    t1 = time.perf_counter()
    flat = smoke.run_grow(simtpu_torch, lambda tz: scan.Engine(tz, device), grow=False)
    torch.cuda.synchronize()
    flat_wall = time.perf_counter() - t1
    flat_rec = smoke.grow_record(flat, rec["grow"])
    if flat_rec != rec:
        raise AssertionError("phase 15: the grow run differs from the non-grow engine's: "
                             + "; ".join(smoke.grow_differences(flat_rec, rec)))
    eng = run["engine"]
    log(f"phase 15: the grow problem on Engine(device='cuda') in grow mode: {len(rec['waves'])} waves of "
        f"{[w['pods'] for w in rec['waves']]} pods, {smoke.GROW_CLONES} clones before the last; placements and "
        f"every final plane == golden == the non-grow engine's; grow counts {rec['grow']}; K24 "
        f"{launches.get('grow_terms', 0)}, K25 {launches.get('grow_nodes', 0)}, K11/K12 0, no plain version; "
        f"final buckets t {eng._grow_ref['t']}/{eng._grow_ref['t_cap']}, ti {eng._grow_ref['ti']}/"
        f"{eng._grow_ref['ti_cap']}; {wall:.2f} s (non-grow engine {flat_wall:.2f} s) [{card}]")
    return {"wall_s": wall, "wall_s_no_grow": flat_wall, "launches": launches, "grow": rec["grow"]}


# -- phase 17: term columns past the shared budget; K22 and K20 at their shapes --

#: the terms problem (smoke.terms_problem) on the card: (preferred terms,
#: the Tc they give) on TERMS_NODES nodes, (many, web, webq) replicas
TERMS_CASES = ((300, 512), (600, 1024))
TERMS_NODES = 1000
TERMS_REPLICAS = (120, 1200, 120)


def terms_cluster(terms: int):
    return smoke.terms_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes, TERMS_NODES, terms,
                               TERMS_REPLICAS)


#: the terms problems tensorized (phases 17 and 21), by term count
TERMS_BATCHES = {}


def terms_batch(device, terms: int):
    """terms_cluster(terms) tensorized with a seeded 2000-entry placement
    log (tensorized_batch), once per term count."""
    if terms not in TERMS_BATCHES:
        TERMS_BATCHES[terms] = tensorized_batch(*terms_cluster(terms), device, 2000)
    return TERMS_BATCHES[terms]


def phase_terms(device, err) -> dict:
    """Phase 17 (a): any number of term columns. The terms problem at Tc =
    512 and 1024 (a seeded placement log of 2000 entries): K14 -> K15 ->
    K16 against their plain versions on its first plain and quota rounds
    (K16's published words in global memory), K10 on its first hard-spread
    run, and at Tc = 1024 K18/K19 on the 16 single-node scenarios of a k=1
    sweep that evict the most pods (the lists cut to 48 rows for the plain
    version); every output and plane equal. Then the plans' modes, and
    K10's, K16's and K19's device time at Tc = 1024."""
    out = {}
    for terms, tc in TERMS_CASES:
        cluster, apps = terms_cluster(terms)
        t, b, s, st, p = terms_batch(device, terms)
        f = scan.flags_from(t, b.ext)
        if s.g_terms.shape[1] != tc:
            raise AssertionError(f"phase 17: the terms problem has Tc = {s.g_terms.shape[1]}, want {tc}")
        label = f"Tc={tc} terms problem"
        r_done, r_first, _ = phase_rounds(label, t, b, s, st, p, f, ("plain", "quota-anti"), err)
        w_done, w_runs, w_buf = phase_waves(label, t, b, s, st, p, f, ("hard-spread",), err, per_kind=1)
        n, r = int(t.n_nodes), int(t.alloc.shape[1])
        kmax = max(1, min(tc, int(s.node_dom.shape[0])))
        pods_max = max(bb - a for _, a, bb, _, _ in w_runs)
        plans = {"round_commit": cuda.round_plan(n, tc)["mode"],
                 "wave_hard": cuda.wave_hard_plan(n, r, tc, kmax, pods_max)["mode"],
                 "sweep_place": cuda.sweep_place_plan(n, r, tc)["mode"],
                 "sweep_drain": cuda.sweep_drain_plan(16, n, tc, 20)["staging"]}
        row = {"tc": tc, "nodes": n, "terms": int(t.n_terms), "rounds": r_done, "waves": w_done, "plans": plans}
        log(f"phase 17: K14-K16 equal to their plain versions on the {label}'s rounds {r_done}, K10 on its "
            f"runs {w_done}; plans {plans}")
        if tc == 1024:
            seed_name_hashes(smoke.NAME_SEED)
            try:
                pc = tfaults.place_cluster(cluster, apps, device="cuda")
            finally:
                seed_name_hashes(None)
            inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "k=1"))
            order = np.argsort([-len(v) for v in inp.rq_lists], kind="stable")[:16]
            keep = np.zeros(len(inp.masks), bool)
            keep[order] = True
            inp = tsweep.SweepInputs(pc, tfaults.ScenarioSet(masks=inp.masks[keep], labels=tuple(
                f"node:{i}" for i in np.flatnonzero(keep))))
            (_, _, _), rows, nodes, plain = compare_sweep_chunk("phase 17", f"{label}'s k=1 chunk", inp, 0, 16, err,
                                                                 rq_cols=48)
            valid, ev_idx, rq_idx, _ = inp.chunk(0, 16, 16)
            place = time_place(inp, valid, ev_idx, rq_idx)

            def fresh_place():
                batched.sweep_place(batched.SweepBuffers(inp.batch_buf, inp.pods, inp.statics, batched.sweep_drain(
                    inp.statics, inp.state, inp.log, ev_idx), valid, rq_idx))
            per, _, _ = profile_kernels(lambda: [fresh_place() for _ in range(5)], {"sweep_place": fresh_place})
            place["device_us"] = per["sweep_place"][0]
            rt = time_rounds(t, s, p, f, r_first["plain"], f"{label}'s first plain")
            wt = time_wave(w_buf, w_runs[0], 10)
            row["times"] = {"wave_hard": wt, "round_commit": rt["round_commit"], "round_score": rt["round_score"],
                            "round_pick": rt["round_pick"], "sweep_place": place,
                            "sweep_rows_compared": rows, "sweep_plain_s": plain}
            log(f"phase 17: K18/K19 equal to their plain versions on 16 scenarios of the {label} ({rows} requeue "
                f"rows compared); at Tc = 1024: K10 {wt['device_us']:.2f} us a launch of {wt['pods']} pods "
                f"({wt['device_us'] / wt['pods']:.2f} us a pod step), K16 {rt['round_commit']['ms'] * 1e3:.2f} us "
                f"a round, K19 {place['device_us']:.2f} us a launch (profiler; {place_rates(place)})")
        out[f"tc{tc}"] = row
    return out


#: K22 beside the two relaxations: seeded (S, C, N, R), no N a multiple of 4
RELAX_LOAD_SHAPES = ((8, 7, 1001, 1), (8, 7, 1003, 3), (6, 5, 999, 12))
#: K22's plan sweep (cuda.relax_load_plan): threads, nodes a thread,
#: classes unrolled
RELAX_LOAD_SWEEP = ((64, 128, 256), (1, 2, 4), (4, 8, 16))


def relax_seeded(device, shape, seed: int):
    """Relaxation buffers of (S, C, N, R) from `seed`; candidate 0 has no
    valid node, so it is stuck (its residual +inf)."""
    s, c, n, r = shape
    rng = np.random.default_rng(seed)
    cap = (rng.random((n, r)) * 4 + 1).astype(np.float32)
    valid = rng.random((s, n)) < 0.9
    valid[0] = False
    return trelax.relax_buffers(rng.random((c, n)) < 0.7, rng.random((c, r)).astype(np.float32),
                                rng.integers(1000, 5000, c).astype(np.float32),
                                (rng.random((n, r)) * cap * 0.5).astype(np.float32), cap, valid, np.float32(0.05),
                                device)


def relax_load_equal(a, b, steps: int, label: str, err) -> float:
    """`steps` K22 launches on `b` against relax_load_plain on `a` from the
    same y (the plain projection moving y between them; the last step in
    residual mode): over and the residual exactly equal."""
    for it in range(steps):
        res = it == steps - 1
        b.y.copy_(a.y)
        b.residual.zero_()
        a.residual.zero_()
        trelax.relax_load_plain(a, residual=res)
        cuda.launch_relax_load(b, residual=res)
        torch.cuda.synchronize()
        d = float((a.over - b.over).abs().max())
        if d or (res and not torch.equal(a.residual, b.residual)):
            raise AssertionError(f"phase 17: K22 differs from relax_load_plain on {label} at step {it}: over {d}, "
                                 f"residual {a.residual.tolist()} vs {b.residual.tolist()}")
        trelax.relax_project_plain(a)


def phase_relax_load_shapes(device, err) -> dict:
    """Phase 17 (b): K22 against relax_load_plain at R = 1, 3 and 12 (the
    chunked path) on seeded relaxations at N no multiple of 4, 5 steps
    each, exactly; its plan swept at the capacity relaxation (every plan
    equal to the plain version, then each one's device time in turns), and
    the load's yardstick, one torch.einsum("scn,cr->snr") on the same y
    and req (the load alone, not K22's whole function)."""
    out = {"shapes": {}}
    for q, shape in enumerate(RELAX_LOAD_SHAPES):
        a, b = relax_seeded(device, shape, 40 + q), relax_seeded(device, shape, 40 + q)
        trelax.relax_project_plain(a, init=True)
        b.stuck.copy_(a.stuck)
        relax_load_equal(a, b, 5, f"{shape}", err)
        per, _, _ = profile_kernels(lambda: [cuda.launch_relax_load(b) for _ in range(20)],
                                    {"relax_load": lambda: cuda.launch_relax_load(b)})
        plan = cuda.relax_load_plan(*shape[:1], shape[2], shape[3])
        out["shapes"][str(shape)] = {"device_us": per["relax_load"][0], "bound_us":
                                     relax_bound(b)["relax_load"]["bound_ms"] * 1e3, "template": plan["template"],
                                     "r_chunks": plan["r_chunks"]}
        log(f"phase 17: K22 equal to relax_load_plain on (S, C, N, R) = {shape} (5 steps, the last in residual "
            f"mode, candidate 0 stuck): {per['relax_load'][0]:.2f} us device, template {plan['template']} in "
            f"{plan['r_chunks']} chunk(s)")
    prob, valid = relax_problem_of(smoke.capacity_problem)
    args = (prob.feas, prob.req, prob.cnt, prob.fixed, prob.cap, valid, np.float32(prob.lr), device)
    a, b = trelax.relax_buffers(*args), trelax.relax_buffers(*args)
    trelax.relax_project_plain(a, init=True)
    b.stuck.copy_(a.stuck)
    trelax.relax_project_plain(a)
    b.y.copy_(a.y)
    trelax.relax_load_plain(a)
    cuda.launch_relax_load(b)
    ctx = b.cache["ctx"]
    chosen = (ctx.load_threads, ctx.load_npt, ctx.load_unroll)
    launchers = {}
    for threads in RELAX_LOAD_SWEEP[0]:
        for npt in RELAX_LOAD_SWEEP[1]:
            for unroll in RELAX_LOAD_SWEEP[2]:
                def go(_, cfg=(threads, npt, unroll)):
                    ctx.load_threads, ctx.load_npt, ctx.load_unroll = cfg
                    cuda.launch_relax_load(b)
                go(None)
                torch.cuda.synchronize()
                if not torch.equal(a.over, b.over):
                    raise AssertionError(f"phase 17: K22 at plan {(threads, npt, unroll)} differs from its plain "
                                         "version on the capacity relaxation")
                launchers[f"{threads}x{npt}x{unroll}"] = go
    launchers["einsum"] = lambda _: torch.einsum("scn,cr->snr", b.y, b.req)
    sweep = in_turns(launchers, lambda: None, per_turn=4)
    ctx.load_threads, ctx.load_npt, ctx.load_unroll = chosen
    out["sweep_us"] = {k: v * 1e3 for k, v in sweep.items() if k != "einsum"}
    out["yardstick_us"] = sweep["einsum"] * 1e3
    out["chosen"] = "x".join(map(str, chosen))
    best = min(out["sweep_us"], key=out["sweep_us"].get)
    log(f"phase 17: K22's plan sweep at the capacity relaxation (threads x nodes a thread x unroll, CUDA events "
        f"in turns, every plan equal to the plain version): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(out["sweep_us"].items(), key=lambda kv: kv[1])) +
        f" us; fastest {best}, the plan's {out['chosen']}; the load's yardstick torch.einsum {out['yardstick_us']:.2f} us")
    return out


#: K20 beside the explain paths' chunks: (label, N, pods, k) of seeded
#: states of the serial smoke mix
EXPLAIN_SHAPES = (("one pod, N=120", 120, 1, 4), ("N=3001", 3001, 64, 4), ("N=5000", 5000, 64, 4),
                  ("N=9000", 9000, 64, 4), ("one pod, N=9000", 9000, 1, 4), ("8 pods, N=3001, k=128", 3001, 8, 128),
                  ("N=120, k=64", 120, 64, 64))


def explain_inputs(device, n: int, p: int, k: int, seed: int):
    """(statics, state, pod rows, flags, k) of `p` pods drawn from the
    serial smoke mix on `n` nodes against a state of 3 n seeded
    placements."""
    t, b, s, st, pods = tensorized_batch(*smoke.smoke_problem(synth_cluster, synth_apps, n_nodes=n,
                                                              n_pods=max(4 * p, 400)), device, 3 * n)
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(len(pods[0]), p, replace=False))
    return s, st, tuple(np.asarray(x)[sel] for x in pods), scan.flags_from(t, b.ext), k


def phase_explain_shapes(device, err) -> dict:
    """Phase 17 (c): K20 against explain_pass_plain beside phase 12's
    chunks: one pod on 120 nodes (one block), 64 pods on 3001 (a ragged
    last tile), 5000 and 9000 nodes, one pod on 9000 (16 blocks), 8 on
    3001 with k = 128 (4 blocks a pod),
    where some stage's first k witnesses span two tiles, and 64 on 120
    with k = 64, where some stage eliminates fewer than k nodes; counts,
    feasible, witnesses and fail codes exactly. Then each shape's device time, and the cluster
    size swept at 64 x 5000 (every size equal, then in turns)."""
    out = {}
    for q, (label, n, p, k) in enumerate(EXPLAIN_SHAPES):
        inputs = explain_inputs(device, n, p, k, 60 + q)
        cmp = compare_explain_chunk(f"{label} chunk", inputs, err, "phase 17")
        eb = cmp["eb"]
        plan = cuda.explain_plan(n, int(inputs[0].g_terms.shape[1]), pods=p, sms=torch.cuda.get_device_properties(
            0).multi_processor_count)
        counts, _, wits, _ = tbd.explain_pass(*inputs)
        row = {"pods": p, "n": n, "k": k, "blocks": plan["blocks"], "tile": plan["tile"],
               "plain_ms": cmp["plain_s"] * 1e3}
        if k > tbd.WITNESS_K:
            tiles = [np.unique(w[w >= 0] // plan["tile"]).size for w in wits.reshape(-1, k)]
            short = int(((counts > 0) & (counts < k)).sum())
            row.update(stages_spanning_tiles=int(sum(t_ > 1 for t_ in tiles)), stages_below_k=short)
        per, _, _ = profile_kernels(lambda: [cuda.launch_explain_pass(eb) for _ in range(20)],
                                    {"explain_pass": lambda: cuda.launch_explain_pass(eb)})
        nbytes = explain_bytes(eb)
        row.update(device_us=per["explain_pass"][0], bytes=nbytes, bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
        if n == 5000:
            launchers = {}
            for blocks in (1, 2, 4, 8, 16):
                # a pad the kernel does not write would keep this value
                eb.witnesses.fill_(-7)
                cuda.launch_explain_pass(eb, blocks)
                if not all(np.array_equal(x, y) for x, y in zip(eb.outputs(), cmp["want"])):
                    raise AssertionError(f"phase 17: K20 on {blocks} blocks a pod differs on the {label} chunk")
                launchers[str(blocks)] = lambda _, blocks=blocks: cuda.launch_explain_pass(eb, blocks)
            row["cluster_sweep_us"] = {kk: v * 1e3 for kk, v in in_turns(launchers, lambda: None, 4).items()}
        out[label] = row
        log(f"phase 17: K20 on the {label} chunk ({p} pods x N={n}, k={k}, {plan['blocks']} blocks of "
            f"{plan['tile']} nodes a pod): {row['device_us']:.2f} us device, bound {row['bound_us']:.4f} us"
            + (f"; {row['stages_spanning_tiles']} stage rows with witnesses in two tiles or more, "
               f"{row['stages_below_k']} with fewer eliminations than k" if k > tbd.WITNESS_K else "")
            + (f"; cluster sweep (blocks a pod: us, CUDA events in turns) {row['cluster_sweep_us']}"
               if "cluster_sweep_us" in row else ""))
    wide = [r for r in out.values() if r["k"] > tbd.WITNESS_K]
    if not any(r["stages_spanning_tiles"] for r in wide) or not any(r["stages_below_k"] for r in wide):
        raise AssertionError("phase 17: no K20 shape has a stage whose first k witnesses span two tiles, or none "
                             "a stage with fewer eliminations than k")
    return out


#: phase 18's many-keys sweep problem (smoke.many_keys_problem): nodes and
#: replicas a deployment
MANY_KEYS_NODES, MANY_KEYS_REPLICAS = 256, 4


def phase_many_keys(device, err) -> tuple:
    """Phase 18 (a): K18 past the 4096 topology keys its packed sort keys
    held. The many-keys problem (4100 keys every node carries, 50 a group,
    Tc = 64) placed on the card; the 16 single-node scenarios of a k=1 sweep
    on the nodes whose pods own the highest key ids: K18 and K19 equal to
    their plain versions (every replica plane, nodes, reasons), some
    drained pair on a key past 4095; then K18's device time there.
    Returns the measurements and K18's plan there (staging)."""
    cluster, apps = smoke.many_keys_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes,
                                            MANY_KEYS_NODES, MANY_KEYS_REPLICAS)
    seed_name_hashes(smoke.NAME_SEED)
    try:
        pc = tfaults.place_cluster(cluster, apps, device="cuda")
    finally:
        seed_name_hashes(None)
    inp = tsweep.SweepInputs(pc, tfaults.generate_scenarios(cluster.nodes, "k=1"))
    keys, tc = int(inp.statics.node_dom.shape[0]), int(inp.statics.g_terms.shape[1])
    g_terms, topo = inp.statics.g_terms.cpu().numpy(), inp.statics.term_topo.cpu().numpy()
    group_key = np.where(g_terms >= 0, topo[np.maximum(g_terms, 0)], -1).max(axis=1)
    log_g, log_n = inp.log["g"].cpu().numpy(), inp.log["node"].cpu().numpy()
    node_key = np.full(pc.n_nodes, -1)
    np.maximum.at(node_key, log_n[log_n >= 0], group_key[log_g[log_n >= 0]])
    pick = np.sort(np.argsort(-node_key, kind="stable")[:16])
    if keys < smoke.MANY_KEYS or tc > 64 or node_key[pick].max() < 4096:
        raise AssertionError(f"phase 18: the many-keys problem has {keys} keys, Tc = {tc}, highest key on the "
                             f"picked nodes {node_key[pick].max()}")
    masks = np.zeros((16, pc.n_nodes), bool)
    masks[np.arange(16), pick] = True
    inp = tsweep.SweepInputs(pc, tfaults.ScenarioSet(masks=masks, labels=tuple(f"node:{i}" for i in pick)))
    (valid, ev_idx, rq_idx), rows, nodes, plain = compare_sweep_chunk(
        "phase 18", "many-keys problem's k=1 chunk", inp, 0, 16, err)
    st = inp.state
    width = (st.free.shape[1] + st.ports_used.shape[1] + 2 * st.vols_any.shape[1] + st.vg_free.shape[1]
             + st.sdev_free.shape[1] + st.gpu_free.shape[1])
    plan = cuda.sweep_drain_plan(16, pc.n_nodes, tc, width, torch.cuda.get_device_properties(0).multi_processor_count)
    per, _, _ = profile_kernels(
        lambda: [batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx) for _ in range(20)],
        {"sweep_drain": lambda: batched.sweep_drain(inp.statics, inp.state, inp.log, ev_idx)})
    out = {"keys": keys, "tc": tc, "nodes": pc.n_nodes, "highest_key_drained": int(node_key[pick].max()),
           "entries": int((ev_idx >= 0).sum()), "requeue_rows": rows, "replaced": int((nodes >= 0).sum()),
           "plain_s": plain, "sweep_drain_us": per["sweep_drain"][0], "ms_from": ms_from("sweep_drain")}
    plan = {"staged_bytes_a_pair": 4 * cuda.DRAIN_PAIR_WORDS, "staging": plan["staging"],
            "stage_entries": plan["stage_entries"]}
    log(f"phase 18: K18/K19 equal to their plain versions on 16 single-node scenarios of the many-keys problem "
        f"({keys} topology keys, Tc = {tc}, N={pc.n_nodes}; {out['entries']} drained entries, the highest key "
        f"{out['highest_key_drained']}; {rows} requeue rows, {out['replaced']} re-placed); K18 "
        f"{out['sweep_drain_us']:.2f} us device ({ms_from('sweep_drain')}); plan {plan}")
    return out, plan


class AuditCapture:
    """The auditor's K8 call (audit/checker.py audit_bulk), keeping the
    inputs of the last audit it ran; the launches and their counts are the
    wrapper's own."""

    def __enter__(self):
        self.fn, self.last, self.calls = checker.audit_bulk, None, 0
        checker.audit_bulk = self
        return self

    def __call__(self, x):
        self.last = x
        self.calls += 1
        return self.fn(x)

    def __exit__(self, *exc):
        checker.audit_bulk = self.fn


#: phase 18's seeded log on the bulk problem's nodes, and the prefixes K8
#: is timed on (time linear in M)
K8_BULK_LOG = 150000
K8_PREFIXES = (18750, 37500, 75000, 150000)


def bulk_audit_logs(pc, device) -> dict:
    """Phase 18 (b)'s logs on the bulk problem's nodes (its place_cluster,
    phase 9): K8_BULK_LOG entries of the batch's own pods (groups, requests,
    pins), in a seeded order on seeded nodes; the same entries all on one
    node; half of them on one node. {label: AuditInputs} on the card."""
    rng = np.random.default_rng(18)
    t, b = pc.tensors, pc.batch
    rows = rng.permutation(len(b.group))[:K8_BULK_LOG]
    if len(rows) < K8_BULK_LOG:
        rows = rng.choice(len(b.group), K8_BULK_LOG)
    nodes = rng.integers(0, t.n_nodes, K8_BULK_LOG)
    r, m = t.alloc.shape[1], K8_BULK_LOG
    v, sd, gd = t.ext.vg_cap.shape[1], t.ext.sdev_cap.shape[1], t.ext.gpu_dev_total.shape[1]
    base = checker._Entries(g=np.asarray(b.group, np.int64)[rows], n=nodes.astype(np.int64),
                            req=checker._pad_req(np.asarray(b.req, np.float64)[rows], r),
                            forced=np.asarray(b.forced, bool)[rows], pin=np.asarray(b.pin, np.int64)[rows],
                            lvm=np.zeros((m, v)), sdev=np.zeros((m, sd), bool), gpu=np.zeros((m, gd)),
                            rows=rows)
    half = nodes.copy()
    half[rng.permutation(m)[: m // 2]] = 7
    nv = np.ones(t.n_nodes, bool)
    return {label: checker._upload(t, dataclasses.replace(base, n=n.astype(np.int64)), nv, device)
            for label, n in (("seeded", nodes), ("one node", np.full(m, 7)), ("half on one node", half))}


def audit_prefix(x, m: int):
    """The first m entries of AuditInputs `x`."""
    per_entry = ("g", "n", "req", "forced", "pin", "lvm", "sdev", "gpu")
    return type(x)(**{f: (getattr(x, f)[:m].contiguous() if f in per_entry else getattr(x, f)) for f in x._fields})


def audit_window(x, calls: int = 10, tries: int = 3) -> dict:
    """K8's device time on AuditInputs `x` from `calls` launches in one
    profiler window, and the kernels a launch the window saw, held against
    cuda.audit_plan's count. The trace has come back without some of a
    window's K8 launches, whole or in part (two or three of ten, at random),
    so each part's multiplicity is read as its events over the launches of
    the once-a-launch part (MULTI_KERNEL), rounded: a kernel the plan has
    and a launch lacks reads 0, a pass more reads one part more. Returns
    us per launch (each part's mean over the launches it was seen in, times
    its multiplicity, summed), each part's us per launch, and the kernels
    per launch (the multiplicities' sum). A window with fewer than half its
    launches, or whose count differs, is profiled again, up to `tries`
    windows; a count that differs in every window fails the phase, naming
    each window's events per part. With no events in any window, the time
    is from CUDA events and the kernels not measured."""
    plan = cuda.audit_plan(x.alloc.shape[0], x.g.shape[0], 0)
    seen = []
    for _ in range(tries):
        events, _ = window_events(lambda: [kaudit.audit_bulk(x) for _ in range(calls)])
        parts = {part: (us, count) for name, part, us, count in events if name == "audit_bulk"}
        launches = parts.get(MULTI_KERNEL["audit_bulk"], (0.0, 0))[1]
        if 2 * launches < calls:
            continue
        mult = {part: round(count / launches) for part, (_, count) in parts.items()}
        kernels = sum(mult.values())
        if kernels == plan["kernels"]:
            per_launch = {p: us / count * mult[p] for p, (us, count) in parts.items() if mult[p]}
            return {"device_us": sum(per_launch.values()), "ms_from": "profiler", "kernels_per_launch": kernels,
                    "parts_us": per_launch, "launches_seen": launches}
        seen.append((kernels, {part: count for part, (_, count) in parts.items()}))
        log(f"  audit_bulk: a profiler window saw {kernels} kernels a launch (plan {plan['kernels']}) over {launches} "
            f"of {calls} launches: {seen[-1][1]}")
    if seen:
        raise AssertionError(f"K8 on M={x.g.shape[0]}, N={x.alloc.shape[0]}: the profiler saw {seen} kernels a "
                             f"launch, its plan {plan['kernels']}")
    PROFILER_MISSED.add("audit_bulk")
    log("  audit_bulk: device time from CUDA events around back-to-back launches")
    return {"device_us": time_call(lambda: kaudit.audit_bulk(x), 20) * 1e3, "ms_from": "cuda events",
            "kernels_per_launch": None, "parts_us": {}}


def phase_audit_logs(logs: dict) -> tuple:
    """Phase 18 (b): K8 against its plain version on each log of `logs`
    ({label: AuditInputs}), the flag words equal; then each one's device
    time and kernels a launch (audit_window), bound, the plain version's
    time, and the seeded log's prefixes (time linear in M). Returns the
    measurements and each log's launch plan."""
    out, plans = {}, {}
    for label, x in logs.items():
        got, want = kaudit.audit_bulk(x), kaudit.audit_bulk_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"phase 18: K8 on the {label} log: {int((got != want).sum())} flag words differ "
                                 "from the plain version")
        n, m = x.alloc.shape[0], x.g.shape[0]
        plans[label] = {k: v for k, v in cuda.audit_plan(n, m, 0).items() if k not in ("offsets", "s", "words")}
        nbytes = audit_bytes(x)
        row = out[label] = {"n": n, "m": m, "flagged": int((want != 0).sum()), **audit_window(x),
                            "plain_ms": time_call(lambda: kaudit.audit_bulk_plain(x), 3), "bytes": nbytes,
                            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}
        log(f"phase 18: K8 equal to its plain version on the {label} log (M={m}, N={n}, {row['flagged']} "
            f"flagged): {row['device_us']:.2f} us device over {row['kernels_per_launch']} kernels a launch "
            f"({row['ms_from']}; plan {plans[label]['kernels']}), bound {row['bound_us']:.3f} us, plain "
            f"{row['plain_ms']:.3f} ms; parts " + ", ".join(f"{k} {v:.2f}" for k, v in row["parts_us"].items()))
    if "seeded" in logs:
        x = logs["seeded"]
        prefixes = {str(m): audit_window(audit_prefix(x, m))["device_us"] for m in K8_PREFIXES}
        out["seeded"]["prefixes_us"] = prefixes
        log("phase 18: K8 on the seeded log's prefixes (M: device us) " + ", ".join(
            f"{k}: {v:.2f}" for k, v in prefixes.items()))
    return out, plans


#: phase 18's K3 widths, and the pods sampled per case
K3_WIDTHS = (120, 943, 1000, 2000, 3001, 5000, 9000)
K3_SAMPLE = 12


#: k3_cases' cases by N, built once for phases 18 and 19 (their states are
#: cloned before use)
K3_CASES = {}


def k3_cases(device, n: int) -> dict:
    """Phase 18 (c)'s cases at N nodes: the serial smoke mix; the same with
    custom score weights; with pods forced (some pinned to a node, some to
    no node); the extended mix (storage and GPU pods). {label: (statics,
    state, pods, flags, sample)}."""
    if n not in K3_CASES:
        K3_CASES[n] = _k3_cases(device, n)
    return K3_CASES[n]


def _k3_cases(device, n: int) -> dict:
    rng = np.random.default_rng(n)
    t, b, s, st, pods = tensorized_batch(*smoke.smoke_problem(synth_cluster, synth_apps, n_nodes=n, n_pods=400),
                                         device, 3 * n)
    f = scan.flags_from(t, b.ext)
    sample = np.sort(rng.choice(len(pods[0]), K3_SAMPLE, replace=False))
    weights = torch.as_tensor(np.array([1.3, 0.7, 2.1, 0.9, 1.7, 3.3, 0.45, 2.6, 1.15, 0.8, 1.9, 1.05], np.float32),
                              device=device)
    forced = [np.array(x, copy=True) for x in pods]
    forced[3][sample[::2]] = True
    forced[2][sample[::4]] = rng.integers(0, n, len(sample[::4]))
    forced[2][sample[2::4]] = -2
    xt, xb, xs, xst, xpods = tensorized_batch(*smoke.extended_problem(
        synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes, n_nodes=n, n_pods=600), device, 3 * n)
    probe = scan.StepBuffers(xs, xst, xpods, scan.flags_from(xt, xb.ext))
    ext_rows = np.flatnonzero(probe.storage_live | probe.gpu_live)
    x_sample = np.sort(np.concatenate([rng.choice(ext_rows, K3_SAMPLE // 2, replace=False),
                                       rng.choice(len(xpods[0]), K3_SAMPLE // 2, replace=False)]))
    return {"serial": (s, st, pods, f, sample),
            "custom weights": (s._replace(score_w=weights), st, pods, f, sample),
            "forced": (s, st, tuple(forced), f, sample),
            "extended": (xs, xst, xpods, scan.flags_from(xt, xb.ext), np.unique(x_sample))}


def compare_k3(label: str, statics, state, pods, flags, sample, err) -> tuple:
    """K3 against score_argmax_pod_plain on each pod of `sample` after the
    kernels K1 (K5, K6) and K2 on the same state: the score row bit for bit
    and chosen, placed, reason and out_node equal. Returns the buffers."""
    buf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    fields = ("chosen", "placed", "reason", "out_node")
    for i in map(int, sample):
        scan.filter_pod(buf, i)
        if buf.storage_live[i]:
            scan.storage_pod(buf, i)
        if buf.gpu_live[i]:
            scan.gpu_pod(buf, i)
        scan.topology_pod(buf, i)
        scan.score_argmax_pod_plain(buf, i)
        want = buf.score.clone(), [getattr(buf, f)[i].clone() for f in fields]
        buf.score.fill_(float("nan"))
        scan.score_argmax_pod(buf, i)
        torch.cuda.synchronize()
        if not torch.equal(buf.score.view(torch.int32), want[0].view(torch.int32)):
            bad = int((buf.score.view(torch.int32) != want[0].view(torch.int32)).sum())
            raise AssertionError(f"phase 18: K3 ({label}, N={buf.ctx.n}) pod {i}: {bad} scores differ bitwise")
        for f, w in zip(fields, want[1]):
            if getattr(buf, f)[i] != w:
                raise AssertionError(f"phase 18: K3 ({label}, N={buf.ctx.n}) pod {i}: {f} differs")
        err["score_argmax_pod"] = max(err["score_argmax_pod"], score_diff(buf.score, want[0]))
    return buf


def launch_score_with(buf, i: int, npt: int) -> None:
    """K3 for pod i of `buf` on the template `npt` (1: registers, 0:
    global) instead of its plan's: a measurement launch, not counted."""
    threads = cuda.score_plan(buf.ctx.n)["threads"]
    err = cuda.build()["score_argmax_pod"].simtpu_score_argmax_pod(
        ctypes.byref(buf.ctx), i, ctypes.byref(cuda.ScorePlan(threads=threads, npt=npt)),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 on template {npt} failed to launch ({err})")


def phase_k3_widths(device, err) -> tuple:
    """Phase 18 (c): K3 at N = 120 ... 9000 (one node a thread in registers
    up to 1024 nodes, the global path above) on each case of k3_cases,
    equal to its plain version; then its device time per launch (profiler)
    at each N on a serial pod, the plain version's and the bound; up to
    1024 nodes the global path too, equal to the register path's and timed
    against it in turns (the sweep behind `cuda.score_plan`). Returns the
    measurements and each N's plan."""
    out, plans = {}, {}
    for n in K3_WIDTHS:
        plan = plans[str(n)] = cuda.score_plan(n)
        row = {}
        timed = None
        for label, (s, st, pods, f, sample) in k3_cases(device, n).items():
            buf = compare_k3(label, s, st, pods, f, sample, err)
            row[label] = len(sample)
            if label == "serial":
                timed = (buf, int(sample[-1]))
        buf, i = timed
        per, _, _ = profile_kernels(lambda: [scan.score_argmax_pod(buf, i) for _ in range(50)],
                                    {"score_argmax_pod": lambda: scan.score_argmax_pod(buf, i)})
        nbytes = kernel_bytes(buf, i)["score_argmax_pod"]
        row.update(device_us=per["score_argmax_pod"][0], ms_from=ms_from("score_argmax_pod"),
                   plain_ms=time_call(lambda: scan.score_argmax_pod_plain(buf, i), 10), bytes=nbytes,
                   bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
        if plan["npt"]:
            want = buf.score.clone()
            buf.score.fill_(float("nan"))
            launch_score_with(buf, i, 0)
            torch.cuda.synchronize()
            if not torch.equal(buf.score.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"phase 18: K3's global path at N={n} differs from its register path")
            launchers = {"registers": lambda _: launch_score_with(buf, i, plan["npt"]),
                         "global": lambda _: launch_score_with(buf, i, 0)}
            row["sweep_us"] = {k: v * 1e3 for k, v in in_turns(launchers, lambda: None, 10).items()}
        out[str(n)] = row
        log(f"phase 18: K3 equal to its plain version at N={n} (plan: template {plan['template']}, "
            f"{plan['threads']} threads) on the serial, custom-weights, forced and extended cases "
            f"({K3_SAMPLE} pods each): {row['device_us']:.2f} us device ({row['ms_from']}), bound "
            f"{row['bound_us']:.4f} us, plain {row['plain_ms']:.3f} ms"
            + (f"; paths (us, CUDA events in turns) {row['sweep_us']}" if "sweep_us" in row else ""))
    return out, plans



# -- phase 19: K2 and K4 at N = 120 ... 9000 and at Tc = 512 and 1024 -----------

#: the plans K2 is held at and timed at (the sweeps behind
#: cuda.TOPO_SMALL_NODES and cuda.TOPO_NODES_PER_BLOCK): up to
#: TOPO_THREADS nodes plain launches of K2_PLAIN_BLOCKS blocks; past that
#: clusters of K2_CLUSTER_BLOCKS blocks, and for the comparison plain
#: launches of K2_WIDE_PLAIN blocks, each block taking every node's minima
K2_PLAIN_BLOCKS = (1, 2, 3, 4, 6, 8)
K2_CLUSTER_BLOCKS = (2, 4, 8, 12, 16)
K2_WIDE_PLAIN = (8, 16, 32)
K2_SWEEP_NODES = (1000, 2000, 3001, 5000, 9000)


def k2_plans(n: int) -> tuple:
    """(blocks, shared budget, cluster) of K2's swept plans at N nodes."""
    if n <= cuda.TOPO_THREADS:
        return tuple((b, None, False) for b in K2_PLAIN_BLOCKS)
    return tuple((b, None, True) for b in K2_CLUSTER_BLOCKS) + tuple((b, None, False) for b in K2_WIDE_PLAIN)


def bits_equal(a, b) -> bool:
    """Equal bit for bit (float planes compared as their int32 bits)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def launch_topology_with(buf, i: int, blocks: int = None, budget: int = None, cluster: bool = None) -> None:
    """K2 for pod i of `buf` on `topology_plan`'s plan of `blocks` blocks,
    a shared `budget` (0: every scratch segment in the slab) and a
    `cluster` launch or not: a measurement launch, not counted."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    plan = cuda.topology_plan_struct(buf, blocks, budget, cluster)
    err = cuda.build()["topology_pod"].simtpu_topology_pod(ctypes.byref(buf.ctx), buf.group_host[i],
                                                           ctypes.byref(plan), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K2 on {blocks} block(s), budget {budget}, failed to launch ({err})")


def compare_k2_k4(label: str, statics, state, pods, flags, sample, plans=((None, None, None),)) -> tuple:
    """Phase 19: K2 and K4 against their plain versions, pod by pod along
    `sample` on one state advanced by the kernels: K1 (K5, K6) on the card,
    then K2 on each of `plans` ((blocks, shared budget, cluster launch);
    all None: the wrapper's own plan) and its plain version from the same
    stage bytes —
    the stage bytes and the four raw rows bit for bit; K3 on the card; then
    K4 and its plain version from the same state — every state plane and
    the pod's output rows bit for bit. Returns the buffers and the placed
    pods of the sample."""
    buf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    outs = ("out_lvm", "out_take", "out_gpu")
    placed = 0
    for i in map(int, sample):
        scan.filter_pod(buf, i)
        if buf.storage_live[i]:
            scan.storage_pod(buf, i)
        if buf.gpu_live[i]:
            scan.gpu_pod(buf, i)
        stage0 = buf.stage.clone()
        scan.topology_pod_plain(buf, i)
        want = buf.stage.clone(), buf.raw.clone()
        for blocks, budget, cluster in plans:
            buf.stage.copy_(stage0)
            buf.raw.fill_(float("nan"))
            if blocks is None and budget is None and cluster is None:
                scan.topology_pod(buf, i)
            else:
                launch_topology_with(buf, i, blocks, budget, cluster)
            torch.cuda.synchronize()
            if not (torch.equal(buf.stage, want[0]) and bits_equal(buf.raw, want[1])):
                bad = int((buf.raw.view(torch.int32) != want[1].view(torch.int32)).sum())
                raise AssertionError(f"phase 19: K2 ({label}, N={buf.ctx.n}, Tc={buf.ctx.tc}, blocks {blocks}, "
                                     f"budget {budget}, cluster {cluster}) pod {i}: stage bytes equal "
                                     f"{torch.equal(buf.stage, want[0])}, {bad} raw words differ")
        scan.score_argmax_pod(buf, i)
        before = clone_state(buf.state), [getattr(buf, f)[i].clone() for f in outs]
        scan.commit_pod_plain(buf, i)
        want = clone_state(buf.state), [getattr(buf, f)[i].clone() for f in outs]
        copy_state(buf.state, before[0])
        for f, v in zip(outs, before[1]):
            getattr(buf, f)[i] = v
        scan.commit_pod(buf, i)
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(buf.state, want[0])):
            if not bits_equal(a, b):
                raise AssertionError(f"phase 19: K4 ({label}, N={buf.ctx.n}, Tc={buf.ctx.tc}) pod {i}: state "
                                     f"plane {type(buf.state)._fields[k]} differs")
        for f, w in zip(outs, want[1]):
            if not bits_equal(getattr(buf, f)[i], w):
                raise AssertionError(f"phase 19: K4 ({label}, N={buf.ctx.n}) pod {i}: {f} differs")
        placed += int(buf.placed[i])
    return buf, placed


def time_k2_k4(buf, i: int) -> dict:
    """K2's and K4's device µs per launch (profiler) at pod i of `buf`, the
    host's µs per back-to-back launch (CUDA events around 2000 launches
    from Python), their plain versions' ms and their bounds (bytes)."""
    row = {}
    nbytes = kernel_bytes(buf, i)
    for name, fn in (("topology_pod", scan.topology_pod), ("commit_pod", scan.commit_pod)):
        per, _, _ = profile_kernels(lambda: [fn(buf, i) for _ in range(50)], {name: lambda: fn(buf, i)})
        row[name] = {"device_us": per[name][0], "ms_from": ms_from(name),
                     "host_us": time_call(lambda: fn(buf, i), 2000) * 1e3,
                     "plain_ms": time_call(lambda: WRAPPERS[name][1](buf, i), 10),
                     "bytes": nbytes[name], "bound_us": nbytes[name] / HBM_BYTES_PER_S * 1e6}
    return row


def k2_sweep(buf, sample) -> dict:
    """K2's device µs per launch (profiler) on each of k2_plans(N), at the
    first pod of `sample` with a hard-spread column and the first without
    (K1 for the pod first: K2 reads its stage bytes)."""
    out = {}
    st = buf.statics
    for i in map(int, sample):
        hard = bool((st.spread_hard[buf.group_host[i]] > 0).any()) and buf.flags.spread_hard
        key = "hard" if hard else "no_hard"
        if key in out:
            continue
        scan.filter_pod(buf, i)
        row = {"pod": i}
        lib = cuda.build()["topology_pod"].simtpu_topology_pod
        stream = torch.cuda.current_stream().cuda_stream
        for blocks, _, cluster in k2_plans(buf.ctx.n):
            label = f"{'cluster' if cluster else 'plain'} {blocks}"
            # the plan built once, so a window timed by CUDA events holds
            # the kernels and not the plan's construction on the host
            plan = cuda.topology_plan_struct(buf, blocks, None, cluster)
            call = (lambda p_: lambda: lib(ctypes.byref(buf.ctx), buf.group_host[i], ctypes.byref(p_), stream))(plan)
            if call():
                raise RuntimeError(f"phase 19: K2 on {label} blocks failed to launch")
            per, _, _ = profile_kernels(lambda: [call() for _ in range(50)], {"topology_pod": call})
            row[label] = per["topology_pod"][0]
        out[key] = row
    return out


def phase_k2_k4(device) -> tuple:
    """Phase 19: K2 and K4 against their plain versions bit for bit on phase
    18's cases (k3_cases) at N = 120 ... 9000 (K2 on the wrapper's plan and
    on every plan of k2_plans(N)), and on the terms problem at Tc = 512 and
    1024 (K2 also on plans whose scratch lives wholly in the slab: one
    block, a cluster, a plain launch of four blocks); then at each N on a
    serial pod K2's and K4's device time, host time per launch, plain time
    and bound, and at K2_SWEEP_NODES K2's device time on each plan of its
    sweep, on a pod with a hard-spread column and one without. Returns the
    measurements and each N's plan."""
    out, plans = {}, {}
    for n in K3_WIDTHS:
        plan = plans[str(n)] = cuda.topology_plan(n, 4)
        sizes = ((None, None, None),) + k2_plans(n)
        row = {"pods": {}}
        timed = None
        for label, (s, st, pods, f, sample) in k3_cases(device, n).items():
            buf, placed = compare_k2_k4(label, s, st, pods, f, sample, sizes)
            row["pods"][label] = [len(sample), placed]
            if label == "serial":
                timed = buf, sample
        buf, sample = timed
        row.update(time_k2_k4(buf, int(sample[-1])))
        if n in K2_SWEEP_NODES:
            row["sweep_us"] = k2_sweep(buf, sample)
        out[str(n)] = row
        log(f"phase 19: K2 and K4 equal to their plain versions at N={n} (K2's plan: {plan['blocks']} block(s) of "
            f"{plan['threads']} threads, {plan['launch']} launch; and on {k2_plans(n)}) on the serial, "
            f"custom-weights, forced and extended cases (pods, placed: {row['pods']}): K2 "
            f"{row['topology_pod']['device_us']:.2f} us device ({row['topology_pod']['ms_from']}), "
            f"{row['topology_pod']['host_us']:.2f} us host a launch, bound {row['topology_pod']['bound_us']:.4f} us, "
            f"plain {row['topology_pod']['plain_ms']:.3f} ms; K4 {row['commit_pod']['device_us']:.2f} us device, "
            f"{row['commit_pod']['host_us']:.2f} us host, bound {row['commit_pod']['bound_us']:.4f} us, plain "
            f"{row['commit_pod']['plain_ms']:.3f} ms"
            + (f"; K2 by plan (device us, profiler) {row['sweep_us']}" if "sweep_us" in row else ""))
    rng = np.random.default_rng(19)
    for terms, tc in TERMS_CASES:
        t, b, s, st, p = tensorized_batch(*terms_cluster(terms), device, 2000)
        if s.g_terms.shape[1] != tc:
            raise AssertionError(f"phase 19: the terms problem has Tc = {s.g_terms.shape[1]}, want {tc}")
        sample = np.sort(rng.choice(len(p[0]), K3_SAMPLE, replace=False))
        sizes = ((None, None, None), (1, 0, None), (4, 0, True), (4, None, True), (4, 0, False), (1, None, False))
        buf, placed = compare_k2_k4(f"Tc={tc} terms problem", s, st, p, scan.flags_from(t, b.ext), sample, sizes)
        plan = cuda.topology_plan(int(t.n_nodes), tc)
        timed = time_k2_k4(buf, int(sample[-1]))
        out[f"tc{tc}"] = {"pods": [len(sample), placed], "plan_mode": plan["mode"], **timed}
        log(f"phase 19: K2 and K4 equal to their plain versions on {len(sample)} pods ({placed} placed) of the "
            f"Tc={tc} terms problem (K2's plan in {plan['mode']} memory, and with every segment in the slab on "
            f"one block, a cluster of 4 and a plain launch of 4, and on a cluster of 4 and one block): K2 "
            f"{timed['topology_pod']['device_us']:.2f} us, K4 "
            f"{timed['commit_pod']['device_us']:.2f} us device")
    return out, plans

# -- phase 20: K1 and K5 at N = 120 ... 9000, on edge states and the wide problem --

#: the node counts, and the plans K1 and K5 are held at and timed at (the
#: sweeps behind cuda.FILTER_THREADS and cuda.STORAGE_THREADS and K5's
#: templates)
K1K5_WIDTHS = (120, 1000, 2000, 5000, 9000)
FILTER_SWEEP = (32, 64, 128, 256, 512)
STORAGE_SWEEP = (32, 64, 128, 256)
#: K5's sweep of templates and threads is timed at these node counts
STORAGE_SWEEP_NODES = (1000, 5000)
#: the group-row widths (P, W, C) of the edge states: within K1's register
#: template, and past it
EDGE_WIDTHS = ((2, 3, 2), (12, 12, 12))
#: launches of each variant in a turns window, after TURNS_LEAD turns
#: that are not read (a window's trace can drop its first launches)
TURNS_REPS = 30
TURNS_LEAD = 5
#: storage pods of the extended mix K5 is held at per N, beside the case's
K5_SAMPLE = 8


def edge_state(statics, state, widths, seed: int):
    """`statics`/`state` with seeded ports, volume and attach rows of widths
    (P, W, C) — the group's ports_req, vol_rw/ro/att_req and the class mask,
    the nodes' ports_used, vols_any, vols_rw and attach limits — and a
    volume-binding mask that fails one node in five: with every flag on,
    each of K1's stages fails first somewhere."""
    p, w, c = widths
    rng = np.random.default_rng(seed)
    g, n = statics.static_mask.shape
    dev = statics.alloc.device

    def t(x):
        return torch.as_tensor(x, device=dev).contiguous()

    s = statics._replace(ports_req=t(rng.random((g, p)) < 0.2), vol_rw_req=t(rng.random((g, w)) < 0.15),
                         vol_ro_req=t(rng.random((g, w)) < 0.15), vol_att_req=t(rng.random((g, w)) < 0.3),
                         vol_class_mask=t(rng.random((c, w)) < 0.4),
                         attach_limits=t(rng.integers(0, 4, (n, c)).astype(np.float32)),
                         vol_mask=t(rng.random((g, n)) < 0.8))
    st = state._replace(ports_used=t((rng.random((n, p)) < 0.1).astype(np.float32)),
                        vols_any=t((rng.random((n, w)) < 0.2).astype(np.float32)),
                        vols_rw=t((rng.random((n, w)) < 0.1).astype(np.float32)))
    return s, st


def tight_state(state, seed: int):
    """`state` with each VG's free space cut to a seeded fraction and half
    the exclusive devices taken: K5's claims fail on many nodes."""
    rng = np.random.default_rng(seed)
    dev = state.vg_free.device
    return state._replace(
        vg_free=(state.vg_free * torch.as_tensor(rng.random(tuple(state.vg_free.shape)), dtype=torch.float32,
                                                 device=dev)).contiguous(),
        sdev_free=torch.as_tensor(rng.random(tuple(state.sdev_free.shape)) < 0.5, device=dev).contiguous())


def launch_filter_with(buf, i: int, threads: int) -> None:
    """K1 for pod i of `buf` on `filter_plan`'s plan of `threads` threads: a
    measurement launch, not counted."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    plan = cuda.filter_plan_struct(buf, threads)
    err = cuda.build()["filter_pod"].simtpu_filter_pod(ctypes.byref(buf.ctx), i, buf.group_host[i], buf.pin_host[i],
                                                       ctypes.byref(plan), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 on {threads} threads failed to launch ({err})")


def launch_storage_with(buf, i: int, threads: int, template: int) -> None:
    """K5 for pod i of `buf` on `storage_plan`'s plan of `threads` threads
    and template `template`: a measurement launch, not counted."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    plan = cuda.storage_plan_struct(buf, threads, template)
    err = cuda.build()["storage_pod"].simtpu_storage_pod(ctypes.byref(buf.ctx), i, ctypes.byref(plan),
                                                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 on {threads} threads, template {template}, failed to launch ({err})")


def storage_templates(buf) -> tuple:
    """K5's templates that hold `buf`'s widths: the register template where
    max(V, SD) fits it, shared and global."""
    regs = (cuda.STORAGE_REG,) if max(buf.ctx.v, buf.ctx.sd) <= cuda.STORAGE_REG else ()
    return regs + (cuda.STORAGE_SHARED, cuda.STORAGE_GLOBAL)


def storage_shared_fits(buf, threads: int) -> bool:
    x = buf.ctx
    plan = cuda.storage_plan(x.n, x.v, x.sd, x.l, x.k, threads, cuda.STORAGE_SHARED)
    return plan["smem"] <= cuda.WAVE_SMEM


def compare_k1(label: str, buf, sample) -> dict:
    """Phase 20: K1 against filter_pod_plain on each pod of `sample` (pod by
    pod on one state), on the wrapper's plan and on every plan of
    FILTER_SWEEP: the stage bytes equal. Returns the stage bytes seen."""
    seen = set()
    for i in map(int, sample):
        scan.filter_pod_plain(buf, i)
        want = buf.stage.clone()
        seen |= set(want.unique().tolist())
        for threads in (None,) + FILTER_SWEEP:
            buf.stage.fill_(0xAA)
            if threads is None:
                scan.filter_pod(buf, i)
            else:
                launch_filter_with(buf, i, threads)
            torch.cuda.synchronize()
            if not torch.equal(buf.stage, want):
                bad = int((buf.stage != want).sum())
                raise AssertionError(f"phase 20: K1 ({label}, N={buf.ctx.n}, P={buf.ctx.p_ports}, W={buf.ctx.w}, "
                                     f"C={buf.ctx.c}, threads {threads}) pod {i}: {bad} stage bytes differ")
    return {"pods": len(sample), "stage_bytes": sorted(seen), "plan": cuda.filter_plan(
        buf.ctx.n, buf.ctx.r, buf.ctx.p_ports, buf.ctx.w, buf.ctx.c, buf.ctx.flags)["template"]}


def compare_k5(label: str, buf, sample) -> dict:
    """Phase 20: K5 against storage_pod_plain on each storage pod of
    `sample`, on the wrapper's plan and on every (threads, template) of
    STORAGE_SWEEP x storage_templates: st_ok, st_alloc, st_take and st_raw
    bit for bit. Returns the pods and the nodes whose plans fit."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    fields = ("st_ok", "st_alloc", "st_take", "st_raw")
    pods = [int(i) for i in sample if buf.storage_live[int(i)]]
    fit = 0
    for i in pods:
        scan.storage_pod_plain(buf, i)
        want = [getattr(buf, f).clone() for f in fields]
        fit += int(want[0].sum())
        plans = [(None, None)] + [(t, m) for t in STORAGE_SWEEP for m in storage_templates(buf)
                                  if m != cuda.STORAGE_SHARED or storage_shared_fits(buf, t)]
        for threads, template in plans:
            buf.st_ok.fill_(True)
            buf.st_take.fill_(True)
            buf.st_alloc.fill_(float("nan"))
            buf.st_raw.fill_(float("nan"))
            if threads is None:
                scan.storage_pod(buf, i)
            else:
                launch_storage_with(buf, i, threads, template)
            torch.cuda.synchronize()
            for f, w in zip(fields, want):
                if not bits_equal(getattr(buf, f), w):
                    raise AssertionError(f"phase 20: K5 ({label}, N={buf.ctx.n}, V={buf.ctx.v}, SD={buf.ctx.sd}, "
                                         f"threads {threads}, template {template}) pod {i}: {f} differs")
    x = buf.ctx
    return {"pods": len(pods), "nodes_fit": fit,
            "plan": cuda.storage_plan(x.n, x.v, x.sd, x.l, x.k)["template"]}


def turns_window(variants: dict, kernel: str, reps: int = TURNS_REPS):
    """Device µs per launch of each of `variants` ({label: fn launching one
    `kernel` kernel}) in one profiler window, the variants launched in turns
    (a, b, c, a, b, c, ...) TURNS_LEAD + `reps` times and the window's last
    `reps` turns of kernel events read in launch order: the median per
    variant. None where the window lost more than the lead's events (then
    the caller times in turns by CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = list(variants)
    for fn in variants.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        cuda.launch_noop(torch.device("cuda"))
        torch.cuda.synchronize()
        time.sleep(PROFILER_LEAD_S)
        for _ in range(TURNS_LEAD + reps):
            for k in labels:
                variants[k]()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel_of(e.name) == kernel),
                 key=lambda e: e.time_range.start)
    # a call of several kernels (MULTI_KERNEL; K13's begins with the part
    # named there, as its parent's one kernel does) is the sum of its parts
    calls = []
    for e in evs:
        if not calls or kernel not in MULTI_KERNEL or part_of(e.name) == MULTI_KERNEL[kernel]:
            calls.append(0.0)
        calls[-1] += e.time_range.elapsed_us()
    if len(calls) < reps * len(labels):
        return None
    calls = calls[len(calls) - reps * len(labels):]
    got = {k: [] for k in labels}
    for j, us in enumerate(calls):
        got[labels[j % len(labels)]].append(us)
    return {k: float(np.median(v)) for k, v in got.items()}


def sweep_us(variants: dict, kernel: str) -> tuple:
    """turns_window's medians (a window that lost events taken again once),
    or CUDA events in turns where both lost an event; and which of the
    two."""
    for _ in range(2):
        got = turns_window(variants, kernel)
        if got is not None:
            return got, "profiler"
    return {k: v * 1e3 for k, v in in_turns({k: (lambda f: lambda _: f())(f) for k, f in variants.items()},
                                            lambda: None, 10).items()}, "cuda events"


def time_k1_k5(name: str, buf, i: int) -> dict:
    """K1's or K5's device µs per launch (profiler) at pod i of `buf`, the
    host's µs per back-to-back launch (CUDA events around 2000 launches
    from Python), the plain version's ms and the bound (bytes)."""
    fn, plain = WRAPPERS[name]
    nbytes = kernel_bytes(buf, i)[name]
    per, _, _ = profile_kernels(lambda: [fn(buf, i) for _ in range(50)], {name: lambda: fn(buf, i)})
    return {"pod": i, "device_us": per[name][0], "ms_from": ms_from(name),
            "host_us": time_call(lambda: fn(buf, i), 2000) * 1e3, "plain_ms": time_call(lambda: plain(buf, i), 10),
            "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}


def k1_sweep(buf, i: int) -> dict:
    """K1's device µs per launch on each plan of FILTER_SWEEP at pod i."""
    got, how = sweep_us({str(t): (lambda t_: lambda: launch_filter_with(buf, i, t_))(t) for t in FILTER_SWEEP},
                        "filter_pod")
    return {"us": got, "from": how}


def k5_sweep(buf, i: int) -> dict:
    """K5's device µs per launch on each (threads, template) of STORAGE_SWEEP
    x storage_templates at pod i."""
    variants = {f"{t} x {m}": (lambda t_, m_: lambda: launch_storage_with(buf, i, t_, m_))(t, m)
                for t in STORAGE_SWEEP for m in storage_templates(buf)
                if m != cuda.STORAGE_SHARED or storage_shared_fits(buf, t)}
    got, how = sweep_us(variants, "storage_pod")
    return {"us": got, "from": how}


def phase_k1_k5(device) -> tuple:
    """Phase 20: K1 and K5 against their plain versions bit for bit — K1 on
    phase 18's serial and forced cases (pods pinned to a node, to no node,
    forced) and on two edge states of the serial case (edge_state: every
    flag on, ports / volume / attach rows within and past the register
    template), K1 and K5 on the extended case and on its tight state, at N
    = 120 ... 9000; K1 on the edge batch and its edge state; K5 on the wide
    problem (V = SD = 36) — each on the wrapper's plan and on every plan of
    its sweep; then at each N K1's and K5's device time, host time per
    launch, plain time and bound, K1's sweep at each N and K5's at
    STORAGE_SWEEP_NODES and on the wide problem. Returns the measurements
    and the plans."""
    out, plans = {}, {"filter_plan": {}, "storage_plan": {}}
    rng = np.random.default_rng(20)
    for n in K1K5_WIDTHS:
        cases = k3_cases(device, n)
        row = {"compare": {}}
        s, st, pods, f, sample = cases["serial"]
        sbuf = scan.StepBuffers(s, clone_state(st), pods, f)
        row["compare"]["serial"] = compare_k1("serial", sbuf, sample)
        fs, fst, fpods, ff, fsample = cases["forced"]
        row["compare"]["forced"] = compare_k1("forced", scan.StepBuffers(fs, clone_state(fst), fpods, ff), fsample)
        for widths in EDGE_WIDTHS:
            es, est = edge_state(s, st, widths, n + sum(widths))
            label = "edge P{} W{} C{}".format(*widths)
            row["compare"][label] = compare_k1(label, scan.StepBuffers(es, est, pods, scan.StepFlags()), sample)
        xs, xst, xpods, xf, xsample = cases["extended"]
        xbuf = scan.StepBuffers(xs, clone_state(xst), xpods, xf)
        row["compare"]["extended"] = compare_k1("extended", xbuf, xsample)
        # the case's storage pods and K5_SAMPLE more of the mix's
        live = np.flatnonzero(xbuf.storage_live)
        k5_sample = np.union1d(xsample, rng.choice(live, min(K5_SAMPLE, len(live)), replace=False))
        row["compare"]["extended_k5"] = compare_k5("extended", xbuf, k5_sample)
        tbuf = scan.StepBuffers(xs, tight_state(xst, n), xpods, xf)
        row["compare"]["extended_tight_k5"] = compare_k5("extended, tight state", tbuf, k5_sample)
        i = int(sample[-1])
        row["filter_pod"] = time_k1_k5("filter_pod", sbuf, i)
        row["filter_pod"]["sweep"] = k1_sweep(sbuf, i)
        si = next(int(j) for j in xsample if xbuf.storage_live[int(j)])
        row["storage_pod"] = time_k1_k5("storage_pod", xbuf, si)
        if n in STORAGE_SWEEP_NODES:
            row["storage_pod"]["sweep"] = k5_sweep(xbuf, si)
        x = sbuf.ctx
        plans["filter_plan"][str(n)] = cuda.filter_plan(x.n, x.r, x.p_ports, x.w, x.c, x.flags)
        x = xbuf.ctx
        plans["storage_plan"][str(n)] = cuda.storage_plan(x.n, x.v, x.sd, x.l, x.k)
        out[str(n)] = row
        log(f"phase 20: K1 and K5 equal to their plain versions at N={n} on every plan of their sweeps "
            f"({json.dumps(row['compare'])}): K1 {row['filter_pod']['device_us']:.2f} us device "
            f"({row['filter_pod']['ms_from']}), {row['filter_pod']['host_us']:.2f} us host a launch, bound "
            f"{row['filter_pod']['bound_us']:.4f} us, plain {row['filter_pod']['plain_ms']:.3f} ms; K5 "
            f"{row['storage_pod']['device_us']:.2f} us device, {row['storage_pod']['host_us']:.2f} us host, bound "
            f"{row['storage_pod']['bound_us']:.4f} us, plain {row['storage_pod']['plain_ms']:.3f} ms; K1 by threads "
            f"(device us, {row['filter_pod']['sweep']['from']}) {row['filter_pod']['sweep']['us']}"
            + (f"; K5 by threads x template ({row['storage_pod']['sweep']['from']}) "
               f"{row['storage_pod']['sweep']['us']}" if "sweep" in row["storage_pod"] else ""))
    # the edge batch (host ports, exclusive volumes, a pod forced onto a
    # missing node, an impossible selector) and its edge state
    e_tensors, e_batch, e_statics, e_state, e_pods = edge_batch(device)
    every = range(len(e_pods[0]))
    edge = {"derived": compare_k1("edge batch", scan.StepBuffers(
        e_statics, e_state, e_pods, scan.flags_from(e_tensors, e_batch.ext)), every)}
    es, est = edge_state(e_statics, e_state, tuple(int(d) for d in (e_statics.ports_req.shape[1],
                                                                     e_statics.vol_rw_req.shape[1],
                                                                     e_statics.vol_class_mask.shape[0])), 20)
    edge["edge_state"] = compare_k1("edge batch, edge state", scan.StepBuffers(es, est, e_pods, scan.StepFlags()),
                                    every)
    out["edge_batch"] = edge
    # the wide problem: 36 VGs and 36 SSDs on one node
    w_cluster, w_apps = smoke.wide_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    wt, wb, ws, wst, wpods = tensorized_batch(w_cluster, w_apps, device, 5)
    wbuf = scan.StepBuffers(ws, clone_state(wst), wpods, scan.flags_from(wt, wb.ext))
    wl = np.flatnonzero(wbuf.storage_live)
    wide = {"k5": compare_k5("wide problem", wbuf, wl), "k1": compare_k1("wide problem", wbuf, wl)}
    wide["storage_pod"] = time_k1_k5("storage_pod", wbuf, int(wl[0]))
    wide["storage_pod"]["sweep"] = k5_sweep(wbuf, int(wl[0]))
    x = wbuf.ctx
    plans["storage_plan"]["wide"] = cuda.storage_plan(x.n, x.v, x.sd, x.l, x.k)
    out["wide"] = wide
    log(f"phase 20: K1 equal to its plain version on the edge batch ({json.dumps(edge)}); K5 on the wide problem "
        f"(V = {x.v}, SD = {x.sd}; {json.dumps(wide['k5'])}): {wide['storage_pod']['device_us']:.2f} us device, "
        f"by threads x template ({wide['storage_pod']['sweep']['from']}) {wide['storage_pod']['sweep']['us']}")
    return out, plans


#: phase 21: K6's plan sweep, threads a block (x each template that holds
#: the width: cuda.gpu_plan)
GPU_SWEEP = (32, 64, 128, 256, 512)
#: K6's sweep is timed at these node counts (and on the wide problem)
GPU_SWEEP_NODES = (1000, 5000)
#: the GPU widths of the seeded GPU states (gpu_case): every register
#: template, one past each, and the wide problem's 40
GPU_WIDTHS = (1, 2, 4, 5, 8, 9, 40)
#: the seeded GPU pods: (per-GPU memory MiB, count, preset devices; -1 the
#: last device): one-GPU pods on a grid of free memory (ties), multi-GPU
#: stacking, several shares a device, preset rows, a request larger than
#: every device, a count of 0, and a pod without GPU memory
GPU_PODS = ((4096, 1, ()), (8192, 1, ()), (16384, 1, ()), (2048, 2, ()), (4096, 3, ()), (1024, 7, ()),
            (4096, 2, (0, 1)), (4096, 1, (-1,)), (1 << 30, 1, ()), (1 << 30, 3, ()), (4096, 0, ()), (0, 0, ()))
#: K13's plan sweep: (threads a block, shared budget; None the plan's, 0
#: the grouping scratch in global memory)
DELTA_SWEEP = ((128, None), (256, None), (512, None), (1024, None), (1024, 0))
#: K13's batches of the extended log, entries before padding
DELTA_ENTRIES = (200, 2000)
#: the terms problem's K13 batch: seeded entries at Tc = 512
DELTA_TERMS = (300, 512, 200)


def gpu_case(statics, state, pods, gd: int, seed: int):
    """`statics`/`state` with seeded GPU rows of GD devices — 8, 16 or 24
    GiB a device, free memory on a grid of quarters (ties), one device in
    five missing, every 17th node without a device, every 13th node's
    total short of one device — and a batch of the GPU_PODS on the first
    pods of `pods` (an extended batch's arrays)."""
    rng = np.random.default_rng(seed)
    n = statics.alloc.shape[0]
    dev = statics.alloc.device
    exists = rng.random((n, gd)) < 0.8
    exists[::17] = False
    cap = rng.choice(np.array([8192, 16384, 24576], np.float32), (n, gd))
    grid = rng.choice(np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32), (n, gd))
    free = np.where(exists, cap * grid, 0.0).astype(np.float32)
    total = (cap * exists).sum(axis=1, dtype=np.float32)
    total[::13] = 2048.0

    def t(x):
        return torch.as_tensor(x, device=dev).contiguous()

    p = len(GPU_PODS)
    mem = np.array([m for m, _, _ in GPU_PODS], np.float32)
    count = np.array([c for _, c, _ in GPU_PODS], np.int32)
    preset = np.zeros((p, gd), np.int32)
    for j, (_, _, devs) in enumerate(GPU_PODS):
        for d in devs:
            preset[j, d % gd] = 1
    base = tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)[:p] for a in pods[:8])
    return (statics._replace(gpu_dev_exists=t(exists), gpu_total=t(total)), state._replace(gpu_free=t(free)),
            (*base, mem, count, preset))


def launch_gpu_with(buf, i: int, threads: int, template: str) -> None:
    """K6 for pod i of `buf` on `gpu_plan`'s plan of `threads` threads and
    template `template`: a measurement launch, not counted."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    plan = cuda.gpu_plan_struct(buf, threads, template)
    err = cuda.build()["gpu_pod"].simtpu_gpu_pod(ctypes.byref(buf.ctx), i, ctypes.byref(plan),
                                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K6 on {threads} threads, template {template}, failed to launch ({err})")


def gpu_templates(buf, threads: int) -> tuple:
    """K6's templates that hold `buf`'s GD: the register template up to
    GPU_REG devices, and the rows read in place."""
    return (("registers",) if buf.ctx.gd <= cuda.GPU_REG else ()) + ("global",)


def compare_k6(label: str, buf, sample) -> dict:
    """Phase 21: K6 against gpu_pod_plain on each pod of `sample`, on the
    wrapper's plan and on every (threads, template) of GPU_SWEEP x
    gpu_templates: gpu_ok and gpu_sh bit for bit, each element written
    (the outputs filled with the negated verdicts and NaN first)."""
    if buf.ctx is None:
        buf.ctx = cuda.make_ctx(buf)
    fit = presets = 0
    for i in map(int, sample):
        scan.gpu_pod_plain(buf, i)
        want_ok, want_sh = buf.gpu_ok.clone(), buf.gpu_sh.clone()
        fit += int(want_ok.sum())
        presets += buf.gpu_host[i][2]
        for threads, template in [(None, None)] + [(t, m) for t in GPU_SWEEP for m in gpu_templates(buf, t)]:
            buf.gpu_ok.copy_(~want_ok)
            buf.gpu_sh.fill_(float("nan"))
            if threads is None:
                scan.gpu_pod(buf, i)
            else:
                launch_gpu_with(buf, i, threads, template)
            torch.cuda.synchronize()
            if not (torch.equal(buf.gpu_ok, want_ok) and bits_equal(buf.gpu_sh, want_sh)):
                raise AssertionError(f"phase 21: K6 ({label}, N={buf.ctx.n}, GD={buf.ctx.gd}, threads {threads}, "
                                     f"template {template}) pod {i}: gpu_ok or gpu_sh differs")
    x = buf.ctx
    return {"pods": len(sample), "nodes_fit": fit, "preset_pods": presets, "plan": cuda.gpu_plan(x.n, x.gd)["template"]}


def k6_sweep(buf, i: int) -> dict:
    """K6's device µs per launch on each (threads, template) of GPU_SWEEP x
    gpu_templates at pod i."""
    variants = {f"{t} x {m}": (lambda t_, m_: lambda: launch_gpu_with(buf, i, t_, m_))(t, m)
                for t in GPU_SWEEP for m in gpu_templates(buf, t)}
    got, how = sweep_us(variants, "gpu_pod")
    return {"us": got, "from": how}


#: the parent tree's kernels that phase 22 builds and times against this
#: tree's, and their C entries' argument types there (K7's and K11's block
#: and the stream)
PARENT_KERNELS = {"delta_apply": [ctypes.c_void_p, ctypes.c_void_p],
                  "compact_compress": [ctypes.c_void_p, ctypes.c_void_p]}


def load_parent(parent: Path):
    """The parent tree's kernels/cuda.py as a module of its own, its
    PARENT_KERNELS built from the parent tree's sources (nvcc, all at once)
    and its other libraries this tree's: the parent's K7 and K11 paths,
    wrappers included, for timing in turns against this tree's."""
    import importlib.util

    src = parent / "simtpu_torch" / "kernels"
    spec = importlib.util.spec_from_file_location("parent_cuda", src / "cuda.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    libs = dict(cuda.build())
    out = Path(tempfile.mkdtemp(prefix="parent_kernels_"))
    procs = {name: subprocess.Popen([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                                     str(src / "csrc" / f"{name}.cu")], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True) for name in PARENT_KERNELS}
    for name, proc in procs.items():
        build_log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"the parent's {name} failed to build:\n{build_log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = getattr(lib, f"simtpu_{name}")
        fn.argtypes = PARENT_KERNELS[name]
        fn.restype = ctypes.c_int
        libs[name] = lib
    mod._LIBS.update(libs)
    return mod


def host_in_turns(calls: dict, iters: int, turns: int = 7) -> dict:
    """Host µs per back-to-back call of each of `calls` ({label: fn}):
    CUDA events around `iters` calls, the labels in turns, the order
    reversed every other turn; the median per label."""
    got = {k: [] for k in calls}
    for turn in range(turns):
        for k in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
            got[k].append(time_call(calls[k], iters) * 1e3)
    return {k: float(np.median(v)) for k, v in got.items()}


def vs_parent(calls: dict, kernel: str, host_iters: int) -> dict:
    """The parent's path against this tree's: `calls` maps "parent" and
    "new" to a callable each (one call of `kernel` through each tree's
    wrapper): device µs per call in turns in one profiler window (CUDA
    events where the windows lost events), host µs per back-to-back call
    in seven turns, and the ratios."""
    got, how = sweep_us(calls, kernel)
    host = host_in_turns(calls, host_iters)
    return {"device_us": got, "from": how, "speedup": got["parent"] / got["new"], "host_us": host,
            "host_ratio": host["new"] / host["parent"]}


def log_entries(kbuf, placed, rng, k: int):
    """`k` seeded placements of a kernel run as remove_placements-style
    records (drawn again where the run placed fewer than k pods)."""
    node = kbuf.out_node.cpu().numpy()
    ok = placed[node[placed] >= 0]
    return placement_records(kbuf, rng.choice(ok, k, replace=k > len(ok)))


def seeded_entries(tensors, pods, rng, k: int):
    """`k` seeded records of random groups on random nodes with requests of
    the batch's pods and no extended rows."""
    ext = tensors.ext
    v, sd, gd = ext.vg_cap.shape[1], ext.sdev_cap.shape[1], ext.gpu_dev_total.shape[1]
    req = np.asarray(pods[1])
    return [(int(rng.integers(len(tensors.groups))), int(rng.integers(tensors.n_nodes)),
             req[int(rng.integers(len(req)))], 0, np.zeros(v, np.float32), np.zeros(sd, bool),
             np.zeros(gd, np.float32), 0.0) for _ in range(k)]


def packed_pair(tensors, entries) -> dict:
    """The entries packed to evict (w = -1) and to restore (w = +1)."""
    ext = tensors.ext
    widths = (tensors.alloc.shape[1], ext.vg_cap.shape[1], ext.sdev_cap.shape[1], ext.gpu_dev_total.shape[1])
    return {sign: sstate.pack_delta_entries(entries, *widths, sign) for sign in (-1.0, 1.0)}


def carry_variants(cstate, dspec, nds, seed: int) -> dict:
    """The carry `cstate` ({"mixed": (cstate, dspec, nds)}, its own rows)
    and two seeded variants on the same entries' terms: "tabular", every
    count row a histogram over a small key's domains (cm_dense and the own
    planes' dense rows empty, node_dom_small every key's row the first
    small key's), and "dense", every count row a [N] row (no tabular row:
    each term adds at every node of the chosen node's domain under its
    key, a zone's ~62 nodes or one host)."""
    rng = np.random.default_rng(seed)
    dev = cstate.free.device
    t, ti = cstate.cnt_total.shape[0], dspec.ip_tab_of.shape[0]
    n, d = cstate.free.shape[0], cstate.cm_tab.shape[1]

    def ints(*shape):
        return torch.as_tensor(rng.integers(0, 50, shape).astype(np.int32), device=dev)

    def rows(size):
        return torch.arange(size, dtype=torch.int32, device=dev)

    def none(size):
        return torch.full((size,), -1, dtype=torch.int32, device=dev)

    small = int(np.flatnonzero((nds >= 0).any(dim=1).cpu().numpy())[0])
    tab = cstate._replace(cm_tab=ints(t, d), cm_dense=ints(0, n), cnt_total=ints(t),
                          **{f"{q}_tab": ints(ti, d) for q in ("oa", "of", "wa", "wn")},
                          **{f"{q}_dense": ints(0, n) for q in ("oa", "of", "wa", "wn")})
    dense = cstate._replace(cm_tab=ints(0, d), cm_dense=ints(t, n), cnt_total=ints(t),
                            **{f"{q}_tab": ints(0, d) for q in ("oa", "of", "wa", "wn")},
                            **{f"{q}_dense": ints(ti, n) for q in ("oa", "of", "wa", "wn")})
    return {"mixed": (cstate, dspec, nds),
            "tabular": (tab, type(dspec)(rows(t), none(t), rows(ti), none(ti)),
                        nds[small].expand_as(nds).contiguous()),
            "dense": (dense, type(dspec)(none(t), rows(t), none(ti), rows(ti)), nds)}


def launch_delta_with(statics, dspec, ndom, nds, cstate, packed, threads: int, budget: int) -> None:
    """K13 on `compact_delta_plan`'s plan of `threads` threads and shared
    `budget`: a measurement launch, not counted."""
    device = cstate.free.device
    ctx, entries = cuda.delta_ctx(statics, dspec, ndom, nds, cstate, packed)
    plan = cuda.delta_plan_struct(ctx, device, threads, budget)
    err = cuda.build()["compact_delta"].simtpu_compact_delta(ctypes.byref(ctx), ctypes.byref(plan),
                                                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K13 on {threads} threads, budget {budget}, failed to launch ({err})")


def on_cpu(nt):
    """A NamedTuple of tensors copied to the CPU."""
    return type(nt)(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in nt))


def compare_k13(label: str, statics, dspec, ndom, nds, cstate, packed, signs=(-1.0, 1.0)) -> dict:
    """Phase 21: K13 against apply_placement_deltas_compact_plain, the
    packed batch applied with each sign of `signs` in turn from `cstate`,
    on the wrapper's plan and on every plan of DELTA_SWEEP: every compact
    field bit for bit after each step. The plain version runs on copies of
    the inputs on the CPU (its thousands of small ops take a fraction of
    the time there that they take launched one by one on the card)."""
    want, plain = [], on_cpu(cstate)
    t0 = time.perf_counter()
    args = (on_cpu(statics), on_cpu(dspec), ndom.cpu(), nds.cpu())
    for sign in signs:
        sstate.apply_placement_deltas_compact_plain(*args, plain, packed[sign])
        want.append(clone_state(plain))
    plain_s = time.perf_counter() - t0
    for threads, budget in ((None, None),) + DELTA_SWEEP:
        got = clone_state(cstate)
        for sign, w in zip(signs, want):
            if threads is None:
                sstate.apply_placement_deltas_compact(statics, dspec, ndom, nds, got, packed[sign])
            else:
                launch_delta_with(statics, dspec, ndom, nds, got, packed[sign], threads, budget)
            torch.cuda.synchronize()
            bad = [f for f, a, b in zip(got._fields, got, w) if not bits_equal(a.cpu(), b)]
            if bad:
                raise AssertionError(f"phase 21: K13 ({label}, threads {threads}, budget {budget}, w = {sign:+.0f}): "
                                     f"fields {bad} differ from the plain version")
    wgt, node = np.asarray(packed[-1.0][2]), np.asarray(packed[-1.0][1])
    moved = sorted(f for f, a, b in zip(cstate._fields, want[0], cstate) if a.numel() and not torch.equal(a, b.cpu()))
    return {"entries": int((wgt != 0).sum()), "padded": int(len(wgt)), "nodes": int(len(np.unique(node[wgt != 0]))),
            "most_on_a_node": int(np.bincount(node[wgt != 0]).max()), "moved": moved, "plain_s": plain_s}


def time_pair(kernel: str, pair, nbytes: int) -> dict:
    """A delta kernel's (K7's or K13's) device µs per call, the sum of its
    two kernels (profiler; `pair` evicts and restores, two calls), each
    kernel's share, host µs per back-to-back call, and its bound."""
    per, _, _ = profile_kernels(lambda: [pair() for _ in range(20)], {kernel: (pair, 2)})
    events, _ = window_events(lambda: [pair() for _ in range(20)])
    parts = {part: us / 40 for name, part, us, _ in events if name == kernel}
    return {"device_us": per[kernel][0], "ms_from": ms_from(kernel), "parts_us": parts,
            "host_us": time_call(pair, 100) / 2 * 1e3, "bytes": nbytes,
            "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}


def time_k13(statics, dspec, ndom, nds, cstate, packed, nbytes: int) -> dict:
    """time_pair of K13, evicting and restoring in turn on a copy of the
    carry."""
    carry = clone_state(cstate)

    def pair():
        sstate.apply_placement_deltas_compact(statics, dspec, ndom, nds, carry, packed[-1.0])
        sstate.apply_placement_deltas_compact(statics, dspec, ndom, nds, carry, packed[1.0])

    return time_pair("compact_delta", pair, nbytes)


def k13_sweep(statics, dspec, ndom, nds, cstate, packed) -> dict:
    """K13's device µs per call on each plan of DELTA_SWEEP, the plans in
    turns, each evicting and restoring in turn on its own copy of the
    carry."""
    variants = {}
    for threads, budget in DELTA_SWEEP:
        carry, sign = clone_state(cstate), [-1.0]

        def call(t=threads, b=budget, c=carry, s=sign):
            launch_delta_with(statics, dspec, ndom, nds, c, packed[s[0]], t, b)
            s[0] = -s[0]
        variants[f"{threads} threads" + (", global" if budget == 0 else "")] = call
    got, how = sweep_us(variants, "compact_delta")
    return {"us": got, "from": how}


def phase_k6_k13(device, x_tensors, x_statics, run, head, packed200) -> tuple:
    """Phase 21: K6 and K13 against their plain versions bit for bit. K6
    at N = 120 ... 9000 on the extended case's GPU pods and on seeded GPU
    states of GD = 1, 2, 4, 5, 8, 9 and 40 (gpu_case: ties, stacking,
    presets, missing devices, a request past every device, a count of 0),
    and on the wide problem's GPU pods (GD = 40), each on the wrapper's
    plan and every plan of its sweep; per N its device / host / plain time
    and bound, its sweep at GPU_SWEEP_NODES and on the wide problem. K13
    on the extended log (run's placements) at E = 200 and 2000 on the
    extended carry and its tabular and dense variants, and at the terms
    problem's Tc = 512, each on its plan and every plan of DELTA_SWEEP;
    their device / host / plain time and bound. Returns the measurements
    and the plans."""
    rng = np.random.default_rng(21)
    out, plans = {"gpu_pod": {}, "compact_delta": {}}, {"gpu_plan": {}, "compact_delta_plan": {}}
    t0 = time.perf_counter()
    for n in K1K5_WIDTHS:
        xs, xst, xpods, xf, xsample = k3_cases(device, n)["extended"]
        xbuf = scan.StepBuffers(xs, xst, xpods, xf)
        live = np.flatnonzero(xbuf.gpu_live)
        sample = np.union1d(xsample[xbuf.gpu_live[xsample]], rng.choice(live, min(8, len(live)), replace=False))
        row = {"compare": {"extended": compare_k6("extended", xbuf, sample)}}
        gbufs = {}
        for gd in GPU_WIDTHS:
            s, st, pods = gpu_case(xs, xst, xpods, gd, n + gd)
            gbufs[gd] = scan.StepBuffers(s, st, pods, xf)
            row["compare"][f"GD={gd}"] = compare_k6(f"GD={gd}", gbufs[gd], range(len(GPU_PODS)))
        counts = xbuf.gpu_host
        gi = next(int(i) for i in sample if counts[int(i)][1] >= 2)
        row["timing"] = time_k1_k5("gpu_pod", xbuf, gi)
        if n in GPU_SWEEP_NODES:
            row["timing"]["sweep"] = k6_sweep(xbuf, gi)
            # past the register templates: the seeded GD = 9 and 40 states'
            # multi-GPU pod (GPU_PODS[3]), by threads
            for gd in (9, 40):
                row["timing"][f"sweep_gd{gd}"] = k6_sweep(gbufs[gd], 3)
        plans["gpu_plan"][str(n)] = cuda.gpu_plan(xbuf.ctx.n, xbuf.ctx.gd)
        out["gpu_pod"][str(n)] = row
        tm = row["timing"]
        log(f"phase 21: K6 equal to its plain version at N={n} on every plan of its sweep "
            f"({json.dumps(row['compare'])}): {tm['device_us']:.2f} us device ({tm['ms_from']}), "
            f"{tm['host_us']:.2f} us host a launch, bound {tm['bound_us']:.4f} us, plain {tm['plain_ms']:.3f} ms"
            + (f"; by threads x template ({tm['sweep']['from']}) {tm['sweep']['us']}, at GD = 9 "
               f"{tm['sweep_gd9']['us']}, at GD = 40 {tm['sweep_gd40']['us']}" if "sweep" in tm else ""))
    # the wide problem: a node with 40 GPU devices
    w_cluster, w_apps = smoke.wide_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes)
    wt, wb, ws, wst, wpods = tensorized_batch(w_cluster, w_apps, device, 5)
    wbuf = scan.StepBuffers(ws, clone_state(wst), wpods, scan.flags_from(wt, wb.ext))
    wl = np.flatnonzero(wbuf.gpu_live)
    wide = {"compare": compare_k6("wide problem", wbuf, wl)}
    wi = next(int(i) for i in wl if wbuf.gpu_host[int(i)][1] >= 2)
    wide["timing"] = time_k1_k5("gpu_pod", wbuf, wi)
    wide["timing"]["sweep"] = k6_sweep(wbuf, wi)
    plans["gpu_plan"]["wide"] = cuda.gpu_plan(wbuf.ctx.n, wbuf.ctx.gd)
    out["gpu_pod"]["wide"] = wide
    log(f"phase 21: K6 on the wide problem (GD = {wbuf.ctx.gd}; {json.dumps(wide['compare'])}): "
        f"{wide['timing']['device_us']:.2f} us device, by threads x template ({wide['timing']['sweep']['from']}) "
        f"{wide['timing']['sweep']['us']}")
    k6_s = time.perf_counter() - t0
    # K13 on the extended log
    n = x_tensors.n_nodes
    dev, nds = compact_maps(x_tensors, device)
    dspec = sstate.compact_delta_spec_dev(x_tensors, device)
    ndom = sstate.node_dom_for(x_tensors, n, device)
    carry = sstate.compress_state_plain(dev, clone_state(run.state))
    batches = {200: packed200, 2000: packed_pair(x_tensors, log_entries(run, head, rng, 2000))}
    for label, (cst, dsp, nd) in carry_variants(carry, dspec, nds, 21).items():
        for e, packed in batches.items():
            if label != "mixed" and e != 2000:
                continue
            key = f"{label} E={e}"
            signs = (-1.0, 1.0) if e == 200 else (-1.0,)
            row = {"compare": compare_k13(f"extended {key}", x_statics, dsp, ndom, nd, cst, packed, signs)}
            row["timing"] = time_k13(x_statics, dsp, ndom, nd, cst, packed,
                                     compact_delta_bytes(x_statics, cst, packed[-1.0], dsp, ndom, nd))
            if (label, e) in (("mixed", 200), ("tabular", 2000)):
                row["timing"]["sweep"] = k13_sweep(x_statics, dsp, ndom, nd, cst, packed)
            x = cuda.delta_ctx(x_statics, dsp, ndom, nd, cst, packed[-1.0])[0]
            plans["compact_delta_plan"][key] = cuda.delta_plan_of(x)
            out["compact_delta"][key] = row
            tm = row["timing"]
            log(f"phase 21: K13 equal to its plain version on the extended log's {key} batch on every plan of its "
                f"sweep ({json.dumps(row['compare'])}): {tm['device_us']:.2f} us device ({tm['ms_from']}), "
                f"{tm['host_us']:.2f} us host a call, bound {tm['bound_us']:.4f} us, by kernel {tm['parts_us']}"
                + (f"; by plan ({tm['sweep']['from']}) {tm['sweep']['us']}" if "sweep" in tm else ""))
    # the terms problem at Tc = 512: seeded entries
    terms, tc, e = DELTA_TERMS
    tt, tb, ts, tst, tp = terms_batch(device, terms)
    if ts.g_terms.shape[1] != tc:
        raise AssertionError(f"phase 21: the terms problem has Tc = {ts.g_terms.shape[1]}, want {tc}")
    tdev, tnds = compact_maps(tt, device)
    tspec = sstate.compact_delta_spec_dev(tt, device)
    tndom = sstate.node_dom_for(tt, tt.n_nodes, device)
    tcarry = sstate.compress_state_plain(tdev, clone_state(tst))
    tpacked = packed_pair(tt, seeded_entries(tt, tp, rng, e))
    key = f"terms Tc={tc} E={e}"
    row = {"compare": compare_k13(key, ts, tspec, tndom, tnds, tcarry, tpacked)}
    row["timing"] = time_k13(ts, tspec, tndom, tnds, tcarry, tpacked,
                             compact_delta_bytes(ts, tcarry, tpacked[-1.0], tspec, tndom, tnds))
    x = cuda.delta_ctx(ts, tspec, tndom, tnds, tcarry, tpacked[-1.0])[0]
    plans["compact_delta_plan"][key] = cuda.delta_plan_of(x)
    out["compact_delta"][key] = row
    tm = row["timing"]
    log(f"phase 21: K13 equal to its plain version on the {key} batch ({json.dumps(row['compare'])}): "
        f"{tm['device_us']:.2f} us device, {tm['host_us']:.2f} us host a call, bound {tm['bound_us']:.4f} us")
    out["seconds"] = {"k6": k6_s, "all": time.perf_counter() - t0}
    log(f"phase 21: {out['seconds']['all']:.1f} s (K6 {k6_s:.1f} s)")
    return out, plans


# -- phase 22: K7 and K11 ---------------------------------------------------

#: K11's tiles along a row checked beside the wrapper's plan: one, and
#: three times the plan's
K11_TILES = (1, 3)
#: phase 22's serial cut whose node count is not a multiple of 4
K11_ODD_NODES = 1001
#: the preference weights of phase 22's fractional K7 case (0 where a slot
#: has no ip row) and the values its preference planes start from
FRACTIONAL = (2.5, 0.3, 1.75, 0.6)
#: the integer weights of the weighted K7 cases (real Kubernetes weights)
INT_WEIGHTS = tuple(range(1, 101))


def launch_delta_apply_with(statics, state, packed, threads: int, budget: int) -> None:
    """K7 on `compact_delta_plan`'s plan of `threads` threads and shared
    `budget`: a measurement launch, not counted."""
    ctx, _, entries = cuda.delta_apply_call(statics, state, packed)
    plan = cuda.delta_plan_struct(ctx, state.free.device, threads, budget)
    err = cuda.build()["delta_apply"].simtpu_delta_apply(ctypes.byref(ctx), ctypes.byref(plan),
                                                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K7 on {threads} threads, budget {budget}, failed to launch ({err})")


def hostname_statics(statics):
    """The statics with every topology key a per-node key (node_dom[k, n] =
    k N + n): a hostname-only cluster's layout, every domain one node."""
    k, n = statics.node_dom.shape
    ids = torch.arange(k * n, dtype=torch.int32, device=statics.node_dom.device).reshape(k, n)
    return statics._replace(node_dom=ids)


def region_statics(statics):
    """The statics with every key that groups nodes (a zone) made one
    domain of all the nodes that have it, as a region or single-value
    label is, and the per-node keys kept: one large domain beside
    one-node ones."""
    nd = statics.node_dom.cpu().numpy().copy()
    for row in nd:
        live = row >= 0
        if live.any() and len(np.unique(row[live])) < live.sum():
            row[live] = row[live].min()
    return statics._replace(node_dom=torch.from_numpy(nd).to(statics.node_dom.device))


def weighted_statics(statics, rng, values):
    """The statics with both preference weights drawn from `values` on every
    slot whose term has an ip row."""
    terms = statics.g_terms
    ip = (terms >= 0) & (statics.ip_of[terms.clamp(min=0).long()] >= 0)

    def draw():
        v = torch.as_tensor(rng.choice(np.asarray(values, np.float32), tuple(terms.shape)), device=terms.device)
        return torch.where(ip, v, torch.zeros((), device=terms.device))

    return statics._replace(w_aff_pref=draw(), w_anti_pref=draw())


def pref_state(state, rng, values):
    """A copy of the state with both preference planes drawn from `values`."""
    def draw(t):
        return torch.as_tensor(rng.choice(np.asarray(values, np.float32), tuple(t.shape)), device=t.device)

    return clone_state(state)._replace(w_own_aff_pref=draw(state.w_own_aff_pref),
                                       w_own_anti_pref=draw(state.w_own_anti_pref))


def compare_k7(label: str, statics, state, packed, round_trip: bool) -> dict:
    """Phase 22: K7 against apply_placement_deltas_plain, the batch evicted
    (w = -1) then restored (w = +1) from `state`, on the wrapper's plan and
    every plan of DELTA_SWEEP: every plane bit for bit after each step, and
    with `round_trip` the state before the eviction after the restore. The
    plain version runs on copies of the inputs on the CPU."""
    want, plain, args = [], on_cpu(state), on_cpu(statics)
    t0 = time.perf_counter()
    for sign in (-1.0, 1.0):
        sstate.apply_placement_deltas_plain(args, plain, packed[sign])
        want.append(clone_state(plain))
    plain_s = time.perf_counter() - t0
    if round_trip and not all(bits_equal(a, b.cpu()) for a, b in zip(want[1], state)):
        raise AssertionError(f"phase 22: K7's plain version ({label}) does not return the state before")
    for threads, budget in ((None, None),) + DELTA_SWEEP:
        got = clone_state(state)
        for sign, w in zip((-1.0, 1.0), want):
            if threads is None:
                sstate.apply_placement_deltas(statics, got, packed[sign])
            else:
                launch_delta_apply_with(statics, got, packed[sign], threads, budget)
            torch.cuda.synchronize()
            bad = [f for f, a, b in zip(got._fields, got, w) if not bits_equal(a.cpu(), b)]
            if bad:
                raise AssertionError(f"phase 22: K7 ({label}, threads {threads}, budget {budget}, w = {sign:+.0f}): "
                                     f"planes {bad} differ from the plain version")
    wgt, node = np.asarray(packed[-1.0][2]), np.asarray(packed[-1.0][1])
    moved = sorted(f for f, a, b in zip(state._fields, want[0], state) if a.numel() and not torch.equal(a, b.cpu()))
    return {"entries": int((wgt != 0).sum()), "padded": int(len(wgt)), "nodes": int(len(np.unique(node[wgt != 0]))),
            "most_on_a_node": int(np.bincount(node[wgt != 0]).max()), "pref_mode": cuda.pref_mode(statics, len(wgt)),
            "moved": moved, "round_trip": round_trip, "plain_s": plain_s}


def time_k7(statics, state, packed) -> dict:
    """time_pair of K7, evicting and restoring in turn on a copy of the
    state."""
    carry = clone_state(state)

    def pair():
        sstate.apply_placement_deltas(statics, carry, packed[-1.0])
        sstate.apply_placement_deltas(statics, carry, packed[1.0])

    return time_pair("delta_apply", pair, delta_bytes(statics, state, packed[-1.0]))


def k7_vs_parent(pmod, statics, state, packed) -> dict:
    """The parent's K7 path against this tree's on copies of one state
    (each through engine/state.py apply_placement_deltas' device check):
    evict and restore in turn, call by call, the copies equal bit for bit
    after two turns; then vs_parent."""
    def parent(st, carry, p):
        if carry.free.device.type == "cpu":
            sstate.apply_placement_deltas_plain(st, carry, p)
        else:
            pmod.launch_delta(st, carry, p)

    carries = {"parent": clone_state(state), "new": clone_state(state)}
    apply = {"parent": parent, "new": sstate.apply_placement_deltas}
    sign = {"parent": -1.0, "new": -1.0}

    def call(side):
        apply[side](statics, carries[side], packed[sign[side]])
        sign[side] = -sign[side]

    for _ in range(2):
        call("parent")
        call("new")
    torch.cuda.synchronize()
    bad = [f for f, a, b in zip(state._fields, carries["parent"], carries["new"]) if not bits_equal(a, b)]
    if bad:
        raise AssertionError(f"phase 22: K7 differs from the parent's K7: {bad}")
    return vs_parent({side: (lambda s_: lambda: call(s_))(side) for side in ("parent", "new")}, "delta_apply", 100)


def launch_compress_with(spec, state, tiles: int):
    """K11 on its task table with `tiles` blocks along a row: a
    measurement launch, not counted; the CompactState it writes."""
    ctx, plan, out = cuda.compress_ctx(spec, state)
    plan = cuda.CompressPlan(n_tasks=plan.n_tasks, tiles=tiles, tasks=plan.tasks, gather=plan.gather)
    err = cuda.build()["compact_compress"].simtpu_compact_compress(ctypes.byref(ctx), ctypes.byref(plan),
                                                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K11 on {tiles} tiles failed to launch ({err})")
    return sstate.CompactState(**out)


def compare_k11(label: str, tensors, state, device) -> dict:
    """Phase 22: K11 against compress_state_plain on `state`, on the
    wrapper's plan and on K11_TILES times its tiles: every field bit for
    bit, the narrowed planes 16-byte aligned and apart in one buffer."""
    spec = sstate.compact_spec_dev(tensors, device)
    want = sstate.compress_state_plain(spec, clone_state(state))
    plan = cuda._compress_setup(spec, state)["plan"]
    for tiles in (None,) + tuple(k * plan.tiles for k in K11_TILES):
        got = (sstate.compress_state(spec, clone_state(state)) if tiles is None
               else launch_compress_with(spec, clone_state(state), tiles))
        torch.cuda.synchronize()
        bad = [f for f, a, b in zip(got._fields, got, want) if a.dtype != b.dtype or not bits_equal(a, b)]
        if bad:
            raise AssertionError(f"phase 22: K11 ({label}, tiles {tiles}): fields {bad} differ from the plain version")
        spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                       for f, t in zip(got._fields, got) if f in cuda.NARROW_FIELDS and t.numel())
        if any(a % 16 for a, _ in spans) or any(b > a for (_, b), (a, _) in zip(spans, spans[1:])):
            raise AssertionError(f"phase 22: K11 ({label}): the narrowed planes are not aligned and apart")
    return {"n": tensors.n_nodes, "n_mod_4": tensors.n_nodes % 4, "tasks": plan.n_tasks, "tiles": plan.tiles,
            "rows": {"Rt": int(spec.t_tab.shape[0]), "Rd": int(spec.t_dense.shape[0]),
                     "Rti": int(spec.ip_tab.shape[0]), "Rdi": int(spec.ip_dense.shape[0]), "D": int(spec.t_rep.shape[1])}}


def time_k11(tensors, state, device) -> dict:
    """K11's device µs per launch (profiler), host µs per back-to-back
    call, the plain version's ms and the bound (bytes)."""
    spec = sstate.compact_spec_dev(tensors, device)
    call = (lambda: sstate.compress_state(spec, state))
    nbytes = compact_bytes(tensors, state, call())["compact_compress"]
    per, _, _ = profile_kernels(lambda: [call() for _ in range(50)], {"compact_compress": call})
    return {"device_us": per["compact_compress"][0], "ms_from": ms_from("compact_compress"),
            "host_us": time_call(call, 200) * 1e3,
            "plain_ms": time_call(lambda: sstate.compress_state_plain(spec, state), 10),
            "bytes": nbytes, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}


def k11_vs_parent(pmod, tensors, state, device) -> dict:
    """The parent's K11 path against this tree's on one state (each
    through engine/state.py compress_state's device check): equal field
    for field, then vs_parent."""
    spec = sstate.compact_spec_dev(tensors, device)

    def parent():
        if state.free.device.type == "cpu":
            return sstate.compress_state_plain(spec, state)
        return sstate.CompactState(**pmod.launch_compact_compress(spec, state))

    a, b = parent(), sstate.compress_state(spec, state)
    torch.cuda.synchronize()
    bad = [f for f, x, y in zip(a._fields, a, b) if not bits_equal(x, y)]
    if bad:
        raise AssertionError(f"phase 22: K11 differs from the parent's K11: {bad}")
    return vs_parent({"parent": parent, "new": lambda: sstate.compress_state(spec, state)}, "compact_compress", 200)


def seeded_carry(tensors, device, k: int, seed: int):
    """A dense state rebuilt from a seeded placement log of `k` entries
    (random groups on random nodes) on `tensors`."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, len(tensors.groups), k).astype(np.int32)
    n = rng.integers(0, tensors.n_nodes, k).astype(np.int32)
    return sstate.build_state(tensors, g, n, np.zeros((k, tensors.alloc.shape[1]), np.float32), None, device)


def phase_k7_k11(device, x_tensors, x_statics, run, head, packed200, carries: dict, parent) -> tuple:
    """Phase 22: K7 and K11 against their plain versions bit for bit. K7
    on the extended problem's dense state (run's placements) at E = 200
    (phase 2's batch) and 2000, on its hostname-only variant (every key a
    per-node key) at 2000, on its region variant (each zone key one domain
    of all its nodes beside the per-node keys) at 1000, with integer
    preference weights (1-100: the atomic
    path), with those weights and preference planes past pref_mode's bound
    and with fractional weights and planes (the log-order path), each
    evicted then restored on the wrapper's plan and every plan of
    DELTA_SWEEP (the integer cases back to the state before); K11 on
    `carries` ({label: (tensors, dense state)}: the serial, extended,
    capacity-winner and bulk carries and N % 4 != 0) on its plan and
    K11_TILES. Then their device / host / plain times and bounds, and with
    `parent` (a module of load_parent) the parent's K7 and K11 equal and
    timed in turns (vs_parent). Returns the measurements and the plans."""
    rng = np.random.default_rng(22)
    t0 = time.perf_counter()
    state = run.state
    packed2000 = packed_pair(x_tensors, log_entries(run, head, rng, 2000))
    weights = weighted_statics(x_statics, rng, INT_WEIGHTS)
    cases = {
        "extended E=200": (x_statics, state, packed200, True),
        "extended E=2000": (x_statics, state, packed2000, True),
        "hostname E=2000": (hostname_statics(x_statics), state, packed2000, True),
        "region E=1000": (region_statics(x_statics), state, packed_pair(x_tensors, log_entries(run, head, rng, 1000)),
                          True),
        "weighted E=200": (weights, state, packed200, True),
        "past the bound E=200": (weights, pref_state(state, rng, cuda.F32_EXACT - np.arange(1, 60)), packed200,
                                 False),
        "fractional E=200": (weighted_statics(x_statics, rng, FRACTIONAL), pref_state(state, rng, FRACTIONAL),
                             packed200, False),
    }
    out = {"delta_apply": {}, "compact_compress": {}}
    plans = {"delta_apply_plan": {}, "compress_plan": {}}
    for label, (st, s, packed, round_trip) in cases.items():
        row = {"compare": compare_k7(label, st, s, packed, round_trip)}
        if label in ("extended E=200", "extended E=2000", "hostname E=2000", "region E=1000", "fractional E=200"):
            row["timing"] = time_k7(st, s, packed)
            if parent is not None and label != "fractional E=200":
                row["timing"]["parent"] = k7_vs_parent(parent, st, s, packed)
        plans["delta_apply_plan"][label] = cuda.delta_plan_of(cuda.delta_apply_call(st, s, packed[-1.0])[0])
        out["delta_apply"][label] = row
        tm = row.get("timing", {})
        log(f"phase 22: K7 equal to its plain version on the {label} batch on every plan of its sweep "
            f"({json.dumps(row['compare'])})"
            + (f": {tm['device_us']:.2f} us device ({tm['ms_from']}), {tm['host_us']:.2f} us host a call, bound "
               f"{tm['bound_us']:.4f} us, by kernel {tm['parts_us']}" if tm else "")
            + (f"; against the parent's K7 {json.dumps(tm['parent'])}" if "parent" in tm else ""))
    k7_s = time.perf_counter() - t0
    for label, (tensors, s) in carries.items():
        row = {"compare": compare_k11(label, tensors, s, device)}
        if label in ("serial", "bulk"):
            row["timing"] = time_k11(tensors, s, device)
            if parent is not None:
                row["timing"]["parent"] = k11_vs_parent(parent, tensors, s, device)
        setup = cuda._compress_setup(sstate.compact_spec_dev(tensors, device), s)
        plans["compress_plan"][label] = {"tasks": setup["plan"].n_tasks, "tiles": setup["plan"].tiles,
                                         "narrow_bytes": setup["nbytes"]}
        out["compact_compress"][label] = row
        tm = row.get("timing", {})
        log(f"phase 22: K11 equal to its plain version on the {label} carry on its plan and {K11_TILES} x its "
            f"tiles ({json.dumps(row['compare'])})"
            + (f": {tm['device_us']:.2f} us device ({tm['ms_from']}), {tm['host_us']:.2f} us host a call, bound "
               f"{tm['bound_us']:.4f} us ({tm['bytes']} B), plain {tm['plain_ms']:.3f} ms" if tm else "")
            + (f"; against the parent's K11 {json.dumps(tm['parent'])}" if "parent" in tm else ""))
    out["seconds"] = {"k7": k7_s, "all": time.perf_counter() - t0}
    log(f"phase 22: {out['seconds']['all']:.1f} s (K7 {k7_s:.1f} s)")
    return out, plans


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}")
    args = sys.argv[1:]
    parent_dir = Path(args[args.index("--parent") + 1]).resolve() if "--parent" in args else None

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    # the profile build of K9/K10 (phase 2's breakdown) and K14-K16 (phase
    # 6's splits) compiles beside the twenty-five libraries, every nvcc
    # started together
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        profile_build = pool.submit(cuda.build_profile)
        cuda.build()
        profile_build.result()
    log(f"phase 1: built {len(cuda.KERNELS)} kernels and the K9/K10/K14-K16 profile build in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {cuda.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for name in cuda.KERNELS:
        for line in cuda.BUILD_INFO.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # the parent tree's K5, K6 and K13 (phase 21 times them in turns
    # against this tree's), where a directory of it was given
    parent = load_parent(parent_dir) if parent_dir is not None else None
    if parent is not None:
        log(f"phase 1: built the parent's {', '.join(PARENT_KERNELS)} from {parent_dir}")

    # -- phase 2: kernels against their plain versions ---------------------
    configure_numerics()
    err = dict.fromkeys(KERNELS, 0.0)
    rng = np.random.default_rng(11)
    tensors, batch, statics, state, pods = smoke_batch(device)
    flags = scan.flags_from(tensors, batch.ext)
    log(f"phase 2: smoke shape N={tensors.n_nodes} T={tensors.n_terms} G={len(tensors.groups)} "
        f"Tc={statics.g_terms.shape[1]} pods={len(pods[0])} flags={flags}")
    sample = np.sort(rng.choice(len(pods[0]), N_SAMPLE, replace=False))
    kbuf = phase_compare(statics, state, pods, flags, sample, err)
    phase_compare(statics, state, pods, scan.StepFlags(), sample[: N_SAMPLE // 2], err)
    e_tensors, e_batch, e_statics, e_state, e_pods = edge_batch(device)
    edge_buf = phase_compare(e_statics, e_state, e_pods, scan.StepFlags(), range(len(e_pods[0])), err)
    log(f"phase 2: K1-K4 equal to their plain versions on {N_SAMPLE} smoke pods (derived flags), "
        f"{N_SAMPLE // 2} (all flags) and the edge problem (reasons {sorted(set(edge_buf.reason.tolist()))})")

    x_tensors, x_batch, x_statics, x_state, x_pods = extended_batch(device)
    x_flags = scan.flags_from(x_tensors, x_batch.ext)
    probe = scan.StepBuffers(x_statics, x_state, x_pods, x_flags)
    x_sample, kinds = extended_sample(probe, rng)
    log(f"phase 2: extended shape N={x_tensors.n_nodes} V={x_statics.vg_cap.shape[1]} "
        f"SD={x_statics.sdev_cap.shape[1]} GD={x_state.gpu_free.shape[1]} pods={len(x_pods[0])} "
        f"(storage {int(probe.storage_live.sum())}, GPU {int(probe.gpu_live.sum())}; {kinds}) flags={x_flags}")
    xbuf = phase_compare(x_statics, x_state, x_pods, x_flags, x_sample, err)
    reasons = sorted(set(xbuf.reason[torch.as_tensor(x_sample, device=device)].tolist()))
    log(f"phase 2: K1-K6 equal to their plain versions on {len(x_sample)} extended pods "
        f"(reasons {reasons}); max |score diff| {err['score_argmax_pod']}")
    # a kernel run of the first 3000 extended pods gives real placements to evict
    run = scan.StepBuffers(x_statics, clone_state(x_state), x_pods, x_flags)
    head = np.arange(3000)
    for i in head:
        scan.filter_pod(run, int(i))
        if run.storage_live[i]:
            scan.storage_pod(run, int(i))
        if run.gpu_live[i]:
            scan.gpu_pod(run, int(i))
        scan.topology_pod(run, int(i))
        scan.score_argmax_pod(run, int(i))
        scan.commit_pod(run, int(i))
    torch.cuda.synchronize()
    x_run = run  # phase 21's log
    entries = delta_entries(run, head, rng, 200)
    packed = phase_delta(x_statics, run.state, entries, x_tensors, err)
    log(f"phase 2: K7 equal to its plain version evicting and restoring {len(entries)} placements; "
        "the round trip restores every plane bit for bit")
    for label, (f_cluster, f_apps) in (("bulk fixture", fuzz.bulk_fixture()),
                                       ("mutation fixture", fuzz._mutation_fixture())):
        f_sim = Simulator(device="cuda")
        f_sim.run_cluster(f_cluster)
        for app in f_apps:
            f_sim.schedule_app(app)
        f_tensors, f_e = checker.simulation_entries(f_sim)
        flagged = compare_k8(label, f_tensors, f_e, None, device, err, seed=1)
        f_sim.close()
        log(f"phase 2: K8 equal to its plain version on the {label} ({len(f_e.n)} entries) "
            f"in {len(flagged)} cases; entries flagged {flagged}")
    # K9/K10 on runs of the wave plans, from the state the main path gives them
    s_done, s_runs, s_wbuf = phase_waves("serial smoke problem", tensors, batch, statics, state, pods, flags,
                                         ("lean", "lean-pref", "hard-spread", "anti-req"), err)
    x_done, x_runs, x_wbuf = phase_waves("extended problem", x_tensors, x_batch, x_statics, x_state, x_pods,
                                         x_flags, ("storage", "gpu"), err)
    r_tensors, r_batch, r_statics, r_state, r_pods = rack_batch(device)
    r_flags = scan.flags_from(r_tensors, r_batch.ext)
    r_done, _, r_wbuf = phase_waves("rack problem", r_tensors, r_batch, r_statics, r_state, r_pods, r_flags,
                                    ("lean", "lean-pref"), err, per_kind=1)
    k_tensors, k_batch, k_statics, k_state, k_pods = keys_batch(device)
    k_flags = scan.flags_from(k_tensors, k_batch.ext)
    k_done, _, k_wbuf = phase_waves("keys problem", k_tensors, k_batch, k_statics, k_state, k_pods, k_flags,
                                    ("lean", "lean-pref", "hard-spread"), err)
    log(f"phase 2: K9/K10 equal to their plain versions (nodes, reasons, plans, every state plane) on "
        f"runs of the serial smoke problem {s_done}, the extended problem {x_done}, the rack problem "
        f"({r_tensors.n_domains} domains over {r_tensors.node_dom.shape[0]} keys) {r_done} and the keys "
        f"problem ({k_tensors.node_dom.shape[0]} keys) {k_done}")

    big_waves = {}
    for n_big in WAVE_BIG_NODES:
        b_tensors, b_batch, b_statics, b_state, b_pods = big_batch(device, n_big)
        b_flags = scan.flags_from(b_tensors, b_batch.ext)
        big_waves[n_big], _, _ = phase_waves(f"{n_big}-node problem", b_tensors, b_batch, b_statics, b_state,
                                             b_pods, b_flags, ("lean", "lean-pref", "hard-spread"), err,
                                             per_kind=1)
        del b_tensors, b_batch, b_statics, b_state, b_pods
    log(f"phase 2: K9/K10 equal to their plain versions above 1024 nodes (2 and 3 nodes per thread in "
        f"registers, then the carried rows in global memory): {big_waves}")

    # K11/K12 on the states the wave runs above left (written by K1-K4 and
    # K9/K10), K13 on K7's eviction and restore batches
    parts = {}
    for label, c_tensors, c_state in (("serial smoke problem", tensors, s_wbuf.state),
                                      ("extended problem", x_tensors, x_wbuf.state),
                                      ("rack problem", r_tensors, r_wbuf.state),
                                      ("keys problem", k_tensors, k_wbuf.state)):
        _, parts[label] = phase_compact(label, c_tensors, c_state, device, err)
    # phase 22's K11 carries: these states as they are now, later phases'
    # (the bulk carry, the capacity winner, a 1001-node cut) added there
    k11_carries = {"serial": (tensors, clone_state(s_wbuf.state)), "extended": (x_tensors, clone_state(x_wbuf.state))}
    log("phase 2: K11/K12 equal to their plain versions (every compact field; the expansion equal to "
        "the state compressed, state_diff 0, no storage shared) on " + "; ".join(
            f"the {k} {v}" for k, v in parts.items()))
    x_start = phase_compact_delta(x_tensors, x_statics, run.state, packed, device, err)
    log(f"phase 2: K13 equal to its plain version and to the expand -> K7 -> compress route evicting "
        f"and restoring {len(entries)} placements on the extended carry; the round trip restores "
        "every compact field bit for bit")
    round_times, q_round_times, a_round_times, m_round_times, l_round_times, copy_times, split_rounds, \
        round_sweeps = phase_bulk_kernels(device, err)
    sweep_times = phase_sweep_kernels(device, err)
    relax_kernels = phase_relax_kernels(device, err)
    relax_wide = phase_relax_wide(device, err)
    relax_kernels["shapes"] = phase_relax_shapes(device, err)
    grow_times = phase_grow_kernels(device)
    # -- phase 17: any Tc; K22 and K20 at their shapes and plan sweeps --------
    terms_run = phase_terms(device, err)
    relax_kernels["load"] = phase_relax_load_shapes(device, err)
    explain_shapes = phase_explain_shapes(device, err)

    # timing: K1-K4 at the smoke pod with the most term rows (as PR 2);
    # K1-K4 and K5 at a storage pod and K6 at a GPU pod of the extended batch
    counts = [(int((statics.g_terms[int(kbuf.group[i])] >= 0).sum()), i) for i in range(0, kbuf.n_pods, 97)]
    ti = max(counts)[1]
    times, nbytes = phase_timing(kbuf, ti, STEP)
    si = int(np.flatnonzero(probe.storage_live & ((probe.lvm_size.cpu().numpy() > 0).sum(axis=1) >= 2))[0])
    gi = int(np.flatnonzero(probe.gpu_live & (probe.gpu_count.cpu().numpy() >= 2))[0])
    s_times, s_bytes = phase_timing(xbuf, si, STEP + ("storage_pod",))
    g_times, g_bytes = phase_timing(xbuf, gi, ("gpu_pod",))
    launch_ms = time_call(lambda: cuda.launch_noop(device), 2000)
    d_state = clone_state(run.state)

    def delta_pair():
        sstate.apply_placement_deltas(x_statics, d_state, packed[-1.0])
        sstate.apply_placement_deltas(x_statics, d_state, packed[1.0])

    delta_ms = time_call(delta_pair, 200) / 2
    delta_plain_ms = time_call(
        lambda: sstate.apply_placement_deltas_plain(x_statics, d_state, packed[-1.0])
        or sstate.apply_placement_deltas_plain(x_statics, d_state, packed[1.0]), 2) / 2
    d_bytes = delta_bytes(x_statics, run.state, packed[-1.0])
    for name, (host_ms, plain_ms) in times.items():
        log(f"  {name}: {host_ms * 1e3:.2f} us per back-to-back launch from Python, plain "
            f"{plain_ms * 1e3:.1f} us, {nbytes[name]} B (smoke pod {ti})")
    for name, (host_ms, plain_ms) in list(s_times.items()) + list(g_times.items()):
        at, b = (si, s_bytes) if name in s_times else (gi, g_bytes)
        log(f"  {name}: {host_ms * 1e3:.2f} us per back-to-back launch from Python, plain "
            f"{plain_ms * 1e3:.1f} us, {b[name]} B (extended pod {at})")
    log(f"  delta_apply: {delta_ms * 1e3:.2f} us per launch of {len(entries)} entries, plain "
        f"{delta_plain_ms * 1e3:.1f} us, {d_bytes} B")
    log(f"  empty launch: {launch_ms * 1e3:.2f} us")

    per, busy, pwall = phase_profile(statics, state, pods, flags, 2000)
    # where K1-K4's times came from, before later phases' windows (phase 19
    # times K2 and K4 again) add to PROFILER_MISSED
    step_from = {name: ms_from(name) for name in STEP}
    log(f"  profiler, serial smoke K1-K4 over 2000 pods: {pwall:.3f} s wall, device busy {busy:.3f} "
        "of it; " + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in per.items()))
    x_per, x_busy, x_wall = phase_profile(x_statics, x_state, x_pods, x_flags, 2000)
    log(f"  profiler, extended K1-K6 over 2000 pods: {x_wall:.3f} s wall, device busy {x_busy:.3f} "
        "of it; " + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in x_per.items()))
    d_per, _, _ = profile_kernels(lambda: [delta_pair() for _ in range(20)], {"delta_apply": (delta_pair, 2)})
    x_per.update(d_per)
    log(f"  profiler, delta_apply: {d_per['delta_apply'][0]:.2f} us x {d_per['delta_apply'][1]}")
    # K11/K12 at the serial smoke carry, K13 on K7's batches at the extended one
    c_dev, c_nds = compact_maps(tensors, device)
    c_state = clone_state(s_wbuf.state)
    c_carry = sstate.compress_state(c_dev, clone_state(c_state))
    compact_times = {
        "compact_compress": (time_call(lambda: sstate.compress_state(c_dev, c_state), 200),
                             time_call(lambda: sstate.compress_state_plain(c_dev, c_state), 5)),
        "compact_expand": (time_call(lambda: sstate.expand_state(c_dev, c_carry, c_nds), 200),
                           time_call(lambda: sstate.expand_state_plain(c_dev, c_carry, c_nds), 5)),
    }
    c_bytes = compact_bytes(tensors, c_state, c_carry)
    x_dev, x_nds = compact_maps(x_tensors, device)
    x_dspec = sstate.compact_delta_spec_dev(x_tensors, device)
    x_ndom = sstate.node_dom_for(x_tensors, x_tensors.n_nodes, device)
    d_carry = type(x_start)(*(t.clone() for t in x_start))

    def compact_delta_pair(apply=sstate.apply_placement_deltas_compact):
        apply(x_statics, x_dspec, x_ndom, x_nds, d_carry, packed[-1.0])
        apply(x_statics, x_dspec, x_ndom, x_nds, d_carry, packed[1.0])

    compact_times["compact_delta"] = (
        time_call(compact_delta_pair, 200) / 2,
        time_call(lambda: compact_delta_pair(sstate.apply_placement_deltas_compact_plain), 2) / 2)
    c_bytes["compact_delta"] = compact_delta_bytes(x_statics, x_start, packed[-1.0], x_dspec, x_ndom, x_nds)
    c_per, _, _ = profile_kernels(lambda: [(sstate.compress_state(c_dev, c_state),
                                            sstate.expand_state(c_dev, c_carry, c_nds),
                                            compact_delta_pair()) for _ in range(20)],
                                  {"compact_compress": lambda: sstate.compress_state(c_dev, c_state),
                                   "compact_expand": lambda: sstate.expand_state(c_dev, c_carry, c_nds),
                                   "compact_delta": (compact_delta_pair, 2)})
    x_per.update(c_per)
    for name, (host_ms, plain_ms) in compact_times.items():
        log(f"  {name}: {c_per[name][0]:.2f} us device (profiler), {host_ms * 1e3:.2f} us per "
            f"back-to-back call from Python, plain {plain_ms * 1e3:.1f} us, {c_bytes[name]} B, bound "
            f"{c_bytes[name] / HBM_BYTES_PER_S * 1e6:.3f} us "
            + ("(serial smoke carry)" if name != "compact_delta" else f"({len(entries)} entries, extended carry)"))

    # K9/K10: one run of each kind relaunched from its start state, and the
    # wave dispatcher over the first 2000 pods of the two problems
    wave_times = {}
    for buf, run in ((s_wbuf, next(r for r in s_runs if r[0] == "lean")),
                     (s_wbuf, next(r for r in s_runs if r[0] == "lean-pref")),
                     (s_wbuf, next(r for r in s_runs if r[0] == "hard-spread")),
                     (x_wbuf, next(r for r in x_runs if r[0] == "storage"))):
        t = time_wave(buf, run, 50)
        wave_times.setdefault(t["name"], t)
        log(f"  {t['name']} ({t['kind']} run of {t['pods']} pods): {t['device_us']:.2f} us device per launch "
            f"(profiler), {t['device_us'] / t['pods']:.2f} us per pod step, {t['host_us']:.2f} us to enqueue "
            f"a launch, plain {t['plain_ms'] * 1e3:.1f} us, {t['bytes']} B")
    breakdown = phase_wave_breakdown({"serial": (s_wbuf, s_runs), "extended": (x_wbuf, x_runs)})
    # every template instance and path of K9, K10, K14-K16, K18, K19 and K23
    ptxas = {name: ptxas_entries(name) for name in (*WAVES, "sweep_place", "relax_project", *ROUND_KERNELS,
                                                    "sweep_drain")}
    for name, entries in ptxas.items():
        for fn, info in entries.items():
            log(f"  ptxas {name} {fn}: {info}")
    w_per, w_busy, w_wall = profile_waves(tensors, batch, statics, state, pods, flags, 2000)
    xw_per, xw_busy, xw_wall = profile_waves(x_tensors, x_batch, x_statics, x_state, x_pods, x_flags, 2000)
    for label, pr, bz, wl in (("serial smoke", w_per, w_busy, w_wall), ("extended", xw_per, xw_busy, xw_wall)):
        log(f"  profiler, {label} wave dispatcher over 2000 pods: {wl:.3f} s wall, device busy {bz:.3f} "
            "of it; " + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in pr.items()))

    # -- phase 3: the serial main path -------------------------------------
    launches, s_steps, wall, n_pods, _, s_sim, s_waves, s_gauge = run_main_path(
        smoke.smoke_problem(synth_cluster, synth_apps), smoke.GOLDEN, card, "phase 3", "serial")

    # -- phase 3b: the extended main path ----------------------------------
    x_launches, x_steps, x_wall3, x_pods_n, x_record, x_sim, x_waves, x_gauge = run_main_path(
        smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes),
        smoke.EXT_GOLDEN, card, "phase 3b", "extended")
    if x_launches.get("compact_delta", 0) < 1 or x_launches.get("delta_apply", 0) or not x_record["preempted"]:
        raise AssertionError(f"phase 3b: the preemption deltas did not go through K13 alone ({x_launches})")

    # -- phase 3d: both main paths in the serial-exact configuration -------
    # (the wavefront and the compact carry off, the JAX package's audit
    # fallback engine)
    off_launches, _, off_wall, _, _, _, _, _ = run_main_path(
        smoke.smoke_problem(synth_cluster, synth_apps), smoke.GOLDEN, card, "phase 3d serial", "serial",
        speculate=False, compact=False)
    off_x_launches, off_x_steps, off_x_wall, _, _, _, _, _ = run_main_path(
        smoke.extended_problem(synth, simtpu_torch.AppResource, simtpu_torch.ResourceTypes),
        smoke.EXT_GOLDEN, card, "phase 3d extended", "extended", speculate=False, compact=False)
    if off_x_launches.get("delta_apply", 0) < 1:
        raise AssertionError(f"phase 3d: no preemption delta ran through K7 ({off_x_launches})")

    # -- phase 3c: K8 on the main paths' placement logs --------------------
    for label, sim in (("serial log", s_sim), ("extended log", x_sim)):
        l_tensors, l_e = checker.simulation_entries(sim)
        flagged = compare_k8(label, l_tensors, l_e, sim._engine.node_valid, device, err, seed=2)
        log(f"phase 3c: K8 equal to its plain version on the {label} ({len(l_e.n)} entries, "
            f"N={l_tensors.n_nodes}) in {len(flagged)} cases; entries flagged {flagged}")

    # -- phase 4: the examples ---------------------------------------------
    got = run_example("examples/cluster/demo", "examples/application/web", "web")
    log(f"phase 4: demo example, {len(got['placed'])} pods placed, equal to the CPU path")
    gpu_rec = run_example("examples/cluster/gpushare", "examples/application/gpushare",
                          "inference", ["gpu"])
    st_rec = run_example("examples/cluster/demo", "examples/application/local-storage",
                         "database", ["open-local"])
    log(f"phase 4b: gpushare example {len(gpu_rec['placed'])} pods placed "
        f"({len(gpu_rec['gpu_index'])} with GPU assignments), local-storage example "
        f"{len(st_rec['placed'])} pods placed ({len(st_rec['node_ext'])} annotated nodes); "
        "both equal to the CPU path")

    # -- phase 4c: the example configs through the apply front door -------
    run_cli_examples(card)

    # -- phase 5: the capacity main path ------------------------------------
    plan, c_launches, c_steps, c_wall, winner, c_split, c_gauge = run_capacity(card)
    host_split = capacity_host_split(card, plan.nodes_added)

    # -- phase 5b: the divergence fallback ----------------------------------
    run_injected(card)

    # -- phase 6: the bulk main path ------------------------------------------
    b_launches, b_steps, b_wall, b_pods, b_dev = run_bulk(card)
    # K14-K16 phase by phase on the named rounds (phase 2's start states),
    # after the main path's counts were read; K15 on the bulk rounds
    splits = {name: {label: round_split(name, *args) for label, args in split_rounds.items()
                     if name != "round_pick" or label.startswith("bulk")} for name in ROUND_KERNELS}
    del split_rounds
    for name in ROUND_KERNELS:
        for label, sp in splits[name].items():
            kplan = sp["plan"]
            how = (f"{kplan['kernel']} kernel" if name == "round_pick" else
                   f"B={kplan['blocks']} x {kplan['threads']} threads, template {kplan['template']}")
            extra = (f"; {sp['steps_or_passes']} bisection steps / radix passes, {sp['ladder_levels']} ladder "
                     f"levels" if name == "round_pick" else "")
            log(f"phase 6: {name}'s split at the {label} round (pod {sp['pod']}, k={sp['k']}, N={sp['n']}, "
                f"{how}): {sp['us_per_launch']:.2f} us per launch (CUDA events; profile build "
                f"{sp['profile_build_us']:.2f} us); " + ", ".join(
                    f"{ph} {us:.2f} us" for ph, us in sp["phase_us"].items()) + f"{extra} [{card}]")

    # -- phase 7: the large capacity plan (bulk + incremental) ---------------
    l_plan, l_launches, l_wall, l_audit = run_large_capacity(card)

    # -- phases 8-11: the batched what-if sweeps -------------------------------
    serial_faults = run_serial_faults(card, err)
    bulk_faults, bulk_pc = run_bulk_faults(card, err)
    # phase 18's K8 logs on the bulk problem's nodes
    k8_logs = {"large capacity winner": l_audit, **bulk_audit_logs(bulk_pc, device)}
    batched_capacity = run_batched_capacity(card)
    resilience_plan = run_resilience_plan(card)

    # -- phases 12-13: decision observability, the fuzz harness ---------------
    explain = run_explain(card, bulk_pc, err)
    del bulk_pc
    fuzz_run = run_fuzz(card)

    # -- phases 14-15: the solver paths, the grow path --------------------------
    solver_paths = run_solver_paths(card, {"capacity": plan.timings["plan"], "large_capacity": l_wall,
                                           "resilience": resilience_plan["wall_s"]})
    grow_path = run_grow_path(card, device)

    # -- phase 16: the wide problem through every StepCtx kernel family ---------
    wide_paths = run_wide(card)

    # -- phase 18: K18 past 4096 keys; K8 on large and skewed logs; K3's widths --
    many_keys, many_keys_plan = phase_many_keys(device, err)
    audit_logs, audit_plans = phase_audit_logs(k8_logs)
    del k8_logs, l_audit
    k3_widths, k3_plans = phase_k3_widths(device, err)

    # -- phase 19: K2 and K4 at N = 120 ... 9000 and at Tc = 512 and 1024 -------
    k2k4_widths, k2_plans = phase_k2_k4(device)

    # -- phase 20: K1 and K5 at N = 120 ... 9000, edge states, the wide problem --
    k1k5_widths, k1k5_plans = phase_k1_k5(device)

    # -- phase 21: K6 and K13 at their shapes, against the parent's where given --
    k6k13, k6k13_plans = phase_k6_k13(device, x_tensors, x_statics, x_run, head, packed)

    # -- phase 22: K7 and K11, against the parent's where given -----------------
    w_tensors = winner[0]
    n_tensors = big_batch(device, K11_ODD_NODES)[0]
    k11_carries.update({"capacity winner": (w_tensors, seeded_carry(w_tensors, device, 12000, 22)),
                        "bulk": copy_times.pop("bulk_carry"),
                        f"serial N={K11_ODD_NODES}": (n_tensors, seeded_carry(n_tensors, device, 3000, 23))})
    k7k11, k7k11_plans = phase_k7_k11(device, x_tensors, x_statics, x_run, head, packed, k11_carries, parent)

    # K8's time at the capacity winner's log (M entries on the plan's nodes)
    w_tensors, w_e, w_nv = winner
    w_x = checker._upload(w_tensors, w_e, np.ones(w_tensors.n_nodes, bool) if w_nv is None else w_nv,
                          device)
    k8_ms = time_call(lambda: kaudit.audit_bulk(w_x), 200)
    k8_plain_ms = time_call(lambda: kaudit.audit_bulk_plain(w_x), 5)
    k8_winner = audit_window(w_x, 20)
    x_per["audit_bulk"] = (k8_winner["device_us"], 20)
    k8_bytes = audit_bytes(w_x)
    log(f"  audit_bulk: M={len(w_e.n)} N={w_tensors.n_nodes}: {k8_winner['device_us']:.2f} us device over "
        f"{k8_winner['kernels_per_launch']} kernels a launch ({k8_winner['ms_from']}), {k8_ms * 1e3:.2f} us per "
        f"back-to-back launch from Python, plain {k8_plain_ms * 1e3:.1f} us, {k8_bytes} B")

    rows = []
    busy_s = 0.0
    all_times = {**times, **{k: v for k, v in s_times.items() if k not in times}, **g_times,
                 "delta_apply": (delta_ms, delta_plain_ms), "audit_bulk": (k8_ms, k8_plain_ms),
                 **compact_times}
    all_bytes = {**nbytes, "storage_pod": s_bytes["storage_pod"], "gpu_pod": g_bytes["gpu_pod"],
                 "delta_apply": d_bytes, "audit_bulk": k8_bytes, **c_bytes}
    main_launches = {**x_launches, "audit_bulk": c_launches.get("audit_bulk", 0),
                     **{k: b_launches.get(k, 0) for k in ROUND_KERNELS},
                     "carry_copy": l_launches.get("carry_copy", 0)}
    for name, replaces in KERNELS.items():
        if name in RELAX_KERNELS or name in GROW_KERNELS:
            t = relax_kernels["times"][name] if name in RELAX_KERNELS else grow_times[name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": f"simtpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                **({"also_replaces": "simtpu/solve/relax.py:218"} if name == "relax_project" else {}),
                **({"also_replaces": "simtpu/engine/state.py:517"} if name == "grow_terms" else {}),
                # the main paths: phase 14 (a)-(c) for K22/K23, phase 15 for K24/K25
                "launches": (sum(o["launches"].get(name, 0) for o in solver_paths.values())
                             if name in RELAX_KERNELS else grow_path["launches"].get(name, 0)),
                "max_abs_err": err[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": None,
                "host_ms": t["host_ms"],
                "launch_ms": launch_ms,
                "ms_from": ms_from(name),
                "at": (f"the capacity relaxation {tuple(relax_kernels['problems']['capacity']['shape'])}"
                       if name in RELAX_KERNELS else t["at"]),
                "bytes": t["bytes"],
                **({"ops": t["ops"]} if name in RELAX_KERNELS else {}),
                **({"launches_by_path": {k: o["launches"].get(name, 0) for k, o in solver_paths.items()}}
                   if name in RELAX_KERNELS else {}),
                **({"ptxas": ptxas[name], "wide_rows": relax_wide,
                    "large_capacity_us": relax_kernels["problems"]["large_capacity"]["device_us"][name],
                    "rows_per_sm": {k: o["rows_per_sm"] for k, o in relax_kernels["problems"].items()}}
                   if name == "relax_project" else {}),
            })
            continue
        if name in EXPLAIN_KERNELS:
            t = explain["times"][name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": f"simtpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                # the main paths: phase 12 (a)-(d)
                "launches": explain["launches"][name],
                "max_abs_err": err[name],
                "ms": t["device_us"] / 1e3,
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_us"] / 1e3,
                "bound_by": "bytes",
                "library_ms": None,
                "host_ms": t["host_us"] / 1e3,
                "launch_ms": launch_ms,
                "ms_from": t["ms_from"],
                "at": f"{t['pods']} pod(s) x N={t['n']}",
                "bytes": t["bytes"],
                **({"extended_chunk": explain["times"]["explain_pass_extended"]} if name == "explain_pass"
                   else {"terms_exact": t["terms_exact"]}),
                "launches_by_path": {p: explain[p]["launches"].get(name, 0)
                                     for p in ("extended", "bulk", "scores", "plan")},
            })
            continue
        if name in SWEEP_KERNELS:
            t = sweep_times[name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": f"simtpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                **({"also_replaces": "simtpu/parallel/sweep.py:49"} if name == "sweep_place" else {}),
                # the main path: phase 8's zone and k=1 sweeps
                "launches": sum(serial_faults[k]["launches"].get(name, 0) for k in ("zone", "k1")),
                "max_abs_err": err[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": None,
                "host_ms": t["host_ms"],
                "launch_ms": launch_ms,
                "ms_from": ms_from(name),
                "at": t["at"],
                "bytes": t["bytes"],
                "us_per_pod_step": t["us_per_pod_step"] if name == "sweep_place" else None,
                "main_path_us_per_launch": {"serial_k1": serial_faults["k1"]["us_per_launch"].get(name),
                                            "bulk_k2": bulk_faults["us_per_launch"].get(name)},
                "launches_bulk_faults_path": bulk_faults["launches"].get(name, 0),
                "launches_batched_capacity_path": batched_capacity["launches"].get(name, 0),
                "launches_resilience_plan_path": resilience_plan["launches"].get(name, 0),
                **({"ptxas": ptxas[name], "chunks": t["chunks"], "edges": t["edges"],
                    "first_chunks": {"serial_k1": serial_faults["k1"]["compare"]["drain"],
                                     "bulk_k2": bulk_faults["compare"]["drain"]}}
                   if name == "sweep_drain" else {}),
                **({"ptxas": ptxas[name], "events_by_path": {"serial_k1": serial_faults["k1"]["sweep_place_events"],
                                       "bulk_k2": bulk_faults["sweep_place_events"],
                                       "batched_capacity": batched_capacity["sweep_place_events"],
                                       "resilience_plan": resilience_plan["sweep_place_events"]},
                    "first_chunks": {"serial_k1": serial_faults["k1"]["compare"]["timed"],
                                     "bulk_k2": bulk_faults["compare"]["timed"]}} if name == "sweep_place" else {}),
            })
            continue
        if name in ROUND_KERNELS or name == "carry_copy":
            t = round_times[name] if name in ROUND_KERNELS else copy_times["compact"]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": f"simtpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                "launches": main_launches.get(name, 0),
                "max_abs_err": err[name],
                "ms": t["ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"),
                "host_ms": t["host_ms"],
                "launch_ms": launch_ms,
                "ms_from": ms_from(name),
                "at": t.get("round", "the bulk problem's compact carry"),
                "bytes": t["bytes"],
                "launches_bulk_path": b_launches.get(name, 0),
                "launches_large_capacity_path": l_launches.get(name, 0),
                **({"quota_round": q_round_times[name], "quota_anti_round": a_round_times[name],
                    "matrix_round": m_round_times[name], "large_capacity_round": l_round_times[name]}
                   if name in ROUND_KERNELS else {"dense_carry": copy_times["dense"]}),
                **({"ptxas": ptxas[name], "phase_split": splits[name]} if name in ROUND_KERNELS else {}),
                **({"cluster_sweep": round_sweeps} if name in cuda.CLUSTER_KERNELS else {}),
            })
            continue
        if name in WAVES:
            t = wave_times[name]
            mean_us = (xw_per.get(name) or w_per.get(name) or (t["device_us"],))[0]
            busy_s += mean_us / 1e6 * x_launches.get(name, 0)
            rows.append({
                "name": name,
                "route": "cuda",
                "source": f"simtpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces,
                "launches": main_launches.get(name, 0),
                "max_abs_err": err[name],
                # the timed run's own device time (profiler) and its bound
                "ms": t["device_us"] / 1e3,
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bytes"] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
                "host_ms": t["host_us"] / 1e3,
                "launch_ms": launch_ms,
                "ms_from": ms_from(name),
                "run": {"kind": t["kind"], "pods": t["pods"], "us_per_pod_step": t["device_us"] / t["pods"]},
                "ptxas": ptxas[name],
                "breakdown": [r for r in breakdown if r["name"] == name],
                "above_1024_nodes": {str(k): v for k, v in big_waves.items()},
                "main_path_us_per_launch": {"serial": w_per.get(name, (None,))[0],
                                            "extended": xw_per.get(name, (None,))[0]},
                "launches_serial_path": launches.get(name, 0),
                "launches_capacity_path": c_launches.get(name, 0),
            })
            continue
        host_ms, plain_ms = all_times[name]
        # the kernel's own time on the card (profiler; K1-K4 and K11/K12 at
        # the serial smoke shape, K5-K7 and K13 at the extended one); the
        # back-to-back launch time from Python (host_ms) is bound by the
        # launch path
        prof = per.get(name) if name in STEP else x_per.get(name)
        ms = prof[0] / 1e3 if prof else host_ms
        busy_s += ms / 1e3 * x_launches.get(name, 0)
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"simtpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": main_launches.get(name, 0),
            "max_abs_err": err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": all_bytes[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            "host_ms": host_ms,
            "launch_ms": launch_ms,
            "ms_from": step_from.get(name, ms_from(name)) if prof else "cuda events",
            "launches_serial_path": launches.get(name, 0),
            "launches_capacity_path": c_launches.get(name, 0),
            "ms_extended": x_per[name][0] / 1e3 if name in x_per else None,
            "host_ms_extended": s_times[name][0] if name in s_times else None,
        })
    # phase 17's figures on the rows of the kernels they time
    for row in rows:
        if row["name"] in terms_run["tc1024"]["times"]:
            row["tc1024"] = terms_run["tc1024"]["times"][row["name"]]
        if row["name"] == "relax_load":
            row["load"] = relax_kernels["load"]
            row["yardstick_ms"] = relax_kernels["load"]["yardstick_us"] / 1e3
            row["yardstick"] = 'torch.einsum("scn,cr->snr", y, req): the load alone, not the whole function'
        if row["name"] == "explain_pass":
            row["shapes"] = explain_shapes
        if row["name"] == "sweep_drain":
            row["many_keys"] = many_keys
        if row["name"] == "audit_bulk":
            row["kernels_per_launch"] = k8_winner["kernels_per_launch"]
            row["parts_us"] = k8_winner["parts_us"]
            row["logs"] = audit_logs
            row["launches_by_phase"] = {
                "5": c_launches.get("audit_bulk", 0), "7": l_launches.get("audit_bulk", 0),
                "8": sum(serial_faults[k]["launches"].get("audit_bulk", 0) for k in ("zone", "k1")),
                "9": bulk_faults["launches"].get("audit_bulk", 0),
                "10": batched_capacity["launches"].get("audit_bulk", 0),
                "11": resilience_plan["launches"].get("audit_bulk", 0),
                "12": sum(explain[p]["launches"].get("audit_bulk", 0) for p in ("extended", "bulk", "scores", "plan")),
                "13": fuzz_run["launches"].get("audit_bulk", 0) + fuzz_run["mutation_kill"]["launches"].get(
                    "audit_bulk", 0)}
        if row["name"] in ("filter_pod", "topology_pod", "commit_pod", "storage_pod", "gpu_pod", "delta_apply",
                           "compact_compress", "compact_delta"):
            # the main paths' launches of K1, K2, K4-K7, K11 and K13, path by
            # path (a bulk round launches K1 and K2, and K5 for a storage
            # pod, once more; the bulk path's K7 reverts a failed stretch)
            name = row["name"]
            row["launches_by_path"] = {
                "serial": launches.get(name, 0), "extended": x_launches.get(name, 0),
                "serial_exact_serial": off_launches.get(name, 0),
                "serial_exact_extended": off_x_launches.get(name, 0), "capacity": c_launches.get(name, 0),
                "bulk": b_launches.get(name, 0), "bulk_rounds": b_steps["rounds"],
                "large_capacity": l_launches.get(name, 0),
                "phase_8_zone": serial_faults["zone"]["launches"].get(name, 0),
                "phase_8_k1": serial_faults["k1"]["launches"].get(name, 0),
                "phase_9": bulk_faults["launches"].get(name, 0),
                "phase_10": batched_capacity["launches"].get(name, 0),
                "phase_11": resilience_plan["launches"].get(name, 0),
                **{f"explain_{p}": explain[p]["launches"].get(name, 0) for p in ("extended", "bulk", "scores", "plan")},
                "phase_13": fuzz_run["launches"].get(name, 0) + fuzz_run["mutation_kill"]["launches"].get(name, 0),
                "phase_14": sum(o["launches"].get(name, 0) for o in solver_paths.values()),
                "phase_15_grow": grow_path["launches"].get(name, 0)}
        if row["name"] in ("topology_pod", "commit_pod"):
            row["widths"] = {k: {"pods": v["pods"], **v[row["name"]],
                                 **({"sweep_us": v["sweep_us"]} if "sweep_us" in v and row["name"] == "topology_pod"
                                    else {})} for k, v in k2k4_widths.items()}
        if row["name"] in ("filter_pod", "storage_pod"):
            name = row["name"]
            row["widths"] = {k: {**v[name], "compare": v["compare"]} for k, v in k1k5_widths.items()
                             if k not in ("edge_batch", "wide")}
            row["edge_batch" if name == "filter_pod" else "wide"] = (
                k1k5_widths["edge_batch"] if name == "filter_pod" else k1k5_widths["wide"])
        if row["name"] == "gpu_pod":
            row["widths"] = k6k13["gpu_pod"]
        if row["name"] == "compact_delta":
            row["entries"] = k6k13["compact_delta"]
            row["phase_21_s"] = k6k13["seconds"]
        if row["name"] in ("delta_apply", "compact_compress"):
            row["phase_22"] = k7k11[row["name"]]
            row["phase_22_s"] = k7k11["seconds"]
        if row["name"] == "score_argmax_pod":
            row["widths"] = k3_widths
            row["launches_bulk_path"] = b_launches.get("score_argmax_pod", 0)
            row["launches_large_capacity_path"] = l_launches.get("score_argmax_pod", 0)
    # launch plans and constants beside the line's measurements: the
    # wrappers' choices, not readings of this run
    plans = {"sweep_drain_many_keys": many_keys_plan, "audit_bulk_logs": audit_plans,
             "audit_bulk_capacity_winner": {k: v for k, v in cuda.audit_plan(
                 w_tensors.n_nodes, len(w_e.n), 0).items() if k not in ("offsets", "s", "words")},
             "score_argmax_pod_widths": k3_plans, "topology_pod_widths": k2_plans, **k1k5_plans, **k6k13_plans,
             **k7k11_plans}
    print(json.dumps({"kernels": rows, "plans": plans, "card": card, "terms": terms_run,
                      "compact_carry": {"serial": s_gauge, "extended": x_gauge, "capacity": c_gauge,
                                        "partitions": parts},
                      "serial": {"wall_s": wall, "pods": n_pods, "pods_per_s": n_pods / wall,
                                 "steps": s_steps, "waves": s_waves, "wall_s_wavefront_off": off_wall,
                                 "pods_per_s_wavefront_off": n_pods / off_wall},
                      "extended": {"wall_s": x_wall3, "pods": x_pods_n, "pods_per_s": x_pods_n / x_wall3,
                                   "pod_steps": x_steps, "waves": x_waves,
                                   "preempted": len(x_record["preempted"]),
                                   "device_busy": busy_s / x_wall3, "wall_s_wavefront_off": off_x_wall,
                                   "pods_per_s_wavefront_off": x_pods_n / off_x_wall,
                                   "pod_steps_wavefront_off": off_x_steps},
                      "loop_device_busy": {"serial": busy, "extended": x_busy,
                                           "serial_waves": w_busy, "extended_waves": xw_busy},
                      "capacity": {"nodes_added": plan.nodes_added, "candidates": len(plan.candidates),
                                   "plan_s": plan.timings["plan"], "ingest_s": plan.timings["ingest"],
                                   "wall_s": c_wall, "pod_steps": c_steps["pods"],
                                   "candidate_wall_s": [c["wall_s"] for c in plan.candidates],
                                   "waves": plan.engine["wavefront"],
                                   "audit_split_mean_s": c_split,
                                   "candidate_host_split": host_split},
                      "bulk": {"wall_s": b_wall, "pods": b_pods, "pods_per_s": b_pods / b_wall,
                               "rounds": b_steps["rounds"], "serial_pod_steps": b_steps["pods"],
                               "wave_pods": b_steps["wave_pods"], "place_s": b_steps["place_s"], **b_dev,
                               "rounds_device_share": b_dev["rounds_device_s"] / b_wall,
                               "device_busy": b_dev["device_s"] / b_wall, "profiled": True},
                      "serial_faults": serial_faults, "bulk_faults": bulk_faults,
                      "batched_capacity": batched_capacity, "resilience_plan": resilience_plan,
                      "explain": {k: v for k, v in explain.items() if k != "times"}, "fuzz": fuzz_run,
                      "relax_kernels": {k: relax_kernels[k] for k in ("problems", "run_ms", "shapes")},
                      "solver_paths": solver_paths, "grow_path": grow_path, "wide_paths": wide_paths,
                      "large_capacity": {"nodes_added": l_plan.nodes_added, "wall_s": l_wall,
                                         "probes": {str(k): v for k, v in l_plan.probes.items()},
                                         "timings": l_plan.timings,
                                         "placements": [{k: c[k] for k in ("phase", "count", "wall_s")}
                                                        for c in l_plan.candidates]}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
