#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (simtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit; none is caught):

1. the card's name and power limit (nvidia-smi); build the twenty-five CUDA
   kernels from `simtpu_torch/kernels/csrc/` (nvcc, sm_90a, one process
   per source, all at once);
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
   topology keys: lean, preference and hard-spread runs), the pods
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
   pod step;
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
   pods/s, the rounds and their device share;
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
   plain version.
Phase 2 also holds K14-K16 against their plain versions on rounds of the
bulk problem (plain, storage, quota-spread, quota-anti) and of the matrix
cut (2000 x 20 000, bench.py's "matrix" mix: multi-GPU, self-affinity and
GPU rounds), each from the state the earlier rounds left, and K17 on the
bulk carry, dense and compact; then their times at named rounds. And
K18/K19 against their plain versions on the extended problem's
`place_cluster` (a chunk of 16 single-node scenarios and one of 4 zone
outages, storage and GPU pods in the requeue): every replica plane,
nodes and reasons; then their times on the single-node chunk. And K22/K23
against their plain versions on the relaxations of the capacity and the
large capacity problems (100 candidates, 400 iterations; the first 5
iterations step by step, then y and the residual to the stated tolerances
and the feasible sets equal), K24/K25 against theirs on every growth of
the grow problem's carry (entry, extension, promotions, node growth), bit
for bit; then their times.
Last, K8's time at the capacity winner's log (device time from the
profiler, back-to-back launches from Python, the plain version's).

The line before the last is the JSON `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import copy
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
    per, _, _ = profile_kernels(lambda: [once() for _ in range(iters)])
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
    per, busy, wall = profile_kernels(lambda: wavefront.run_batch_waves(buf, tensors, groups, cut))
    return per, busy, wall


def delta_entries(kbuf, placed_pods, rng, k: int):
    """`k` seeded placements of a kernel run as remove_placements-style
    records, half of them storage or GPU pods."""
    node = kbuf.out_node.cpu().numpy()
    ext = kbuf.storage_live | kbuf.gpu_live
    ok = placed_pods[node[placed_pods] >= 0]
    pick = np.concatenate([rng.choice(ok[ext[ok]], k // 2, replace=False),
                           rng.choice(ok[~ext[ok]], k - k // 2, replace=False)])
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


def compact_delta_bytes(statics, state, cstate, packed, tensors) -> int:
    """Bytes K13 must move for these entries: the entries read once, the
    chosen nodes' rows read and written, each tabular bucket and cnt_total
    entry the entries touch read and written, and the dense count rows'
    elements they touch read and written."""
    g, node, wgt, req, vg, sd, gp = (np.asarray(x) for x in packed)
    live = wgt != 0
    e, r = req.shape
    entry_bytes = e * (12 + 4 * r + 4 * vg.shape[1] + sd.shape[1] + 4 * gp.shape[1])
    rows = np.unique(node[live])
    row_bytes = len(rows) * (4 * r + 4 * cstate.ports_used.shape[1] + 8 * cstate.vols_any.shape[1]
                             + 4 * cstate.vg_free.shape[1] + cstate.sdev_free.shape[1]
                             + 4 * cstate.gpu_free.shape[1])
    g_terms = statics.g_terms.cpu().numpy()
    node_dom = statics.node_dom.cpu().numpy()
    term_topo = statics.term_topo.cpu().numpy()
    ip_of = statics.ip_of.cpu().numpy()
    dspec = sstate.compact_delta_spec(tensors)
    t_tab_of, t_dense_of = dspec.t_tab_of.numpy(), dspec.t_dense_of.numpy()
    ip_tab_of, ip_dense_of = dspec.ip_tab_of.numpy(), dspec.ip_dense_of.numpy()
    nds = tensors.node_dom_small
    n = tensors.n_nodes
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
            if t_tab_of[term] >= 0:
                buckets.add((term, nds[key, c]))
                if ip >= 0 and ip_tab_of[ip] >= 0:
                    ip_buckets.add((ip, nds[key, c]))
                continue
            same = node_dom[key] == node_dom[key, c]
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
    k1 = n * r * f4 + n * p * f4 + 2 * n * w * f4 + n * c * f4 + 3 * n + n  # + stage out
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
    return profile_kernels(lambda: scan.run_batch(buf))


def profile_kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = ev.cuda_time_total
        for name in KERNELS:
            if ev.key.startswith(f"{name}_kernel"):
                per[name] = (dev_us / max(ev.count, 1), ev.count)
                busy_us += dev_us
    return per, busy_us / 1e6 / wall, wall


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
    calls = {
        "round_score": (lambda: rounds.round_score(rb, i, mode), lambda: rounds.round_score_plain(rb, i, mode)),
        "round_pick": (lambda: rounds.round_pick(rb, i, k, mode), lambda: rounds.round_pick_plain(rb, i, k, mode)),
        "round_commit": (lambda: rounds.round_commit(rb, i, k, mode, 0),
                         lambda: rounds.round_commit_plain(rb, i, k, mode, 0)),
    }
    per, _, _ = profile_kernels(lambda: [(calls["round_score"][0](), calls["round_pick"][0](),
                                          calls["round_commit"][0]()) for _ in range(20)])
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
        per, _, _ = profile_kernels(lambda: [tinc._copy_state(carry) for _ in range(20)])
        out[label] = {"ms": per["carry_copy"][0] / 1e3,
                      "host_ms": time_call(lambda: tinc._copy_state(carry), 200),
                      "plain_ms": time_call(lambda: tinc.copy_carry_plain(carry), 20),
                      "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"  carry_copy ({label} carry, {len(carry)} planes): {out[label]['ms'] * 1e3:.2f} us device "
            f"(profiler), {out[label]['host_ms'] * 1e3:.2f} us per back-to-back call from Python, plain "
            f"{out[label]['plain_ms'] * 1e3:.1f} us, {nbytes} B, bound {out[label]['bound_ms'] * 1e3:.3f} us")
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
        for name in KERNELS:
            if ev.key.startswith(f"{name}_kernel"):
                dev[name] = dev_us / 1e6
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
    version may run. Returns (plan, launches, wall)."""
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
            with contextlib.redirect_stderr(err_text):
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
    return plan, launches, wall


def phase_bulk_kernels(device, err):
    """Phase 2 for K14-K17: the rounds of the bulk problem (plain,
    quota-spread, quota-anti, storage) and of the matrix cut (matrix, self-
    affinity, GPU rounds) against their plain versions, K17 on the bulk
    carry, dense and compact; then their times at named rounds."""
    b_tensors, b_batch, b_statics, b_state, b_pods = problem_batch(*smoke.bulk_problem(synth), device)
    b_flags = scan.flags_from(b_tensors, b_batch.ext)
    log(f"phase 2: bulk shape N={b_tensors.n_nodes} T={b_tensors.n_terms} G={len(b_tensors.groups)} "
        f"Tc={b_statics.g_terms.shape[1]} domains={b_tensors.n_domains} pods={len(b_pods[0])} flags={b_flags}")
    b_done, b_first, b_buf = phase_rounds("bulk problem", b_tensors, b_batch, b_statics, b_state, b_pods,
                                          b_flags, ("plain", "quota-spread", "quota-anti", "storage"), err)
    m_tensors, m_batch, m_statics, m_state, m_pods = problem_batch(*smoke.matrix_problem(synth), device)
    m_flags = scan.flags_from(m_tensors, m_batch.ext)
    log(f"phase 2: matrix cut N={m_tensors.n_nodes} V={m_statics.vg_cap.shape[1]} "
        f"GD={m_state.gpu_free.shape[1]} pods={len(m_pods[0])} flags={m_flags}")
    m_done, m_first, _ = phase_rounds("matrix cut", m_tensors, m_batch, m_statics, m_state, m_pods, m_flags,
                                      ("bulkm", "bulka", "gpu"), err)
    log(f"phase 2: K14-K16 equal to their plain versions (caps, s0, slope, fill orders, m_n, every state "
        f"plane, the slot outputs) on rounds of the bulk problem {b_done} and the matrix cut {m_done}")
    copy_times = phase_carry_copy(b_tensors, b_buf.state, device, err)
    log("phase 2: K17 equal to its plain version on the bulk carry, dense and compact: fresh storage, "
        "the snapshot untouched when the copy is written")
    times = time_rounds(b_tensors, b_statics, b_pods, b_flags, b_first["plain"], "bulk plain")
    q_times = time_rounds(b_tensors, b_statics, b_pods, b_flags, b_first["quota-spread"], "bulk quota-spread")
    x_times = time_rounds(m_tensors, m_statics, m_pods, m_flags, m_first["bulkm"], "matrix bulkm")
    return times, q_times, x_times, copy_times


# -- the batched sweeps (K18 sweep_drain, K19 sweep_place) --------------------


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

    # times on the k=1 chunk
    per, _, _ = profile_kernels(lambda: [inp.run(valid, ev_idx, rq_idx) for _ in range(5)])
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
                     "us_per_pod_step": dev_us / max(steps, 1)}
        log(f"  {name}: {dev_us:.2f} us device per launch (profiler, 16 blocks"
            + (f", {dev_us / max(steps, 1):.2f} us per pod step of the longest list of {steps}" if name == "sweep_place" else "")
            + f"), {out[name]['host_ms'] * 1e3:.2f} us to enqueue, plain {plain[name] * 1e3:.1f} ms, "
            f"{nbytes[name]} B, bound {out[name]['bound_ms'] * 1e3:.3f} us")
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
    per, _, _ = profile_kernels(lambda: out.append(tfaults.sweep_scenarios(pc, scen)))
    wall = time.perf_counter() - t0
    dev_s = sum(per[k][0] * per[k][1] for k in SWEEP_KERNELS if k in per) / 1e6
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
            "us_per_launch": {k: per[k][0] for k in SWEEP_KERNELS if k in per}}


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
    out = {"scenarios": s_chunk, "e_pad": inp.e_pad, "r_pad": inp.r_pad, "cols": int(rq_idx.shape[1]),
           "entries": int((ev_idx >= 0).sum()), "rows": rows, "placed": int((nodes >= 0).sum()),
           "plain_s": plain}
    log(f"{phase}: K18/K19 equal to their plain versions on the {label} ({s_chunk} scenarios x "
        f"N={pc.n_nodes}, e_pad {inp.e_pad} with {out['entries']} entries, r_pad {inp.r_pad}"
        + (f" cut to {out['cols']}" if rq_cols is not None else "")
        + f", {rows} requeue rows, {out['placed']} re-placed): every replica plane, nodes, reasons, the base "
        f"carry untouched; plain K18 {plain['sweep_drain']:.1f} s, K19 {plain['sweep_place']:.1f} s")
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
        f"{dev_s / wall:.1%} of the wall, {out['k1']['us_per_launch']} us per launch; == golden")
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
        f"K18/K19 device {dev_s:.4f} s = {dev_s / wall:.1%}, {out['us_per_launch']} us per launch; == golden, "
        f"the carry unchanged [{card}]")
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
        plan = tpsweep.plan_capacity_batched(cluster, apps, template, device="cuda")
        torch.cuda.synchronize()
    finally:
        seed_name_hashes(None)
        tpsweep.sweep_scan = scan_fn
    wall = time.perf_counter() - t0
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
           "pod_steps": n_pods, "us_per_pod_step": walls[0] / n_pods * 1e6, "launches": launches}
    log(f"phase 10: plan_capacity_batched on the capacity problem: {len(plan.probes)} candidates in one "
        f"K18 + K19 launch pair, sweep {walls[0]:.3f} s wall ({out['us_per_pod_step']:.2f} us per pod step "
        f"of {n_pods}), plan {wall:.2f} s, +{plan.nodes_added} nodes, failures {failures} == golden, "
        f"winner record == golden [{card}]")
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
            with contextlib.redirect_stderr(io.StringIO()):
                rc, doc = smoke.run_cli_json(tcli.main, ["resilience", "-f", cfg, "--plan", "--faults",
                                                         smoke.CAP_RESIL_SPEC, "--seed", "0", "--json"])
        finally:
            seed_name_hashes(None)
            tresil.sweep_scenarios = sweep_fn
        wall = time.perf_counter() - t0
    launches, plain = dict(cuda.LAUNCHES), dict(cuda.PLAIN_CALLS)
    if rc != golden["plan_rc"] or smoke.doc_record(doc) != golden["plan"]:
        raise AssertionError(f"phase 11: exit {rc} (golden {golden['plan_rc']}), plan "
                             f"{smoke.doc_record(doc)} != golden {golden['plan']}")
    if launches.get("sweep_drain", 0) != len(sweep_walls) or launches.get("sweep_place", 0) != len(sweep_walls) \
            or any(plain.values()):
        raise AssertionError(f"phase 11: {len(sweep_walls)} sweeps, launches {launches}, plain {plain}")
    out = {"wall_s": wall, "rc": rc, "nodes_added": doc["nodes_added"], "candidates": doc["candidates_probed"],
           "sweeps": len(sweep_walls), "sweep_wall_s": sweep_walls, "launches": launches}
    log(f"phase 11: cli resilience --plan --faults k=2:64 on the capacity problem: exit {rc}, "
        f"+{doc['nodes_added']} nodes after {doc['candidates_probed']} candidates, audit fallback "
        f"{bool(doc['audit'].get('fallback'))}; {wall:.2f} s, {len(sweep_walls)} sweeps of "
        f"{np.mean(sweep_walls) * 1e3:.1f} ms mean; == golden [{card}]")
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


def compare_explain_chunk(label: str, inputs, err) -> dict:
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
            raise AssertionError(f"phase 12: K20 differs from its plain version on the {label} ({name})")
    eb = tbd.ExplainBuffers(statics, state, pods, flags, k)
    log(f"phase 12: K20 equal to its plain version on the {label} ({len(pods[0])} pods x "
        f"N={statics.alloc.shape[0]}: counts, feasible, witnesses, fail codes; "
        f"{int(np.asarray(got[0]).sum())} eliminations); plain {plain_s:.2f} s")
    return {"pods": len(pods[0]), "n": int(statics.alloc.shape[0]), "plain_s": plain_s, "eb": eb}


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
    candidate, smoke.SOLVE_ITERS iterations): the first 5 iterations step by
    step (over and y), then y and the residual to the stated tolerances and
    the feasible sets equal; then their times at the capacity shape."""
    out = {}
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
        if (max(steps) > smoke.SOLVE_Y_ATOL or y_err > smoke.SOLVE_Y_ATOL or res_err > smoke.SOLVE_RES_ATOL
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
        if label == "capacity":
            timed_a, timed_b = a, b
    bound = relax_bound(timed_b)
    times = {}
    for name, launch, plain in (("relax_load", cuda.launch_relax_load, trelax.relax_load_plain),
                                ("relax_project", cuda.launch_relax_project, trelax.relax_project_plain)):
        times[name] = {"host_ms": time_call(lambda: launch(timed_b), 200),
                       "plain_ms": time_call(lambda: plain(timed_a), 3), **bound[name]}
    per, _, _ = profile_kernels(lambda: [(cuda.launch_relax_load(timed_b), cuda.launch_relax_project(timed_b))
                                         for _ in range(20)])
    run_ms = time_call(lambda: trelax.relax_run(timed_b, smoke.SOLVE_ITERS), 2)
    for name in RELAX_KERNELS:
        t = times[name]
        t["ms"] = per[name][0] / 1e3
        log(f"  {name}: {per[name][0]:.2f} us device (profiler), {t['host_ms'] * 1e3:.2f} us per back-to-back "
            f"launch from Python, plain {t['plain_ms'] * 1e3:.1f} us, {t['bytes']} B, {t['ops']} ops, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}) at the capacity relaxation "
            f"{tuple(out['capacity']['shape'])}")
    log(f"  relax_run ({smoke.SOLVE_ITERS} iterations, {2 * smoke.SOLVE_ITERS + 2} launches) at the capacity "
        f"relaxation: {run_ms:.2f} ms")
    return {"problems": out, "times": times, "run_ms": run_ms}


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
        per, _, _ = profile_kernels(lambda: [launch() for _ in range(20)])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"card: {card}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda.build()
    log(f"phase 1: built {len(cuda.KERNELS)} kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda.BUILD_INFO.get('seconds', 0.0):.1f} s)")
    for name in cuda.KERNELS:
        for line in cuda.BUILD_INFO.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

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

    # K11/K12 on the states the wave runs above left (written by K1-K4 and
    # K9/K10), K13 on K7's eviction and restore batches
    parts = {}
    for label, c_tensors, c_state in (("serial smoke problem", tensors, s_wbuf.state),
                                      ("extended problem", x_tensors, x_wbuf.state),
                                      ("rack problem", r_tensors, r_wbuf.state),
                                      ("keys problem", k_tensors, k_wbuf.state)):
        _, parts[label] = phase_compact(label, c_tensors, c_state, device, err)
    log("phase 2: K11/K12 equal to their plain versions (every compact field; the expansion equal to "
        "the state compressed, state_diff 0, no storage shared) on " + "; ".join(
            f"the {k} {v}" for k, v in parts.items()))
    x_start = phase_compact_delta(x_tensors, x_statics, run.state, packed, device, err)
    log(f"phase 2: K13 equal to its plain version and to the expand -> K7 -> compress route evicting "
        f"and restoring {len(entries)} placements on the extended carry; the round trip restores "
        "every compact field bit for bit")
    round_times, q_round_times, m_round_times, copy_times = phase_bulk_kernels(device, err)
    sweep_times = phase_sweep_kernels(device, err)
    relax_kernels = phase_relax_kernels(device, err)
    grow_times = phase_grow_kernels(device)

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
    log(f"  profiler, serial smoke K1-K4 over 2000 pods: {pwall:.3f} s wall, device busy {busy:.3f} "
        "of it; " + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in per.items()))
    x_per, x_busy, x_wall = phase_profile(x_statics, x_state, x_pods, x_flags, 2000)
    log(f"  profiler, extended K1-K6 over 2000 pods: {x_wall:.3f} s wall, device busy {x_busy:.3f} "
        "of it; " + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in x_per.items()))
    d_per, _, _ = profile_kernels(lambda: [delta_pair() for _ in range(20)])
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
    c_bytes["compact_delta"] = compact_delta_bytes(x_statics, run.state, x_start, packed[-1.0], x_tensors)
    c_per, _, _ = profile_kernels(lambda: [(sstate.compress_state(c_dev, c_state),
                                            sstate.expand_state(c_dev, c_carry, c_nds),
                                            compact_delta_pair()) for _ in range(20)])
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
    _, _, off_wall, _, _, _, _, _ = run_main_path(
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

    # -- phase 7: the large capacity plan (bulk + incremental) ---------------
    l_plan, l_launches, l_wall = run_large_capacity(card)

    # -- phases 8-11: the batched what-if sweeps -------------------------------
    serial_faults = run_serial_faults(card, err)
    bulk_faults, bulk_pc = run_bulk_faults(card, err)
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

    # K8's time at the capacity winner's log (M entries on the plan's nodes)
    w_tensors, w_e, w_nv = winner
    w_x = checker._upload(w_tensors, w_e, np.ones(w_tensors.n_nodes, bool) if w_nv is None else w_nv,
                          device)
    k8_ms = time_call(lambda: kaudit.audit_bulk(w_x), 200)
    k8_plain_ms = time_call(lambda: kaudit.audit_bulk_plain(w_x), 5)
    k8_per, _, _ = profile_kernels(lambda: [kaudit.audit_bulk(w_x) for _ in range(20)])
    x_per.update(k8_per)
    k8_bytes = audit_bytes(w_x)
    log(f"  audit_bulk: M={len(w_e.n)} N={w_tensors.n_nodes}: {k8_per['audit_bulk'][0]:.2f} us device "
        f"(profiler), {k8_ms * 1e3:.2f} us per back-to-back launch from Python, plain "
        f"{k8_plain_ms * 1e3:.1f} us, {k8_bytes} B")

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
                "ms_from": "profiler",
                "at": (f"the capacity relaxation {tuple(relax_kernels['problems']['capacity']['shape'])}"
                       if name in RELAX_KERNELS else t["at"]),
                "bytes": t["bytes"],
                **({"ops": t["ops"]} if name in RELAX_KERNELS else {}),
                **({"launches_by_path": {k: o["launches"].get(name, 0) for k, o in solver_paths.items()}}
                   if name in RELAX_KERNELS else {}),
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
                "ms_from": "profiler",
                "at": t["at"],
                "bytes": t["bytes"],
                "us_per_pod_step": t["us_per_pod_step"] if name == "sweep_place" else None,
                "main_path_us_per_launch": {"serial_k1": serial_faults["k1"]["us_per_launch"].get(name),
                                            "bulk_k2": bulk_faults["us_per_launch"].get(name)},
                "launches_bulk_faults_path": bulk_faults["launches"].get(name, 0),
                "launches_batched_capacity_path": batched_capacity["launches"].get(name, 0),
                "launches_resilience_plan_path": resilience_plan["launches"].get(name, 0),
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
                "library_ms": None,
                "host_ms": t["host_ms"],
                "launch_ms": launch_ms,
                "ms_from": "profiler",
                "at": t.get("round", "the bulk problem's compact carry"),
                "bytes": t["bytes"],
                "launches_bulk_path": b_launches.get(name, 0),
                "launches_large_capacity_path": l_launches.get(name, 0),
                **({"quota_round": q_round_times[name], "matrix_round": m_round_times[name]}
                   if name in ROUND_KERNELS else {"dense_carry": copy_times["dense"]}),
            })
            continue
        if name in WAVES:
            t = wave_times[name]
            mean_us = xw_per[name][0] if name in xw_per else w_per[name][0]
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
                "ms_from": "profiler",
                "run": {"kind": t["kind"], "pods": t["pods"], "us_per_pod_step": t["device_us"] / t["pods"]},
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
            "ms_from": "profiler" if prof else "cuda events",
            "launches_serial_path": launches.get(name, 0),
            "launches_capacity_path": c_launches.get(name, 0),
            "ms_extended": x_per[name][0] / 1e3 if name in x_per else None,
            "host_ms_extended": s_times[name][0] if name in s_times else None,
        })
    print(json.dumps({"kernels": rows, "card": card,
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
                      "relax_kernels": {"problems": relax_kernels["problems"], "run_ms": relax_kernels["run_ms"]},
                      "solver_paths": solver_paths, "grow_path": grow_path,
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
