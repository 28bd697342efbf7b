#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (simtpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure ends the run with a non-zero exit; none is caught):

1. the card's name and power limit (nvidia-smi); build the four per-pod
   CUDA kernels from `simtpu_torch/kernels/csrc/` (nvcc, sm_90a);
2. each kernel against its plain PyTorch version on the card, on the
   tensorized smoke problem (1000 nodes x 10 000 pods) with a seeded
   placement log, pod by pod: stage bits, argmax and reason must be equal,
   and the state planes after the commit; then each kernel's time per
   launch, its plain version's and the bytes bound;
3. the main path: `simtpu_torch.simulate(device="cuda")` on the smoke
   problem. Every kernel must have launched once per pod, no plain
   version may have run, and the placements and reasons must equal the
   golden file the JAX package produced on the CPU;
4. the demo example (examples/cluster/demo + application/web): every pod
   placed, as on the CPU path.

The line before the last is the JSON `{"kernels": [...]}`; the last line is
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when
no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import simtpu_torch
from simtpu_torch import smoke
from simtpu_torch.constants import LABEL_APP_NAME
from simtpu_torch.core.objects import set_label
from simtpu_torch.core.tensorize import Tensorizer
from simtpu_torch.device import configure_numerics
from simtpu_torch.engine import scan
from simtpu_torch.engine.state import build_state
from simtpu_torch.io.cluster import create_cluster_resource_from_cluster_config
from simtpu_torch.io.yaml_loader import load_resources
from simtpu_torch.kernels import cuda
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
}
WRAPPERS = {
    "filter_pod": (scan.filter_pod, scan.filter_pod_plain),
    "topology_pod": (scan.topology_pod, scan.topology_pod_plain),
    "score_argmax_pod": (scan.score_argmax_pod, scan.score_argmax_pod_plain),
    "commit_pod": (scan.commit_pod, scan.commit_pod_plain),
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
    tz = Tensorizer(cluster.nodes)
    batch = tz.add_pods(pods)
    tensors = tz.freeze()
    _, pod_arrays = scan.build_pod_arrays(batch, tensors.alloc.shape[1])
    rng = np.random.default_rng(7)
    k = log_len
    log_g = rng.integers(0, len(tensors.groups), k).astype(np.int32)
    log_n = rng.integers(0, tensors.n_nodes, k).astype(np.int32)
    log_r = pod_arrays[1][rng.integers(0, len(pod_arrays[0]), k)]
    state = build_state(tensors, log_g, log_n, log_r, None, device)
    statics = scan.statics_from(tensors, None, device)
    return tensors, batch, statics, state, pod_arrays


def smoke_batch(device):
    """The smoke problem (1000 nodes x 10 000 pods), 3000 logged placements."""
    return tensorized_batch(*smoke.smoke_problem(synth_cluster, synth_apps), device, 3000)


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


def state_diff(a, b) -> float:
    worst = 0.0
    for x, y in zip(a, b):
        if x.numel():
            if x.dtype == torch.bool:
                worst = max(worst, float((x != y).any()))
            else:
                worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst


def score_diff(a, b) -> float:
    fin = torch.isfinite(a)
    if not torch.equal(fin, torch.isfinite(b)) or not torch.equal(a[~fin], b[~fin]):
        raise AssertionError("score_argmax_pod: -inf lanes differ from the plain version")
    return float((a[fin].double() - b[fin].double()).abs().max()) if fin.any() else 0.0


def phase_compare(statics, state, pods, flags, n_sample, err):
    """Each kernel against its plain version on identical inputs, pod by
    pod along a seeded sample of the batch; `err` collects the largest
    difference per kernel. Returns the kernel side's buffers."""
    kbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    pbuf = scan.StepBuffers(statics, clone_state(state), pods, flags)
    rng = np.random.default_rng(11)
    sample = np.sort(rng.choice(kbuf.n_pods, min(n_sample, kbuf.n_pods), replace=False))
    for i in map(int, sample):
        copy_state(pbuf.state, kbuf.state)
        scan.filter_pod(kbuf, i)
        scan.filter_pod_plain(pbuf, i)
        torch.cuda.synchronize()
        if not torch.equal(kbuf.stage & 0x3F, pbuf.stage & 0x3F):
            raise AssertionError(f"filter_pod: stage bits differ at pod {i}")
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
        err["commit_pod"] = max(err["commit_pod"], state_diff(kbuf.state, pbuf.state))
    if err["commit_pod"] or err["topology_pod"]:
        raise AssertionError(f"state or raw counts differ from the plain versions: {err}")
    return kbuf


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
    """Bytes each kernel must move for pod i (each input read once, each
    output written once), from this run's shapes and this pod's terms."""
    st, s = buf.statics, buf.state
    n, r = st.alloc.shape
    p, w, c = st.ports_req.shape[1], st.vol_rw_req.shape[1], st.vol_class_mask.shape[0]
    g = int(buf.group[i])
    terms = st.g_terms[g]
    terms = terms[terms >= 0]
    tv = int(terms.numel())
    ti = int((st.ip_of[terms.long()] >= 0).sum()) if tv else 0
    f4 = 4
    k1 = n * r * f4 + n * p * f4 + 2 * n * w * f4 + n * c * f4 + 3 * n + n  # + stage out
    k2 = n + tv * 2 * n * f4 + ti * 4 * n * f4 + n + 4 * n * f4
    k3 = n + 4 * n * f4 + n * r * f4 + n * 2 * f4 + 4 * n * f4 + n * f4
    k4 = tv * n * f4 + 2 * tv * n * f4 + 2 * ti * 4 * n * f4 + 2 * r * f4 + 2 * (p + 2 * w) * f4
    return {"filter_pod": k1, "topology_pod": k2, "score_argmax_pod": k3, "commit_pod": k4}


def phase_timing(kbuf):
    """Per-launch time of each kernel and of its plain version on the card,
    at the sampled pod with the most term rows."""
    st = kbuf.statics
    counts = [(int((st.g_terms[int(kbuf.group[i])] >= 0).sum()), i) for i in range(0, kbuf.n_pods, 97)]
    i = max(counts)[1]
    scratch = scan.StepBuffers(st, clone_state(kbuf.state), (kbuf.group.cpu(), kbuf.req.cpu(),
                               kbuf.pin.cpu(), kbuf.forced.cpu()), kbuf.flags)
    out = {}
    for name, (wrapper, plain) in WRAPPERS.items():
        ms = time_call(lambda: wrapper(scratch, i), 2000)
        plain_ms = time_call(lambda: plain(scratch, i), 20)
        out[name] = (ms, plain_ms)
    launch_ms = time_call(lambda: cuda.launch_noop(kbuf.device), 2000)
    return out, launch_ms, kernel_bytes(scratch, i), i


def phase_profile(statics, state, pods, flags, n_pods: int):
    """Device time per kernel and the device's busy share over the K1-K4
    loop of `n_pods` pods (torch.profiler's CUDA activity). Returns
    ({kernel: (device us per launch, launches)}, busy share, wall s)."""
    from torch.profiler import ProfilerActivity, profile

    buf = scan.StepBuffers(statics, clone_state(state), tuple(x[:n_pods] for x in pods), flags)
    scan.run_batch(scan.StepBuffers(statics, clone_state(state), tuple(x[:8] for x in pods), flags))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan.run_batch(buf)
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
    tensors, batch, statics, state, pods = smoke_batch(device)
    flags = scan.flags_from(tensors, batch.ext)
    log(f"phase 2: smoke shape N={tensors.n_nodes} T={tensors.n_terms} G={len(tensors.groups)} "
        f"Tc={statics.g_terms.shape[1]} pods={len(pods[0])} flags={flags}")
    err = dict.fromkeys(KERNELS, 0.0)
    kbuf = phase_compare(statics, state, pods, flags, N_SAMPLE, err)
    phase_compare(statics, state, pods, scan.StepFlags(), N_SAMPLE // 2, err)
    e_tensors, e_batch, e_statics, e_state, e_pods = edge_batch(device)
    edge_buf = phase_compare(e_statics, e_state, e_pods, scan.StepFlags(), len(e_pods[0]), err)
    reasons = sorted(set(edge_buf.reason.tolist()))
    log(f"phase 2: K1-K4 equal to their plain versions on {N_SAMPLE} smoke pods (derived flags), "
        f"{N_SAMPLE // 2} (all flags) and the edge problem (reasons {reasons}); "
        f"max |score diff| {err['score_argmax_pod']}")
    times, launch_ms, nbytes, ti = phase_timing(kbuf)
    for name, (host_ms, plain_ms) in times.items():
        log(f"  {name}: {host_ms * 1e3:.2f} us per back-to-back launch from Python, plain "
            f"{plain_ms * 1e3:.1f} us, {nbytes[name]} B (pod {ti})")
    log(f"  empty launch: {launch_ms * 1e3:.2f} us")

    per, busy, pwall = phase_profile(statics, state, pods, flags, 2000)
    log(f"  profiler, K1-K4 over 2000 pods: {pwall:.3f} s wall, device busy {busy:.3f} of it; "
        + ", ".join(f"{k} {v[0]:.2f} us x {v[1]}" for k, v in per.items()))

    # -- phase 3: the main path --------------------------------------------
    cluster, apps = smoke.smoke_problem(synth_cluster, synth_apps)
    cuda.reset_counts()
    seed_name_hashes(smoke.NAME_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = simtpu_torch.simulate(cluster, apps, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seed_name_hashes(None)
    launches = dict(cuda.LAUNCHES)
    plain_calls = sum(cuda.PLAIN_CALLS.values())
    record = smoke.placement_record(result)
    n_pods = len(record["placed"]) + len(record["failed"])
    short = [k for k in KERNELS if launches.get(k, 0) < n_pods]
    if short or plain_calls:
        raise AssertionError(f"main path: launches {launches} for {n_pods} pods, plain calls {plain_calls}")
    diffs = smoke.record_differences(record, smoke.load_record())
    if diffs:
        raise AssertionError("main path differs from the golden placements:\n" + "\n".join(diffs))
    log(f"phase 3: simulate(device='cuda') {smoke.N_NODES} nodes x {n_pods} pods: {wall:.2f} s, "
        f"{n_pods / wall:.0f} pods/s, {len(record['failed'])} unscheduled, placements == golden "
        f"[{card}]")

    # -- phase 4: the demo example -----------------------------------------
    demo = create_cluster_resource_from_cluster_config(str(REPO / "examples/cluster/demo"))
    web = simtpu_torch.AppResource(name="web", resource=load_resources(str(REPO / "examples/application/web")))
    seed_name_hashes(1)
    res = simtpu_torch.simulate(demo, [web], device="cuda")
    seed_name_hashes(1)
    ref = simtpu_torch.simulate(demo, [web], device="cpu")
    seed_name_hashes(None)
    got, want = smoke.placement_record(res), smoke.placement_record(ref)
    if got["failed"] or got != want:
        raise AssertionError(f"demo example: {len(got['failed'])} unscheduled, equal to CPU: {got == want}")
    log(f"phase 4: demo example, {len(got['placed'])} pods placed, equal to the CPU path")

    rows = []
    busy_s = 0.0
    for name, replaces in KERNELS.items():
        host_ms, plain_ms = times[name]
        # the kernel's own time on the card (profiler); the back-to-back
        # launch time from Python (host_ms) is bound by the launch path
        ms = per[name][0] / 1e3 if name in per else host_ms
        busy_s += ms / 1e3 * launches[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"simtpu_torch/kernels/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
            "host_ms": host_ms,
            "launch_ms": launch_ms,
            "ms_from": "profiler" if name in per else "cuda events",
        })
    print(json.dumps({"kernels": rows, "card": card, "wall_s": wall, "pods_per_s": n_pods / wall,
                      "loop_device_busy": busy, "simulate_device_busy": busy_s / wall}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
