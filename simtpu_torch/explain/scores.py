"""Score attribution: why did THIS node win, and by how much.

The port of the JAX package's `explain/scores.py`. For a placed pod,
decompose the winning score into its per-plugin terms (the registry score
plugins + the Simon/Open-Local/GPU-share extensions, weights from
`schedconfig`), name the runner-up node, and report the margin — per term.
`d(margin)/d(w_i) = raw_i(winner) - raw_i(runner_up)`, so the rows carry
the RAW (pre-weight) normalized term values beside the weighted
contributions.

Exactness: each attributed pod is re-evaluated against the state built
from the placement-log prefix BEFORE it (one `build_state` per pod, which
is why attribution is opt-in and capped): for engine-level runs that is
exactly the state its scheduling cycle saw, and the recomputed argmax is
pinned to equal the recorded node (`consistent`).

The evaluation is K1 -> (K5) -> (K6) -> K2 -> K21 `pod_terms`
(`kernels/csrc/pod_terms.cu`) on the card, K21 in the place K3 takes in
the serial step: the engine's total score (K3's code, bit for bit) and the
12 raw term rows. On the CPU `pod_terms` runs its plain version, built on
the textbook `filter_and_score`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..engine.scan import (
    StepBuffers,
    build_pod_arrays,
    filter_and_score,
    filter_pod,
    flags_from,
    gpu_pod,
    statics_from,
    storage_pod,
    topology_pod,
    topology_raws,
)
from ..engine.state import build_state
from ..kernels import cuda
from ..kernels.scores import (
    balanced_allocation,
    least_allocated,
    maxabs_normalize,
    minmax_normalize,
    selector_spread_from_counts,
    simon_share,
    spread_score_from_raw,
    taint_toleration_score,
)

#: attributed pods per call unless the caller asks for more — one
#: build_state + one [N] evaluation each
DEFAULT_MAX_PODS = 8


def extras_from_log(tensors, nodes_arr: np.ndarray, ext_log: dict) -> Dict[str, np.ndarray]:
    """Reconstruct `Engine.place`-shaped extras arrays ([P, ...] per-pod
    extended-resource allocations) from an engine's ext_log — the log
    appends placed pods in batch order, so scattering its rows back onto
    the placed batch rows recovers the per-row view `attribute_scores`
    consumes. Valid for engine-level runs whose log was not surgered (no
    preemption), the same contract as prefix-state exactness. (Not the
    auditor's `audit/checker.py extras_from_log`, which takes a
    PlacedCluster.)"""
    nodes_arr = np.asarray(nodes_arr)
    p = len(nodes_arr)
    ext = tensors.ext
    v = ext.vg_cap.shape[1]
    sd = ext.sdev_cap.shape[1]
    gd = ext.gpu_dev_total.shape[1]
    lvm = np.zeros((p, v), np.float32)
    dev = np.zeros((p, sd), bool)
    gpu = np.zeros((p, gd), np.float32)
    placed = np.flatnonzero(nodes_arr >= 0)
    for pos, j in enumerate(placed):
        if pos >= len(ext_log["vg_alloc"]):
            break
        lvm[j] = np.asarray(ext_log["vg_alloc"][pos])
        dev[j] = np.asarray(ext_log["sdev_take"][pos])
        gpu[j] = np.asarray(ext_log["gpu_shares"][pos])
    return {"lvm_alloc": lvm, "dev_take": dev, "gpu_shares": gpu}


#: the attribution's plugin rows, in `score_pod`'s term order:
#: (plugin name, schedconfig weight index)
PLUGIN_TERMS = (
    ("NodeResourcesLeastAllocated", 0),
    ("NodeResourcesBalancedAllocation", 1),
    ("Simon", 2),
    ("Open-Gpu-Share", 3),
    ("NodeAffinity", 4),
    ("TaintToleration", 5),
    ("InterPodAffinity", 6),
    ("PodTopologySpread", 7),
    ("SelectorSpread", 8),
    ("ImageLocality", 9),
    ("NodePreferAvoidPods", 11),
    ("Open-Local", 10),
)


def pod_terms_of(statics, state, pod, flags):
    """One pod against `state`: the engine's total score vector [N] (-inf
    outside m_all) and the per-plugin RAW (pre-weight) normalized term
    vectors [12, N] in PLUGIN_TERMS order, as the JAX package's
    `_eval_pod_terms` computes them. The terms are computed
    unconditionally: a family the pod has no term of gives the same
    constants the engine's skips use. The Open-Local raw term is
    `(score - score_nostorage) / w[10]` (0 where w[10] == 0; NaN outside
    m_all, where both scores are -inf)."""
    g, req = int(pod[0]), pod[1]
    ev = filter_and_score(statics, state, pod, flags)
    m_all = ev.m_all
    w10 = statics.score_w[10]
    raws = topology_raws(statics, state, g)
    least = least_allocated(state.free, statics.alloc, req)
    balanced = balanced_allocation(state.free, statics.alloc, req)
    simon = minmax_normalize(simon_share(statics.alloc, req), m_all)
    storage_raw = torch.where(w10 != 0, (ev.score - ev.score_nostorage) / torch.where(w10 == 0, 1.0, w10), 0.0)
    terms = torch.stack([
        least, balanced, simon, simon,
        minmax_normalize(statics.node_pref[g], m_all),
        taint_toleration_score(statics.taint_intol[g], m_all),
        maxabs_normalize(raws.ipa, m_all),
        spread_score_from_raw(raws.spread, m_all),
        selector_spread_from_counts(raws.ss_host, raws.ss_zone, statics.ss_zone[g].any(), m_all),
        statics.static_score[g], statics.avoid_pen[g], storage_raw,
    ]).to(torch.float32)
    return ev.score, terms


class TermsBuffers(StepBuffers):
    """A StepBuffers of the attributed pods, with K21's output rows
    `terms` [12, N] (its total score goes to `score`) and the host pod
    tuple the plain version reads."""

    def __init__(self, statics, state, pods, flags):
        super().__init__(statics, state, pods, flags)
        self.pods_host = pods
        self.terms = torch.zeros((len(PLUGIN_TERMS), statics.alloc.shape[0]), dtype=torch.float32,
                                 device=self.device)


def pod_terms_plain(buf: TermsBuffers, i: int) -> None:
    """Plain version of K21: pod i's score and raw term rows (`pod_terms_of`)
    into `buf.score` and `buf.terms`."""
    cuda.count_plain("pod_terms")
    host = buf.pods_host
    pod = (host[0][i], torch.as_tensor(host[1][i], device=buf.device)) + tuple(a[i] for a in host[2:])
    score, terms = pod_terms_of(buf.statics, buf.state, pod, buf.flags)
    buf.score.copy_(score)
    buf.terms.copy_(terms)


def pod_terms(buf: TermsBuffers, i: int) -> None:
    """K21 (`kernels/csrc/pod_terms.cu`) for pod i, after K1 -> (K5) ->
    (K6) -> K2 for it; the plain version for buffers on the CPU."""
    if buf.device.type == "cpu":
        pod_terms_plain(buf, i)
    else:
        cuda.launch_pod_terms(buf, i)


def eval_pod_terms(statics, state, pod, flags):
    """(score [N], terms [12, N]) of one pod tuple against `state`: K1 ->
    (K5) -> (K6) -> K2 -> K21 on the card, the plain version on the CPU."""
    buf = TermsBuffers(statics, state, tuple(np.asarray(a)[None] for a in pod), flags)
    if buf.device.type != "cpu":
        filter_pod(buf, 0)
        if buf.storage_live[0]:
            storage_pod(buf, 0)
        if buf.gpu_live[0]:
            gpu_pod(buf, 0)
        topology_pod(buf, 0)
    pod_terms(buf, 0)
    return buf.score, buf.terms


def attribute_scores(
    tensors,
    batch,
    nodes_arr: np.ndarray,
    extras: Dict[str, np.ndarray],
    *,
    rows: Optional[Sequence[int]] = None,
    max_pods: int = DEFAULT_MAX_PODS,
    sched_config=None,
    node_valid: Optional[np.ndarray] = None,
    device=None,
) -> List[Dict[str, object]]:
    """Per-plugin score decomposition for up to `max_pods` placed pods, on
    `device` (None = the CUDA card).

    `nodes_arr`/`extras` are one engine placement's outputs over `batch`
    (`Engine.place`); `rows` selects batch rows to attribute (default: the
    first `max_pods` placed rows). Returns one document per pod: winner,
    runner-up, margin, and per-term rows with weight, raw winner/runner-up
    values, and the weighted delta (the term's contribution to the
    margin)."""
    device = resolve_device(device)
    nodes_arr = np.asarray(nodes_arr)
    placed = np.flatnonzero(nodes_arr >= 0)
    if rows is None:
        rows = placed[: max(int(max_pods), 0)]
    else:
        rows = np.asarray(list(rows), np.int64)[: max(int(max_pods), 0)]
    if not len(rows):
        return []
    flags = flags_from(tensors, batch.ext)
    statics = statics_from(tensors, sched_config, device)
    if node_valid is not None:
        statics = statics._replace(
            node_valid=statics.node_valid & torch.as_tensor(np.asarray(node_valid, bool), device=device))
    r_res = tensors.alloc.shape[1]
    req_pad, pods = build_pod_arrays(batch, r_res)
    from ..core.objects import name_of, namespace_of
    from ..schedconfig import DEFAULT_WEIGHTS

    weights = np.asarray(
        sched_config.score_weights if sched_config is not None else DEFAULT_WEIGHTS, np.float32)
    node_names = list(tensors.node_names)
    out: List[Dict[str, object]] = []
    for j in rows:
        j = int(j)
        # the placement-log prefix before batch row j: every earlier placed
        # row, in batch order (engine-level log order)
        prefix = placed[placed < j]
        state = build_state(
            tensors,
            np.asarray(batch.group)[prefix].astype(np.int32),
            nodes_arr[prefix].astype(np.int32),
            req_pad[prefix].astype(np.float32),
            {
                "node": nodes_arr[prefix].tolist(),
                "vg_alloc": list(np.asarray(extras["lvm_alloc"])[prefix]),
                "sdev_take": list(np.asarray(extras["dev_take"])[prefix]),
                "gpu_shares": list(np.asarray(extras["gpu_shares"])[prefix]),
                "gpu_mem": np.asarray(batch.ext["gpu_mem"])[prefix].tolist(),
            },
            device,
        )
        pod = tuple(np.asarray(arr)[j] for arr in pods)
        score_dev, terms_dev = eval_pod_terms(statics, state, pod, flags)
        score = score_dev.cpu().numpy()
        term_mat = terms_dev.cpu().numpy()
        order = np.argsort(-score, kind="stable")
        winner = int(order[0])
        runner = int(order[1]) if len(order) > 1 and np.isfinite(score[order[1]]) else -1
        recorded = int(nodes_arr[j])
        margin = float(score[winner] - score[runner]) if runner >= 0 else None
        terms = []
        for t, (name, widx) in enumerate(PLUGIN_TERMS):
            rw = float(term_mat[t, winner])
            rr = float(term_mat[t, runner]) if runner >= 0 else None
            wgt = float(weights[widx])
            terms.append(
                {
                    "plugin": name,
                    "weight": wgt,
                    "winner_raw": round(rw, 6),
                    "runner_up_raw": None if rr is None else round(rr, 6),
                    "delta": None if rr is None else round(wgt * (rw - rr), 6),
                }
            )
        pod_obj = batch.pods[j] if batch.pods else None
        out.append(
            {
                "pod": (
                    f"{namespace_of(pod_obj)}/{name_of(pod_obj)}"
                    if pod_obj is not None
                    else f"pod[{j}]"
                ),
                "row": j,
                "node": node_names[recorded] if 0 <= recorded < len(node_names) else "",
                "winner": node_names[winner] if 0 <= winner < len(node_names) else "",
                "runner_up": node_names[runner] if 0 <= runner < len(node_names) else "",
                "margin": None if margin is None else round(margin, 6),
                # pinned for engine-level runs: the recomputed argmax IS the
                # recorded landing node (prefix-state exactness)
                "consistent": winner == recorded,
                "terms": terms,
            }
        )
    return out
