"""Score functions: each returns a float score vector over all nodes.

The plain PyTorch form of the JAX package's `kernels/scores.py`, operation
for operation, so that the results are bit-identical: the CPU path of the
per-pod step and the oracle of `kernels/csrc/score_argmax_pod.cu`.

Normalization mirrors each plugin's NormalizeScore; scores are computed over
the full node axis but normalized over the feasible mask only. The products
over the term axis (`soft_w @ cnt_at` and the like) sum integer-valued
floats: exact in any order below 2^24, so their summation order is free.
"""

from __future__ import annotations

import torch

from ..core.tensorize import RES_CPU, RES_MEMORY
from .fp import fma

MAX_NODE_SCORE = 100.0
_BIG = 3.4e38
_TINY = 1e-30
_F32 = torch.float32
#: SelectorSpread's zone weighting, rounded to f32 as the JAX package does
ZONE_WEIGHT = torch.tensor(2.0 / 3.0, dtype=_F32)


def _clamp_min(x: torch.Tensor, lo: float) -> torch.Tensor:
    """jnp.maximum(x, lo) with lo rounded to f32."""
    return torch.maximum(x, torch.tensor(lo, dtype=_F32, device=x.device))


def minmax_normalize(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Min-max to [0, 100] over feasible nodes (SimonPlugin.NormalizeScore;
    same default for NodeAffinity)."""
    lo = torch.where(mask, score, _BIG).amin()
    hi = torch.where(mask, score, -_BIG).amax()
    rng = hi - lo
    return torch.where(
        rng > 0, (score - lo) * MAX_NODE_SCORE / _clamp_min(rng, _TINY), 0.0
    )


def maxabs_normalize(score: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scale by max |score| to [-100, 100] (InterPodAffinity NormalizeScore)."""
    m = torch.where(mask, score.abs(), 0.0).amax()
    return torch.where(m > 0, score * MAX_NODE_SCORE / _clamp_min(m, _TINY), 0.0)


def least_allocated(
    free: torch.Tensor, alloc: torch.Tensor, req: torch.Tensor
) -> torch.Tensor:
    """NodeResourcesLeastAllocated over cpu+memory: mean of free-fraction ×
    100 after placing the pod."""
    cols = [RES_CPU, RES_MEMORY]
    fa = free[:, cols] - req[cols]  # [N, 2] free after placement
    al = alloc[:, cols]
    frac = torch.where(al > 0, fa.clamp(min=0.0) / _clamp_min(al, _TINY), 0.0)
    return (frac[:, 0] + frac[:, 1]) / 2.0 * MAX_NODE_SCORE


def balanced_allocation(
    free: torch.Tensor, alloc: torch.Tensor, req: torch.Tensor
) -> torch.Tensor:
    """NodeResourcesBalancedAllocation (two-resource form):
    100 - |cpuFrac - memFrac|·100."""
    cols = [RES_CPU, RES_MEMORY]
    al = alloc[:, cols]
    used_after = al - free[:, cols] + req[cols]
    frac = torch.where(al > 0, used_after / _clamp_min(al, _TINY), 1.0)
    return (1.0 - (frac[:, 0] - frac[:, 1]).abs()) * MAX_NODE_SCORE


def _dominant_share(alloc: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """Simon's dominant share before the ×100: max over the resources the
    node allocates of req / (alloc - req), floored at 0."""
    req_b = req[None, :].expand_as(alloc)
    denom = alloc - req_b  # [N, R]
    zero_denom = denom == 0
    share = torch.where(
        zero_denom,
        torch.where(req_b == 0, 0.0, 1.0),
        req_b / torch.where(zero_denom, 1.0, denom),
    )
    share = torch.where(alloc > 0, share, 0.0)
    return share.amax(dim=-1).clamp(min=0.0)


def simon_share(alloc: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """Simon plugin raw score: dominant share of the pod request against
    (static allocatable − request), per node, ×100."""
    return _dominant_share(alloc, req) * MAX_NODE_SCORE


def taint_toleration_score(intolerable_cnt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """TaintToleration score: fewer intolerable PreferNoSchedule taints →
    higher, reverse-normalized to [0, 100]."""
    hi = torch.where(mask, intolerable_cnt, 0.0).amax()
    return torch.where(
        hi > 0,
        MAX_NODE_SCORE * (1.0 - intolerable_cnt / _clamp_min(hi, _TINY)),
        MAX_NODE_SCORE,
    )


def spread_score_from_raw(raw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The inverse-min-max of `topology_spread_score` applied to an already
    summed [N] raw count vector."""
    lo = torch.where(mask, raw, _BIG).amin()
    hi = torch.where(mask, raw, -_BIG).amax()
    rng = hi - lo
    return torch.where(
        rng > 0,
        MAX_NODE_SCORE * (hi - raw) / _clamp_min(rng, _TINY),
        MAX_NODE_SCORE,
    )


def topology_spread_score(
    cnt_at: torch.Tensor,  # [T, N] matching placed pods at each node's domain
    soft_w: torch.Tensor,  # [T] ScheduleAnyway constraint multiplicity
    mask: torch.Tensor,  # [N] feasible nodes
) -> torch.Tensor:
    """PodTopologySpread score: lower matching count in the node's domains →
    higher score, inverse-min-max to [0, 100]."""
    return spread_score_from_raw(soft_w @ cnt_at, mask)


def selector_spread_compose(
    cnt_host: torch.Tensor,  # [N] matching placed pods on each node
    cnt_zone: torch.Tensor,  # [N] matching placed pods in each node's zone
    max_host: torch.Tensor,  # scalar — max of cnt_host over feasible nodes (0-floored)
    max_zone: torch.Tensor,  # scalar — max of cnt_zone over feasible nodes (0-floored)
    any_zone_terms,  # bool scalar — the pod has zone-key counting terms
) -> torch.Tensor:
    """`selector_spread_score`'s normalization with the masked maxima given.
    The zone blend is `fma(zw, zone, (1 - zw) * node)`: the contraction
    XLA's CPU backend emits for this expression."""
    node_score = torch.where(
        max_host > 0,
        MAX_NODE_SCORE * (max_host - cnt_host) / _clamp_min(max_host, _TINY),
        MAX_NODE_SCORE,
    )
    zone_score = torch.where(
        max_zone > 0,
        MAX_NODE_SCORE * (max_zone - cnt_zone) / _clamp_min(max_zone, _TINY),
        MAX_NODE_SCORE,
    )
    zw = ZONE_WEIGHT.to(cnt_host.device)
    have_zones = torch.as_tensor(any_zone_terms, device=cnt_host.device) & (max_zone > 0)
    return torch.where(have_zones, fma(zw, zone_score, (1.0 - zw) * node_score), node_score)


def selector_spread_from_counts(
    cnt_host: torch.Tensor,
    cnt_zone: torch.Tensor,
    any_zone_terms,
    mask: torch.Tensor,
) -> torch.Tensor:
    """`selector_spread_score`'s normalization on already summed host/zone
    count vectors."""
    return selector_spread_compose(
        cnt_host,
        cnt_zone,
        torch.where(mask, cnt_host, 0.0).amax(),
        torch.where(mask, cnt_zone, 0.0).amax(),
        any_zone_terms,
    )


def selector_spread_score(
    cnt_at: torch.Tensor,  # [T, N] matching placed pods at each node's domain
    ss_host: torch.Tensor,  # [T] hostname-key counting terms of the pod
    ss_zone: torch.Tensor,  # [T] zone-key counting terms
    mask: torch.Tensor,  # [N]
) -> torch.Tensor:
    """SelectorSpread score: spread pods of the same service/controller
    across nodes, then zones with zoneWeighting=2/3 when zones exist."""
    return selector_spread_from_counts(
        ss_host.to(_F32) @ cnt_at,
        ss_zone.to(_F32) @ cnt_at,
        ss_zone.any(),
        mask,
    )


def interpod_score(
    cnt_at: torch.Tensor,  # [T, N] matching placed pods at each node's domain
    own_aff_at: torch.Tensor,  # [T, N] placed owners of required affinity terms
    w_own_aff_at: torch.Tensor,  # [T, N] summed preferred-affinity owner weights
    w_own_anti_at: torch.Tensor,  # [T, N]
    s_match: torch.Tensor,  # [T] incoming pod matches term
    w_aff_pref: torch.Tensor,  # [T] incoming pod's preferred affinity weights
    w_anti_pref: torch.Tensor,  # [T]
    hard_pod_affinity_weight: float = 1.0,
) -> torch.Tensor:
    """InterPodAffinity raw score (caller applies maxabs_normalize): weight ×
    matching placed pods in domain for the incoming pod's preferred terms,
    plus placed pods' preferred terms (and required affinity terms, scaled
    by HardPodAffinityWeight=1) that select the incoming pod."""
    incoming = (w_aff_pref - w_anti_pref) @ cnt_at
    symmetric = s_match.to(_F32) @ (
        w_own_aff_at - w_own_anti_at + hard_pod_affinity_weight * own_aff_at
    )
    return incoming + symmetric


# -- the step's composition, as the compiled reference computes it ----------
#
# The JAX package's engine compiles its scan step with the score weights as
# a runtime argument (StaticArrays.score_w), and XLA's CPU backend lets
# LLVM contract some `a * b + c` into one FMA. Read off the compiled scan
# (its optimized HLO, `XLA_FLAGS=--xla_dump_to`) and pinned by
# tests/test_torch_kernels.py and tests/test_torch_extended.py against a
# scan that also returns its scores, with the default and with custom
# weights:
# - the resource pair is `frac_sum * (w0 * 50) + (1 - |d|) * (w1 * 100)`,
#   two rounded products and a rounded sum (XLA folds the constant
#   factors: `w0 * (mean * 100)` becomes `frac_sum * (w0 * 50)`);
# - the Simon term is one FMA, `fma(w2 + w3, x, score)`, except when the
#   node-affinity term follows it (StepFlags.node_pref): then it is added
#   with two roundings; its numerator `share * 100 - lo` is contracted;
# - every later term of the running sum is one FMA, `fma(w, term, score)`
#   (node affinity, taint, inter-pod, soft spread, SelectorSpread, and the
#   Open-Local term after the mask);
# - the static pair is `score + fma(w9, image, w11 * avoid)`.
# With the default weights (1 and 2) every product by a weight is exact,
# so an FMA there rounds like the two-rounding form.


def resource_base_score(
    free: torch.Tensor, alloc: torch.Tensor, req: torch.Tensor, w_least, w_balanced
) -> torch.Tensor:
    """`w_least * least_allocated + w_balanced * balanced_allocation` as the
    compiled step computes it: frac_sum * (w_least * 50) + (1 - |cpuFrac -
    memFrac|) * (w_balanced * 100), each product rounded."""
    cols = [RES_CPU, RES_MEMORY]
    al = alloc[:, cols]
    fa = free[:, cols] - req[cols]
    frac = torch.where(al > 0, fa.clamp(min=0.0) / _clamp_min(al, _TINY), 0.0)
    used_after = al - free[:, cols] + req[cols]
    bfrac = torch.where(al > 0, used_after / _clamp_min(al, _TINY), 1.0)
    balanced = (1.0 - (bfrac[:, 0] - bfrac[:, 1]).abs()) * (w_balanced * MAX_NODE_SCORE)
    return (frac[:, 0] + frac[:, 1]) * (w_least * 50.0) + balanced


def simon_minmax(alloc: torch.Tensor, req: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`minmax_normalize(simon_share(alloc, req), mask)` as the compiled
    step computes it: the extremes come from the rounded ×100 shares, the
    numerator is fma(share, 100, -lo)."""
    share = _dominant_share(alloc, req)
    raw = share * MAX_NODE_SCORE
    lo = torch.where(mask, raw, _BIG).amin()
    hi = torch.where(mask, raw, -_BIG).amax()
    rng = hi - lo
    num = fma(share, MAX_NODE_SCORE, -lo)
    return torch.where(rng > 0, num * MAX_NODE_SCORE / _clamp_min(rng, _TINY), 0.0)
