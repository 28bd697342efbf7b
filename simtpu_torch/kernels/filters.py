"""Filter functions: each returns a boolean feasibility mask over all nodes.

The plain PyTorch form of the JAX package's `kernels/filters.py`, function
for function and operation for operation, so that the results are
bit-identical. These are the CPU path of the per-pod step and the oracle of
its CUDA kernels (`kernels/csrc/filter_pod.cu`, `topology_pod.cu`).

Stateless filters (NodeUnschedulable, TaintToleration, NodeAffinity/selector,
NodeName pinning) are precomputed per pod-group in core/tensorize.py; the
functions here are the ones that depend on mutable scheduling state.
"""

from __future__ import annotations

import torch

from .fp import fma

# Relative slack for float32 resource comparisons; the reference compares exact
# integer milli-quantities, so allow only rounding-level drift.
_RES_EPS = 1e-5
_F32 = torch.float32


def resources_fit(free: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit: every requested resource fits in the node's free
    allocatable (incl. the synthetic `pods` count resource).

    free: [N, R], req: [R] → mask [N]. `free + slack` is one fused
    multiply-add, as XLA compiles it (kernels/fp.py).
    """
    m = torch.maximum(free.abs(), torch.ones((), dtype=_F32, device=free.device))
    return (fma(_RES_EPS, m, free) >= req).all(dim=-1)


def ports_conflict_free(ports_used: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """NodePorts: no requested (protocol, hostPort) pair already in use on the
    node. ports_used: [N, P] in-use counts, want: [P] bool → mask [N]."""
    return ~(want[None, :] & (ports_used > 0)).any(dim=-1)


def volume_conflict_free(
    vols_any: torch.Tensor,  # [N, W] users (rw or ro) of exclusive volume w
    vols_rw: torch.Tensor,  # [N, W] read-write users of volume w
    want_rw: torch.Tensor,  # [W] bool — pod mounts volume w read-write
    want_ro: torch.Tensor,  # [W] bool — pod mounts volume w read-only
) -> torch.Tensor:
    """VolumeRestrictions: a read-write mount conflicts with any existing
    user of the same volume; a read-only mount conflicts with an existing
    read-write user. Returns [N]."""
    rw_conflict = (want_rw[None, :] & (vols_any > 0)).any(dim=-1)
    ro_conflict = (want_ro[None, :] & (vols_rw > 0)).any(dim=-1)
    return ~(rw_conflict | ro_conflict)


def attach_limits_ok(
    vols_any: torch.Tensor,  # [N, W] users of volume w on node n
    want_att: torch.Tensor,  # [W] bool — pod attaches volume w
    class_mask: torch.Tensor,  # [C, W] bool — volume w belongs to attach class c
    limits: torch.Tensor,  # [N, C] per-node attach limits
) -> torch.Tensor:
    """NodeVolumeLimits: per class, unique volumes already attached to the
    node plus the pod's volumes not yet on the node must stay within the
    node's limit; a class the pod adds nothing to never filters. The sums
    are counts, exact in f32 in any order. Returns [N]."""
    present = (vols_any > 0).to(_F32)  # [N, W]
    cm = class_mask.to(_F32)  # [C, W]
    used = present @ cm.T  # [N, C] unique volumes on node per class
    new = ((1.0 - present) * want_att.to(_F32)[None, :]) @ cm.T
    return ((new == 0) | (used + new <= limits)).all(dim=-1)


def topology_spread_filter(
    cnt_at: torch.Tensor,  # [T, N] placed pods matching term t at node n's domain
    valid: torch.Tensor,  # [T, N] node carries term t's topology key
    max_skew: torch.Tensor,  # [T] maxSkew of DoNotSchedule constraints (0 = inactive)
    elig_nodes: torch.Tensor,  # [N] nodes eligible for the pod (static mask)
) -> torch.Tensor:
    """PodTopologySpread hard filter: placing on node n must keep
    `count(domain of n) + 1 - min count over eligible domains <= maxSkew`
    for every DoNotSchedule constraint; nodes missing the topology key are
    infeasible for that constraint. The minimum is the per-node masked
    minimum of `cnt_at` over eligible nodes."""
    t_count, n = cnt_at.shape
    if t_count == 0:
        return torch.ones(n, dtype=torch.bool, device=cnt_at.device)
    active = max_skew > 0
    inf = 3.4e38
    elig = valid & elig_nodes[None, :]
    min_cnt = torch.where(elig, cnt_at, inf).amin(dim=1)  # [T]
    min_cnt = torch.where(min_cnt >= inf, 0.0, min_cnt)
    ok_tn = (~active[:, None]) | (
        valid & (cnt_at + 1.0 - min_cnt[:, None] <= max_skew[:, None])
    )
    return ok_tn.all(dim=0)


def interpod_filter(
    cnt_at: torch.Tensor,  # [T, N] placed pods matching term t at node n's domain
    own_anti_at: torch.Tensor,  # [T, N] placed owners of required anti term t
    valid: torch.Tensor,  # [T, N] node carries term t's topology key
    cnt_total: torch.Tensor,  # [T] cluster-wide matching count per term
    s_match: torch.Tensor,  # [T] incoming pod matches term selector+ns
    a_aff: torch.Tensor,  # [T] incoming pod requires affinity term t
    a_anti: torch.Tensor,  # [T] incoming pod requires anti-affinity term t
) -> torch.Tensor:
    """InterPodAffinity filter over all nodes: required affinity terms need
    a matching placed pod in the node's domain (with the first-pod-in-series
    escape), required anti-affinity terms and existing pods' anti-affinity
    that selects the incoming pod forbid a shared domain. Returns [N]."""
    t_count, n = cnt_at.shape
    if t_count == 0:
        return torch.ones(n, dtype=torch.bool, device=cnt_at.device)
    anti_violated = (a_anti[:, None] & (cnt_at > 0)).any(dim=0)  # [N]
    sym_violated = (s_match[:, None] & (own_anti_at > 0)).any(dim=0)
    aff_term_ok = (~a_aff[:, None]) | (valid & (cnt_at > 0))  # [T, N]
    aff_ok = aff_term_ok.all(dim=0)
    total_match = torch.where(a_aff, cnt_total, 0.0).sum()
    self_ok = (
        (total_match == 0)
        & torch.where(a_aff, s_match, True).all()
        & ((~a_aff[:, None]) | valid).all(dim=0)
    )
    aff_ok = aff_ok | (a_aff.any() & self_ok)
    return aff_ok & ~anti_violated & ~sym_violated
