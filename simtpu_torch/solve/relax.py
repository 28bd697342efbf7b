"""Batched assignment relaxation: the solve backend's convex core.

The JAX package's `solve/relax.py`. The capacity question "do these pods
fit on base + i clones?" is, after tensorization, a transportation
problem: interchangeable pods of one (group, request) CLASS are
distributed over the nodes their group's static/volume feasibility planes
allow, without exceeding any node's remaining allocatable vector.
Dropping integrality gives a convex feasibility problem per candidate
count, and the candidates differ only in the `node_valid` membership mask,
so every candidate is solved in one projected-gradient run over the
candidate axis.

Per candidate the solve minimizes the overcommit penalty

    f(y) = 1/2 * sum_{n,r} relu( (y^T req)[n,r] - free[n,r] )^2

over the product of per-class simplices {y[c,:] >= 0 off-mask-zero,
sum_n y[c,n] = cnt[c]} by projected gradient with an exact sort-based
simplex projection; the step is 0.9 / sigma_max(req)^2.

- residual <= RESIDUAL_TOL says the relaxation is (numerically) feasible:
  a necessary condition for any integral placement;
- infeasibility is never concluded from non-convergence: the planner
  builds a float64 weak-duality certificate on the host from the
  boundary candidate's y (`infeasibility_certificate`).

The run, per relaxation: `relax_project` in its init mode (the start point
cnt / nfeas on each class's feasible valid nodes), then `iters` times
`relax_load` (per candidate and node, the load of every resource and its
overcommit) and `relax_project` (per candidate and class, the gradient
step and the exact projection), then `relax_load` in its residual mode
(the largest overcommit per candidate, +inf when a class with demand has
no feasible valid node). On CUDA tensors these are K22
(`kernels/csrc/relax_load.cu`) and K23 (`kernels/csrc/relax_project.cu`),
launched back to back with no host sync; on CPU tensors their plain
versions below (`relax_load_plain`, `relax_project_plain`, with
`project_rows_plain` the JAX `_project_rows`). The plain versions sum the
load over classes in ascending order and the gradient over resources in
ascending order, in f32, as the kernels do; the projection's prefix sum
is taken in float64 and rounded to f32, in both.

Differences from the JAX package: the iteration count is the keyword
`iters` (default 400) — the JAX `SIMTPU_SOLVER_ITERS` switch has no
counterpart, since the port reads no environment switch. The JAX package
pads every axis to a power of two so that its per-shape executables are
reused; the port launches at the true shapes (a relaxation of no class
gets one class row of zero count), and `RelaxVerdicts.bucket` records the
shapes launched. The real rows' results do not depend on the padding.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import cuda

#: relaxed-feasibility acceptance: max scaled overcommit after the final
#: projection (capacities are scaled to ~1.0)
RESIDUAL_TOL = 1e-3

#: relative slack the float64 certificate must clear before infeasibility
#: is PROVEN — guards the f32→f64 recompute against degenerate lam ~ 0
CERT_MARGIN = 1e-9

#: projected-gradient iterations of a relaxation (the JAX default)
DEFAULT_ITERS = 400


class RelaxProblem(NamedTuple):
    """Host-side problem statement, class-collapsed and capacity-scaled
    (field for field the JAX package's)."""

    cls_rows: List[np.ndarray]  # per class: batch row indices (free pods)
    cls_group: np.ndarray  # [C] i32 group of each class
    cnt: np.ndarray  # [C] f32 pod count per class
    req: np.ndarray  # [C, R] f32 scaled per-pod request
    req_raw: np.ndarray  # [C, R] f64 unscaled (rounding/certificate)
    feas: np.ndarray  # [C, N] bool static & volume feasibility
    fixed: np.ndarray  # [N, R] f32 scaled pinned/forced load
    fixed_raw: np.ndarray  # [N, R] f64 unscaled
    cap: np.ndarray  # [N, R] f32 scaled allocatable
    cap_raw: np.ndarray  # [N, R] f64 unscaled
    scale: np.ndarray  # [R] f64 per-resource scale divisor
    lr: float  # 1/L step size for the projected gradient
    pinned_rows: np.ndarray  # [Q] batch rows with pin >= 0


def build_relax_problem(tensors, batch) -> RelaxProblem:
    """Collapse a tensorized capacity problem into the relaxation's
    class-level statement. Pinned rows (DaemonSet clone pods and
    spec.nodeName pods) become fixed per-node load, which each candidate's
    membership mask gates."""
    pin = np.asarray(batch.pin)
    free = np.flatnonzero(pin < 0)
    pinned = np.flatnonzero(pin >= 0)

    n, r = tensors.alloc.shape
    req_all = np.asarray(batch.req, np.float64)
    if req_all.shape[1] < r:
        req_all = np.pad(req_all, ((0, 0), (0, r - req_all.shape[1])))

    fixed_raw = np.zeros((n, r), np.float64)
    if len(pinned):
        np.add.at(fixed_raw, pin[pinned], req_all[pinned])

    group = np.asarray(batch.group, np.int64)
    if len(free):
        key = np.concatenate([group[free, None].astype(np.float64), req_all[free]], axis=1)
        uniq, inverse = np.unique(key, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        c = uniq.shape[0]
        cls_rows = [free[np.flatnonzero(inverse == ci)] for ci in range(c)]
        cls_group = uniq[:, 0].astype(np.int32)
        req_raw = uniq[:, 1:]
        cnt = np.array([len(rows) for rows in cls_rows], np.float32)
    else:
        cls_rows, c = [], 0
        cls_group = np.zeros(0, np.int32)
        req_raw = np.zeros((0, r), np.float64)
        cnt = np.zeros(0, np.float32)

    static = np.asarray(tensors.static_mask, bool)
    vol = np.asarray(tensors.vol_mask, bool)
    if vol.shape[0] == 1 and static.shape[0] > 1:
        vol = np.broadcast_to(vol, static.shape)
    feas = static[cls_group] & vol[cls_group] if c else np.zeros((0, n), bool)

    if c > 1:
        # second collapse: groups with the same request AND the same
        # feasibility row are one class for the relaxation
        key2 = np.concatenate([req_raw, feas.astype(np.float64)], axis=1)
        uniq2, inv2 = np.unique(key2, axis=0, return_inverse=True)
        inv2 = inv2.reshape(-1)
        if uniq2.shape[0] < c:
            merged_rows = [
                np.sort(np.concatenate([cls_rows[ci] for ci in np.flatnonzero(inv2 == mi)]))
                for mi in range(uniq2.shape[0])
            ]
            first = np.array([int(np.flatnonzero(inv2 == mi)[0]) for mi in range(uniq2.shape[0])])
            cls_rows = merged_rows
            cls_group = cls_group[first]
            req_raw = req_raw[first]
            feas = feas[first]
            cnt = np.array([len(rows) for rows in cls_rows], np.float32)
            c = uniq2.shape[0]

    cap_raw = np.asarray(tensors.alloc, np.float64)
    scale = np.maximum(cap_raw.max(axis=0), 1e-9)
    req = (req_raw / scale).astype(np.float32)
    sigma = float(np.linalg.norm(req, 2)) if req.size else 1.0
    lr = 0.9 / max(sigma * sigma, 1e-12)

    return RelaxProblem(
        cls_rows=cls_rows,
        cls_group=cls_group,
        cnt=cnt,
        req=req,
        req_raw=req_raw,
        feas=np.ascontiguousarray(feas),
        fixed=(fixed_raw / scale).astype(np.float32),
        fixed_raw=fixed_raw,
        cap=(cap_raw / scale).astype(np.float32),
        cap_raw=cap_raw,
        scale=scale,
        lr=lr,
        pinned_rows=pinned,
    )


# -- the plain versions -------------------------------------------------------


def project_rows_plain(v: torch.Tensor, a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean projection of each row of `v` [..., N] onto the
    masked simplex {y >= 0, y*(~mask) = 0, sum y = a} (sort + threshold):
    the JAX `_project_rows`, with the prefix sum taken in float64 and
    rounded to f32 as K23 takes it. Rows with a <= 0 are zero."""
    neg = torch.where(mask, v, torch.full_like(v, -float("inf")))
    u = torch.sort(neg, dim=-1, descending=True).values
    finite = torch.isfinite(u)
    cs = torch.cumsum(torch.where(finite, u, torch.zeros_like(u)).double(), dim=-1).float()
    k = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    t = (cs - a[..., None]) / k
    cond = finite & (u > t)
    rho = torch.clamp(cond.sum(dim=-1) - 1, min=0)
    tau = torch.gather(t, -1, rho[..., None])
    y = torch.clamp(v - tau, min=0.0) * mask
    return torch.where((a > 0)[..., None], y, torch.zeros_like(y))


class RelaxBuffers(NamedTuple):
    """One relaxation's inputs and carried planes on one device: y [S, C,
    N], over [S, N, R] and residual [S] f32 are written by the steps;
    stuck [S] int32 flags a candidate with a class of demand but no
    feasible valid node (set by the init step)."""

    feas: torch.Tensor  # [C, N] bool
    req: torch.Tensor  # [C, R] f32
    cnt: torch.Tensor  # [C] f32
    fixed: torch.Tensor  # [N, R] f32
    cap: torch.Tensor  # [N, R] f32
    valid: torch.Tensor  # [S, N] bool
    lr: float  # f32 step
    y: torch.Tensor  # [S, C, N] f32
    over: torch.Tensor  # [S, N, R] f32
    residual: torch.Tensor  # [S] f32
    stuck: torch.Tensor  # [S] int32
    cache: dict  # the kernels' argument block, once built


def relax_buffers(feas, req, cnt, fixed, cap, valid, lr, device) -> RelaxBuffers:
    """RelaxBuffers on `device` from host arrays (numpy or tensors)."""
    device = torch.device(device)

    def on(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(x)), device=device).to(dtype).contiguous()

    feas, req, cnt = on(feas, torch.bool), on(req, torch.float32), on(cnt, torch.float32)
    fixed, cap, valid = on(fixed, torch.float32), on(cap, torch.float32), on(valid, torch.bool)
    s, n = valid.shape
    c, r = req.shape
    return RelaxBuffers(
        feas=feas, req=req, cnt=cnt, fixed=fixed, cap=cap, valid=valid, lr=float(np.float32(lr)),
        y=torch.zeros((s, c, n), dtype=torch.float32, device=device),
        over=torch.zeros((s, n, r), dtype=torch.float32, device=device),
        residual=torch.zeros(s, dtype=torch.float32, device=device),
        stuck=torch.zeros(s, dtype=torch.int32, device=device),
        cache={},
    )


def _free(rb: RelaxBuffers) -> torch.Tensor:
    """[S, N, R] free capacity of every candidate: relu((cap - fixed) * valid)."""
    return torch.clamp((rb.cap - rb.fixed)[None] * rb.valid[:, :, None].to(torch.float32), min=0.0)


def relax_load_plain(rb: RelaxBuffers, residual: bool = False) -> None:
    """K22's function (on tensors of any device): over[s, n, r] = relu(sum_c y[s, c, n]
    * req[c, r] - free[s, n, r]) with the sum over c ascending in f32; in
    residual mode also residual[s] = max over (n, r), +inf when stuck[s]."""
    cuda.count_plain("relax_load")
    s, c, n = rb.y.shape
    load = torch.zeros((s, n, rb.req.shape[1]), dtype=torch.float32, device=rb.y.device)
    for ci in range(c):
        load = load + rb.y[:, ci, :, None] * rb.req[ci]
    rb.over.copy_(torch.clamp(load - _free(rb), min=0.0))
    if residual:
        peak = (rb.over.reshape(s, -1).amax(dim=1) if rb.over.numel()
                else torch.zeros(s, device=rb.y.device))
        peak = torch.clamp(peak, min=0.0)
        rb.residual.copy_(torch.where(rb.stuck > 0, torch.full_like(peak, float("inf")), peak))


def relax_project_plain(rb: RelaxBuffers, init: bool = False) -> None:
    """K23's function (on tensors of any device). Init mode: y = cnt / max(nfeas, 1) on
    each class's feasible valid nodes (zero elsewhere), and stuck[s] = 1
    when a class with cnt > 0 has none. Step mode: per (s, c) row, the
    gradient g[n] = sum_r over[s, n, r] * req[c, r] (r ascending, f32), the
    step v = y - lr * g and the projection `project_rows_plain`."""
    cuda.count_plain("relax_project")
    f = rb.feas[None] & rb.valid[:, None, :]
    if init:
        nfeas = f.sum(dim=2)
        share = rb.cnt[None] / torch.clamp(nfeas, min=1).to(torch.float32)
        rb.y.copy_(torch.where(f, share[:, :, None].expand_as(rb.y), torch.zeros_like(rb.y)))
        stuck = ((nfeas == 0) & (rb.cnt[None] > 0)).any(dim=1)
        rb.stuck.copy_(stuck.to(torch.int32))
        return
    s, c, n = rb.y.shape
    grad = torch.zeros((s, c, n), dtype=torch.float32, device=rb.y.device)
    for ri in range(rb.req.shape[1]):
        grad = grad + rb.over[:, None, :, ri] * rb.req[None, :, ri, None]
    lr = torch.tensor(rb.lr, dtype=torch.float32, device=rb.y.device)
    v = rb.y - lr * grad
    rb.y.copy_(project_rows_plain(v, rb.cnt[None].expand(s, c), f))


def relax_load(rb: RelaxBuffers, residual: bool = False) -> None:
    """K22 in one launch for buffers on the card, its plain version for
    buffers on the CPU."""
    if rb.y.device.type == "cpu":
        relax_load_plain(rb, residual)
    else:
        cuda.launch_relax_load(rb, residual)


def relax_project(rb: RelaxBuffers, init: bool = False) -> None:
    """K23 in one launch for buffers on the card, its plain version for
    buffers on the CPU."""
    if rb.y.device.type == "cpu":
        relax_project_plain(rb, init)
    else:
        cuda.launch_relax_project(rb, init)


def relax_run(rb: RelaxBuffers, iters: int) -> None:
    """The whole projected-gradient run on `rb`: init, `iters` steps, the
    residual. No host sync between the launches."""
    relax_project(rb, init=True)
    for _ in range(int(iters)):
        relax_load(rb)
        relax_project(rb)
    relax_load(rb, residual=True)


def relax_plain(feas, req, cnt, fixed, cap, valid, lr, iters: int = DEFAULT_ITERS):
    """The JAX `_relax_kernel`'s function on the CPU: (y [S, C, N],
    residual [S]) of every candidate membership mask row of `valid`."""
    rb = relax_buffers(feas, req, cnt, fixed, cap, valid, lr, "cpu")
    relax_run(rb, iters)
    return rb.y, rb.residual


class RelaxVerdicts(NamedTuple):
    residual: np.ndarray  # [S] f32 max scaled overcommit per candidate
    y_s: torch.Tensor  # [S, C, N] on the device of the run
    c: int  # true class count
    n: int  # true node count
    bucket: tuple  # (S, C, N, R) shapes launched


def relax_candidates(prob: RelaxProblem, valid_s: np.ndarray, iters: int = DEFAULT_ITERS,
                     device=None) -> RelaxVerdicts:
    """Solve every candidate membership mask (rows of `valid_s` [S, N]) in
    one run on `device` (None = the CUDA card)."""
    device = resolve_device(device)
    c = len(prob.cnt)
    n, r = prob.cap.shape
    s = valid_s.shape[0]
    feas, req, cnt = prob.feas, prob.req, prob.cnt
    if not c:  # one zero-count class row keeps every launch non-empty
        feas, req, cnt = np.zeros((1, n), bool), np.zeros((1, r), np.float32), np.zeros(1, np.float32)
    rb = relax_buffers(feas, req, cnt, prob.fixed, prob.cap, valid_s, np.float32(prob.lr), device)
    relax_run(rb, iters)
    residual = rb.residual.cpu().numpy()
    return RelaxVerdicts(residual=residual, y_s=rb.y, c=c, n=n, bucket=(s, rb.y.shape[1], n, r))


def fetch_y(verdicts: RelaxVerdicts, s: int) -> np.ndarray:
    """Host copy of candidate s's fractional assignment, float64 [C, N]."""
    y = verdicts.y_s[s].cpu().numpy()
    return np.asarray(y, np.float64)[: verdicts.c, : verdicts.n]


def infeasibility_certificate(prob: RelaxProblem, y: np.ndarray, valid: np.ndarray) -> bool:
    """Float64 weak-duality proof that NO fractional assignment exists for
    this membership mask. Prices lam = relu(load - free) come from the
    solver's y, but the inequality is re-evaluated exactly. Returns True
    iff infeasibility is PROVEN."""
    c, n = y.shape if y.size else (0, prob.cap_raw.shape[0])
    if c == 0:
        return False
    valid = np.asarray(valid, bool)
    feas = prob.feas & valid[None, :]
    if np.any((feas.sum(axis=1) == 0) & (prob.cnt > 0)):
        return True  # a class with demand and no feasible valid node
    free = np.maximum((prob.cap_raw - prob.fixed_raw) * valid[:, None], 0.0) / prob.scale
    req = np.asarray(prob.req, np.float64)
    load = np.einsum("cn,cr->nr", y, req)
    lam = np.maximum(load - free, 0.0)
    if not lam.any():
        return False
    percost = np.einsum("nr,cr->cn", lam, req)
    mincost = np.where(feas, percost, np.inf).min(axis=1)
    lhs = float(np.sum(np.asarray(prob.cnt, np.float64) * mincost))
    rhs = float(np.sum(lam * free))
    return lhs > rhs * (1.0 + CERT_MARGIN) + 1e-12
