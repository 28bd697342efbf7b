"""Open-Local storage: LVM + exclusive-device fit, plan, and score.

The plain PyTorch form of the JAX package's `kernels/storage.py`, operation
for operation, so that the results are bit-identical: the CPU path of the
per-pod step and the oracle of `kernels/csrc/storage_pod.cu` (K5).

Vectorized over nodes; the per-claim loops are short static unrolls (a pod
has a handful of volume claims). Semantics mirror the vendored open-local
algorithm:

- LVM named-VG fit and binpack placement of unnamed PVCs into the
  smallest-free VG that fits;
- exclusive devices: per media class, PVCs ascending take the smallest free
  device with enough capacity;
- binpack scores: LVM = mean over used VGs of pod-usage/capacity × 10;
  device = mean over units of requested/capacity × 10.

`argmin` takes the first index on ties, as `jnp.argmin` does. The row sum
of the per-VG usage is taken in the order the compiled reference reduces it
(`xla_row_parts`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fp import fma

MAX_LOCAL_SCORE = 10.0
_BIG = 3.4e38  # finite stand-in for +inf
_TINY = 1e-30
_F32 = torch.float32


def _first_argmin(key: torch.Tensor) -> torch.Tensor:
    """Row-wise argmin of a [N, K] tensor, lowest index on ties."""
    k = key.shape[1]
    idx = torch.arange(k, device=key.device).expand_as(key)
    lo = key.amin(dim=1, keepdim=True)
    return torch.where(key == lo, idx, k).amin(dim=1)


def _one_hot_rows(choice: torch.Tensor, on: torch.Tensor, width: int) -> torch.Tensor:
    """[N, width] bool with row n's `choice[n]` column set where `on[n]`."""
    cols = torch.arange(width, device=choice.device)
    return (cols[None, :] == choice[:, None]) & on[:, None]


#: columns XLA's CPU backend sums left to right in one part of a row sum
XLA_ROW_PART = 32


def xla_row_parts(v: int) -> list:
    """The contiguous column ranges [(start, stop), ...] in which XLA's CPU
    backend reduces a row of V floats (`jnp.sum(x, axis=1)` under `jit`):
    each part is summed left to right, then the parts left to right.

    Up to XLA_ROW_PART columns the row is one part. Past it the row is cut
    into k = ceil(V / 32) parts: with r = V - 32 (k - 2), a head of
    ceil(r / 2) columns, k - 2 parts of 32, a tail of floor(r / 2): 33 = 17
    + 16, 36 = 18 + 18, 64 = 32 + 32, 65 = 17 + 32 + 16, 72 = 20 + 32 +
    20, 128 = 4 x 32. tests/test_torch_filter_storage.py holds it bit for
    bit against `jax.jit(lambda a: jnp.sum(a, axis=1))` at every V from 1
    to 300, on 300 seeded f32 rows whose exponents spread over 2^-20 ...
    2^20 (three in ten zero), and against the JAX package's
    `open_local_score` under `jit` at V = 33, 48, 64, 65, 72, 100 and 128,
    where pods' claims take up to eight VGs of a node."""
    if v <= XLA_ROW_PART:
        return [(0, v)]
    k = -(-v // XLA_ROW_PART)
    r = v - XLA_ROW_PART * (k - 2)
    head = (r + 1) // 2
    bounds = [0, head] + [head + XLA_ROW_PART * j for j in range(1, k - 1)] + [v]
    return list(zip(bounds[:-1], bounds[1:]))


def xla_row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order (`xla_row_parts`): each
    part left to right from 0, then the parts left to right from 0."""
    out = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for a, b in xla_row_parts(x.shape[1]):
        part = torch.zeros_like(out)
        for j in range(a, b):
            part = part + x[:, j]
        out = out + part
    return out


def lvm_plan(
    vg_free: torch.Tensor,  # [N, V] capacity - requested (current)
    vg_name_id: torch.Tensor,  # [N, V] interned VG name, -1 pad
    sizes: torch.Tensor,  # [L] pvc sizes, 0 = padding
    vg_ids: torch.Tensor,  # [L] -1 unnamed, -2 missing VG, >=0 named
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (fits [N], alloc [N, V]) — the pod's LVM allocation per node."""
    n, v = vg_free.shape
    exists = vg_name_id >= 0
    has_any_vg = exists.any(dim=1)
    fits = torch.ones(n, dtype=torch.bool, device=vg_free.device)
    alloc = torch.zeros_like(vg_free)
    free = vg_free
    for i in range(sizes.shape[0]):
        size, vid = sizes[i], vg_ids[i]
        active = bool(size > 0)
        named = bool(vid >= 0)
        if named:
            slot = exists & (vg_name_id == vid)
        else:
            eligible = exists & (free >= size)
            key = torch.where(eligible, free, torch.tensor(_BIG, dtype=_F32, device=free.device))
            slot = _one_hot_rows(_first_argmin(key) if v else torch.zeros(n, dtype=torch.long),
                                 eligible.any(dim=1), v)
        take = slot & (free >= size)
        room = take.any(dim=1)
        if named:
            ok = slot.any(dim=1) & room
        else:
            ok = (exists & (free >= size)).any(dim=1)
        ok = ok & bool(vid != -2) & has_any_vg
        upd = torch.where(active & ok[:, None] & take, size, torch.zeros((), dtype=_F32))
        alloc = alloc + upd
        free = free - upd
        if active:
            fits = fits & ok
    return fits, alloc


def device_plan(
    sdev_free: torch.Tensor,  # [N, SD] bool — device exists and unallocated
    sdev_cap: torch.Tensor,  # [N, SD]
    sdev_media: torch.Tensor,  # [N, SD] media code (0 none)
    sizes: torch.Tensor,  # [K] ascending per media class, 0 padding
    medias: torch.Tensor,  # [K] media code per pvc
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (fits [N], take [N, SD] bool, tightness [N]) where tightness is
    Σ requested/allocated over assigned devices (for ScoreDevice)."""
    n, sd = sdev_cap.shape
    dev = sdev_cap.device
    fits = torch.ones(n, dtype=torch.bool, device=dev)
    take = torch.zeros((n, sd), dtype=torch.bool, device=dev)
    free = sdev_free
    tightness = torch.zeros(n, dtype=_F32, device=dev)
    zero = torch.zeros((), dtype=_F32, device=dev)
    for i in range(sizes.shape[0]):
        size, media = sizes[i], medias[i]
        active = bool(size > 0)
        eligible = free & (sdev_media == media) & (sdev_cap >= size)
        key = torch.where(eligible, sdev_cap, torch.tensor(_BIG, dtype=_F32, device=dev))
        found = eligible.any(dim=1)
        choice = _first_argmin(key) if sd else torch.zeros(n, dtype=torch.long, device=dev)
        sel = _one_hot_rows(choice, found, sd) & active
        take = take | sel
        free = free & ~sel
        # one nonzero term a row: exact in any order
        cap_chosen = xla_row_sum(torch.where(sel, sdev_cap, zero))
        tightness = tightness + torch.where(
            found & active, size / torch.clamp(cap_chosen, min=_TINY), zero
        )
        if active:
            fits = fits & found
    return fits, take, tightness


def open_local_score(
    alloc: torch.Tensor,  # [N, V] pod's LVM allocation (from lvm_plan)
    vg_cap: torch.Tensor,  # [N, V]
    dev_tightness: torch.Tensor,  # [N] Σ req/cap over assigned devices
    n_lvm: int,  # number of LVM PVCs (for the zero check)
    n_dev: int,  # number of device PVCs
) -> torch.Tensor:
    """LocalPlugin.Score raw value: ScoreLVM + ScoreDevice (floats, where
    the reference truncates to int). The compiled reference contracts the
    device term into the sum: fma(tightness / n_dev, 10, lvm_score)."""
    zero = torch.zeros((), dtype=_F32, device=alloc.device)
    used = alloc > 0
    per_vg = torch.where(used, alloc / torch.clamp(vg_cap, min=_TINY), zero)
    vg_count = used.sum(dim=1, dtype=torch.int32)
    lvm_score = torch.where(
        (vg_count > 0) & (n_lvm > 0),
        xla_row_sum(per_vg) / vg_count.clamp(min=1).to(_F32) * MAX_LOCAL_SCORE,
        zero,
    )
    if n_dev > 0:
        return fma(dev_tightness / float(n_dev), MAX_LOCAL_SCORE, lvm_score)
    return lvm_score + zero


def storage_plan(
    vg_free, vg_name_id, vg_cap, sdev_free, sdev_cap, sdev_media, has_storage,
    lvm_size, lvm_vg, dev_size, dev_media,
):
    """The fused storage step of one pod, as the JAX package's fused
    cascade computes it: (storage_ok [N], lvm_alloc [N, V], dev_take
    [N, SD], raw Open-Local score [N])."""
    lvm_ok, lvm_alloc = lvm_plan(vg_free, vg_name_id, lvm_size, lvm_vg)
    dev_ok, dev_take, dev_tight = device_plan(sdev_free, sdev_cap, sdev_media, dev_size, dev_media)
    raw = open_local_score(
        lvm_alloc, vg_cap, dev_tight, int((lvm_size > 0).sum()), int((dev_size > 0).sum())
    )
    return has_storage & lvm_ok & dev_ok, lvm_alloc, dev_take, raw
