"""GPU-share: per-device GPU-memory fit and device assignment.

The plain PyTorch form of the JAX package's `kernels/gpushare.py`,
operation for operation, so that the results are bit-identical: the CPU
path of the per-pod step and the oracle of `kernels/csrc/gpu_pod.cu` (K6).

Mirrors open-gpu-share's `GpuNodeInfo.AllocateGpuId`:

- 1-GPU pods take the tightest-fitting device (min idle memory ≥ request,
  lowest index on ties — the Go loop uses strict `<`);
- multi-GPU pods greedily stack shares device by device in index order;
  one device may host several of the requested GPU shares;

plus the node-level total check of `GpuSharePlugin.Filter`. The share
counts are integer-valued f32, so the cumulative sum is exact in any order.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 3.4e38  # finite stand-in for +inf
_TINY = 1e-30
_F32 = torch.float32


def gpu_plan(
    gpu_free: torch.Tensor,  # [N, GD] free memory per device
    dev_exists: torch.Tensor,  # [N, GD] bool
    gpu_total: torch.Tensor,  # [N] node total GPU memory (static capacity)
    mem,  # scalar — per-GPU memory request
    count,  # scalar — number of GPU shares requested
    preset: torch.Tensor = None,  # [GD] shares from an existing gpu-index anno
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (fits [N], shares [N, GD]) — shares = how many of the pod's
    GPU shares land on each device. Non-GPU pods fit everywhere with zero
    shares. A non-empty `preset` is honoured verbatim (AllocateGpuId's
    annotation short-circuit), without re-checking per-device memory."""
    n, gd = gpu_free.shape
    dev = gpu_free.device
    mem = torch.as_tensor(mem, dtype=_F32, device=dev)
    count = torch.as_tensor(count, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=_F32, device=dev)
    # Filter triggers on mem > 0 alone; a pod with gpu-mem but no/zero
    # gpu-count then fails AllocateGpuId on every node (valid_req)
    is_gpu_pod = mem > 0
    valid_req = count > 0
    count_f = count.to(_F32)

    free = torch.where(dev_exists, gpu_free, torch.tensor(-1.0, dtype=_F32, device=dev))
    per_dev = torch.where(
        free >= mem, torch.floor(free / torch.clamp(mem, min=_TINY)), zero
    )
    # multi-GPU greedy: fill devices in index order (two-pointer walk)
    cum = torch.cumsum(per_dev, dim=1)
    prev = cum - per_dev
    greedy = torch.minimum(torch.clamp(torch.minimum(cum, count_f) - prev, min=0.0), per_dev)

    # 1-GPU tightest fit: min free among devices that fit, lowest index tie
    fit1 = free >= mem
    key = torch.where(fit1, free, torch.tensor(_BIG, dtype=_F32, device=dev))
    idx = torch.arange(gd, device=dev).expand_as(key)
    tight_idx = torch.where(key == key.amin(dim=1, keepdim=True), idx, gd).amin(dim=1)
    tight = ((idx == tight_idx[:, None]) & fit1.any(dim=1)[:, None]).to(_F32)

    shares = torch.where(count == 1, tight, greedy)
    enough = shares.sum(dim=1) >= count_f
    node_total_ok = gpu_total >= mem  # Filter's node-level pre-check
    has_dev = dev_exists.any(dim=1)
    fits = torch.where(is_gpu_pod, node_total_ok & has_dev & valid_req & enough, True)
    shares = torch.where((is_gpu_pod & fits)[:, None], shares, zero)
    if preset is not None:
        preset = torch.as_tensor(preset, device=dev)
        has_preset = preset.sum() > 0
        preset_fits = torch.where(is_gpu_pod, node_total_ok & has_dev & valid_req, True)
        fits = torch.where(has_preset, preset_fits, fits)
        shares = torch.where(
            has_preset,
            torch.where(
                (is_gpu_pod & preset_fits)[:, None],
                preset.to(_F32).expand(n, gd),
                zero,
            ),
            shares,
        )
    return fits, shares
