"""K8 `audit_bulk`: the placement auditor's bulk pass, and its plain version.

Replaces the JAX package's jitted bulk pass (`simtpu/audit/checker.py
_get_bulk_jit :388`, its numpy twin `_bulk_flags_numpy :297`): for M placed
entries in placement order on N nodes, one int flag word per entry with a
bit per violated constraint class, in `BULK_BITS` order —

- invalid node / pin (order-free): the stateless filter verdict
  (`static_mask[g, n]`, `vol_mask[g, n]`), the candidate-cluster mask, the
  DaemonSet / `spec.nodeName` pins;
- overcommit: each entry's request against the node's allocatable less the
  requests of the entries placed on the node before it, with slack
  `EPS_REL * max(|free|, 1) + EPS_ABS`;
- host-port and exclusive-volume conflicts (an earlier entry on the node
  holds the port / volume);
- attach limits (the node's on-node volume classes plus the entry's new
  ones against the per-class limit);
- Open-Local VG space and exclusive-device double takes;
- GPU-share device memory.

Entries bound by `spec.nodeName` (forced) bypass every feasibility bit but
the pin bit; their requests still count toward later entries' prefixes.

`audit_bulk(inputs)` decides by the inputs' device: tensors on the CPU go
to `audit_bulk_plain`, tensors on a CUDA card launch K8
(`kernels/csrc/audit_bulk.cu`) or raise. Every value is f64, as the JAX
pass runs under x64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda

# Conservation slack (checker.py of the JAX package): the engines compare
# float32 `free + 1e-5·max(|free|,1) >= req` and accumulate usage in f32;
# the audit accumulates in f64 and allows the engine's slack twice over
# plus an absolute term for f32 drift.
EPS_REL = 2e-5
EPS_ABS = 1e-3
ATTACH_EPS = 1e-9

#: bit i of the flag word (the order is the JAX package's `_BULK_BITS`)
BULK_BITS = (
    "invalid-node",
    "overcommit",
    "port-conflict",
    "volume-conflict",
    "attach-limit",
    "storage",
    "gpu",
)
(BIT_INVALID_NODE, BIT_OVERCOMMIT, BIT_PORT, BIT_VOLUME, BIT_ATTACH,
 BIT_STORAGE, BIT_GPU) = range(len(BULK_BITS))


class AuditInputs(NamedTuple):
    """The bulk pass's inputs, all on one device (the JAX pass's argument
    order). Widths P, W, C, V, SD, GD may be 0."""

    alloc: torch.Tensor  # [N, R] f64
    static_mask: torch.Tensor  # [G, N] bool
    vol_mask: torch.Tensor  # [G, N] bool
    node_valid: torch.Tensor  # [N] bool
    ports: torch.Tensor  # [G, P] bool
    vol_rw: torch.Tensor  # [G, W] bool
    vol_ro: torch.Tensor  # [G, W] bool
    vol_att: torch.Tensor  # [G, W] bool
    vol_class_mask: torch.Tensor  # [C, W] f64
    attach_limits: torch.Tensor  # [N, C] f64
    vg_avail0: torch.Tensor  # [N, V] f64 — VG capacity less the preset requests
    sdev_free0: torch.Tensor  # [N, SD] bool — device exists and not preallocated
    gpu_total: torch.Tensor  # [N, GD] f64 — device memory per GPU
    g: torch.Tensor  # [M] int64 group
    n: torch.Tensor  # [M] int64 landing node
    req: torch.Tensor  # [M, R] f64
    forced: torch.Tensor  # [M] bool
    pin: torch.Tensor  # [M] int64 (-1 unpinned, -2 pinned to a missing node)
    lvm: torch.Tensor  # [M, V] f64
    sdev: torch.Tensor  # [M, SD] bool
    gpu: torch.Tensor  # [M, GD] f64 — shares × per-GPU memory


def _prefix_within(order: torch.Tensor, n: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Exclusive per-node prefix sums of `cols` along placement order, in
    the JAX package's form: a global cumsum over the node-sorted entries
    less its value at the segment's start. [M, C] in entry order."""
    m = order.shape[0]
    out = torch.zeros(cols.shape, dtype=torch.float64, device=cols.device)
    if not m:
        return out
    c = cols.to(torch.float64)[order]
    ns = n[order]
    cum = torch.cumsum(c, dim=0)
    excl = cum - c
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=n.device), ns[1:] != ns[:-1]])
    idx = torch.arange(m, device=n.device)
    first = torch.cummax(torch.where(seg_start, idx, torch.zeros_like(idx)), dim=0).values
    out[order] = excl - excl[first]
    return out


def _slack(free: torch.Tensor) -> torch.Tensor:
    return EPS_REL * torch.clamp(torch.abs(free), min=1.0) + EPS_ABS


def audit_bulk_plain(x: AuditInputs) -> torch.Tensor:
    """The flag word per entry [M] int32, computed as the JAX package's
    `_bulk_flags_numpy` computes it (stable by-node order, prefix sums as
    global cumsums less the segment start)."""
    m = x.g.shape[0]
    dev = x.alloc.device
    flags = torch.zeros(m, dtype=torch.int32, device=dev)
    if not m:
        return flags
    g, n = x.g, x.n

    def put(bit: int, mask: torch.Tensor) -> None:
        flags.bitwise_or_(mask.to(torch.int32) << bit)

    ok_static = x.static_mask[g, n] & x.vol_mask[g, n]
    pin_ok = torch.where(x.pin >= 0, n == x.pin, x.pin > -2)
    nv = x.node_valid[n]
    bad = torch.where(
        x.forced,
        ~((x.pin >= 0) & (n == torch.clamp(x.pin, min=0)) & nv),
        ~(ok_static & pin_ok & nv),
    )
    put(BIT_INVALID_NODE, bad)

    order = torch.sort(n, stable=True).indices
    soft = ~x.forced

    free = x.alloc[n] - _prefix_within(order, n, x.req)
    put(BIT_OVERCOMMIT, soft & torch.any(x.req > free + _slack(free), dim=1))

    if x.ports.shape[1]:
        want = x.ports[g]
        cnt = _prefix_within(order, n, want)
        put(BIT_PORT, soft & torch.any(want & (cnt > 0), dim=1))

    if x.vol_rw.shape[1]:
        rw, ro, att = x.vol_rw[g], x.vol_ro[g], x.vol_att[g]
        cnt_any = _prefix_within(order, n, rw | ro | att)
        cnt_rw = _prefix_within(order, n, rw)
        vv = torch.any(rw & (cnt_any > 0), dim=1) | torch.any(ro & (cnt_rw > 0), dim=1)
        put(BIT_VOLUME, soft & vv)
        on_node = cnt_any > 0
        new = att & ~on_node
        used_c = on_node.to(torch.float64) @ x.vol_class_mask.T
        new_c = new.to(torch.float64) @ x.vol_class_mask.T
        limits = x.attach_limits[n]
        put(BIT_ATTACH, soft & torch.any((new_c > 0) & (used_c + new_c > limits + ATTACH_EPS), dim=1))

    sv = torch.zeros(m, dtype=torch.bool, device=dev)
    if x.vg_avail0.shape[1]:
        free_vg = x.vg_avail0[n] - _prefix_within(order, n, x.lvm)
        sv |= torch.any(x.lvm > free_vg + _slack(free_vg), dim=1)
    if x.sdev_free0.shape[1]:
        taken = _prefix_within(order, n, x.sdev) > 0
        sv |= torch.any(x.sdev & (~x.sdev_free0[n] | taken), dim=1)
    put(BIT_STORAGE, soft & sv)

    if x.gpu_total.shape[1]:
        free_g = x.gpu_total[n] - _prefix_within(order, n, x.gpu)
        put(BIT_GPU, soft & torch.any(x.gpu > free_g + _slack(free_g), dim=1))
    return flags


def audit_bulk(x: AuditInputs) -> torch.Tensor:
    """K8 for inputs on a CUDA card (raises if it cannot launch), the plain
    version for inputs on the CPU. Returns the flag words [M] int32."""
    dev = x.alloc.device
    if dev.type == "cpu":
        cuda.count_plain("audit_bulk")
        return audit_bulk_plain(x)
    if dev.type != "cuda":
        raise RuntimeError(f"audit_bulk: unsupported device {dev}")
    return cuda.launch_audit(x)
