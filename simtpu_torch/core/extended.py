"""Extended-resource tensorization: Open-Local storage and GPU-share devices.

Lowers the two annotation-based extended schedulers to arrays:

- Open-Local (`pkg/simulator/plugin/open-local.go`, vendored algo at
  `vendor/github.com/alibaba/open-local/pkg/scheduler/algorithm/algo/common.go`):
  node VGs/devices come from the `simon/node-local-storage` JSON annotation
  (`pkg/utils/utils.go:538-567`), pod demand from `simon/pod-local-storage`
  (`utils.go:593-651`), VG names / media types from StorageClass parameters
  (`vendor/.../open-local/pkg/utils/common.go:318-340`).
- GPU-share (`pkg/simulator/plugin/open-gpu-share.go`, vendored cache at
  `vendor/github.com/alibaba/open-gpu-share/pkg/cache/gpunodeinfo.go`): per-node
  devices each hold capacity/count GPU memory; pod demand comes from the
  `alibabacloud.com/gpu-mem` + `gpu-count` annotations
  (`vendor/.../open-gpu-share/pkg/utils/pod.go:57-98`).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from .objects import annotations_of, name_of
from .quantity import parse_quantity
from .vocab import Interner

MEDIA_NONE, MEDIA_SSD, MEDIA_HDD = 0, 1, 2
_MEDIA_CODE = {"ssd": MEDIA_SSD, "hdd": MEDIA_HDD}


def _parse_num(v) -> float:
    """Storage JSON writes numbers as strings ("capacity": "107374182400")."""
    if isinstance(v, str):
        return parse_quantity(v)
    return float(v or 0)


def _parse_bool(v) -> bool:
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


@dataclass
class NodeStorage:
    """Parsed `simon/node-local-storage` annotation (utils.go:538-541)."""

    vgs: List[dict]
    devices: List[dict]

    @classmethod
    def from_node(cls, node: dict) -> Optional["NodeStorage"]:
        raw = annotations_of(node).get(C.ANNO_NODE_LOCAL_STORAGE)
        if raw is None:
            return None
        data = json.loads(raw)
        return cls(vgs=data.get("vgs") or [], devices=data.get("devices") or [])


class StorageClassCatalog:
    """StorageClass name → parameters lookup (the informer the LocalPlugin
    consults, `pkg/simulator/plugin/open-local.go:29,71`)."""

    def __init__(self, storage_classes: Sequence[dict] = ()):
        self._params: Dict[str, dict] = {}
        for sc in storage_classes:
            self._params[name_of(sc)] = sc.get("parameters") or {}

    def __contains__(self, sc_name: str) -> bool:
        return sc_name in self._params

    def vg_name(self, sc_name: str) -> str:
        return self._params.get(sc_name, {}).get("vgName", "")

    def media_type(self, sc_name: str) -> str:
        return self._params.get(sc_name, {}).get("mediaType", "")


@dataclass
class ExtendedNodeArrays:
    """Per-node extended-resource capacity arrays (V/SD/GD = padded widths)."""

    vg_cap: np.ndarray  # [N, V] f32
    vg_req0: np.ndarray  # [N, V] f32 initial Requested from annotation
    vg_name_id: np.ndarray  # [N, V] i32 interned VG name, -1 pad
    vg_names: List[str]
    has_storage: np.ndarray  # [N] bool — node carries the storage annotation
    sdev_cap: np.ndarray  # [N, SD] f32 exclusive-device capacity
    sdev_media: np.ndarray  # [N, SD] i32 media code
    sdev_alloc0: np.ndarray  # [N, SD] bool initially allocated
    sdev_names: List[List[str]]  # per node, for reports
    gpu_dev_total: np.ndarray  # [N, GD] f32 per-device GPU memory
    gpu_total: np.ndarray  # [N] f32 node total GPU memory (capacity)


def tensorize_node_storage(
    nodes: Sequence[dict], vg_names: Optional[Interner] = None
) -> ExtendedNodeArrays:
    n = len(nodes)
    storages = [NodeStorage.from_node(node) for node in nodes]
    if vg_names is None:
        vg_names = Interner()
    v_max = max([len(s.vgs) for s in storages if s] + [0])
    sd_max = max([len(s.devices) for s in storages if s] + [0])

    vg_cap = np.zeros((n, max(v_max, 1)), np.float32)
    vg_req0 = np.zeros_like(vg_cap)
    vg_name_id = np.full((n, max(v_max, 1)), -1, np.int32)
    has_storage = np.zeros(n, bool)
    sdev_cap = np.zeros((n, max(sd_max, 1)), np.float32)
    sdev_media = np.zeros((n, max(sd_max, 1)), np.int32)
    sdev_alloc0 = np.zeros((n, max(sd_max, 1)), bool)
    sdev_names: List[List[str]] = []

    # GPU devices: capacity/count each (gpunodeinfo.go:34-41); totals read from
    # node *capacity* (utils/node.go:11-26)
    gpu_counts = []
    gpu_totals = []
    for node in nodes:
        cap = ((node.get("status") or {}).get("capacity")) or {}
        gpu_totals.append(parse_quantity(cap.get(C.RES_GPU_MEM)))
        gpu_counts.append(int(parse_quantity(cap.get(C.RES_GPU_COUNT))))
    gd_max = max(gpu_counts + [0])
    gpu_dev_total = np.zeros((n, max(gd_max, 1)), np.float32)

    for i, (node, s) in enumerate(zip(nodes, storages)):
        names = []
        if s is not None:
            has_storage[i] = True
            for j, vg in enumerate(s.vgs):
                vg_cap[i, j] = _parse_num(vg.get("capacity"))
                vg_req0[i, j] = _parse_num(vg.get("requested"))
                vg_name_id[i, j] = vg_names.intern(vg.get("name", ""))
            for j, dev in enumerate(s.devices):
                sdev_cap[i, j] = _parse_num(dev.get("capacity"))
                sdev_media[i, j] = _MEDIA_CODE.get(
                    str(dev.get("mediaType", "")).lower(), MEDIA_NONE
                )
                sdev_alloc0[i, j] = _parse_bool(dev.get("isAllocated"))
                names.append(dev.get("device") or dev.get("name") or f"dev-{j}")
        sdev_names.append(names)
        if gpu_counts[i] > 0:
            gpu_dev_total[i, : gpu_counts[i]] = gpu_totals[i] / gpu_counts[i]

    return ExtendedNodeArrays(
        vg_cap=vg_cap,
        vg_req0=vg_req0,
        vg_name_id=vg_name_id,
        vg_names=[str(x) for x in vg_names.items()],
        has_storage=has_storage,
        sdev_cap=sdev_cap,
        sdev_media=sdev_media,
        sdev_alloc0=sdev_alloc0,
        sdev_names=sdev_names,
        gpu_dev_total=gpu_dev_total,
        gpu_total=np.asarray(gpu_totals, np.float32),
    )


@dataclass
class PodExtendedDemand:
    """One pod's storage/GPU demand, host-side."""

    lvm_sizes: List[float]
    lvm_vg_ids: List[int]  # interned VG name id or -1 (binpack)
    dev_sizes: List[float]  # sorted ascending within each media class
    dev_medias: List[int]
    gpu_mem: float
    gpu_count: int
    gpu_preset: List[int]  # device ids from an existing gpu-index annotation


def pod_extended_demand(
    pod: dict, catalog: StorageClassCatalog, vg_names: Interner
) -> PodExtendedDemand:
    """Extract the pod's Open-Local PVC list (`pkg/utils/utils.go:608-651`)
    and GPU annotation demand (`open-gpu-share/pkg/utils/pod.go:83-98`)."""
    annos = annotations_of(pod)
    lvm_sizes: List[float] = []
    lvm_vg_ids: List[int] = []
    dev_pairs: List[Tuple[float, int]] = []
    raw = annos.get(C.ANNO_POD_LOCAL_STORAGE)
    if raw:
        try:
            volumes = (json.loads(raw) or {}).get("volumes") or []
        except json.JSONDecodeError:
            volumes = []
        for vol in volumes:
            sc = vol.get("scName", "")
            size = _parse_num(vol.get("size"))
            if vol.get("kind") == "LVM":
                vg = catalog.vg_name(sc)
                lvm_sizes.append(size)
                # -1 = unnamed (binpack); -2 = named VG that exists on no node
                # (NewNotSuchVGError → unfit everywhere, common.go:71-75)
                if not vg:
                    lvm_vg_ids.append(-1)
                else:
                    vid = vg_names.get(vg)
                    lvm_vg_ids.append(vid if vid >= 0 else -2)
            elif vol.get("kind") in ("SSD", "HDD"):
                media = _MEDIA_CODE.get(catalog.media_type(sc).lower(), MEDIA_NONE)
                if media != MEDIA_NONE:
                    # SC without a known mediaType is dropped by
                    # DividePVCAccordingToMediaType (common.go:247-259)
                    dev_pairs.append((size, media))
    # device PVCs are consumed smallest-first per media class
    # (CheckExclusiveResourceMeetsPVCSize sorts both sides, common.go:290-297),
    # SSD class first (ProcessDevicePVC, common.go:394-446)
    dev_pairs.sort(key=lambda p: (p[1] != MEDIA_SSD, p[0]))
    # named-VG PVCs are allocated before unnamed ones (DivideLVMPVCs split,
    # common.go:59-70 then :108-144); keep relative order within each class
    order = sorted(range(len(lvm_sizes)), key=lambda i: lvm_vg_ids[i] == -1)
    lvm_sizes = [lvm_sizes[i] for i in order]
    lvm_vg_ids = [lvm_vg_ids[i] for i in order]
    gpu_mem = parse_quantity(annos.get(C.ANNO_POD_GPU_MEM, 0))
    try:
        gpu_count = int(annos.get(C.ANNO_POD_GPU_COUNT, "0"))
    except ValueError:
        gpu_count = 0
    # an existing gpu-index annotation short-circuits device planning
    # (AllocateGpuId, gpunodeinfo.go:247-253) — e.g. running pods from a live
    # cluster snapshot keep their device assignment
    gpu_preset: List[int] = []
    raw_idx = annos.get(C.ANNO_POD_GPU_INDEX, "")
    if raw_idx:
        try:
            gpu_preset = [int(tok) for tok in raw_idx.split("-")]
        except ValueError:
            gpu_preset = []
    return PodExtendedDemand(
        lvm_sizes=lvm_sizes,
        lvm_vg_ids=lvm_vg_ids,
        dev_sizes=[p[0] for p in dev_pairs],
        dev_medias=[p[1] for p in dev_pairs],
        gpu_mem=gpu_mem,
        gpu_count=gpu_count,
        gpu_preset=gpu_preset,
    )


