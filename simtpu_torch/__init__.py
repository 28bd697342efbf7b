"""simtpu_torch — the PyTorch/CUDA port of simtpu's serial simulation path.

`simulate()` places a cluster's pods and then each app's, pod by pod in
the reference's serial order, with the per-pod scheduling step run by four
hand-written CUDA kernels on an NVIDIA H100 (`kernels/csrc/`). Placements,
reasons and the carried state are bit-identical to the JAX package's
`simtpu.simulate()`. Pass `device="cpu"` for the plain PyTorch path.

This package imports neither JAX nor anything of `simtpu`.
"""

from .api import Simulator, simulate
from .core.objects import (
    AppResource,
    NodeStatus,
    ResourceTypes,
    SimulateResult,
    UnscheduledPod,
)

__all__ = [
    "AppResource",
    "NodeStatus",
    "ResourceTypes",
    "SimulateResult",
    "Simulator",
    "UnscheduledPod",
    "simulate",
]
