"""Device policy and numerics settings of the port.

Entry points take `device=None`, which means the CUDA card. With no card
they raise: nothing drops to the CPU on its own. The tests (and anyone who
wants the plain PyTorch path) pass `device="cpu"` explicitly.

Numerics follow the JAX package: every value is f32, TF32 is off for
matrix products and convolutions, and PyTorch's deterministic algorithms
are on.
"""

from __future__ import annotations

import torch


def configure_numerics() -> None:
    """f32 everywhere, TF32 off, deterministic algorithms on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def resolve_device(device=None) -> torch.device:
    """The explicit `torch.device` an engine runs on (`None` = `cuda`).

    Raises RuntimeError when CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simtpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    configure_numerics()
    return dev
