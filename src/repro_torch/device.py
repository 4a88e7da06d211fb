"""Device selection for the port's entry points.

Entry points (``init_model``, ``Server``, ``serve()``, the CLI) run on
the GPU unless the caller asks for the CPU: with no ``device`` and no
CUDA device present they raise instead of silently running on the host.

f32 means IEEE f32 on the whole path: TF32 is switched off for cuBLAS
and cuDNN here, and asserted, so the dense route and the oracles keep
the reference's 3e-5 tolerances.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def ieee_f32() -> None:
    """Disable TF32 for matmuls and convolutions and assert it stuck."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device and raises when there is
    none; an explicit device ("cpu", "cuda", "cuda:1", ...) is taken as
    given.  Always switches TF32 off."""
    ieee_f32()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


def describe(device: Optional[torch.device]) -> str:
    """Human-readable device name for reports."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
