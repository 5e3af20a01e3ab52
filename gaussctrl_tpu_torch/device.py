"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A CUDA request without a card raises: the port
    never moves a computation to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch sees none; "
                           "pass device='cpu' to run on the CPU")
    return dev


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is float64 (reference runs)."""
    return x if x.dtype == torch.float64 else x.float()


@contextlib.contextmanager
def exact_fp32():
    """Float32 matmuls and cuDNN convolutions without TF32 inside the block
    (the segmentation and metric networks compute in float32, as the JAX
    package's do); the previous settings are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
