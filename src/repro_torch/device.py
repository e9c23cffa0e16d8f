"""Device rule of the port's entry points.

``device=None`` means ``"cuda"``: the port runs on the card unless the caller
asks for the CPU (as the tests do). Asking for CUDA where none is present
raises instead of quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ``"float32"``) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def tensor_device(tree) -> Optional[torch.device]:
    """Device of the first tensor found in a (nested) params tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = tensor_device(v)
            if d is not None:
                return d
    return None
