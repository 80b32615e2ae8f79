"""Argument checks and pointer helpers shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

PTR = ctypes.c_void_p
INT = ctypes.c_int


def check(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    """Raise unless ``t`` has this shape, dtype, device and is contiguous;
    return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
