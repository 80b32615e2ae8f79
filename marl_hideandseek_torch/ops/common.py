"""Argument checks and pointer helpers shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

PTR = ctypes.c_void_p
INT = ctypes.c_int
# Entry signature of the kernels that take their arguments as arrays
# (csrc/megastep.cu, csrc/rgbd.cu, csrc/observations.cu): pointers, ints
# and floats, each with its count, then the stream.
ARRAY_ENTRY = [PTR, INT, PTR, INT, PTR, INT, PTR]


def check(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    """Raise unless ``t`` has this shape, dtype, device and is contiguous;
    return its data pointer."""
    ptr = check_view(t, name, shape, dtype, device)
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return ptr


def check_view(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    """Raise unless ``t`` has this shape, dtype and device, in any
    layout (a kernel that takes strides reads it as it is); return its
    data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def as_f32(x: float) -> float:
    """A Python constant as the float32 PyTorch rounds it to."""
    return float(torch.tensor(x, dtype=torch.float32))


def c_arrays(ptrs, iparams, fparams):
    """ctypes arrays for the (pointers, ints, floats) launch arguments."""
    return ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(iparams))(*iparams),
            (ctypes.c_float * len(fparams))(*fparams))


def launch_arrays(kernel, ptrs, iparams, fparams, device) -> None:
    """One launch of an ``ARRAY_ENTRY`` kernel on the current stream."""
    p_arr, i_arr, f_arr = c_arrays(ptrs, iparams, fparams)
    kernel(ctypes.cast(p_arr, ctypes.c_void_p), len(ptrs),
           ctypes.cast(i_arr, ctypes.c_void_p), len(iparams),
           ctypes.cast(f_arr, ctypes.c_void_p), len(fparams),
           stream_ptr(device))


def wall_bound(wall_active: torch.Tensor) -> torch.Tensor:
    """[1] i32 batch-max active-wall count (pallas_step._wall_bound): the
    kernels' wall loops stop there. Wall slots are densely packed, so the
    slots past it are inactive in every world. Computed on the device,
    without a host sync."""
    return wall_active.sum(0, dtype=torch.int32).amax().reshape(1)


def block_occupancy(lib_name: str) -> dict:
    """Launch shape of ``csrc/<lib_name>.cu``'s kernel, which runs one
    warp per world: worlds per block, shared bytes per block, and the
    blocks and worlds resident per SM as the CUDA runtime reckons them
    (its ``mhs_<lib_name>_occupancy`` entry)."""
    from marl_hideandseek_torch.ops.build import load

    fn = getattr(load(lib_name), f"mhs_{lib_name}_occupancy")
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"mhs_{lib_name}_occupancy failed: cudaError {err}")
    return {"worlds_per_block": out[0], "smem_bytes_per_block": out[1],
            "blocks_per_sm": out[2], "worlds_per_sm": out[0] * out[2]}
