"""Device timestamps in stream order (``csrc/stamp.cu``): one thread writes
the card's global timer (nanoseconds) into a slot of a device int64 buffer.
Launched while a stream is captured, the launch is a node of the CUDA graph
and every replay writes its slot again (utils/profiling.py's step spans).
There is no plain version: on the CPU a span reads the host clock."""

from __future__ import annotations

import ctypes
import threading

import torch

from .build import load_library, raise_on

_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib, _ = load_library("stamp")
            lib.stamp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            lib.stamp.restype = ctypes.c_int
            _lib = lib
        return _lib


def stamp_cuda(slots: torch.Tensor, i: int) -> None:
    """Write the card's time (ns) into ``slots[i]`` on the current stream;
    ``slots`` a contiguous int64 tensor on the card."""
    if slots.dtype != torch.int64 or slots.device.type != "cuda" or not 0 <= i < slots.numel():
        raise ValueError("stamp: slots must be an int64 CUDA tensor holding slot i")
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    raise_on(_load_lib().stamp(slots.data_ptr(), i, stream), "stamp")
