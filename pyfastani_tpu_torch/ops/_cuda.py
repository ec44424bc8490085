"""What the kernel wrappers of ``ops`` share around a launch: the dispatch
on the operands' device, operand checks, pointers and the stream for the
kernels' plain C interface (``_build.load_library``), and the check of
each launch's ``cudaGetLastError``."""

from __future__ import annotations

import ctypes

import torch


def cuda_device(name: str, t: torch.Tensor) -> torch.device | None:
    """``None`` for a CPU tensor (the plain version's route), its CUDA
    device, with an index, for a CUDA tensor; raises for any other."""
    dev = t.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def check(name: str, dev, dtype, t: torch.Tensor, n: int | None = None) -> None:
    """Raises unless ``t`` is a 1-D ``dtype`` tensor on ``dev`` (of ``n``
    entries when given)."""
    if t.dim() != 1 or t.dtype != dtype or t.device != dev:
        raise TypeError(f"{name} must be a 1-D {dtype} tensor on {dev}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} holds {t.shape[0]} entries, expected {n}")


def raise_on(what: str, err: int) -> None:
    """Raises with the CUDA error's message unless the launch returned 0."""
    if err != 0:
        from .._build import load_library

        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{load_library().cuda_error_string(err).decode()}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream(dev: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``dev``, where the kernels launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
