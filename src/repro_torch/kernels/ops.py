"""Checked wrappers around the CUDA kernels.

A wrapper checks device, dtype, shape and layout, then:

* on CPU tensors, runs the kernel's plain PyTorch version from
  :mod:`repro_torch.kernels.ref` (that is how the CPU tests reach it);
* on CUDA tensors, launches the kernel on the current stream, or raises.
  There is no fallback: a failed build or launch is an error.

``LAUNCHES[name]`` counts the kernel launches each wrapper made, so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_MAX_D = 128


def _flash_fn():
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, KH, D) [model layout] -> (B, S, H, D).

    GQA when H is a multiple of KH (kv head = h // (H // KH)).  Masks are
    those of :func:`repro_torch.nn.attention.make_mask` with no q offset.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"agree on batch and head dim, or H % KH != 0")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    scale = float(scale) if scale is not None else d ** -0.5

    if q.device.type == "cpu":
        out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=causal,
                                      window=window, scale=scale)
        return out.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")

    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    if d % 4 or d > _FLASH_MAX_D:
        raise ValueError(f"the CUDA kernel takes a head dim that is a multiple "
                         f"of 4 and at most {_FLASH_MAX_D}, not {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(stride {x.stride(3)})")
        if x.data_ptr() % (4 * x.element_size()) or any(st % 4 for st in x.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on a 4-element boundary: "
                             f"the kernel moves 4 elements a load (strides "
                             f"{x.stride()})")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, kh, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), 0 if window is None else int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out
