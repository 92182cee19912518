"""Rotary position embeddings (RoPE, half-split), arbitrary position ids."""
from __future__ import annotations

import torch

from repro_torch.nn.norms import acc_dtype


def rope_frequencies(d_head: int, theta: float, device,
                     dtype: torch.dtype) -> torch.Tensor:
    """Inverse frequencies for half the head dim, in ``dtype``."""
    half = d_head // 2
    exponent = torch.arange(half, dtype=dtype, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, d_head) or (..., seq, d_head); positions:
    (..., seq) integer ids broadcastable to x's seq dim — e.g. (1, S) for
    a prompt or (B, 1) for one decode step per slot."""
    f = acc_dtype(x)  # fp32, or float64 in a float64 forward
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device, f)
    angles = positions.to(f)[..., None] * inv_freq  # (..., seq, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x.dim() == positions.dim() + 2:  # heads axis between seq and d_head
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.to(f).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
