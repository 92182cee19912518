"""Plain PyTorch versions of the kernels.

They are the math the models use (grouped attention plus a mask), so a
kernel is validated against exactly what the XLA-path layers compute.
The CPU tests use them, and on a CPU tensor the wrappers in
:mod:`repro_torch.kernels.ops` run them in place of the kernel.
"""
from __future__ import annotations

from repro_torch.nn.attention import grouped_attention, make_mask
from repro_torch.nn.ssm import ssd_chunked


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, H, S, D); k/v: (B, KH, T, D) -> (B, H, S, D)."""
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    mask = make_mask(s, t, causal, window, device=q.device)
    out = grouped_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), mask, scale)
    return out.transpose(1, 2)


def ssm_scan_ref(x, dt, a, b_mat, c_mat, *, chunk=128):
    """x: (B, L, H, P); dt: (B, L, H); a: (H,); b/c: (B, L, G, N), G
    dividing H -> (y (B, L, H, P), final state (B, H, N, P) fp32)."""
    return ssd_chunked(x, dt, a, b_mat, c_mat, chunk)
