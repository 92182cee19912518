"""Mamba2 (state-space duality) block, full-sequence forward.

The sequence is split into chunks of ``chunk`` steps: interactions inside
a chunk are matrix products, and the state is carried from one chunk to
the next.  With ``impl="pallas"`` the chunked scan is the CUDA kernel
behind :func:`repro_torch.kernels.ops.ssm_scan` (the name is the JAX
package's, so one spec drives both packages); :func:`ssd_chunked` is its
plain version.  One-token decode arrives with the LM slice.

Layout conventions (the JAX package's):
  x     (B, L, H, P)   inner activations, H heads of dim P
  dt    (B, L, H)      softplus-discretized step sizes
  A     (H,)           negative per-head decay rates
  B_, C_ (B, L, G, N)  input/output projections, G groups, state size N
State: (B, H, N, P).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import initializers as init

IMPLS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_head: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    impl: str = "xla"  # "xla": ssd_chunked | "pallas": the ssm_scan kernel

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"Mamba2 impl {self.impl!r}; expected one of {IMPLS}")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head


def mamba2_init(cfg: Mamba2Config, generator=None, dtype=torch.float32):
    d_in = cfg.d_inner
    conv_dim = d_in + 2 * cfg.n_groups * cfg.d_state
    proj_out = 2 * d_in + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    params = {
        "in_proj": init.scaled_normal(generator, (cfg.d_model, proj_out), dtype),
        "conv_w": init.scaled_normal(generator, (cfg.conv_width, conv_dim), dtype,
                                     fan_in=cfg.conv_width),
        "conv_b": init.zeros(generator, (conv_dim,), dtype),
        "A_log": init.zeros(generator, (cfg.n_heads,), torch.float32),
        "D": init.ones(generator, (cfg.n_heads,), torch.float32),
        "dt_bias": init.zeros(generator, (cfg.n_heads,), torch.float32),
        "norm_scale": init.ones(generator, (d_in,), dtype),
        "out_proj": init.scaled_normal(generator, (d_in, cfg.d_model), dtype,
                                       fan_in=d_in),
    }
    if generator is not None:
        decay = torch.linspace(1.0, 16.0, cfg.n_heads, dtype=torch.float32)
        params["A_log"].copy_(torch.log(decay))
    return params


def causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B,L,C), w: (W,C)."""
    width, length = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, :length] * w[0]
    for i in range(1, width):  # W is tiny (4): no (B, L, W, C) windows tensor
        y = y + xp[:, i : i + length] * w[i]
    return y + b


def ssd_chunked(x, dt, A, B_, C_, chunk):
    """Chunked SSD scan.  Shapes per module docstring; returns (y, final_state).

    y: (B, L, H, P) in x's dtype;  final_state: (B, H, N, P) in fp32.
    """
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    if l % chunk:
        raise ValueError(f"seq {l} must divide chunk {chunk}")
    nc, q = l // chunk, chunk
    rep = h // g

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h).float()
    Bc = B_.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)  # (b,nc,q,h,n)
    Cc = C_.reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)

    a = dtc * A[None, None, None, :]  # (b,nc,q,h) log-decay, negative
    cs = torch.cumsum(a, dim=-2)  # inclusive cumsum within chunk
    total = cs[:, :, -1]  # (b,nc,h)

    # Intra-chunk: att[i,j] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i.
    cb = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc).float()
    cs_t = cs.transpose(2, 3)  # (b,nc,h,q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # Mask in log-space BEFORE exp so j>i never overflows.
    decay = torch.exp(torch.where(tri, cs_t[..., :, None] - cs_t[..., None, :],
                                  float("-inf")))  # (b,nc,h,q_i,q_j)
    att = cb * decay * dtc.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", att.to(x.dtype), xc)

    # Chunk states: S_c = sum_j exp(total - cs_j) dt_j B_j x_j  -> (b,nc,h,n,p)
    w_state = torch.exp(total[:, :, None, :] - cs) * dtc  # (b,nc,q,h)
    s_chunk = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bc.float(), w_state, xc.float())

    # Inter-chunk recurrence over nc: carries[c] is the state entering chunk c.
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    carries = []
    for c in range(nc):
        carries.append(state)
        state = torch.exp(total[:, c])[:, :, None, None] * state + s_chunk[:, c]
    s_carry = torch.stack(carries, dim=1)  # (b,nc,h,n,p)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Cc.float() * torch.exp(cs)[..., None],
                           s_carry)
    y = (y_intra.float() + y_inter).reshape(b, l, h, p)
    return y.to(x.dtype), state


def _split_proj(cfg: Mamba2Config, zxbcdt):
    d_in, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : 2 * d_in + 2 * gn]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * gn :]
    return z, xbc, dt_raw


def _gated_norm(y, z, scale, eps=1e-6):
    yf = (y * F.silu(z.float())).float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * (var + eps) ** -0.5 * scale.float()).to(y.dtype)


def mamba2_apply(params, cfg: Mamba2Config, x):
    """Full-sequence forward.  x: (B, L, d_model) -> (B, L, d_model)."""
    b, l, _ = x.shape
    d_in, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = F.silu(causal_conv1d(xbc, params["conv_w"], params["conv_b"]))
    # views into xbc: the kernel reads them through their strides
    xs = xbc[..., :d_in].reshape(b, l, cfg.n_heads, cfg.d_head)
    B_ = xbc[..., d_in : d_in + gn].reshape(b, l, cfg.n_groups, cfg.d_state)
    C_ = xbc[..., d_in + gn :].reshape(b, l, cfg.n_groups, cfg.d_state)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    chunk = min(cfg.chunk, l)
    while l % chunk:
        chunk -= 1
    if cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops

        y, _ = kops.ssm_scan(xs, dt, A, B_, C_, chunk=chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, B_, C_, chunk)
    y = (y + xs * params["D"][None, None, :, None]).to(x.dtype)
    y = y.reshape(b, l, d_in)
    y = _gated_norm(y, z, params["norm_scale"])
    return y @ params["out_proj"]
