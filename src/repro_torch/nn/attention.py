"""Grouped-query attention with qk-norm, RoPE, sliding windows and KV caches.

Four entry points:
  * ``attention_init``    -- parameters
  * ``attention_apply``   -- full-sequence self-attention
  * ``attention_prefill`` -- full-sequence attention that also writes the
                             prompt's K/V into a preallocated cache
  * ``attention_decode``  -- single-token decode against that cache

The caches are updated in place: a serving cache is the largest tensor
the engine holds, and copying it per step (as an immutable-array
framework must) would double its memory traffic.

The sequence-mixing math is grouped (no materialized KV repetition): q is
reshaped to (batch, seq, kv_heads, group, d_head) and contracted directly
against the grouped KV.  The plain path's softmax and norms sum in fp32,
or in float64 when the weights are float64
(:func:`repro_torch.nn.norms.acc`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn import initializers as init
from repro_torch.nn.norms import acc
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30
IMPLS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: Optional[int] = None
    use_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None  # sliding-window size (None = full)
    # "xla": plain grouped attention; "pallas": the flash-attention kernel
    # (the names are the JAX package's, so one spec drives both packages)
    impl: str = "xla"
    softmax_scale: Optional[float] = None

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise NotImplementedError(
                f"attention impl {self.impl!r} is not ported; the port has "
                f"{IMPLS} (xla_chunked: ROADMAP.md Queue 1 item 9b)")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def scale(self) -> float:
        return (self.softmax_scale if self.softmax_scale is not None
                else self.head_dim ** -0.5)


def attention_init(cfg: AttentionConfig, generator=None, dtype=torch.float32):
    dh = cfg.head_dim
    hd, kd = cfg.n_heads * dh, cfg.n_kv_heads * dh
    params = {
        "wq": init.scaled_normal(generator, (cfg.d_model, hd), dtype),
        "wk": init.scaled_normal(generator, (cfg.d_model, kd), dtype),
        "wv": init.scaled_normal(generator, (cfg.d_model, kd), dtype),
        "wo": init.scaled_normal(generator, (hd, cfg.d_model), dtype, fan_in=hd),
    }
    if cfg.use_bias:
        params["bq"] = init.zeros(generator, (hd,), dtype)
        params["bk"] = init.zeros(generator, (kd,), dtype)
        params["bv"] = init.zeros(generator, (kd,), dtype)
    if cfg.qk_norm:
        params["q_norm"] = init.ones(generator, (dh,), dtype)
        params["k_norm"] = init.ones(generator, (dh,), dtype)
    return params


def _headwise_rmsnorm(x, scale, eps=1e-6):
    xf = acc(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)).to(x.dtype)


def _project_qkv(params, cfg: AttentionConfig, x, positions):
    """Returns q:(B,S,H,Dh), k/v:(B,S,KH,Dh), qk-normed and rotated."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if cfg.use_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, s, cfg.n_kv_heads, dh)
    v = v.reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = _headwise_rmsnorm(q, params["q_norm"])
        k = _headwise_rmsnorm(k, params["k_norm"])
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def grouped_attention(q, k, v, mask, scale):
    """Core GQA soft-attention.

    q: (B,S,H,Dh), k/v: (B,T,K,Dh), mask: bool, broadcastable to
    (B,K,G,S,T).  Returns (B,S,H,Dh).
    """
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, s, kheads, h // kheads, dh)
    scores = acc(torch.einsum("bskgd,btkd->bkgst", qg, k)) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def make_mask(s, t, causal, window, q_offset=0, device=None):
    """(1,1,1,S,T) boolean attention mask."""
    qi = torch.arange(s, device=device)[:, None] + q_offset
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    return mask[None, None, None]


def _flash(q, k, v, cfg: AttentionConfig):
    from repro_torch.kernels import ops as kops

    return kops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                                scale=cfg.scale)


def attention_apply(params, cfg: AttentionConfig, x, positions=None, mask=None):
    """Full-sequence self-attention.  x: (B,S,d_model)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cfg.impl == "pallas":
        out = _flash(q, k, v, cfg)
    else:
        if mask is None:
            mask = make_mask(s, s, cfg.causal, cfg.window, device=x.device)
        out = grouped_attention(q, k, v, mask, cfg.scale)
    return out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"]


def init_kv_cache(cfg: AttentionConfig, batch, max_seq, dtype=torch.float32,
                  device=None):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(params, cfg: AttentionConfig, x, cache, pos_offset=0):
    """Batched prefill: full-sequence attention through the same kernel
    dispatch as :func:`attention_apply`, writing the prompt's K/V into
    cache positions ``[pos_offset, pos_offset+S)`` in place.

    Returns (y (B,S,d_model), cache).
    """
    b, s, _ = x.shape
    t = pos_offset + s
    if t > cache["k"].shape[1]:
        raise ValueError(f"prompt ends at {t}, past the cache's "
                         f"{cache['k'].shape[1]} positions")
    positions = (pos_offset + torch.arange(s, device=x.device))[None]
    q, k, v = _project_qkv(params, cfg, x, positions)
    cache["k"][:, pos_offset:t] = k.to(cache["k"].dtype)
    cache["v"][:, pos_offset:t] = v.to(cache["v"].dtype)
    if cfg.impl == "pallas" and pos_offset == 0:
        out = _flash(q, k, v, cfg)
    else:
        # pos_offset > 0 (chunked prompt ingestion) attends against the
        # cache prefix, which the flash path does not slice
        mask = make_mask(s, t, cfg.causal, cfg.window, q_offset=pos_offset,
                         device=x.device)
        out = grouped_attention(q, cache["k"][:, :t].to(q.dtype),
                                cache["v"][:, :t].to(q.dtype), mask, cfg.scale)
    y = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return y, cache


def attention_decode(params, cfg: AttentionConfig, x, cache, pos):
    """One-token decode.  x: (B,1,d_model); pos: an int, or an integer
    tensor (B,) of *per-sequence* positions (continuous batching: each
    serving slot decodes at its own depth).

    Writes the new K/V into ``cache`` in place and attends to positions
    ``<= pos`` (within the sliding window when configured).
    """
    b = x.shape[0]
    per_slot = torch.is_tensor(pos) and pos.dim() == 1
    if per_slot:
        pos = pos.to(device=x.device, dtype=torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    if per_slot:
        # scatter one (K,Dh) row per sequence at that sequence's position
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    else:
        cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    kj = torch.arange(cache["k"].shape[1], device=x.device)[None, :]
    valid = kj <= positions  # (B,T)
    if cfg.window is not None:
        valid &= kj > positions - cfg.window
    mask = valid[:, None, None, None, :]  # (B,1,1,1,T)
    out = grouped_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                            mask, cfg.scale)
    y = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return y, cache
