"""Grouped-query attention with qk-norm, RoPE, sliding windows, KV caches
and cross-attention.

Entry points:
  * ``attention_init``        -- parameters
  * ``attention_apply``       -- full-sequence attention (training, the
                                 encoder, cross-attention with ``kv_x``)
  * ``attention_prefill``     -- full-sequence attention that also writes
                                 the prompt's K/V into a preallocated cache
  * ``attention_decode``      -- single-token decode against that cache
  * ``precompute_cross_kv``   -- an encoder output's K/V, projected once
  * ``cross_attention_cached``-- cross-attention against them

The caches are updated in place: a serving cache is the largest tensor
the engine holds, and copying it per step (as an immutable-array
framework must) would double its memory traffic.

The sequence-mixing math is grouped (no materialized KV repetition): q is
reshaped to (batch, seq, kv_heads, group, d_head) and contracted directly
against the grouped KV.  The plain path's softmax and norms sum in fp32,
or in float64 when the weights are float64
(:func:`repro_torch.nn.norms.acc`).  ``impl`` picks the full-sequence
path of self-attention: ``"xla"`` the grouped math, ``"xla_chunked"`` an
online softmax over KV chunks (:func:`chunked_attention`), ``"pallas"``
the flash kernel.  Cross-attention always takes the grouped math, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed.api import (constrain, current_mesh, from_local, is_dtensor,
                                         local, placed_grad, spec, to_local, write_at)
from repro_torch.nn import initializers as init
from repro_torch.nn.norms import acc, acc_dtype
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.types import P

NEG_INF = -1e30
IMPLS = ("xla", "xla_chunked", "pallas")


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
    # "xla": plain grouped attention; "xla_chunked": an online softmax over
    # KV chunks; "pallas": the flash-attention kernel (the names are the JAX
    # package's, so one spec drives both packages)
    impl: str = "xla"
    softmax_scale: Optional[float] = None
    # the JAX package unrolls its chunked-attention KV scan for XLA's cost
    # analysis; the port's loop over chunks has nothing to unroll, so it
    # changes nothing
    scan_unroll: bool = False
    kv_chunk: int = 1024  # xla_chunked block size (halved until it divides T)
    # inside a sharding context, full-sequence self-attention shards q's
    # sequence over the model axis ("act_seq") and replicates k/v's heads
    seq_shard: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise NotImplementedError(
                f"attention impl {self.impl!r} is not ported; the port has {IMPLS}")
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
        "wq": P(init.scaled_normal(generator, (cfg.d_model, hd), dtype), ("embed", "heads")),
        "wk": P(init.scaled_normal(generator, (cfg.d_model, kd), dtype),
                ("embed", "kv_heads")),
        "wv": P(init.scaled_normal(generator, (cfg.d_model, kd), dtype),
                ("embed", "kv_heads")),
        "wo": P(init.scaled_normal(generator, (hd, cfg.d_model), dtype, fan_in=hd),
                ("heads", "embed")),
    }
    if cfg.use_bias:
        params["bq"] = P(init.zeros(generator, (hd,), dtype), ("heads",))
        params["bk"] = P(init.zeros(generator, (kd,), dtype), ("kv_heads",))
        params["bv"] = P(init.zeros(generator, (kd,), dtype), ("kv_heads",))
    if cfg.qk_norm:
        params["q_norm"] = P(init.ones(generator, (dh,), dtype), (None,))
        params["k_norm"] = P(init.ones(generator, (dh,), dtype), (None,))
    return params


def _headwise_rmsnorm(x, scale, eps=1e-6):
    xf = acc(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)).to(x.dtype)


def _split_heads(x, heads: int, dh: int, axis: str):
    """(B, S, heads * dh) -> (B, S, heads, dh).  In a sharding context a
    projection whose columns split over the mesh but whose heads do not
    (kv_heads = 8 on model = 16) is gathered first: DTensor refuses to
    cut a head."""
    b, s, _ = x.shape
    split = spec((b, s, heads, dh), ("batch", None, axis, None))
    if split is not None and split[2] is None:
        x = constrain(x, ("batch", None, None))
    return x.reshape(b, s, heads, dh)


def _project_qkv(params, cfg: AttentionConfig, x, kv_x, positions, kv_positions,
                 constrain_full_seq: bool = False):
    """q from ``x``, k/v from ``kv_x`` (``x`` itself for self-attention).
    Returns q:(B,S,H,Dh), k/v:(B,T,KH,Dh), qk-normed and rotated.

    ``constrain_full_seq`` (full-sequence self-attention with
    ``seq_shard``) pins q to sequence-sharded ("act_seq") and k/v to
    replicated heads, as the JAX package does.  Outside a sharding
    context the constraints are no-ops."""
    b, s, _ = x.shape
    t = kv_x.shape[1]
    dh = cfg.head_dim
    q, k, v = x @ params["wq"], kv_x @ params["wk"], kv_x @ params["wv"]
    if cfg.use_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _split_heads(q, cfg.n_heads, dh, "heads")
    k = _split_heads(k, cfg.n_kv_heads, dh, "kv_heads")
    v = _split_heads(v, cfg.n_kv_heads, dh, "kv_heads")
    if constrain_full_seq:
        q = constrain(q, ("batch", "act_seq", None, None))
        k = constrain(k, ("batch", None, None, None))
        v = constrain(v, ("batch", None, None, None))
    if cfg.qk_norm:
        q = _headwise_rmsnorm(q, params["q_norm"])
        k = _headwise_rmsnorm(k, params["k_norm"])
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, scale, *, causal=True, window=None, kv_chunk=1024):
    """Flash-style attention in plain PyTorch: a loop over KV chunks with an
    online softmax, O(S * kv_chunk) score memory instead of O(S^2).

    q: (B,S,H,Dh); k/v: (B,T,K,Dh), T a multiple of ``kv_chunk``.  Returns
    (B,S,H,Dh).
    """
    b, s, h, dh = q.shape
    t, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    if t % kv_chunk:
        raise ValueError(f"kv_chunk {kv_chunk} does not divide T={t}")
    qg = q.reshape(b, s, kheads, g, dh)
    q_pos = torch.arange(s, device=q.device)[:, None]
    dt = acc_dtype(q)
    m = torch.full((b, kheads, g, s), NEG_INF, dtype=dt, device=q.device)
    l_sum = torch.zeros((b, kheads, g, s), dtype=dt, device=q.device)
    out = torch.zeros((b, kheads, g, s, dh), dtype=dt, device=q.device)
    for start in range(0, t, kv_chunk):
        k_blk, v_blk = k[:, start:start + kv_chunk], v[:, start:start + kv_chunk]
        scores = acc(torch.einsum("bskgd,btkd->bkgst", qg, k_blk)) * scale
        k_pos = start + torch.arange(kv_chunk, device=q.device)[None, :]
        mask = torch.ones((s, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        scores = scores.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]).masked_fill(~mask, 0.0)
        alpha = torch.exp(m - m_new)
        l_sum = alpha * l_sum + p.sum(dim=-1)
        out = out * alpha[..., None] + acc(torch.einsum(
            "bkgst,btkd->bkgsd", p.to(v_blk.dtype), v_blk))
        m = m_new
    out = out / l_sum.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def _kv_chunk(cfg: AttentionConfig, t: int) -> int:
    """The JAX package's chunk rule: ``cfg.kv_chunk``, at most T, halved
    until it divides T."""
    kv_chunk = min(cfg.kv_chunk, t)
    while t % kv_chunk:
        kv_chunk //= 2
    return max(kv_chunk, 1)


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


def _core_axes(q, k, seq_sharded: bool):
    """Logical axes of q and of k/v for the core on local shards, and
    whether each rank picks its q heads' kv heads from whole k and v.
    Batch, and q's sequence (``seq_shard``) or the heads: the kv heads
    split with q's where they split alike, and stay whole where they do
    not (kv_heads = 8 on model = 16), each rank then indexing the ones
    its q heads read."""
    whole = ("batch", None, None, None)
    if seq_sharded:
        return ("batch", "act_seq", None, None), whole, False
    qa, ka = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
    q_spec, k_spec = spec(q, qa), spec(k, ka)
    if q_spec is None or q_spec[2] == k_spec[2] or k.shape[2] == 1:
        return qa, ka, False
    return qa, whole, True


def _on_shards(attend, q, k, v, mask, cfg: AttentionConfig, seq_sharded: bool = False):
    """``attend(q, k, v, mask)`` run on local shards (DTensor would refuse
    the flattens of its batched matmuls): batch and q's heads (or its
    sequence) split, the kv heads split alike or indexed from whole k and
    v (:func:`_core_axes`).  Outside a sharding context it is ``attend``'s
    call."""
    qa, ka, by_index = _core_axes(q, k, seq_sharded)

    def on_local(q, k, v, *rest):
        if by_index:  # each local q head's kv head, from the whole k and v
            *rest, idx = rest
            k, v = k[:, :, idx], v[:, :, idx]
        return attend(q, k, v, rest[0] if rest else None)

    args, axes = [q, k, v], [qa, ka, ka]
    if mask is not None:
        args.append(mask)
        axes.append(("batch", None, None, qa[1], None))
    if by_index:
        rep = cfg.n_heads // cfg.n_kv_heads
        args.append(torch.arange(cfg.n_heads, device=q.device) // rep)
        axes.append(("heads",))
    return local(on_local, *args, axes=axes)


def _flash(q, k, v, cfg: AttentionConfig):
    from repro_torch.kernels import ops as kops

    return kops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                                scale=cfg.scale)


def attention_apply(params, cfg: AttentionConfig, x, positions=None, kv_x=None,
                    kv_positions=None, mask=None):
    """Full-sequence attention.  x: (B,S,d_model); ``kv_x`` (B,T,d_model)
    makes it cross-attention, which is non-causal, has no window and
    always runs the grouped math (never the kernel)."""
    b, s, _ = x.shape
    cross = kv_x is not None
    if kv_x is None:
        kv_x = x
    t = kv_x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None]
    if kv_positions is None:
        kv_positions = torch.arange(t, device=x.device)[None]
    full_seq = cfg.seq_shard and not cross
    q, k, v = _project_qkv(params, cfg, x, kv_x, positions, kv_positions,
                           constrain_full_seq=full_seq)
    if cfg.impl == "pallas" and not cross:
        core, kv_chunk = "flash", None
    elif cfg.impl == "xla_chunked" and not cross:
        core, kv_chunk = "chunked", _kv_chunk(cfg, t)
    else:
        core, kv_chunk = "grouped", None
        if mask is None:
            mask = make_mask(s, t, cfg.causal and not cross,
                             None if cross else cfg.window, device=x.device)
    # a q sequence shard needs the mask's rows, so only the grouped math
    # keeps one (the kernels take no row offset)
    seq_sharded = full_seq and core == "grouped"

    def attend(q, k, v, mask):
        if core == "flash":
            return _flash(q, k, v, cfg)
        if core == "chunked":
            return chunked_attention(q, k, v, cfg.scale, causal=cfg.causal,
                                     window=cfg.window, kv_chunk=kv_chunk)
        return grouped_attention(q, k, v, mask, cfg.scale)

    out = _on_shards(attend, q, k, v, mask, cfg, seq_sharded)
    if seq_sharded:
        # to the heads for the output projection: DTensor (torch 2.11)
        # refuses to flatten (batch, sequence) with the inner dim sharded
        out = constrain(out, ("batch", None, "heads", None))
    # the flatten's gradient comes back on the flattened heads as the
    # forward placed them: DTensor's choice for it (the heads' dim sharded)
    # cannot be cut into heads that do not split evenly (56 on model = 16)
    out = placed_grad(out.reshape(b, s, cfg.n_heads * cfg.head_dim))
    return out @ params["wo"]


def init_kv_cache(cfg: AttentionConfig, batch, max_seq, dtype=torch.float32,
                  device=None):
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def precompute_cross_kv(params, cfg: AttentionConfig, enc_out, dtype=torch.float32):
    """Project an encoder output (B,T,d_model) once into the cross-attention
    cache ``{"k", "v"}`` (B,T,KH,Dh) every decode step reads."""
    b, t, _ = enc_out.shape
    k, v = enc_out @ params["wk"], enc_out @ params["wv"]
    if cfg.use_bias:
        k, v = k + params["bk"], v + params["bv"]
    dh = cfg.head_dim
    return {"k": k.reshape(b, t, cfg.n_kv_heads, dh).to(dtype),
            "v": v.reshape(b, t, cfg.n_kv_heads, dh).to(dtype)}


def cross_attention_cached(params, cfg: AttentionConfig, x, cache):
    """Cross-attention of x (B,S,d_model) against a precomputed cross-KV
    cache: every position attends to every encoder frame, with no RoPE.
    An empty cache (no encoder output) gives zeros."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = x @ params["wq"]
    if cfg.use_bias:
        q = q + params["bq"]
    q = _split_heads(q, cfg.n_heads, dh, "heads")
    if cfg.qk_norm:
        q = _headwise_rmsnorm(q, params["q_norm"])
    t = cache["k"].shape[1]
    mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=x.device)
    out = _on_shards(lambda q, k, v, mask: grouped_attention(q, k, v, mask, cfg.scale),
                     q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), mask, cfg)
    return out.reshape(b, s, cfg.n_heads * dh) @ params["wo"]


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
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions)
    cache["k"][:, pos_offset:t] = k.to(cache["k"].dtype)
    cache["v"][:, pos_offset:t] = v.to(cache["v"].dtype)
    if cfg.impl == "pallas" and pos_offset == 0:
        out = _flash(q, k, v, cfg)
    elif cfg.impl == "xla_chunked" and pos_offset == 0:
        out = chunked_attention(q, k, v, cfg.scale, causal=cfg.causal, window=cfg.window,
                                kv_chunk=_kv_chunk(cfg, s))
    else:
        # pos_offset > 0 (chunked prompt ingestion) attends against the
        # cache prefix, which the flash and chunked paths do not slice
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
    q, k_new, v_new = _project_qkv(params, cfg, x, x, positions, positions)
    if per_slot:
        # scatter one (K,Dh) row per sequence at that sequence's position
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, pos] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v_new[:, 0].to(cache["v"].dtype)
    else:
        write_at(cache["k"], 1, pos, k_new[:, 0].to(cache["k"].dtype))
        write_at(cache["v"], 1, pos, v_new[:, 0].to(cache["v"].dtype))
    kj = torch.arange(cache["k"].shape[1], device=x.device)[None, :]
    valid = kj <= positions  # (B,T)
    if cfg.window is not None:
        valid &= kj > positions - cfg.window
    if is_dtensor(cache["k"]) and current_mesh() is not None:
        out = _decode_on_shards(q, cache["k"], cache["v"], valid, cfg.scale)
    else:
        mask = valid[:, None, None, None, :]  # (B,1,1,1,T)
        out = grouped_attention(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                                mask, cfg.scale)
    y = out.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return y, cache


def decode_partials(q, k, v, valid, scale):
    """One query's attention over a part of the cache, unnormalised: the
    part's score max ``m`` (B,KH,G,1,1), the sum ``l`` of exp(score - m)
    and ``o`` = exp(score - m) @ v (B,1,KH,G,Dh), in the accumulation
    dtype.  Parts combine exactly by :func:`combine_partials`."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    qg = q.reshape(b, s, kheads, h // kheads, dh)
    scores = acc(torch.einsum("bskgd,btkd->bkgst", qg, k.to(q.dtype))) * scale
    scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum("bkgst,btkd->bskgd", p, acc(v))


def combine_partials(m_max, m, l_sum, o):
    """Rescale a part's ``(m, l, o)`` to the global max ``m_max``: summed
    over the parts, ``o / l`` is the softmax-weighted sum."""
    w = torch.exp(m - m_max)
    return l_sum * w, o * w.permute(0, 3, 1, 2, 4)


def _decode_on_shards(q, k, v, valid, scale):
    """Decode attention against a DTensor cache, as XLA partitions the
    reference's: the cache stays where it is (batch and sequence
    sharded), q and the valid mask follow its batch, each rank attends
    over its part of the sequence, and the parts combine through an
    all-reduce of the max, then of the sums (``Partial`` placements)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = k.device_mesh
    kp = tuple(k.placements)
    seq = [i for i, p in enumerate(kp) if p.is_shard(1)]
    kv_target = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in kp]
    q_target = [Shard(0) if p.is_shard(0) else Replicate() for p in kp]
    k_l, v_l = to_local(k, kv_target), to_local(v, kv_target)
    q_l = to_local(q if is_dtensor(q) else from_local(q, mesh, [Replicate()] * mesh.ndim),
                   q_target)
    valid_l = to_local(from_local(valid, mesh, [Replicate()] * mesh.ndim), kv_target)

    def over_parts(t, op):
        if not seq:
            return t
        part = [Partial(op) if i in seq else q_target[i] for i in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, part, run_check=False).redistribute(
            mesh, q_target).to_local()

    m, l_sum, o = decode_partials(q_l, k_l, v_l, valid_l, scale)
    l_sum, o = combine_partials(over_parts(m, "max"), m, l_sum, o)
    out = over_parts(o, "sum") / over_parts(l_sum, "sum").permute(0, 3, 1, 2, 4)
    b, s, kheads, g, dh = out.shape
    return from_local(out.reshape(b, s, kheads * g, dh).to(q.dtype), mesh, q_target)
