"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, true recurrence).

mLSTM splits the sequence into chunks: work inside a chunk is matrix
products over (chunk x chunk) panels, and the inter-chunk state
``(C, n, m)`` is carried from one chunk to the next.  Exponential gating
is stabilized with the running max ``m`` as in the xLSTM paper.  With
``impl="pallas"`` the chunked cell is the CUDA kernel behind
:func:`repro_torch.kernels.ops.mlstm_scan` (the name is the JAX package's,
so one spec drives both packages); ``"xla"`` runs :func:`mlstm_chunked`.
A step-by-step recurrent oracle (:func:`mlstm_recurrent`) is used by the
tests, and its step by decode.

sLSTM has hidden-state-dependent gates, so it is inherently sequential: a
Python loop over time with block-diagonal (per-head) recurrent matrices.

Decode caches are dicts of tensors; the decode functions return a new
dict, which :mod:`repro_torch.models.lm` writes into the layer's cache.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.api import along, flatten, local, unflatten
from repro_torch.nn import initializers as init
from repro_torch.nn.norms import acc, acc_dtype
from repro_torch.nn.ssm import causal_conv1d
from repro_torch.nn.types import P

IMPLS = ("xla", "pallas")
BIG_NEG = -(10.0 ** 6)


@dataclasses.dataclass(frozen=True)
class MLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    impl: str = "xla"  # "xla": mlstm_chunked | "pallas": the mlstm_scan kernel
    # the JAX package unrolls its chunk scan for XLA's cost analysis; the
    # port's loop over chunks has nothing to unroll, so it changes nothing
    scan_unroll: bool = False

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"mLSTM impl {self.impl!r}; expected one of {IMPLS}")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def d_head(self) -> int:
        return self.d_inner // self.n_heads


@dataclasses.dataclass(frozen=True)
class SLSTMConfig:
    d_model: int
    n_heads: int = 4
    conv_width: int = 4
    proj_factor: float = 4.0 / 3.0

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_up(self) -> int:
        # round up to a multiple of 64, as the JAX package does
        return int(-(-self.d_model * self.proj_factor // 64) * 64)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_init(cfg: MLSTMConfig, generator=None, dtype=torch.float32):
    d_in, h, p = cfg.d_inner, cfg.n_heads, cfg.d_head
    params = {
        "up_proj": P(init.scaled_normal(generator, (cfg.d_model, 2 * d_in), dtype),
                     ("embed", "mlp")),
        "conv_w": P(init.scaled_normal(generator, (cfg.conv_width, d_in), dtype,
                                       fan_in=cfg.conv_width), (None, "mlp")),
        "conv_b": P(init.zeros(generator, (d_in,), dtype), ("mlp",)),
        # per-head block-diagonal projections (official xLSTM BlockLinear)
        "wq": P(init.scaled_normal(generator, (h, p, p), dtype, fan_in=p),
                ("heads", "mlp", None)),
        "wk": P(init.scaled_normal(generator, (h, p, p), dtype, fan_in=p),
                ("heads", "mlp", None)),
        "wv": P(init.scaled_normal(generator, (h, p, p), dtype, fan_in=p),
                ("heads", "mlp", None)),
        "w_if": P(init.scaled_normal(generator, (d_in, 2 * h), torch.float32), ("mlp", None)),
        "b_if": P(init.zeros(generator, (2 * h,), torch.float32), (None,)),
        "norm_scale": P(init.ones(generator, (d_in,), dtype), ("mlp",)),
        "down_proj": P(init.scaled_normal(generator, (d_in, cfg.d_model), dtype,
                                          fan_in=d_in), ("mlp", "embed")),
    }
    if generator is not None:
        params["b_if"][h:] = 3.0  # forget gates start open
    return params


def mlstm_chunked(q, k, v, i_log, f_log, chunk, initial=None):
    """Chunkwise-parallel mLSTM cell.

    q, k, v: (B, L, H, P);  i_log, f_log: (B, L, H) log-space gates.
    Returns (h (B,L,H,P), final (C, n, m)).
    """
    b, l, h, p = q.shape
    if l % chunk:
        raise ValueError(f"seq {l} must divide chunk {chunk}")
    nc, qq = l // chunk, chunk
    scale = p ** -0.5

    qc = q.reshape(b, nc, qq, h, p)
    kc = k.reshape(b, nc, qq, h, p) * scale
    vc = v.reshape(b, nc, qq, h, p)
    ic = acc(i_log.reshape(b, nc, qq, h))
    fc = acc(f_log.reshape(b, nc, qq, h))
    fcum = torch.cumsum(fc, dim=2)  # inclusive within chunk
    ftot = fcum[:, :, -1]  # (b,nc,h)

    if initial is None:
        c_s = torch.zeros((b, h, p, p), dtype=acc_dtype(q), device=q.device)
        n_s = torch.zeros((b, h, p), dtype=acc_dtype(q), device=q.device)
        m_s = torch.full((b, h), float("-inf"), dtype=acc_dtype(q), device=q.device)
    else:
        c_s, n_s, m_s = initial
    tri = torch.tril(torch.ones((qq, qq), dtype=torch.bool, device=q.device))

    hs = []
    for c in range(nc):
        qk_, kk_, vk_ = qc[:, c], kc[:, c], vc[:, c]
        ik_, ftot_k = ic[:, c].transpose(1, 2), ftot[:, c]  # (b,h,q), (b,h)
        # log weights: intra  a[i,j] = fcum_i - fcum_j + i_j   (j <= i)
        #              inter  b[i]   = fcum_i + m_s
        fci = fcum[:, c].transpose(1, 2)  # (b,h,q)
        a_log = fci[..., :, None] - fci[..., None, :] + ik_[..., None, :]
        a_log = torch.where(tri, a_log, float("-inf"))  # (b,h,qi,qj)
        b_log = fci + m_s[..., None]  # (b,h,q)
        m_i = torch.maximum(torch.amax(a_log, dim=-1), b_log)
        m_i = torch.clamp_min(m_i, BIG_NEG)  # avoid -inf - -inf
        intra_w = torch.exp(a_log - m_i[..., None])
        inter_w = torch.exp(b_log - m_i)

        qkT = acc(torch.einsum("bqhp,bjhp->bhqj", qk_, kk_))
        s_intra = qkT * intra_w
        h_num = acc(torch.einsum("bhqj,bjhp->bqhp", s_intra.to(vk_.dtype), vk_))
        qf = acc(qk_)
        h_num = h_num + torch.einsum("bqhp,bhpd->bqhd", qf, c_s) * inter_w.transpose(1, 2)[..., None]
        denom = s_intra.sum(dim=-1)  # (b,h,q)
        denom = denom + torch.einsum("bqhp,bhp->bhq", qf, n_s) * inter_w
        denom = torch.maximum(denom.abs(), torch.exp(-m_i))
        hs.append(h_num / denom.transpose(1, 2)[..., None])

        # state update to chunk end
        w_log = ftot_k[..., None] - fci + ik_  # (b,h,q)
        m_next = torch.maximum(ftot_k + m_s, torch.amax(w_log, dim=-1))
        m_next = torch.clamp_min(m_next, BIG_NEG)
        kw = torch.exp(w_log - m_next[..., None])  # (b,h,q)
        kwf = acc(kk_) * kw.transpose(1, 2)[..., None]  # (b,q,h,p)
        c_upd = torch.einsum("bjhp,bjhd->bhpd", kwf, acc(vk_))
        n_upd = kwf.sum(dim=1)
        carry = torch.exp(ftot_k + m_s - m_next)[..., None]
        c_s = carry[..., None] * c_s + c_upd
        n_s = carry * n_s + n_upd
        m_s = m_next
    h_seq = torch.stack(hs, dim=1).reshape(b, l, h, p)
    return h_seq.to(q.dtype), (c_s, n_s, m_s)


def mlstm_step(state, q_t, k_t, v_t, i_t, f_t):
    """Single recurrent mLSTM step.  q/k/v: (B,H,P); i/f: (B,H) raw logs.
    state = (C (B,H,P,P), n (B,H,P), m (B,H))."""
    c_s, n_s, m_s = state
    p = q_t.shape[-1]
    k_t = k_t * (p ** -0.5)
    m_next = torch.maximum(f_t + m_s, i_t)
    m_next = torch.clamp_min(m_next, BIG_NEG)
    f_w = torch.exp(f_t + m_s - m_next)[..., None]
    i_w = torch.exp(i_t - m_next)[..., None]
    kf, vf = acc(k_t), acc(v_t)
    c_next = f_w[..., None] * c_s + i_w[..., None] * kf[..., :, None] * vf[..., None, :]
    n_next = f_w * n_s + i_w * kf
    qf = acc(q_t)
    num = torch.einsum("bhp,bhpd->bhd", qf, c_next)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n_next).abs(), torch.exp(-m_next))
    h = num / den[..., None]
    return (c_next, n_next, m_next), h.to(q_t.dtype)


def mlstm_recurrent(q, k, v, i_log, f_log, initial=None):
    """Step-by-step oracle.  Same shapes/returns as :func:`mlstm_chunked`."""
    b, l, h, p = q.shape
    if initial is None:
        initial = (
            torch.zeros((b, h, p, p), dtype=acc_dtype(q), device=q.device),
            torch.zeros((b, h, p), dtype=acc_dtype(q), device=q.device),
            torch.full((b, h), float("-inf"), dtype=acc_dtype(q), device=q.device),
        )
    state, hs = initial, []
    for t in range(l):
        state, h_t = mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                acc(i_log[:, t]), acc(f_log[:, t]))
        hs.append(h_t)
    return torch.stack(hs, dim=1), state


def _group_norm_heads(x, scale, eps=1e-6):
    """Per-head group norm over the head dim. x: (B,L,H,P), scale: (H*P,)."""
    b, l, h, p = x.shape
    xf = acc(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * (var + eps) ** -0.5
    return (flatten(y, 2, 3) * acc(scale)).to(x.dtype)


def _mlstm_qkv_gates(params, cfg: MLSTMConfig, x, conv_state=None):
    b, l, _ = x.shape
    d_in = cfg.d_inner
    up = x @ params["up_proj"]
    xm, z = up[..., :d_in], up[..., d_in:]
    if conv_state is None:
        xc = F.silu(causal_conv1d(xm, params["conv_w"], params["conv_b"]))
        new_conv = None
    else:
        xc, new_conv = causal_conv1d(xm, params["conv_w"], params["conv_b"], state=conv_state)
        xc = F.silu(xc)
    xch = unflatten(xc, -1, (cfg.n_heads, cfg.d_head))
    xmh = unflatten(xm, -1, (cfg.n_heads, cfg.d_head))
    q = torch.einsum("blhp,hpk->blhk", xch, params["wq"])
    k = torch.einsum("blhp,hpk->blhk", xch, params["wk"])
    v = torch.einsum("blhp,hpk->blhk", xmh, params["wv"])
    if_pre = acc(xm) @ params["w_if"] + params["b_if"]
    i_log = if_pre[..., : cfg.n_heads]
    f_log = along(F.logsigmoid, if_pre[..., cfg.n_heads :])  # DTensor: no backward rule
    return q, k, v, i_log, f_log, z, new_conv


def _fit_chunk(l: int, chunk: int) -> int:
    ck = min(chunk, l)
    while l % ck:
        ck -= 1
    return ck


def mlstm_block_apply(params, cfg: MLSTMConfig, x):
    """Full mLSTM block: up-proj, conv, cell, gated output, down-proj."""
    q, k, v, i_log, f_log, z, _ = _mlstm_qkv_gates(params, cfg, x)
    chunk = _fit_chunk(x.shape[1], cfg.chunk)
    if cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops

        def cell(*t):
            return kops.mlstm_scan(*t, chunk=chunk)[0]
    else:
        def cell(*t):
            return mlstm_chunked(*t, chunk)[0]
    # inside a sharding context the cell runs on local shards (batch and
    # heads): DTensor would refuse its flattens of (batch, heads)
    qkv, gates = ("batch", None, "heads", None), ("batch", None, "heads")
    h = local(cell, q, k, v, i_log, f_log, axes=(qkv, qkv, qkv, gates, gates))
    h = _group_norm_heads(h, params["norm_scale"])
    h = h * F.silu(z)
    return h @ params["down_proj"]


def init_mlstm_cache(cfg: MLSTMConfig, batch, dtype=torch.float32, device=None):
    p = cfg.d_head
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner), dtype=dtype, device=device),
        "c": torch.zeros((batch, cfg.n_heads, p, p), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, cfg.n_heads, p), dtype=torch.float32, device=device),
        "m": torch.full((batch, cfg.n_heads), BIG_NEG, dtype=torch.float32, device=device),
    }


def mlstm_block_decode(params, cfg: MLSTMConfig, x, cache):
    """One-token decode.  x: (B,1,d_model).  Returns (y, new cache)."""
    q, k, v, i_log, f_log, z, new_conv = _mlstm_qkv_gates(
        params, cfg, x, conv_state=cache["conv"].to(x.dtype))
    state = (cache["c"], cache["n"], cache["m"])
    state, h_t = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0], i_log[:, 0], f_log[:, 0])
    h = _group_norm_heads(h_t[:, None], params["norm_scale"])
    h = h * F.silu(z)
    new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                 "c": state[0], "n": state[1], "m": state[2]}
    return h @ params["down_proj"], new_cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_init(cfg: SLSTMConfig, generator=None, dtype=torch.float32):
    d, hh, p = cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "conv_w": P(init.scaled_normal(generator, (cfg.conv_width, d), dtype,
                                       fan_in=cfg.conv_width), (None, "embed")),
        "conv_b": P(init.zeros(generator, (d,), dtype), ("embed",)),
        "w_gates": P(init.scaled_normal(generator, (d, 4 * d), dtype), ("embed", "mlp")),
        "r_gates": P(init.scaled_normal(generator, (hh, p, 4 * p), dtype, fan_in=p),
                     (None, None, None)),
        "b_gates": P(init.zeros(generator, (4 * d,), torch.float32), ("mlp",)),
        "norm_scale": P(init.ones(generator, (d,), dtype), ("embed",)),
        "up_proj": P(init.scaled_normal(generator, (d, 2 * cfg.d_up), dtype), ("embed", "mlp")),
        "down_proj": P(init.scaled_normal(generator, (cfg.d_up, d), dtype, fan_in=cfg.d_up),
                       ("mlp", "embed")),
    }


def slstm_cell_step(state, x_gates, r_w, n_heads, d_head):
    """One sLSTM step.  state = (c, n, m, h), each (B, H, P).
    x_gates: (B, 4*d) input-side gate preactivations."""
    c_s, n_s, m_s, h_s = state
    b = x_gates.shape[0]
    # recurrent contribution: block-diagonal per head
    h_heads = h_s.reshape(b, n_heads, d_head)
    r_contrib = torch.einsum("bhp,hpk->bhk", acc(h_heads), acc(r_w))
    # gate layout is per-head-major: (head, gate-kind, unit)
    gates = (unflatten(acc(x_gates), -1, (n_heads, 4, d_head))
             + r_contrib.reshape(b, n_heads, 4, d_head))
    i_raw, f_raw = gates[:, :, 0], gates[:, :, 1]
    z_raw, o_raw = gates[:, :, 2], gates[:, :, 3]
    f_log = along(F.logsigmoid, f_raw)  # DTensor has no rule for its backward
    m_next = torch.maximum(f_log + m_s, i_raw)
    m_next = torch.clamp_min(m_next, BIG_NEG)
    i_w = torch.exp(i_raw - m_next)
    f_w = torch.exp(f_log + m_s - m_next)
    c_next = f_w * c_s + i_w * torch.tanh(z_raw)
    n_next = f_w * n_s + i_w
    h_next = torch.sigmoid(o_raw) * c_next / torch.clamp_min(n_next, 1.0)
    return (c_next, n_next, m_next, h_next.to(h_s.dtype))


def slstm_block_apply(params, cfg: SLSTMConfig, x, cache=None):
    """sLSTM block forward (a loop over time).  x: (B, L, d_model).

    When ``cache`` is given (decode), x is (B, 1, d) and the new cache is
    returned alongside the output.
    """
    b, l, d = x.shape
    hp = (b, cfg.n_heads, cfg.d_head)
    decode = cache is not None
    if decode:
        xc, new_conv = causal_conv1d(x, params["conv_w"], params["conv_b"],
                                     state=cache["conv"].to(x.dtype))
        xc = F.silu(xc)
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        xc = F.silu(causal_conv1d(x, params["conv_w"], params["conv_b"]))
        state = (
            torch.zeros(hp, dtype=acc_dtype(x), device=x.device),
            torch.zeros(hp, dtype=acc_dtype(x), device=x.device),
            torch.full(hp, BIG_NEG, dtype=acc_dtype(x), device=x.device),
            torch.zeros(hp, dtype=x.dtype, device=x.device),
        )
    x_gates_all = xc @ params["w_gates"] + params["b_gates"]

    if decode:
        state = slstm_cell_step(state, x_gates_all[:, 0], params["r_gates"],
                                cfg.n_heads, cfg.d_head)
        h_seq = flatten(state[3], 1, 2)[:, None]
        new_cache = {"conv": new_conv.to(cache["conv"].dtype), "c": state[0],
                     "n": state[1], "m": state[2], "h": state[3]}
    else:
        def scan(x_gates_all, r_gates, *state):
            hs = []
            for t in range(l):
                state = slstm_cell_step(state, x_gates_all[:, t], r_gates,
                                        cfg.n_heads, cfg.d_head)
                hs.append(state[3])
            return torch.stack(hs, dim=1)

        # the time loop on local shards (batch kept, heads whole): on
        # DTensors each of its ~20 ops a step would pass DTensor's dispatch
        h_seq = local(scan, x_gates_all, params["r_gates"], *state,
                      axes=[("batch", None, None), (None, None, None)]
                      + [("batch", None, None)] * 4).reshape(b, l, d)

    # output: group norm + gated up/down projection
    xf = acc(h_seq).reshape(b, -1, cfg.n_heads, cfg.d_head)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * (var + 1e-6) ** -0.5).reshape(b, -1, d).to(x.dtype) * params["norm_scale"]
    u1, u2 = (y @ params["up_proj"]).chunk(2, dim=-1)
    out = (F.gelu(u1, approximate="tanh") * u2) @ params["down_proj"]
    if decode:
        return out, new_cache
    return out


def init_slstm_cache(cfg: SLSTMConfig, batch, dtype=torch.float32, device=None):
    hp = (batch, cfg.n_heads, cfg.d_head)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_model), dtype=dtype, device=device),
        "c": torch.zeros(hp, dtype=torch.float32, device=device),
        "n": torch.zeros(hp, dtype=torch.float32, device=device),
        "m": torch.full(hp, BIG_NEG, dtype=torch.float32, device=device),
        "h": torch.zeros(hp, dtype=dtype, device=device),
    }
