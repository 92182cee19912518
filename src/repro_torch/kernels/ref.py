"""Plain PyTorch versions of the kernels.

Flash attention and the SSD scan are the math the models use (grouped
attention plus a mask, ``ssd_chunked``), so those kernels are validated
against exactly what the XLA-path layers compute; :func:`ssm_scan_chunks`
is the same scan in the CUDA kernel's order, with hooks for its products
and its precision.  The mLSTM scan's
plain version is the Pallas kernel's own formulation, which differs in
small ways from the layer's ``mlstm_chunked`` (see
:func:`mlstm_scan_ref`); :func:`mlstm_recurrent_ref` is the step-by-step
oracle for both.  The CPU tests use them, and on a CPU tensor the
wrappers in :mod:`repro_torch.kernels.ops` run them in place of the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.nn.attention import grouped_attention, make_mask
from repro_torch.nn.ssm import ssd_chunked
from repro_torch.nn.xlstm import BIG_NEG, mlstm_recurrent


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


def ssm_scan_chunks(x, dt, a, b_mat, c_mat, *, chunk, dtype=torch.float32,
                    matmul=torch.matmul):
    """The SSD scan chunk by chunk, as the CUDA kernel orders it: for each
    chunk, with cs the inclusive cumsum of dt * a, the panel (C B^T) masked
    to j <= i and weighted by exp(cs_i - cs_j) dt_j, y = panel x +
    exp(cs_i) (C S) (the decay applied after the product), then S <-
    exp(cs_Q) S + B^T (w x), w_j = exp(cs_Q - cs_j) dt_j.  Shapes and
    returns as :func:`ssm_scan_ref`.  ``dtype`` is that of every sum and
    product (float64 gives a yardstick for the fp32 kernel's own rounding);
    ``matmul`` takes the four matrix products, C B^T, panel x, C S and
    B^T (w x) (a test models the kernel's arithmetic through it)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if l % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence {l}")
    rep = h // g
    xf = x.to(dtype).transpose(1, 2)  # (b,h,l,p)
    bf = b_mat.to(dtype).repeat_interleave(rep, dim=2).transpose(1, 2)  # (b,h,l,n)
    cf = c_mat.to(dtype).repeat_interleave(rep, dim=2).transpose(1, 2)
    dtf = dt.to(dtype).transpose(1, 2)  # (b,h,l)
    af = a.to(dtype)[None, :, None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = torch.zeros((bsz, h, n, p), dtype=dtype, device=x.device)
    out = []
    for l0 in range(0, l, chunk):
        xc, bc, cc = (t[:, :, l0:l0 + chunk] for t in (xf, bf, cf))
        dtc = dtf[..., l0:l0 + chunk]
        cs = torch.cumsum(dtc * af, dim=-1)  # (b,h,q)
        decay = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :], float("-inf")))
        panel = matmul(cc, bc.transpose(-1, -2)) * decay * dtc[..., None, :]
        out.append(matmul(panel, xc) + torch.exp(cs)[..., None] * matmul(cc, state))
        w = torch.exp(cs[..., -1:] - cs) * dtc
        state = (torch.exp(cs[..., -1])[..., None, None] * state
                 + matmul(bc.transpose(-1, -2), w[..., None] * xc))
    y = torch.cat(out, dim=2).transpose(1, 2)
    return y.to(x.dtype), state.float()


def mlstm_scan_ref(q, k, v, i_log, f_log, *, chunk, dtype=torch.float32,
                   matmul=torch.matmul):
    """The Pallas ``mlstm_scan_blhp`` kernel's math, chunk by chunk in
    fp32: k scaled by P^-1/2, the stabiliser starting at -1e6 (not -inf,
    as ``mlstm_chunked`` has it), the panel product in fp32 (not cast to
    v's dtype first).  q/k/v: (B, L, H, P); i_log/f_log: (B, L, H).
    Returns h (B, L, H, P) in q's dtype.  ``dtype`` is that of every sum
    and product (float64 gives a yardstick for the fp32 version's own
    rounding).  ``matmul`` takes the four matrix products, q k^T, S v, q C
    and the state update (k w)^T v (a test models a kernel's arithmetic
    through it)."""
    b, l, h, p = q.shape
    if l % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence {l}")
    qf = q.to(dtype).transpose(1, 2)  # (b,h,l,p)
    kf = k.to(dtype).transpose(1, 2) * (p ** -0.5)
    vf = v.to(dtype).transpose(1, 2)
    ig = i_log.to(dtype).transpose(1, 2)  # (b,h,l)
    fg = f_log.to(dtype).transpose(1, 2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    c = torch.zeros((b, h, p, p), dtype=dtype, device=q.device)
    n = torch.zeros((b, h, p), dtype=dtype, device=q.device)
    m = torch.full((b, h), BIG_NEG, dtype=dtype, device=q.device)
    out = []
    for l0 in range(0, l, chunk):
        qc, kc, vc = (t[:, :, l0:l0 + chunk] for t in (qf, kf, vf))
        igc, fgc = ig[..., l0:l0 + chunk], fg[..., l0:l0 + chunk]
        fcum = torch.cumsum(fgc, dim=-1)  # inclusive
        ftot = fcum[..., -1]
        # intra log-weights a[i,j] = fcum_i - fcum_j + ig_j (j<=i); inter b[i]
        a_log = torch.where(tri, fcum[..., :, None] - fcum[..., None, :] + igc[..., None, :],
                            float("-inf"))
        b_log = fcum + m[..., None]
        m_i = torch.clamp_min(torch.maximum(torch.amax(a_log, dim=-1), b_log), BIG_NEG)
        intra_w = torch.exp(a_log - m_i[..., None])  # (b,h,Q,Q)
        inter_w = torch.exp(b_log - m_i)  # (b,h,Q)
        s_intra = matmul(qc, kc.transpose(-1, -2)) * intra_w
        h_num = matmul(s_intra, vc) + matmul(qc, c) * inter_w[..., None]
        denom = s_intra.sum(dim=-1) + (qc @ n[..., None])[..., 0] * inter_w
        denom = torch.maximum(denom.abs(), torch.exp(-m_i))
        out.append(h_num / denom[..., None])
        # state update to chunk end
        w_log = ftot[..., None] - fcum + igc  # (b,h,Q)
        m_next = torch.clamp_min(torch.maximum(ftot + m, torch.amax(w_log, dim=-1)),
                                 BIG_NEG)
        kw = kc * torch.exp(w_log - m_next[..., None])[..., None]  # (b,h,Q,P)
        carry = torch.exp(ftot + m - m_next)
        c = carry[..., None, None] * c + matmul(kw.transpose(-1, -2), vc)
        n = carry[..., None] * n + kw.sum(dim=-2)
        m = m_next
    return torch.cat(out, dim=2).transpose(1, 2).to(q.dtype)


def mlstm_recurrent_ref(q, k, v, i_log, f_log):
    """Recurrent oracle (per-step), the strictest reference: h (B, L, H, P)."""
    h, _ = mlstm_recurrent(q, k, v, i_log, f_log)
    return h
