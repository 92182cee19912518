#!/usr/bin/env python3
"""How much of the fp32 mLSTM scan's error at long chunks comes from the
gates' cumsum being held in fp32, on the CPU.

    PYTHONPATH=src python scripts/mlstm_fcum_rounding.py [--draws N] [--heads H]

The chunkwise mLSTM (``repro_torch.kernels.ref.mlstm_scan_ref``'s math) is
run in float64 three ways on ``chip_smoke.py``'s mLSTM inputs at
(1, 2048, H, 1024) (a CPU generator seeded by the draw): exactly; with the
cumsum fcum of the log forget gates rounded to fp32 before its differences
fcum_i - fcum_j and ftot - fcum_j are taken ("fp32 fcum"); and with fcum
kept in float64 and each difference rounded to fp32 once ("float64 fcum").
Both rounded ways also round the exponents and the stabiliser to fp32, as a
kernel computes them.  Over a 1024-step chunk fcum reaches about -50, where
an fp32 ulp is 4e-6, and a row whose panel sum nearly cancels turns that
into an error of its whole row.  One line a (draw, chunk): each rounded
way's largest error over max |h|.  Takes a few minutes and a few GB.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

BIG_NEG = -1e6


def _r32(x):
    return x.float().double()


def scan(q, k, v, i_log, f_log, chunk, mode):
    """h of the chunkwise mLSTM in float64; ``mode`` is "exact", "fp32
    fcum" or "float64 fcum" (see the module's docstring)."""
    b, l, h, p = q.shape
    f64 = torch.float64
    qf = q.to(f64).transpose(1, 2)
    kf = k.to(f64).transpose(1, 2) * p ** -0.5
    vf = v.to(f64).transpose(1, 2)
    ig = i_log.to(f64).transpose(1, 2)
    fg = f_log.to(f64).transpose(1, 2)
    rounded = mode != "exact"
    r = _r32 if rounded else (lambda x: x)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    c = torch.zeros((b, h, p, p), dtype=f64)
    n = torch.zeros((b, h, p), dtype=f64)
    m = torch.full((b, h), BIG_NEG, dtype=f64)
    out = []
    for l0 in range(0, l, chunk):
        qc, kc, vc = (t[:, :, l0:l0 + chunk] for t in (qf, kf, vf))
        igc, fgc = ig[..., l0:l0 + chunk], fg[..., l0:l0 + chunk]
        fcum = torch.cumsum(fgc, -1)
        if mode == "fp32 fcum":
            fcum = _r32(fcum)
        ftot = fcum[..., -1]
        diff = r(fcum[..., :, None] - fcum[..., None, :])
        wdiff = r(ftot[..., None] - fcum)
        fcum, ftot = r(fcum), r(ftot)
        a_log = r(torch.where(tri, diff + igc[..., None, :], float("-inf")))
        b_log = r(fcum + m[..., None])
        m_i = torch.clamp_min(torch.maximum(torch.amax(a_log, dim=-1), b_log), BIG_NEG)
        intra_w = torch.exp(a_log - m_i[..., None])
        inter_w = torch.exp(b_log - m_i)
        s_intra = (qc @ kc.transpose(-1, -2)) * intra_w
        h_num = s_intra @ vc + (qc @ c) * inter_w[..., None]
        denom = s_intra.sum(-1) + (qc @ n[..., None])[..., 0] * inter_w
        denom = torch.maximum(denom.abs(), torch.exp(-m_i))
        out.append(h_num / denom[..., None])
        w_log = r(wdiff + igc)
        m_next = r(torch.clamp_min(torch.maximum(ftot + m, torch.amax(w_log, dim=-1)),
                                   BIG_NEG))
        kw = kc * torch.exp(w_log - m_next[..., None])[..., None]
        carry = torch.exp(ftot + m - m_next)
        c = carry[..., None, None] * c + kw.transpose(-1, -2) @ vc
        n = carry[..., None] * n + kw.sum(-2)
        m = m_next
    return torch.cat(out, dim=2).transpose(1, 2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=4)
    parser.add_argument("--heads", type=int, default=2)
    args = parser.parse_args(argv)
    for draw in range(args.draws):
        gen = torch.Generator().manual_seed(draw)
        q, k, v = (torch.randn(1, 2048, args.heads, 1024, generator=gen) for _ in range(3))
        i_log = torch.randn(1, 2048, args.heads, generator=gen) * 2.0
        f_log = F.logsigmoid(torch.randn(1, 2048, args.heads, generator=gen) + 3.0)
        for chunk in (512, 1024):
            exact = scan(q, k, v, i_log, f_log, chunk, "exact")
            top = exact.abs().max().item()
            print(json.dumps({"draw": draw, "chunk": chunk, **{
                mode: (scan(q, k, v, i_log, f_log, chunk, mode) - exact).abs().max().item() / top
                for mode in ("fp32 fcum", "float64 fcum")}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
