"""Pre-processing design space (paper §IV-E).

Five searchable stages over (B, L, C) sensor streams, jointly sampled with
the architecture so the whole signal path is optimized end-to-end:

  * ``filter``      — windowed-sinc low/high-pass FIR (cutoff, taps, kind)
  * ``downsample``  — integer-factor decimation
  * ``window``      — sequential windowing: fixed-offset crop of length W
  * ``event_window``— event-based windowing: crop centred on the maximum
                      short-time energy (the "event")
  * ``normalize``   — zscore | minmax | none

The deployed stream system applies windowing continuously; during NAS each
example contributes one window (documented simplification).  The stages
run in the candidate's forward, on its device, so hardware-in-the-loop
latency measurements include the pre-processing cost — the paper's
end-to-end claim.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

Shape = Tuple[int, ...]


def _sinc_kernel(taps: int, cutoff: float, kind: str) -> torch.Tensor:
    """Windowed-sinc FIR kernel.  cutoff in (0, 0.5) of sampling rate."""
    m = taps - 1
    idx = torch.arange(taps, dtype=torch.float32)
    n = idx - m / 2.0
    h = 2 * cutoff * torch.sinc(2 * cutoff * n)
    # Hamming window
    w = 0.54 - 0.46 * torch.cos(2 * math.pi * idx / m)
    h = h * w
    h = h / h.sum()
    if kind == "highpass":
        delta = torch.zeros(taps)
        delta[m // 2] = 1.0
        h = delta - h
    return h


def _apply_fir(x, kernel):
    """Depthwise 'SAME' FIR along L.  x: (B, L, C)."""
    c, taps = x.shape[-1], kernel.shape[0]
    weight = kernel.to(x.device, x.dtype).expand(c, 1, taps)
    xt = F.pad(x.transpose(1, 2), ((taps - 1) // 2, taps - 1 - (taps - 1) // 2))
    return F.conv1d(xt, weight, groups=c).transpose(1, 2)


def build_stage(cfg: Dict[str, Any], shape: Shape) -> Tuple[Callable, Shape]:
    l, c = shape
    stage = cfg["stage"]
    if stage == "filter":
        taps = int(cfg.get("taps", 31))
        cutoff = float(cfg.get("cutoff", 0.25))
        kind = str(cfg.get("kind", "lowpass"))
        kernel = _sinc_kernel(taps, cutoff, kind)
        return (lambda x: _apply_fir(x, kernel)), (l, c)
    if stage == "downsample":
        factor = max(1, int(cfg.get("factor", 1)))
        out_l = (l + factor - 1) // factor
        return (lambda x: x[:, ::factor]), (out_l, c)
    if stage == "window":
        w = min(int(cfg.get("size", l)), l)
        off = min(int(cfg.get("offset", 0)), l - w)
        return (lambda x: x[:, off : off + w]), (w, c)
    if stage == "event_window":
        w = min(int(cfg.get("size", l)), l)
        energy_w = min(int(cfg.get("energy_window", 16)), l)

        def fn(x):
            power = x.float().square().sum(dim=-1)  # (B, L)
            energy = power.unfold(1, energy_w, 1).sum(dim=-1)  # VALID windows
            centre = energy.argmax(dim=1) + energy_w // 2
            start = (centre - w // 2).clamp(0, x.shape[1] - w)
            rows = start[:, None] + torch.arange(w, device=x.device)
            return x[torch.arange(x.shape[0], device=x.device)[:, None], rows]

        return fn, (w, c)
    if stage == "normalize":
        kind = str(cfg.get("kind", "zscore"))
        if kind == "minmax":
            def fn(x):
                lo = x.amin(dim=1, keepdim=True)
                hi = x.amax(dim=1, keepdim=True)
                return (x - lo) / (hi - lo).clamp_min(1e-6)
        elif kind == "zscore":
            def fn(x):
                mu = x.mean(dim=1, keepdim=True)
                sd = x.std(dim=1, keepdim=True, correction=0)
                return (x - mu) / sd.clamp_min(1e-6)
        else:
            fn = lambda x: x
        return fn, (l, c)
    raise ValueError(f"unknown pre-processing stage {stage!r}")


def build_preprocessing(stages: List[Dict[str, Any]], shape: Shape):
    """Compose sampled stages -> (callable | None, out_shape)."""
    if not stages:
        return None, shape
    fns = []
    for cfg in stages:
        fn, shape = build_stage(cfg, shape)
        fns.append(fn)

    def pipeline(x):
        for f in fns:
            x = f(x)
        return x

    return pipeline, shape
