#!/usr/bin/env python3
"""How far the flash kernel, its plain version and SDPA each land from the
plain version run in float64, on ``chip_smoke.py``'s flash cases.

    PYTHONPATH=src python scripts/flash_accuracy.py [--seeds N]

First ``chip_smoke.py``'s own draws (one generator seeded 0 across
``FLASH_CASES``, fp32 then bf16, as its flash phase draws them), one line
a case and dtype; then, in bf16, N more draws a case (generators seeded
100, 101, ...; 4 at the cases above 2^22 elements), one line a case with
the largest of each error and how many draws put the kernel more than the
bf16 tolerance from the bf16 plain version.  It shows whether a bf16 miss
is the kernel's or the plain version's own rounding (the plain version
rounds the normalised P to bf16 before P @ V).  Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=40)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops, timing

    print("card: " + timing.card())
    torch.backends.cuda.matmul.allow_tf32 = False

    def errors(q, k, v, case):
        _, _, _, _, _, causal, window = case
        kw = dict(causal=causal, window=window)
        out = ops.flash_attention(q, k, v, **kw).double()
        plain = cs._flash_plain(q, k, v, **kw).double()
        f64 = cs._flash_plain(q.double(), k.double(), v.double(), **kw)
        sdpa = cs._flash_library(q, k, v, **kw)().transpose(1, 2).double()

        def err(a, b):
            return (a - b).abs().max().item()

        return {"kernel_vs_plain": err(out, plain), "kernel_vs_f64": err(out, f64),
                "plain_vs_f64": err(plain, f64), "sdpa_vs_f64": err(sdpa, f64)}

    def draw(gen, case, dt):
        b, s, h, kh, d = case[:5]
        return [torch.randn(b, s, heads, d, generator=gen, device="cuda").to(dt)
                for heads in (h, kh, kh)]

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        for case in cs.FLASH_CASES:
            q, k, v = draw(gen, case, getattr(torch, dtype))
            print(json.dumps({"draw": "chip_smoke", "dtype": dtype, "case": case,
                              "tol": cs.TOLERANCE[dtype], **errors(q, k, v, case)}),
                  flush=True)
    for case in cs.FLASH_CASES:
        b, s, h, _, d = case[:5]
        n = args.seeds if b * s * h * d <= 2 ** 22 else min(args.seeds, 4)
        worst, over = {}, 0
        for seed in range(100, 100 + n):
            q, k, v = draw(torch.Generator(device="cuda").manual_seed(seed), case,
                           torch.bfloat16)
            row = errors(q, k, v, case)
            over += row["kernel_vs_plain"] > cs.TOLERANCE["bfloat16"]
            worst = {key: max(worst.get(key, 0.0), val) for key, val in row.items()}
        print(json.dumps({"draw": f"seeds 100-{99 + n}", "dtype": "bfloat16", "case": case,
                          "tol": cs.TOLERANCE["bfloat16"],
                          "kernel_vs_plain_over_tol": over, "max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
