#!/usr/bin/env python3
"""How far the mLSTM scan kernel and its fp32 plain version each land from
the float64 plain version, by chunk, at xlstm-1.3b's shape.

    PYTHONPATH=src python scripts/mlstm_chunk_accuracy.py [--draws N]

For each draw of inputs (``chip_smoke.py``'s mLSTM inputs at
(1, 2048, 4, 1024), one generator seeded 0 across draws), each dtype and
each chunk of the schedules' grid above 64, one line: max |h| of the
float64 plain version, and for each pair of (kernel, fp32 plain, float64
plain) the largest error over the mLSTM phase's per-element tolerance
(2^-8 |h| in bf16 plus 1e-4 max |h|) and over max |h|, and the kernel's
reading of the phase's float64 check (that tolerance plus twice the fp32
plain version's own error, per element; the check of the chunks above
``MLSTM_F64_CHUNK``).  It shows whether a miss of the fp32 plain version's
tolerance is the kernel's or fp32 arithmetic's.  Needs a CUDA card and
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
    parser.add_argument("--draws", type=int, default=2)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref, timing

    print("card: " + timing.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for draw in range(args.draws):
        for dtype in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype)
            for chunk in (128, 256, 512, 1024):
                q, k, v, il, fl = cs._mlstm_inputs(torch, gen, 1, 2048, 4, 1024, 0.0, dt_)
                h = ops.mlstm_scan(q, k, v, il, fl, chunk=chunk)[0].double()
                p32 = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), il, fl,
                                         chunk=chunk).double()
                p64 = ref.mlstm_scan_ref(q.double(), k.double(), v.double(), il.double(),
                                         fl.double(), chunk=chunk, dtype=torch.float64)
                top = p64.abs().max().item()

                def over(a, b):
                    err = (a - b).abs()
                    tol = cs.MLSTM_H_REL[dtype] * b.abs() + cs.MLSTM_TOL * top
                    return [(err / tol).max().item(), err.max().item() / top]

                check = (h - p64).abs() / (cs.MLSTM_H_REL[dtype] * p64.abs()
                                           + cs.MLSTM_TOL * top + 2 * (p32 - p64).abs())
                print(json.dumps({"draw": draw, "dtype": dtype, "chunk": chunk,
                                  "max_abs_h_f64": top,
                                  "kernel_vs_plain_fp32": over(h, p32),
                                  "kernel_vs_f64": over(h, p64),
                                  "plain_fp32_vs_f64": over(p32, p64),
                                  "float64_check": check.max().item()}), flush=True)
                del q, k, v, il, fl, h, p32, p64, check
    return 0


if __name__ == "__main__":
    sys.exit(main())
