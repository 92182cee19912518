#!/usr/bin/env python3
"""Times versions of the flash kernel's CUDA source against each other on
one card, in turns.

    PYTHONPATH=src python scripts/flash_variants.py A.cu B.cu ...

Each argument is a whole ``flash_attention.cu`` (the checkout's
``src/repro_torch/kernels/csrc/flash_attention.cu``, an earlier one from
``git show``, or an edited copy).  Each is built with the flags of
``repro_torch.kernels.build`` into ``build/flash_variants/`` (the
registers of its D=80 and D=128 kernels are printed), then, at the NAS
and served shapes and in fp32 and bf16, held against the plain version
and timed in turns (A, B, ..., B, A): CUDA events around back-to-back
launches, and the kernels' device time from ``torch.profiler``.  A source
that takes a tile pair (it exports ``repro_flash_attention_takes``) is
launched with the pair the named default schedule maps to; an earlier one
with its own fixed tiles.  One line
a (shape, dtype, source), with the card's name and power limit first.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from repro_torch.kernels import build, ops, ref, timing

OUT = build.BUILD_DIR.parent / "flash_variants"
# (B, S, H, KH, D, causal): the NAS loop's attention, the longer served
# prompt, and D=128 over a long sequence without the causal imbalance
SHAPES = [(1, 2048, 32, 32, 80, False), (1, 512, 16, 8, 128, True),
          (1, 2048, 16, 8, 128, False)]
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _build(sources):
    fns = {}
    for src, (lib, log) in build.build_files(sources, OUT).items():
        for kernel, used in build.registers(log):
            if "Li80E" in kernel or "Li128E" in kernel:
                print(f"registers {src} {kernel.split('flash_fwd')[-1][:24]}: {used}")
        fns[src] = _bind(lib)
    return fns


def _bind(lib):
    """(entry point, whether it takes a tile pair): sources from before the
    kernel took schedules have no tile arguments."""
    if hasattr(lib, "repro_flash_attention_takes"):
        return ops.bind_flash(lib), True
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, False


def _launch(bound, q, k, v, o, causal):
    fn, tiled = bound
    b, s, h, d = q.shape
    tiles = ops.flash_launch_tiles(128, 128, d, q.dtype) if tiled else ()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             0 if q.dtype == torch.float32 else 1, b, s, k.shape[1], h, k.shape[2], d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             int(causal), 0, d ** -0.5, *tiles, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def main(sources) -> int:
    if not sources or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    fns = _build(sources)
    print("card: " + timing.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, kh, d, causal in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, s, kh, d, generator=gen, device="cuda").to(dtype)
            want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), causal=causal)
            want = want.transpose(1, 2).float()
            out = torch.empty_like(q)
            rows = {}
            for src in list(fns) + list(fns)[::-1]:
                run = lambda: _launch(fns[src], q, k, v, out, causal)  # noqa: E731
                run()
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                if err > TOLERANCE[dtype]:
                    raise SystemExit(f"{src} {(b, s, h, kh, d, causal)} {dtype}: "
                                     f"max |err| {err} > {TOLERANCE[dtype]}")
                rows.setdefault(src, []).append((timing.event_ms(run, runs=15),
                                                 timing.device_ms(run, warmup=1), err))
            for src, turns in rows.items():
                print(f"flash_variant {(b, s, h, kh, d, causal)} {str(dtype)[6:]} {src}: "
                      f"event ms {[round(t[0], 4) for t in turns]}, "
                      f"device ms {[t[1] for t in turns]}, "
                      f"max |err| {max(t[2] for t in turns):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
