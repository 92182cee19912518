#!/usr/bin/env python3
"""Checks and times versions of the mLSTM kernel's CUDA source against each
other on one card, in turns.

    PYTHONPATH=src python scripts/mlstm_variants.py [--draws N] A.cu B.cu ...
    PYTHONPATH=src python scripts/mlstm_variants.py --same A.cu B.cu ...

Each argument is a whole ``mlstm_scan.cu`` (the checkout's
``src/repro_torch/kernels/csrc/mlstm_scan.cu``, an earlier one from
``git show``, or an edited copy).  Each is built with the flags of
``repro_torch.kernels.build`` into ``build/mlstm_variants/``; its kernels'
registers are printed, and their tensor-core and FMA instructions
(``cuobjdump -sass``: HMMA by input type, DMMA, FFMA).  Then, at the
xlstm-1.3b forward's shape, at batch 4 over 512 steps, at chunk 256, and at
the forward's shape with chunks 512 and 1024, in fp32 and bf16, the sources
run on the same inputs in turns (A, B, ..., B, A): h against the fp32 plain
version, as ``chip_smoke.py`` holds it (per element, ``rel |h| + 1e-4
max|h|``, rel 0 in fp32 and 2^-8 in bf16; reported, not enforced, with the
chunk row where the worst element lies; and, as a yardstick for the fp32
version's own rounding, the same against a float64 plain version), CUDA
events around back-to-back calls, and the device time of each of the two
launches from ``torch.profiler``.  ``--draws N`` repeats each shape on N
draws of random inputs (the error depends on them).  One line a (shape,
draw, dtype, source), with the card's name and power limit first.  With
``--same`` nothing is timed: each source runs every case of
``chip_smoke.py``'s ``MLSTM_CASES`` in both dtypes on the same inputs, and
one line a case says whether its h equals A's bit for bit.  Needs a CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ops, ref, timing

OUT = build.BUILD_DIR.parent / "mlstm_variants"
# (B, L, H, P, chunk): the xlstm-1.3b forward's, batch 4 at 512, chunk 256,
# the forward's with the largest chunks a schedule allows
SHAPES = [(1, 2048, 4, 1024, 128), (4, 512, 4, 1024, 128), (1, 1024, 2, 1024, 256),
          (1, 2048, 4, 1024, 512), (1, 2048, 4, 1024, 1024)]
H_REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
PASSES = ("mlstm_chunk_panel", "mlstm_chunk_state")


def sass_counts(path):
    """{kernel: Counter of HMMA.<type>, DMMA and FFMA instructions} of a built
    library, from ``cuobjdump -sass`` (kernel names demangled by ``c++filt``
    where the machine has it)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            counts[kernel] = collections.Counter()
        elif kernel is not None:
            op = re.search(r"\b(HMMA\.\w+(?:\.\w+)*|DMMA\.\w+|FFMA)\b", line)
            if op:
                name = op.group(1)
                if name.startswith("HMMA"):
                    name = "HMMA." + name.split(".")[-1]
                counts[kernel][name] += 1
    if shutil.which("c++filt") and counts:
        names = subprocess.run(["c++filt"], input="\n".join(counts), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        counts = dict(zip(names, counts.values()))
    return counts


def _build(sources):
    fns = {}
    for src, (lib, log) in build.build_files(sources, OUT).items():
        for kernel, used in build.registers(log):
            print(f"registers {src} {kernel[:40]}: {used}")
        for kernel, counts in sass_counts(lib._name).items():
            name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
            print(f"sass {src} {name}: {dict(sorted(counts.items()))}")
        fns[src] = ops.bind_mlstm(lib)
    return fns


def _runner(fns, q, k, v, il, fl, out, chunk):
    fn, floats = fns
    b, l, h, p = q.shape
    scratch = torch.empty((floats(b, l, h, p, chunk),), dtype=torch.float32, device="cuda")

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), il.data_ptr(), fl.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), 0 if q.dtype == torch.float32 else 1,
                 b, l, h, p, chunk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *il.stride(), *fl.stride(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def _same(fns):
    """Whether each build gives the first one's bits at chip_smoke.py's cases."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    first, *rest = fns
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for case in chip_smoke.MLSTM_CASES:
            b, l, h, p, chunk, i_shift = case
            args = chip_smoke._mlstm_inputs(torch, gen, b, l, h, p, i_shift, dtype)
            outs = {}
            for src in fns:
                outs[src] = torch.empty_like(args[0])
                _runner(fns[src], *args, outs[src], chunk)()
            torch.cuda.synchronize()
            for src in rest:
                print(f"same bits as {first} {case} {str(dtype)[6:]} {src}: "
                      f"{torch.equal(outs[first], outs[src])}", flush=True)


def main(argv) -> int:
    draws, same = 1, argv[:1] == ["--same"]
    if same:
        argv = argv[1:]
    if argv[:1] == ["--draws"]:
        draws, argv = int(argv[1]), argv[2:]
    sources = argv
    if not sources or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    fns = _build(sources)
    print("card: " + timing.card())
    if same:
        _same(fns)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, l, h, p, chunk in [shape for shape in SHAPES for _ in range(draws)]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, l, h, p, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            il = torch.randn(b, l, h, generator=gen, device="cuda") * 2.0
            fl = F.logsigmoid(torch.randn(b, l, h, generator=gen, device="cuda") + 3.0)
            want = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), il, fl, chunk=chunk)
            tol = H_REL[dtype] * want.abs() + 1e-4 * want.abs().max()
            want64 = ref.mlstm_scan_ref(q, k, v, il, fl, chunk=chunk, dtype=torch.float64)
            tol64 = H_REL[dtype] * want64.abs() + 1e-4 * want64.abs().max()
            ref_over = ((want - want64).abs() / tol64).max().item()
            out = torch.empty_like(q)
            rows = {}
            for src in list(fns) + list(fns)[::-1]:
                run = _runner(fns[src], q, k, v, il, fl, out, chunk)
                run()
                torch.cuda.synchronize()
                ratio = (out.float() - want).abs() / tol
                worst = int(ratio.argmax())
                over = ratio.flatten()[worst].item()
                over64 = ((out.double() - want64).abs() / tol64).max().item()
                row_in_chunk = (worst // (h * p)) % l % chunk
                times = timing.device_times(run, warmup=1)
                passes = [timing.measured(sum(ms for key, ms in times.items() if name in key))
                          for name in PASSES]
                rows.setdefault(src, []).append((timing.event_ms(run, runs=15), passes, over,
                                                 row_in_chunk, over64))
            for src, turns in rows.items():
                print(f"mlstm_variant {(b, l, h, p, chunk)} {str(dtype)[6:]} {src}: "
                      f"event ms {[round(t[0], 4) for t in turns]}, "
                      f"device ms (panel, state) {[t[1] for t in turns]}, "
                      f"max err / tol {max(t[2] for t in turns):.3g} "
                      f"(chunk row {turns[0][3]}); against float64 "
                      f"{max(t[4] for t in turns):.3g} (the fp32 plain version {ref_over:.3g})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
