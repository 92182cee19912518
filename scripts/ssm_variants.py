#!/usr/bin/env python3
"""Checks and times versions of the SSD scan kernel's CUDA source against
each other on one card, in turns, and reads each one's effect on the NAS
loop's best-candidate check.

    PYTHONPATH=src python scripts/ssm_variants.py [--draws N] A.cu B.cu ...

Each argument is a whole ``ssm_scan.cu`` (the checkout's
``src/repro_torch/kernels/csrc/ssm_scan.cu``, an earlier one from ``git
show``, or an edited copy) with the C entry point ``repro_ssm_scan_fwd``.
Each is built with the flags of ``repro_torch.kernels.build`` into
``build/ssm_variants/`` (its kernels' registers are printed) and launched
through ``ops.ssm_scan``, the port's own wrapper, with ``ops._ssm_fns``
patched to return that build's entry points (an earlier source's entry
point, which takes no scratch, is wrapped in the current signature).
Printed, with the card's name and power limit first:

* at the NAS loop's shape (B 4, L 2048, H 80, G 1, N = P = 64, chunk 128),
  at chunk 256 (B 1) and at chunk 1024 (B 1, H 16, N = P = 128), in fp32 and
  bf16, every source run on the same
  inputs in turns (A, B, ..., B, A): CUDA events around back-to-back calls,
  the kernel's device time from ``torch.profiler``, and y against the fp32
  plain version as ``chip_smoke.py`` holds it (per element, ``rel |y| +
  1e-4 max|y|``, rel 0 in fp32 and 2^-8 in bf16; reported, not enforced),
  and the same against the float64 chunk-loop version (the fp32 plain
  version's own distance from it beside); the final state against the fp32
  plain version's, over 1e-4 of its max;
* the ``nas_best`` reading of ``chip_smoke.py`` (max |output - plain output|
  over 1e-3 of max |plain output|) of its best candidate, the one-ssm-mixer
  architecture of its NAS space, for each source over N draws (default 4):
  draw s has weights from seed s and inputs from seed s + 1 (draw 0 is the
  check's own); and, for each draw, the same reading of the plain forward
  whose ``ssm_scan`` outputs get relative noise of 1e-7 of their max.

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from repro_torch.kernels import build, ops, ref, timing  # noqa: E402

OUT = build.BUILD_DIR.parent / "ssm_variants"
# (B, L, H, G, N, P, chunk): the NAS loop's shape, chunk 256, and the
# largest chunk the schedules allow at N = P = 128
SHAPES = [(4, 2048, 80, 1, 64, 64, 128), (1, 2048, 80, 1, 64, 64, 256),
          (1, 2048, 16, 1, 128, 128, 1024)]
Y_REL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}


def _bind(lib):
    """A build's entry points as ``ops._ssm_fns`` returns them.  An earlier
    source's entry point, which takes no scratch and names no shared-memory
    size, is wrapped in that signature: it gets no scratch, and its own
    checks refuse what it does not take."""
    if hasattr(lib, "repro_ssm_scan_scratch_floats"):
        return ops.bind_ssm(lib)
    old = lib.repro_ssm_scan_fwd
    old.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 12
                    + [ctypes.c_void_p])
    old.restype = ctypes.c_int

    def fn(x, dt, a, b, c, y, state, _scratch, *rest):
        return old(x, dt, a, b, c, y, state, *rest)
    return fn, lambda *_: 0, lambda *_: 0


def _build(sources):
    fns = {}
    for src, (lib, log) in build.build_files(sources, OUT).items():
        for kernel, used in build.registers(log):
            print(f"registers {src} {kernel[-48:]}: {used}")
        fns[src] = _bind(lib)
    return fns


def launching(bound):
    """``ops.ssm_scan`` launches the given build within this context."""
    return mock.patch.object(ops, "_ssm_fns", lambda: bound)


def _over(got, want, rel):
    tol = rel * want.abs() + 1e-4 * want.abs().max()
    return ((got.double() - want.double()).abs() / tol.double()).max().item()


def time_in_turns(fns):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, l, h, g, n, p, chunk in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = chip_smoke._ssm_inputs(torch, gen, b, l, h, g, n, p, dtype)
            x, dt, a, bm, cm = args
            want, want_s = ref.ssm_scan_ref(x.float(), dt, a, bm.float(), cm.float(), chunk=chunk)
            want64, want64_s = ref.ssm_scan_chunks(x.double(), dt.double(), a.double(),
                                                   bm.double(), cm.double(), chunk=chunk,
                                                   dtype=torch.float64)
            ref_over = _over(want, want64, Y_REL[dtype])
            state_tol = 1e-4 * want_s.abs().max().item()
            rows = {}
            run = lambda: ops.ssm_scan(*args, chunk=chunk)  # noqa: E731
            for src in list(fns) + list(fns)[::-1]:
                with launching(fns[src]):
                    try:
                        y, state = run()
                    except (RuntimeError, ValueError) as err:  # a source that refuses the shape
                        rows[src] = str(err)
                        continue
                    torch.cuda.synchronize()
                    over = _over(y.float(), want, Y_REL[dtype])
                    over64 = _over(y, want64, Y_REL[dtype])
                    over_s = (state - want_s).abs().max().item() / state_tol
                    rows.setdefault(src, []).append((timing.event_ms(run, runs=15),
                                                     timing.device_ms(run, warmup=1), over,
                                                     over64, over_s))
            for src, turns in rows.items():
                if isinstance(turns, str):
                    print(f"ssm_variant {(b, l, h, g, n, p, chunk)} {str(dtype)[6:]} {src}: "
                          f"refused ({turns})", flush=True)
                    continue
                print(f"ssm_variant {(b, l, h, g, n, p, chunk)} {str(dtype)[6:]} {src}: "
                      f"event ms {[round(t[0], 4) for t in turns]}, "
                      f"device ms {[t[1] for t in turns]}, "
                      f"max err / tol {max(t[2] for t in turns):.3g}; against float64 "
                      f"{max(t[3] for t in turns):.3g} (the fp32 plain version {ref_over:.3g}); "
                      f"state max err / (1e-4 max|state|) {max(t[4] for t in turns):.3g} "
                      f"(the fp32 plain version against float64 "
                      f"{(want_s.double() - want64_s).abs().max().item() / state_tol:.3g})",
                      flush=True)
            del args, x, dt, a, bm, cm, want, want64, want_s, want64_s


def best_candidate():
    """The NAS phase's best candidate: of the architectures its random
    sampler draws at seed 0, the one with a single ssm mixer."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.search.samplers import RandomSampler
    from repro_torch.search.study import Study

    space = parse_search_space(chip_smoke.NAS_SPACE)
    archs = []

    def objective(trial):
        archs.append(sample_architecture(space, trial))
        return 0.0

    Study(name="ssm-variants", sampler=RandomSampler(seed=0)).optimize(
        objective, chip_smoke.NAS_TRIALS)
    ops_of = [[layer.op for layer in arch.layers] for arch in archs]
    pick = next(i for i, o in enumerate(ops_of) if o.count("ssm") == 1 and "attention" not in o)
    return ModelBuilder(space.input_shape, space.output_dim).build(archs[pick]), space


def nas_best_readings(fns, draws):
    builder_model, space = best_candidate()
    c, l = space.input_shape
    print(f"nas_best candidate: {builder_model.arch.signature()}", flush=True)

    def plain_ssm(x_, dt, a, b, c_, *, chunk):
        return ref.ssm_scan_ref(x_, dt, a, b, c_, chunk=chunk)

    noise = torch.Generator(device="cuda").manual_seed(2)

    def noisy_ssm(x_, dt, a, b, c_, *, chunk):
        y, state = plain_ssm(x_, dt, a, b, c_, chunk=chunk)
        return y + 1e-7 * y.abs().max() * torch.randn(
            y.shape, generator=noise, device=y.device, dtype=y.dtype), state

    for s in range(draws):
        model = builder_model.init(torch.Generator(device="cuda").manual_seed(s), "cuda")
        x = torch.randn(chip_smoke.NAS_BATCH, l, c, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(s + 1))
        with torch.inference_mode(), \
                mock.patch.object(ops, "flash_attention", chip_smoke._flash_plain):
            with mock.patch.object(ops, "ssm_scan", plain_ssm):
                want = model(x)
            tol = chip_smoke.NAS_REL_TOL * want.abs().max().item()
            for src, bound in fns.items():
                with launching(bound):
                    got = model(x)
                print(f"nas_best draw {s}, {src}: max |err| / tol "
                      f"{(got - want).abs().max().item() / tol:.3g}", flush=True)
            with mock.patch.object(ops, "ssm_scan", noisy_ssm):
                got = model(x)
            print(f"nas_best draw {s}, plain forward with ssm_scan outputs given relative "
                  f"noise 1e-7 of max |y|: max |err| / tol "
                  f"{(got - want).abs().max().item() / tol:.3g}", flush=True)
        builder_model.to("cpu")
        del model, x, want, got
        torch.cuda.empty_cache()


def main(argv) -> int:
    draws = 4
    if argv[:1] == ["--draws"]:
        draws, argv = int(argv[1]), argv[2:]
    if not argv or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    fns = _build(argv)
    print("card: " + timing.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    time_in_turns(fns)
    nas_best_readings(fns, draws)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
