#!/usr/bin/env python3
"""How far the xlstm-1.3b forward's logits land from the fp32 forward with
``impl="xla"`` with each given version of the mLSTM kernel, over several
draws of weights and tokens, and how far they move when the xla forward's
own mLSTM outputs are perturbed.

    PYTHONPATH=src python scripts/xlstm_logits_variants.py [--seeds N] [--bf16] A.cu ...

The model is ``chip_smoke.py``'s: xlstm-1.3b at full width, one sequence of
2048 tokens; draw s has random weights from seed s and tokens from seed
s + 1 (``chip_smoke.py`` checks draw 0).  Each argument is a whole
``mlstm_scan.cu``, built with ``scripts/mlstm_variants.py``.  Printed, with
the card's name and power limit first, for each draw:

* for each source, the max |logits difference| from the fp32 xla forward
  over that check's tolerance (1e-3 of max |logits|: ``chip_smoke.py``'s
  check before the float64 one), and in fp32 also the reading of
  ``chip_smoke.py``'s check: the max over elements of |logits - the float64
  xla forward's| over 1e-3 of max |logits| plus twice the fp32 xla
  forward's own |error| against float64 at that element (the fp32 xla
  forward's own error over 1e-3 of max |logits| is printed per draw);
* with ``--bf16`` the weights are rounded to bf16 (``LM.init``'s dtype) and
  the kernels run their bf16 path; the same bf16 weights' xla forward is
  printed beside them;
* for the first draw in fp32, also the first mLSTM layer's output for each
  source on the forward's own inputs against the float64 plain version and
  against ``mlstm_chunked`` (the xla path's cell), both as max |difference|
  / max |h|, and probes of the xla forward itself: every mLSTM output given
  relative noise of 1e-7 of its max, scaled by 1 + 1e-7, or replaced by the
  float64 plain version (the xla path's own fp32 rounding taken out).

Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from unittest import mock

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mlstm_variants  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import ops, ref, timing  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.nn import xlstm  # noqa: E402


def _scan_with(fns):
    """A stand-in for ``ops.mlstm_scan`` that launches the given build."""
    def scan(q, k, v, i_log, f_log, *, chunk):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        mlstm_variants._runner(fns, q, k, v, i_log, f_log, out, chunk)()
        return out, None
    return scan


def _first_layer(model, tokens, sources, builds):
    """Each source's first mLSTM layer output on the forward's own inputs."""
    first = []

    def capture(q, k, v, i_log, f_log, *, chunk):
        if not first:
            first.append((q.clone(), k.clone(), v.clone(), i_log.clone(), f_log.clone(), chunk))
        return xlstm.mlstm_chunked(q, k, v, i_log, f_log, chunk)[0], None

    with mock.patch.object(ops, "mlstm_scan", capture):
        model(tokens)
    q, k, v, il, fl, chunk = first[0]
    want64 = ref.mlstm_scan_ref(q, k, v, il, fl, chunk=chunk, dtype=torch.float64)
    chunked = xlstm.mlstm_chunked(q, k, v, il, fl, chunk)[0]
    top = want64.abs().max().item()
    print(f"first mLSTM layer: mlstm_chunked vs float64 "
          f"{(chunked.double() - want64).abs().max().item() / top:.3g}", flush=True)
    for src in sources:
        h, _ = _scan_with(builds[src])(q, k, v, il, fl, chunk=chunk)
        print(f"first mLSTM layer, {src}: vs float64 "
              f"{(h.double() - want64).abs().max().item() / top:.3g}, vs mlstm_chunked "
              f"{(h - chunked).abs().max().item() / top:.3g}", flush=True)


def _probes(plain, tokens, want, tol):
    cell = xlstm.mlstm_chunked
    gen = torch.Generator(device="cuda").manual_seed(2)
    probes = {
        "relative noise 1e-7 of max |h|":
            lambda h, *_: h + 1e-7 * h.abs().max() * torch.randn(
                h.shape, generator=gen, device=h.device),
        "scale 1 + 1e-7": lambda h, *_: h * (1 + 1e-7),
        "float64 plain version": lambda h, q, k, v, il, fl, chunk: ref.mlstm_scan_ref(
            q, k, v, il, fl, chunk=chunk, dtype=torch.float64).to(h.dtype),
    }
    for name, probe in probes.items():
        def perturbed(q, k, v, il, fl, chunk, initial=None, probe=probe):
            h, state = cell(q, k, v, il, fl, chunk, initial)
            return probe(h, q, k, v, il, fl, chunk), state
        with mock.patch.object(xlstm, "mlstm_chunked", perturbed):
            got = plain(tokens)
        print(f"xla forward, mLSTM outputs {name}: logits move "
              f"{(got - want).abs().max().item() / tol:.3g} of tol", flush=True)


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args(argv)
    if not args.sources or not torch.cuda.is_available():
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 1
    builds = mlstm_variants._build(args.sources)
    print("card: " + timing.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = get_arch("xlstm-1.3b").spec()
    kernel_spec = serve.swap_spec_impl(spec, "pallas")
    xla_spec = serve.swap_spec_impl(spec, "xla")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    for seed in range(args.seeds):
        tokens = torch.randint(0, spec.vocab, (1, 2048), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(seed + 1))
        with torch.inference_mode():
            plain = LM(xla_spec).init(torch.Generator(device="cuda").manual_seed(seed))
            want = plain(tokens)
            tol = 1e-3 * want.abs().max().item()
            model = LM(kernel_spec).init(torch.Generator(device="cuda").manual_seed(seed), dtype)
            if args.bf16:
                plain16 = LM(xla_spec)
                plain16.load_state_dict(model.state_dict(), strict=True, assign=True)
                print(f"draw {seed}: xla forward, bf16 weights: max |err| / tol "
                      f"{(plain16(tokens).float() - want).abs().max().item() / tol:.3g}",
                      flush=True)
                del plain16
            else:
                if seed == 0:
                    _first_layer(model, tokens, args.sources, builds)
                exact = LM(xla_spec)
                exact.load_state_dict({k: v.double() for k, v in plain.state_dict().items()},
                                      strict=True, assign=True)
                want64 = exact(tokens)
                del exact
                plain_err = (want.double() - want64).abs()
                top = 1e-3 * want64.abs().max()
                tol64 = top + 2 * plain_err
                print(f"draw {seed}: xla forward fp32 against float64: max |err| / (1e-3 "
                      f"max|logits|) {(plain_err.max() / top).item():.3g}", flush=True)
            for src in args.sources:
                with mock.patch.object(ops, "mlstm_scan", _scan_with(builds[src])):
                    got = model(tokens).float()
                err = (got - want).abs().max().item() / tol
                new = ("" if args.bf16 else
                       f", against float64 {((got.double() - want64).abs() / tol64).max().item():.3g}")
                print(f"draw {seed}: logits, {src}: max |err| / tol against fp32 xla "
                      f"{err:.3g}{new}", flush=True)
                del got
            if not args.bf16:
                del want64, plain_err, tol64
            del model
            if seed == 0 and not args.bf16:
                _probes(plain, tokens, want, tol)
            del plain, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
