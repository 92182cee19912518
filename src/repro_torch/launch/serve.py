"""Serving driver: continuous-batching engine + artifact-store warm boot.

Two modes share one traffic-shaped request loop (bounded admission
queue, continuous batching up to a concurrency limit, graceful shedding
when the queue is full), driven by a deterministic seeded
:class:`~repro_torch.launch.traffic.TrafficSpec`.

Report mode serves the winning candidate of an exploration::

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --from-report results/serving.report.json --expect-compiles 0

It rebuilds the best architecture from the report's recorded trial
params and loads its program from the artifact store the exploration
filled (:mod:`repro_torch.evaluation.artifact_store`): a warm boot
generates nothing (``compiles`` in the JSON summary counts generates;
``--expect-compiles 0`` enforces it).  It runs on the report target's
device: the seed-0 weights are placed there once, and each joining
batch's input is copied there and run through the loaded program, which
launches the kernels the exploration measured.

LM mode serves a language model::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --requests 8 --max-batch 4 --queue-limit 8

Prompts run through :meth:`LM.prefill` and join the running batch
mid-flight; decode advances every active slot with a per-slot position
vector.  Every attention, Mamba2 and mLSTM sub-block is served with
``impl="pallas"``, so each prefill of a transformer runs the
flash-attention kernel once per attention layer.  A recurrent layer
(``--arch xlstm-1.3b``, the Mamba2 layers of ``--arch zamba2-2.7b``)
prefills by looping its decode step over the prompt, as the JAX package
does, so it runs no scan kernel in serving.  ``--arch paligemma-3b``
serves text prompts (prefill takes no image prefix, as in the JAX
package); ``--arch whisper-medium`` serves with no encoder output, so its
cross-attention adds zeros, as the JAX package's engine does.  Serving
runs on CUDA; ``--device cpu`` asks for the CPU (where the kernel's plain
version stands in for it), and without a card nothing runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import NoCudaCardError, resolve_device
from repro_torch.launch.traffic import TrafficSpec
from repro_torch.models.lm import LM


# ---------------------------------------------------------------------------
# shared request loop
# ---------------------------------------------------------------------------

class RequestQueue:
    """Bounded admission queue: arrivals beyond ``limit`` are shed."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self.items: List[Any] = []
        self.shed: List[Any] = []

    def offer(self, request) -> bool:
        if len(self.items) >= self.limit:
            self.shed.append(request)
            return False
        self.items.append(request)
        return True

    def take(self):
        return self.items.pop(0) if self.items else None

    def __len__(self):
        return len(self.items)


def _admit(queue: RequestQueue, pending: List[Any], upto: float) -> None:
    while pending and pending[0].arrival_s <= upto:
        queue.offer(pending.pop(0))


# ---------------------------------------------------------------------------
# LM mode: continuous batching with per-slot cache depths
# ---------------------------------------------------------------------------

class ServingEngine:
    """Continuous-batching engine for :class:`repro_torch.models.lm.LM`.

    One batched decode cache serves ``max_batch`` slots; joining
    requests prefill at batch 1 through the full-sequence kernel and are
    copied into their slot, so the running batch never stalls for a
    joiner's token-by-token warmup.  Decode advances all active slots in
    one step with a per-slot position vector.  Admission is clocked by a
    simulated tick (``tick_s`` per engine iteration), so a fixed seed
    replays the same admissions, sheds, and outputs on any host.
    """

    def __init__(self, model: LM, *, max_batch: int, queue_limit: int,
                 max_context: int, tick_s: float = 0.01):
        self.model = model
        self.device = model.embed.device
        self.max_batch = int(max_batch)
        self.max_context = int(max_context)
        self.tick_s = float(tick_s)
        self.queue = RequestQueue(queue_limit)
        self.cache = model.init_cache(self.max_batch, self.max_context,
                                      dtype=torch.float32)
        # slot i: None, or dict(req=, pos=, token=, out=[generated tokens])
        self.slots: List[Optional[Dict[str, Any]]] = [None] * self.max_batch
        self.completed: List[Dict[str, Any]] = []
        self.iterations = 0
        self.prefills = 0
        # host clock per join / per decode step, each ending in a device sync
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    def _merge_slot(self, single_cache, slot: int) -> None:
        """Copy a batch-1 prefilled cache into slot ``slot`` of the batched
        cache, in place: every leaf of every sub-block (K/V, recurrent
        states), whose batch axis is the first.  (The JAX engine rebuilds
        every cache leaf with a dynamic update slice, because its arrays
        are immutable.)"""
        for dst, src in zip(self.cache, single_cache, strict=True):
            for name, leaves in src.items():
                for leaf, value in leaves.items():
                    dst[name][leaf][slot].copy_(value[0])

    def _join(self, req) -> None:
        """Prefill one request (full-sequence kernel) into a free slot."""
        slot = self.slots.index(None)
        prompt = torch.as_tensor(req.prompt_tokens(self.model.spec.vocab)[None],
                                 dtype=torch.long, device=self.device)
        t0 = time.perf_counter()
        single = self.model.init_cache(1, self.max_context, dtype=torch.float32)
        logits, single = self.model.prefill(single, prompt)
        self._merge_slot(single, slot)
        first = int(torch.argmax(logits[0, -1]))  # waits for the device
        self.prefill_s.append(time.perf_counter() - t0)
        self.prefills += 1
        self.slots[slot] = {"req": req, "pos": req.prompt_len,
                            "token": first, "out": [first]}

    def _decode_step(self) -> None:
        """One engine iteration: every active slot decodes one token."""
        t0 = time.perf_counter()
        tokens = np.zeros((self.max_batch, 1), np.int64)
        pos = np.zeros((self.max_batch,), np.int64)
        for i, s in enumerate(self.slots):
            if s is not None:
                tokens[i, 0] = s["token"]
                pos[i] = s["pos"]
        logits, self.cache = self.model.decode(
            self.cache, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        self.decode_s.append(time.perf_counter() - t0)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s["pos"] += 1
            s["token"] = int(nxt[i])
            s["out"].append(int(nxt[i]))
            if len(s["out"]) >= s["req"].gen_len or s["pos"] + 1 >= self.max_context:
                self.completed.append({
                    "id": s["req"].id,
                    "prompt_len": s["req"].prompt_len,
                    "tokens": s["out"],
                    "finish_iter": self.iterations,
                })
                self.slots[i] = None

    def run(self, requests: List[Any]) -> Dict[str, Any]:
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.id))
        now = 0.0
        with torch.inference_mode():
            while pending or len(self.queue) or any(s is not None for s in self.slots):
                _admit(self.queue, pending, now)
                if not len(self.queue) and all(s is None for s in self.slots):
                    now = max(now, pending[0].arrival_s)
                    _admit(self.queue, pending, now)
                while len(self.queue) and None in self.slots:
                    self._join(self.queue.take())
                if any(s is not None for s in self.slots):
                    self._decode_step()
                self.iterations += 1
                now += self.tick_s
        self.completed.sort(key=lambda r: r["id"])
        return {
            "served": len(self.completed),
            "shed": len(self.queue.shed),
            "shed_ids": [r.id for r in self.queue.shed],
            "iterations": self.iterations,
            "prefills": self.prefills,
            "tokens_generated": sum(len(r["tokens"]) for r in self.completed),
        }


def _map_sub_cfg(layers, kinds, **fields):
    out = []
    for layer in layers:
        subs = tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, **fields))
            if s.kind in kinds else s
            for s in layer.subs
        )
        out.append(dataclasses.replace(layer, subs=subs))
    return tuple(out)


KERNEL_KINDS = ("attention", "mamba2", "mlstm")  # sub-blocks whose impl picks a kernel


def swap_spec_impl(spec, impl):
    """``spec`` with ``impl`` set on every attention, Mamba2 and mLSTM
    sub-block of its decoder and encoder layers: ``"pallas"`` runs the
    kernels (flash attention, the SSD scan, the mLSTM scan), ``"xla"`` their
    plain layers.  Cross-attention keeps its impl: it never runs the kernel.
    Plain dataclass surgery: it fits the JAX package's specs too."""
    return dataclasses.replace(
        spec, layers=_map_sub_cfg(spec.layers, KERNEL_KINDS, impl=impl),
        encoder_layers=_map_sub_cfg(spec.encoder_layers, KERNEL_KINDS, impl=impl))


def _serve_lm(args):
    """Serve ``args.arch`` with random weights (seed 0) under the traffic
    the arguments declare.  Returns (summary, engine)."""
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    spec = arch.smoke_spec_fn() if args.smoke else arch.spec()
    spec = swap_spec_impl(spec, "pallas")
    generator = torch.Generator(device=device).manual_seed(0)
    model = LM(spec).init(generator, dtype=torch.float32)

    traffic = _traffic_from_args(args)
    engine = ServingEngine(
        model, max_batch=args.max_batch, queue_limit=args.queue_limit,
        max_context=min(traffic.max_context + 1, spec.max_position),
        tick_s=args.tick_ms / 1e3)
    t0 = time.perf_counter()
    summary = engine.run(traffic.requests())
    wall = time.perf_counter() - t0
    summary.update({
        "mode": "lm", "arch": spec.name, "device": str(device),
        "traffic": traffic.to_dict(),
        "max_batch": args.max_batch, "queue_limit": args.queue_limit,
        "wall_s": round(wall, 3),
        "tok_per_s": round(summary["tokens_generated"] / max(wall, 1e-9), 1),
        "prefill_ms": [round(s * 1e3, 3) for s in engine.prefill_s],
        "decode_ms": [round(s * 1e3, 3) for s in engine.decode_s],
        "sample": engine.completed[0]["tokens"][:8] if engine.completed else [],
    })
    return summary, engine


# ---------------------------------------------------------------------------
# report mode: warm-boot the exploration winner from the artifact store
# ---------------------------------------------------------------------------

def rebuild_best(report: Dict[str, Any]):
    """(candidate, spec): the report's best architecture, rebuilt from its
    recorded trial params through a trial whose params are preset."""
    from repro_torch.core.builder import ModelBuilder
    from repro_torch.core.space import parse_search_space
    from repro_torch.core.translate import sample_architecture
    from repro_torch.explorer.experiment import ExperimentSpec
    from repro_torch.search.trial import Trial

    if not report.get("best"):
        raise SystemExit("report has no best trial to serve")
    spec = ExperimentSpec.from_dict(report["spec"])
    space = parse_search_space(dict(spec.search_space))
    trial = Trial(number=report["best"].get("number", 0), study=None)
    trial.params = dict(report["best"]["params"])
    arch = sample_architecture(space, trial)
    recorded = report["best"].get("signature")
    if recorded is not None and arch.signature() != recorded:
        raise SystemExit(
            f"rebuilt architecture signature {arch.signature()!r} does not "
            f"match the report's {recorded!r}; the search space or builder "
            f"changed since the exploration")
    builder = ModelBuilder(space.input_shape, space.output_dim)
    return builder.build(arch), spec


def _serve_report(args) -> Dict[str, Any]:
    """Boot the report's winner (from the store, or by generating it) and
    serve the report's traffic through it, one forward per joining batch."""
    from repro_torch.evaluation.serving import _ServingEstimator
    from repro_torch.explorer.experiment import ServingSpec
    from repro_torch.hwgen.generator import generate_call_count
    from repro_torch.kernels import ops
    from repro_torch.kernels import schedule as ksched
    from repro_torch.launch.traffic import ServingCosts, ServingSim

    with open(args.from_report) as f:
        report = json.load(f)
    candidate, spec = rebuild_best(report)
    serving = spec.serving if spec.serving is not None else ServingSpec()
    if args.requests:
        serving.traffic.n_requests = args.requests
    if spec.cache.dir is None:
        print("warning: report's experiment had no cache dir; the boot "
              "will generate instead of loading", file=sys.stderr)

    est = _ServingEstimator(target=spec.target, serving=serving, cache=spec.cache.dir)
    device = resolve_device(est.generator.target.device)
    before = generate_call_count()
    t0 = time.perf_counter()
    # the winner's kernel schedules, as the exploration tuned or searched
    # them: the program key names them, so a tuned exploration's program
    # is the one found
    schedules = (report.get("kernel_tuning") or {}).get("schedules")
    plan = est._schedule_plan(candidate, {"schedules": schedules} if schedules else None)
    t_plan = time.perf_counter()
    artifact = est._artifact(candidate, plan)
    t_artifact = time.perf_counter()
    artifact.fn.to(device)  # the seed-0 weights, placed once
    boot_s = time.perf_counter() - t0
    boot_parts = {"plan_s": t_plan - t0, "artifact_s": t_artifact - t_plan,
                  "place_s": boot_s - (t_artifact - t0)}
    compiles = generate_call_count() - before

    # the admission/shedding/batching model the estimators ranked this
    # candidate by, with the booted program run once per joining batch
    requests = serving.traffic.requests()
    queue = RequestQueue(serving.queue_limit)
    pending = sorted(requests, key=lambda r: (r.arrival_s, r.id))
    seq_len = max(1, int(candidate.input_shape[-1]))
    costs = ServingCosts(
        prefill_s_per_token=est._prefill_bound_s(candidate, plan)
        / (serving.max_batch * seq_len),
        decode_step_s=est._decode_step_s(candidate))
    now, served, batches = 0.0, 0, 0
    l, c = int(candidate.input_shape[-1]), int(candidate.input_shape[0])
    launches = dict(ops.LAUNCHES)
    t1 = time.perf_counter()
    with torch.inference_mode(), ksched.use_schedules(artifact.schedules):
        while pending or len(queue):
            _admit(queue, pending, now)
            if not len(queue):
                now = max(now, pending[0].arrival_s)
                _admit(queue, pending, now)
            group = []
            while len(queue) and len(group) < serving.max_batch:
                group.append(queue.take())
            if not group:
                continue
            xb = np.zeros((serving.max_batch, l, c), np.float32)
            for i, req in enumerate(group):
                rng = np.random.default_rng(req.token_seed)
                xb[i] = rng.standard_normal((l, c)).astype(np.float32)
            artifact(torch.from_numpy(xb).to(device))
            served += len(group)
            batches += 1
            now += sum(r.prompt_len for r in group) * costs.prefill_s_per_token \
                + costs.decode_step_s
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    exec_s = time.perf_counter() - t1

    sim = ServingSim(max_batch=serving.max_batch,
                     queue_limit=serving.queue_limit).run(requests, costs)
    return {
        "mode": "report",
        "experiment": report.get("experiment"),
        "signature": candidate.arch.signature(),
        "target": spec.target,
        "device": str(device),
        "compiles": compiles,
        "artifact_store": est.artifacts.stats() if est.artifacts else None,
        "boot_s": boot_s,
        "boot_parts": boot_parts,
        "served": served,
        "shed": len(queue.shed),
        "batches": batches,
        "exec_s": exec_s,
        "launches": {k: v - launches.get(k, 0) for k, v in ops.LAUNCHES.items()
                     if v != launches.get(k, 0)},
        "traffic": serving.traffic.to_dict(),
        "modelled": {k: sim[k] for k in
                     ("p50_latency_s", "p99_latency_s", "throughput_tok_s",
                      "peak_concurrency")},
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_mix(text: Optional[str]) -> Optional[Dict[int, float]]:
    """``"8,16"`` -> equal weights; ``"8:0.75,16:0.25"`` -> weighted."""
    if not text:
        return None
    mix: Dict[int, float] = {}
    for part in text.split(","):
        if ":" in part:
            k, w = part.split(":", 1)
            mix[int(k)] = float(w)
        else:
            mix[int(part)] = 1.0
    return mix


def _traffic_from_args(args) -> TrafficSpec:
    raw: Dict[str, Any] = {
        "seed": args.seed, "n_requests": args.requests or 8,
        "arrival": args.arrival, "rate_rps": args.rate_rps,
    }
    if _parse_mix(args.prompt_lens):
        raw["prompt_lens"] = _parse_mix(args.prompt_lens)
    if _parse_mix(args.gen_lens):
        raw["gen_lens"] = _parse_mix(args.gen_lens)
    return TrafficSpec.from_raw(raw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--arch", default=None,
                      help="serve a named LM architecture (default: the "
                           "qwen3-1.7b smoke config)")
    mode.add_argument("--from-report", default=None,
                      help="serve an exploration report's best candidate, "
                           "loading its program from the artifact store")
    p.add_argument("--smoke", action="store_true",
                   help="reduced same-family config (LM mode)")
    p.add_argument("--requests", type=int, default=0,
                   help="number of requests (0 = traffic default)")
    p.add_argument("--arrival", default="burst",
                   choices=("burst", "uniform", "poisson"))
    p.add_argument("--rate-rps", type=float, default=8.0)
    p.add_argument("--prompt-lens", default="",
                   help="prompt length mix, e.g. '8,16' or '8:0.75,16:0.25'")
    p.add_argument("--gen-lens", default="",
                   help="generation length mix, same syntax")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--queue-limit", type=int, default=8)
    p.add_argument("--tick-ms", type=float, default=10.0,
                   help="simulated admission clock per engine iteration")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where to serve in LM mode (default cuda; there is no "
                        "fallback); report mode serves on the report target's "
                        "device")
    p.add_argument("--expect-compiles", type=int, default=None,
                   help="exit nonzero if the boot generated more candidates "
                        "than this (report mode)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.arch is None and args.from_report is None:
        args.arch = "qwen3-1.7b"
        args.smoke = True
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        if args.from_report:
            summary = _serve_report(args)
        else:
            summary, _ = _serve_lm(args)
    except NoCudaCardError as e:
        raise SystemExit(f"serve: {e}") from None
    print(json.dumps(summary))
    if args.expect_compiles is not None and args.from_report:
        if summary["compiles"] > args.expect_compiles:
            print(f"FAIL: boot generated {summary['compiles']} candidate(s), "
                  f"expected <= {args.expect_compiles}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
