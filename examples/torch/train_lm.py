"""End-to-end LM pretraining on the port (the JAX package's
``examples/train_lm.py``).

Default runs a small model for a quick demo; ``--full`` selects the
~100M-parameter configuration: identical code path, bigger numbers.
Both train in fp32:

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300                # on the card
    PYTHONPATH=src python examples/torch/train_lm.py --full --steps 300         # ~100M
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 4 --seq 32 --batch 2

AdamW with a cosine schedule over ``--steps`` (3e-3, warm-up a tenth),
weight decay 0.01; the synthetic token stream through the prefetcher; an
asynchronous checkpoint every 100 steps (two kept) under ``--ckpt-dir``,
from whose latest step a run resumes.  As in the reference, the schedule
spans ``--steps`` and a checkpoint holds no schedule, so a run resumed to
a longer ``--steps`` trains on another schedule than an uninterrupted
one.  The weights are drawn from a generator seeded 0 on the device.

``main(argv)`` returns what it printed, and each step's loss, as a dict;
``train(args, model=)`` takes other initial weights.
"""
import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import Prefetcher, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.models.specs import ModelSpec, transformer_layer
from repro_torch.nn.types import param_count
from repro_torch.train.optimizer import Optimizer, OptimizerConfig, cosine_schedule
from repro_torch.train.step import make_train_step, param_dict


def model_spec(full: bool) -> ModelSpec:
    if full:  # ~100M params
        d, layers, ff, vocab, heads = 640, 10, 2560, 32000, 10
    else:  # CPU demo (~3.8M, the embeddings tied)
        d, layers, ff, vocab, heads = 192, 4, 768, 8192, 6
    return ModelSpec(
        name="lm-100m" if full else "lm-demo",
        d_model=d, vocab=vocab,
        layers=(transformer_layer(d, heads, max(heads // 2, 1), ff, qk_norm=True),) * layers,
        tie_embeddings=True, remat=False,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--full", action="store_true")
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--ckpt-dir", default="results/train_lm_ckpt")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args, model=None, log=print) -> dict:
    """Train as the arguments say, from ``model``'s weights if given (an
    :class:`LM` of ``model_spec(args.full)`` on the device).  Returns the
    summary: parameters, the step it resumed from, each step's loss, the
    logged steps, the loop's wall time, tokens/s and the allocator's peak
    on the card."""
    device = resolve_device(args.device)
    spec = model_spec(args.full)
    if model is None:
        model = LM(spec).init(torch.Generator(device).manual_seed(0), dtype=torch.float32)
    params = param_dict(model)
    n_params = param_count(params)
    log(f"model {spec.name}: {n_params:,} params")

    opt = Optimizer(OptimizerConfig(
        name="adamw",
        learning_rate=cosine_schedule(3e-3, warmup=args.steps // 10, total=args.steps),
        weight_decay=0.01,
    ))
    opt_state = opt.init(params)
    step = make_train_step(model, opt)

    data = SyntheticLMData(spec.vocab, args.seq, args.batch)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = ckpt.latest_step() or 0
    if start:
        start, restored = ckpt.restore(like={"params": params, "opt": opt_state},
                                       device=device)
        model.load_state_dict(restored["params"], assign=True)
        params, opt_state = param_dict(model), restored["opt"]
        log(f"resumed from step {start}")
    prefetch = Prefetcher(data, start_step=start)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    losses, logged = {}, []
    metrics = {"loss": torch.tensor(float("nan"))}
    t0 = time.time()
    tokens_seen = 0
    try:
        for _ in range(start, args.steps):
            i, batch = prefetch.next()
            batch = {k: torch.from_numpy(v).to(device, dtype=torch.long)
                     for k, v in batch.items()}
            params, opt_state, metrics = step(params, opt_state, batch)
            losses[i + 1] = metrics["loss"]
            tokens_seen += args.batch * args.seq
            if (i + 1) % 25 == 0:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                log(f"step {i + 1:4d}  loss {loss:.4f}  "
                    f"{tokens_seen / max(dt, 1e-9):,.0f} tok/s")
                logged.append({"step": i + 1, "loss": loss})
            if (i + 1) % 100 == 0:
                ckpt.save_async(i + 1, {"params": params, "opt": opt_state})
        _sync(device)
        wall = time.time() - t0
        ckpt.wait()
    finally:
        prefetch.close()
    final = float(metrics["loss"])
    log(f"done: final loss {final:.4f}")
    steps_run = args.steps - start
    return {"spec": spec.name, "n_params": n_params, "start_step": start,
            "losses": {k: float(v) for k, v in losses.items()}, "logged": logged,
            "final_loss": final, "steps_run": steps_run, "wall_s": wall,
            "step_ms": wall * 1e3 / max(steps_run, 1),
            "tokens_per_s": tokens_seen / max(wall, 1e-9),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                     if device.type == "cuda" else None)}


def main(argv=None) -> dict:
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
