"""Which train steps run on DTensor parameters under this machine's torch.

The smoke configs (and ``VARIANTS`` of two), two AdamW steps each, on
a (1, 1) NCCL mesh on the card and on a (2, 2) gloo mesh of 4 CPU
processes, each against the plain step from the same seed.  Prints one
``PROBE <mesh> <config> ok=<bool> {...}`` line a pair: the losses, the
first sharded step's seconds, the largest parameter difference and
whether the bits are equal, or the error with the aten op DTensor failed
on.  Run from the root of a checkout on a machine with a card:

    python scripts/dtensor_probe.py             # every config
    PROBE_ARCHS=qwen3-1.7b,dbrx-132b python scripts/dtensor_probe.py
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

ARCHS = ["qwen3-1.7b", "dbrx-132b", "zamba2-2.7b", "xlstm-1.3b", "whisper-medium",
         "arctic-480b", "paligemma-3b", "nemotron-4-340b", "phi4-mini-3.8b", "qwen1.5-4b",
         "qwen3-1.7b+seq_shard", "phi4-mini-3.8b+kv3"]
# attention variants: a sequence-sharded q; 3 KV heads for 6 q heads, so
# that on (2, 2) the q heads split and the KV heads stay whole
VARIANTS = {"seq_shard": dict(seq_shard=True), "kv3": dict(n_kv_heads=3)}
STEPS = 2
GLOO_RANKS = 4


def _with_attention(spec, **fields):
    return dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, subs=tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, **fields))
            if s.kind == "attention" else s for s in layer.subs))
        for layer in spec.layers))


def steps(name, mesh, device) -> dict:
    """``STEPS`` AdamW steps plain and on ``mesh`` from seed 0."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.distributed.api import sharding_context
    from repro_torch.distributed.sharding import default_rules, distribute_model, replicate_tree
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import Optimizer, OptimizerConfig
    from repro_torch.train.step import make_train_step, param_dict

    arch, _, variant = name.partition("+")
    spec = get_arch(arch).smoke_spec_fn()
    if variant:
        spec = _with_attention(spec, **VARIANTS[variant])
    rules = default_rules(mesh)
    opt = Optimizer(OptimizerConfig(name="adamw", learning_rate=1e-3))
    data = SyntheticLMData(spec.vocab, 16, 4)
    plain = LM(spec).init(torch.Generator(device=device).manual_seed(0))
    p0 = param_dict(plain)
    s0, f0 = opt.init(p0), make_train_step(plain, opt)
    sharded = LM(spec).init(torch.Generator(device=device).manual_seed(0))
    p1 = distribute_model(sharded, mesh, rules)
    with sharding_context(mesh, rules):
        s1 = opt.init(p1)
    f1 = make_train_step(sharded, opt)
    row = {"losses": [], "first_s": None}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).long().to(device) for k, v in data.batch_at(i).items()}
        p0, s0, m0 = f0(p0, s0, batch)
        t0 = time.perf_counter()
        with sharding_context(mesh, rules):
            p1, s1, m1 = f1(p1, s1, replicate_tree(batch, mesh))
        loss = float(m1["loss"].full_tensor())
        if i == 0:
            row["first_s"] = time.perf_counter() - t0
        row["losses"].append([float(m0["loss"]), loss])
    row["param_max_abs_diff"] = max(float((p0[k] - p1[k].full_tensor()).abs().max()) for k in p0)
    row["bits"] = all(torch.equal(p0[k], p1[k].full_tensor()) for k in p0)
    return row


def probe(mesh, device, tag, rank=0) -> None:
    for name in os.environ.get("PROBE_ARCHS", ",".join(ARCHS)).split(","):
        try:
            row, ok = steps(name, mesh, device), True
        except Exception as e:  # a probe reports each failure and goes on
            where = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                     for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]
            row, ok = {"error": f"{type(e).__name__}: {str(e)[:600]}", "where": where[-4:]}, False
        if rank == 0:
            print(f"PROBE {tag} {name} ok={ok} " + json.dumps(row), flush=True)


def name_dtensor_ops() -> None:
    """Prefix DTensor's dispatch errors with the aten op that raised them."""
    from torch.distributed.tensor import _dispatch

    for method in ("dispatch", "_propagate_op_sharding_dispatch_slow_path",
                   "_dispatch_get_local_results_slow_path"):
        orig = getattr(_dispatch.OpDispatcher, method, None)
        if orig is None:
            continue

        def named(self, op_call, *args, _orig=orig, **kwargs):
            try:
                return _orig(self, op_call, *args, **kwargs)
            except Exception as e:
                if str(e).startswith("[aten"):
                    raise
                node = torch._C._current_autograd_node()  # in a backward: its node
                where = f" in {node.name()}" if node is not None else ""
                raise RuntimeError(f"[{op_call}{where}] {type(e).__name__}: {e}") from e

        setattr(_dispatch.OpDispatcher, method, named)


def main() -> None:
    import torch.distributed as dist

    sys.path.insert(0, "src")
    name_dtensor_ops()
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    if mode == "nccl":
        from repro_torch.launch.mesh import make_host_mesh

        probe(make_host_mesh("cuda"), "cuda", "nccl(1,1)")
        dist.destroy_process_group()
    elif mode == "gloo":
        rank, store = int(sys.argv[2]), sys.argv[3]
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, GLOO_RANKS), rank=rank,
                                world_size=GLOO_RANKS, timeout=datetime.timedelta(seconds=300))
        from repro_torch.launch.mesh import make_mesh

        probe(make_mesh((2, 2), ("data", "model")), "cpu", "gloo(2,2)", rank)
        dist.destroy_process_group()
    else:
        print(sys.version, torch.__version__, torch.version.cuda, flush=True)
        env = dict(os.environ, PYTHONPATH="src")
        with tempfile.TemporaryDirectory() as tmp:
            store = os.path.join(tmp, "store")
            ranks = [subprocess.Popen([sys.executable, __file__, "gloo", str(r), store], env=env,
                                      stdout=None if r == 0 else subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL) for r in range(GLOO_RANKS)]
            try:
                subprocess.run([sys.executable, __file__, "nccl"], env=env, timeout=900)
                for proc in ranks:
                    proc.wait(timeout=1200)
            finally:
                for proc in ranks:
                    proc.kill()


if __name__ == "__main__":
    main()
