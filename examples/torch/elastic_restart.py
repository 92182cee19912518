"""Elastic restart demo on the port (the JAX package's
``examples/elastic_restart.py``): train -> checkpoint -> "lose" devices ->
resume on a different mesh with resharded state.

On a real pod this is the failure path: a host dies, the job restarts
with fewer cards, ``elastic_remesh`` builds the largest viable mesh and
the checkpoint restores onto it (the Checkpointer stores whole host
arrays; each rank slices its shard from them).  In one process the two
meshes are (1, 1) -> (1, 1), but the code path (save under mesh A,
restore under an independently constructed mesh B with new placements)
is the same.

    PYTHONPATH=src python examples/torch/elastic_restart.py               # on the card
    PYTHONPATH=src python examples/torch/elastic_restart.py --device cpu

The process group of one rank is NCCL on the card and gloo on the CPU
(``launch/mesh.py::start_single_process_group``); a group this example
started is destroyed at its end.  Parameters are DTensors placed by
``shapes_shardings_from_axes`` from their logical axes, and the optimizer
state follows them.  The reference restores the optimizer with
``{"step": rep_b, "mu": sh_b, "nu": sh_b}``; the port's AdamW state has
the same three entries, its moments keyed like the parameters (state-dict
names, where the reference nests the JAX tree), so the port's
``shardings`` tree is the same tree of placements: ``step`` replicated,
``mu`` and ``nu`` each placed as its parameter.

``main(argv)`` returns what it printed as a dict; ``run(device,
ckpt_dir, weights=)`` takes other initial weights.
"""
import argparse
import shutil
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.distributed.api import sharding_context
from repro_torch.distributed.fault import StragglerMonitor, elastic_remesh
from repro_torch.distributed.sharding import (default_rules, placements, replicate_tree,
                                               shapes_shardings_from_axes)
from repro_torch.launch.mesh import start_single_process_group
from repro_torch.models.lm import LM
from repro_torch.models.specs import ModelSpec, transformer_layer
from repro_torch.nn.types import param_axes
from repro_torch.train.optimizer import Optimizer, OptimizerConfig
from repro_torch.train.step import make_train_step, param_dict

CKPT = "results/elastic_demo_ckpt"


def build(device: torch.device, weights=None):
    """``(spec, model, opt)``: the demo LM drawn from a generator seeded 0
    on ``device``, or ``weights(spec)`` (an :class:`LM` on ``device``)."""
    spec = ModelSpec(name="elastic-demo", d_model=64, vocab=512,
                     layers=(transformer_layer(64, 4, 2, 128),) * 2, remat=False)
    model = (weights(spec) if weights is not None else
             LM(spec).init(torch.Generator(device).manual_seed(0), dtype=torch.float32))
    opt = Optimizer(OptimizerConfig(name="adamw", learning_rate=1e-3))
    return spec, model, opt


def shardings(model, mesh, rules):
    """Each parameter's placements on ``mesh``, from its logical axes."""
    params = param_dict(model)
    specs = shapes_shardings_from_axes(params, param_axes(model), mesh, rules)
    return {k: placements(specs[k], mesh) for k in params}


def place(model, mesh, rules) -> dict:
    """Shard ``model``'s parameters onto ``mesh`` in place; returns the
    ``{state-dict name: DTensor}`` mapping a train step takes."""
    from torch.distributed.tensor import distribute_tensor

    sh = shardings(model, mesh, rules)
    state = {k: distribute_tensor(p.detach(), mesh, sh[k], src_data_rank=None)
             for k, p in model.named_parameters()}
    model.load_state_dict(state, strict=True, assign=True)
    return param_dict(model)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _train(step, params, opt_state, data, steps, mesh, device, monitor=None):
    metrics = None
    for i in steps:
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(device, dtype=torch.long)
                 for k, v in data.batch_at(i).items()}
        params, opt_state, metrics = step(params, opt_state, replicate_tree(batch, mesh))
        if monitor is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            monitor.record(time.time() - t0)
    return params, opt_state, float(metrics["loss"].full_tensor())


def run(device="cuda", ckpt_dir: str = CKPT, weights=None, log=print) -> dict:
    """Both phases; returns each phase's mesh and loss, the restart step,
    the straggler flags, and the parameters saved at step 10 and those
    restored from it (host tensors)."""
    device = resolve_device(device)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    owned = not dist.is_initialized()
    start_single_process_group(device.type)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    try:
        spec, model, opt = build(device, weights)
        data = SyntheticLMData(spec.vocab, seq=32, global_batch=4)
        ckpt = Checkpointer(ckpt_dir, keep=2)

        # ---- phase 1: train on mesh A ------------------------------------
        mesh_a = elastic_remesh((16, 16), ("data", "model"))
        rules = default_rules(mesh_a)
        monitor = StragglerMonitor()
        with sharding_context(mesh_a, rules):
            params = place(model, mesh_a, rules)
            opt_state = opt.init(params)
            step = make_train_step(model, opt)
            params, opt_state, loss_a = _train(step, params, opt_state, data, range(10),
                                               mesh_a, device, monitor)
            ckpt.save(10, {"params": params, "opt": opt_state})
        saved = {k: v.full_tensor().to("cpu", copy=True) for k, v in params.items()}
        log(f"phase 1 (mesh {_mesh_shape(mesh_a)}): loss {loss_a:.4f}, checkpoint at step 10")

        # ---- phase 2: "restart" with a re-built mesh + resharded restore --
        spec, model, opt = build(device, weights)  # fresh process state
        mesh_b = elastic_remesh((16, 8), ("data", "model"))  # degraded topology
        rules_b = default_rules(mesh_b)
        sh_b = shardings(model, mesh_b, rules_b)
        rep_b = placements((), mesh_b)
        params_like = param_dict(model)
        with sharding_context(mesh_b, rules_b):
            step_idx, restored = ckpt.restore(
                like={"params": params_like, "opt": opt.init(params_like)},
                shardings={"params": sh_b, "opt": {"step": rep_b, "mu": sh_b, "nu": sh_b}},
            )
            model.load_state_dict(restored["params"], strict=True, assign=True)
            params, opt_state = param_dict(model), restored["opt"]
            loaded = {k: v.full_tensor().to("cpu", copy=True) for k, v in params.items()}
            step = make_train_step(model, opt)
            params, opt_state, loss_b = _train(step, params, opt_state, data,
                                               range(step_idx, step_idx + 10), mesh_b, device)
        log(f"phase 2 resumed at step {step_idx} on mesh {_mesh_shape(mesh_b)}: "
            f"loss {loss_b:.4f} after 10 more steps")
        log("elastic restart OK")
    finally:
        if owned and dist.is_initialized():  # the group this run started
            dist.destroy_process_group()
    return {"mesh_a": _mesh_shape(mesh_a), "loss_a": loss_a, "restart_step": step_idx,
            "mesh_b": _mesh_shape(mesh_b), "loss_b": loss_b,
            "straggler_flags": monitor.flags, "saved": saved, "restored": loaded}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    out = run(args.device)
    return {k: v for k, v in out.items() if k not in ("saved", "restored")}


if __name__ == "__main__":
    main()
