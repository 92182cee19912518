"""Worker programs of ``test_torch_distributed.py``, each run as its own
process with a time limit (not collected: the name has no ``test_``).

    python torch_distributed_worker.py gloo RANK WORLD DIR
        one rank of the port's sharded checks over gloo, on a FileStore in
        DIR: the qwen3 smoke train steps on a (2, 2) mesh from DIR/init.npz,
        the train CLI's ``run(mesh=)`` with a checkpoint, its restore onto
        a (4, 1) mesh, dbrx smoke losses (with and without ``shard_ff``),
        a ``seq_shard`` forward, one step's gradients of ``GRAD_ARCHS``
        plain and on (2, 2), ``compress_decompress`` on DTensors,
        ``compressed_psum`` over 2 and 4 ranks and ``elastic_remesh``;
        rank 0 writes DIR/gloo.npz and DIR/gloo.json, every rank its
        ``compressed_psum`` outputs.
    python torch_distributed_worker.py jax DIR
        the JAX package on 4 spoofed host devices: the same train steps on
        a (2, 2) mesh and ``compressed_psum`` in ``shard_map``; writes
        DIR/jax.npz and DIR/jax.json.

Both read their inputs (weights, batches, gradients) from DIR, written by
the test from seeded numpy draws.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np

STEPS = 3
LR_STEPS = (1e-3, 1, 3)  # cosine_schedule(base, warmup, total)
OPT = dict(name="adamw", weight_decay=0.1, grad_clip_norm=1.0)
PSUM_SHAPES = {"w": (3, 300), "b": (7,)}
GRAD_ARCHS = ("paligemma-3b", "zamba2-2.7b", "xlstm-1.3b", "arctic-480b", "qwen3-1.7b+seq_shard",
              "phi4-mini-3.8b+kv3")
# attention variants of a smoke config: a sequence-sharded q, and 3 KV heads
# for 6 q heads, which split on model = 2 where the KV heads do not
VARIANTS = {"seq_shard": dict(seq_shard=True), "kv3": dict(n_kv_heads=3)}
# decode against caches placed by their logical axes: attention's K/V
# sequence split, Mamba2's heads and the shared layer, whisper's cross K/V,
# the mLSTM and sLSTM states
DECODE_ARCHS = ("qwen3-1.7b", "zamba2-2.7b", "whisper-medium", "xlstm-1.3b")
DECODE_STEPS = 3


def nested(flat):
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    out = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def psum_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    out = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
           for k, s in PSUM_SHAPES.items()}
    out["w"][0, :5] = 0.0  # an all-but-zero block, and exact halves below
    out["w"][1, :4] = [0.5, -1.5, 2.5, -0.0]
    return out


def with_attention(spec, **fields):
    return dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, subs=tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, **fields))
            if s.kind == "attention" else s for s in layer.subs))
        for layer in spec.layers))


def with_moe(spec, **fields):
    return dataclasses.replace(spec, layers=tuple(
        dataclasses.replace(layer, subs=tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, **fields))
            if s.kind == "moe" else s for s in layer.subs))
        for layer in spec.layers))


# -- the port over gloo ---------------------------------------------------------------------

def gloo(rank, world, d):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        arrays, info = _gloo_checks(rank, d)
        if rank == 0:
            np.savez(os.path.join(d, "gloo.npz"), **arrays)
            with open(os.path.join(d, "gloo.json"), "w") as f:
                json.dump(info, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _full(tree):
    """{name: numpy} of a tree of DTensors (gathered on every rank)."""
    return {k: v.full_tensor().numpy() for k, v in tree.items()}


def _layout(tree, mesh):
    from repro_torch.distributed.sharding import spec_of

    return {k: {"dtensor": type(v).__name__ == "DTensor",
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in spec_of(v.placements, v.dim(), mesh)],
                "local": list(v.to_local().shape)} for k, v in tree.items()}


def _gloo_checks(rank, d):
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_arch
    from repro_torch.convert import lm_from_jax
    from repro_torch.distributed.api import sharding_context
    from repro_torch.distributed.compression import GradientCompressor
    from repro_torch.distributed.fault import elastic_remesh
    from repro_torch.distributed.sharding import (default_rules, distribute_model,
                                                  placements_tree, replicate_tree)
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer as topt
    from repro_torch.train import step as tstep

    arrays, info = {}, {}
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh)
    batches = np.load(os.path.join(d, "batches.npz"))

    # the qwen3 smoke steps from the JAX weights
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    init = np.load(os.path.join(d, "init.npz"))
    model = lm_from_jax(spec, nested(dict(init)), device="cpu")
    params = distribute_model(model, mesh, rules)
    opt = topt.Optimizer(topt.OptimizerConfig(
        learning_rate=topt.cosine_schedule(*LR_STEPS), **OPT))
    fn = tstep.make_train_step(model, opt)
    with sharding_context(mesh, rules):
        state = opt.init(params)
        losses = []
        for i in range(STEPS):
            batch = replicate_tree({"tokens": torch.from_numpy(batches[f"tokens_{i}"])}, mesh)
            params, state, metrics = fn(params, state, batch)
            losses.append(float(metrics["loss"].to_local()))
    info["steps"] = {"losses": losses, "params": _layout(params, mesh),
                     "mu": _layout(state["mu"], mesh), "nu": _layout(state["nu"], mesh),
                     "step": {"value": int(state["step"].to_local()),
                              "replicated": all(p.is_replicate()
                                                for p in state["step"].placements)},
                     "module_is_mapping": all(
                         p.to_local().data_ptr() == params[k].to_local().data_ptr()
                         for k, p in model.named_parameters())}
    arrays.update({f"steps/{k}": v for k, v in _full(params).items()})
    arrays.update({f"mu/{k}": v for k, v in _full(state["mu"]).items()})

    # the train CLI on the mesh, with a checkpoint after its last step
    ckpt = os.path.join(d, "ckpt")
    args = train_cli.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", str(STEPS), "--seq", "16",
         "--global-batch", "2", "--log-every", "100", "--ckpt-dir", ckpt,
         "--ckpt-every", str(STEPS)])
    summary, cli = train_cli.run(args, mesh=mesh)
    info["cli"] = {"losses": summary["losses"], "params": _layout(cli["params"], mesh),
                   "mu": _layout(cli["opt_state"]["mu"], mesh)}
    arrays.update({f"cli/{k}": v for k, v in _full(cli["params"]).items()})

    # that checkpoint restored onto a (4, 1) mesh
    mesh41 = make_mesh((4, 1), ("data", "model"))
    model41 = LM(spec).init(torch.Generator().manual_seed(1))
    like_params = distribute_model(model41, mesh41, default_rules(mesh41))
    like = {"params": like_params, "opt": opt.init(like_params)}
    with sharding_context(mesh41, default_rules(mesh41)):
        step, restored = Checkpointer(ckpt).restore(like=like, shardings=placements_tree(like))
    info["restore41"] = {"step": step, "params": _layout(restored["params"], mesh41)}
    arrays.update({f"restore41/{k}": v for k, v in _full(restored["params"]).items()})
    arrays.update({f"restore41_nu/{k}": v for k, v in _full(restored["opt"]["nu"]).items()})

    # dbrx smoke: the loss with and without 2D experts
    dbrx = get_arch("dbrx-132b").smoke_spec_fn()
    tokens = torch.from_numpy(batches["dbrx_tokens"])
    info["dbrx"] = {}
    for shard_ff in (False, True):
        m = LM(with_moe(dbrx, shard_ff=shard_ff)).init(torch.Generator().manual_seed(0))
        p = distribute_model(m, mesh, rules)
        with sharding_context(mesh, rules):
            loss = tstep.make_loss_fn(m)(p, replicate_tree({"tokens": tokens}, mesh))
        info["dbrx"][str(shard_ff)] = {"loss": float(loss.full_tensor()),
                                       "params": _layout(p, mesh)}

    # seq_shard: the full-sequence forward with q sequence-sharded
    m = LM(with_attention(spec, seq_shard=True)).init(torch.Generator().manual_seed(0))
    p = distribute_model(m, mesh, rules)
    with sharding_context(mesh, rules), torch.no_grad():
        logits = tstep.call(m, p, "forward", replicate_tree(
            torch.from_numpy(batches["tokens_0"]), mesh))
    arrays["seq_shard_logits"] = logits.full_tensor().numpy()

    # one step's gradients of configs whose sharded paths differ from
    # qwen3's (one KV head, the SSD and mLSTM scans, MoE with a dense
    # branch, a sequence-sharded q, KV heads whole under split q heads)
    # against the unsharded ones
    info["grads"] = {}
    for name in GRAD_ARCHS:
        arch, _, variant = name.partition("+")
        gspec = get_arch(arch).smoke_spec_fn()
        if variant:
            gspec = with_attention(gspec, **VARIANTS[variant])
        tokens = torch.from_numpy(np.random.default_rng(7).integers(0, gspec.vocab, (4, 16)))
        plain = LM(gspec).init(torch.Generator().manual_seed(0))
        loss0, g0 = tstep.value_and_grad(tstep.make_loss_fn(plain), tstep.param_dict(plain),
                                         {"tokens": tokens})
        m = LM(gspec).init(torch.Generator().manual_seed(0))
        p = distribute_model(m, mesh, rules)
        with sharding_context(mesh, rules):
            loss1, g1 = tstep.value_and_grad(tstep.make_loss_fn(m), p,
                                             replicate_tree({"tokens": tokens}, mesh))
        info["grads"][name] = {"loss": [float(loss0), float(loss1.full_tensor())],
                               "placed": all(tuple(g1[k].placements) == tuple(p[k].placements)
                                             for k in p)}
        arrays.update({f"grads/{name}/plain/{k}": v.numpy() for k, v in g0.items()})
        arrays.update({f"grads/{name}/mesh/{k}": v for k, v in _full(g1).items()})

    # decode on the mesh: the caches (4 sequences of 8 positions) placed by
    # their logical axes, three steps against the unsharded decode
    from repro_torch.launch.dryrun import _distribute

    rng = np.random.default_rng(11)
    for arch in DECODE_ARCHS:
        dspec = get_arch(arch).smoke_spec_fn()
        plain = LM(dspec).init(torch.Generator().manual_seed(0))
        m = LM(dspec).init(torch.Generator().manual_seed(0))
        p = distribute_model(m, mesh, rules)
        enc = None
        if dspec.encoder_layers:
            enc = torch.from_numpy(rng.standard_normal((4, 6, dspec.d_model)).astype(np.float32))
        with torch.no_grad():
            c0 = plain.init_cache(4, 8, enc_out=enc)
            c1 = _distribute(plain.init_cache(4, 8, enc_out=enc), plain.cache_axes(), mesh, rules)
        step_fn = tstep.make_decode_step(m)
        for i in range(DECODE_STEPS):
            tok = torch.from_numpy(rng.integers(0, dspec.vocab, (4, 1)))
            with torch.no_grad():
                want, _ = plain.decode(c0, tok, i)
            with sharding_context(mesh, rules):
                got, _ = step_fn(p, c1, replicate_tree(tok, mesh), i)
            arrays[f"decode/{arch}/{i}/plain"] = want.numpy()
            arrays[f"decode/{arch}/{i}/mesh"] = got.full_tensor().numpy()

    # compress_decompress on sharded gradients: blocks over the global tensor
    from torch.distributed.tensor import Shard, distribute_tensor

    g = torch.from_numpy(batches["compress_g"])
    comp = GradientCompressor()
    dg = {"g": distribute_tensor(g, mesh, [Shard(0), Shard(1)], src_data_rank=None)}
    out, err = comp.compress_decompress(dg, comp.init_state(dg))
    info["compress"] = {"same": (tuple(out["g"].placements) == tuple(err["g"].placements)
                                 == tuple(dg["g"].placements))}
    arrays["compress_out"] = out["g"].full_tensor().numpy()
    arrays["compress_err"] = err["g"].full_tensor().numpy()

    # compressed_psum over the model dim (2 ranks) and over 4 ranks
    grads = {k: torch.from_numpy(v) for k, v in psum_inputs(rank).items()}
    for name, (m_, dim) in {"psum2": (mesh, "model"), "psum4": (mesh41, "data")}.items():
        summed = comp.compressed_psum(grads, dim, mesh=m_)
        np.savez(os.path.join(d, f"{name}_rank{rank}.npz"),
                 **{k: v.numpy() for k, v in summed.items()})

    # elastic re-meshing of the 4 ranks
    em = elastic_remesh((16, 16), ("data", "model"))
    info["elastic"] = {"shape": list(em.shape), "names": list(em.mesh_dim_names)}
    return arrays, info


# -- the JAX package on 4 spoofed devices ---------------------------------------------------

def jax_side(d):
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import get_arch
    from repro.distributed.compression import GradientCompressor
    from repro.distributed.sharding import default_rules, shapes_shardings_from_axes
    from repro.launch.mesh import make_mesh
    from repro.models.lm import LM
    from repro.nn.types import split
    from repro.train import optimizer as jopt
    from repro.train import step as jstep

    assert len(jax.devices()) == 4
    arrays, info = {}, {}
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = default_rules(mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    model = LM(spec)
    _, axes = split(jax.eval_shape(functools.partial(model.init, dtype=jnp.float32),
                                   jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    nested(dict(np.load(os.path.join(d, "init.npz")))))
    param_sh = shapes_shardings_from_axes(params, axes, mesh, rules)
    params = jax.device_put(params, param_sh)
    opt = jopt.Optimizer(jopt.OptimizerConfig(
        learning_rate=jopt.cosine_schedule(*LR_STEPS), **OPT))
    state = jax.device_put(opt.init(params), {"step": rep, "mu": param_sh, "nu": param_sh})
    fn = jax.jit(jstep.make_train_step(model, opt), donate_argnums=(0, 1))
    batches = np.load(os.path.join(d, "batches.npz"))
    losses = []
    with mesh:
        for i in range(STEPS):
            params, state, metrics = fn(params, state,
                                        {"tokens": jnp.asarray(batches[f"tokens_{i}"])})
            losses.append(float(metrics["loss"]))
    info["losses"] = losses
    shards = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(p.key) for p in path)
        arrays[f"params/{key}"] = np.asarray(leaf)
        arrays[f"mu/{key}"] = np.asarray(
            functools.reduce(lambda t, p: t[p.key], path, state["mu"]))
        shards[key] = list(leaf.sharding.shard_shape(leaf.shape))
    info["shards"] = shards

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    comp = GradientCompressor()
    for n in (2, 4):
        for group in range(4 // n):
            ranks = range(group * n, (group + 1) * n)
            m = make_mesh((n,), ("x",))
            ins = [psum_inputs(r) for r in ranks]
            stacked = {k: jnp.concatenate([jnp.asarray(x[k])[None] for x in ins])
                       for k in PSUM_SHAPES}
            f = shard_map(lambda g: jax.tree_util.tree_map(
                lambda t: t[None], comp.compressed_psum(
                    jax.tree_util.tree_map(lambda t: t[0], g), "x")),
                mesh=m, in_specs=PartitionSpec("x"), out_specs=PartitionSpec("x"))
            out = jax.jit(f)(stacked)
            for i, r in enumerate(ranks):
                for k in PSUM_SHAPES:
                    arrays[f"psum{n}/{r}/{k}"] = np.asarray(out[k][i])
    np.savez(os.path.join(d, "jax.npz"), **arrays)
    with open(os.path.join(d, "jax.json"), "w") as f:
        json.dump(info, f)


if __name__ == "__main__":
    if sys.argv[1] == "gloo":
        gloo(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        jax_side(sys.argv[2])
