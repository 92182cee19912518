"""The training slice against the JAX package on the CPU, on the same numpy
inputs and converted parameters: the losses, the three optimizers (params
and state over 3 steps), clipping and the cosine schedule, the qwen3
smoke train step (loss and every gradient against ``jax.value_and_grad``,
then 3 AdamW steps), the chunked-loss path, ``model_forward``'s ``frames``
and ``patch_embeds`` branches and a recurrent model, microbatch
accumulation, the eval / prefill / decode steps, ``moe_apply``'s
auxiliaries and the optimizer-state converter."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import lm_from_jax, lm_tree_from_jax, opt_state_from_jax  # noqa: E402
from repro_torch.train import loss as tloss  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

# fp32 against fp32, the sums in another order: a loss relative to itself,
# a gradient or a logit of the max |value| of its tensor
REL = 1e-5
# the optimizers' parameters and state after 3 steps, absolute: elementwise
# fp32 rules on the same inputs
OPT_ATOL = 1e-6
# an LM's parameters after 3 AdamW train steps, of each tensor's max: the
# gradients agree to REL, and AdamW's first update g / (|g| + eps) turns an
# entry whose gradient is near 0 into about +-lr whatever its rounding, so
# the parameters keep a few times REL (1.7e-5 read on qwen3 smoke)
STEP_REL = 1e-4


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# a tensor whose max is below this share of the largest in its tree is
# held to that share instead: the key biases' gradients are zero
# analytically (softmax ignores a shift shared by all keys), so both
# packages give fp32 noise (~1e-9) there, and its own max says nothing
FLOOR = 1e-3


def _close_trees(got, want, rel=REL):
    """Two {name: tensor} mappings, each tensor to ``rel`` of its max (or
    of FLOOR times the tree's largest, if that is larger)."""
    assert got.keys() == want.keys()
    floor = FLOOR * max(float(v.abs().max()) for v in want.values())
    errs = {k: float((got[k].double() - want[k].double()).abs().max())
            / max(float(want[k].abs().max()), floor) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] < rel, (worst, errs[worst])


# -- losses ---------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    logits, labels = _rand(0, 2, 12, 40, scale=3.0), np.random.default_rng(1).integers(0, 40, (2, 12))
    mask = (np.random.default_rng(2).random((2, 12)) > 0.3).astype(np.float32) if masked else None
    want = jloss.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))
    got = tloss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              None if mask is None else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < REL * abs(float(want))


@pytest.mark.parametrize("transposed", [False, True])
def test_chunked_cross_entropy_matches_jax(transposed):
    b, s, d, v = 2, 32, 16, 64
    h, labels = _rand(3, b, s, d), np.random.default_rng(4).integers(0, v, (b, s))
    w = _rand(5, v, d, scale=0.1) if transposed else _rand(5, d, v, scale=0.1)
    mask = (np.random.default_rng(6).random((b, s)) > 0.2).astype(np.float32)
    want = jloss.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                       chunk=8, mask=jnp.asarray(mask), transposed=transposed)
    got = tloss.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                      torch.from_numpy(labels), chunk=8,
                                      mask=torch.from_numpy(mask), transposed=transposed)
    full = tloss.cross_entropy(torch.from_numpy(h) @ torch.from_numpy(w.T if transposed else w),
                               torch.from_numpy(labels), torch.from_numpy(mask))
    assert abs(float(got) - float(want)) < REL * abs(float(want))
    assert abs(float(got) - float(full)) < REL * abs(float(full))


def test_shift_labels_matches_jax():
    tokens = np.random.default_rng(7).integers(0, 100, (3, 10))
    jl, jm = jloss.shift_labels(jnp.asarray(tokens))
    tl, tm = tloss.shift_labels(torch.from_numpy(tokens))
    assert np.array_equal(tl.numpy(), np.asarray(jl)) and np.array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.float32


# -- optimizers -----------------------------------------------------------------

def _opt_tree():
    """Leaves of one, two and three dimensions (Adafactor factors the last
    two) and one with zero gradient entries."""
    return {"b": _rand(10, 6), "w": _rand(11, 5, 7), "stack": _rand(12, 3, 4, 6)}


def _grads(i):
    g = {k: _rand(20 + i, *v.shape, scale=0.5) for k, v in _opt_tree().items()}
    g["w"][0] = 0.0
    return g


def _configs(name):
    kw = dict(name=name, learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0)
    return (jopt.OptimizerConfig(**{**kw, "learning_rate": jopt.cosine_schedule(0.05, 1, 5)}),
            topt.OptimizerConfig(**{**kw, "learning_rate": topt.cosine_schedule(0.05, 1, 5)}))


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_three_steps_match_jax(name):
    jcfg, tcfg = _configs(name)
    jo, to = jopt.Optimizer(jcfg), topt.Optimizer(tcfg)
    jp = {k: jnp.asarray(v) for k, v in _opt_tree().items()}
    tp = {k: torch.from_numpy(v) for k, v in _opt_tree().items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = _grads(i)
        jp, js, jm = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts, tm = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-7
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-6
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=OPT_ATOL, rtol=0)
    assert int(ts["step"]) == int(js["step"]) == 3 and ts["step"].dtype == torch.int32
    flat_j = dict(_flat_paths({k: v for k, v in js.items() if k != "step"}))
    flat_t = dict(_flat_paths({k: v for k, v in ts.items() if k != "step"}))
    assert set(flat_j) == set(flat_t) and len(flat_t) == {"adafactor": 5}.get(name, 3) * (
        2 if name == "adamw" else 1)
    for path, want in flat_j.items():
        np.testing.assert_allclose(flat_t[path].numpy(), np.asarray(want), atol=OPT_ATOL, rtol=0)


def _flat_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizer_decreases_quadratic(name):
    opt = topt.Optimizer(topt.OptimizerConfig(name=name, learning_rate=0.1, weight_decay=0.0,
                                              grad_clip_norm=None))
    params = {"w": torch.tensor([3.0, -2.0]), "m": torch.ones((2, 2))}
    state = opt.init(params)

    def loss_fn(p):
        return (p["w"] ** 2).sum() + ((p["m"] - 0.5) ** 2).sum()

    loss0 = float(loss_fn(params))
    for _ in range(30):
        _, grads = tstep.value_and_grad(lambda p, _: loss_fn(p), params, None)
        params, state, _ = opt.update(grads, state, params)
    assert float(loss_fn(params)) < loss0 * 0.2, name


def test_clip_by_global_norm_and_cosine_schedule_match_jax():
    g = _grads(0)
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tc, tn = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    assert float(topt.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-7, rtol=0)
    jf, tf = jopt.cosine_schedule(1.0, 10, 100, 0.1), topt.cosine_schedule(1.0, 10, 100, 0.1)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 130):
        assert abs(float(tf(torch.tensor(step))) - float(jf(jnp.asarray(step)))) <= 1e-7


# -- the train step on the LMs ------------------------------------------------------

def _lm_pair(arch):
    jspec = jax_get_arch(arch).smoke_spec_fn()
    tspec = get_arch(arch).smoke_spec_fn()
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(tspec, _numpy(params), device="cpu")
    return jmodel, params, tmodel, tspec


def _lm_batch(spec, b=2, s=16, seed=0, labels=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, spec.vocab, (b, s)).astype(np.int32)}
    if labels:
        batch["labels"] = rng.integers(0, spec.vocab, (b, s)).astype(np.int32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})


def _check_loss_and_grads(jmodel, params, tmodel, tspec, batch, loss_chunk=0, rel=REL):
    jb, tb = _both(batch)
    jl, jg = jax.value_and_grad(jstep.make_loss_fn(jmodel, loss_chunk=loss_chunk))(params, jb)
    tl, tg = tstep.value_and_grad(tstep.make_loss_fn(tmodel, loss_chunk=loss_chunk),
                                  tstep.param_dict(tmodel), tb)
    assert abs(float(tl) - float(jl)) < REL * abs(float(jl))
    _close_trees(tg, lm_tree_from_jax(tspec, _numpy(jg), device="cpu"), rel)


def test_train_step_loss_and_every_gradient_match_jax_then_three_adamw_steps():
    """qwen3 smoke: the loss and each gradient tensor against
    ``jax.value_and_grad`` through the converted tree, to 1e-5 of the
    tensor's max; then 3 AdamW steps of each package's train step, the
    parameters and both moments held to the JAX package's."""
    jmodel, params, tmodel, tspec = _lm_pair("qwen3-1.7b")
    _check_loss_and_grads(jmodel, params, tmodel, tspec, _lm_batch(tspec))
    cfg = dict(name="adamw", weight_decay=0.1, grad_clip_norm=1.0)
    jo = jopt.Optimizer(jopt.OptimizerConfig(learning_rate=jopt.cosine_schedule(1e-3, 1, 3), **cfg))
    to = topt.Optimizer(topt.OptimizerConfig(learning_rate=topt.cosine_schedule(1e-3, 1, 3), **cfg))
    jfn = jax.jit(jstep.make_train_step(jmodel, jo))
    tfn = tstep.make_train_step(tmodel, to)
    jp, js = params, jo.init(params)
    tp = tstep.param_dict(tmodel)
    ts = to.init(tp)
    for i in range(3):
        jb, tb = _both(_lm_batch(tspec, seed=10 + i, labels=False))
        jp, js, jm = jfn(jp, js, jb)
        tp, ts, tm = tfn(tp, ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < REL * abs(float(jm["loss"]))
    _close_trees(tp, lm_tree_from_jax(tspec, _numpy(jp), device="cpu"), STEP_REL)
    state = opt_state_from_jax(tspec, _numpy(js), device="cpu")
    assert int(ts["step"]) == int(state["step"]) == 3
    _close_trees(ts["mu"], state["mu"], STEP_REL)
    _close_trees(ts["nu"], state["nu"], STEP_REL)
    # the step trained the module: its parameters are the mapping's storage;
    # they stay frozen, so evaluation builds no graph
    assert tmodel.embed.data_ptr() == tp["embed"].data_ptr()
    assert not any(p.requires_grad for p in tmodel.parameters())
    assert tmodel(tb["tokens"]).grad_fn is None


def test_chunked_loss_path_matches_jax():
    """``loss_chunk`` (the hidden states and the tied head's weight,
    chunk halved until it divides S) against the reference's."""
    jmodel, params, tmodel, tspec = _lm_pair("qwen3-1.7b")
    _check_loss_and_grads(jmodel, params, tmodel, tspec, _lm_batch(tspec, s=24), loss_chunk=16)


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b", "zamba2-2.7b"])
def test_model_forward_branches_match_jax(arch):
    """One step's loss and gradients through ``frames`` (whisper: encode,
    then the decoder against its output), ``patch_embeds`` (paligemma's
    prefix) and a recurrent model (zamba2: Mamba2 and the weight-shared
    attention layer, whose gradient sums over its runs)."""
    jmodel, params, tmodel, tspec = _lm_pair(arch)
    batch = _lm_batch(tspec, s=12, labels=False)
    if arch.startswith("whisper"):
        batch["frames"] = _rand(30, 2, 10, tspec.d_model)
    elif arch.startswith("paligemma"):
        batch["patch_embeds"] = _rand(31, 2, 4, tspec.d_model)
    # zamba2: the Mamba2 layers' gradients run back through the chunked
    # SSD sums (exponentials of cumulative sums, in another order):
    # 1.05e-5 of A_log's max read, so 5e-5 there
    _check_loss_and_grads(jmodel, params, tmodel, tspec, batch,
                          rel=5e-5 if arch.startswith("zamba2") else REL)


def test_microbatches_match_the_single_step_and_jax():
    """microbatches=4 sums fp32 gradients and divides by 4: the same
    update as one step on the whole batch (the reference's
    ``test_grad_accumulation_equivalence``), and the JAX package's
    accumulated step."""
    jmodel, params, tmodel, tspec = _lm_pair("qwen3-1.7b")
    cfg = dict(name="sgd", learning_rate=0.1, grad_clip_norm=None, weight_decay=0.0)
    jo, to = jopt.Optimizer(jopt.OptimizerConfig(**cfg)), topt.Optimizer(topt.OptimizerConfig(**cfg))
    jb, tb = _both(_lm_batch(tspec, b=8))
    jp4, _, jm4 = jax.jit(jstep.make_train_step(jmodel, jo, microbatches=4))(params, jo.init(params), jb)
    out = {}
    for mb in (1, 4):
        p = {k: v.clone() for k, v in tstep.param_dict(tmodel).items()}
        out[mb] = tstep.make_train_step(tmodel, to, microbatches=mb)(p, to.init(p), tb)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert max(float((p1[k] - p4[k]).abs().max()) for k in p1) < 1e-4
    assert abs(float(m4["loss"]) - float(jm4["loss"])) < REL * abs(float(jm4["loss"]))
    _close_trees(p4, lm_tree_from_jax(tspec, _numpy(jp4), device="cpu"))


def test_eval_prefill_and_decode_steps_match_jax():
    jmodel, params, tmodel, tspec = _lm_pair("qwen3-1.7b")
    jb, tb = _both(_lm_batch(tspec, s=10))
    tp = tstep.param_dict(tmodel)
    loss = tstep.make_eval_step(tmodel)(tp, tb)
    assert loss.grad_fn is None
    assert abs(float(loss) - float(jstep.make_eval_step(jmodel)(params, jb))) < REL * float(loss)
    for last_only in (False, True):
        got = tstep.make_prefill_step(tmodel, last_only)(tp, tb)
        want = jstep.make_prefill_step(jmodel, last_only)(params, jb)
        assert got.shape == want.shape and _rel_err(got, want) < REL
    jcache = jmodel.init_cache(params, 2, 16, dtype=jnp.float32)
    _, jcache = jmodel.prefill(params, jcache, jb["tokens"])
    tcache = tmodel.init_cache(2, 16)
    tmodel.prefill(tcache, tb["tokens"])
    nxt = np.array([[3], [7]], np.int32)
    want, _ = jstep.make_decode_step(jmodel)(params, jcache, jnp.asarray(nxt), 10)
    got, _ = tstep.make_decode_step(tmodel)(tp, tcache, torch.from_numpy(nxt).long(), 10)
    assert _rel_err(got, want) < REL


def test_moe_return_aux_matches_jax():
    from repro.nn import moe as jmoe
    from repro_torch.nn import moe as tmoe
    from test_torch_moe import _layer_pair

    case = dict(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=0.75)
    jcfg, tcfg, jp, tp = _layer_pair(3, case)
    x = _rand(4, 2, 24, 32)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x), return_aux=True)
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x), return_aux=True)
    assert _rel_err(ty, jy) < REL and taux.keys() == jaux.keys()
    assert float(taux["dropped_fraction"]) == float(jaux["dropped_fraction"]) > 0
    assert abs(float(taux["load_balance_loss"]) - float(jaux["load_balance_loss"])) < 1e-6
    assert torch.equal(tmoe.moe_apply(tp, tcfg, torch.from_numpy(x)), ty)


def test_adafactor_state_converts_where_the_layouts_factor_alike():
    """A tree of the LM's parameters' shape converts (step, mu, nu), and
    Adafactor's moments convert but for a stacked norm scale, which the
    JAX package factors across its layers axis: that one raises."""
    jmodel, params, _, tspec = _lm_pair("qwen3-1.7b")
    state = _numpy(jopt.Optimizer(jopt.OptimizerConfig(name="adamw")).init(params))
    got = opt_state_from_jax(tspec, state, device="cpu")
    assert set(got) == {"step", "mu", "nu"} and got["mu"].keys() == tstep.param_dict(
        lm_from_jax(tspec, _numpy(params), device="cpu")).keys()
    ada = _numpy(jopt.Optimizer(jopt.OptimizerConfig(name="adafactor")).init(params))
    with pytest.raises(ValueError):
        opt_state_from_jax(tspec, ada, device="cpu")
    unstacked = {k: v for k, v in ada["v"].items() if not k.startswith("seg_")}
    only = {"step": ada["step"], "v": unstacked}
    with pytest.raises(ValueError, match="do not factor"):  # the layers' moments are missing
        opt_state_from_jax(tspec, only, device="cpu")
