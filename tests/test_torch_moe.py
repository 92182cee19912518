"""Mixture of experts: the port's routing, slot assignment and MoE layer
against the JAX package's on the same numpy inputs and weights, with a
capacity that drops tokens, exact ties in the router and arctic's dense
residual branch; the dbrx and arctic smoke LMs' prefill and decode
against the JAX LM; and the layer in float64."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

REL = 1e-5  # fp32 against fp32, sums in another order: of the max |value|


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _tied_logits(seed, b, s, e):
    """Router logits drawn from a few levels, so that many tokens hold
    exact ties, some of them across the top-k boundary."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1.0, 0.0, 0.5, 2.0], np.float32), size=(b, s, e))


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_topk_matches_jax_with_exact_ties(top_k):
    logits = _tied_logits(0, 2, 32, 8)
    jids, jgates, jprobs = jmoe.route_topk(jnp.asarray(logits), top_k)
    tids, tgates, tprobs = tmoe.route_topk(torch.from_numpy(logits), top_k)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert _rel_err(tgates, jgates) < REL and _rel_err(tprobs, jprobs) < REL


@pytest.mark.parametrize("s, k, e, capacity, drops", [
    (16, 2, 4, 3, True), (32, 4, 8, 5, True), (8, 1, 4, 8, False)])
def test_slot_assignment_matches_jax(s, k, e, capacity, drops):
    """Skewed routing, so that the busiest experts drop choices (unless
    the capacity holds every token)."""
    rng = np.random.default_rng(s * k)
    ids = rng.choice(e, size=(3, s, k), p=np.linspace(1.0, 3.0, e) / np.linspace(1.0, 3.0, e).sum())
    jslot, jtoken = jmoe._slot_assignment(jnp.asarray(ids, jnp.int32), e, capacity)
    tslot, ttoken = tmoe._slot_assignment(torch.from_numpy(ids), e, capacity)
    assert np.array_equal(tslot.numpy(), np.asarray(jslot))
    assert np.array_equal(ttoken.numpy(), np.asarray(jtoken))
    assert (ttoken.numpy() < 0).any() == drops


def test_slot_assignment_compares_choices_with_experts_only():
    """The largest tensor it makes is (B, S*K, E), never (B, S*K, S*K)."""
    b, s, k, e = 1, 512, 4, 16
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, e, (b, s, k)))
    sizes, where = [], torch.where

    def recorded(*args, **kwargs):
        out = where(*args, **kwargs)
        sizes.append(out.numel())
        return out

    torch.where = recorded
    try:
        tmoe._slot_assignment(ids, e, 64)
    finally:
        torch.where = where
    assert sizes and max(sizes) == b * s * k * e


def _layer_pair(seed, cfg_kwargs, ties=False):
    jcfg = jmoe.MoEConfig(**cfg_kwargs)
    tcfg = tmoe.MoEConfig(**cfg_kwargs)
    values, _ = split(jmoe.moe_init(jcfg, jax.random.PRNGKey(seed)))
    values = jax.tree_util.tree_map(np.array, values)
    if ties:  # pairs of experts with the same router column: their probabilities tie
        values["w_router"][:, 1::2] = values["w_router"][:, 0::2]
    jp = jax.tree_util.tree_map(jnp.asarray, values)
    tp = jax.tree_util.tree_map(torch.from_numpy, values)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("case", [
    pytest.param(dict(d_model=32, d_ff=48, n_experts=4, top_k=2, capacity_factor=0.75),
                 id="drops"),
    pytest.param(dict(d_model=32, d_ff=48, n_experts=8, top_k=2, capacity_factor=1.0),
                 id="ties"),
    pytest.param(dict(d_model=32, d_ff=48, n_experts=8, top_k=2, capacity_factor=2.0,
                      dense_residual=True), id="dense-residual"),
    pytest.param(dict(d_model=32, d_ff=48, n_experts=4, top_k=1, capacity_factor=1.25,
                      gated=False, activation="gelu"), id="ungated"),
    pytest.param(dict(d_model=32, d_ff=48, n_experts=16, top_k=4, capacity_factor=1.25),
                 id="dbrx-routing"),
])
def test_moe_apply_matches_jax(request, case):
    ties = request.node.callspec.id == "ties"
    jcfg, tcfg, jp, tp = _layer_pair(3, case, ties=ties)
    x = _rand(4, 2, 24, 32)
    want = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    got = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and _rel_err(got, want) < REL
    if ties:  # exact ties in the router reached the top-k boundary
        ids, _, probs = tmoe.route_topk(torch.from_numpy(x) @ tp["w_router"], 2)
        assert (probs.gather(-1, ids[..., 1:]) == probs.gather(-1, ids[..., 1:] ^ 1)).all()


def test_moe_apply_in_float64_keeps_float64():
    """The router and the experts sum in float64 on float64 weights; the
    result is the fp32 layer's to fp32 rounding, and routes the same."""
    case = dict(d_model=32, d_ff=48, n_experts=8, top_k=2, capacity_factor=1.0,
                dense_residual=True)
    _, tcfg, _, tp = _layer_pair(5, case)
    x = torch.from_numpy(_rand(6, 2, 24, 32))
    y32 = tmoe.moe_apply(tp, tcfg, x)
    p64 = jax.tree_util.tree_map(lambda t: t.double(), tp)
    y64 = tmoe.moe_apply(p64, tcfg, x.double())
    assert y64.dtype == torch.float64 and _rel_err(y32, y64.numpy()) < 1e-5


# -- the MoE LMs -----------------------------------------------------------------

def _lm_pair(arch):
    jmodel = JaxLM(jax_get_arch(arch).smoke_spec_fn())
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tspec = get_arch(arch).smoke_spec_fn()
    return jmodel, params, lm_from_jax(tspec, jax.tree_util.tree_map(np.asarray, params),
                                       device="cpu"), tspec


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_lm_prefill_and_decode_match_jax(arch):
    jmodel, params, tmodel, tspec = _lm_pair(arch)
    toks = np.random.default_rng(1).integers(0, 512, (2, 8))
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    assert _rel_err(tlogits, jlogits) < REL
    nxt, pos = np.random.default_rng(2).integers(0, 512, (2, 1)), np.array([8, 5])
    jlogits, jcache = jax.jit(jmodel.decode)(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
    tlogits, tcache = tmodel.decode(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
    assert _rel_err(tlogits, jlogits) < REL
    ported = cache_from_jax(tspec, jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    for got, want in zip(tcache, ported, strict=True):
        assert got["sub_1"] == want["sub_1"] == {}
        for kv in ("k", "v"):
            assert _rel_err(got["sub_0"][kv], want["sub_0"][kv].numpy()) < REL


def test_arctic_dense_branch_is_carried_across():
    _, params, tmodel, _ = _lm_pair("arctic-480b")
    state = tmodel.state_dict()
    want = np.asarray(params["seg_0"]["sub_1"]["inner"]["dense"]["w_up"][1])
    assert np.array_equal(state["seg_0.1.subs.1.inner.dense.w_up"].numpy(), want)
    assert sum(t.numel() for t in state.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))


def test_moe_config_fields_match_jax():
    """The port's fields are the JAX config's but the unused
    ``router_jitter`` and ``dense_d_ff``, in the same order (the sharding
    switch ``shard_ff`` included)."""
    assert [f.name for f in dataclasses.fields(tmoe.MoEConfig)] == \
        [f.name for f in dataclasses.fields(jmoe.MoEConfig)
         if f.name not in ("router_jitter", "dense_d_ff")]
    for seq in (1, 7, 2048):
        cfg = dict(d_model=8, d_ff=8, n_experts=16, top_k=4)
        assert tmoe.MoEConfig(**cfg).capacity(seq) == jmoe.MoEConfig(**cfg).capacity(seq)
