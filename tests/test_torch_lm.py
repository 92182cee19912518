"""The served slice as a whole: the port's LM on the qwen3 smoke spec,
with the JAX package's weights carried across by ``lm_from_jax``, against
the JAX LM — forward logits, prefill logits and caches, per-slot decode —
and the port's own prefill against its own token loop."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.launch.serve import swap_spec_impl  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

ATOL = 1e-4  # prefill vs the token loop in tests/test_serving.py


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(impl="xla"):
    jspec = jax_get_arch("qwen3-1.7b").smoke_spec_fn()
    tspec = get_arch("qwen3-1.7b").smoke_spec_fn()
    if impl != "xla":
        # the port's helper is plain dataclass surgery and fits both specs
        # (importing the JAX dry-run module would spoof 512 host devices
        # for every process this one starts)
        jspec = swap_spec_impl(jspec, impl)
        tspec = swap_spec_impl(tspec, impl)
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(tspec, _numpy(params), device="cpu")
    return jmodel, params, tmodel, tspec


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def _close_caches(tcache, jcache, tspec):
    ported = cache_from_jax(tspec, _numpy(jcache), device="cpu")
    assert len(ported) == len(tcache) == tspec.n_layers
    for got, want in zip(tcache, ported):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            assert got[name].keys() == leaves.keys()
            for leaf, value in leaves.items():
                _close(got[name][leaf], value.numpy())


def test_forward_logits_match_jax_apply():
    jmodel, params, tmodel, _ = _pair()
    toks = _tokens(0, 2, 12)
    _close(tmodel(torch.from_numpy(toks)), jax.jit(jmodel.apply)(params, jnp.asarray(toks)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match_jax(impl):
    jmodel, params, tmodel, tspec = _pair(impl)
    toks = _tokens(1, 2, 8)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    _close(tlogits, jlogits)
    _close_caches(tcache, jcache, tspec)


def test_decode_with_per_slot_positions_matches_jax():
    jmodel, params, tmodel, tspec = _pair()
    toks = _tokens(2, 2, 8)
    _, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    _, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    nxt, pos = _tokens(3, 2, 1), np.array([8, 5])
    jlogits, jcache = jax.jit(jmodel.decode)(params, jcache, jnp.asarray(nxt),
                                             jnp.asarray(pos))
    tlogits, tcache = tmodel.decode(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
    _close(tlogits, jlogits)
    _close_caches(tcache, jcache, tspec)


def test_prefill_matches_own_token_loop():
    _, _, tmodel, _ = _pair("pallas")
    toks = torch.from_numpy(_tokens(4, 2, 8))
    loop_cache, loop_logits = tmodel.init_cache(2, 16), []
    for t in range(8):
        lg, loop_cache = tmodel.decode(loop_cache, toks[:, t:t + 1], t)
        loop_logits.append(lg)
    loop_logits = torch.cat(loop_logits, dim=1)
    logits, cache = tmodel.prefill(tmodel.init_cache(2, 16), toks)
    assert (logits - loop_logits).abs().max().item() < ATOL
    for a, b in zip(cache, loop_cache):
        for kv in ("k", "v"):
            assert (a["sub_0"][kv] - b["sub_0"][kv]).abs().max().item() < ATOL
    nxt = logits[:, -1:].argmax(-1)
    lg_a, _ = tmodel.decode(cache, nxt, 8)
    lg_b, _ = tmodel.decode(loop_cache, nxt, 8)
    assert (lg_a - lg_b).abs().max().item() < ATOL


def test_lm_from_jax_rejects_trees_that_do_not_fit():
    _, params, _, tspec = _pair()
    tree = _numpy(params)
    with pytest.raises(ValueError, match="missing"):
        lm_from_jax(tspec, {k: v for k, v in tree.items() if k != "final_norm"}, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        lm_from_jax(tspec, {**tree, "head": np.zeros((64, 512), np.float32)}, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["embed"] = np.zeros((511, 64), np.float32)
    with pytest.raises(ValueError, match="wrong shapes"):
        lm_from_jax(tspec, bad, device="cpu")


def test_own_init_is_seeded_and_complete():
    spec = get_arch("qwen3-1.7b").smoke_spec_fn()
    a = LM(spec).init(torch.Generator().manual_seed(3))
    b = LM(spec).init(torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(t.is_meta for t in sa.values())
    assert abs(a.embed.std().item() - 0.02) < 2e-3
