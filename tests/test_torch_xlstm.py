"""The xLSTM slice: the port's mLSTM and sLSTM functions against the JAX
package's on the same numpy inputs and converted parameters, then the
xlstm smoke LM as a whole (weights carried across by ``lm_from_jax``):
forward logits at both impls, prefill logits and every cache leaf,
per-slot decode, the port's own prefill against its token loop, weight
and cache transfer, and the serve CLI on the CPU."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.nn import xlstm as jx  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.launch.serve import swap_spec_impl  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.nn import xlstm as tx  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # prefill vs the token loop in tests/test_serving.py
ARCH = "xlstm-1.3b"


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _params(tree):
    """JAX P-tree -> (jax values, torch tensors) from the same numpy."""
    values, _ = split(tree)
    return values, {k: torch.from_numpy(np.array(v)) for k, v in values.items()}


def _gates(seed, b, l, h, f_bias=3.0):
    rng = np.random.default_rng(seed)
    il = (rng.standard_normal((b, l, h)) * 2.0).astype(np.float32)
    fl = (-np.logaddexp(0.0, -(rng.standard_normal((b, l, h)) + f_bias))).astype(np.float32)
    return il, fl


# -- the cells -------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 16])
def test_mlstm_chunked_matches_jax(chunk):
    """h and the final (C, n, m), to 1e-5 of each one's max: the same
    formulation (m from -inf, the panel cast to v's dtype), sums in
    another order."""
    b, l, h, p = 2, 32, 2, 16
    q, k, v = (_rand(s, b, l, h, p) for s in (1, 2, 3))
    il, fl = _gates(4, b, l, h)
    jh, jstate = jax.jit(jx.mlstm_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in (q, k, v, il, fl)), chunk)
    th, tstate = tx.mlstm_chunked(*(torch.from_numpy(a) for a in (q, k, v, il, fl)), chunk)
    assert _rel_err(th, jh) < 1e-5
    for got, want in zip(tstate, jstate):
        assert _rel_err(got, want) < 1e-5


def test_mlstm_step_and_recurrent_match_jax():
    b, h, p = 2, 2, 16
    c, n = _rand(1, b, h, p, p), _rand(2, b, h, p)
    m = _rand(3, b, h)
    q, k, v = (_rand(s, b, h, p) for s in (4, 5, 6))
    it, ft = _rand(7, b, h), -np.abs(_rand(8, b, h))
    jstate, jh = jx.mlstm_step(tuple(jnp.asarray(a) for a in (c, n, m)),
                               *(jnp.asarray(a) for a in (q, k, v, it, ft)))
    tstate, th = tx.mlstm_step(tuple(torch.from_numpy(a) for a in (c, n, m)),
                               *(torch.from_numpy(a) for a in (q, k, v, it, ft)))
    assert _rel_err(th, jh) < 1e-5
    for got, want in zip(tstate, jstate):
        assert _rel_err(got, want) < 1e-5
    qs, ks, vs = (_rand(s, b, 12, h, p) for s in (9, 10, 11))
    il, fl = _gates(12, b, 12, h)
    jh, _ = jax.jit(jx.mlstm_recurrent)(*(jnp.asarray(a) for a in (qs, ks, vs, il, fl)))
    th, _ = tx.mlstm_recurrent(*(torch.from_numpy(a) for a in (qs, ks, vs, il, fl)))
    assert _rel_err(th, jh) < 1e-5


def test_slstm_cell_step_matches_jax():
    b, hh, p = 2, 2, 8
    c, n, hs = _rand(1, b, hh, p), np.abs(_rand(2, b, hh, p)) + 0.5, _rand(3, b, hh, p)
    m = _rand(4, b, hh, p)
    xg, rw = _rand(5, b, 4 * hh * p), _rand(6, hh, p, 4 * p, scale=0.3)
    jstate = jx.slstm_cell_step(tuple(jnp.asarray(a) for a in (c, n, m, hs)),
                                jnp.asarray(xg), jnp.asarray(rw), hh, p)
    tstate = tx.slstm_cell_step(tuple(torch.from_numpy(a) for a in (c, n, m, hs)),
                                torch.from_numpy(xg), torch.from_numpy(rw), hh, p)
    for got, want in zip(tstate, jstate):
        _close(got, want, atol=3e-6)


def test_causal_conv1d_decode_form_matches_jax():
    x, w, bias, state = _rand(1, 2, 1, 12), _rand(2, 4, 12), _rand(3, 12), _rand(4, 2, 3, 12)
    jy, jstate = jssm.causal_conv1d(*(jnp.asarray(a) for a in (x, w, bias)),
                                    state=jnp.asarray(state))
    ty, tstate = tssm.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, bias)),
                                    state=torch.from_numpy(state))
    _close(ty, jy, atol=1e-6)
    _close(tstate, jstate, atol=0)


# -- the blocks ------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mlstm_block_apply_matches_jax(impl):
    """The full block (up-proj, conv, gates, cell, group norm, gate,
    down-proj) at L=16 with chunk 8; ``pallas`` runs the JAX Pallas kernel
    in interpret mode and the port's wrapper on the CPU (its plain
    version)."""
    jcfg = jx.MLSTMConfig(32, n_heads=2, chunk=8, impl=impl)
    tcfg = tx.MLSTMConfig(32, n_heads=2, chunk=8, impl=impl)
    jparams, tparams = _params(jx.mlstm_init(jcfg, jax.random.PRNGKey(0)))
    x = _rand(1, 2, 16, 32)
    want = jax.jit(jx.mlstm_block_apply, static_argnums=1)(jparams, jcfg, jnp.asarray(x))
    got = tx.mlstm_block_apply(tparams, tcfg, torch.from_numpy(x))
    _close(got, want, atol=3e-5)


def test_mlstm_block_decode_matches_jax():
    jcfg, tcfg = jx.MLSTMConfig(32, n_heads=2, chunk=8), tx.MLSTMConfig(32, n_heads=2, chunk=8)
    jparams, tparams = _params(jx.mlstm_init(jcfg, jax.random.PRNGKey(1)))
    jcache = jx.init_mlstm_cache(jcfg, 2)
    jcache = dict(jcache, conv=jnp.asarray(_rand(2, *jcache["conv"].shape)),
                  c=jnp.asarray(_rand(3, *jcache["c"].shape)))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    x = _rand(4, 2, 1, 32)
    jy, jnew = jx.mlstm_block_decode(jparams, jcfg, jnp.asarray(x), jcache)
    ty, tnew = tx.mlstm_block_decode(tparams, tcfg, torch.from_numpy(x), tcache)
    _close(ty, jy, atol=3e-5)
    assert tnew.keys() == jnew.keys()
    for key in jnew:
        _close(tnew[key], jnew[key], atol=3e-5)


def test_slstm_block_apply_matches_jax():
    """Full sequence (the loop over time) and one decode step with a cache."""
    jcfg, tcfg = jx.SLSTMConfig(32, n_heads=2), tx.SLSTMConfig(32, n_heads=2)
    assert tcfg.d_up == jcfg.d_up
    jparams, tparams = _params(jx.slstm_init(jcfg, jax.random.PRNGKey(2)))
    x = _rand(1, 2, 12, 32)
    want = jax.jit(jx.slstm_block_apply, static_argnums=1)(jparams, jcfg, jnp.asarray(x))
    _close(tx.slstm_block_apply(tparams, tcfg, torch.from_numpy(x)), want, atol=3e-5)

    jcache = jx.init_slstm_cache(jcfg, 2)
    jcache = dict(jcache, conv=jnp.asarray(_rand(3, *jcache["conv"].shape)),
                  h=jnp.asarray(_rand(4, *jcache["h"].shape)))
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    xd = _rand(5, 2, 1, 32)
    jy, jnew = jx.slstm_block_apply(jparams, jcfg, jnp.asarray(xd), cache=jcache)
    ty, tnew = tx.slstm_block_apply(tparams, tcfg, torch.from_numpy(xd), cache=tcache)
    _close(ty, jy, atol=3e-5)
    assert tnew.keys() == jnew.keys()
    for key in jnew:
        _close(tnew[key], jnew[key], atol=3e-5)


def test_caches_start_as_jax_caches_do():
    for jcache, tcache in (
            (jx.init_mlstm_cache(jx.MLSTMConfig(32, n_heads=2), 3),
             tx.init_mlstm_cache(tx.MLSTMConfig(32, n_heads=2), 3)),
            (jx.init_slstm_cache(jx.SLSTMConfig(32, n_heads=2), 3),
             tx.init_slstm_cache(tx.SLSTMConfig(32, n_heads=2), 3))):
        assert tcache.keys() == jcache.keys()
        for key in jcache:
            assert tuple(tcache[key].shape) == jcache[key].shape
            np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))


# -- the smoke LM ------------------------------------------------------------------

def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(impl="xla"):
    jspec = jax_get_arch(ARCH).smoke_spec_fn()
    tspec = get_arch(ARCH).smoke_spec_fn()
    jspec = swap_spec_impl(jspec, impl)
    tspec = swap_spec_impl(tspec, impl)
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(tspec, _numpy(params), device="cpu")
    return jmodel, params, tmodel, tspec


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _close_caches(tcache, jcache, tspec):
    ported = cache_from_jax(tspec, _numpy(jcache), device="cpu")
    assert len(ported) == len(tcache) == tspec.n_layers
    kinds = [sub.kind for layer in tspec.layers for sub in layer.subs]
    assert kinds == ["mlstm", "mlstm", "mlstm", "slstm"]
    for got, want in zip(tcache, ported):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            assert got[name].keys() == leaves.keys()
            for leaf, value in leaves.items():
                _close(got[name][leaf], value.numpy())


def test_smoke_spec_matches_jax_spec():
    jspec, tspec = jax_get_arch(ARCH).smoke_spec_fn(), get_arch(ARCH).smoke_spec_fn()
    assert (tspec.d_model, tspec.vocab, tspec.n_layers, tspec.norm, tspec.positional) == (
        jspec.d_model, jspec.vocab, jspec.n_layers, jspec.norm, jspec.positional)
    full_j, full_t = jax_get_arch(ARCH).spec(), get_arch(ARCH).spec()
    for jl, tl in zip(full_j.layers, full_t.layers, strict=True):
        (js,), (ts,) = jl.subs, tl.subs
        assert ts.kind == js.kind
        assert {f.name: getattr(ts.cfg, f.name) for f in dataclasses.fields(ts.cfg)} == {
            f.name: getattr(js.cfg, f.name) for f in dataclasses.fields(ts.cfg)}
    assert full_t.layers[0].subs[0].cfg.d_head == 1024
    assert sum(ts.kind == "mlstm" for layer in full_t.layers for ts in layer.subs) == 42


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_logits_match_jax_apply(impl):
    jmodel, params, tmodel, _ = _pair(impl)
    toks = _tokens(0, 2, 16)
    _close(tmodel(torch.from_numpy(toks)), jax.jit(jmodel.apply)(params, jnp.asarray(toks)))


def test_prefill_logits_and_cache_match_jax():
    jmodel, params, tmodel, tspec = _pair("pallas")
    toks = _tokens(1, 2, 8)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    _close(tlogits, jlogits)
    _close_caches(tcache, jcache, tspec)


def test_decode_with_per_slot_positions_matches_jax():
    jmodel, params, tmodel, tspec = _pair("pallas")
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
        for name in a:
            for leaf in a[name]:
                assert (a[name][leaf] - b[name][leaf]).abs().max().item() < ATOL
    nxt = logits[:, -1:].argmax(-1)
    lg_a, _ = tmodel.decode(cache, nxt, 8)
    lg_b, _ = tmodel.decode(loop_cache, nxt, 8)
    assert (lg_a - lg_b).abs().max().item() < ATOL


def test_prefill_logits_match_the_kernel_forward():
    """The decode-step loop of prefill against the full-sequence forward
    through the kernel's wrapper: the check ``chip_smoke.py`` makes at full
    width."""
    _, _, tmodel, _ = _pair("pallas")
    toks = torch.from_numpy(_tokens(5, 1, 16))
    logits, _ = tmodel.prefill(tmodel.init_cache(1, 17), toks)
    _close(logits, tmodel(toks).numpy())


def test_weight_and_cache_transfer_reject_trees_that_do_not_fit():
    jmodel, params, _, tspec = _pair()
    tree = _numpy(params)
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    del bad["seg_0"]["sub_0"]["inner"]["w_if"]
    with pytest.raises(ValueError, match="missing"):
        lm_from_jax(tspec, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["seg_0"]["sub_0"]["inner"]["wq"] = np.zeros((3, 2, 64, 32), np.float32)
    with pytest.raises(ValueError, match="wrong shapes"):
        lm_from_jax(tspec, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, tree)
    bad["seg_1"]["sub_0"]["inner"]["extra"] = np.zeros((1, 4), np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        lm_from_jax(tspec, bad, device="cpu")

    cache = _numpy(jmodel.init_cache(params, 2, 16, dtype=jnp.float32))
    ok = cache_from_jax(tspec, cache, device="cpu")
    assert ok[3]["sub_0"].keys() == {"conv", "c", "n", "m", "h"}
    assert tuple(ok[0]["sub_0"]["c"].shape) == (2, 2, 64, 64)
    bad = jax.tree_util.tree_map(lambda x: x, cache)
    del bad["seg_1"]["sub_0"]["h"]
    with pytest.raises(ValueError, match="cache keys"):
        cache_from_jax(tspec, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda x: x, cache)
    bad["seg_0"]["sub_0"]["c"] = bad["seg_0"]["sub_0"]["c"][:2]
    with pytest.raises(ValueError, match="layers axis"):
        cache_from_jax(tspec, bad, device="cpu")


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--requests", "4", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arch"] == "xlstm-smoke" and out["device"] == "cpu"
    assert out["served"] == 4 and out["shed"] == 0 and out["prefills"] == 4


def test_own_init_is_seeded_and_complete():
    """The port's own draw: the same seed gives the same weights, none is
    left on the meta device, and the gates start as the JAX package's do
    (input-gate biases 0, forget-gate biases 3, sLSTM gate biases 0)."""
    spec = get_arch(ARCH).smoke_spec_fn()
    a = LM(spec).init(torch.Generator().manual_seed(3))
    b = LM(spec).init(torch.Generator().manual_seed(3))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(t.is_meta for t in sa.values())
    b_if = sa["seg_0.0.subs.0.inner.b_if"]
    assert torch.equal(b_if, torch.tensor([0.0, 0.0, 3.0, 3.0]))
    assert torch.equal(sa["seg_1.0.subs.0.inner.b_gates"], torch.zeros(4 * 64))
