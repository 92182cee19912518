"""The encoder-decoder slice: whisper's smoke LM (a non-causal encoder
over frame embeddings, decoder layers with cross-attention, learned
positions shared by both, layernorm, biases) against the JAX package's
on the same weights (carried across by ``lm_from_jax``) and the same
seeded numpy inputs, through both impls (the CPU runs the flash kernel's
plain version): ``encode``, the forward with and without an encoder
output, ``init_cache(enc_out=)`` with its cross K/V, prefill and every
cache leaf, three per-slot decode steps, and the empty cross cache the
serving engine builds.  Then the ``xla_chunked`` attention against the
JAX package's at T that force its chunk-halving rule, and cross-attention
that never reaches the flash kernel."""
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve import swap_spec_impl  # noqa: E402
from test_torch_lm_space import (  # noqa: E402
    check_smoke_forward_logits, check_specs_and_full_size_parameter_count)
from repro_torch.nn import attention as tattn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "whisper-medium"
REL = 1e-5  # fp32 against fp32, sums in another order: of the max |value|
ENC_LEN = 20  # encoder frames: not a multiple of any tile


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _rel_err(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(impl="xla"):
    """The JAX smoke LM (``impl="xla"``) and the port's with ``impl`` on
    its encoder and decoder self-attention, on the JAX package's weights."""
    jmodel = JaxLM(jax_get_arch(ARCH).smoke_spec_fn())
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tspec = swap_spec_impl(get_arch(ARCH).smoke_spec_fn(), impl)
    return jmodel, params, lm_from_jax(tspec, _numpy(params), device="cpu"), tspec


def _encoded(jmodel, params, tmodel, seed=0, b=2):
    """The same frames through both encoders: (JAX enc_out, port enc_out)."""
    frames = _rand(seed, b, ENC_LEN, tmodel.spec.d_model)
    return (jax.jit(jmodel.encode)(params, jnp.asarray(frames)),
            tmodel.encode(torch.from_numpy(frames)))


def _close_caches(tcache, jcache, tspec):
    ported = cache_from_jax(tspec, _numpy(jcache), device="cpu")
    assert len(ported) == len(tcache) == tspec.n_layers
    for got, want in zip(tcache, ported):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            assert got[name].keys() == leaves.keys()
            for leaf, value in leaves.items():
                assert got[name][leaf].shape == value.shape, (name, leaf)
                if value.numel():
                    assert _rel_err(got[name][leaf], value.numpy()) < REL, (name, leaf)


def test_specs_and_full_size_parameter_count_match_jax():
    check_specs_and_full_size_parameter_count(ARCH)


def test_smoke_forward_logits_match_jax():
    check_smoke_forward_logits(ARCH)


def test_smoke_spec_is_the_encdec_family():
    spec = get_arch(ARCH).smoke_spec_fn()
    assert spec.positional == "learned" and spec.norm == "layernorm"
    assert [s.kind for s in spec.layers[0].subs] == ["attention", "cross_attention", "mlp"]
    assert [s.kind for s in spec.encoder_layers[0].subs] == ["attention", "mlp"]
    assert not spec.encoder_layers[0].subs[0].cfg.causal
    assert not spec.is_subquadratic()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encode_matches_jax(impl):
    jmodel, params, tmodel, _ = _pair(impl)
    jenc, tenc = _encoded(jmodel, params, tmodel)
    assert tenc.shape == (2, ENC_LEN, 64)
    assert _rel_err(tenc, jenc) < REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_with_encoder_output_matches_jax_apply(impl):
    jmodel, params, tmodel, _ = _pair(impl)
    jenc, tenc = _encoded(jmodel, params, tmodel)
    toks = _tokens(1, 2, 16)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(toks), enc_out=jenc)
    assert _rel_err(tmodel(torch.from_numpy(toks), enc_out=tenc), want) < REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_without_encoder_output_matches_jax_apply(impl):
    """Without an encoder output a cross-attention sub-block attends to
    its own input, non-causally, in both packages."""
    jmodel, params, tmodel, _ = _pair(impl)
    toks = _tokens(2, 2, 16)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(toks))
    got = tmodel(torch.from_numpy(toks))
    assert _rel_err(got, want) < REL
    _, tenc = _encoded(jmodel, params, tmodel)
    assert not torch.allclose(got, tmodel(torch.from_numpy(toks), enc_out=tenc))


def test_init_cache_projects_the_encoder_output_once():
    """The cross K/V leaves of ``init_cache(enc_out=)`` against the JAX
    package's and against ``precompute_cross_kv`` of each decoder layer."""
    jmodel, params, tmodel, tspec = _pair()
    jenc, tenc = _encoded(jmodel, params, tmodel)
    jcache = jmodel.init_cache(params, 2, 16, enc_out=jenc, dtype=jnp.float32)
    tcache = tmodel.init_cache(2, 16, enc_out=tenc)
    _close_caches(tcache, jcache, tspec)
    for layer, cache in zip(tmodel.layers(), tcache):
        blk = layer.subs[1]
        want = tattn.precompute_cross_kv(blk.inner, blk.sub.cfg, tenc)
        for leaf in ("k", "v"):
            assert cache["sub_1"][leaf].shape == (2, ENC_LEN, 4, 16)
            assert torch.equal(cache["sub_1"][leaf], want[leaf])
        jwant = jattn.precompute_cross_kv(
            {k: jnp.asarray(v.numpy()) for k, v in blk.inner.items()}, blk.sub.cfg,
            jnp.asarray(tenc.numpy()), dtype=jnp.float32)
        assert _rel_err(cache["sub_1"]["k"], jwant["k"]) < REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match_jax(impl):
    jmodel, params, tmodel, tspec = _pair(impl)
    jenc, tenc = _encoded(jmodel, params, tmodel)
    toks = _tokens(3, 2, 10)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, enc_out=jenc, dtype=jnp.float32),
        jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16, enc_out=tenc),
                                     torch.from_numpy(toks))
    assert _rel_err(tlogits, jlogits) < REL
    _close_caches(tcache, jcache, tspec)
    # a prefill from offset 0 gives the forward's logits (the learned
    # positions and the cross K/V the same in both)
    assert _rel_err(tlogits, tmodel(torch.from_numpy(toks), enc_out=tenc).numpy()) < REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("with_encoder", [True, False], ids=["enc_out", "empty_cross"])
def test_three_decode_steps_with_per_slot_positions_match_jax(impl, with_encoder):
    """From a prefill at a nonzero offset, per-slot decode steps: the
    learned positions taken per slot, the cross K/V unchanged.  Without an
    encoder output (as the serving engine runs) the cross cache is empty
    and its sub-block adds zeros."""
    jmodel, params, tmodel, tspec = _pair(impl)
    jenc, tenc = _encoded(jmodel, params, tmodel) if with_encoder else (None, None)
    toks = _tokens(4, 2, 6)
    jcache = jmodel.init_cache(params, 2, 16, enc_out=jenc, dtype=jnp.float32)
    tcache = tmodel.init_cache(2, 16, enc_out=tenc)
    _, jcache = jax.jit(jmodel.prefill, static_argnums=3)(params, jcache, jnp.asarray(toks), 2)
    _, tcache = tmodel.prefill(tcache, torch.from_numpy(toks), pos_offset=2)
    _close_caches(tcache, jcache, tspec)
    cross = [c["sub_1"]["k"].clone() for c in tcache]
    assert all(k.shape[1] == (ENC_LEN if with_encoder else 0) for k in cross)
    decode = jax.jit(jmodel.decode)
    pos = np.array([8, 5])
    for step in range(3):
        nxt = _tokens(5 + step, 2, 1)
        jlogits, jcache = decode(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlogits, tcache = tmodel.decode(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert _rel_err(tlogits, jlogits) < REL
        _close_caches(tcache, jcache, tspec)
        pos = pos + 1
    assert all(torch.equal(c["sub_1"]["k"], k) for c, k in zip(tcache, cross))


def test_cross_attention_never_reaches_the_kernel():
    """With ``impl="pallas"`` on every sub-block, cross-attention included,
    the encoder's and the decoder's self-attention call the flash wrapper
    once a layer (non-causal over the frames, causal over the tokens) and
    cross-attention never, in the forward, the prefill and a decode step."""
    _, params, _, tspec = _pair("pallas")
    spec = dataclasses.replace(tspec, layers=tuple(
        dataclasses.replace(layer, subs=tuple(
            dataclasses.replace(s, cfg=dataclasses.replace(s.cfg, impl="pallas"))
            if s.kind == "cross_attention" else s for s in layer.subs))
        for layer in tspec.layers))
    model = lm_from_jax(spec, _numpy(params), device="cpu")
    calls, flash = [], ops.flash_attention

    def recorded(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)

    toks = torch.from_numpy(_tokens(6, 1, 8))
    with mock.patch.object(ops, "flash_attention", recorded):
        enc = model.encode(torch.from_numpy(_rand(7, 1, ENC_LEN, 64)))
        assert calls == [(ENC_LEN, ENC_LEN, False)] * 2
        model(toks, enc_out=enc)
        assert calls[2:] == [(8, 8, True)] * 2
        cache = model.init_cache(1, 12, enc_out=enc)
        model.prefill(cache, toks)
        model.decode(cache, toks[:, :1], 8)
        assert calls[4:] == [(8, 8, True)] * 2


# -- xla_chunked ---------------------------------------------------------------------

@pytest.mark.parametrize("t, kv_chunk, causal, window", [
    (24, 16, True, None),    # 16 -> 8
    (20, 1024, False, None),  # 20 (min with T) divides
    (36, 32, True, 7),       # 32 -> 16 -> 8 -> 4, a window across chunks
])
def test_chunked_attention_matches_jax(t, kv_chunk, causal, window):
    """The online softmax over KV chunks, at the chunk the halving rule
    picks, against the JAX package's ``chunked_attention``, and against the
    grouped math."""
    cfg = tattn.AttentionConfig(32, 4, 2, d_head=8, kv_chunk=kv_chunk)
    chunk = tattn._kv_chunk(cfg, t)
    assert t % chunk == 0 and chunk <= min(kv_chunk, t)
    q, k, v = _rand(10, 2, t, 4, 8), _rand(11, 2, t, 2, 8), _rand(12, 2, t, 2, 8)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                                   causal=causal, window=window, kv_chunk=chunk)
    got = tattn.chunked_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.3,
                                  causal=causal, window=window, kv_chunk=chunk)
    assert _rel_err(got, want) < REL
    mask = tattn.make_mask(t, t, causal, window)
    plain = tattn.grouped_attention(*(torch.from_numpy(x) for x in (q, k, v)), mask, 0.3)
    assert _rel_err(got, plain.numpy()) < REL


@pytest.mark.parametrize("s", [12, 20])
def test_xla_chunked_apply_and_prefill_match_jax(s):
    """``impl="xla_chunked"`` in ``attention_apply`` and
    ``attention_prefill`` (kv_chunk 8: 8 divides 16, halves to 4 at 12
    and 20) against the JAX package's, output and cache."""
    jcfg = jattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True, impl="xla_chunked",
                                 kv_chunk=8)
    tcfg = tattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True, impl="xla_chunked",
                                 kv_chunk=8)
    jp, _ = split(jattn.attention_init(jcfg, jax.random.PRNGKey(s)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _rand(13, 2, s, 32)
    want = jattn.attention_apply(jp, jcfg, jnp.asarray(x))
    assert _rel_err(tattn.attention_apply(tp, tcfg, torch.from_numpy(x)), want) < REL
    jcache = jattn.init_kv_cache(jcfg, 2, 24, jnp.float32)
    jy, jcache = jattn.attention_prefill(jp, jcfg, jnp.asarray(x), jcache)
    ty, tcache = tattn.attention_prefill(tp, tcfg, torch.from_numpy(x),
                                         tattn.init_kv_cache(tcfg, 2, 24))
    assert _rel_err(ty, jy) < REL
    for leaf in ("k", "v"):
        assert _rel_err(tcache[leaf], jcache[leaf]) < REL


def test_cross_attention_cached_applies_q_norm_and_no_rope():
    """At a config with qk-norm and RoPE: the cached path norms q, rotates
    nothing, and matches the JAX package's; a cross ``attention_apply``
    over the same K/V rotates both sides, so it differs."""
    jcfg = jattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True, rope=True)
    tcfg = tattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True, rope=True)
    jp, _ = split(jattn.attention_init(jcfg, jax.random.PRNGKey(3)))
    jp = dict(jp, q_norm=jnp.asarray(1.0 + 0.5 * _rand(14, 8)))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x, enc = _rand(15, 2, 6, 32), _rand(16, 2, 9, 32)
    jcache = jattn.precompute_cross_kv(jp, jcfg, jnp.asarray(enc), dtype=jnp.float32)
    tcache = tattn.precompute_cross_kv(tp, tcfg, torch.from_numpy(enc))
    want = jattn.cross_attention_cached(jp, jcfg, jnp.asarray(x), jcache)
    got = tattn.cross_attention_cached(tp, tcfg, torch.from_numpy(x), tcache)
    assert _rel_err(got, want) < REL
    full = tattn.attention_apply(tp, tcfg, torch.from_numpy(x), kv_x=torch.from_numpy(enc))
    jfull = jattn.attention_apply(jp, jcfg, jnp.asarray(x), kv_x=jnp.asarray(enc))
    assert _rel_err(full, jfull) < REL and _rel_err(full, got.numpy()) > 1e-3


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["served"] == 4 and out["shed"] == 0 and out["arch"] == "whisper-smoke"
