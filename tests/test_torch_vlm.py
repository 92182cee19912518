"""The VLM slice: paligemma's smoke LM (MQA, tied and sqrt(d_model)-scaled
embeddings, a prefix of precomputed patch embeddings) against the JAX
package's on the same weights (carried across by ``lm_from_jax``) and the
same seeded numpy inputs: the forward with a prefix, prefill, every cache
leaf and three per-slot decode steps, through both impls (the CPU runs
the flash kernel's plain version); ``logit_softcap`` set on the smoke
spec; and each config's ``input_specs`` and ``cell_supported`` for every
shape cell."""
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

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.launch.serve import swap_spec_impl  # noqa: E402
from test_torch_lm_space import (  # noqa: E402
    check_smoke_forward_logits, check_specs_and_full_size_parameter_count)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "paligemma-3b"
REL = 1e-5  # fp32 against fp32, sums in another order: of the max |value|
SOFTCAP = 0.5  # below the smoke logits' max |logit| (~0.67), so tanh bends them


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _prefix(seed, b, npfx, d):
    return np.random.default_rng(seed).standard_normal((b, npfx, d)).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(impl="xla", **fields):
    """The JAX smoke LM (``impl="xla"``) and the port's with ``impl``, on
    the JAX package's weights; ``fields`` replace spec fields of both."""
    jspec = dataclasses.replace(jax_get_arch(ARCH).smoke_spec_fn(), **fields)
    tspec = swap_spec_impl(dataclasses.replace(get_arch(ARCH).smoke_spec_fn(), **fields), impl)
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    return jmodel, params, lm_from_jax(tspec, _numpy(params), device="cpu"), tspec


def _close_caches(tcache, jcache, tspec):
    ported = cache_from_jax(tspec, _numpy(jcache), device="cpu")
    assert len(ported) == len(tcache) == tspec.n_layers
    for got, want in zip(tcache, ported):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            assert got[name].keys() == leaves.keys()
            for leaf, value in leaves.items():
                assert _rel_err(got[name][leaf], value.numpy()) < REL, (name, leaf)


def test_specs_and_full_size_parameter_count_match_jax():
    check_specs_and_full_size_parameter_count(ARCH)


def test_smoke_forward_logits_match_jax():
    check_smoke_forward_logits(ARCH)


def test_smoke_spec_is_the_vlm_family():
    spec = get_arch(ARCH).smoke_spec_fn()
    assert spec.embed_scale and spec.tie_embeddings and spec.frontend == "vision_stub"
    attn = spec.layers[0].subs[0].cfg
    assert (attn.n_heads, attn.n_kv_heads, spec.num_prefix_tokens) == (4, 1, 8)
    assert not spec.is_subquadratic()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_with_prefix_matches_jax_apply(impl):
    jmodel, params, tmodel, tspec = _pair(impl)
    toks, pfx = _tokens(0, 2, 16), _prefix(1, 2, tspec.num_prefix_tokens, tspec.d_model)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(toks), prefix_embeds=jnp.asarray(pfx))
    got = tmodel(torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pfx))
    assert _rel_err(got, want) < REL
    # the prefix replaces the first rows: other tokens there change nothing
    toks2 = toks.copy()
    toks2[:, :tspec.num_prefix_tokens] = 0
    again = tmodel(torch.from_numpy(toks2), prefix_embeds=torch.from_numpy(pfx))
    assert torch.equal(again, got)


def test_embedding_is_scaled_before_the_prefix_is_written():
    """The port's ``_embed`` against the JAX ``LM._embed``: sqrt(d_model)
    times the table's rows, then the prefix, cast to the rows' dtype, over
    the first rows."""
    jmodel, params, tmodel, tspec = _pair()
    toks, pfx = _tokens(2, 2, 12), _prefix(3, 2, 8, tspec.d_model)
    want = jmodel._embed(params, jnp.asarray(toks), jnp.asarray(pfx))
    got = tmodel._embed(torch.from_numpy(toks), torch.from_numpy(pfx).double())
    assert got.dtype == torch.float32
    assert _rel_err(got, want) < 1e-7
    np.testing.assert_array_equal(got[:, :8].numpy(), pfx)
    scaled = tmodel.embed[torch.from_numpy(toks[:, 8:])] * tspec.d_model ** 0.5
    assert torch.equal(got[:, 8:], scaled)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match_jax(impl):
    """Prefill takes no prefix, in either package: the prompt is text."""
    jmodel, params, tmodel, tspec = _pair(impl)
    toks = _tokens(4, 2, 10)
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    assert _rel_err(tlogits, jlogits) < REL
    _close_caches(tcache, jcache, tspec)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_three_decode_steps_with_per_slot_positions_match_jax(impl):
    jmodel, params, tmodel, tspec = _pair(impl)
    toks = _tokens(5, 2, 8)
    _, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    _, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    decode = jax.jit(jmodel.decode)
    pos = np.array([8, 3])
    for step in range(3):
        nxt = _tokens(6 + step, 2, 1)
        jlogits, jcache = decode(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlogits, tcache = tmodel.decode(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert _rel_err(tlogits, jlogits) < REL
        _close_caches(tcache, jcache, tspec)
        pos = pos + 1


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_logit_softcap_matches_jax(impl):
    """``logit_softcap`` on the smoke spec: the forward with a prefix and a
    decode step, against the JAX package's; the cap bounds the logits."""
    jmodel, params, tmodel, tspec = _pair(impl, logit_softcap=SOFTCAP)
    toks, pfx = _tokens(9, 2, 12), _prefix(10, 2, 8, tspec.d_model)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(toks), prefix_embeds=jnp.asarray(pfx))
    got = tmodel(torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pfx))
    assert _rel_err(got, want) < REL
    assert got.abs().max() < SOFTCAP
    uncapped = _pair(impl)[2](torch.from_numpy(toks), prefix_embeds=torch.from_numpy(pfx))
    assert uncapped.abs().max() > SOFTCAP  # the cap bends these logits
    jlogits, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    _, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    nxt = _tokens(11, 2, 1)
    jlogits, _ = jax.jit(jmodel.decode)(params, jcache, jnp.asarray(nxt), 12)
    tlogits, _ = tmodel.decode(tcache, torch.from_numpy(nxt), 12)
    assert _rel_err(tlogits, jlogits) < REL


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax_for_every_cell(arch):
    """Every shape cell's inputs: the same names, shapes and logical axes
    as the JAX package's ``ShapeDtypeStruct``s, on ``meta``; bf16
    activations, and int64 token ids where the JAX package has int32.
    ``cell_supported`` agrees on every cell."""
    assert SHAPES.keys() == JAX_SHAPES.keys()
    dtypes = {jnp.dtype(jnp.int32): torch.long, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for name, cell in SHAPES.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(JAX_SHAPES[name])
        ok, why = get_arch(arch).cell_supported(cell)
        jok, _ = jax_get_arch(arch).cell_supported(JAX_SHAPES[name])
        assert ok == jok and bool(why) == (not ok), (arch, name)
        got, axes = input_specs(get_arch(arch), cell)
        want, jaxes = jax_input_specs(jax_get_arch(arch), JAX_SHAPES[name])
        assert axes == jaxes and got.keys() == want.keys(), (arch, name)
        for key, t in got.items():
            assert t.is_meta and tuple(t.shape) == want[key].shape, (arch, name, key)
            assert t.dtype == dtypes[jnp.dtype(want[key].dtype)], (arch, name, key)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["served"] == 4 and out["shed"] == 0 and out["arch"] == "paligemma-smoke"
