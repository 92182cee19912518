"""The hybrid slice: zamba2's Mamba2 layers and weight-shared attention
block.  The port's Mamba2 decode step against the JAX package's on the
same numpy inputs, then the zamba2 smoke LM as a whole (weights carried
across by ``lm_from_jax``): forward logits at both impls, prefill logits
and every cache leaf (``shared_<i>`` included), per-slot decode, the
parameter count with the shared layer counted once, and the refusal of
trees that do not fit.  Last, the plain path in float64 (Mamba2 and
attention against a float64 numpy computation) and in fp32 and bf16
(their dtypes kept)."""
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
from repro.nn.types import split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_jax, lm_from_jax  # noqa: E402
from repro_torch.launch.serve import swap_spec_impl  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-2.7b"
REL = 1e-5  # fp32 against fp32, sums in another order: of the max |value|
REL64 = 1e-12  # float64 against float64


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _rel_err(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(impl="xla"):
    """The JAX smoke LM (``impl="xla"``) and the port's with ``impl``, on
    the JAX package's weights."""
    jspec = jax_get_arch(ARCH).smoke_spec_fn()
    tspec = get_arch(ARCH).smoke_spec_fn()
    tspec = swap_spec_impl(tspec, impl)
    jmodel = JaxLM(jspec)
    params, _ = split(jmodel.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    tmodel = lm_from_jax(tspec, _numpy(params), device="cpu")
    return jmodel, params, tmodel, tspec


def _close_caches(tcache, jcache, tspec):
    ported = cache_from_jax(tspec, _numpy(jcache), device="cpu")
    assert len(ported) == len(tcache) == tspec.n_layers
    for got, want in zip(tcache, ported):
        assert got.keys() == want.keys()
        for name, leaves in want.items():
            assert got[name].keys() == leaves.keys()
            for leaf, value in leaves.items():
                assert _rel_err(got[name][leaf], value.numpy()) < REL, (name, leaf)


def _mamba_params(cfg, seed):
    """The JAX Mamba2 init on ``seed`` with its zero biases and unit norm
    drawn at random too, as (jax values, numpy)."""
    values, _ = split(jssm.mamba2_init(cfg, jax.random.PRNGKey(seed)))
    out = {k: np.array(v) for k, v in values.items()}
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias", "D", "norm_scale"):
        out[k] = (out[k] + 0.3 * rng.standard_normal(out[k].shape)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in out.items()}, out


# -- the Mamba2 decode step ------------------------------------------------------

def test_ssd_recurrent_step_matches_jax():
    b, h, g, n, p = 2, 4, 2, 8, 16
    state, x = _rand(1, b, h, n, p), _rand(2, b, h, p)
    dt = np.abs(_rand(3, b, h)) + 0.1
    a = -np.exp(_rand(4, h))
    bm, cm = _rand(5, b, g, n), _rand(6, b, g, n)
    jy, jstate = jssm.ssd_recurrent_step(*(jnp.asarray(v) for v in (state, x, dt, a, bm, cm)))
    ty, tstate = tssm.ssd_recurrent_step(*(torch.from_numpy(v) for v in (state, x, dt, a, bm, cm)))
    assert ty.dtype == torch.float32 and tstate.dtype == torch.float32
    assert _rel_err(ty, jy) < REL and _rel_err(tstate, jstate) < REL


def test_mamba2_decode_matches_jax():
    """Three steps from a cache with a nonzero conv window and state: the
    output and both cache leaves at each step."""
    cfg = jssm.Mamba2Config(32, d_state=8, d_head=8, n_groups=2, chunk=4)
    tcfg = tssm.Mamba2Config(32, d_state=8, d_head=8, n_groups=2, chunk=4)
    jp, npp = _mamba_params(cfg, 0)
    tp = {k: torch.from_numpy(v) for k, v in npp.items()}
    conv_dim = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    jcache = {"conv": jnp.asarray(_rand(1, 2, cfg.conv_width - 1, conv_dim)),
              "state": jnp.asarray(_rand(2, 2, cfg.n_heads, cfg.d_state, cfg.d_head, scale=0.1))}
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    for step in range(3):
        x = _rand(10 + step, 2, 1, 32)
        jy, jcache = jssm.mamba2_decode(jp, cfg, jnp.asarray(x), jcache)
        ty, tcache = tssm.mamba2_decode(tp, tcfg, torch.from_numpy(x), tcache)
        assert _rel_err(ty, jy) < REL
        for leaf in ("conv", "state"):
            assert tcache[leaf].dtype == torch.float32
            assert _rel_err(tcache[leaf], jcache[leaf]) < REL


def test_decode_steps_reproduce_the_full_sequence_forward():
    """mamba2_decode looped from a fresh cache gives mamba2_apply's output
    through the chunked scan and through the kernel's wrapper (its plain
    version on the CPU)."""
    tcfg = tssm.Mamba2Config(32, d_state=8, d_head=8, chunk=4)
    _, npp = _mamba_params(jssm.Mamba2Config(32, d_state=8, d_head=8, chunk=4), 3)
    tp = {k: torch.from_numpy(v) for k, v in npp.items()}
    x = torch.from_numpy(_rand(4, 2, 12, 32))
    cache = tssm.init_ssm_cache(tcfg, 2)
    steps = []
    for t in range(12):
        y, cache = tssm.mamba2_decode(tp, tcfg, x[:, t:t + 1], cache)
        steps.append(y)
    steps = torch.cat(steps, dim=1)
    for impl in ("xla", "pallas"):
        full = tssm.mamba2_apply(tp, dataclasses.replace(tcfg, impl=impl), x)
        assert _rel_err(steps, full.numpy()) < REL


# -- the zamba2 smoke LM -----------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_logits_match_jax_apply(impl):
    jmodel, params, tmodel, _ = _pair(impl)
    toks = _tokens(0, 2, 16)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(toks))
    assert _rel_err(tmodel(torch.from_numpy(toks)), want) < REL


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_logits_and_cache_match_jax(impl):
    """Every cache leaf, the shared layer's runs (``shared_<i>``) too."""
    jmodel, params, tmodel, tspec = _pair(impl)
    toks = _tokens(1, 2, 8)
    jcache0 = jmodel.init_cache(params, 2, 16, dtype=jnp.float32)
    assert sorted(k for k in jcache0 if k.startswith("shared_")) == ["shared_0", "shared_1"]
    jlogits, jcache = jax.jit(jmodel.prefill)(params, jcache0, jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    assert _rel_err(tlogits, jlogits) < REL
    _close_caches(tcache, jcache, tspec)


def test_three_decode_steps_with_per_slot_positions_match_jax():
    jmodel, params, tmodel, tspec = _pair("pallas")
    toks = _tokens(2, 2, 8)
    _, jcache = jax.jit(jmodel.prefill)(
        params, jmodel.init_cache(params, 2, 16, dtype=jnp.float32), jnp.asarray(toks))
    _, tcache = tmodel.prefill(tmodel.init_cache(2, 16), torch.from_numpy(toks))
    decode = jax.jit(jmodel.decode)
    pos = np.array([8, 5])
    for step in range(3):
        nxt = _tokens(3 + step, 2, 1)
        jlogits, jcache = decode(params, jcache, jnp.asarray(nxt), jnp.asarray(pos))
        tlogits, tcache = tmodel.decode(tcache, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert _rel_err(tlogits, jlogits) < REL
        _close_caches(tcache, jcache, tspec)
        pos = pos + 1


def test_each_run_of_the_shared_layer_has_its_own_cache():
    _, _, tmodel, tspec = _pair()
    runs = [i for i, layer in enumerate(tspec.layers) if layer.shared]
    assert len(runs) == 2 and tmodel.layers()[runs[0]] is tmodel.layers()[runs[1]]
    _, cache = tmodel.prefill(tmodel.init_cache(1, 8), torch.from_numpy(_tokens(4, 1, 6)))
    a, b = (cache[i]["sub_0"]["k"] for i in runs)
    assert a.data_ptr() != b.data_ptr() and not torch.equal(a, b)


def test_parameter_count_counts_the_shared_layer_once():
    """The state dict holds the shared layer once, and its count equals the
    JAX tree's, for the smoke spec's weights and the full spec on ``meta``
    (against ``jax.eval_shape`` of the JAX init)."""
    _, params, tmodel, _ = _pair()
    state = tmodel.state_dict()
    assert sum(k.startswith("shared.") for k in state) == len(
        jax.tree_util.tree_leaves(params["shared"]))
    assert len(state) == len(list(tmodel.parameters()))
    assert sum(t.numel() for t in state.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    full = LM(get_arch(ARCH).spec())
    shapes = jax.eval_shape(lambda: split(JaxLM(jax_get_arch(ARCH).spec()).init(
        jax.random.PRNGKey(0), dtype=jnp.float32))[0])
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(t.numel() for t in full.state_dict().values()) == want
    assert 2.3e9 < want < 2.5e9


def test_weight_and_cache_transfer_refuse_trees_that_do_not_fit():
    jmodel, params, _, tspec = _pair()
    tree = _numpy(params)
    with pytest.raises(ValueError, match="missing"):
        lm_from_jax(tspec, {k: v for k, v in tree.items() if k != "shared"}, device="cpu")
    extra = dict(tree, shared={**tree["shared"], "sub_2": tree["shared"]["sub_0"]})
    with pytest.raises(ValueError, match="unexpected"):
        lm_from_jax(tspec, extra, device="cpu")
    stacked = dict(tree, shared=jax.tree_util.tree_map(lambda x: np.stack([x, x]),
                                                       tree["shared"]))
    with pytest.raises(ValueError, match="wrong shapes"):
        lm_from_jax(tspec, stacked, device="cpu")
    # a spec with no shared layer refuses a tree that has one
    plain = dataclasses.replace(tspec, layers=tuple(
        dataclasses.replace(layer, shared=False) for layer in tspec.layers))
    with pytest.raises(ValueError, match="unexpected"):
        lm_from_jax(plain, tree, device="cpu")

    cache = _numpy(jmodel.init_cache(params, 1, 8, dtype=jnp.float32))
    with pytest.raises(ValueError, match="do not match"):
        cache_from_jax(tspec, {k: v for k, v in cache.items() if k != "shared_1"}, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        cache_from_jax(tspec, dict(cache, shared_2=cache["shared_0"]), device="cpu")
    bad = dict(cache, shared_0={"sub_0": {"k": cache["shared_0"]["sub_0"]["k"]},
                                "sub_1": {}})
    with pytest.raises(ValueError, match="cache keys"):
        cache_from_jax(tspec, bad, device="cpu")


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--requests", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["served"] == 4 and out["shed"] == 0 and out["arch"] == "zamba2-smoke"


# -- the plain path in float64, fp32 and bf16 --------------------------------------

def _silu(x):
    return x / (1.0 + np.exp(-x))


def _mamba2_numpy(p, cfg, x):
    """Mamba2 in float64 numpy, one step of the recurrence at a time."""
    b, l, _ = x.shape
    d_in, gn, h = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.n_heads
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * gn], \
        zxbcdt[..., 2 * d_in + 2 * gn:]
    w = p["conv_w"]
    xp = np.concatenate([np.zeros((b, w.shape[0] - 1, xbc.shape[-1])), xbc], axis=1)
    conv = sum(xp[:, i:i + l] * w[i] for i in range(w.shape[0])) + p["conv_b"]
    xbc = _silu(conv)
    xs = xbc[..., :d_in].reshape(b, l, h, cfg.d_head)
    bm = np.repeat(xbc[..., d_in:d_in + gn].reshape(b, l, cfg.n_groups, -1), h // cfg.n_groups, 2)
    cm = np.repeat(xbc[..., d_in + gn:].reshape(b, l, cfg.n_groups, -1), h // cfg.n_groups, 2)
    dt = np.log1p(np.exp(dt_raw + p["dt_bias"]))
    a = -np.exp(p["A_log"])
    state = np.zeros((b, h, cfg.d_state, cfg.d_head))
    ys = []
    for t in range(l):
        state = (np.exp(dt[:, t] * a)[..., None, None] * state
                 + np.einsum("bhn,bh,bhp->bhnp", bm[:, t], dt[:, t], xs[:, t]))
        ys.append(np.einsum("bhn,bhnp->bhp", cm[:, t], state))
    y = np.stack(ys, axis=1) + xs * p["D"][None, None, :, None]
    y = y.reshape(b, l, d_in) * _silu(z)
    y = y / np.sqrt(np.mean(y * y, axis=-1, keepdims=True) + 1e-6) * p["norm_scale"]
    return y @ p["out_proj"]


def _attention_numpy(p, cfg, x):
    """Causal GQA with qk-norm and RoPE in float64 numpy."""
    b, s, _ = x.shape
    dh, kh = cfg.head_dim, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, dh)
    k = (x @ p["wk"]).reshape(b, s, kh, dh)
    v = (x @ p["wv"]).reshape(b, s, kh, dh)

    def norm(t, scale):
        return t / np.sqrt(np.mean(t * t, axis=-1, keepdims=True) + 1e-6) * scale

    def rope(t):
        half = dh // 2
        ang = np.arange(s)[:, None] * (1.0 / cfg.rope_theta ** (np.arange(half) / half))
        cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
        t1, t2 = t[..., :half], t[..., half:]
        return np.concatenate([t1 * cos - t2 * sin, t2 * cos + t1 * sin], axis=-1)

    q, k = rope(norm(q, p["q_norm"])), rope(norm(k, p["k_norm"]))
    k, v = np.repeat(k, cfg.group, 2), np.repeat(v, cfg.group, 2)
    scores = np.einsum("bshd,bthd->bhst", q, k) * cfg.scale
    qi, kj = np.arange(s)[:, None], np.arange(s)[None]
    mask = kj <= qi
    if cfg.window is not None:
        mask &= kj > qi - cfg.window
    scores = np.where(mask, scores, -np.inf)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, -1)
    return out @ p["wo"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba2_apply_in_float64_matches_float64_numpy(impl):
    cfg = tssm.Mamba2Config(32, d_state=8, d_head=8, n_groups=2, chunk=4, impl=impl)
    _, npp = _mamba_params(jssm.Mamba2Config(32, d_state=8, d_head=8, n_groups=2), 5)
    p64 = {k: v.astype(np.float64) for k, v in npp.items()}
    x = _rand(6, 2, 12, 32).astype(np.float64)
    y = tssm.mamba2_apply({k: torch.from_numpy(v) for k, v in p64.items()}, cfg,
                          torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert _rel_err(y, _mamba2_numpy(p64, cfg, x)) < REL64


@pytest.mark.parametrize("window", [None, 5])
def test_attention_apply_in_float64_matches_float64_numpy(window):
    cfg = tattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True, window=window)
    p = tattn.attention_init(cfg, torch.Generator().manual_seed(7), torch.float64)
    p["q_norm"] += 0.1 * torch.randn(8, generator=torch.Generator().manual_seed(8),
                                     dtype=torch.float64)
    x = _rand(9, 2, 12, 32).astype(np.float64)
    y = tattn.attention_apply(p, cfg, torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert _rel_err(y, _attention_numpy({k: v.numpy() for k, v in p.items()}, cfg, x)) < REL64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp32_and_bf16_keep_their_dtypes(dtype):
    """The plain Mamba2 and attention paths return the input's dtype, and
    the scan's state stays fp32."""
    mcfg = tssm.Mamba2Config(32, d_state=8, d_head=8, chunk=4)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 32, generator=gen).to(dtype)
    assert tssm.mamba2_apply(tssm.mamba2_init(mcfg, gen, dtype), mcfg, x).dtype == dtype
    y, state = tssm.ssd_chunked(x.reshape(2, 8, 8, 4), torch.rand(2, 8, 8, generator=gen),
                                -torch.rand(8, generator=gen), x[..., :16].reshape(2, 8, 2, 8),
                                x[..., 16:].reshape(2, 8, 2, 8), 4)
    assert y.dtype == dtype and state.dtype == torch.float32
    acfg = tattn.AttentionConfig(32, 4, 2, d_head=8, qk_norm=True)
    assert tattn.attention_apply(tattn.attention_init(acfg, gen, dtype), acfg, x).dtype == dtype
