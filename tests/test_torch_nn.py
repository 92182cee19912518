"""The port's layers against the JAX package's, module by module, on the
same numpy inputs and the same (converted) parameters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.nn import attention as jattn  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.nn import norms as jnorms  # noqa: E402
from repro.nn import rope as jrope  # noqa: E402
from repro.nn.types import split  # noqa: E402
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn import mlp as tmlp  # noqa: E402
from repro_torch.nn import norms as tnorms  # noqa: E402
from repro_torch.nn import rope as trope  # noqa: E402

ATOL = 3e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def _params(tree):
    """JAX P-tree -> (jax values, torch tensors) from the same numpy."""
    values, _ = split(tree)
    return values, {k: torch.from_numpy(np.array(v)) for k, v in values.items()}


@pytest.mark.parametrize("positions", [
    np.arange(6)[None],                 # one prompt, scalar offsets
    np.array([[3], [11]]),              # per-slot decode positions
])
def test_rope(positions):
    x = _rand(0, 2, positions.shape[1], 4, 16)
    want = jax.jit(jrope.apply_rope, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(positions), 1e6)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), 1e6), want)


def test_rmsnorm_and_headwise_rmsnorm():
    x, scale = _rand(1, 2, 5, 64), _rand(2, 64)
    _close(tnorms.rmsnorm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jnorms.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    xh, sh = _rand(3, 2, 5, 4, 16), _rand(4, 16)
    _close(tattn._headwise_rmsnorm(torch.from_numpy(xh), torch.from_numpy(sh)),
           jattn._headwise_rmsnorm(jnp.asarray(xh), jnp.asarray(sh)))


@pytest.mark.parametrize("activation, gated", [("silu", True), ("gelu", False)])
def test_mlp(activation, gated):
    jcfg = jmlp.MLPConfig(64, 192, activation=activation, gated=gated, use_bias=True)
    tcfg = tmlp.MLPConfig(64, 192, activation=activation, gated=gated, use_bias=True)
    jp, tp = _params(jmlp.mlp_init(jcfg, jax.random.PRNGKey(0)))
    x = _rand(5, 2, 7, 64)
    _close(tmlp.mlp_apply(tp, tcfg, torch.from_numpy(x)),
           jax.jit(jmlp.mlp_apply, static_argnums=1)(jp, jcfg, jnp.asarray(x)))


def _attn(impl="xla", window=None):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, qk_norm=True,
              rope_theta=1e6, window=window, impl=impl)
    jcfg, tcfg = jattn.AttentionConfig(**kw), tattn.AttentionConfig(**kw)
    jp, tp = _params(jattn.attention_init(jcfg, jax.random.PRNGKey(1)))
    # non-unit norm scales, so the qk-norm parameters are exercised
    for seed, name in enumerate(("q_norm", "k_norm"), start=11):
        jp[name] = jnp.asarray(1.0 + 0.5 * _rand(seed, 16))
        tp[name] = torch.from_numpy(np.array(jp[name]))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("impl, window", [("xla", None), ("pallas", None), ("pallas", 8)])
def test_attention_apply(impl, window):
    jcfg, tcfg, jp, tp = _attn(impl, window)
    x = _rand(6, 2, 24, 64)
    _close(tattn.attention_apply(tp, tcfg, torch.from_numpy(x)),
           jax.jit(jattn.attention_apply, static_argnums=1)(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("impl, pos_offset", [("xla", 0), ("pallas", 0), ("pallas", 3)])
def test_attention_prefill(impl, pos_offset):
    jcfg, tcfg, jp, tp = _attn(impl)
    x = _rand(7, 2, 10, 64)
    jcache = jattn.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = tattn.init_kv_cache(tcfg, 2, 16, dtype=torch.float32)
    jy, jc = jax.jit(jattn.attention_prefill, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(x), jcache, pos_offset)
    ty, tc = tattn.attention_prefill(tp, tcfg, torch.from_numpy(x), tcache, pos_offset)
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_per_slot_positions(window):
    jcfg, tcfg, jp, tp = _attn(window=window)
    k0, v0 = _rand(8, 3, 12, 2, 16), _rand(9, 3, 12, 2, 16)
    x, pos = _rand(10, 3, 1, 64), np.array([5, 0, 11])
    jy, jc = jax.jit(jattn.attention_decode, static_argnums=1)(
        jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(pos))
    tcache = {"k": torch.from_numpy(k0.copy()), "v": torch.from_numpy(v0.copy())}
    ty, tc = tattn.attention_decode(tp, tcfg, torch.from_numpy(x), tcache,
                                    torch.from_numpy(pos))
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_attention_config_rejects_unported_impl():
    """An impl the port does not have is refused, naming the ones it has
    (since xla_chunked was ported, those are all of the JAX package's)."""
    with pytest.raises(NotImplementedError, match="xla_chunked"):
        tattn.AttentionConfig(64, 4, 2, impl="splash")
    assert tattn.AttentionConfig(64, 4, 2, impl="xla_chunked").impl == "xla_chunked"


def test_initializers_draw_the_jax_distributions():
    """Same distributions as the JAX initializers (not the same numbers:
    the generators differ): normal(0.02), and a +-2-truncated normal
    scaled by fan_in^-1/2."""
    from repro.nn import initializers as jinit
    from repro_torch.nn import initializers as tinit

    g = torch.Generator().manual_seed(0)
    shape = (256, 512)
    t_norm = tinit.normal(g, shape).numpy()
    t_trunc = tinit.scaled_normal(g, shape, fan_in=64).numpy()
    j_norm = np.asarray(jinit.normal(jax.random.PRNGKey(0), shape))
    j_trunc = np.asarray(jinit.scaled_normal(jax.random.PRNGKey(1), shape, fan_in=64))
    assert abs(t_norm.std() / j_norm.std() - 1) < 0.02
    assert abs(t_trunc.std() / j_trunc.std() - 1) < 0.02
    assert np.abs(t_trunc).max() <= 2 / 8 + 1e-6
    assert abs(t_norm.mean()) < 1e-3 and abs(t_trunc.mean()) < 2e-3
