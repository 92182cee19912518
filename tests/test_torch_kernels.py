"""The port's flash attention against the JAX package's: the plain
version and the CPU path of the wrapper against ``repro.kernels.ref`` and
the Pallas kernel (interpret mode) on the same numpy inputs, and — on a
machine with a card — the CUDA kernel against the plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny shapes: leave the CPU to the other test workers

from repro_torch.kernels import ops, ref  # noqa: E402


def _jax():
    """The JAX package, imported only by the tests that compare with it
    (the machine with the card need not have JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    jit_ref = jax.jit(jref.flash_attention_ref,
                      static_argnames=("causal", "window", "scale"))
    return jnp, jops, jit_ref


def _inputs(seed, b, s, h, kh, d, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kh, d)).astype(np.float32)
    return q, k, v


def _bhsd(x):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


# (causal, window, S, group)
CASES = ([(True, None, s, g) for s in (8, 100, 128, 200) for g in (1, 2)]
         + [(True, 32, 128, 2), (False, None, 100, 2)])


@pytest.mark.parametrize("causal, window, s, group", CASES)
def test_flash_attention_matches_jax(causal, window, s, group):
    jnp, jops, jref_fn = _jax()
    h, d = 4, 16
    q, k, v = _inputs(s, 2, s, h, h // group, d)
    kw = dict(causal=causal, window=window, scale=d ** -0.5)

    want_ref = np.asarray(jref_fn(
        jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)), jnp.asarray(_bhsd(v)), **kw))
    want_pallas = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))

    got_ref = ref.flash_attention_ref(torch.from_numpy(_bhsd(q)), torch.from_numpy(_bhsd(k)),
                                      torch.from_numpy(_bhsd(v)), **kw).numpy()
    got_ops = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(got_ref, want_ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_ops, want_pallas, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_ops, _bhsd(got_ref), atol=1e-5, rtol=0)


def test_non_causal_padded_tail_follows_the_reference_not_pallas():
    """At S=200 the Pallas wrapper pads KV to 256 and, when non-causal,
    attends to the padded columns.  The port holds to the reference; the
    Pallas divergence is recorded here as a fault of the JAX kernel."""
    jnp, jops, jref_fn = _jax()
    q, k, v = _inputs(200, 1, 200, 4, 2, 16)
    kw = dict(causal=False, window=None, scale=0.25)
    want = np.asarray(jref_fn(
        jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)), jnp.asarray(_bhsd(v)), **kw))
    pallas = np.asarray(jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), **kw))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(_bhsd(got), want, atol=1e-5, rtol=0)
    assert np.max(np.abs(_bhsd(pallas) - want)) > 1e-2  # known divergence


def test_cpu_call_does_not_count_as_a_launch():
    before = ops.LAUNCHES["flash_attention"]
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 1, 8, 4, 2, 16))
    ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("bad, message", [
    (dict(k_shape=(1, 8, 3, 16)), "H % KH"),
    (dict(window=0), "window"),
    (dict(k_dtype=torch.float64), "dtypes differ"),
])
def test_wrapper_rejects_bad_inputs(bad, message):
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(bad.get("k_shape", (1, 8, 2, 16)), dtype=bad.get("k_dtype", torch.float32))
    v = torch.zeros_like(k)
    with pytest.raises(ValueError, match=message):
        ops.flash_attention(q, k, v, window=bad.get("window"))


# (B, S, H, KH, D, causal, window) — the chip smoke's cases, at the served
# widths among them
CUDA_CASES = [
    (1, 8, 4, 2, 16, True, None),
    (2, 100, 4, 2, 16, True, None),
    (1, 200, 16, 8, 128, True, None),
    (1, 512, 16, 8, 128, True, None),
    (1, 128, 4, 2, 16, True, 32),
    (1, 200, 4, 2, 16, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b, s, h, kh, d, causal, window", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(b, s, h, kh, d, causal, window, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to("cuda", dt) for x in _inputs(s, b, s, h, kh, d))
    before = ops.LAUNCHES["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window).transpose(1, 2)
    assert out.dtype == dt and out.shape == q.shape
    assert (out.float() - want.float()).abs().max().item() <= atol
