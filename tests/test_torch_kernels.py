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


# -- the SSD scan --------------------------------------------------------------

def _ssm_inputs(seed, b, l, h, g, n, p):
    """Step sizes and decays of a Mamba2 layer at init: dt softplus of a
    small normal, a = -linspace(1, 16) (decays down to exp(-16 dt))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, a, bm, cm


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _err_over_tol(got, want, rel, of_max=0.0, of_rms=0.0):
    """The largest |got - want| over its own bound, per element:
    ``rel * |want| + of_max * max|want| + of_rms * rms(want)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = (rel * np.abs(want) + of_max * np.abs(want).max()
             + of_rms * np.sqrt(np.mean(want ** 2)))
    return (np.abs(got - want) / np.maximum(bound, 1e-30)).max()


# a bf16 unit in the last place, relative: 2^-7 of |v| at most (8 bits of
# mantissa), so round-to-nearest moves a value by 2^-8 of |v| at most
BF16_ULP = 2.0 ** -7


# (L, G, chunk): chunk 8 is the schedule's least, 100 the decrement-chosen
# chunk of L=200, 64 a power of two below L
SSM_CASES = [(64, 1, 8), (64, 2, 8), (200, 1, 100), (200, 2, 100), (128, 1, 64),
             (128, 2, 64)]


@pytest.mark.parametrize("l, g, chunk", SSM_CASES)
def test_ssm_scan_matches_jax(l, g, chunk):
    """fp32: y and the final state against the JAX wrapper (Pallas kernel in
    interpret mode) and the JAX plain version, to 1e-5 of max |y| and of
    max |state| (the sums are taken in another order)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    b, h, n, p = 2, 4, 8, 16
    args = _ssm_inputs(l + g, b, l, h, g, n, p)
    jargs = [jnp.asarray(v) for v in args]
    want_y, want_s = jops.ssm_scan(*jargs, chunk=chunk)
    ref_y, ref_s = jax.jit(jref.ssm_scan_ref, static_argnames=("chunk",))(*jargs, chunk=chunk)
    targs = [torch.from_numpy(v) for v in args]
    got_y, got_s = ops.ssm_scan(*targs, chunk=chunk)
    plain_y, plain_s = ref.ssm_scan_ref(*targs, chunk=chunk)
    assert got_y.shape == (b, l, h, p) and got_s.shape == (b, h, n, p)
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    for got, want in ((got_y, want_y), (got_s, want_s), (plain_y, ref_y), (plain_s, ref_s)):
        assert _rel_err(got.numpy(), want) < 1e-5


def test_ssm_scan_bf16_matches_jax():
    """bf16 x, B, C, per element of y.  Against the JAX plain version, which
    rounds the decayed panel to bf16 before its product with x at the same
    place: one bf16 ulp of |y| plus the fp32 order-of-summation tolerance,
    1e-4 of max |y|.  Against the JAX wrapper (Pallas in interpret mode),
    which keeps the panel in fp32: 2e-2 of |y| plus 2e-2 of rms(y), for
    the panel's rounding summed over the chunk.  The state is summed in
    fp32 on both sides, to 1e-5 of its max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    x, dt, a, bm, cm = _ssm_inputs(7, 2, 64, 4, 2, 8, 16)
    jx, jb, jc = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, bm, cm))
    jargs = (jx, jnp.asarray(dt), jnp.asarray(a), jb, jc)
    want_y, want_s = jops.ssm_scan(*jargs, chunk=16)
    plain_y, _ = jax.jit(jref.ssm_scan_ref, static_argnames=("chunk",))(*jargs, chunk=16)
    tx, tb, tc = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, bm, cm))
    got_y, got_s = ops.ssm_scan(tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc,
                                chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    got = got_y.float().numpy()
    assert _err_over_tol(got, plain_y.astype(jnp.float32), BF16_ULP, of_max=1e-4) <= 1
    assert _err_over_tol(got, want_y.astype(jnp.float32), 2e-2, of_rms=2e-2) <= 1
    assert _rel_err(got_s.numpy(), want_s) < 1e-5


def test_ssm_scan_cpu_call_does_not_count_as_a_launch():
    before = ops.LAUNCHES["ssm_scan"]
    ops.ssm_scan(*[torch.from_numpy(v) for v in _ssm_inputs(0, 1, 16, 2, 1, 4, 4)], chunk=8)
    assert ops.LAUNCHES["ssm_scan"] == before


@pytest.mark.parametrize("bad, message", [
    (dict(chunk=24), "does not divide"),
    (dict(g=3), "G does not divide H"),
    (dict(c_dtype=torch.float64), "dtypes differ"),
])
def test_ssm_scan_rejects_bad_inputs(bad, message):
    g = bad.get("g", 2)
    x, dt, a = torch.zeros(1, 64, 4, 8), torch.zeros(1, 64, 4), torch.zeros(4)
    bm = torch.zeros(1, 64, g, 8)
    cm = torch.zeros(1, 64, g, 8, dtype=bad.get("c_dtype", torch.float32))
    with pytest.raises(ValueError, match=message):
        ops.ssm_scan(x, dt, a, bm, cm, chunk=bad.get("chunk", 16))


# (B, L, H, G, N, P, chunk) — the chip smoke's cases: the served NAS shape is
# the last; chunk 256 tiles the (Q, Q) panel
SSM_CUDA_CASES = [
    (1, 64, 4, 2, 8, 16, 8),
    (2, 200, 4, 1, 16, 16, 100),
    (2, 256, 8, 2, 16, 16, 64),
    (1, 2048, 80, 1, 64, 64, 256),
    (4, 2048, 80, 1, 64, 64, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, y_rel", [("float32", 0.0), ("bfloat16", BF16_ULP / 2)])
@pytest.mark.parametrize("b, l, h, g, n, p, chunk", SSM_CUDA_CASES)
def test_ssm_scan_cuda_kernel_matches_plain_version(b, l, h, g, n, p, chunk, dtype, y_rel):
    """Against the fp32 plain version on the same (bf16-valued) inputs: the
    kernel sums in fp32 and rounds y once, so each element of y is within
    ``y_rel`` of its |y| (half a bf16 ulp) plus 1e-4 of max |y| (order of
    summation); the fp32 state within 1e-4 of its max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt_ = getattr(torch, dtype)
    x, dt, a, bm, cm = (torch.from_numpy(v).cuda() for v in _ssm_inputs(l, b, l, h, g, n, p))
    x, bm, cm = x.to(dt_), bm.to(dt_), cm.to(dt_)
    before = ops.LAUNCHES["ssm_scan"]
    y, s = ops.ssm_scan(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    want_y, want_s = ref.ssm_scan_ref(x.float(), dt, a, bm.float(), cm.float(), chunk=chunk)
    assert y.dtype == dt_ and y.shape == x.shape and s.dtype == torch.float32
    assert _err_over_tol(y.float().cpu().numpy(), want_y.cpu().numpy(), y_rel,
                         of_max=1e-4) <= 1
    assert _rel_err(s.cpu().numpy(), want_s.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
def test_ssm_scan_cuda_refuses_a_head_wider_than_64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, dt, a, bm, cm = (torch.from_numpy(v).cuda() for v in _ssm_inputs(0, 1, 16, 2, 1, 8, 72))
    with pytest.raises(ValueError, match="P up to 64"):
        ops.ssm_scan(x, dt, a, bm, cm, chunk=8)


def _recurrence_fp64(x, dt, a, bm, cm):
    """The scan as its definition, one step at a time, in float64:
    S_t = exp(dt_t a) S_{t-1} + dt_t B_t^T x_t,  y_t = C_t S_t."""
    rep = x.shape[2] // bm.shape[2]
    x, dt, a = x.astype(np.float64), dt.astype(np.float64), a.astype(np.float64)
    bh = np.repeat(bm, rep, axis=2).astype(np.float64)
    ch = np.repeat(cm, rep, axis=2).astype(np.float64)
    state = np.zeros((x.shape[0], x.shape[2], bm.shape[3], x.shape[3]))
    ys = []
    for t in range(x.shape[1]):
        state = (np.exp(dt[:, t] * a)[:, :, None, None] * state
                 + (dt[:, t, :, None] * bh[:, t])[..., None] * x[:, t, :, None, :])
        ys.append(np.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("chunk", [8, 128, 256])
def test_ssm_scan_plain_version_matches_the_recurrence(chunk):
    """The chunked formulation in fp32 against the step-by-step recurrence
    in float64, to 3e-5 of max |y| and of max |state| up to chunk 256.  The
    error grows with the chunk: |cumsum(dt * a)| grows with it, and so does
    the fp32 rounding of the decays taken from it."""
    args = _ssm_inputs(11, 2, 256, 4, 2, 8, 16)
    want_y, want_s = _recurrence_fp64(*args)
    got_y, got_s = ops.ssm_scan(*[torch.from_numpy(v) for v in args], chunk=chunk)
    assert _rel_err(got_y.numpy(), want_y) < 3e-5
    assert _rel_err(got_s.numpy(), want_s) < 3e-5
