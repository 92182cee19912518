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
    # ragged S inside a 64-row tile, D not a multiple of 16, group 4, and a
    # window that crosses 64-row tiles
    (2, 777, 8, 2, 36, True, 100),
    (1, 300, 4, 4, 80, False, None),  # the NAS loop's head dim, non-causal
    # paligemma-3b's causal MQA at D = 256 over its 2048 tokens, whisper-medium's
    # encoder (non-causal, 1500 frames: no multiple of a tile, where the JAX
    # package's Pallas kernel leaves the padded KV columns unmasked; held here
    # to the plain version) and its decoder's 448-token text context
    (1, 2048, 8, 1, 256, True, None),
    (1, 1500, 16, 16, 64, False, None),
    (1, 448, 16, 16, 64, True, None),
    # paligemma-3b's served prompts (64 and 128 tokens) and whisper-medium's
    # cached prefill of 384 tokens
    (1, 64, 8, 1, 256, True, None),
    (1, 128, 8, 1, 256, True, None),
    (1, 384, 16, 16, 64, True, None),
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


def _tf32(x, rounding):
    """x as a TF32 value (10 mantissa bits).  ``"rna"``: to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds (on the magnitude bits,
    so for both signs).  ``"trunc"``: toward zero, the low 13 bits cleared,
    as the tensor core reads an fp32 word given as a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, terms, rounding):
    """a @ b as the tensor cores take it from TF32 operands: each product
    exact in fp32, the sums in fp32.  ``terms=3`` is split-TF32, each
    operand x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and the
    product hi*hi + hi*lo + lo*hi; ``terms=1`` is plain TF32."""
    a_hi, b_hi = _tf32(a, rounding), _tf32(b, rounding)
    out = a_hi @ b_hi
    if terms == 3:
        out = (_tf32(a - a_hi, rounding) @ b_hi + a_hi @ _tf32(b - b_hi, rounding)
               + out)
    return out


def _tf32_flash(q, k, v, terms, rounding, block=64):
    """The fp32 CUDA kernel's arithmetic: for each 64-key tile, S = Q K^T
    and P V through :func:`_tf32_matmul`, the running max and denominator
    in fp32.  q/k/v: (B, H, S, D), non-causal."""
    scale = q.shape[-1] ** -0.5
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for t0 in range(0, k.shape[-2], block):
        kt = k[..., t0:t0 + block, :].transpose(-1, -2)
        s = _tf32_matmul(q, kt, terms, rounding) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _tf32_matmul(p, v[..., t0:t0 + block, :], terms, rounding)
        m = m_new
    return o / l[..., None]


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
@pytest.mark.parametrize("d", [80, 128])
def test_split_tf32_holds_the_fp32_tolerance_and_plain_tf32_does_not(d, rounding):
    """The fp32 kernel computes both products in split-TF32 on the tensor
    cores, splitting by truncation (``"trunc"``: hi is x with its low bits
    cleared, lo the exact rest, read by the tensor core through its top
    bits); ``"rna"`` splits with ``cvt.rna``.  Modelled here in torch on
    random inputs (scores of order 1), either is within the 1e-4 fp32
    tolerance of the plain version, and plain TF32 (one product, 11 bits)
    is not: the design holds the tolerance the kernel is checked against."""
    q, k, v = (torch.from_numpy(_bhsd(x)) for x in _inputs(d, 1, 256, 4, 4, d))
    want = ref.flash_attention_ref(q, k, v, causal=False, window=None)
    err3 = (_tf32_flash(q, k, v, 3, rounding) - want).abs().max().item()
    err1 = (_tf32_flash(q, k, v, 1, rounding) - want).abs().max().item()
    assert err3 <= 1e-4
    assert err1 > 1e-4


def test_tf32_rounding_of_the_model():
    """rna: 1 + 2^-11 (a tie) rounds away from zero to 1 + 2^-10, in both
    signs, and 1 + 2^-12 down to 1; trunc: both down, toward zero."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3.0])
    np.testing.assert_array_equal(_tf32(x, "rna").numpy(),
                                  [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 3.0])
    np.testing.assert_array_equal(_tf32(x, "trunc").numpy(), [1.0, -1.0, 1.0, 3.0])


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


def _check_ssm_bf16_against_jax(seed, bf16_dt):
    """bf16 x, B, C (and, with ``bf16_dt``, dt and a) through the wrapper's
    CPU path against the JAX package on the same bf16 values, per element of
    y.  Against the JAX plain version, which rounds the decayed panel to bf16
    before its product with x at the same place: one bf16 ulp of |y| plus
    the fp32 order-of-summation tolerance, 1e-4 of max |y|.  Against the JAX
    wrapper (Pallas in interpret mode), which keeps the panel in fp32: 2e-2
    of |y| plus 2e-2 of rms(y), for the panel's rounding summed over the
    chunk.  The state is summed in fp32 on both sides, to 1e-5 of its max."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    args = _ssm_inputs(seed, 2, 64, 4, 2, 8, 16)
    bf16 = (0, 1, 2, 3, 4) if bf16_dt else (0, 3, 4)  # x, dt, a, B, C
    jargs = [jnp.asarray(v).astype(jnp.bfloat16) if i in bf16 else jnp.asarray(v)
             for i, v in enumerate(args)]
    want_y, want_s = jops.ssm_scan(*jargs, chunk=16)
    plain_y, _ = jax.jit(jref.ssm_scan_ref, static_argnames=("chunk",))(*jargs, chunk=16)
    targs = [torch.from_numpy(v).to(torch.bfloat16) if i in bf16 else torch.from_numpy(v)
             for i, v in enumerate(args)]
    got_y, got_s = ops.ssm_scan(*targs, chunk=16)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    got = got_y.float().numpy()
    assert _err_over_tol(got, plain_y.astype(jnp.float32), BF16_ULP, of_max=1e-4) <= 1
    assert _err_over_tol(got, want_y.astype(jnp.float32), 2e-2, of_rms=2e-2) <= 1
    assert _rel_err(got_s.numpy(), want_s) < 1e-5


def test_ssm_scan_bf16_matches_jax():
    """bf16 x, B, C: :func:`_check_ssm_bf16_against_jax`."""
    _check_ssm_bf16_against_jax(7, bf16_dt=False)


def test_ssm_scan_bf16_dt_and_a_match_jax():
    """bf16 dt and a beside bf16 x, B, C: the wrapper takes them in fp32, as
    the Pallas kernel casts them (:func:`_check_ssm_bf16_against_jax`)."""
    _check_ssm_bf16_against_jax(8, bf16_dt=True)


@pytest.mark.parametrize("l, g, chunk", SSM_CASES)
def test_ssm_scan_chunk_loop_matches_ssd_chunked_and_jax(l, g, chunk):
    """The chunk-loop plain version (the CUDA kernel's order) against
    ``ssd_chunked`` and the JAX plain version, to 1e-5 of max |y| and of
    max |state|; in float64 (float64 inputs, so y stays float64) against the
    step-by-step recurrence to 1e-12."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    args = _ssm_inputs(l + 3 * g, 2, l, 4, g, 8, 16)
    ref_y, ref_s = jax.jit(jref.ssm_scan_ref, static_argnames=("chunk",))(
        *[jnp.asarray(v) for v in args], chunk=chunk)
    targs = [torch.from_numpy(v) for v in args]
    got_y, got_s = ref.ssm_scan_chunks(*targs, chunk=chunk)
    plain_y, plain_s = ref.ssm_scan_ref(*targs, chunk=chunk)
    for got, want in ((got_y, plain_y.numpy()), (got_s, plain_s.numpy()), (got_y, ref_y),
                      (got_s, ref_s)):
        assert _rel_err(got.numpy(), want) < 1e-5
    y64, _ = ref.ssm_scan_chunks(*[t.double() for t in targs], chunk=chunk, dtype=torch.float64)
    rec_y, _ = _recurrence_fp64(*args)
    assert np.abs(y64.numpy() - rec_y).max() / np.abs(rec_y).max() < 1e-12


# The SSD kernel's products as the tensor cores take them: ("bf16", 2) is the
# bf16 path (the fp32 operand in two bf16 terms), ("tf32", 3) the fp32 path
# (split-TF32); each with its cheaper version, which must miss the tolerance
SSM_PRODUCTS = [("bf16", 2, True), ("tf32", 3, True), ("bf16", 1, False), ("tf32", 1, False)]


@pytest.mark.parametrize("kind, terms, holds", SSM_PRODUCTS)
def test_ssm_scan_product_split_holds_the_tolerance_and_the_cheaper_one_does_not(
        kind, terms, holds):
    """:func:`ref.ssm_scan_chunks` with its four products taken as the CUDA
    kernel's tensor cores take them (:func:`_bf16_products`,
    :func:`_tf32_matmul`), at N = P = 64 and chunk 128 (the NAS loop's
    widths) on bf16-valued inputs: the fp32 operands in two bf16 terms, and
    split-TF32, are within 1e-4 of max |y| of the fp32 plain version (the
    kernel's tolerance beside rounding y once); one bf16 term, and plain
    TF32, are not."""
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in _ssm_inputs(5, 1, 512, 4, 1, 64, 64))
    x, bm, cm = (t.bfloat16().float() for t in (x, bm, cm))
    want, _ = ref.ssm_scan_ref(x, dt, a, bm, cm, chunk=128)
    if kind == "bf16":
        mm = _bf16_products(terms)
    else:
        def mm(p, q):
            return _tf32_matmul(p, q, terms, "trunc")
    got, _ = ref.ssm_scan_chunks(x, dt, a, bm, cm, chunk=128, matmul=mm)
    assert ((got - want).abs().max().item() <= 1e-4 * want.abs().max().item()) == holds


def test_ssm_scan_cpu_call_does_not_count_as_a_launch():
    before = ops.LAUNCHES["ssm_scan"]
    ops.ssm_scan(*[torch.from_numpy(v) for v in _ssm_inputs(0, 1, 16, 2, 1, 4, 4)], chunk=8)
    assert ops.LAUNCHES["ssm_scan"] == before


@pytest.mark.parametrize("bad, message", [
    (dict(chunk=0), "does not divide"),  # a chunk that does not divide L is halved
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


# (B, L, H, G, N, P, chunk) — the chip smoke's cases: the NAS loop's shape at
# chunk 256 and at its own chunk 128; Mamba2-2.7b's d_state 128 and headdim
# 64; a head of 128; N and P off the MMA tiles with chunk 100 (ragged
# tiles); chunk 1024 at N = P = 128
SSM_CUDA_CASES = [
    (1, 64, 4, 2, 8, 16, 8),
    (2, 200, 4, 1, 16, 16, 100),
    (2, 256, 8, 2, 16, 16, 64),
    (1, 2048, 80, 1, 64, 64, 256),
    (4, 2048, 80, 1, 64, 64, 128),
    (2, 512, 8, 1, 128, 64, 128),
    (2, 512, 8, 2, 64, 128, 128),
    (2, 200, 6, 3, 24, 72, 100),
    (1, 2048, 16, 1, 128, 128, 1024),
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
@pytest.mark.parametrize("p", [72, 128])
def test_ssm_scan_cuda_takes_a_head_wider_than_64(p):
    """Heads wider than 64, which the kernel once refused, launch and match
    the fp32 plain version as the other cases do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, a, bm, cm = (torch.from_numpy(v).cuda() for v in _ssm_inputs(p, 1, 128, 2, 1, 8, p))
    before = ops.LAUNCHES["ssm_scan"]
    y, s = ops.ssm_scan(x, dt, a, bm, cm, chunk=64)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_scan"] == before + 1
    want_y, want_s = ref.ssm_scan_ref(x, dt, a, bm, cm, chunk=64)
    assert _err_over_tol(y.cpu().numpy(), want_y.cpu().numpy(), 0.0, of_max=1e-4) <= 1
    assert _rel_err(s.cpu().numpy(), want_s.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
def test_ssm_scan_cuda_takes_bf16_dt_and_a():
    """bf16 dt and a launch (the wrapper casts them to fp32) and match the
    fp32 plain version on the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, dt, a, bm, cm = (torch.from_numpy(v).cuda() for v in _ssm_inputs(3, 2, 256, 4, 2, 16, 32))
    dt, a = dt.bfloat16(), a.bfloat16()
    y, s = ops.ssm_scan(x, dt, a, bm, cm, chunk=128)
    torch.cuda.synchronize()
    want_y, want_s = ref.ssm_scan_ref(x, dt.float(), a.float(), bm, cm, chunk=128)
    assert _err_over_tol(y.cpu().numpy(), want_y.cpu().numpy(), 0.0, of_max=1e-4) <= 1
    assert _rel_err(s.cpu().numpy(), want_s.cpu().numpy()) <= 1e-4


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


# -- the mLSTM scan ------------------------------------------------------------

def _mlstm_inputs(seed, b, l, h, p, f_bias=3.0, i_shift=0.0):
    """q, k, v standard normal; log input gates 2 N(0, 1) + ``i_shift``; log
    forget gates log-sigmoid(N(0, 1) + ``f_bias``), as tests/test_kernels.py
    draws them (an mLSTM layer's forget bias starts at 3)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, l, h, p)).astype(np.float32) for _ in range(3))
    il = (rng.standard_normal((b, l, h)) * 2.0 + i_shift).astype(np.float32)
    fl = (-np.logaddexp(0.0, -(rng.standard_normal((b, l, h)) + f_bias))).astype(np.float32)
    return q, k, v, il, fl


# (B, L, H, P, chunk): tests/test_kernels.py's sweep shapes, the
# decrement-chosen chunk 100 of L=200, and the schedule's least chunk, 8
MLSTM_SHAPES = [(2, 64, 2, 32, 16), (2, 128, 4, 16, 32), (1, 200, 2, 64, 100),
                (1, 64, 2, 64, 8)]


@pytest.mark.parametrize("f_bias", [-2.0, 1.0, 5.0])
@pytest.mark.parametrize("b, l, h, p, chunk", MLSTM_SHAPES)
def test_mlstm_scan_matches_jax(b, l, h, p, chunk, f_bias):
    """The wrapper's CPU path (the plain version, the Pallas kernel's own
    formulation) against the JAX wrapper (Pallas in interpret mode), to 1e-4
    of max |h|: the same sums in another order (up to 1.8e-5 measured: the
    log-gate cumsums reach |fcum| ~ 2e2 in a chunk of 100, where an fp32
    ulp is 1.5e-5, and a near-cancelling denominator amplifies that).  Both
    plain versions, this
    and ``mlstm_chunked``, against the JAX recurrent oracle at JAX's own
    tolerance (atol 2e-4, rtol 2e-3, tests/test_kernels.py)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.nn.xlstm import mlstm_chunked

    args = _mlstm_inputs(l + p + int(f_bias), b, l, h, p, f_bias=f_bias)
    jargs = [jnp.asarray(a) for a in args]
    want, none = jops.mlstm_scan(*jargs, chunk=chunk)
    oracle = np.asarray(jax.jit(jref.mlstm_scan_ref)(*jargs))
    targs = [torch.from_numpy(a) for a in args]
    got, got_none = ops.mlstm_scan(*targs, chunk=chunk)
    assert got_none is None and none is None
    assert got.shape == (b, l, h, p) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-4, rtol=2e-3)
    chunked, _ = mlstm_chunked(*targs, chunk)
    np.testing.assert_allclose(chunked.numpy(), oracle, atol=2e-4, rtol=2e-3)


def test_mlstm_scan_with_strongly_negative_input_gates_is_finite():
    """Input gates shifted by -100: exp(-m) overflows to inf, the denominator
    is inf and h is 0 in the Pallas kernel; the plain version gives the
    same finite output."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    args = _mlstm_inputs(5, 1, 64, 2, 32, i_shift=-100.0)
    want, _ = jops.mlstm_scan(*[jnp.asarray(a) for a in args], chunk=16)
    got, _ = ops.mlstm_scan(*[torch.from_numpy(a) for a in args], chunk=16)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlstm_recurrent_matches_jax():
    """The port's step-by-step oracle against the JAX package's, to 1e-5 of
    max |h|, and the port's plain version against it at JAX's tolerance."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    args = _mlstm_inputs(9, 2, 48, 2, 16, f_bias=1.0)
    want = np.asarray(jax.jit(jref.mlstm_scan_ref)(*[jnp.asarray(a) for a in args]))
    targs = [torch.from_numpy(a) for a in args]
    assert _rel_err(ref.mlstm_recurrent_ref(*targs).numpy(), want) < 1e-5
    np.testing.assert_allclose(ref.mlstm_scan_ref(*targs, chunk=16).numpy(),
                               ref.mlstm_recurrent_ref(*targs).numpy(), atol=2e-4, rtol=2e-3)


def test_mlstm_scan_bf16_cpu_path_rounds_h_once():
    """bf16 q, k, v: the plain version computes in fp32 and rounds h to bf16
    once, so it is within half a bf16 ulp of the fp32 result on the same
    bf16 values."""
    q, k, v, il, fl = (torch.from_numpy(a) for a in _mlstm_inputs(3, 1, 64, 2, 32))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got, _ = ops.mlstm_scan(q, k, v, il, fl, chunk=16)
    want, _ = ops.mlstm_scan(q.float(), k.float(), v.float(), il, fl, chunk=16)
    assert got.dtype == torch.bfloat16
    assert _err_over_tol(got.float().numpy(), want.numpy(), BF16_ULP / 2, of_max=1e-7) <= 1


def _bf16_terms(x, n):
    """x as ``n`` bf16 terms: hi = bf16(x), then bf16 of what is left."""
    terms = []
    for _ in range(n):
        terms.append(x.bfloat16().float())
        x = x - terms[-1]
    return terms


def _bf16_products(terms):
    """A matmul as the bf16 kernel's tensor cores take it: an operand that
    bf16 holds exactly (q, k, v) goes in as it is, the fp32 one (S, C, or
    the weighted side of the state update) as ``terms`` bf16 terms; each
    product exact, the sums in fp32."""
    def exact(x):
        return bool((x.bfloat16().float() == x).all())

    def mm(a, b):
        assert exact(a) or exact(b)
        if not exact(a):
            return sum(t @ b for t in _bf16_terms(a, terms))
        if not exact(b):
            return sum(a @ t for t in _bf16_terms(b, terms))
        return a @ b
    return mm


# The mLSTM kernel's products: ("bf16", 2) is the bf16 path on the tensor
# cores (the fp32 operand in two bf16 terms), ("fp32", 1) the fp32 path (the
# plain version's own products, summed in its order on the CUDA cores);
# ("tf32", 3) is split-TF32 on the tensor cores, which holds this tolerance
# but not the xlstm-1.3b logits check (PERF.md); each tensor-core split with
# its cheaper version, which must miss the tolerance
MLSTM_PRODUCTS = [("bf16", 2, True), ("bf16", 1, False), ("fp32", 1, True),
                  ("tf32", 3, True), ("tf32", 1, False)]


@pytest.mark.parametrize("kind, terms, holds", MLSTM_PRODUCTS)
@pytest.mark.parametrize("f_bias", [-2.0, 1.0, 3.0, 5.0])
def test_mlstm_scan_product_split_holds_the_tolerance_and_the_cheaper_one_does_not(
        f_bias, kind, terms, holds):
    """The kernel's products, modelled in torch as
    :func:`test_split_tf32_holds_the_fp32_tolerance_and_plain_tf32_does_not`
    models flash's: :func:`ref.mlstm_scan_ref` with its four products taken
    as the tensor cores take them, at P = 256, chunk 64.  bf16 path
    (:func:`_bf16_products`, on bf16-valued inputs): the fp32 operand split
    into two bf16 terms is within 1e-4 of max |h| of the fp32 plain version
    (the part of the kernel's bf16 tolerance left beside rounding h once),
    and that operand rounded to bf16 once is not.  The kernel moves the
    state weights onto v and splits w v where this model splits k w: either
    way one fp32 operand of the update is split.  On fp32 inputs: the fp32
    path's products, the plain version's own, hold it exactly; split-TF32
    (:func:`_tf32_matmul`, both operands split by truncation) is within 1e-4
    of max |h| of the fp32 plain version, and plain TF32 is not."""
    q, k, v, il, fl = (torch.from_numpy(a) for a in _mlstm_inputs(7, 1, 256, 2, 256, f_bias=f_bias))
    if kind == "bf16":
        q, k, v = (t.bfloat16().float() for t in (q, k, v))
        mm = _bf16_products(terms)
    elif kind == "fp32":
        mm = torch.matmul
    else:
        def mm(a, b):
            return _tf32_matmul(a, b, terms, "trunc")
    want = ref.mlstm_scan_ref(q, k, v, il, fl, chunk=64)
    got = ref.mlstm_scan_ref(q, k, v, il, fl, chunk=64, matmul=mm)
    assert ((got - want).abs().max().item() <= 1e-4 * want.abs().max().item()) == holds


def test_mlstm_scan_bf16_gates_match_jax():
    """bf16 log gates: the wrapper takes them in fp32, as the Pallas kernel
    casts them.  Against the JAX wrapper (Pallas in interpret mode) on the
    same bf16 values, to :func:`test_mlstm_scan_matches_jax`'s 1e-4 of
    max |h|."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    q, k, v, il, fl = _mlstm_inputs(13, 2, 64, 2, 32)
    jil, jfl = (jnp.asarray(g).astype(jnp.bfloat16) for g in (il, fl))
    want, _ = jops.mlstm_scan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jil, jfl, chunk=16)
    til, tfl = (torch.from_numpy(g).to(torch.bfloat16) for g in (il, fl))
    got, none = ops.mlstm_scan(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               til, tfl, chunk=16)
    assert none is None and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) < 1e-4


def test_mlstm_scan_cpu_call_does_not_count_as_a_launch():
    before = ops.LAUNCHES["mlstm_scan"]
    ops.mlstm_scan(*[torch.from_numpy(a) for a in _mlstm_inputs(0, 1, 16, 2, 8)], chunk=8)
    assert ops.LAUNCHES["mlstm_scan"] == before


@pytest.mark.parametrize("bad, message", [
    (dict(chunk=0), "does not divide"),  # a chunk that does not divide L is halved
    (dict(f_shape=(1, 64, 3)), "shapes do not agree"),
    (dict(v_dtype=torch.float64), "dtypes differ"),
])
def test_mlstm_scan_rejects_bad_inputs(bad, message):
    q = k = torch.zeros(1, 64, 2, 8)
    v = torch.zeros(1, 64, 2, 8, dtype=bad.get("v_dtype", torch.float32))
    il, fl = torch.zeros(1, 64, 2), torch.zeros(bad.get("f_shape", (1, 64, 2)))
    with pytest.raises(ValueError, match=message):
        ops.mlstm_scan(q, k, v, il, fl, chunk=bad.get("chunk", 16))


# (B, L, H, P, chunk, input-gate shift) — the chip smoke's cases: the
# xlstm-1.3b forward's shape first, then serving-length prompts at batch 4,
# the CPU shapes, and strongly negative input gates
MLSTM_CUDA_CASES = [
    (1, 2048, 4, 1024, 128, 0.0),
    (4, 512, 4, 1024, 128, 0.0),
    (2, 64, 2, 32, 16, 0.0),
    (2, 128, 4, 16, 32, 0.0),
    (1, 200, 2, 64, 100, 0.0),
    (1, 64, 2, 64, 8, 0.0),
    (1, 64, 2, 32, 16, -100.0),
    # P not a multiple of 8 and a chunk not a multiple of 16 (the MMA tiles'
    # zero-fill and masks), and chunk 256 at the full P
    (1, 96, 2, 36, 24, 0.0),
    (1, 1024, 2, 1024, 256, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, h_rel", [("float32", 0.0), ("bfloat16", BF16_ULP / 2)])
@pytest.mark.parametrize("b, l, h, p, chunk, i_shift", MLSTM_CUDA_CASES)
def test_mlstm_scan_cuda_kernel_matches_plain_version(b, l, h, p, chunk, i_shift, dtype, h_rel):
    """Against the fp32 plain version on the same (bf16-valued) inputs: the
    kernel sums in fp32 and rounds h once, so each element of h is within
    ``h_rel`` of its |h| (half a bf16 ulp) plus 1e-4 of max |h| (order of
    summation); finite everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt_ = getattr(torch, dtype)
    q, k, v, il, fl = (torch.from_numpy(a).cuda()
                       for a in _mlstm_inputs(l + p, b, l, h, p, i_shift=i_shift))
    q, k, v = q.to(dt_), k.to(dt_), v.to(dt_)
    before = ops.LAUNCHES["mlstm_scan"]
    out, none = ops.mlstm_scan(q, k, v, il, fl, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_scan"] == before + 1 and none is None
    want = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), il, fl, chunk=chunk)
    assert out.dtype == dt_ and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    assert _err_over_tol(out.float().cpu().numpy(), want.cpu().numpy(), h_rel,
                         of_max=1e-4) <= 1


@pytest.mark.cuda
def test_mlstm_scan_cuda_takes_bf16_gates():
    """bf16 log gates launch (the wrapper casts them to fp32) and match the
    fp32 plain version on the same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, il, fl = (torch.from_numpy(a).cuda() for a in _mlstm_inputs(4, 1, 128, 2, 64))
    il, fl = il.bfloat16(), fl.bfloat16()
    out, _ = ops.mlstm_scan(q, k, v, il, fl, chunk=32)
    torch.cuda.synchronize()
    want = ref.mlstm_scan_ref(q, k, v, il.float(), fl.float(), chunk=32)
    assert _err_over_tol(out.cpu().numpy(), want.cpu().numpy(), 0.0, of_max=1e-4) <= 1


# -- head dims above 128, the tile pairs, the large chunks, the gate -------------

# (B, S, H, KH, D, causal, window): nemotron-4-340b's head dim 192 and
# paligemma-3b's 256, one ragged and non-causal
WIDE_CUDA_CASES = [
    (1, 512, 12, 1, 192, True, None),
    (1, 512, 8, 1, 256, True, None),
    (2, 300, 4, 2, 256, False, None),
    (1, 200, 4, 2, 160, True, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b, s, h, kh, d, causal, window", WIDE_CUDA_CASES)
def test_cuda_kernel_takes_head_dims_to_256(b, s, h, kh, d, causal, window, dtype, atol):
    test_cuda_kernel_matches_plain_version(b, s, h, kh, d, causal, window, dtype, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b, s, h, kh, d, causal", [
    (1, 300, 4, 4, 80, False), (1, 512, 16, 8, 128, True), (2, 200, 4, 2, 36, True)])
def test_cuda_kernel_at_every_tile_pair(b, s, h, kh, d, causal, dtype, atol):
    """Each tile pair the kernel is built for at this head dim, asked for by
    a schedule: launched as asked, within the tolerance of the plain
    version."""
    from repro_torch.kernels import schedule as ksched

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to("cuda", dt) for x in _inputs(s, b, s, h, kh, d))
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal).transpose(1, 2).float()
    pairs = [(bq, bk) for bq in ops.FLASH_Q_TILES for bk in ops.FLASH_KV_TILES
             if ops.flash_takes(d, dt, bq, bk)]
    assert len(pairs) >= 2
    for bq, bk in pairs:
        sink = {}
        with ksched.record_kernel_calls(sink):
            out = ops.flash_attention(q, k, v, causal=causal,
                                      schedule=ksched.KernelSchedule(block_q=bq, block_kv=bk))
        torch.cuda.synchronize()
        (call,) = sink.values()
        assert call["launched"] == {"block_q": bq, "block_kv": bk}
        assert (out.float() - want).abs().max().item() <= atol, (bq, bk)


@pytest.mark.cuda
def test_cuda_flash_tile_rule_is_the_kernels():
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    takes = ops.bind_flash_takes(build.load("flash_attention"))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in range(4, 261, 4):
            for bq in (32, 64, 128, 256):
                for bk in (16, 32, 64, 128, 256):
                    assert bool(takes(d, code, bq, bk)) == ops.flash_takes(d, dtype, bq, bk)


def _hold_to_float64(q, k, v, il, fl, chunk):
    """One launch of the kernel, held to the float64 plain version: each
    element of h within the dtype's tolerance (half a bf16 ulp of |h| in
    bf16, plus 1e-4 of max |h|) plus twice the fp32 plain version's own
    error there."""
    before = ops.LAUNCHES["mlstm_scan"]
    out, _ = ops.mlstm_scan(q, k, v, il, fl, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_scan"] == before + 1
    plain = ref.mlstm_scan_ref(q.float(), k.float(), v.float(), il, fl, chunk=chunk).double()
    exact = ref.mlstm_scan_ref(q.double(), k.double(), v.double(), il.double(), fl.double(),
                               chunk=chunk, dtype=torch.float64)
    h_rel = BF16_ULP / 2 if q.dtype == torch.bfloat16 else 0.0
    tol = h_rel * exact.abs() + 1e-4 * exact.abs().max() + 2 * (plain - exact).abs()
    assert bool(torch.isfinite(out.float()).all())
    assert ((out.double() - exact).abs() / tol).max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [512, 1024])
def test_mlstm_scan_cuda_takes_the_largest_chunks(chunk, dtype):
    """Chunks 512 and 1024 at P = 1024 (v, in bf16 w v, streamed through the
    state pass), held to the float64 plain version (:func:`_hold_to_float64`),
    since over 512 or 1024 terms fp32 arithmetic in the plain version's
    order already misses the exact h by up to 2.6 times 1e-4 of max |h| on
    rows whose denominator cancels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt_ = getattr(torch, dtype)
    q, k, v, il, fl = (torch.from_numpy(a).cuda()
                       for a in _mlstm_inputs(chunk, 1, 2048, 2, 1024))
    _hold_to_float64(q.to(dt_), k.to(dt_), v.to(dt_), il, fl, chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("b, l, h, p, chunk", [(1, 2048, 4, 1024, 128), (1, 96, 2, 36, 24)])
def test_mlstm_scan_cuda_fp32_holds_float64(b, l, h, p, chunk):
    """The fp32 path at the xlstm-1.3b forward's shape and at a P and chunk
    that are not whole tiles, held to the float64 plain version
    (:func:`_hold_to_float64`): it may miss the exact h by no more than the
    tolerance plus twice what fp32 arithmetic in the plain version's order
    misses it by."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, il, fl = (torch.from_numpy(a).cuda() for a in _mlstm_inputs(l + p + 1, b, l, h, p))
    _hold_to_float64(q, k, v, il, fl, chunk)


@pytest.mark.cuda
def test_process_backend_latencies_match_serial_on_the_card(tmp_path):
    """The cross-process measurement gate: the same candidates measured on
    the card by two spawned workers of the process backend and by the
    serial backend take the same time within 5% (two workers timing each
    other's forwards would not)."""
    from repro_torch.explorer.explorer import Explorer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    space = {
        "input": [1024, 1024], "output": 4,
        "sequence": [
            {"block": "mixer", "op_candidates": ["ssm", "attention"],
             "type_repeat": {"type": "vary_all", "depth": [1, 2]},
             "ssm": {"impl": ["pallas"], "d_state": [64], "d_head": [64], "expand": [2]},
             "attention": {"impl": ["pallas"], "heads": [16]}},
            {"block": "pool", "op_candidates": "global_avg_pool"},
            {"block": "head", "op_candidates": "linear", "linear": {"width": [64]}},
        ],
    }

    def run(backend, workers):
        raw = {"name": f"gate-{backend}", "search_space": space,
               "sampler": {"name": "random", "seed": 0},
               "executor": {"backend": backend, "n_workers": workers},
               "criteria": [{"estimator": "latency_s", "params": {"batch": 4}}],
               "target": "h100", "budget": {"n_trials": 6}, "report_dir": str(tmp_path)}
        explorer = Explorer.from_dict(raw)
        explorer.run(save_report=False)
        return {t.user_attrs["signature"]: t.user_attrs["latency_s"]
                for t in explorer.study.trials}

    serial, process = run("serial", 1), run("process", 2)
    print({sig: (serial[sig], process.get(sig)) for sig in serial})
    assert serial.keys() == process.keys()
    for sig, latency in serial.items():
        assert abs(process[sig] / latency - 1) <= 0.05, (sig, latency, process[sig])


def _grad_inputs(device):
    """Small inputs of each kernel, every float tensor requiring a gradient."""
    gen = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=gen).to(device).requires_grad_(True)

    return {
        "flash_attention": (lambda *a: ops.flash_attention(*a, causal=True),
                            (t(1, 16, 2, 16), t(1, 16, 1, 16), t(1, 16, 1, 16))),
        "ssm_scan": (lambda x, dt, a, b, c: ops.ssm_scan(x, dt.abs(), -a.abs(), b, c, chunk=8),
                     (t(1, 16, 2, 8), t(1, 16, 2), t(2), t(1, 16, 1, 8), t(1, 16, 1, 8))),
        "mlstm_scan": (lambda q, k, v, i, f: ops.mlstm_scan(q, k, v, i, -f.abs(), chunk=8),
                       (t(1, 16, 2, 8), t(1, 16, 2, 8), t(1, 16, 2, 8), t(1, 16, 2),
                        t(1, 16, 2))),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan", "mlstm_scan"])
def test_plain_versions_stay_differentiable(kernel):
    """On the CPU a wrapper runs its plain version, which autograd goes
    through: the gradient guard is the CUDA kernels' alone."""
    fn, args = _grad_inputs("cpu")[kernel]
    out = fn(*args)
    out = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(out.square().sum(), args, allow_unused=True)
    assert out.grad_fn is not None
    assert all(g is not None and torch.isfinite(g).all() for g in grads[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan", "mlstm_scan"])
def test_cuda_kernels_refuse_to_cut_a_gradient(kernel):
    """A forward-only kernel on inputs that need a gradient raises, saying
    that training runs on impl="xla" as the reference's does, and launches
    nothing; under no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn, args = _grad_inputs("cuda")[kernel]
    before = ops.LAUNCHES[kernel]
    with pytest.raises(NotImplementedError, match='forward-only.*impl="xla"'):
        fn(*args)
    assert ops.LAUNCHES[kernel] == before
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
