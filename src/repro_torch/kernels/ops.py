"""Checked wrappers around the CUDA kernels (flash attention, the SSD scan,
the mLSTM scan).

Each public op first resolves its kernel schedule as the JAX package's
``kernels/ops.py`` does, with the same precedence:

  explicit ``schedule=``  >  active ``use_schedules`` context
      >  legacy block/chunk kwargs  >  the named ``default`` schedule.

Legacy kwargs stay unvalidated (call sites derive them from shapes, e.g. a
decrement-clamped chunk); the effective schedule clamps the blocks to the
sequence and halves a chunk until it divides the sequence, and every call
is recorded through :func:`repro_torch.kernels.schedule.note_kernel_call`
with its requested and effective schedules and the tiles it launches.
The CUDA flash kernel is built for a set of tile pairs at each head dim
(:func:`flash_takes`); :func:`flash_launch_tiles` maps the effective blocks
onto the largest built pair at or below them.  Then the wrapper checks
shapes, dtypes and devices, and calls its registered op
(``torch.ops.repro_torch.flash_attention``, ``::ssm_scan``,
``::mlstm_scan``) with the schedule's tiles or chunk as ints.  The op
makes the device choice:

* on CPU tensors, it runs the kernel's plain PyTorch version from
  :mod:`repro_torch.kernels.ref` (that is how the CPU tests reach it);
* on CUDA tensors, it checks dtype and layout and launches the kernel on
  the current stream, or raises.  There is no fallback: a failed build or
  launch is an error;
* on ``meta`` and fake tensors (the autotuner's discovery pass, the
  counted forward, ``torch.export``), its fake implementation returns
  empty outputs of the right shapes: nothing is computed or launched.

Because the launch sits behind a registered op, ``torch.export`` records
the op, tiles included, in the program it traces, and a program loaded
in another process launches the same kernel; that process must import
this module first, which registers the ops.  ``LAUNCHES[name]`` counts
the kernel launches each op made, so a run, or a loaded program, can
show that its main path went through the kernels.  The kernels are
forward-only: on CUDA a wrapper refuses inputs that would need a
gradient through it (:func:`_refuse_grad`), rather than return outputs
that silently cut it; on the CPU the op's gradient is the plain
version's.  :func:`kernel_work` gives the operations and bytes
of one call, from its recorded shapes: the bound ``chip_smoke.py`` holds
each kernel to and the kernels' share of ``metric: modelled``.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import schedule as ksched
from repro_torch.kernels.schedule import KernelSchedule

LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_MAX_D = 256


def _resolve(kernel, schedule, legacy):
    """The precedence in the module docstring; returns a fully populated
    (every size field set) KernelSchedule."""
    if schedule is not None:
        return ksched.as_schedule(kernel, schedule)
    active = ksched.active_schedule(kernel)
    if active is not None:
        return active
    legacy = {k: v for k, v in legacy.items() if v is not None}
    if legacy:
        # call-site kwargs: unvalidated by design (shape-derived values)
        return KernelSchedule(**legacy).merged_over(ksched.default_schedule(kernel))
    return ksched.default_schedule(kernel)


# both pure: cached, since a served prefill calls the wrapper once a layer
# and the kernel at short prompts is shorter than the wrapper's host path
_effective = functools.lru_cache(maxsize=4096)(ksched.effective_schedule)


def _dtype_name(dtype: torch.dtype) -> str:
    """A dtype as the JAX package names it ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """A CUDA kernel has no backward: its output would carry no
    ``grad_fn``, and every weight before it would get no gradient without
    a word.  So a call that autograd would differentiate is refused."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: the CUDA kernel is forward-only (the reference's Pallas "
            f"kernel has no gradient either) and an input requires a gradient; "
            f"train on impl=\"xla\", as the reference does. Run the kernel under "
            f"torch.no_grad() or inference_mode, or on the CPU, where the plain "
            f"version is differentiable")


def _plain_backward(op, name: str, plain, n_grad: int) -> None:
    """Register ``op``'s autograd formula: the gradient of its plain
    version, recomputed from the saved inputs (the first ``n_grad`` are
    tensors).  Only the CPU reaches it (on CUDA the wrappers refuse a
    gradient first)."""
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:n_grad])
        ctx.rest = inputs[n_grad:]

    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        if any(t.device.type != "cpu" for t in saved):
            raise NotImplementedError(f"{name}: the CUDA kernel is forward-only")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            outs = plain(*leaves, *ctx.rest)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                      [g for _, g in pairs], allow_unused=True)
        return (*got, *([None] * len(ctx.rest)))

    op.register_autograd(backward, setup_context=setup_context)


def _flash_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """The (q, k) pairs the mask of ``nn.attention.make_mask`` (no q offset)
    admits: for query i, keys j <= i when causal and j > i - window."""
    pairs = 0
    for i in range(s):
        hi = min(t - 1, i) if causal else t - 1
        lo = max(0, i - window + 1) if window is not None else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def kernel_work(kernel: str, shapes, meta, effective: KernelSchedule):
    """(operations, bytes) of one call of ``kernel`` at the recorded
    ``shapes`` (name -> shape, as :func:`note_kernel_call` records them),
    ``meta`` (dtype and masks) and ``effective`` schedule (a scan's chunk).
    Bytes: every input read once and every output written once.

    * ``flash_attention``: 4 B H D per attended (q, k) pair (the two
      products), the pairs taken from the mask; q, k, v and the output.
    * ``ssm_scan``: for each batch and chunk of Q, the C B^T entries on or
      below the diagonal once per group (Q (Q + 1) N: a group's heads share
      them); for each head their product with x (Q (Q + 1) P), then C S
      and the state update (4 Q N P); x, B, C in the input dtype, dt, a
      and the final state in fp32, y in the input dtype.
    * ``mlstm_scan``: for each (batch, head) and chunk of Q, the q k^T
      panel and its product with v on or below the diagonal (2 Q (Q + 1)
      P), q C and the C update (4 Q P^2), q . n and the n update (4 Q P);
      q, k, v and h in the input dtype, the two gates in fp32.

    The masked half of a panel is not work."""
    esize = getattr(torch, meta.get("dtype", "float32")).itemsize
    if kernel == "flash_attention":
        b, s, h, d = shapes["q"]
        t = shapes["k"][1]
        flops = 4 * b * h * d * _flash_pairs(s, t, bool(meta.get("causal", True)),
                                             meta.get("window"))
        nbytes = esize * (2 * b * s * h * d + 2 * b * t * shapes["k"][2] * d)
        return flops, nbytes
    q = effective.chunk
    if kernel == "ssm_scan":
        b, l, h, p = shapes["x"]
        g, n = shapes["b"][2], shapes["b"][3]
        flops = b * (l // q) * (g * q * (q + 1) * n + h * (q * (q + 1) * p + 4 * q * n * p))
        nbytes = esize * (2 * b * l * h * p + 2 * b * l * g * n) + 4 * (b * l * h + h + b * h * n * p)
        return flops, nbytes
    if kernel == "mlstm_scan":
        b, l, h, p = shapes["q"]
        flops = b * h * (l // q) * (2 * q * (q + 1) * p + 4 * q * p * p + 4 * q * p)
        nbytes = esize * 4 * b * l * h * p + 4 * 2 * b * l * h
        return flops, nbytes
    raise ksched.ScheduleError(f"no work formula for kernel {kernel!r}")


# the tile pairs the CUDA flash kernel is instantiated for, before the
# shared-memory and register rule of flash_takes
FLASH_Q_TILES = (64, 128)
FLASH_KV_TILES = (32, 64, 128)
_MAX_SMEM = 232448


def _flash_dk(d: int) -> int:
    """The head dim the kernel is built for: D padded to a multiple of 16 up
    to 128, of 32 above."""
    return -(-d // 16) * 16 if d <= 128 else -(-d // 32) * 32


def flash_takes(d: int, dtype: torch.dtype, block_q: int, block_kv: int) -> bool:
    """Whether the CUDA flash kernel is built for head dim ``d`` in ``dtype``
    with (``block_q``, ``block_kv``) tiles: the pair must fit one block's
    shared memory (the Q tile and two stages of K and V tiles, rows padded
    by 16 bytes) and the registers (the fp32 accumulators a thread holds,
    ``MT (DK + BK) / 2`` with MT = block_q / 64, plus fp32's split operands
    or bf16's held Q fragments, at most 152).  ``takes()`` in
    ``csrc/flash_attention.cu`` is the same rule; ``chip_smoke.py`` holds
    the two to each other."""
    if dtype not in _DTYPES or d <= 0 or d % 4 or d > _FLASH_MAX_D:
        return False
    if block_q not in FLASH_Q_TILES or block_kv not in FLASH_KV_TILES:
        return False
    es, dk, mt = (4 if dtype == torch.float32 else 2), _flash_dk(d), block_q // 64
    extra = 8 * mt if es == 4 else (dk // 4 if mt == 1 and 96 < dk <= 128 else 0)
    smem = (block_q + 4 * block_kv) * (dk + 16 // es) * es
    return smem <= _MAX_SMEM and mt * (dk + block_kv) // 2 + extra <= 152


@functools.lru_cache(maxsize=None)
def flash_launch_tiles(block_q: int, block_kv: int, d: int, dtype: torch.dtype):
    """The (block_q, block_kv) tile pair the CUDA kernel launches for an
    effective schedule: the largest query tile it is built for at or below
    ``block_q`` (the smallest where none is), then the largest KV tile built
    with it at or below ``block_kv`` (likewise).  None for a head dim or
    dtype the kernel does not take."""
    pairs = [(bq, bk) for bq in FLASH_Q_TILES for bk in FLASH_KV_TILES
             if flash_takes(d, dtype, bq, bk)]
    if not pairs:
        return None
    qs = sorted({bq for bq, _ in pairs})
    bq = max((q for q in qs if q <= block_q), default=qs[0])
    ks = sorted(bk for q, bk in pairs if q == bq)
    bk = max((k for k in ks if k <= block_kv), default=ks[0])
    return bq, bk


def bind_flash(lib: ctypes.CDLL):
    """The C entry point of a built ``flash_attention.cu``, typed."""
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bind_flash_takes(lib: ctypes.CDLL):
    """``repro_flash_attention_takes(D, dtype, block_q, block_kv)`` of a
    built ``flash_attention.cu``, typed: the kernel's own answer to
    :func:`flash_takes`."""
    fn = lib.repro_flash_attention_takes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _flash_fn():
    """The kernel's C entry point, loaded and typed once."""
    return bind_flash(build.load("flash_attention"))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    schedule: Optional[KernelSchedule] = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, KH, D) [model layout] -> (B, S, H, D).

    GQA when H is a multiple of KH (kv head = h // (H // KH)).  Masks are
    those of :func:`repro_torch.nn.attention.make_mask` with no q offset.
    The tiles come from the resolved schedule (module docstring).
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,T,KH,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         f"agree on batch and head dim, or H % KH != 0")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    requested = _resolve("flash_attention", schedule,
                         {"block_q": block_q, "block_kv": block_kv})
    eff = _effective("flash_attention", requested, seq_len=s, kv_len=t)
    tiles = (flash_launch_tiles(eff.block_q, eff.block_kv, d, q.dtype)
             if q.device.type != "cpu" else None)
    ksched.note_kernel_call(
        "flash_attention", requested, eff,
        shapes={"q": q.shape, "k": k.shape, "v": v.shape},
        meta={"causal": causal, "window": window, "scale": scale,
              "dtype": _dtype_name(q.dtype)},
        launched=None if tiles is None else {"block_q": tiles[0], "block_kv": tiles[1]})
    scale = float(scale) if scale is not None else d ** -0.5
    if q.device.type == "cuda":
        _refuse_grad("flash_attention", q, k, v)
    block_q, block_kv = tiles if tiles is not None else (0, 0)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), window, scale,
                                                 block_q, block_kv)


def _flash_plain(q, k, v, causal, window, scale, block_q, block_kv):
    out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window, scale=scale)
    return out.transpose(1, 2).contiguous()


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int], scale: float, block_q: int,
              block_kv: int) -> torch.Tensor:
    """The flash kernel's launch with (``block_q``, ``block_kv``) tiles
    (0, 0: none is built for this head dim and dtype), or on the CPU its
    plain version.  :func:`flash_attention` is the checked entry point."""
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal, window, scale, block_q, block_kv)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    if d % 4 or d > _FLASH_MAX_D or block_q == 0:
        raise ValueError(f"the CUDA kernel takes a head dim that is a multiple "
                         f"of 4 and at most {_FLASH_MAX_D}, not {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(stride {x.stride(3)})")
        if x.data_ptr() % (4 * x.element_size()) or any(st % 4 for st in x.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on a 4-element boundary: "
                             f"the kernel moves 4 elements a load (strides "
                             f"{x.stride()})")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _flash_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, s, t, h, kh, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), 0 if window is None else int(window), scale,
            block_q, block_kv, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} "
                           f"(tiles {(block_q, block_kv)} at D={d}, {q.dtype})")
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, scale, block_q, block_kv):
    return q.new_empty(q.shape)


_plain_backward(_flash_op, "flash_attention", _flash_plain, 3)


def bind_ssm(lib: ctypes.CDLL):
    """The C entry points of a built ``ssm_scan.cu`` (the scan, the floats
    of scratch it needs, the bytes of shared memory a block of it needs),
    typed."""
    fn = lib.repro_ssm_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    floats = lib.repro_ssm_scan_scratch_floats
    floats.argtypes = [ctypes.c_int] * 5
    floats.restype = ctypes.c_longlong
    smem = lib.repro_ssm_scan_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return fn, floats, smem


def _scan_chunk(kernel, schedule, chunk, seq_len, device, dtype, shapes) -> int:
    """Resolve a scan's schedule, record the call, and return the effective
    chunk (which divides ``seq_len``)."""
    if chunk is not None and chunk <= 0:
        raise ValueError(f"chunk {chunk} does not divide the sequence {seq_len}: "
                         f"a chunk is positive")
    requested = _resolve(kernel, schedule, {"chunk": chunk})
    eff = _effective(kernel, requested, seq_len=seq_len)
    ksched.note_kernel_call(kernel, requested, eff, shapes=shapes,
                            meta={"dtype": _dtype_name(dtype)},
                            launched=None if device.type == "cpu" else {"chunk": eff.chunk})
    return eff.chunk


@functools.cache
def _ssm_fns():
    return bind_ssm(build.load("ssm_scan"))


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_grouped: torch.Tensor, c_grouped: torch.Tensor, *,
             chunk: Optional[int] = None, schedule: Optional[KernelSchedule] = None):
    """Mamba2 SSD scan.  x: (B, L, H, P); dt: (B, L, H); a: (H,);
    b/c: (B, L, G, N), group layout (head h reads group h // (H // G)).
    Returns (y (B, L, H, P) in x's dtype, final state (B, H, N, P) fp32).

    The chunk is the resolved schedule's (module docstring), halved until
    it divides L.  dt and a may be of any float dtype: they are
    taken in fp32, as the Pallas kernel takes them.  One call counts one
    launch, though in fp32 the kernel is two CUDA launches (the chunks'
    panels, then the scan).
    """
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_grouped.dim() != 4:
        raise ValueError(f"expected x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,G,N); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b_grouped.shape)}")
    bsz, l, h, p = x.shape
    g, n = b_grouped.shape[2], b_grouped.shape[3]
    if (tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,)
            or tuple(b_grouped.shape[:2]) != (bsz, l)
            or c_grouped.shape != b_grouped.shape or g == 0 or h % g):
        raise ValueError(f"shapes do not agree, or G does not divide H: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b_grouped.shape)}, c {tuple(c_grouped.shape)}")
    chunk = _scan_chunk("ssm_scan", schedule, chunk, l, x.device, x.dtype, {
        "x": x.shape, "dt": dt.shape, "a": a.shape, "b": b_grouped.shape,
        "c": c_grouped.shape})
    tensors = (x, dt, a, b_grouped, c_grouped)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"devices differ: {[str(t.device) for t in tensors]}")
    if not (x.dtype == b_grouped.dtype == c_grouped.dtype):
        raise ValueError(f"x, b, c dtypes differ: {x.dtype}, {b_grouped.dtype}, "
                         f"{c_grouped.dtype}")

    if x.device.type == "cuda":
        _refuse_grad("ssm_scan", *tensors)
    return torch.ops.repro_torch.ssm_scan(x, dt, a, b_grouped, c_grouped, chunk)


def _ssm_plain(x, dt, a, b_grouped, c_grouped, chunk):
    y, state = ref.ssm_scan_ref(x, dt, a, b_grouped, c_grouped, chunk=chunk)
    return y.contiguous(), state.contiguous()


@torch.library.custom_op("repro_torch::ssm_scan", mutates_args=())
def _ssm_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_grouped: torch.Tensor,
            c_grouped: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan kernel's launch at ``chunk``, or on the CPU its plain
    version.  :func:`ssm_scan` is the checked entry point."""
    if x.device.type == "cpu":
        return _ssm_plain(x, dt, a, b_grouped, c_grouped, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
    bsz, l, h, p = x.shape
    g, n = b_grouped.shape[2], b_grouped.shape[3]
    if x.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {x.dtype}")
    for name, t in (("x", x), ("b", b_grouped), ("c", c_grouped)):
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}'s last dim must be contiguous (stride {t.stride(3)})")
    fn, floats, smem = _ssm_fns()
    if smem(n, chunk, _DTYPES[x.dtype]) < 0:
        raise ValueError(
            f"the CUDA kernel takes N up to 256 (a warp holds a quarter of the state's "
            f"rows in registers) and an (N, chunk) whose staged tiles fit one block's "
            f"227 KB of shared memory (in fp32 every chunk up to 1024 at N up to 144), "
            f"not N={n}, chunk={chunk} in {x.dtype}")
    dt, a = dt.float(), a.float().contiguous()
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    if bsz == 0:
        return y, state
    scratch = torch.empty((max(1, floats(bsz, l, g, chunk, _DTYPES[x.dtype])),),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_grouped.data_ptr(),
                 c_grouped.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
                 _DTYPES[x.dtype],
                 bsz, l, h, g, n, p, chunk,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2),
                 b_grouped.stride(0), b_grouped.stride(1), b_grouped.stride(2),
                 c_grouped.stride(0), c_grouped.stride(1), c_grouped.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["ssm_scan"] += 1
    return y, state


@_ssm_op.register_fake
def _ssm_fake(x, dt, a, b_grouped, c_grouped, chunk):
    bsz, l, h, p = x.shape
    n = b_grouped.shape[3]
    return x.new_empty((bsz, l, h, p)), x.new_empty((bsz, h, n, p), dtype=torch.float32)


_plain_backward(_ssm_op, "ssm_scan", _ssm_plain, 5)


_MLSTM_MAX_P = 1024


def bind_mlstm(lib: ctypes.CDLL):
    """The C entry points of a built ``mlstm_scan.cu`` (the scan, the floats
    of scratch it needs), typed."""
    fn = lib.repro_mlstm_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 15 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    floats = lib.repro_mlstm_scan_scratch_floats
    floats.argtypes = [ctypes.c_int] * 5
    floats.restype = ctypes.c_longlong
    return fn, floats


@functools.cache
def _mlstm_fns():
    return bind_mlstm(build.load("mlstm_scan"))


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_log: torch.Tensor, f_log: torch.Tensor, *,
               chunk: Optional[int] = None, schedule: Optional[KernelSchedule] = None):
    """Chunkwise mLSTM (the xLSTM matrix memory).  q/k/v: (B, L, H, P);
    i_log/f_log: (B, L, H) log-space gates.  Returns (h (B, L, H, P) in
    q's dtype, None), as the JAX package's ``ops.mlstm_scan`` does.

    The chunk is the resolved schedule's (module docstring), halved until
    it divides L.  The gates may be of any float dtype: they are
    taken in fp32, as the Pallas kernel takes them.  One call counts one
    launch, though the kernel is two CUDA launches (the chunks' panels, then
    the state).
    """
    if q.dim() != 4 or i_log.dim() != 3:
        raise ValueError(f"expected q/k/v (B,L,H,P) and i_log/f_log (B,L,H); got "
                         f"{tuple(q.shape)}, {tuple(i_log.shape)}")
    bsz, l, h, p = q.shape
    if (k.shape != q.shape or v.shape != q.shape or tuple(i_log.shape) != (bsz, l, h)
            or f_log.shape != i_log.shape):
        raise ValueError(f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, i_log {tuple(i_log.shape)}, "
                         f"f_log {tuple(f_log.shape)}")
    chunk = _scan_chunk("mlstm_scan", schedule, chunk, l, q.device, q.dtype, {
        "q": q.shape, "k": k.shape, "v": v.shape, "i_log": i_log.shape,
        "f_log": f_log.shape})
    tensors = (q, k, v, i_log, f_log)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"devices differ: {[str(t.device) for t in tensors]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")

    if q.device.type == "cuda":
        _refuse_grad("mlstm_scan", *tensors)
    return torch.ops.repro_torch.mlstm_scan(q, k, v, i_log, f_log, chunk), None


def _mlstm_plain(q, k, v, i_log, f_log, chunk):
    return ref.mlstm_scan_ref(q, k, v, i_log, f_log, chunk=chunk).contiguous()


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=())
def _mlstm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_log: torch.Tensor,
              f_log: torch.Tensor, chunk: int) -> torch.Tensor:
    """The mLSTM scan kernel's launch at ``chunk``, or on the CPU its plain
    version.  :func:`mlstm_scan` is the checked entry point."""
    if q.device.type == "cpu":
        return _mlstm_plain(q, k, v, i_log, f_log, chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cuda or cpu, not {q.device}")
    bsz, l, h, p = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}")
    if p % 4 or p > _MLSTM_MAX_P:
        raise ValueError(f"the CUDA kernel takes a head dim that is a multiple of 4 "
                         f"and at most {_MLSTM_MAX_P} (xlstm-1.3b's), not P={p}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride {x.stride(3)})")
        if x.data_ptr() % (4 * x.element_size()) or any(st % 4 for st in x.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on a 4-element boundary: the "
                             f"kernel moves 4 elements a load (strides {x.stride()})")
    i_log, f_log = i_log.float(), f_log.float()
    out = torch.empty((bsz, l, h, p), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn, floats = _mlstm_fns()
    scratch = torch.empty((floats(bsz, l, h, p, chunk),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i_log.data_ptr(),
                 f_log.data_ptr(), out.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype],
                 bsz, l, h, p, chunk,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 i_log.stride(0), i_log.stride(1), i_log.stride(2),
                 f_log.stride(0), f_log.stride(1), f_log.stride(2), stream)
    if err != 0:
        raise RuntimeError(
            f"mlstm_scan kernel launch failed: CUDA error {err} (1 is an invalid value: "
            f"the kernel also refuses a chunk whose state pass does not fit one "
            f"block's shared memory with v streamed, which at P=1024 is a chunk "
            f"above 2048; every chunk a schedule allows, up to 1024, fits)")
    LAUNCHES["mlstm_scan"] += 1
    return out


@_mlstm_op.register_fake
def _mlstm_fake(q, k, v, i_log, f_log, chunk):
    return q.new_empty(q.shape)


_plain_backward(_mlstm_op, "mlstm_scan", _mlstm_plain, 5)
