// Chunkwise mLSTM (xLSTM matrix memory) scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mlstm_scan.py::mlstm_scan_blhp (body
// _mlstm_kernel).  What it computes is the same: for each (batch, head) the
// sequence is cut into chunks of Q steps.  With fcum the inclusive cumsum of
// the log forget gates f inside a chunk, ftot its last value, i the log
// input gates, k scaled by P^-1/2, and the state (C (P, P), n (P,), m)
// entering the chunk (C = 0, n = 0, m = -1e6 before the first):
//   a_ij = fcum_i - fcum_j + i_j (j <= i),  b_i = fcum_i + m
//   m_i  = max(max_j a_ij, b_i, -1e6)
//   S_ij = (q_i . k_j) exp(a_ij - m_i)                (masked before exp)
//   h_i  = (S v + exp(b_i - m_i) q_i C)_i / max(|sum_j S_ij + exp(b_i - m_i) q_i . n|, exp(-m_i))
//   w_j  = ftot - fcum_j + i_j,  m' = max(ftot + m, max_j w_j, -1e6)
//   C   <- exp(ftot + m - m') C + sum_j exp(w_j - m') k_j^T v_j,  n likewise,  m <- m'
// exp(-m_i) is inf where m_i < -88 (strongly negative input gates): the
// denominator is then inf and h is 0, as in the Pallas kernel.  IEEE expf and
// division throughout (no fast math).
//
// Translation.  The Pallas kernel holds C, n, m in VMEM scratch across the
// sequential chunk axis of a (batch, head, chunk) grid.  At the xlstm-1.3b
// width (P = 1024) C is 4 MB of fp32 per (batch, head), far more than a
// block's 227 KB of shared memory, and one block per (batch, head) would put
// 4 blocks on 132 SMs.  The value columns of C and h are independent: only
// the panel q k^T, its row sums, q . n and the stabiliser are shared across
// them.  So a call is two launches in both paths: a panel pass (the chunks'
// stabilised, masked panels S, their row sums, the per-row scalars and the
// chunk's n update u = sum_j k_j P^-1/2 exp(w_j - m'), all chunks in
// parallel; the scalar m chain over the gates is run by every block up to its
// chunk), then a state pass, one block per (batch, head, 32 value columns),
// that loops over the chunks in order with its (P, 32) slice of C (128 KB at
// P = 1024) and n in shared memory: h = S v + exp(b - m) q C, then the state
// update.  The panel, u and the scalars are computed once per chunk, not once
// per column block; only panel tiles on or below the diagonal are computed.
//
// bf16 inputs (namespace tc): the four products, q k^T, q C, S v and the
// update k^T (w v) (the state weights and P^-1/2 moved onto v), run on the
// tensor cores with mma.sync m16n8k16 and fp32 accumulation.  q, k and v are
// exact in bf16 and go in unsplit (q k^T is one product).  The fp32 operand
// (C, S or w v) is split into two bf16 terms, x = hi + lo with hi = bf16(x),
// so each of those products is two MMAs and keeps about 16 bits of that
// operand; w v is split once a chunk into shared memory, C and S as their
// fragments are loaded.  Rounding any of them to bf16 once misses the 1e-4
// tolerance (tests/test_torch_kernels.py models both).  The panel pass is one
// block of 4 warps per (batch, head, chunk, 64 x 64 tile on or below the
// diagonal): 3 blocks a chunk at Q = 128, 192 at the forward shape, where the
// fp32 path has 128; the diagonal tile's upper right quarter is skipped and
// the tiles above the diagonal are neither computed nor written.  The state
// pass has 8 warps, each 32 x 16 of a 128-row block of h and 32 x 32 of a
// 256-row block of the C update.  Tiles of q, k, v and S come from L2
// through a two-stage cp.async ring in dynamic shared memory, bf16 tiles as
// bf16, read by ldmatrix (rows padded 16 bytes) or, for the fp32 C slice,
// by scalar loads with its columns swizzled by row; a staged tile's products
// go into a fresh accumulator added to the total in fp32, since the tensor
// cores add into their accumulator with truncation.
// chip_smoke.py drives this path through the xlstm-1.3b forward with bf16
// weights (its xlstm_forward_bf16 phase).
//
// fp32 inputs (namespace simt): the products on the CUDA cores, each output
// one fp32 FMA chain in the order of the plain version's fp32 matrix
// products (ascending over P or over the chunk; above chunk 416 at P = 1024,
// a fresh sum a staged tile of 32 steps, added in order, and the gates'
// cumsum in double), and every other sum in its first version's order, so
// that h is bit for bit what this path gave before it was restructured (at
// chunks up to 416).  The xlstm-1.3b forward's logits check
// (chip_smoke.py's xlstm_forward phase: the same weights' impl="xla" forward
// in float64, within 1e-3 of max |logits| plus twice the fp32 impl="xla"
// forward's own error) passes no tensor-core version: over four draws of
// weights and tokens split-TF32 (m16n8k8, hi*hi + hi*lo + lo*hi) read 0.78,
// 3.8, 0.42 and 317 of it, fp64 mma.sync (m16n8k8, exact products, fp64
// sums) 1.27, 1.39, 0.60 and 314, and this order 0.29, 0.45, 0.39 and 0.50;
// both held the kernel's own 1e-4 tolerance at the forward's shape (PERF.md;
// scripts/mlstm_variants.py, scripts/xlstm_logits_variants.py).  Noise of
// 1e-7 of max |h| on its mLSTM outputs moves that model's logits 24.6 times
// 1e-3 of their max, so only a kernel that rounds as cuBLAS's fp32 products
// do stays inside the check on every draw.
// The structure is rebuilt for parallelism: the panel pass is one block per
// (batch, head, chunk, 64 chunk rows), 128 at the forward shape, which walks
// its row's panel tiles on or below the diagonal in order, carrying its
// rows' partial row sums from tile to tile; the m chain is run 8 chunks a
// round, a warp a chunk.  In the state pass each warp updates its own 128
// rows of C, 8 x 8 a lane, from its own two-stage cp.async ring of k (no
// barrier across the block; scaled in place by the lane that copied it), v
// lands by cp.async while the chunk's scalars are read, and the other
// contractions keep two staged tiles in flight through registers (q read by
// rows, eight threads a row, and stored transposed and swizzled).
//
// Bound.  At the forward shape of xlstm-1.3b (B = 1, L = 2048, H = 4,
// P = 1024, Q = 128) a call is about 36.6 GFLOP of products (2 Q (Q + 1) P +
// 4 Q P^2 + 4 Q P per chunk and head: the panel and S v on or below the
// diagonal, q C, the C update, q . n and the n update) and moves about
// 0.13 GB (fp32), so on the H100 it is bound by operations: 0.222 ms at
// split-TF32's 165 TFLOP/s (chip_smoke.py's fp32 bound; 0.55 ms at the CUDA
// cores' 67), 0.037 ms in bf16 at 989 TFLOP/s.
//
// What still holds it back (PERF.md has the measured times): every one of
// the 32 column blocks of a head streams the whole chunk's q and k from L2
// (about 1.1 GB a call in bf16, twice that in fp32), and the state pass is
// one block of 8 warps a SM (C's slice fills shared memory), so copies and
// products overlap only in part; a thread-block cluster sharing the staged
// tiles would divide the streaming.  In bf16, mma.sync, not wgmma; every
// thread issues copies.  In fp32, q C and S v are 4 x 4 a thread (a round
// of h is 128 x 32) and wait on a block barrier a staged tile: taking the
// products out of the state pass leaves about half its time (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float BIG_NEG = -1e6f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_P = 1024;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

// -- PTX wrappers ------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies BYTES from global to shared memory asynchronously; with !valid the
// destination is zero-filled and nothing is read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until none of this thread's committed copy groups is pending.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most the newest of this thread's committed groups is pending.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a b on a 16x8x16 bf16 tile, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- end of PTX wrappers -----------------------------------------------------

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// x0, x1 as two bf16 terms each: hi = bf16(x), lo = bf16(x - hi), packed in
// pairs (x0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// 4 consecutive elements as fp32; p is aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc += t, element by element
__device__ __forceinline__ void add_tile(float (&acc)[4][4], const float (&t)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += t[r][c];
}

// ===========================================================================
// fp32: the chunk's products on the CUDA cores, in the plain version's order
// ===========================================================================

namespace simt {

constexpr int THREADS = 256;
constexpr int RB = 64;       // rows of a product tile (chunk rows, panel columns, rows of P)
constexpr int TV = 32;       // value columns per pass-2 block
constexpr int KT = 32;       // reduction steps per staged tile
constexpr int LDA = RB + 4;  // row of a staged k-major tile
constexpr int RB2 = 128;     // rows of a pass-2 tile (chunk rows, rows of P)
constexpr int LDA2 = RB2 + 4;
// the update with v staged whole: each warp's rows of C, the rows of C a
// warp takes a round, and the chunk rows a stage of its ring
constexpr int WARP_ROWS = MAX_P / (THREADS / 32);
constexpr int WR = 64;
constexpr int KU = 8;
static_assert(THREADS / 32 * 2 * KU * WR <= 2 * KT * LDA2, "the warps' rings fit the block's");
static_assert(MAX_P % THREADS == 0 && THREADS % RB == 0, "whole shares of P and of the rows");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* h;         // (B, L, H, P), contiguous
  float* panel;    // (B H nc, Q64, Q64): S transposed, S_T[j][i]
  float* rows;     // (B H nc, 4, Q64): row sums, exp(b - m), exp(-m), exp(w - m')
  float* u;        // (B H nc, P): sum_j k_j P^-1/2 exp(w_j - m'), the chunk's n update
  float* carry;    // (B H nc): exp(ftot + m - m')
  int L, H, P, Q, nc;
  float scale;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  long long i_sb, i_sl, i_sh, f_sb, f_sl, f_sh;
};

// The floats of scratch a call needs (panel, rows, u, carry), in that order.
__host__ __device__ inline long long scratch_floats(int B, int L, int H, int P, int Q) {
  const long long chunks = (long long)B * H * (L / Q);
  const long long q64 = round_up(Q, RB);
  return chunks * (q64 * q64 + 4 * q64 + P + 1);
}

// the chunk's gates and row scalars (fcum in double when BLOCKED), then two
// stages of the staged q and k tiles
template <bool BLOCKED>
__host__ inline int panel_smem(int Q) {
  return 4 * ((BLOCKED ? 5 : 4) * round_up(Q, RB) + 4 * KT * LDA);
}
// STREAM: the chunk's v columns come through a two-stage ring of KT-row
// tiles beside the staged A tiles, in place of all Q rows staged at once, so
// that shared memory no longer grows with the chunk's rows times TV.
template <bool STREAM>
__host__ inline int state_smem(int P, int Q) {
  const int p128 = round_up(P, RB2);
  const int vrows = STREAM ? 2 * KT : round_up(Q, KT);
  return 4 * (p128 * TV + p128 + vrows * TV + 2 * KT * LDA2 + 4 * round_up(Q, RB) + THREADS);
}

// A 64-row, KT-column tile in flight: two of its 512 quads a thread.
struct Tile2 {
  float4 r[2];
};

// Rows r0.. (64) and columns p0.. (KT) of src (rows of rs floats), zero past
// row nrows or column P.  Eight threads read a row's 32 elements together.
__device__ __forceinline__ void fetch_panel(Tile2& t, const float* src, long long rs, int r0,
                                            int nrows, int p0, int P) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * THREADS, ii = e / (KT / 4), pp = 4 * (e % (KT / 4));
    t.r[u] = (r0 + ii < nrows && p0 + pp < P) ? load4(src + (long long)(r0 + ii) * rs + p0 + pp)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
// That tile stored k-major: dst[pp][ii], rows of LDA floats.
__device__ __forceinline__ void put_panel(const Tile2& t, float* dst) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = threadIdx.x + u * THREADS, ii = e / (KT / 4), pp = 4 * (e % (KT / 4));
    dst[(pp + 0) * LDA + ii] = t.r[u].x;
    dst[(pp + 1) * LDA + ii] = t.r[u].y;
    dst[(pp + 2) * LDA + ii] = t.r[u].z;
    dst[(pp + 3) * LDA + ii] = t.r[u].w;
  }
}

// ---------------------------------------------------------------------------
// pass 1: the chunk's panel and per-row scalars, one block per 64 rows
// ---------------------------------------------------------------------------

// One block per (batch, head, chunk, 64 rows of the chunk): the row tile's
// panel tiles on or below the diagonal, in order, each thread carrying its
// rows' partial row sums from tile to tile as a block over the whole chunk
// did, and a share of the chunk's n update.
// BLOCKED (the chunks above 416 at P = 1024, which also stream v in pass 2):
// each staged tile's products go into a fresh accumulator added to the
// total, so a long sum's rounding grows with its tiles, not its terms; and
// fcum is scanned and kept in double, each difference fcum_i - fcum_j (and
// ftot - fcum_j) rounded to fp32 once.  Over 1024 steps fcum reaches about
// -50, where an fp32 ulp is 4e-6: differences of fp32 fcum put that error
// into every weight of a row, and a row whose panel sum nearly cancels
// turns it into up to 3e-4 of max |h| (twice the float64 check's allowance).
template <bool BLOCKED>
__global__ void __launch_bounds__(THREADS) mlstm_chunk_panel(Params p) {
  using F = typename std::conditional<BLOCKED, double, float>::type;
  extern __shared__ float smem[];
  const int Q = p.Q, q64 = round_up(Q, RB);
  F* fcum = reinterpret_cast<F*>(smem);                // (q64,)
  float* igs = reinterpret_cast<float*>(fcum + q64);   // (q64,)
  float* kws = igs + q64;    // (q64,)
  float* mrow = kws + q64;   // (q64,): the block's rows from 0
  float* As = mrow + q64;    // 2 x (KT, LDA): q^T
  float* Bs = As + 2 * KT * LDA;  // 2 x (KT, LDA): k^T
  __shared__ float sh_mprev, sh_mnext, sh_round[2 * (THREADS / 32)];
  __shared__ F sh_ftot;

  const int ti = blockIdx.x, c = blockIdx.y, bh = blockIdx.z, h = bh % p.H, b = bh / p.H;
  const int i0 = ti * RB;
  const int tid = threadIdx.x;
  const long long chunk_id = (long long)bh * p.nc + c;
  const float* igp = p.ig + b * p.i_sb + h * p.i_sh;
  const float* fgp = p.fg + b * p.f_sb + h * p.f_sh;

  // 1. the m chain over the chunks up to this one, 8 chunks a round: each
  // warp takes one, its fcum an inclusive shuffle scan 32 steps at a time,
  // run once for ftot and again for the max of ftot - fcum_j + i_j (the
  // same sums in the same order, so no store of the chunk's fcum is needed
  // but this chunk's); thread 0 then carries m over the round in order
  const int warp = tid >> 5, lane = tid & 31;
  // f(j, fcum_j, i_j) for j < Q in order; returns fcum_{Q-1} (the lane
  // that holds it: past Q the scan adds zeros in another order)
  auto scan = [&](long long l0, auto f) {
    F run = 0.f, last = 0.f;
    for (int j0 = 0; j0 < Q; j0 += 32) {
      const int j = j0 + lane;
      F fj = j < Q ? fgp[(l0 + j) * p.f_sl] : 0.f;
      const float ij = j < Q ? igp[(l0 + j) * p.i_sl] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const F o = __shfl_up_sync(FULL, fj, off);
        if (lane >= off) fj += o;
      }
      fj += run;
      if (j < Q) f(j, fj, ij);
      run = __shfl_sync(FULL, fj, 31);
      last = __shfl_sync(FULL, fj, min(Q - 1 - j0, 31));
    }
    return last;
  };
  float m = BIG_NEG;  // thread 0's
  for (int base = 0; base <= c; base += THREADS / 32) {
    const int cc = base + warp;
    if (cc <= c) {
      const long long l0 = (long long)cc * Q;
      const F ftot = scan(l0, [](int, F, float) {});
      float wmax = -INFINITY;
      scan(l0, [&](int j, F fj, float ij) {
        wmax = fmaxf(wmax, static_cast<float>(ftot - fj) + ij);
        if (cc == c) {
          fcum[j] = fj;
          igs[j] = ij;
        }
      });
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(FULL, wmax, off));
      if (lane == 0) {
        sh_round[2 * warp] = static_cast<float>(ftot);
        sh_round[2 * warp + 1] = wmax;
        if (cc == c) sh_ftot = ftot;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < THREADS / 32 && base + w <= c; ++w) {
        const float ftot = sh_round[2 * w];
        const float m_next = fmaxf(fmaxf(ftot + m, sh_round[2 * w + 1]), BIG_NEG);
        if (base + w == c) {
          sh_mprev = m;
          sh_mnext = m_next;
        }
        m = m_next;
      }
    }
    __syncthreads();
  }

  // 2. per-row scalars: the stabiliser m_i is the row max of the same a_ij
  // the panel weights use
  const float m_prev = sh_mprev, m_next = sh_mnext;
  const F ftot = sh_ftot;
  float* rows = p.rows + chunk_id * 4 * q64;
  for (int j = tid; j < q64; j += THREADS)
    kws[j] = j < Q ? expf(static_cast<float>(ftot - fcum[j]) + igs[j] - m_next) : 0.f;
  {  // the row maxima of a_ij in four parts (a max is exact in any order),
     // in the staging space before the tiles use it
    const int r = tid % RB, quarter = tid / RB, i = i0 + r;
    float amax = -INFINITY;
    if (i < Q) {
      const F fi = fcum[i];
      for (int j = quarter; j <= i; j += THREADS / RB)
        amax = fmaxf(amax, static_cast<float>(fi - fcum[j]) + igs[j]);
    }
    As[quarter * RB + r] = amax;
  }
  __syncthreads();
  for (int r = tid; r < RB; r += THREADS) {
    const int i = i0 + r;
    float mi = 0.f, iw = 0.f, e = 0.f;
    if (i < Q) {
      const F fi = fcum[i];
      const float amax = fmaxf(fmaxf(As[r], As[RB + r]), fmaxf(As[2 * RB + r], As[3 * RB + r]));
      const float b_log = static_cast<float>(fi + m_prev);
      mi = fmaxf(fmaxf(amax, b_log), BIG_NEG);
      iw = expf(b_log - mi);
      e = expf(-mi);
    }
    mrow[r] = mi;
    rows[q64 + i] = iw;
    rows[2 * q64 + i] = e;
  }
  if (ti == 0 && tid == 0) p.carry[chunk_id] = expf(static_cast<float>(ftot + m_prev - m_next));
  __syncthreads();  // kws is whole, and the row maxima are read before the tiles land
  for (int r = tid; r < RB; r += THREADS) rows[3 * q64 + i0 + r] = kws[i0 + r];

  // 3. the n update of the chunk, u = sum_j (k_j P^-1/2) exp(w_j - m'), once
  // here rather than in every value-column block of pass 2; its columns
  // shared among the first half of the chunk's row tiles, which have the
  // fewer panel tiles
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + (long long)c * Q * p.q_sl;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh + (long long)c * Q * p.k_sl;
  const int u_tiles = (gridDim.x + 1) / 2;
  for (int pq = 4 * (tid + THREADS * ti); ti < u_tiles && pq < p.P; pq += 4 * THREADS * u_tiles) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < Q; ++j) {
      const float4 x = load4(kp + j * p.k_sl + pq);
      const float w = kws[j];
      acc.x += x.x * p.scale * w;
      acc.y += x.y * p.scale * w;
      acc.z += x.z * p.scale * w;
      acc.w += x.w * p.scale * w;
    }
    *reinterpret_cast<float4*>(p.u + chunk_id * p.P + pq) = acc;
  }

  // 4. the row tile's panel, its 64 x 64 tiles on or below the diagonal in
  // order; a thread owns rows i0 + 4 ty + r and columns j0 + 4 tx + cc.
  // Stage s is tile s / nps, columns p0 = (s % nps) KT of P; stage s + 1 is
  // read into registers while the block computes on stage s.
  float* panel = p.panel + chunk_id * q64 * q64;
  const int ty = tid / 16, tx = tid % 16;
  // the tiles above the diagonal are all masked: zeros, which pass 2 reads
  // in its 128-row tiles
  for (int j0 = i0 + RB; j0 < q64; j0 += RB)
    for (int e = tid; e < RB * RB / 4; e += THREADS)
      *reinterpret_cast<float4*>(panel + (long long)(j0 + e / (RB / 4)) * q64 + i0 +
                                 4 * (e % (RB / 4))) = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nps = (p.P + KT - 1) / KT, n = (ti + 1) * nps;
  Tile2 ta, tb;
  auto fetch = [&](int s) {
    const int p0 = s % nps * KT;
    fetch_panel(ta, qp, p.q_sl, i0, Q, p0, p.P);
    fetch_panel(tb, kp, p.k_sl, s / nps * RB, Q, p0, p.P);
  };
  fetch(0);
  put_panel(ta, As);
  put_panel(tb, Bs);
  __syncthreads();
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  float acc[4][4];
  for (int s = 0; s < n; ++s) {
    const int buf = s & 1;
    if (s % nps == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.f;
    }
    if (s + 1 < n) fetch(s + 1);
    const float* A = As + buf * KT * LDA;
    const float* B = Bs + buf * KT * LDA;
    float blk[4][4] = {};
    float (&sum)[4][4] = BLOCKED ? blk : acc;
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(A + kk * LDA + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(B + kk * LDA + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ar = get(a, r);
        sum[r][0] += ar * bv.x;
        sum[r][1] += ar * bv.y;
        sum[r][2] += ar * bv.z;
        sum[r][3] += ar * bv.w;
      }
    }
    if constexpr (BLOCKED) add_tile(acc, blk);
    if (s % nps == nps - 1) {
      // the tile is summed: stabilise, mask, store S transposed and add to
      // the row sums
      const int j0 = s / nps * RB;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + 4 * tx + cc;
        float sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
          sv[r] = 0.f;
          if (i < Q && j <= i)
            sv[r] = acc[r][cc] * p.scale *
                    expf(static_cast<float>(fcum[i] - fcum[j]) + igs[j] - mrow[4 * ty + r]);
          part[r] += sv[r];
        }
        *reinterpret_cast<float4*>(panel + (long long)j * q64 + i0 + 4 * ty) =
            make_float4(sv[0], sv[1], sv[2], sv[3]);
      }
    }
    if (s + 1 < n) {
      put_panel(ta, As + (buf ^ 1) * KT * LDA);
      put_panel(tb, Bs + (buf ^ 1) * KT * LDA);
    }
    __syncthreads();
  }
  // row sums over the 16 threads of a row group (one half-warp)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part[r] += __shfl_xor_sync(FULL, part[r], off);
    if (tx == 0) rows[i0 + 4 * ty + r] = part[r];
  }
}

// ---------------------------------------------------------------------------
// pass 2: h and the state, one block per (batch, head, 32 value columns)
// ---------------------------------------------------------------------------

// A 32 x 128 tile in flight: each thread holds 4 of its 1024 quads in
// registers while the block computes on the previous tile.
struct Tile4 {
  float4 r[4];
};

// The staged q tile of q C holds q's element (i, k) at k LDA2 + (i ^ swq(k)),
// so that a warp's transposing stores of eight threads a row of q (one
// coalesced read) fall on different banks.
__device__ __forceinline__ int swq(int k) { return ((k >> 2) & 7) << 2; }

// acc[r][cc] += sum_kk A[kk][4 ty + r] B[kk][4 tx + cc] over a staged tile
// (A swizzled as the q tile is, if asked): two 16-byte shared loads feed 16
// FMAs.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx, bool swizzled) {
#pragma unroll 8
  for (int kk = 0; kk < KT; ++kk) {
    const float4 a =
        *reinterpret_cast<const float4*>(A + kk * LDA2 + (swizzled ? (4 * ty) ^ swq(kk) : 4 * ty));
    const float4 bv = *reinterpret_cast<const float4*>(B + kk * TV + 4 * tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float ar = get(a, r);
      acc[r][0] += ar * bv.x;
      acc[r][1] += ar * bv.y;
      acc[r][2] += ar * bv.z;
      acc[r][3] += ar * bv.w;
    }
  }
}

// Rows of a tile stored as they are: quad e is row e / 32, columns 4 (e % 32).
__device__ __forceinline__ void put_rows(const Tile4& t, float* dst) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    *reinterpret_cast<float4*>(dst + (e / 32) * LDA2 + 4 * (e % 32)) = t.r[u];
  }
}

// A 128-row, 32-column tile of q stored transposed and swizzled (swq):
// quad e is row e / 8, columns 4 (e % 8), eight threads a row.
__device__ __forceinline__ void put_transposed(const Tile4& t, float* dst) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS, pq = 4 * (e % (KT / 4));
    float* d = dst + pq * LDA2 + ((e / (KT / 4)) ^ pq);
    d[0] = t.r[u].x;
    d[LDA2] = t.r[u].y;
    d[2 * LDA2] = t.r[u].z;
    d[3 * LDA2] = t.r[u].w;
  }
}

// A contraction over n staged tiles through two stages of shared memory
// and two tiles of registers: tile s + 2 is read from global memory while
// the block computes on tile s, so each read has two tiles' compute to land
// (one tile in flight a SM left most of the state pass waiting on L2).
template <class Fetch, class Put, class Body>
__device__ __forceinline__ void pipeline(float* As, int n, Fetch fetch, Put put, Body body) {
  float* const A1 = As + KT * LDA2;
  Tile4 ta, tb;  // the tiles of even and of odd index
  fetch(ta, 0);
  if (n > 1) fetch(tb, 1);
  put(ta, As);
  __syncthreads();
  for (int s = 0; s < n; s += 2) {
    if (s + 2 < n) fetch(ta, s + 2);
    body(As, s);
    if (s + 1 < n) put(tb, A1);
    __syncthreads();
    if (s + 1 >= n) break;
    if (s + 3 < n) fetch(tb, s + 3);
    body(A1, s + 1);
    if (s + 2 < n) put(ta, As);
    __syncthreads();
  }
}

// The same, with the KT x TV tile s of v (rows j0 + s KT of vsrc, which
// points at the chunk's column t0) staged beside A in a ring of its own:
// body(A, V, s).  One quad of v a thread.
template <class Fetch, class Put, class Body>
__device__ __forceinline__ void pipeline_v(float* As, float* Vr, const float* vsrc, long long v_sl,
                                           int Q, int cols, int n, Fetch fetch, Put put,
                                           Body body) {
  const int jj = threadIdx.x / (TV / 4), col = 4 * (threadIdx.x % (TV / 4));
  auto fetch_v = [&](float4& vq, int s) {
    const int j = s * KT + jj;
    vq = (j < Q && col < cols) ? load4(vsrc + (long long)j * v_sl + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto put_v = [&](const float4& vq, int buf) {
    *reinterpret_cast<float4*>(Vr + buf * KT * TV + jj * TV + col) = vq;
  };
  float* const A1 = As + KT * LDA2;
  Tile4 ta, tb;
  float4 va, vb;
  fetch(ta, 0);
  fetch_v(va, 0);
  if (n > 1) {
    fetch(tb, 1);
    fetch_v(vb, 1);
  }
  put(ta, As);
  put_v(va, 0);
  __syncthreads();
  for (int s = 0; s < n; s += 2) {
    if (s + 2 < n) {
      fetch(ta, s + 2);
      fetch_v(va, s + 2);
    }
    body(As, Vr, s);
    if (s + 1 < n) {
      put(tb, A1);
      put_v(vb, 1);
    }
    __syncthreads();
    if (s + 1 >= n) break;
    if (s + 3 < n) {
      fetch(tb, s + 3);
      fetch_v(vb, s + 3);
    }
    body(A1, Vr + KT * TV, s + 1);
    if (s + 2 < n) {
      put(ta, As);
      put_v(va, 0);
    }
    __syncthreads();
  }
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS) mlstm_chunk_state(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, P = p.P;
  const int q64 = round_up(Q, RB), q32 = round_up(Q, KT), p128 = round_up(P, RB2);
  float* Cs = smem;               // (p128, TV): this block's columns of C
  float* ns = Cs + p128 * TV;     // (p128,)
  float* vs = ns + p128;          // (q32, TV): the chunk's v columns; STREAM: 2 x (KT, TV)
  float* As = vs + (STREAM ? 2 * KT : q32) * TV;  // 2 x (KT, LDA2)
  float* rs = As + 2 * KT * LDA2; // (4, q64): the chunk's row scalars
  float* red = rs + 4 * q64;      // (THREADS,): q . n partials

  const int t0 = blockIdx.x * TV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // rows 4 ty + r, columns 4 tx + cc
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* hb = static_cast<float*>(p.h) + ((long long)b * p.L * p.H + h) * P;
  const long long h_sl = (long long)p.H * P;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < p128 * TV; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < p128; e += THREADS) ns[e] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const long long chunk_id = ((long long)b * p.H + h) * p.nc + c;
    const long long l0 = (long long)c * Q;
    const float* panel = p.panel + chunk_id * q64 * q64;
    const float* qc = qb + l0 * p.q_sl;
    const float* kc = kb + l0 * p.k_sl;
    __syncthreads();  // the previous chunk is done with vs, rs, ns and As
    if constexpr (!STREAM) {  // the chunk's v columns, in flight while rs is read
      for (int e = tid; e < q32 * (TV / 4); e += THREADS) {
        const int j = e / (TV / 4), col = 4 * (e % (TV / 4));
        const bool ok = j < Q && t0 + col < P;
        cp_async<16>(vs + j * TV + col, ok ? vb + (l0 + j) * p.v_sl + t0 + col : vb, ok);
      }
      cp_async_commit();
    }
    const float carry = p.carry[chunk_id];
    float uq[MAX_P / THREADS];  // the chunk's n update, used at its end
#pragma unroll
    for (int k = 0; k < MAX_P / THREADS; ++k)
      uq[k] = tid + k * THREADS < P ? p.u[chunk_id * P + tid + k * THREADS] : 0.f;
#pragma unroll 4
    for (int e = tid; e < 4 * q64; e += THREADS) rs[e] = p.rows[chunk_id * 4 * q64 + e];
    cp_async_wait_all();
    __syncthreads();
    // acc += A^T B over a staged tile (STREAM: through a fresh accumulator)
    auto product = [&](float (&acc)[4][4], const float* A, const float* B, bool swizzled) {
      if constexpr (STREAM) {
        float blk[4][4] = {};
        mma_tile(blk, A, B, ty, tx, swizzled);
        add_tile(acc, blk);
      } else {
        mma_tile(acc, A, B, ty, tx, swizzled);
      }
    };
    // a contraction whose B operand is the chunk's v: body(A, V, s) with V
    // the KT x TV tile s of v, staged whole or through its ring
    auto with_v = [&](int n, auto fetch, auto put, auto body) {
      if constexpr (STREAM) {
        pipeline_v(As, vs, vb + l0 * p.v_sl + t0, p.v_sl, Q, P - t0, n, fetch, put, body);
      } else {
        pipeline(As, n, fetch, put,
                 [&](const float* A, int s) { body(A, vs + s * KT * TV, s); });
      }
    };

    // h, 128 rows of the chunk at a time
    for (int i0 = 0; i0 < Q; i0 += RB2) {
      float ai[4][4] = {}, ae[4][4] = {};
      // intra: S v over the columns j < i0 + 128 (S is 0 above the diagonal
      // and past Q; the panel's rows are zero-padded to q64)
      with_v(
          (min(Q, i0 + RB2) + KT - 1) / KT,
          [&](Tile4& t, int s) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = tid + u * THREADS, jj = e / 32, ii = 4 * (e % 32);
              t.r[u] = i0 + ii < q64 ? *reinterpret_cast<const float4*>(
                                           panel + (long long)(s * KT + jj) * q64 + i0 + ii)
                                     : zero;
            }
          },
          put_rows, [&](const float* A, const float* V, int) { product(ai, A, V, false); });
      // inter: q C and q . n over P
      float qn = 0.f;
      const int row = tid % RB2, half = tid / RB2;  // q . n: 16 of a tile's 32 steps
      pipeline(
          As, (P + KT - 1) / KT,
          [&](Tile4& t, int s) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = tid + u * THREADS, ii = e / (KT / 4), pq = 4 * (e % (KT / 4));
              t.r[u] = (i0 + ii < Q && s * KT + pq < P)
                           ? load4(qc + (long long)(i0 + ii) * p.q_sl + s * KT + pq)
                           : zero;
            }
          },
          put_transposed,
          [&](const float* A, int s) {
            product(ae, A, Cs + s * KT * TV, true);
#pragma unroll
            for (int kk = 16 * half; kk < 16 * half + 16; ++kk)
              qn += A[kk * LDA2 + (row ^ swq(kk))] * ns[s * KT + kk];
          });
      red[tid] = qn;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = 4 * ty + r, i = i0 + ii;
        if (i >= Q) continue;
        const float qn_i = red[ii] + red[RB2 + ii];
        const float iw = rs[q64 + i];
        const float den = fmaxf(fabsf(rs[i] + qn_i * iw), rs[2 * q64 + i]);
        if (t0 + 4 * tx < P)  // P is a multiple of 4
          *reinterpret_cast<float4*>(hb + (l0 + i) * h_sl + t0 + 4 * tx) = make_float4(
              (ai[r][0] + ae[r][0] * iw) / den, (ai[r][1] + ae[r][1] * iw) / den,
              (ai[r][2] + ae[r][2] * iw) / den, (ai[r][3] + ae[r][3] * iw) / den);
      }
    }

    // the state update: C <- carry C + (k w)^T v.  Staged whole, v feeds
    // 512 rows of C at a time, 8 x 8 a thread; streamed, 128 rows at a time
    // through v's ring
    if constexpr (!STREAM) {
      // each warp owns WARP_ROWS rows of C, WR a round, 8 x 8 a lane (rows
      // 4 uy + r and WR / 2 + 4 uy + r, columns 4 ux + cc and 16 + 4 ux + cc),
      // and streams its rows' columns of k through a two-stage cp.async ring
      // of its own, so the update waits on no barrier across the block
      const int warp = tid >> 5, lane = tid & 31, uy = lane / 4, ux = lane % 4;
      float* ring = As + warp * 2 * KU * WR;  // 2 x (KU, WR)
      const int n = (Q + KU - 1) / KU;
      for (int pr0 = WARP_ROWS * warp; pr0 < min(P, WARP_ROWS * (warp + 1)); pr0 += WR) {
        float acc[8][8] = {};
        // stage s: rows j = s KU.. of k for rows pr0.. of C, copied as they
        // are and scaled in place, (k P^-1/2) exp(w_j - m'), by the lane that
        // copied them
        auto quads = [&](int s, auto f) {
          float* dst = ring + (s & 1) * KU * WR;
#pragma unroll
          for (int u = 0; u < KU * WR / 128; ++u) {
            const int e = lane + 32 * u, jj = e / (WR / 4), pp = 4 * (e % (WR / 4));
            const int j = s * KU + jj;
            f(dst + jj * WR + pp, j, pr0 + pp, j < Q && pr0 + pp < P);
          }
        };
        auto issue = [&](int s) {
          quads(s, [&](float* d, int j, int pc, bool ok) {
            cp_async<16>(d, ok ? kc + (long long)j * p.k_sl + pc : kc, ok);
          });
          cp_async_commit();
        };
        issue(0);
        for (int s = 0; s < n; ++s) {
          if (s + 1 < n) {
            issue(s + 1);  // its stage was last read before the warp barrier that ended s - 1
            cp_async_wait_one();
          } else {
            cp_async_wait_all();
          }
          quads(s, [&](float* d, int j, int, bool ok) {
            if (!ok) return;
            float4* d4 = reinterpret_cast<float4*>(d);
            const float4 x = *d4;
            const float kw = rs[3 * q64 + j];
            *d4 = make_float4(x.x * p.scale * kw, x.y * p.scale * kw, x.z * p.scale * kw,
                              x.w * p.scale * kw);
          });
          __syncwarp();  // stage s has landed and is scaled
          const float* A = ring + (s & 1) * KU * WR;
#pragma unroll
          for (int kk = 0; kk < KU; ++kk) {
            const float* ar = A + kk * WR + 4 * uy;
            const float* vr = vs + (s * KU + kk) * TV + 4 * ux;
            const float4 a0 = *reinterpret_cast<const float4*>(ar);
            const float4 a1 = *reinterpret_cast<const float4*>(ar + WR / 2);
            const float4 b0 = *reinterpret_cast<const float4*>(vr);
            const float4 b1 = *reinterpret_cast<const float4*>(vr + TV / 2);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) acc[r][cc] += a[r] * bv[cc];
          }
          __syncwarp();  // stage s is read before s + 2 is copied over it
        }
        // rows of C are this lane's alone
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int pr = pr0 + (r < 4 ? 4 * uy + r : WR / 2 + 4 * uy + r - 4);
          if (pr >= P) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float4* cp = reinterpret_cast<float4*>(Cs + pr * TV + 4 * ux + half * (TV / 2));
            const float4 old = *cp;
            const float* ac = acc[r] + 4 * half;
            *cp = make_float4(carry * old.x + ac[0], carry * old.y + ac[1],
                              carry * old.z + ac[2], carry * old.w + ac[3]);
          }
        }
      }
    } else {
      for (int pr0 = 0; pr0 < P; pr0 += RB2) {
        float acc[4][4] = {};
        with_v(
            (Q + KT - 1) / KT,
            [&](Tile4& t, int s) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int e = tid + u * THREADS, j = s * KT + e / 32, pp = 4 * (e % 32);
                float4 x = zero;
                if (j < Q && pr0 + pp < P) {
                  x = load4(kc + (long long)j * p.k_sl + pr0 + pp);
                  const float kw = rs[3 * q64 + j];  // (k P^-1/2) exp(w_j - m')
                  x = make_float4(x.x * p.scale * kw, x.y * p.scale * kw, x.z * p.scale * kw,
                                  x.w * p.scale * kw);
                }
                t.r[u] = x;
              }
            },
            put_rows, [&](const float* A, const float* V, int) { product(acc, A, V, false); });
        // rows of C are this thread's alone
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* cp = reinterpret_cast<float4*>(Cs + (pr0 + 4 * ty + r) * TV + 4 * tx);
          const float4 old = *cp;
          *cp = make_float4(carry * old.x + acc[r][0], carry * old.y + acc[r][1],
                            carry * old.z + acc[r][2], carry * old.w + acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_P / THREADS; ++k)
      if (tid + k * THREADS < P) ns[tid + k * THREADS] = carry * ns[tid + k * THREADS] + uq[k];
  }
}

// Whether a chunk of Q rows streams v (the chunks whose whole v columns do
// not fit beside C: above 416 at P = 1024).  Those chunks also sum each
// staged tile's products apart (BLOCKED): over 512 or 1024 terms a running
// fp32 sum drifts from the float64 plain version by several times the
// tolerance.  The chunks below keep their arithmetic bit for bit.
__host__ inline bool streams(int P, int Q) { return state_smem<false>(P, Q) > MAX_SMEM; }
__host__ inline bool fits(int P, int Q) {
  return panel_smem<true>(Q) <= MAX_SMEM && state_smem<true>(P, Q) <= MAX_SMEM;
}

template <bool STREAM>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem1 = panel_smem<STREAM>(p.Q), smem2 = state_smem<STREAM>(p.P, p.Q);
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_panel<STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mlstm_chunk_state<STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_panel<STREAM><<<dim3(round_up(p.Q, RB) / RB, p.nc, B * p.H), THREADS, smem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_state<STREAM><<<dim3((p.P + TV - 1) / TV, p.H, B), THREADS, smem2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ===========================================================================
// bf16: the chunk's products on the tensor cores
// ===========================================================================

namespace tc {

// acc += tile in fp32, element by element.  A staged tile's products are
// summed into a fresh accumulator and added here, so that no MMA
// accumulator runs over more than one tile: the tensor cores add into their
// accumulator with truncation, which over the hundreds of MMAs of a product
// over P = 1024 costs measurable accuracy (PERF.md).
template <int M, int N>
__device__ __forceinline__ void add_into(float (&acc)[M][N][4], const float (&tile)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] += tile[m][n][e];
}

// Issues the copies of a ROWS x COLS tile (4 elements a copy) into dst,
// rows of LD elements: element (r, c) from src[r * stride + c], or zero
// where !ok(r, c) (ok is asked once a 4-element group, at its first column).
template <int THREADS, int ROWS, int COLS, int LD, typename T, class Ok>
__device__ __forceinline__ void stage(T* dst, const T* src, long long stride, Ok ok) {
  constexpr int G = COLS / 4;
  for (int e = threadIdx.x; e < ROWS * G; e += THREADS) {
    const int r = e / G, c = 4 * (e % G);
    const bool valid = ok(r, c);
    cp_async<4 * static_cast<int>(sizeof(T))>(dst + r * LD + c,
                                              valid ? src + r * stride + c : src, valid);
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* h;          // (B, L, H, P), contiguous
  float* panel;     // (B H nc, Q64, Q64): S[i][j]; tiles above the diagonal unwritten
  float* rowpart;   // (B H nc, Q64 / 64, Q64): row sums of S over each 64-column tile
  float* scal;      // (B H nc, 3, Q64): exp(b - m), exp(-m), exp(w - m')
  float* u;         // (B H nc, P): sum_j k_j P^-1/2 exp(w_j - m'), the chunk's n update
  float* carry;     // (B H nc): exp(ftot + m - m')
  int L, H, P, Q, nc;
  float scale;
  long long q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;
  long long i_sb, i_sl, i_sh, f_sb, f_sl, f_sh;
};

// The floats of scratch a call needs (panel, rowpart, scal, u, carry), in
// that order.
__host__ __device__ inline long long scratch_floats(int B, int L, int H, int P, int Q) {
  const long long chunks = (long long)B * H * (L / Q);
  const long long q64 = round_up(Q, 64);
  return chunks * (q64 * q64 + (q64 / 64 + 3) * q64 + P + 1);
}

// ---------------------------------------------------------------------------
// pass 1: the chunk's panel and per-row scalars, one block per 64 x 64 tile
// ---------------------------------------------------------------------------

constexpr int THREADS1 = 128;  // 4 warps, each 32 x 32 of the tile
constexpr int TILE = 64;

template <typename T>
struct Panel {
  static constexpr int KP = 128 / static_cast<int>(sizeof(T));     // P columns a stage
  static constexpr int LD = KP + 16 / static_cast<int>(sizeof(T));  // 144-byte rows
  static constexpr int STAGE = 2 * TILE * LD;                      // q tile, then k tile
};

template <typename T>
__host__ inline int panel_smem(int Q) {
  return 4 * (9 * round_up(Q, TILE) + 208) +
         2 * Panel<T>::STAGE * static_cast<int>(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(THREADS1) mlstm_chunk_panel(Params p) {
  using Cfg = Panel<T>;
  constexpr int KP = Cfg::KP, LD = Cfg::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = p.Q, q64 = round_up(Q, TILE);
  float* wf = reinterpret_cast<float*>(smem);  // (4, q64): each warp's fcum
  float* wi = wf + 4 * q64;                    // (4, q64): each warp's input gates
  float* kwall = wi + 4 * q64;                 // (q64,): exp(w_j - m')
  float* mrow = kwall + q64;                   // (64,): m_i of the tile's rows
  float* part = mrow + TILE;                   // (2, 64): halves of row maxima, row sums
  float* sc = part + 2 * TILE;                 // (16,): gate summaries, the chain's result
  T* ring = reinterpret_cast<T*>(sc + 16);     // 2 stages of (q tile, k tile)

  // tiles in row order: (0,0), (1,0), (1,1), (2,0), ...
  int ti = 0, tj = blockIdx.x;
  while (tj > ti) tj -= ++ti;
  const int c = blockIdx.y, bh = blockIdx.z, h = bh % p.H, b = bh / p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long chunk_id = (long long)bh * p.nc + c;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + (long long)c * Q * p.q_sl;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + (long long)c * Q * p.k_sl;
  const int nstage = (p.P + KP - 1) / KP;
  auto issue = [&](int s, int buf) {
    T* dst = ring + buf * Cfg::STAGE;
    const int p0 = s * KP;
    stage<THREADS1, TILE, KP, LD>(dst, qp + (long long)i0 * p.q_sl + p0, p.q_sl,
                                  [&](int r, int cc) { return i0 + r < Q && p0 + cc < p.P; });
    stage<THREADS1, TILE, KP, LD>(dst + TILE * LD, kp + (long long)j0 * p.k_sl + p0, p.k_sl,
                                  [&](int r, int cc) { return j0 + r < Q && p0 + cc < p.P; });
  };
  issue(0, 0);  // the first tiles are in flight while the scalars are computed
  cp_async_commit();

  // 1. the m chain over the chunks up to this one: each warp sums the gates
  // of one chunk (fcum an inclusive shuffle scan 32 steps at a time), then
  // thread 0 carries m over them in order
  const float* igp = p.ig + b * p.i_sb + h * p.i_sh;
  const float* fgp = p.fg + b * p.f_sb + h * p.f_sh;
  float m = BIG_NEG;  // thread 0's
  for (int base = 0; base <= c; base += 4) {
    const int cc = base + warp;
    if (cc <= c) {
      float* fw = wf + warp * q64;
      float* iw = wi + warp * q64;
      const long long l0 = (long long)cc * Q;
      float run = 0.f;
      for (int s0 = 0; s0 < Q; s0 += 32) {
        const int j = s0 + lane;
        float f = j < Q ? fgp[(l0 + j) * p.f_sl] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(FULL, f, off);
          if (lane >= off) f += o;
        }
        f += run;
        if (j < Q) {
          fw[j] = f;
          iw[j] = igp[(l0 + j) * p.i_sl];
        }
        run = __shfl_sync(FULL, f, 31);
      }
      __syncwarp();
      const float ftot = fw[Q - 1];
      float wmax = -INFINITY;
      for (int j = lane; j < Q; j += 32) wmax = fmaxf(wmax, ftot - fw[j] + iw[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(FULL, wmax, off));
      if (lane == 0) {
        sc[2 * warp] = ftot;
        sc[2 * warp + 1] = wmax;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 0; w < 4 && base + w <= c; ++w) {
        const float ftot = sc[2 * w];
        const float m_next = fmaxf(fmaxf(ftot + m, sc[2 * w + 1]), BIG_NEG);
        if (base + w == c) {
          sc[8] = m;
          sc[9] = m_next;
          sc[10] = ftot;
        }
        m = m_next;
      }
    }
    __syncthreads();
  }
  const float m_prev = sc[8], m_next = sc[9], ftot = sc[10];
  const float* fcum = wf + (c & 3) * q64;  // this chunk's, from the last round
  const float* igs = wi + (c & 3) * q64;

  // 2. per-row scalars: the stabiliser m_i is the row max of the same a_ij
  // the panel weights use (two halves of the j range; max is exact in any
  // order, so every tile of the row gets the same m_i)
  for (int j = tid; j < q64; j += THREADS1)
    kwall[j] = j < Q ? expf(ftot - fcum[j] + igs[j] - m_next) : 0.f;
  {
    const int r = tid & (TILE - 1), half = tid / TILE, i = i0 + r;
    float amax = -INFINITY;
    if (i < Q) {
      const float fi = fcum[i];
      for (int j = half; j <= i; j += 2) amax = fmaxf(amax, fi - fcum[j] + igs[j]);
    }
    part[half * TILE + r] = amax;
  }
  __syncthreads();
  if (tid < TILE) {
    const int i = i0 + tid;
    float mi = 0.f, iw = 0.f, e = 0.f;
    if (i < Q) {
      const float b_log = fcum[i] + m_prev;
      mi = fmaxf(fmaxf(fmaxf(part[tid], part[TILE + tid]), b_log), BIG_NEG);
      iw = expf(b_log - mi);
      e = expf(-mi);
    }
    mrow[tid] = mi;
    if (tj == 0) {
      float* scal = p.scal + chunk_id * 3 * q64;
      scal[i] = iw;
      scal[q64 + i] = e;
      scal[2 * q64 + i] = kwall[i];
    }
  }
  if (blockIdx.x == 0 && tid == 0) p.carry[chunk_id] = expf(ftot + m_prev - m_next);

  // 3. the chunk's n update u = sum_j (k_j P^-1/2) exp(w_j - m'), its
  // columns shared among the chunk's tiles
  for (int e = tid + THREADS1 * blockIdx.x; 4 * e < p.P; e += THREADS1 * gridDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < Q; ++j) {
      const float4 x = load4(kp + j * p.k_sl + 4 * e);
      const float w = kwall[j];
      acc.x += x.x * p.scale * w;
      acc.y += x.y * p.scale * w;
      acc.z += x.z * p.scale * w;
      acc.w += x.w * p.scale * w;
    }
    *reinterpret_cast<float4*>(p.u + chunk_id * p.P + 4 * e) = acc;
  }

  // 4. the tile of q k^T on the tensor cores.  Warp (wr, wc) owns rows
  // 32 wr.. and columns 32 wc.. of the tile; the diagonal tile's upper right
  // quarter is all masked and not computed.
  const int wr = warp >> 1, wc = warp & 1;
  const bool active = !(ti == tj && wc > wr) && i0 + 32 * wr < Q && j0 + 32 * wc < Q;
  float acc[2][4][4] = {};
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait_all();
    __syncthreads();  // tile s has landed, and tile s - 1 is no longer read
    if (s + 1 < nstage) {
      issue(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    if (!active) continue;
    const T* qs = ring + (s & 1) * Cfg::STAGE + 32 * wr * LD;
    const T* ks = ring + (s & 1) * Cfg::STAGE + (TILE + 32 * wc) * LD;
    float tile[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], qs + (16 * mt + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < 4; n += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(tile[mt][n], a[mt], kb[0], kb[1]);
          mma_bf16(tile[mt][n + 1], a[mt], kb[2], kb[3]);
        }
      }
    }
    add_into(acc, tile);
  
  }

  // 5. stabilise and mask, write the tile of S and its row sums
  float* panel = p.panel + chunk_id * q64 * q64;
  float rs[2][2] = {};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int il = 32 * wr + 16 * mt + g + 8 * hr, i = i0 + il;
      const float fi = i < Q ? fcum[i] : 0.f, mi = mrow[il];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = j0 + 32 * wc + 8 * n + 2 * t4;
        float s0 = 0.f, s1 = 0.f;
        if (i < Q && j <= i && j < Q)
          s0 = static_cast<float>(acc[mt][n][2 * hr]) * p.scale *
               expf(fi - fcum[j] + igs[j] - mi);
        if (i < Q && j + 1 <= i && j + 1 < Q)
          s1 = static_cast<float>(acc[mt][n][2 * hr + 1]) * p.scale *
               expf(fi - fcum[j + 1] + igs[j + 1] - mi);
        store2(panel + (long long)i * q64 + j, s0, s1);
        rs[mt][hr] += s0 + s1;
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v = rs[mt][hr];
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      if (t4 == 0) part[wc * TILE + 32 * wr + 16 * mt + g + 8 * hr] = v;
    }
  }
  __syncthreads();
  if (tid < TILE)
    p.rowpart[(chunk_id * (q64 / TILE) + tj) * q64 + i0 + tid] = part[tid] + part[TILE + tid];
}

// ---------------------------------------------------------------------------
// pass 2: h and the state, one block per (batch, head, 32 value columns)
// ---------------------------------------------------------------------------

constexpr int THREADS2 = 256;  // 8 warps
constexpr int TV = 32;         // value columns a block
constexpr int RB = 128;        // chunk rows of h a round: warp (wr, wc) owns 32 x 16 of them
constexpr int PB = 256;        // rows of C a round of the update: 32 a warp
constexpr int LDV = 40;        // rows of the staged v tile and of w v (elements)

template <typename T>
struct State {
  static constexpr int E = static_cast<int>(sizeof(T));
  static constexpr int KS = 128 / E;             // P columns of a staged q tile
  static constexpr int LDQ = KS + 16 / E;        // 144-byte rows
  static constexpr int LDS = 40;                 // rows of a staged fp32 S tile (32 columns)
  static constexpr int KJ = 64 / E;              // chunk rows of a staged k tile
  static constexpr int LDK = PB + 8;
  static constexpr int Q_BYTES = RB * LDQ * E;
  static constexpr int SV_BYTES = RB * LDS * 4 + 32 * LDV * E;
  static constexpr int K_BYTES = KJ * LDK * E;
  static constexpr int STAGE_BYTES =
      Q_BYTES > SV_BYTES ? (Q_BYTES > K_BYTES ? Q_BYTES : K_BYTES)
                         : (SV_BYTES > K_BYTES ? SV_BYTES : K_BYTES);
};

// C's slice holds column col of row p at col ^ swz(p), so that the rows a
// warp's B fragments read fall on different banks
__device__ __forceinline__ int swz(int p) { return ((p >> 1) & 3) << 3; }

// STREAM: w v is computed a staged k tile at a time, into the ring stage
// beside that tile (KJ rows, 5 KB in bf16), in place of all Q rows at once,
// so that shared memory no longer grows with the chunk's rows times TV.
template <typename T, bool STREAM>
__host__ inline int state_smem(int P, int Q) {
  static_assert(State<T>::K_BYTES + 2 * State<T>::KJ * LDV * 2 <= State<T>::STAGE_BYTES,
                "a streamed w v tile fits the ring stage beside its k tile");
  const int pp = round_up(P, 64), q32 = round_up(Q, 32), qr = round_up(Q, RB);
  return 4 * (pp * TV + pp) + (STREAM ? 0 : q32 * LDV * 4) + 4 * (3 * qr + THREADS2) +
         2 * State<T>::STAGE_BYTES;
}

// A contraction over n staged tiles through the two-stage ring: tile s + 1
// is copied while the block computes on tile s, one barrier a tile.
// issue(s, buf) issues the copies of tile s into stage buf, body(s, buf)
// computes on it.
template <class Issue, class Body>
__device__ __forceinline__ void pipeline(int n, Issue issue, Body body) {
  if (n <= 0) return;
  __syncthreads();  // the ring's previous readers are done
  issue(0, 0);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    cp_async_wait_all();
    __syncthreads();  // tile s has landed, and tile s - 1 is no longer read
    if (s + 1 < n) {
      issue(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    body(s, s & 1);
  }
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(THREADS2, 1) mlstm_chunk_state(Params p) {
  using Cfg = State<T>;
  constexpr int KS = Cfg::KS, LDQ = Cfg::LDQ, LDS = Cfg::LDS, KJ = Cfg::KJ, LDK = Cfg::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Q = p.Q, P = p.P;
  const int q64 = round_up(Q, TILE), q32 = round_up(Q, 32), qr = round_up(Q, RB);
  const int pp = round_up(P, 64);
  float* Cs = reinterpret_cast<float*>(smem);  // (pp, TV): this block's columns of C
  float* ns = Cs + pp * TV;                    // (pp,)
  // (q32, LDV): w_j P^-1/2 v_j as two bf16 terms, hi (q32, LDV), then lo
  // (STREAM: none here; the ring stage of each k tile holds its rows)
  float* wvf = ns + pp;
  __nv_bfloat16* wvh = reinterpret_cast<__nv_bfloat16*>(wvf);
  __nv_bfloat16* wvl = wvh + q32 * LDV;
  float* rsum = wvf + (STREAM ? 0 : q32 * LDV);  // (qr,): row sums of S
  float* riw = rsum + qr;         // (qr,): exp(b - m)
  float* re = riw + qr;           // (qr,): exp(-m)
  float* red = re + qr;           // (THREADS2,): q . n halves
  unsigned char* ring = reinterpret_cast<unsigned char*>(red + THREADS2);

  const int t0 = blockIdx.x * TV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* hb = static_cast<T*>(p.h) + ((long long)b * p.L * p.H + h) * P;
  const long long h_sl = (long long)p.H * P;

  for (int e = tid; e < pp * TV; e += THREADS2) Cs[e] = 0.f;
  for (int e = tid; e < pp; e += THREADS2) ns[e] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const long long chunk_id = ((long long)b * p.H + h) * p.nc + c;
    const long long l0 = (long long)c * Q;
    const float* panel = p.panel + chunk_id * q64 * q64;
    const float* scal = p.scal + chunk_id * 3 * q64;
    const float* rp = p.rowpart + chunk_id * (q64 / TILE) * q64;
    const T* qc = qb + l0 * p.q_sl;
    const T* kc = kb + l0 * p.k_sl;
    const T* vc = vb + l0 * p.v_sl;
    __syncthreads();  // the previous chunk is done with w v, the row scalars and C

    // the chunk's row scalars, the state weights, and v (bf16: w v, as two
    // terms)
    for (int i = tid; i < qr; i += THREADS2) {
      float s = 0.f, iw = 0.f, e = 0.f;
      if (i < Q) {
        for (int tj = 0; tj <= i / TILE; ++tj) s += rp[tj * q64 + i];
        iw = scal[i];
        e = scal[q64 + i];
      }
      rsum[i] = s;
      riw[i] = iw;
      re[i] = e;
    }
    // rows [j0, j0 + rows) of w v into (hi, lo) rows of LDV elements
    auto fill_wv = [&](__nv_bfloat16* hi, __nv_bfloat16* lo, int j0, int rows) {
      for (int e = tid; e < rows * (TV / 4); e += THREADS2) {
        const int r = e / (TV / 4), j = j0 + r, col = 4 * (e % (TV / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < Q && t0 + col < P) x = load4(vc + j * p.v_sl + t0 + col);
        const float w = j < Q ? scal[2 * q64 + j] * p.scale : 0.f;
        x = make_float4(x.x * w, x.y * w, x.z * w, x.w * w);
        uint32_t h01, l01, h23, l23;
        split_bf16(x.x, x.y, h01, l01);
        split_bf16(x.z, x.w, h23, l23);
        *reinterpret_cast<uint2*>(hi + r * LDV + col) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(lo + r * LDV + col) = make_uint2(l01, l23);
      }
    };
    if constexpr (!STREAM) fill_wv(wvh, wvl, 0, q32);
    const float carry = p.carry[chunk_id];

    // h, RB rows of the chunk at a time
    const int wr = warp & 3, wc = warp >> 2;
    for (int i0 = 0; i0 < Q; i0 += RB) {
      const int r0 = 32 * wr;  // the warp's first row in the round
      const bool rows_ok = i0 + r0 < Q;
      float acc[2][2][4] = {};
      float qn = 0.f;
      const int qrow = tid & (RB - 1), qhalf = tid / RB;

      // inter: q C over P, and q . n on the CUDA cores
      pipeline(
          (P + KS - 1) / KS,
          [&](int s, int buf) {
            const int p0 = s * KS;
            stage<THREADS2, RB, KS, LDQ>(reinterpret_cast<T*>(ring + buf * Cfg::STAGE_BYTES),
                                         qc + (long long)i0 * p.q_sl + p0, p.q_sl,
                                         [&](int r, int cc) { return i0 + r < Q && p0 + cc < P; });
          },
          [&](int s, int buf) {
            const T* A = reinterpret_cast<const T*>(ring + buf * Cfg::STAGE_BYTES);
            const int p0 = s * KS;
            {
              const T* ar = A + qrow * LDQ + qhalf * (KS / 2);
              const float* nr = ns + p0 + qhalf * (KS / 2);
#pragma unroll
              for (int kk = 0; kk < KS / 2; kk += 4) {
                const float4 x = load4(ar + kk);
                const float4 n4 = *reinterpret_cast<const float4*>(nr + kk);
                qn += x.x * n4.x + x.y * n4.y + x.z * n4.z + x.w * n4.w;
              }
            }
            if (!rows_ok) return;
            float tile[2][2][4] = {};
#pragma unroll
            for (int kk = 0; kk < KS / 16; ++kk) {
              uint32_t a[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4(a[mt], A + (r0 + 16 * mt + (lane & 15)) * LDQ + kk * 16 +
                                       (lane >> 4) * 8);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const int col = 16 * wc + 8 * nt + g, pr = p0 + 16 * kk + 2 * t4;
                uint32_t bh0, bl0, bh1, bl1;
                split_bf16(Cs[pr * TV + (col ^ swz(pr))],
                           Cs[(pr + 1) * TV + (col ^ swz(pr + 1))], bh0, bl0);
                split_bf16(Cs[(pr + 8) * TV + (col ^ swz(pr + 8))],
                           Cs[(pr + 9) * TV + (col ^ swz(pr + 9))], bh1, bl1);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma_bf16(tile[mt][nt], a[mt], bl0, bl1);
                  mma_bf16(tile[mt][nt], a[mt], bh0, bh1);
                }
              }
            }
            add_into(acc, tile);
          
          });
      red[tid] = qn;
      // exp(b_i - m_i) q C, to which S v is added
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float iw = riw[i0 + r0 + 16 * mt + g + 8 * hr];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            acc[mt][nt][2 * hr] *= iw;
            acc[mt][nt][2 * hr + 1] *= iw;
          }
        }
      }

      // intra: S v over the columns j < i0 + RB (S is 0 above the diagonal
      // and past Q; the tiles above the diagonal are zero-filled, not read)
      pipeline(
          (min(Q, i0 + RB) + 31) / 32,
          [&](int s, int buf) {
            float* Sd = reinterpret_cast<float*>(ring + buf * Cfg::STAGE_BYTES);
            T* Vd = reinterpret_cast<T*>(Sd + RB * LDS);
            const int j0 = 32 * s;
            stage<THREADS2, RB, 32, LDS>(Sd, panel + (long long)i0 * q64 + j0, q64,
                                         [&](int r, int) {
                                           return i0 + r < Q && j0 / TILE <= (i0 + r) / TILE;
                                         });
            stage<THREADS2, 32, TV, LDV>(Vd, vc + (long long)j0 * p.v_sl + t0, p.v_sl,
                                         [&](int r, int cc) { return j0 + r < Q && t0 + cc < P; });
          },
          [&](int s, int buf) {
            const float* S = reinterpret_cast<const float*>(ring + buf * Cfg::STAGE_BYTES);
            const T* V = reinterpret_cast<const T*>(S + RB * LDS);
            const int j0 = 32 * s;
            if (!rows_ok) return;
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              if (j0 + 16 * kk > i0 + r0 + 31) break;  // the warp's rows are all above
              uint32_t ah[2][4], al[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const float* sr = S + (r0 + 16 * mt + g) * LDS + 16 * kk + 2 * t4;
                const float2 x0 = *reinterpret_cast<const float2*>(sr);
                const float2 x1 = *reinterpret_cast<const float2*>(sr + 8 * LDS);
                const float2 x2 = *reinterpret_cast<const float2*>(sr + 8);
                const float2 x3 = *reinterpret_cast<const float2*>(sr + 8 * LDS + 8);
                split_bf16(x0.x, x0.y, ah[mt][0], al[mt][0]);
                split_bf16(x1.x, x1.y, ah[mt][1], al[mt][1]);
                split_bf16(x2.x, x2.y, ah[mt][2], al[mt][2]);
                split_bf16(x3.x, x3.y, ah[mt][3], al[mt][3]);
              }
              uint32_t vf[4];
              ldmatrix_x4_trans(vf, V + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                                        16 * wc + (lane >> 4) * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][0], al[mt], vf[0], vf[1]);
                mma_bf16(acc[mt][0], ah[mt], vf[0], vf[1]);
                mma_bf16(acc[mt][1], al[mt], vf[2], vf[3]);
                mma_bf16(acc[mt][1], ah[mt], vf[2], vf[3]);
              }
            }
          
          });

      // h = (S v + exp(b - m) q C) / max(|row sum + exp(b - m) q . n|, exp(-m))
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int il = r0 + 16 * mt + g + 8 * hr, i = i0 + il;
          if (i >= Q) continue;
          const float qn_i = red[il] + red[RB + il];
          const float den = fmaxf(fabsf(rsum[i] + qn_i * riw[i]), re[i]);
          T* out = hb + (l0 + i) * h_sl + t0;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int col = 16 * wc + 8 * nt + 2 * t4;
            if (t0 + col < P)
              store2(out + col, static_cast<float>(acc[mt][nt][2 * hr] / den),
                     static_cast<float>(acc[mt][nt][2 * hr + 1] / den));
          }
        }
      }
    }

    // the state update, PB rows of C at a time: C <- carry C + k^T (w v)
    for (int p0 = 0; p0 < P; p0 += PB) {
      const int pw = 32 * warp;  // the warp's rows of C in the round
      const bool rows_ok = p0 + pw < P;
      float acc[2][4][4] = {};
      pipeline(
          (Q + KJ - 1) / KJ,
          [&](int s, int buf) {
            const int j0 = s * KJ;
            T* kd = reinterpret_cast<T*>(ring + buf * Cfg::STAGE_BYTES);
            stage<THREADS2, KJ, PB, LDK>(kd, kc + (long long)j0 * p.k_sl + p0, p.k_sl,
                                         [&](int r, int cc) { return j0 + r < Q && p0 + cc < P; });
            if constexpr (STREAM) {
              // plain stores: the barrier before this stage is read orders them
              __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(kd + KJ * LDK);
              fill_wv(hi, hi + KJ * LDV, j0, KJ);
            }
          },
          [&](int s, int buf) {
            const T* K = reinterpret_cast<const T*>(ring + buf * Cfg::STAGE_BYTES) + pw;
            // w v's rows of this tile: STREAM, in the stage; else at row j0
            const __nv_bfloat16* wh =
                STREAM ? reinterpret_cast<const __nv_bfloat16*>(K - pw + KJ * LDK) : wvh;
            const __nv_bfloat16* wl = STREAM ? wh + KJ * LDV : wvl;
            const int j0 = s * KJ, jw = STREAM ? 0 : j0;
            if (!rows_ok) return;
#pragma unroll
            for (int kk = 0; kk < KJ / 16; ++kk) {
              uint32_t a[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldmatrix_x4_trans(a[mt], K + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LDK +
                                             16 * mt + ((lane >> 3) & 1) * 8);
#pragma unroll
              for (int nt = 0; nt < 4; nt += 2) {
                const int off = (jw + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                                nt * 8 + (lane >> 4) * 8;
                uint32_t bh[4], bl[4];
                ldmatrix_x4_trans(bh, wh + off);
                ldmatrix_x4_trans(bl, wl + off);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma_bf16(acc[mt][nt], a[mt], bl[0], bl[1]);
                  mma_bf16(acc[mt][nt], a[mt], bh[0], bh[1]);
                  mma_bf16(acc[mt][nt + 1], a[mt], bl[2], bl[3]);
                  mma_bf16(acc[mt][nt + 1], a[mt], bh[2], bh[3]);
                }
              }
            }
          
          });
      // rows of C are this warp's alone
      if (rows_ok) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int pr = p0 + pw + 16 * mt + g + 8 * hr;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int col = 8 * nt + 2 * t4;
              float2* cp = reinterpret_cast<float2*>(Cs + pr * TV + (col ^ swz(pr)));
              const float2 old = *cp;
              *cp = make_float2(carry * old.x + static_cast<float>(acc[mt][nt][2 * hr]),
                                carry * old.y + static_cast<float>(acc[mt][nt][2 * hr + 1]));
            }
          }
        }
      }
    }
    const float* u = p.u + chunk_id * P;
    for (int e = tid; e < P; e += THREADS2) ns[e] = carry * ns[e] + u[e];
  }
}

// Whether a chunk of Q rows streams w v (the chunks whose whole w v does not
// fit beside C: above 256 at P = 1024); both forms compute the same products.
template <typename T>
__host__ inline bool streams(int P, int Q) { return state_smem<T, false>(P, Q) > MAX_SMEM; }
template <typename T>
__host__ inline bool fits(int P, int Q) {
  return panel_smem<T>(Q) <= MAX_SMEM && state_smem<T, true>(P, Q) <= MAX_SMEM;
}

template <typename T, bool STREAM>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem1 = panel_smem<T>(p.Q), smem2 = state_smem<T, STREAM>(p.P, p.Q);
  if (smem1 > MAX_SMEM || smem2 > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_panel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mlstm_chunk_state<T, STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = round_up(p.Q, TILE) / TILE;
  mlstm_chunk_panel<T><<<dim3(tiles * (tiles + 1) / 2, p.nc, B * p.H), THREADS1, smem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_state<T, STREAM><<<dim3((p.P + TV - 1) / TV, p.H, B), THREADS2, smem2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// Floats of fp32 scratch repro_mlstm_scan_fwd needs for these sizes (the
// larger of the two paths' layouts).
extern "C" long long repro_mlstm_scan_scratch_floats(int B, int L, int H, int P, int Q) {
  if (B < 0 || L < 0 || H <= 0 || P <= 0 || Q <= 0 || L % Q != 0) return -1;
  const long long a = simt::scratch_floats(B, L, H, P, Q), b = tc::scratch_floats(B, L, H, P, Q);
  return a > b ? a : b;
}

// dtype (of q, k and v; h is written in it): 0 = float32, 1 = bfloat16.
// i_log and f_log are fp32 (B, L, H), read through their strides.  The
// caller guarantees that the last dims of q, k and v are contiguous and their
// rows start on 4-element boundaries, that P is a multiple of 4 and at most
// 1024, that Q divides L, and that scratch holds
// repro_mlstm_scan_scratch_floats(B, L, H, P, Q) floats; h is (B, L, H, P)
// contiguous.  Returns cudaErrorInvalidValue for sizes it does not take (also
// a chunk whose state pass does not fit one block's shared memory even with
// v streamed: at P = 1024 every chunk up to 2048 fits in both dtypes), else
// cudaGetLastError() after the launches (0 on success); the launches do not
// synchronise.  Chunks above 416 (fp32) or 256 (bf16) at P = 1024 stream v
// through the ring rather than staging the chunk's columns whole.
extern "C" int repro_mlstm_scan_fwd(
    const void* q, const void* k, const void* v, const void* i_log, const void* f_log,
    void* h, void* scratch, int dtype, int B, int L, int H, int P, int Q,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long i_sb, long long i_sl, long long i_sh,
    long long f_sb, long long f_sl, long long f_sh, void* stream) {
  if (B < 0 || L < 0 || H <= 0 || P <= 0 || P > MAX_P || P % 4 != 0 || Q <= 0 ||
      L % Q != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || L == 0) return 0;
  const int nc = L / Q;
  const long long chunks = (long long)B * H * nc;
  const long long q64 = round_up(Q, 64);
  const float scale = 1.0f / sqrtf(static_cast<float>(P));
  float* base = static_cast<float*>(scratch);
  const float* ig = static_cast<const float*>(i_log);
  const float* fg = static_cast<const float*>(f_log);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc > 65535 || (long long)B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (!simt::fits(P, Q)) return static_cast<int>(cudaErrorInvalidValue);
    float* rows = base + chunks * q64 * q64;
    float* u = rows + chunks * 4 * q64;
    simt::Params p{q, k, v, ig, fg, h, base, rows, u, u + chunks * P, L, H, P, Q, nc, scale,
                   q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                   i_sb, i_sl, i_sh, f_sb, f_sl, f_sh};
    return simt::streams(P, Q) ? simt::launch<true>(p, B, s) : simt::launch<false>(p, B, s);
  }
  float* rowpart = base + chunks * q64 * q64;
  float* scal = rowpart + chunks * (q64 / tc::TILE) * q64;
  float* u = scal + chunks * 3 * q64;
  tc::Params p{q, k, v, ig, fg, h, base, rowpart, scal, u, u + chunks * P, L, H, P, Q, nc, scale,
               q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
               i_sb, i_sl, i_sh, f_sb, f_sl, f_sh};
  using BF = __nv_bfloat16;
  if (!tc::fits<BF>(P, Q)) return static_cast<int>(cudaErrorInvalidValue);
  return tc::streams<BF>(P, Q) ? tc::launch<BF, true>(p, B, s) : tc::launch<BF, false>(p, B, s);
}
