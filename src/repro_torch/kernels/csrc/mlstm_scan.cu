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
// them.  So the call is two launches:
//
// 1. mlstm_chunk_panel, one block per (batch, head, chunk), all in parallel.
//    Warp 0 runs the scalar m chain over the gates of the chunks before this
//    one (it depends on the gates only).  The block then writes the chunk's
//    stabilised, masked panel S (transposed, to global scratch), its row
//    sums, exp(b_i - m_i), exp(-m_i), the state weights exp(w_j - m'), the
//    carry exp(ftot + m - m') and the chunk's n update sum_j k_j exp(w_j - m').
//    The panel is computed in 64 x 64 tiles, only those on or below the
//    diagonal; the tiles above it are written as zeros.
// 2. mlstm_chunk_state, one block per (batch, head, 32 value columns),
//    loops over the chunks in order with its (P, 32) slice of C (128 KB at
//    P = 1024) and n in shared memory: h = S v + exp(b - m) q C, then the
//    state update.  Each block computes q . n for the denominator (1/32 of
//    its products) rather than a third launch.
//
// Work split.  256 threads.  Every product is a tile of 64 (panel) or 128
// (pass 2) rows times a k-major operand staged in shared memory 32
// reduction steps at a time; a thread owns a 4 x 4 block of the output, so
// two 16-byte shared loads feed 16 FMAs.  Pass 2's tiles are double-
// buffered: the next tile is read from global memory into registers while
// the block computes on the current one, and stored transposed (q) with
// neighbouring threads on neighbouring words.  Staged tiles have rows of
// 68 or 132 floats.  Inputs are read through their strides (the last dim
// contiguous and rows aligned to 4 elements), fp32 or bf16, converted to
// fp32 as they are staged; gates are fp32; all sums are fp32; h is written
// in q's dtype.  Chunks need not be powers of two (100 for L = 200): rows
// and columns past Q or P are zero-filled and masked.
//
// Bound.  At the forward shape of xlstm-1.3b (B = 1, L = 2048, H = 4,
// P = 1024, Q = 128) a call is about 36.5 GFLOP of unmasked fp32 products
// (2 Q (Q + 1) P + 4 Q P^2 per chunk and head: the panel and S v on or
// below the diagonal, q C and the C update) and moves about 0.13 GB, so on
// the H100 it is bound by operations: about 0.55 ms at the CUDA cores'
// 67 TFLOP/s.  The design answers it by computing the panel and the n
// update once per chunk (not once per column block), only the panel tiles
// on or below the diagonal, by 4 x 4 register blocks, by overlapping tile
// loads with the products, and by filling 128 SMs at B = 1.  The products
// run on the CUDA cores, not the tensor cores; the masked half of the
// diagonal tiles is computed and discarded; every column block streams the
// whole of q and k from L2.  Those are later work (PERF.md has the
// measured time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = 64;       // rows of a product tile (chunk rows, panel columns, rows of P)
constexpr int TV = 32;       // value columns per pass-2 block
constexpr int KT = 32;       // reduction steps per staged tile
constexpr int LDA = RB + 4;  // row of a staged k-major tile
constexpr int RB2 = 128;     // rows of a pass-2 tile (chunk rows, rows of P)
constexpr int LDA2 = RB2 + 4;
constexpr int MAX_P = 1024;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr float BIG_NEG = -1e6f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
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
__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

__host__ inline int panel_smem(int Q) { return 4 * (5 * round_up(Q, RB) + 2 * KT * LDA); }
__host__ inline int state_smem(int P, int Q) {
  const int p128 = round_up(P, RB2);
  return 4 * (p128 * TV + p128 + round_up(Q, KT) * TV + 2 * KT * LDA2 + 4 * round_up(Q, RB) +
              THREADS);
}

// dst[pp][ii] = src[(r0 + ii) * rs + p0 + pp] for a 64-row, KT-column tile
// (k-major, rows of LDA floats); zero past row nrows or column P.  Eight
// threads read a row's 32 elements together.
template <typename T>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, long long rs, int r0,
                                                 int nrows, int p0, int P) {
  for (int e = threadIdx.x; e < RB * (KT / 4); e += THREADS) {
    const int ii = e / (KT / 4), pp = 4 * (e % (KT / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + ii < nrows && p0 + pp < P) x = load4(src + (long long)(r0 + ii) * rs + p0 + pp);
    dst[(pp + 0) * LDA + ii] = x.x;
    dst[(pp + 1) * LDA + ii] = x.y;
    dst[(pp + 2) * LDA + ii] = x.z;
    dst[(pp + 3) * LDA + ii] = x.w;
  }
}

// ---------------------------------------------------------------------------
// pass 1: the chunk's panel and per-row scalars
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS) mlstm_chunk_panel(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, q64 = round_up(Q, RB);
  float* fcum = smem;        // (q64,)
  float* igs = fcum + q64;   // (q64,)
  float* mrow = igs + q64;   // (q64,)
  float* rsum = mrow + q64;  // (q64,)
  float* kws = rsum + q64;   // (q64,)
  float* As = kws + q64;     // (KT, LDA): q^T
  float* Bs = As + KT * LDA; // (KT, LDA): k^T
  __shared__ float sh_mprev, sh_mnext, sh_ftot;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long chunk_id = ((long long)b * p.H + h) * p.nc + c;
  const float* igp = p.ig + b * p.i_sb + h * p.i_sh;
  const float* fgp = p.fg + b * p.f_sb + h * p.f_sh;

  // 1. the m chain over the chunks up to this one (warp 0): fcum is an
  // inclusive shuffle scan 32 steps at a time
  if (tid < 32) {
    float m = BIG_NEG;
    for (int cc = 0; cc <= c; ++cc) {
      const long long l0 = (long long)cc * Q;
      float run = 0.f;
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + tid;
        float f = j < Q ? fgp[(l0 + j) * p.f_sl] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(FULL, f, off);
          if (tid >= off) f += o;
        }
        f += run;
        if (j < Q) {
          fcum[j] = f;
          igs[j] = igp[(l0 + j) * p.i_sl];
        }
        run = __shfl_sync(FULL, f, 31);
      }
      __syncwarp();
      const float ftot = fcum[Q - 1];
      float wmax = -INFINITY;
      for (int j = tid; j < Q; j += 32) wmax = fmaxf(wmax, ftot - fcum[j] + igs[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) wmax = fmaxf(wmax, __shfl_xor_sync(FULL, wmax, off));
      const float m_next = fmaxf(fmaxf(ftot + m, wmax), BIG_NEG);
      if (cc < c) {
        m = m_next;
      } else if (tid == 0) {
        sh_mprev = m;
        sh_mnext = m_next;
        sh_ftot = ftot;
      }
      __syncwarp();  // every lane has read fcum before the next chunk writes it
    }
  }
  __syncthreads();

  // 2. per-row scalars: the stabiliser m_i is the row max of the same a_ij
  // the panel weights use
  const float m_prev = sh_mprev, m_next = sh_mnext, ftot = sh_ftot;
  float* rows = p.rows + chunk_id * 4 * q64;
  for (int i = tid; i < q64; i += THREADS) {
    float mi = 0.f, iw = 0.f, e = 0.f, kw = 0.f;
    if (i < Q) {
      const float fi = fcum[i];
      float amax = -INFINITY;
      for (int j = 0; j <= i; ++j) amax = fmaxf(amax, fi - fcum[j] + igs[j]);
      const float b_log = fi + m_prev;
      mi = fmaxf(fmaxf(amax, b_log), BIG_NEG);
      iw = expf(b_log - mi);
      e = expf(-mi);
      kw = expf(ftot - fi + igs[i] - m_next);
    }
    mrow[i] = mi;
    rsum[i] = 0.f;
    kws[i] = kw;
    rows[q64 + i] = iw;
    rows[2 * q64 + i] = e;
    rows[3 * q64 + i] = kw;
  }
  if (tid == 0) p.carry[chunk_id] = expf(ftot + m_prev - m_next);
  __syncthreads();

  // 3. the n update of the chunk, u = sum_j (k_j P^-1/2) exp(w_j - m'), once
  // here rather than in every value-column block of pass 2
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + (long long)c * Q * p.q_sl;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + (long long)c * Q * p.k_sl;
  for (int pq = 4 * tid; pq < p.P; pq += 4 * THREADS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
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

  // 4. the panel, 64 x 64 tiles on or below the diagonal; a thread owns rows
  // i0 + 4 ty + r and columns j0 + 4 tx + cc
  float* panel = p.panel + chunk_id * q64 * q64;
  const int ty = tid / 16, tx = tid % 16;
  for (int i0 = 0; i0 < q64; i0 += RB) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    // the tiles above the diagonal are all masked: zeros, which pass 2
    // reads in its 128-row tiles
    for (int j0 = i0 + RB; j0 < q64; j0 += RB)
      for (int e = tid; e < RB * RB / 4; e += THREADS)
        *reinterpret_cast<float4*>(panel + (long long)(j0 + e / (RB / 4)) * q64 + i0 +
                                   4 * (e % (RB / 4))) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 <= i0; j0 += RB) {
      float acc[4][4] = {};
      for (int p0 = 0; p0 < p.P; p0 += KT) {
        stage_transposed(As, qp, p.q_sl, i0, Q, p0, p.P);
        stage_transposed(Bs, kp, p.k_sl, j0, Q, p0, p.P);
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < KT; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * LDA + 4 * ty);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * LDA + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ar = get(a, r);
            acc[r][0] += ar * bv.x;
            acc[r][1] += ar * bv.y;
            acc[r][2] += ar * bv.z;
            acc[r][3] += ar * bv.w;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + 4 * tx + cc;
        float s[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ty + r;
          s[r] = 0.f;
          if (i < Q && j <= i)
            s[r] = acc[r][cc] * p.scale * expf(fcum[i] - fcum[j] + igs[j] - mrow[i]);
          part[r] += s[r];
        }
        *reinterpret_cast<float4*>(panel + (long long)j * q64 + i0 + 4 * ty) =
            make_float4(s[0], s[1], s[2], s[3]);
      }
    }
    // row sums over the 16 threads of a row group (one half-warp)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) part[r] += __shfl_xor_sync(FULL, part[r], off);
      if (tx == 0) rsum[i0 + 4 * ty + r] = part[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < q64; i += THREADS) rows[i] = rsum[i];
}

// ---------------------------------------------------------------------------
// pass 2: h and the state, one block per (batch, head, 32 value columns)
// ---------------------------------------------------------------------------

// A 32 x 128 tile in flight: each thread holds 4 of its 1024 quads in
// registers while the block computes on the previous tile.
struct Tile4 {
  float4 r[4];
};

// acc[r][cc] += sum_kk A[kk][4 ty + r] B[kk][4 tx + cc] over a staged tile:
// two 16-byte shared loads feed 16 FMAs.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < KT; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(A + kk * LDA2 + 4 * ty);
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

// A 128-row, 32-column tile stored transposed: quad e is row e % 128,
// columns 4 (e / 128); neighbouring threads write neighbouring words.
__device__ __forceinline__ void put_transposed(const Tile4& t, float* dst) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + u * THREADS;
    float* d = dst + 4 * (e / RB2) * LDA2 + e % RB2;
    d[0] = t.r[u].x;
    d[LDA2] = t.r[u].y;
    d[2 * LDA2] = t.r[u].z;
    d[3 * LDA2] = t.r[u].w;
  }
}

// A contraction over n staged tiles, double-buffered: tile s + 1 is read
// from global memory into registers while the block computes on tile s.
template <class Fetch, class Put, class Body>
__device__ __forceinline__ void pipeline(float* As, int n, Fetch fetch, Put put, Body body) {
  Tile4 t;
  fetch(t, 0);
  put(t, As);
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) fetch(t, s + 1);
    body(As + (s & 1) * KT * LDA2, s);
    if (s + 1 < n) put(t, As + ((s + 1) & 1) * KT * LDA2);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) mlstm_chunk_state(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, P = p.P;
  const int q64 = round_up(Q, RB), q32 = round_up(Q, KT), p128 = round_up(P, RB2);
  float* Cs = smem;               // (p128, TV): this block's columns of C
  float* ns = Cs + p128 * TV;     // (p128,)
  float* vs = ns + p128;          // (q32, TV): the chunk's v columns
  float* As = vs + q32 * TV;      // 2 x (KT, LDA2)
  float* rs = As + 2 * KT * LDA2; // (4, q64): the chunk's row scalars
  float* red = rs + 4 * q64;      // (THREADS,): q . n partials

  const int t0 = blockIdx.x * TV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // rows 4 ty + r, columns 4 tx + cc
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* hb = static_cast<T*>(p.h) + ((long long)b * p.L * p.H + h) * P;
  const long long h_sl = (long long)p.H * P;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < p128 * TV; e += THREADS) Cs[e] = 0.f;
  for (int e = tid; e < p128; e += THREADS) ns[e] = 0.f;

  for (int c = 0; c < p.nc; ++c) {
    const long long chunk_id = ((long long)b * p.H + h) * p.nc + c;
    const long long l0 = (long long)c * Q;
    const float* panel = p.panel + chunk_id * q64 * q64;
    const T* qc = qb + l0 * p.q_sl;
    const T* kc = kb + l0 * p.k_sl;
    __syncthreads();  // the previous chunk is done with vs, rs, ns and As
    for (int e = tid; e < 4 * q64; e += THREADS) rs[e] = p.rows[chunk_id * 4 * q64 + e];
    for (int e = tid; e < q32 * (TV / 4); e += THREADS) {
      const int j = e / (TV / 4), col = 4 * (e % (TV / 4));
      float4 x = zero;
      if (j < Q && t0 + col < P) x = load4(vb + (l0 + j) * p.v_sl + t0 + col);
      *reinterpret_cast<float4*>(vs + j * TV + col) = x;
    }
    const float carry = p.carry[chunk_id];
    __syncthreads();

    // h, 128 rows of the chunk at a time
    for (int i0 = 0; i0 < Q; i0 += RB2) {
      float ai[4][4] = {}, ae[4][4] = {};
      // intra: S v over the columns j < i0 + 128 (S is 0 above the diagonal
      // and past Q; the panel's rows are zero-padded to q64)
      pipeline(
          As, (min(Q, i0 + RB2) + KT - 1) / KT,
          [&](Tile4& t, int s) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = tid + u * THREADS, jj = e / 32, ii = 4 * (e % 32);
              t.r[u] = i0 + ii < q64 ? *reinterpret_cast<const float4*>(
                                           panel + (long long)(s * KT + jj) * q64 + i0 + ii)
                                     : zero;
            }
          },
          put_rows, [&](const float* A, int s) { mma_tile(ai, A, vs + s * KT * TV, ty, tx); });
      // inter: q C and q . n over P
      float qn = 0.f;
      const int row = tid % RB2, half = tid / RB2;  // q . n: 16 of a tile's 32 steps
      pipeline(
          As, (P + KT - 1) / KT,
          [&](Tile4& t, int s) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = tid + u * THREADS, ii = e % RB2, pq = 4 * (e / RB2);
              t.r[u] = (i0 + ii < Q && s * KT + pq < P)
                           ? load4(qc + (long long)(i0 + ii) * p.q_sl + s * KT + pq)
                           : zero;
            }
          },
          put_transposed,
          [&](const float* A, int s) {
            mma_tile(ae, A, Cs + s * KT * TV, ty, tx);
#pragma unroll
            for (int kk = 16 * half; kk < 16 * half + 16; ++kk)
              qn += A[kk * LDA2 + row] * ns[s * KT + kk];
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
        T* out = hb + (l0 + i) * h_sl + t0 + 4 * tx;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (t0 + 4 * tx + cc < P) store(out + cc, (ai[r][cc] + ae[r][cc] * iw) / den);
      }
    }

    // the state update, 128 rows of P at a time: C <- carry C + (k w)^T v
    for (int pr0 = 0; pr0 < P; pr0 += RB2) {
      float acc[4][4] = {};
      pipeline(
          As, (Q + KT - 1) / KT,
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
          put_rows, [&](const float* A, int s) { mma_tile(acc, A, vs + s * KT * TV, ty, tx); });
      // rows of C are this thread's alone
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* cp = reinterpret_cast<float4*>(Cs + (pr0 + 4 * ty + r) * TV + 4 * tx);
        const float4 old = *cp;
        *cp = make_float4(carry * old.x + acc[r][0], carry * old.y + acc[r][1],
                          carry * old.z + acc[r][2], carry * old.w + acc[r][3]);
      }
    }
    const float* u = p.u + chunk_id * P;
    for (int e = tid; e < P; e += THREADS) ns[e] = carry * ns[e] + u[e];
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem1 = panel_smem(p.Q), smem2 = state_smem(p.P, p.Q);
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_panel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mlstm_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_panel<T><<<dim3(p.nc, p.H, B), THREADS, smem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_state<T><<<dim3((p.P + TV - 1) / TV, p.H, B), THREADS, smem2, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of fp32 scratch repro_mlstm_scan_fwd needs for these sizes.
extern "C" long long repro_mlstm_scan_scratch_floats(int B, int L, int H, int P, int Q) {
  if (B < 0 || L < 0 || H <= 0 || P <= 0 || Q <= 0 || L % Q != 0) return -1;
  return scratch_floats(B, L, H, P, Q);
}

// dtype (of q, k and v; h is written in it): 0 = float32, 1 = bfloat16.
// i_log and f_log are fp32 (B, L, H), read through their strides.  The
// caller guarantees that the last dims of q, k and v are contiguous and their
// rows start on 4-element boundaries, that P is a multiple of 4 and at most
// 1024, that Q divides L, and that scratch holds
// repro_mlstm_scan_scratch_floats(B, L, H, P, Q) floats; h is (B, L, H, P)
// contiguous.  Returns cudaErrorInvalidValue for sizes it does not take (also a
// chunk whose pass-2 shared memory does not fit one block: above about 430
// at P = 1024), else cudaGetLastError() after the launches (0 on success);
// the launches do not synchronise.
extern "C" int repro_mlstm_scan_fwd(
    const void* q, const void* k, const void* v, const void* i_log, const void* f_log,
    void* h, void* scratch, int dtype, int B, int L, int H, int P, int Q,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long i_sb, long long i_sl, long long i_sh,
    long long f_sb, long long f_sl, long long f_sh, void* stream) {
  if (B < 0 || L < 0 || H <= 0 || P <= 0 || P > MAX_P || P % 4 != 0 || Q <= 0 ||
      L % Q != 0 || panel_smem(Q) > MAX_SMEM || state_smem(P, Q) > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || L == 0) return 0;
  const int nc = L / Q;
  const long long chunks = (long long)B * H * nc;
  const long long q64 = round_up(Q, RB);
  float* base = static_cast<float*>(scratch);
  Params p{q, k, v, static_cast<const float*>(i_log), static_cast<const float*>(f_log), h,
           base, base + chunks * q64 * q64, base + chunks * (q64 * q64 + 4 * q64),
           base + chunks * (q64 * q64 + 4 * q64 + P),
           L, H, P, Q, nc, 1.0f / sqrtf(static_cast<float>(P)),
           q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
           i_sb, i_sl, i_sh, f_sb, f_sl, f_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
