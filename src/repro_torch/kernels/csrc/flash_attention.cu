// Blockwise online-softmax GQA attention (forward) for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_bhsd
// (body _attn_kernel).  What it computes is the same: per query row a running
// max m, a running denominator l and an fp32 accumulator, updated one KV tile
// at a time; masked probabilities are forced to 0, and the output is
// acc / max(l, 1e-30).
//
// Translation.  The Pallas kernel carries (m, l, acc) in VMEM scratch across
// a sequential fourth grid axis.  Hopper blocks run in parallel and in no
// order, so here one block owns one (batch, q-head, q tile) and loops over the
// KV tiles itself; (m, l, acc) stay in registers for the whole loop.  A
// causal loop ends at the diagonal tile and a sliding-window loop starts at
// the window's floor, so tiles the Pallas grid visits only to mask them out
// are never loaded, and q tiles are launched longest-first so that short
// blocks fill in behind long ones.  GQA is by index (kv_head = h / (H / KH));
// repeated KV is never built.  The kernel is given the true lengths S and T
// and masks k_pos >= T itself: the wrapper pads nothing, so the non-causal
// padded-tail fault of the TPU wrapper (padded KV columns attended to) cannot
// occur.  Tensors are read in the model layout (B, S, H, D) through their
// strides; the head dim must be contiguous and rows must start on a
// 4-element boundary.
//
// Bound.  At the served shape (B=1, S=T=512, H=16, KH=8, D=128, causal) the
// products are 4*S*T*D*H/2 = 1.07 GFLOP against under 10 MB moved; at the NAS
// shape (B=1, S=T=2048, H=KH=32, D=80, non-causal) 42.9 GFLOP against 42 MB.
// Both are bound by operations: on the tensor cores, at 989 TFLOP/s in bf16
// and, for fp32 to fp32 accuracy, split-TF32 at 495 / 3 = 165 TFLOP/s.
//
// Work split.  128 threads (4 warps) a block.  The tile pair comes from the
// caller's kernel schedule (block_q, block_kv): a block takes BQ = 64 or 128
// query rows, and each warp owns MT = BQ / 64 tiles of 16 of them, so a row's
// softmax statistics live in the 4 threads of one quad of one warp (rows g
// and g + 8 of a row tile, g = lane / 4) and are never repeated across warps,
// and each K or V fragment a warp reads feeds MT MMAs.  KV tiles are BK = 32,
// 64 or 128 rows.  A pair is built where it fits shared memory and the
// registers (takes()); the wrapper maps a requested pair onto the largest
// built one at or below it.  The named default schedule (128, 128) launches
// the tiles this kernel had before it took schedules at the NAS and served
// head dims: (128, 32) in fp32 and (128, 64) in bf16 at D = 80, (64, 64) at
// D = 128.  Head dims above 128 (to 256) take one row tile.  Both products run on the tensor
// cores with mma.sync:
//   bf16: m16n8k16 with fp32 accumulation.  K fragments come from ldmatrix,
//     V's from ldmatrix.trans, Q's from ldmatrix (once, into registers, at
//     D > 96).  P goes from the Q K^T accumulator straight into the A fragment
//     of P V, rounded to bf16 in registers (as the plain version rounds P
//     before P V), never through shared memory.
//   fp32: split-TF32 on m16n8k8.  Plain TF32 keeps 11 bits and misses the
//     1e-4 tolerance at D=128.  Each operand x is split as x = hi + lo, hi a
//     TF32 value, and each product is hi*hi + hi*lo + lo*hi, for Q K^T and for
//     P V.  The split is one integer and one float instruction (split_tf32):
//     splitting with cvt.rna.tf32 instead makes the kernel 1.4-1.8x slower
//     on an H100 (PERF.md).  Q stays in shared memory and is
//     split as its fragment is loaded (hi and lo fragments of Q beside the O
//     accumulator would not fit the registers).  P V takes P straight from
//     the accumulator of Q K^T: the k index of that product is permuted
//     within each 8-row step (logical k = t and t + 4 are KV rows 2t and
//     2t + 1), so a thread's two accumulator columns are its two A elements
//     and no shuffle is needed; V's B fragment is read with the same
//     permutation.
// KV tiles come through a two-stage ring in dynamic shared memory filled by
// cp.async (16 bytes a copy in fp32, 8 in bf16: the wrapper guarantees
// 4-element alignment, not 8): the next tile's copy is in flight while the
// current tile's products run, with one barrier a tile.  Rows past T and head
// dims past D are zero-filled by the copy (the head dim is padded to a
// multiple of 16), and each shared row is padded by 16 bytes so that the
// ldmatrix rows and the fp32 fragment loads are free of bank conflicts.
// Shared memory: Q tile + 2 x (K + V) tiles (smem_bytes): with the default
// tiles 169 KB in fp32 and 87 KB in bf16 at D=128 (one block a SM in fp32),
// 86 KB and 68 KB at D=80 (two blocks); 195 KB in fp32 at D=256 with
// (64, 32), where Q stays in shared memory and is read a k step at a time in
// both dtypes, so that a thread's registers hold O (128 floats) and the
// scores.
// Masks are evaluated only on tiles that cross the diagonal, the window's
// floor or T.
//
// Left for later (ROADMAP): wgmma from shared memory, TMA copies issued by a
// producer warp, and overlapping one tile's softmax with the next tile's
// products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int DMAX = 256;
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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
// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// d += a b on a 16x8x8 TF32 tile, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x; 2^-1e30 is 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- end of PTX wrappers -----------------------------------------------------

// x = hi + lo exactly, hi being x with its 13 low mantissa bits cleared (a
// TF32 value).  lo goes to the MMA as it is: the tensor core reads the top 19
// bits of a TF32 operand, so lo loses at most 2^-10 of itself, 2^-20 of x.
// One integer and one float instruction, where cvt.rna.tf32 twice an element
// makes the kernel 1.4-1.8x slower on an H100.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T, H, KH, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  int window;  // <= 0: no sliding window
  float scale;
};

// The head dim a kernel is built for: D padded to a multiple of 16 up to
// 128, of 32 above (160, 192, 224, 256).
__host__ __device__ constexpr int dk_of(int D) { return D <= 128 ? (D + 15) / 16 * 16 : (D + 31) / 32 * 32; }

// Bytes of shared memory a block takes: the Q tile, then two stages of (K, V)
// tiles, rows of DK elements padded by 16 bytes.
__host__ __device__ constexpr int smem_bytes(int esize, int DK, int BQ, int BK) {
  return (BQ + 4 * BK) * (DK + 16 / esize) * esize;
}

// Whether a (BQ, BK) tile pair is built for head dim DK in elements of esize
// bytes: BQ = 64 MT query rows (MT 16-row tiles a warp, 1 or 2), BK KV rows.
// It must fit one block's shared memory, and the registers: the fp32
// accumulators a thread holds, MT (DK + BK) / 2 (its share of O and of the
// scores), with the split operands of fp32 (8 a row tile) or bf16's Q
// fragments (DK / 4, held at 96 < DK <= 128 with one row tile), at most 152
// of the 255 a thread may have, leaving the rest to addresses and
// temporaries.  That keeps two row tiles to DK <= 96 (fp32 with 32-row KV
// tiles, bf16 with up to 64), as this kernel has had them since it moved to
// the tensor cores.  repro_torch.kernels.ops.flash_takes is the same rule.
__host__ __device__ constexpr bool takes(int esize, int DK, int BQ, int BK) {
  const int mt = BQ / 64;
  const int extra = esize == 4 ? 8 * mt : (mt == 1 && DK > 96 && DK <= 128 ? DK / 4 : 0);
  return smem_bytes(esize, DK, BQ, BK) <= MAX_SMEM && mt * (DK + BK) / 2 + extra <= 152;
}

// Tiles for head dim DK and a (BQ, BK) tile pair.  Each of the 4 warps owns
// MT 16-row tiles of queries, so that every K and V fragment a warp reads
// from shared memory feeds MT MMAs.  Shared rows are LD elements, 16 bytes
// longer than DK; the Q tile comes first, then two stages of (K, V) tiles.
template <typename T, int DK, int BQ_, int BK_>
struct Config {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int BQ = BQ_;
  static constexpr int BK = BK_;
  static constexpr int MT = BQ / 64;
  static constexpr int LD = DK + 16 / static_cast<int>(sizeof(T));
  static constexpr int TILE = BK * LD;
  static constexpr size_t BYTES = smem_bytes(sizeof(T), DK, BQ, BK);
  static_assert(BQ == 64 * MT && (MT == 1 || MT == 2), "64 or 128 query rows");
  static_assert(BYTES == static_cast<size_t>(BQ * LD + 4 * TILE) * sizeof(T), "layout");
};

// Issues the copies of rows [r0, r0 + ROWS) of a (rows, D) matrix with row
// stride `stride` into `dst` (rows of LD elements), 4 elements a copy; rows
// >= n_rows and columns >= D are zero-filled.  Each thread keeps one
// 4-element column (LANES threads a row: the power of two at or above DK / 4,
// those past it idle) and walks down the rows, so a copy costs one pointer
// step and no addresses are held across the KV loop.
template <typename T, int DK, int LD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride,
                                          int r0, int n_rows, int D) {
  constexpr int CH = DK / 4;
  constexpr int LANES = CH <= 4 ? 4 : CH <= 8 ? 8 : CH <= 16 ? 16 : CH <= 32 ? 32 : 64;
  constexpr int STEP = THREADS / LANES;  // rows a pass
  const int c = 4 * (threadIdx.x % LANES);
  if (c >= DK) return;
  const bool col_ok = c < D;
  int r = threadIdx.x / LANES;
  const T* s = src + static_cast<long long>(r0 + r) * stride + c;
  T* d = dst + r * LD + c;
#pragma unroll 4
  for (; r < ROWS; r += STEP) {
    const bool ok = col_ok && r0 + r < n_rows;
    cp_async<4 * static_cast<int>(sizeof(T))>(d, ok ? s : src, ok);
    s += STEP * stride;
    d += STEP * LD;
  }
}

template <typename T, int DK, int BQ_, int BK_>
__global__ void __launch_bounds__(THREADS) flash_fwd(const Params p) {
  using C = Config<T, DK, BQ_, BK_>;
  constexpr bool BF16 = C::BF16;
  constexpr int MT = C::MT;
  constexpr int BQ = C::BQ;
  constexpr int BK = C::BK;
  constexpr int LD = C::LD;
  constexpr int TILE = C::TILE;
  constexpr int NT = BK / 8;  // 8-column tiles of a score row
  constexpr int ND = DK / 8;  // 8-column tiles of an output row
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* kvs = qs + BQ * LD;  // stage s: K at kvs + 2 s TILE, V TILE after it

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tg = lane & 3;   // thread in the quad
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  int kv_lo = 0;
  int kv_hi = p.T;
  if (p.causal) kv_hi = min(p.T, q0 + BQ);
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  kv_lo = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // Q, then the first KV tile, as two copy groups
  load_tile<T, DK, LD, BQ>(qs, qp, p.q_ss, q0, p.S, p.D);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<T, DK, LD, BK>(kvs, kp, p.k_st, kv_lo, p.T, p.D);
    load_tile<T, DK, LD, BK>(kvs + TILE, vp, p.v_st, kv_lo, p.T, p.D);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const T* qw = qs + warp * 16 * MT * LD;  // this warp's query rows
  // bf16: Q's A fragments.  Held in registers with one row tile at
  // 96 < D <= 128, where shared memory already limits a SM to two blocks;
  // otherwise read at each k step, so that fewer registers let more blocks
  // share the SM (and, above 128, leave room for O).
  constexpr bool Q_REGS = BF16 && MT == 1 && DK > 96 && DK <= 128;
  uint32_t qf[Q_REGS ? DK / 16 : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      ldmatrix_x4(qf[kk], qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
    }
  }

  float o[MT][ND][4];
  float m_row[MT][2];  // rows g and g + 8 of each row tile, in log2 units
  float l_row[MT][2];  // this thread's share of l
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    }
    m_row[mt][0] = m_row[mt][1] = NEG_INF;
    l_row[mt][0] = l_row[mt][1] = 0.f;
  }
  const float scale2 = p.scale * LOG2E;
  const int qpos0 = q0 + warp * 16 * MT + g;  // row g of row tile 0

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_lo + it * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed, and tile it - 1 is no longer read
    if (it + 1 < n_tiles) {
      T* next = kvs + ((it + 1) & 1) * 2 * TILE;
      load_tile<T, DK, LD, BK>(next, kp, p.k_st, t0 + BK, p.T, p.D);
      load_tile<T, DK, LD, BK>(next + TILE, vp, p.v_st, t0 + BK, p.T, p.D);
      cp_async_commit();
    }
    const T* ks = kvs + (it & 1) * 2 * TILE;
    const T* vs = ks + TILE;

    // S = Q K^T: s[mt][j] is the fragment of columns t0 + 8 j .. t0 + 8 j + 7
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
      }
    }
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (Q_REGS) {
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[mt][i] = qf[kk][i];
          } else {
            ldmatrix_x4(qa[mt], qw + (mt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD
                              + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], qa[mt], kb[0], kb[1]);
            mma_bf16(s[mt][j + 1], qa[mt], kb[2], kb[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* qr = reinterpret_cast<const float*>(qw) + (mt * 16 + g) * LD + kk * 8 + tg;
          split_tf32(qr[0], ah[mt][0], al[mt][0]);
          split_tf32(qr[8 * LD], ah[mt][1], al[mt][1]);
          split_tf32(qr[4], ah[mt][2], al[mt][2]);
          split_tf32(qr[8 * LD + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* kr = reinterpret_cast<const float*>(ks) + (j * 8 + g) * LD + kk * 8 + tg;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(s[mt][j], al[mt], bh0, bh1);
            mma_tf32(s[mt][j], ah[mt], bl0, bl1);
            mma_tf32(s[mt][j], ah[mt], bh0, bh1);
          }
        }
      }
    }

    // scale into log2 units, mask (a masked score is -inf, so its
    // probability is 0 against any running max, which starts at -1e30),
    // and update the row statistics
    const bool need_mask = t0 + BK > p.T || (p.causal && t0 + BK - 1 > q0)
                           || (p.window > 0 && t0 <= q0 + BQ - 1 - p.window);
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale2;
      }
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = qpos0 + mt * 16 + (e >> 1) * 8;
            const int kpos = t0 + j * 8 + tg * 2 + (e & 1);
            bool ok = kpos < p.T;
            if (p.causal) ok = ok && kpos <= qpos;
            if (p.window > 0) ok = ok && kpos > qpos - p.window;
            if (!ok) s[mt][j][e] = -INFINITY;
          }
        }
      }
      float mx[2] = {m_row[mt][0], m_row[mt][1]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[mt][r] = exp2_approx(m_row[mt][r] - mx[r]);
        m_row[mt][r] = mx[r];
        l_row[mt][r] *= alpha[mt][r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = exp2_approx(s[mt][j][e] - mx[e >> 1]);
          l_row[mt][e >> 1] += s[mt][j][e];
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[mt][n][0] *= alpha[mt][0];
        o[mt][n][1] *= alpha[mt][0];
        o[mt][n][2] *= alpha[mt][1];
        o[mt][n][3] *= alpha[mt][1];
      }
    }

    // O += P V
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                                    + n * 8 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][n], pa[mt], vb[0], vb[1]);
            mma_bf16(o[mt][n + 1], pa[mt], vb[2], vb[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        // logical k = tg and tg + 4 are KV rows 2 tg and 2 tg + 1 of this step
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_tf32(s[mt][kk][0], ah[mt][0], al[mt][0]);
          split_tf32(s[mt][kk][2], ah[mt][1], al[mt][1]);
          split_tf32(s[mt][kk][1], ah[mt][2], al[mt][2]);
          split_tf32(s[mt][kk][3], ah[mt][3], al[mt][3]);
        }
        const float* vr = reinterpret_cast<const float*>(vs) + (kk * 8 + 2 * tg) * LD + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[n * 8], bh0, bl0);
          split_tf32(vr[n * 8 + LD], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(o[mt][n], al[mt], bh0, bh1);
            mma_tf32(o[mt][n], ah[mt], bl0, bl1);
            mma_tf32(o[mt][n], ah[mt], bh0, bh1);
          }
        }
      }
    }
  }

  // l over the quad, then O / l in the output dtype
  T* op = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_row[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int qpos = qpos0 + mt * 16 + 8 * r;
      if (qpos < p.S) {
        T* orow = op + static_cast<long long>(qpos) * p.o_ss;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const int col = n * 8 + tg * 2;
          if (col < p.D) store2(orow + col, o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <typename T, int DK, int BQ, int BK>
cudaError_t launch_tiles(const Params& p, int B, cudaStream_t stream) {
  if constexpr (!takes(sizeof(T), DK, BQ, BK)) {
    return cudaErrorInvalidValue;
  } else {
  constexpr size_t smem = Config<T, DK, BQ, BK>::BYTES;
  // the shared-memory limit above 48 KB is set once a device
  static bool configured[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES || !configured[dev]) {
    err = cudaFuncSetAttribute(flash_fwd<T, DK, BQ, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEVICES) configured[dev] = true;
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  flash_fwd<T, DK, BQ, BK><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
  }
}

template <typename T, int DK>
cudaError_t launch_dk(const Params& p, int B, int bq, int bk, cudaStream_t stream) {
  if (bq == 64) {
    if (bk == 32) return launch_tiles<T, DK, 64, 32>(p, B, stream);
    if (bk == 64) return launch_tiles<T, DK, 64, 64>(p, B, stream);
    if (bk == 128) return launch_tiles<T, DK, 64, 128>(p, B, stream);
  } else if (bq == 128) {
    if (bk == 32) return launch_tiles<T, DK, 128, 32>(p, B, stream);
    if (bk == 64) return launch_tiles<T, DK, 128, 64>(p, B, stream);
    if (bk == 128) return launch_tiles<T, DK, 128, 128>(p, B, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Params& p, int B, int bq, int bk, cudaStream_t stream) {
  switch (dk_of(p.D)) {
    case 16: return launch_dk<T, 16>(p, B, bq, bk, stream);
    case 32: return launch_dk<T, 32>(p, B, bq, bk, stream);
    case 48: return launch_dk<T, 48>(p, B, bq, bk, stream);
    case 64: return launch_dk<T, 64>(p, B, bq, bk, stream);
    case 80: return launch_dk<T, 80>(p, B, bq, bk, stream);
    case 96: return launch_dk<T, 96>(p, B, bq, bk, stream);
    case 112: return launch_dk<T, 112>(p, B, bq, bk, stream);
    case 128: return launch_dk<T, 128>(p, B, bq, bk, stream);
    case 160: return launch_dk<T, 160>(p, B, bq, bk, stream);
    case 192: return launch_dk<T, 192>(p, B, bq, bk, stream);
    case 224: return launch_dk<T, 224>(p, B, bq, bk, stream);
    case 256: return launch_dk<T, 256>(p, B, bq, bk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Whether the kernel is built for head dim D (a multiple of 4 up to 256) in
// dtype (0 = float32, 1 = bfloat16) with block_q query rows and block_kv KV
// rows a tile (block_q 64 or 128, block_kv 32, 64 or 128; see takes()).
extern "C" int repro_flash_attention_takes(int D, int dtype, int block_q, int block_kv) {
  if (D <= 0 || D > DMAX || D % 4 != 0 || (dtype != 0 && dtype != 1)) return 0;
  if ((block_q != 64 && block_q != 128) || (block_kv != 32 && block_kv != 64 && block_kv != 128))
    return 0;
  return takes(dtype == 0 ? 4 : 2, dk_of(D), block_q, block_kv) ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees D % 4 == 0,
// D <= 256, H % KH == 0, a contiguous head dim, strides that are multiples
// of 4 and pointers aligned to 4 elements, and a tile pair (block_q,
// block_kv) that repro_flash_attention_takes accepts.  The output is written
// in the input dtype once.  Returns the launch's error (0 on success;
// cudaErrorInvalidValue for a tile pair not built); the launch does not
// synchronise.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int T, int H, int KH, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, int block_q, int block_kv, void* stream) {
  if (D % 4 != 0 || D > DMAX || D <= 0 || KH <= 0 || H % KH != 0 ||
      !repro_flash_attention_takes(D, dtype, block_q, block_kv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, o, S, T, H, KH, D,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_ss, o_sh, causal, window, scale};
  if (S <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(p, B, block_q, block_kv, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(p, B, block_q, block_kv, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
