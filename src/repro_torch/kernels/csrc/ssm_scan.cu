// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssm_scan_blhp (body
// _ssm_kernel).  What it computes is the same: for each (batch, head) the
// sequence is cut into chunks of Q steps; inside a chunk, with cs the
// inclusive cumsum of dt * a,
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j   (intra-chunk)
//        + exp(cs_i) C_i S                                    (inter-chunk)
//   S   <- exp(cs_Q) S + sum_j exp(cs_Q - cs_j) dt_j B_j^T x_j
// with S the (N, P) fp32 state, zero before the first chunk and written out
// after the last.  The mask is applied before exp, so the j > i entries are
// never evaluated and never overflow.  cs is summed in order, each product
// and sum rounded as the plain version's cumsum rounds them: at |cs| in the
// thousands (chunk 1024) an fp32 ulp is 1e-3, and a parallel scan's other
// rounding moved the state 3.4 times its 1e-4 tolerance from the plain
// version's (PERF.md).
//
// Translation.  The Pallas kernel carries S in VMEM scratch across a
// sequential chunk axis of its grid.  Hopper blocks run in parallel and in no
// order, so here a block loops over the chunks itself.  The value columns of
// y and S are independent: only the panel C B^T and the decays are shared
// across them.  So one block owns one (batch, head, 32 value columns) and
// carries its (N, 32) slice of S from chunk to chunk.  Groups are by index
// (B/C row h / (H / G)); the per-head repeat the TPU wrapper builds is never
// materialised.  x, B and C are read through their strides, fp32 or bf16; dt
// and a are fp32 (the wrapper casts them); y is written in x's dtype and the
// state in fp32.
//
// Work split.  4 warps a block.  A chunk is walked in steps: for each tile of
// 64 rows of y (16 a warp) and each tile of 64 columns j on or below it, the
// step's B and x tiles (and, at the row tile's first step, its C tile; at the
// chunk's first, its dt) come through a two-stage cp.async ring while the
// previous step computes; a step that reads the last step's B and x tiles
// keeps them in place.  At a row tile's first step a warp computes
// exp(cs_i) C_i S (the decay applied after the product, so C stays exact);
// at each step its 16 x 64 part of the panel, the panel's decays and mask,
// and panel @ x_j into a fresh accumulator added to y.  On the diagonal tile
// the 8-column tiles of the panel above a warp's rows are neither computed
// nor multiplied.  The state update rides the chunk's last row tile, whose
// steps see every B and x tile of the chunk: each warp owns 16-row tiles of
// S (warp + 4 m) in registers for the whole scan and adds B_j^T (w_j x_j),
// one fresh accumulator per tile and step; the staged copy of S that C S
// reads is rewritten once a chunk.  Tiles are padded to the MMA shapes and
// masked: any N up to 256 (the registers of the update), any P, any chunk
// whose tiles fit the shared memory (every chunk up to 1024 at N <= 128).
//
// Products.  mma.sync with fp32 accumulation, every product on the tensor
// cores.  bf16 (m16n8k16, ldmatrix): C, B and x are exact in bf16 and go in
// unsplit, so C B^T is one product; the fp32 operands (the decayed panel,
// taken from the accumulator's registers; S, staged as two bf16 terms; and
// w x) go in as two bf16 terms, x = hi + lo with hi = bf16(x).  fp32
// (split-TF32 on m16n8k8): each operand x = hi + lo, hi = x with its 13 low
// bits cleared, and each product is hi*hi + hi*lo + lo*hi, as
// flash_attention.cu does; the fragments of C, B and S (staged transposed)
// come from ldmatrix, which on fp32 data hands each thread the 32-bit word
// of a TF32 fragment; panel @ x and the update take their k index permuted
// within each 8-step (k = t and t + 4 are rows 2t and 2t + 1), so the
// panel's accumulator is its own A fragment.  In fp32 the panel C B^T, the
// dearest product (three TF32 products for each), is the same for every
// head of a group and every 32 columns of P: a first launch (ssm_panel)
// computes it once per (batch, group, chunk) into scratch, and the scan
// reads its fragments from there (L2).  The tensor cores add into their
// accumulator with truncation, so every product a step makes goes into a
// fresh accumulator (or, for C S and C B^T, into one over N alone).
// tests/test_torch_kernels.py models both splits against the tolerance.
//
// Bound.  At the shape the NAS loop gives it at zamba2-2.7b's widths
// (B = 4, L = 2048, H = 80, G = 1, P = N = 64, Q = 128) a call is about 16.2
// GFLOP of unmasked products (per chunk Q (Q + 1) N for each group, Q (Q +
// 1) P + 4 Q N P for each head) and moves about 0.18 GB in bf16 (0.35 GB in
// fp32): both are bound by bytes at 3.35 TB/s, fp32 at 0.104 ms (its
// operations take 0.098 ms at split-TF32's 165 TFLOP/s), bf16 at 0.053 ms.
// The first version of this kernel took 1.6-1.7 ms in both, its products on
// the CUDA cores in one block per (batch, head).  This one (640 blocks at
// that shape) takes about 1.03 ms in fp32 and 0.43 ms in bf16 on an H100
// (PERF.md, scripts/ssm_variants.py), 10 and 8 times the bound.  What holds it back, measured by
// taking parts out: a block walks its 48 steps in order, and with no
// products at all the copies, barriers and stores take 0.21 ms (bf16) and
// 0.34 ms (fp32), of which staging B and C, which every head of a group and
// every 32 columns re-reads from L2, is 0.07-0.12 ms; 640 blocks fill 396
// (bf16) or 264 (fp32) slots in 2 or 3 rounds.  Left for later: wgmma and
// TMA; sharing the B and C tiles of a group across heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int RT = 64;        // rows of a tile of the chunk, 16 a warp
constexpr int PS = 32;        // value columns a block
constexpr int LDS = PS + 8;   // row of the staged state (fp32, or bf16 for each term)
constexpr int MAX_N = 256;    // a warp holds up to 4 16-row tiles of the state
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90
constexpr float LOG2E = 1.4426950408889634f;

// -- PTX wrappers ------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes from global to shared memory asynchronously, of which the
// first `bytes` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until none of this thread's committed copy groups is pending.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a b on a 16x8x16 bf16 tile, fp32 accumulation.  Not volatile: an MMA
// reads and writes registers only, so the compiler may interleave
// independent ones (in source order, the three products of a split-TF32
// step would each wait on the last).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on a 16x8x8 TF32 tile, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- end of PTX wrappers -----------------------------------------------------

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// x0, x1 as two bf16 terms each: hi = bf16(x), lo = bf16(x - hi), packed in
// pairs (x0 in the low half)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// x = hi + lo exactly, hi being x with its 13 low mantissa bits cleared (a
// TF32 value); the tensor core reads lo through its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the four fp32 words of a fragment (from ldmatrix on fp32 data) split
__device__ __forceinline__ void split4(const uint32_t (&r)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), hi[e], lo[e]);
}

// d += a b in split-TF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;       // (B, L, H, P), contiguous, x's dtype
  float* state;  // (B, H, N, P), contiguous
  float* panel;  // fp32: (B G nc) x PanelLayout(Q).chunk_floats(), each chunk's C B^T
  int L, H, G, N, P, Q;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg;
  long long c_sb, c_sl, c_sg;
};

// Shared memory, in this order: two C tiles and two B tiles of (RT, ld)
// elements (N padded to a multiple of 16, rows 16 bytes longer), two x tiles
// of (RT, LDX), the staged state (np * LDS floats: in fp32 transposed, PS
// rows of np + 4; in bf16 its hi term, then its lo term, each np rows of
// LDS), then in floats the chunk's cumsum of dt * a, dt and update weights
// (q64 each), two chunks of raw dt, and the chunk's total (padded to 16
// bytes).
template <typename T>
struct Layout {
  static constexpr int E = static_cast<int>(sizeof(T));
  static constexpr int LDX = PS + 16 / E;
  int np, ld, q64;
  __host__ __device__ Layout(int N, int Q)
      : np(round_up(N, 16)), ld(round_up(N, 16) + 16 / E), q64(round_up(Q, RT)) {}
  __host__ __device__ long long bytes() const {
    return 2LL * RT * (2 * ld + LDX) * E + 4LL * np * LDS + 20LL * q64 + 16;
  }
};

// The fp32 scratch of a chunk's panel C B^T: its tiles on or below the
// diagonal in row order ((0, 0), (1, 0), (1, 1), (2, 0), ...), each of pe x
// pe floats, pe = RT, or Q rounded up to 16 where the chunk is one tile.
// Row i of a tile holds its columns j <= i that a warp's MMA tiles cover.
struct PanelLayout {
  int pe, tiles;
  __host__ __device__ explicit PanelLayout(int Q)
      : pe(Q < RT ? round_up(Q, 16) : RT), tiles(round_up(Q, RT) / RT) {}
  __host__ __device__ long long chunk_floats() const {
    return (long long)tiles * (tiles + 1) / 2 * pe * pe;
  }
  __host__ __device__ long long tile(int ti, int tj) const {
    return ((long long)ti * (ti + 1) / 2 + tj) * pe * pe;
  }
};

// Issues the copies of a tile of RT rows and `width` columns into dst (rows
// of ld elements): element (r, c) from src[r * stride + c] where r < rows
// and c < cols, zero elsewhere.  With vec (src and stride 16-byte aligned)
// each copy is 16 bytes of cp.async, a group that crosses `cols` being
// zero-filled by the copy; otherwise each element goes through registers.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, int width, const T* src, long long stride,
                                      int rows, int cols, bool vec) {
  constexpr int EPG = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    const int groups = width / EPG;
    for (int e = threadIdx.x; e < RT * groups; e += THREADS) {
      const int r = e / groups, c = (e - r * groups) * EPG;
      const int bytes = (r < rows && c < cols) ? min(cols - c, EPG) * static_cast<int>(sizeof(T)) : 0;
      cp_async16(dst + r * ld + c, bytes ? src + r * stride + c : src, bytes);
    }
    return;
  }
  for (int e = threadIdx.x; e < RT * width; e += THREADS) {
    const int r = e / width, c = e - r * width;
    dst[r * ld + c] = (r < rows && c < cols) ? src[r * stride + c] : zero<T>();
  }
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* ptr, long long stride) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (stride * static_cast<long long>(sizeof(T))) % 16 == 0;
}

// pan = C B^T in split-TF32 for 16 rows of C (from row r0 of Cs) and the
// first 2 npair 8-column tiles of B's rows (Bs); both fp32 tiles with rows of
// LD floats, N padded to NP
__device__ __forceinline__ void panel_tf32(float (&pan)[8][4], const float* Cs, const float* Bs,
                                           int LD, int NP, int r0, int npair, int lane) {
  for (int kk = 0; kk < NP / 8; ++kk) {
    uint32_t ra[4], ah[4], al[4];
    ldmatrix_x4(ra, Cs + (r0 + (lane & 15)) * LD + 8 * kk + (lane >> 4) * 4);
    split4(ra, ah, al);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if (n2 < npair) {
        uint32_t rb[4], bh[4], bl[4];
        ldmatrix_x4(rb, Bs + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * LD + 8 * kk +
                            ((lane >> 3) & 1) * 4);
        split4(rb, bh, bl);
        mma3(pan[2 * n2], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(pan[2 * n2 + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
}

// fp32: each chunk's panel C B^T, once per (batch, group, chunk) rather than
// once per head and 32 value columns: one block per 64 x 64 tile on or below
// the diagonal, 16 rows a warp, written to p.panel
__global__ void __launch_bounds__(THREADS) ssm_panel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<float> lay(p.N, p.Q);
  const PanelLayout pl(p.Q);
  const int N = p.N, Q = p.Q, LD = lay.ld, pe = pl.pe;
  float* Cs = reinterpret_cast<float*>(smem);  // (RT, LD)
  float* Bs = Cs + RT * LD;                    // (RT, LD)
  int ti = 0, tj = blockIdx.x;  // tiles in row order: (0,0), (1,0), (1,1), (2,0), ...
  while (tj > ti) tj -= ++ti;
  const int c = blockIdx.y, bg = blockIdx.z, b = bg / p.G, grp = bg % p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const long long l0 = (long long)c * Q;
  const float* cp = static_cast<const float*>(p.cm) + b * p.c_sb + grp * p.c_sg + (l0 + ti * RT) * p.c_sl;
  const float* bp = static_cast<const float*>(p.bm) + b * p.b_sb + grp * p.b_sg + (l0 + tj * RT) * p.b_sl;
  stage(Cs, LD, lay.np, cp, p.c_sl, Q - ti * RT, N, aligned16(cp, p.c_sl));
  stage(Bs, LD, lay.np, bp, p.b_sl, Q - tj * RT, N, aligned16(bp, p.b_sl));
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int iw = ti * RT + 16 * warp;
  if (iw >= Q) return;
  const int npair = min(ti == tj ? warp + 1 : 4, (Q - tj * RT + 15) / 16);
  float pan[8][4] = {};
  panel_tf32(pan, Cs, Bs, LD, lay.np, 16 * warp, npair, lane);
  float* out = p.panel + ((long long)bg * (p.L / Q) + c) * pl.chunk_floats() + pl.tile(ti, tj) +
               (16 * warp + g) * pe + 2 * t4;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < 2 * npair) {
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(pan[n][0], pan[n][1]);
      *reinterpret_cast<float2*>(out + 8 * pe + 8 * n) = make_float2(pan[n][2], pan[n][3]);
    }
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS) ssm_scan_fwd(const Params p) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int LDX = Layout<T>::LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<T> lay(p.N, p.Q);
  const int N = p.N, P = p.P, Q = p.Q, NP = lay.np, LD = lay.ld, q64 = lay.q64;
  T* cbuf = reinterpret_cast<T*>(smem);           // 2 x (RT, LD)
  T* bbuf = cbuf + 2 * RT * LD;                    // 2 x (RT, LD)
  T* xbuf = bbuf + 2 * RT * LD;                    // 2 x (RT, LDX)
  float* sst = reinterpret_cast<float*>(xbuf + 2 * RT * LDX);  // the staged state
  __nv_bfloat16* shi = reinterpret_cast<__nv_bfloat16*>(sst);  // bf16: (NP, LDS) hi terms
  __nv_bfloat16* slo = shi + NP * LDS;                         //       (NP, LDS) lo terms
  const int LDT = NP + 4;       // fp32: the staged state transposed, (PS, LDT)
  float* cs = sst + NP * LDS;   // (q64,): the inclusive cumsum of dt * a, 0 past Q
  float* dts = cs + q64;       // (q64,): dt, 0 past Q
  float* wts = dts + q64;       // (q64,): exp(cs_Q - cs_j) dt_j, 0 past Q
  float* dtst = wts + q64;      // 2 x (q64,): raw dt of a chunk, by chunk parity
  float* total = dtst + 2 * q64;   // cs_Q

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (p.H / p.G);
  const int pw = min(PS, P - p0);  // valid value columns of the block
  const float a = p.a[h];
  const T* xp = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* bp = static_cast<const T*>(p.bm) + b * p.b_sb + grp * p.b_sg;
  const T* cp = static_cast<const T*>(p.cm) + b * p.c_sb + grp * p.c_sg;
  const float* dtp = p.dt + b * p.dt_sb + h * p.dt_sh;
  const bool vx = aligned16(xp, p.x_sl), vb = aligned16(bp, p.b_sl), vc = aligned16(cp, p.c_sl);
  const int nt = (Q + RT - 1) / RT;  // row tiles a chunk
  const int nc = p.L / Q;
  const long long y_sl = (long long)p.H * P;
  T* yp = static_cast<T*>(p.y) + (long long)b * p.L * y_sl + (long long)h * P + p0;

  // the copies of step (c, it, jt): B and x tiles jt into ring slot sb
  // (unless they are in place already); at a row tile's first step its C
  // tile into cb; at a chunk's first step its dt
  auto issue = [&](int c, int it, int jt, int sb, int cb, bool bx) {
    const long long l0 = (long long)c * Q;
    if (it == 0 && jt == 0)
      for (int e = tid; e < Q; e += THREADS)
        cp_async4(dtst + (c & 1) * q64 + e, dtp + (l0 + e) * p.dt_sl);
    if (jt == 0) {
      const int r0 = it * RT;
      stage(cbuf + cb * RT * LD, LD, NP, cp + (l0 + r0) * p.c_sl, p.c_sl, Q - r0, N, vc);
    }
    if (!bx) return;
    const int r0 = jt * RT;
    stage(bbuf + sb * RT * LD, LD, NP, bp + (l0 + r0) * p.b_sl, p.b_sl, Q - r0, N, vb);
    stage(xbuf + sb * RT * LDX, LDX, PS, xp + (l0 + r0) * p.x_sl, p.x_sl, Q - r0, pw, vx);
  };

  // S: a warp's 16-row tiles warp + 4 m, rows 16 (warp + 4 m) + g (+ 8),
  // columns 8 n + 2 t4 (+ 1)
  float sreg[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sreg[m][n][e] = 0.f;
  for (int e = tid; e < NP * LDS; e += THREADS) sst[e] = 0.f;

  if (nc > 0) issue(0, 0, 0, 0, 0, true);
  cp_async_commit();
  int r = 0, slot = 0;  // row tiles so far; the ring slot of the step's B and x tiles
  for (int c = 0; c < nc; ++c) {
    for (int it = 0; it < nt; ++it, ++r) {
      const T* Cs = cbuf + (r & 1) * RT * LD;
      const int iw = it * RT + 16 * warp;  // the warp's first row in the chunk
      const bool rows_ok = iw < Q;
      const bool last = it == nt - 1;  // the state update rides the last row tile
      float y[4][4] = {};
      for (int jt = 0; jt <= it; ++jt) {
        cp_async_wait_all();
        __syncthreads();  // this step's tiles have landed; the last step's are no longer read
        if (it == 0 && jt == 0) {
          // the chunk's cumsum of dt * a: the products by every thread, the
          // sums in order by one, each rounded as the plain version's cumsum
          // rounds them (no fused multiply-add): at |cs| in the thousands an
          // fp32 ulp is 1e-3, so any other order would move exp(cs_i - cs_j)
          // by that
          const float* d = dtst + (c & 1) * q64;
          for (int i = tid; i < q64; i += THREADS) {
            const float dv = i < Q ? d[i] : 0.f;
            dts[i] = dv;
            cs[i] = __fmul_rn(dv, a);
          }
          __syncthreads();
          if (tid == 0) {
            float run = 0.f;
#pragma unroll 4
            for (int i = 0; i < q64; i += 4) {  // past Q the products are 0
              float4 v = *reinterpret_cast<const float4*>(cs + i);
              v.x = run = __fadd_rn(run, v.x);
              v.y = run = __fadd_rn(run, v.y);
              v.z = run = __fadd_rn(run, v.z);
              v.w = run = __fadd_rn(run, v.w);
              *reinterpret_cast<float4*>(cs + i) = v;
            }
            *total = cs[Q - 1];
          }
          __syncthreads();
          {
            const float tot = *total;
            for (int i = tid; i < q64; i += THREADS) {
              if (i >= Q) cs[i] = 0.f;
              wts[i] = i < Q ? exp2_approx((tot - cs[i]) * LOG2E) * dts[i] : 0.f;
            }
          }
          __syncthreads();
        }
        int next_slot;
        {  // the next step's copies
          int c1 = c, it1 = it, jt1 = jt + 1;
          if (jt1 > it1) {
            jt1 = 0;
            if (++it1 == nt) {
              it1 = 0;
              ++c1;
            }
          }
          // the next step's B and x tiles stay in place if it reads the same ones
          const bool same = c1 == c && jt1 == jt;
          next_slot = slot ^ !same;
          if (c1 < nc) issue(c1, it1, jt1, next_slot, (jt1 == 0 ? r + 1 : r) & 1, !same);
          cp_async_commit();
        }
        const T* Bs = bbuf + slot * RT * LD;
        const T* Xs = xbuf + slot * RT * LDX;
        const int j0 = jt * RT;
        // 16-column pairs of panel tiles that hold entries j <= i < Q
        const int npair = min(jt == it ? warp + 1 : 4, (Q - j0 + 15) / 16);

        // inter: y = exp(cs_i) (C_i S)
        if (jt == 0 && rows_ok) {
          if constexpr (BF) {
            for (int kk = 0; kk < NP / 16; ++kk) {
              uint32_t af[4];
              ldmatrix_x4(af, Cs + (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int off = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + 16 * half +
                                (lane >> 4) * 8;
                uint32_t bh[4], bl[4];
                ldmatrix_x4_trans(bh, shi + off);
                ldmatrix_x4_trans(bl, slo + off);
                mma_bf16(y[2 * half], af, bl[0], bl[1]);
                mma_bf16(y[2 * half], af, bh[0], bh[1]);
                mma_bf16(y[2 * half + 1], af, bl[2], bl[3]);
                mma_bf16(y[2 * half + 1], af, bh[2], bh[3]);
              }
            }
          } else {
            const float* Cf = reinterpret_cast<const float*>(Cs);
            for (int kk = 0; kk < NP / 8; ++kk) {
              uint32_t ra[4], ah[4], al[4];
              ldmatrix_x4(ra, Cf + (16 * warp + (lane & 15)) * LD + 8 * kk + (lane >> 4) * 4);
              split4(ra, ah, al);
#pragma unroll
              for (int n2 = 0; n2 < 2; ++n2) {
                uint32_t rb[4], bh[4], bl[4];
                ldmatrix_x4(rb, sst + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * LDT + 8 * kk +
                                    ((lane >> 3) & 1) * 4);
                split4(rb, bh, bl);
                mma3(y[2 * n2], ah, al, bh[0], bh[1], bl[0], bl[1]);
                mma3(y[2 * n2 + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
              }
            }
          }
          const float e0 = exp2_approx(cs[iw + g] * LOG2E), e1 = exp2_approx(cs[iw + g + 8] * LOG2E);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            y[n][0] *= e0;
            y[n][1] *= e0;
            y[n][2] *= e1;
            y[n][3] *= e1;
          }
        }
        if (jt == 0 && last) {
          const float decay = exp2_approx(*total * LOG2E);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sreg[m][n][e] *= decay;
        }

        // intra: the panel C_i B_j^T, its decays and mask, then panel @ x_j
        if (rows_ok) {
          float pan[8][4] = {};
          if constexpr (BF) {
            for (int kk = 0; kk < NP / 16; ++kk) {
              uint32_t af[4];
              ldmatrix_x4(af, Cs + (16 * warp + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
              for (int n2 = 0; n2 < 4; ++n2) {
                if (n2 < npair) {
                  uint32_t kb[4];
                  ldmatrix_x4(kb, Bs + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                      ((lane >> 3) & 1) * 8);
                  mma_bf16(pan[2 * n2], af, kb[0], kb[1]);
                  mma_bf16(pan[2 * n2 + 1], af, kb[2], kb[3]);
                }
              }
            }
          } else {
            // the group's panel, made once a chunk by ssm_panel
            const PanelLayout pl(Q);
            const float* pg = p.panel + ((long long)(b * p.G + grp) * nc + c) * pl.chunk_floats() +
                              pl.tile(it, jt) + (16 * warp + g) * pl.pe + 2 * t4;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              if (n < 2 * npair) {
                const float2 v0 = *reinterpret_cast<const float2*>(pg + 8 * n);
                const float2 v1 = *reinterpret_cast<const float2*>(pg + 8 * pl.pe + 8 * n);
                pan[n][0] = v0.x;
                pan[n][1] = v0.y;
                pan[n][2] = v1.x;
                pan[n][3] = v1.y;
              }
            }
          }
          // panel_ij = (C_i . B_j) exp(cs_i - cs_j) dt_j where j <= i < Q, else 0
          {
            const int i = iw + g;
            const float ci0 = cs[i], ci1 = cs[i + 8];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int j = j0 + 8 * n + 2 * t4 + e;
                const float cj = cs[j], dj = dts[j];
                pan[n][e] = (j <= i && i < Q) ? pan[n][e] * exp2_approx((ci0 - cj) * LOG2E) * dj : 0.f;
                pan[n][2 + e] =
                    (j <= i + 8 && i + 8 < Q) ? pan[n][2 + e] * exp2_approx((ci1 - cj) * LOG2E) * dj : 0.f;
              }
            }
          }
          float fr[4][4] = {};
          if constexpr (BF) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              if (kk < npair) {
                uint32_t ah[4], al[4];
                split_bf16(pan[2 * kk][0], pan[2 * kk][1], ah[0], al[0]);
                split_bf16(pan[2 * kk][2], pan[2 * kk][3], ah[1], al[1]);
                split_bf16(pan[2 * kk + 1][0], pan[2 * kk + 1][1], ah[2], al[2]);
                split_bf16(pan[2 * kk + 1][2], pan[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  uint32_t xf[4];
                  ldmatrix_x4_trans(xf, Xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                            16 * half + (lane >> 4) * 8);
                  mma_bf16(fr[2 * half], al, xf[0], xf[1]);
                  mma_bf16(fr[2 * half], ah, xf[0], xf[1]);
                  mma_bf16(fr[2 * half + 1], al, xf[2], xf[3]);
                  mma_bf16(fr[2 * half + 1], ah, xf[2], xf[3]);
                }
              }
            }
          } else {
            const float* Xf = reinterpret_cast<const float*>(Xs);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              if (kk < 2 * npair) {
                // k permuted: logical k t4 and t4 + 4 are panel columns 2 t4 and 2 t4 + 1
                uint32_t ah[4], al[4];
                split_tf32(pan[kk][0], ah[0], al[0]);
                split_tf32(pan[kk][2], ah[1], al[1]);
                split_tf32(pan[kk][1], ah[2], al[2]);
                split_tf32(pan[kk][3], ah[3], al[3]);
                const float* xr = Xf + (8 * kk + 2 * t4) * LDX + g;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                  uint32_t bh0, bl0, bh1, bl1;
                  split_tf32(xr[8 * n], bh0, bl0);
                  split_tf32(xr[LDX + 8 * n], bh1, bl1);
                  mma3(fr[n], ah, al, bh0, bh1, bl0, bl1);
                }
              }
            }
          }
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[n][e] += fr[n][e];
        }

        // the state update: S += B_j^T (w_j x_j), a fresh accumulator a tile
        if (last) {
          const float* wv = wts + j0;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int m0 = 16 * (warp + 4 * m);
            if (m0 >= NP) continue;
            float fr[1][4][4] = {};
            if constexpr (BF) {
              for (int kk = 0; kk < min(4, (Q - j0 + 15) / 16); ++kk) {
                uint32_t am[4];
                ldmatrix_x4_trans(am, Bs + (16 * kk + (lane & 7) + (lane >> 4) * 8) * LD + m0 +
                                          ((lane >> 3) & 1) * 8);
                const int j = 16 * kk + 2 * t4;
                const float w0 = wv[j], w1 = wv[j + 1], w8 = wv[j + 8], w9 = wv[j + 9];
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  uint32_t xf[4];
                  ldmatrix_x4_trans(xf, Xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                            16 * half + (lane >> 4) * 8);
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const float2 x0 = unpack_bf16(xf[2 * e]), x8 = unpack_bf16(xf[2 * e + 1]);
                    uint32_t bh0, bl0, bh1, bl1;
                    split_bf16(w0 * x0.x, w1 * x0.y, bh0, bl0);
                    split_bf16(w8 * x8.x, w9 * x8.y, bh1, bl1);
                    mma_bf16(fr[0][2 * half + e], am, bl0, bl1);
                    mma_bf16(fr[0][2 * half + e], am, bh0, bh1);
                  }
                }
              }
            } else {
              const float* Bf = reinterpret_cast<const float*>(Bs);
              const float* Xf = reinterpret_cast<const float*>(Xs);
              for (int kk = 0; kk < min(8, (Q - j0 + 7) / 8); ++kk) {
                // k permuted as in panel @ x: rows 2 t4 and 2 t4 + 1 of the step
                const int j = 8 * kk + 2 * t4;
                const float* br = Bf + j * LD + m0 + g;
                uint32_t ah[4], al[4];
                split_tf32(br[0], ah[0], al[0]);
                split_tf32(br[8], ah[1], al[1]);
                split_tf32(br[LD], ah[2], al[2]);
                split_tf32(br[LD + 8], ah[3], al[3]);
                const float w0 = wv[j], w1 = wv[j + 1];
                const float* xr = Xf + j * LDX + g;
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                  uint32_t bh0, bl0, bh1, bl1;
                  split_tf32(w0 * xr[8 * n], bh0, bl0);
                  split_tf32(w1 * xr[LDX + 8 * n], bh1, bl1);
                  mma3(fr[0][n], ah, al, bh0, bh1, bl0, bl1);
                }
              }
            }
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sreg[m][n][e] += fr[0][n][e];
          }
        }
        slot = next_slot;
      }

      // y of the row tile, in x's dtype
      if (rows_ok) {
        const long long l0 = (long long)c * Q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int i = iw + g + 8 * hr;
          if (i >= Q) continue;
          T* out = yp + (l0 + i) * y_sl;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = 8 * n + 2 * t4;
            if (P % 2 == 0 && col + 1 < pw) {
              store2(out + col, y[n][2 * hr], y[n][2 * hr + 1]);
            } else {
              if (col < pw) store1(out + col, y[n][2 * hr]);
              if (col + 1 < pw) store1(out + col + 1, y[n][2 * hr + 1]);
            }
          }
        }
      }
    }

    // the staged copy of S for the next chunk's C S
    __syncthreads();  // every warp has read this chunk's copy
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int m0 = 16 * (warp + 4 * m);
      if (m0 >= NP) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m0 + g + 8 * hr;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = 8 * n + 2 * t4;
          const float v0 = sreg[m][n][2 * hr], v1 = sreg[m][n][2 * hr + 1];
          if constexpr (BF) {
            uint32_t hi, lo;
            split_bf16(v0, v1, hi, lo);
            *reinterpret_cast<uint32_t*>(shi + row * LDS + col) = hi;
            *reinterpret_cast<uint32_t*>(slo + row * LDS + col) = lo;
          } else {
            sst[col * LDT + row] = v0;
            sst[(col + 1) * LDT + row] = v1;
          }
        }
      }
    }
  }

  // the final state, rows < N and columns < P of the block's slice
  float* sp = p.state + ((long long)b * p.H + h) * N * P + p0;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int m0 = 16 * (warp + 4 * m);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + g + 8 * hr;
      if (row >= N) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = 8 * n + 2 * t4;
        if (col < pw) sp[(long long)row * P + col] = sreg[m][n][2 * hr];
        if (col + 1 < pw) sp[(long long)row * P + col + 1] = sreg[m][n][2 * hr + 1];
      }
    }
  }
}

template <typename T, int MT>
int launch_mt(const Params& p, int B, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_fwd<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_scan_fwd<T, MT><<<dim3((p.P + PS - 1) / PS, p.H, B), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (sizeof(T) == 4 && p.L > 0) {  // L = 0: the scan alone writes the zero state
    const int tiles = PanelLayout(p.Q).tiles;
    const int smem1 = 2 * RT * Layout<float>(p.N, p.Q).ld * 4;
    cudaError_t err = cudaFuncSetAttribute(ssm_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_panel<<<dim3(tiles * (tiles + 1) / 2, p.L / p.Q, B * p.G), THREADS, smem1, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = static_cast<int>(Layout<T>(p.N, p.Q).bytes());
  const int mt = (round_up(p.N, 16) / 16 + 3) / 4;  // 16-row tiles of S a warp
  if (mt <= 1) return launch_mt<T, 1>(p, B, smem, stream);
  if (mt <= 2) return launch_mt<T, 2>(p, B, smem, stream);
  return launch_mt<T, 4>(p, B, smem, stream);
}

// Bytes of shared memory a block of the scan needs; -1 for sizes it does
// not take (N above 256, or more than one block may have).
long long smem_bytes(int N, int Q, int dtype) {
  if (N <= 0 || N > MAX_N || Q <= 0 || (dtype != 0 && dtype != 1)) return -1;
  const long long bytes =
      dtype == 0 ? Layout<float>(N, Q).bytes() : Layout<__nv_bfloat16>(N, Q).bytes();
  return bytes <= MAX_SMEM ? bytes : -1;
}

}  // namespace

// Floats of fp32 scratch repro_ssm_scan_fwd needs (each chunk's panel, in
// fp32 only); -1 for sizes it does not take.
extern "C" long long repro_ssm_scan_scratch_floats(int B, int L, int G, int Q, int dtype) {
  if (B < 0 || L < 0 || G <= 0 || Q <= 0 || L % Q != 0 || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? (long long)B * G * (L / Q) * PanelLayout(Q).chunk_floats() : 0;
}

// Bytes of shared memory a block needs at state width N and chunk Q for
// dtype (0 = float32, 1 = bfloat16); -1 for sizes the kernel does not take:
// N above 256, or more than a block's 232448 bytes.
extern "C" long long repro_ssm_scan_smem_bytes(int N, int Q, int dtype) {
  return smem_bytes(N, Q, dtype);
}

// dtype (of x, B and C; y is written in it): 0 = float32, 1 = bfloat16.
// dt is fp32 (B, L, H), read through its strides; a is fp32 (H,),
// contiguous.  The caller guarantees that the last dims of x, B and C are
// contiguous, that Q divides L and G divides H, that y (B, L, H, P) and
// the state (B, H, N, P, fp32) are contiguous, and that scratch holds
// repro_ssm_scan_scratch_floats(B, L, G, Q, dtype) floats.  In fp32 a call
// is two launches (the panels, then the scan).  Returns cudaErrorInvalidValue
// for sizes it does not take (repro_ssm_scan_smem_bytes returns -1), else
// cudaGetLastError() after the launches (0 on success); they do not
// synchronise.
extern "C" int repro_ssm_scan_fwd(
    const void* x, const void* dt, const void* a, const void* bm, const void* cm,
    void* y, void* state, void* scratch, int dtype,
    int B, int L, int H, int G, int N, int P, int Q,
    long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh,
    long long b_sb, long long b_sl, long long b_sg,
    long long c_sb, long long c_sl, long long c_sg, void* stream) {
  const long long smem = smem_bytes(N, Q, dtype);
  if (B < 0 || B > 65535 || L < 0 || H <= 0 || H > 65535 || G <= 0 || H % G != 0 || P <= 0 ||
      Q <= 0 || L % Q != 0 || L / Q > 65535 || (long long)B * G > 65535 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(a), bm, cm, y,
           static_cast<float*>(state), static_cast<float*>(scratch), L, H, G, N, P, Q,
           x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg};
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  return launch<__nv_bfloat16>(p, B, s);
}
