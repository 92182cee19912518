// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssm_scan_blhp (body
// _ssm_kernel).  What it computes is the same: for each (batch, head) the
// sequence is cut into chunks of Q steps; inside a chunk, with cs the
// inclusive cumsum of dt * a,
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j   (intra-chunk)
//        + exp(cs_i) C_i S                                    (inter-chunk)
//   S   <- exp(cs_Q) S + sum_j exp(cs_Q - cs_j) dt_j B_j^T x_j
// with S the (N, P) fp32 state, zero before the first chunk and written out
// after the last.  The mask is applied in log space before exp, so the
// j > i entries are never evaluated and never overflow.
//
// Translation.  The Pallas kernel carries S in VMEM scratch across a
// sequential chunk axis of its grid and holds a whole (Q, Q) panel.  Hopper
// blocks run in parallel and in no order, so here one thread block owns one
// (batch, head) and loops over the chunks itself, with S in shared memory
// for the whole loop.  A (Q, Q) fp32 panel is 256 KB at Q = 256, more than a
// block's shared memory, so the panel is computed one 64 x 64 tile at a
// time: for each tile of 64 rows of y, the column tiles j0 <= i0 only (the
// tiles above the diagonal are all masked and are never visited).  Groups
// are by index (B/C row h / (H / G)); the per-head repeat the TPU wrapper
// builds is never materialised.  Inputs are read through their strides
// (only the last dim must be contiguous), fp32 or bf16, converted to fp32
// in shared memory; dt and a are fp32; all sums are fp32; y is written in
// x's dtype and the state in fp32.
//
// Work split.  256 threads as a 16 x 16 grid (ty, tx), two blocks an SM
// (at most 128 registers a thread).  For y a thread owns rows ty + 16 r
// (r < 4) of the current 64-row tile and the columns 4 tx .. 4 tx + 3 of
// P (at most 64, zero-padded to 64); its accumulators stay in registers across the
// inter-chunk product and every column tile.  For the panel it owns the
// entries (ty + 16 r, tx + 16 c); for the state the rows 4 ty .. 4 ty + 3
// of each 64-row group of N and the same columns as for y.  Every product
// steps its reduction 4 at a time with 16-byte shared loads, so 8 loads
// feed 64 FMAs.  Tiles are row-major fp32 in shared memory, zero-padded
// to the widths the loops read, and are loaded 4 elements a load where
// the operand's rows are aligned to 4 (as at the NAS shape).  The C and B
// tiles have rows of 64 NG + 4 floats (4 mod 32), so the 16 B rows a warp
// reads for the panel fall in distinct banks.  The chunk's cumsum is one warp's shuffle scan,
// 32 steps at a time.
//
// Bound.  At the shape the NAS loop gives it at zamba2-2.7b's widths
// (B = 4, L = 2048, H = 80, P = N = 64, Q = 128) a call is about 22 GFLOP of
// unmasked fp32 products (Q (Q + 1) (N + P) + 4 Q N P per chunk and head)
// and moves about 0.34 GB, so on the H100 it is bound by operations: about
// 0.32 ms at the CUDA cores' 67 TFLOP/s, against 0.10 ms for the bytes.
// The design answers the bound by skipping the masked tiles of the panel,
// by 8 shared loads for 64 FMAs free of bank conflicts, and by two blocks
// an SM, so that one block's tile loads overlap the other's products.  The
// products still run on the CUDA cores, not the tensor cores, and the
// masked half of each diagonal tile is computed and discarded.
// mma.sync/wgmma on bf16 or tf32 tiles and asynchronous (cp.async/TMA)
// tile loads are later work (PERF.md has the measured time).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr int TILE = 64;      // rows of y per tile, panel columns per tile
constexpr int RPT = TILE / 16;
constexpr int PANEL_LD = TILE + 4;
constexpr int MAX_N = 128;
constexpr int MAX_P = 64;
constexpr int PW = 64;        // P padded: the row of the state and of the X tile
constexpr int MAX_SMEM = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
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

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  void* y;       // (B, L, H, P), contiguous, x's dtype
  float* state;  // (B, H, N, P), contiguous
  int L, H, G, N, P, Q;
  long long x_sb, x_sl, x_sh;
  long long dt_sb, dt_sl, dt_sh;
  long long b_sb, b_sl, b_sg;
  long long c_sb, c_sl, c_sg;
};

// Shared-memory layout, in floats.  nw: N rounded up to 64 (the state's
// rows); ldn = nw + 4: the row of the C and B tiles; PW: the row of the
// state and of the X tile; q4: Q rounded up to 4.
struct Layout {
  int nw, ldn, q4;
  __host__ __device__ Layout(int N, int Q)
      : nw((N + 63) / 64 * 64), ldn((N + 63) / 64 * 64 + 4), q4((Q + 3) / 4 * 4) {}
  __host__ __device__ int floats() const {
    return nw * PW + 2 * q4 + 2 * TILE * ldn + TILE * PW + TILE * PANEL_LD;
  }
};

// Rows [row0, row0 + rows) of a (L, K) operand into a TILE x width fp32
// tile with rows of ld floats, scaled by w[r] when w is given; entries
// past `rows` or past K are zero.  width and ld are multiples of 4.  When
// K is a multiple of 4 and every row of the operand starts on a 4-element
// boundary, each thread moves 4 elements a load; otherwise one.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int width, const T* src,
                                          long long row_stride, int row0, int rows, int K,
                                          const float* w) {
  const T* base = src + (long long)row0 * row_stride;
  const bool vec = K % 4 == 0 && row_stride % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(base) % (4 * sizeof(T)) == 0;
  if (vec) {
    const int w4 = width >> 2;
    for (int e = threadIdx.x; e < TILE * w4; e += THREADS) {
      const int r = w4 == 16 ? e >> 4 : e / w4;
      const int k = (e - r * w4) << 2;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && k < K) {
        v = load4(base + r * row_stride + k);
        if (w != nullptr) {
          const float s = w[r];
          v = make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
        }
      }
      *reinterpret_cast<float4*>(dst + r * ld + k) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < TILE * width; e += THREADS) {
    const int r = width == 64 ? e >> 6 : e / width;
    const int k = e - r * width;
    float v = 0.f;
    if (r < rows && k < K) {
      v = to_f(base[r * row_stride + k]);
      if (w != nullptr) v *= w[r];
    }
    dst[r * ld + k] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) ssm_scan_fwd(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, P = p.P, Q = p.Q;
  const Layout lay(N, Q);
  const int ldn = lay.ldn;
  const int n4 = (N + 3) & ~3;
  float* S = smem;                 // (nw, PW) state
  float* cs = S + lay.nw * PW;     // (Q,) inclusive cumsum of dt * a
  float* dts = cs + lay.q4;        // (Q,) dt, then exp(cs_Q - cs_j) dt_j
  float* Ct = dts + lay.q4;        // (TILE, ldn)
  float* Bt = Ct + TILE * ldn;     // (TILE, ldn): B for the panel, dt-weighted B for S
  float* Xt = Bt + TILE * ldn;     // (TILE, PW)
  float* panel = Xt + TILE * PW;   // (TILE, PANEL_LD)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float a = p.a[h];
  const T* xp = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtp = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bp = static_cast<const T*>(p.bm) + b * p.b_sb + g * p.b_sg;
  const T* cp = static_cast<const T*>(p.cm) + b * p.c_sb + g * p.c_sg;
  const long long y_sl = (long long)p.H * P;
  T* yp = static_cast<T*>(p.y) + (long long)b * p.L * y_sl + (long long)h * P;

  for (int e = tid; e < lay.nw * PW; e += THREADS) S[e] = 0.f;

  for (int l0 = 0; l0 < p.L; l0 += Q) {
    __syncthreads();  // S is zeroed, or the last chunk's update is done

    // dt and the inclusive cumsum of dt * a over the chunk: one warp
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        const float d = i < Q ? dtp[(long long)(l0 + i) * p.dt_sl] : 0.f;
        float v = d * a;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (i < Q) {
          cs[i] = v;
          dts[i] = d;
        }
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();

    // y, one tile of TILE rows at a time
    for (int i0 = 0; i0 < Q; i0 += TILE) {
      load_tile(Ct, ldn, n4, cp, p.c_sl, l0 + i0, min(TILE, Q - i0), N, nullptr);
      __syncthreads();

      // inter-chunk: acc = exp(cs_i) (C_i S)
      float acc[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < n4; n += 4) {
        float4 cv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) cv[r] = load4(Ct + (ty + 16 * r) * ldn + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 sv = load4(S + (n + k) * PW + 4 * tx);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float c_ = get(cv[r], k);
            acc[r][0] += c_ * sv.x;
            acc[r][1] += c_ * sv.y;
            acc[r][2] += c_ * sv.z;
            acc[r][3] += c_ * sv.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      // intra-chunk: the column tiles on or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        const int tj = min(TILE, Q - j0);
        load_tile(Bt, ldn, n4, bp, p.b_sl, l0 + j0, tj, N, nullptr);
        load_tile(Xt, PW, PW, xp, p.x_sl, l0 + j0, tj, P, nullptr);
        __syncthreads();

        float d[RPT][4];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[r][c] = 0.f;
        for (int n = 0; n < n4; n += 4) {
          float4 cv[RPT], bv[4];
#pragma unroll
          for (int r = 0; r < RPT; ++r) cv[r] = load4(Ct + (ty + 16 * r) * ldn + n);
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = load4(Bt + (tx + 16 * c) * ldn + n);
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              d[r][c] += cv[r].x * bv[c].x + cv[r].y * bv[c].y + cv[r].z * bv[c].z +
                         cv[r].w * bv[c].w;
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // masked before exp: j > i is never evaluated
            panel[(ty + 16 * r) * PANEL_LD + tx + 16 * c] =
                (i < Q && j <= i) ? d[r][c] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
          }
        }
        __syncthreads();

        // acc += panel @ X; panel columns past tj are zero, as are X's rows
        for (int j = 0; j < tj; j += 4) {
          float4 pv[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) pv[r] = load4(panel + (ty + 16 * r) * PANEL_LD + j);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 xv = load4(Xt + (j + k) * PW + 4 * tx);
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const float p_ = get(pv[r], k);
              acc[r][0] += p_ * xv.x;
              acc[r][1] += p_ * xv.y;
              acc[r][2] += p_ * xv.z;
              acc[r][3] += p_ * xv.w;
            }
          }
        }
        __syncthreads();  // Bt, Xt and the panel are free again
      }

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < Q) {
          T* row = yp + (long long)(l0 + i) * y_sl;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (4 * tx + c < P) store(row + 4 * tx + c, acc[r][c]);
          }
        }
      }
    }

    // state: S <- exp(cs_Q) S + sum_j (exp(cs_Q - cs_j) dt_j B_j)^T x_j
    const float total = cs[Q - 1];
    __syncthreads();  // every row tile has read S and dts
    for (int j = tid; j < Q; j += THREADS) dts[j] *= expf(total - cs[j]);
    const float decay = expf(total);
    for (int n0 = 0; n0 < lay.nw; n0 += 64) {  // a thread owns rows n0 + 4 ty + r
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 sv = load4(S + (n0 + 4 * ty + r) * PW + 4 * tx);
        s[r][0] = decay * sv.x;
        s[r][1] = decay * sv.y;
        s[r][2] = decay * sv.z;
        s[r][3] = decay * sv.w;
      }
      for (int j0 = 0; j0 < Q; j0 += TILE) {
        const int tj = min(TILE, Q - j0);
        __syncthreads();  // dts is scaled; the last tile's reads are done
        load_tile(Bt, ldn, lay.nw, bp, p.b_sl, l0 + j0, tj, N, dts + j0);
        load_tile(Xt, PW, PW, xp, p.x_sl, l0 + j0, tj, P, nullptr);
        __syncthreads();
        for (int j = 0; j < tj; ++j) {
          const float4 wv = load4(Bt + j * ldn + n0 + 4 * ty);
          const float4 xv = load4(Xt + j * PW + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w_ = get(wv, r);
            s[r][0] += w_ * xv.x;
            s[r][1] += w_ * xv.y;
            s[r][2] += w_ * xv.z;
            s[r][3] += w_ * xv.w;
          }
        }
      }
      // rows of S are this thread's alone: no other thread reads them
      // before the next chunk's barrier
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(S + (n0 + 4 * ty + r) * PW + 4 * tx) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
  }
  __syncthreads();
  float* sp = p.state + ((long long)b * p.H + h) * N * P;
  for (int e = tid; e < N * P; e += THREADS) sp[e] = S[(e / P) * PW + e % P];
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = 4 * Layout(p.N, p.Q).floats();
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_scan_fwd<T><<<dim3(p.H, B), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of x, B and C; y is written in it): 0 = float32, 1 = bfloat16.
// dt is fp32 (B, L, H); a is fp32 (H,), contiguous.  The caller guarantees
// that the last dims of x, B and C are contiguous, that Q divides L and G
// divides H.  N is at most 128, P at most 64, and the shared
// memory of Layout(N, Q) must fit in one block.  Returns cudaGetLastError()
// after the launch (0 on success); the launch does not synchronise.
extern "C" int repro_ssm_scan_fwd(
    const void* x, const void* dt, const void* a, const void* bm, const void* cm,
    void* y, void* state, int dtype,
    int B, int L, int H, int G, int N, int P, int Q,
    long long x_sb, long long x_sl, long long x_sh,
    long long dt_sb, long long dt_sl, long long dt_sh,
    long long b_sb, long long b_sl, long long b_sg,
    long long c_sb, long long c_sl, long long c_sg, void* stream) {
  if (B < 0 || L < 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || N > MAX_N ||
      P <= 0 || P > MAX_P || Q <= 0 || L % Q != 0 ||
      4 * Layout(N, Q).floats() > MAX_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(a), bm, cm, y,
           static_cast<float*>(state), L, H, G, N, P, Q,
           x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, b_sg, c_sb, c_sl, c_sg};
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
