// Blockwise online-softmax GQA attention (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_bhsd
// (body _attn_kernel).  What it computes is the same: per query row a running
// max m, a running denominator l and an fp32 accumulator, updated one KV tile
// at a time; masked scores are -1e30, masked probabilities are forced to 0,
// and the output is acc / max(l, 1e-30).
//
// Translation.  The Pallas kernel carries (m, l, acc) in VMEM scratch across
// a sequential fourth grid axis.  Hopper blocks run in parallel and in no
// order, so here one thread block owns one (batch, q-head, q-tile) and loops
// over the KV tiles itself; (m, l, acc) live in registers for the whole loop.
// K/V tiles are staged in shared memory (fp32, whatever the input dtype).  A
// causal loop ends at the diagonal tile and a sliding-window loop starts at
// the window's floor, so tiles the Pallas grid visits only to mask them out
// are never loaded.  GQA is by index (kv_head = h / (H / KH)); repeated KV is
// never built.  The kernel is given the true lengths S and T and masks
// q_pos >= S and k_pos >= T itself: the wrapper pads nothing, and the
// non-causal padded-tail fault of the TPU wrapper (padded KV columns attended
// to) cannot occur.  Tensors are read in the model layout (B, S, H, D) through
// their strides; the head dim must be contiguous, and rows must start on a
// 4-element boundary so that each thread moves 4 elements (16 bytes in fp32,
// 8 in bf16) a load.
//
// Work split.  128 threads, 4 per query row, 32 rows per block (BQ) and 32
// KV rows per tile (BK).  Thread c of a row owns the float4 chunks
// c, c+4, c+8, ... of the head dim: its slice of q and of the accumulator are
// in registers.  A score is the sum of the 4 threads' partial dots, reduced
// with two xor-shuffles, so every thread of the row holds the tile's 32
// scores and runs the softmax update redundantly; each then adds P @ V for its
// own chunks.  Neighbouring threads read neighbouring 16-byte chunks of a
// shared K/V row, and the 8 rows of a warp read the same addresses
// (broadcast), so shared loads are free of bank conflicts.  A KV tile is
// brought in with every thread's vector loads issued before any of them is
// stored to shared memory, so the tile costs about one memory latency, and
// q tiles are launched longest-first (the last causal tiles have the most
// KV tiles to visit) so that short blocks fill in behind long ones.
//
// Bound.  At the served shape (B=1, S=T=512, H=16, KH=8, D=128, causal) the
// work is about 4*S*T*D*H/2 = 1.07 GFLOP and the data moved is under 10 MB,
// so on the H100 it is bound by operations.  In fp32 they run on the CUDA
// cores (67 TFLOP/s, about 16 us); in bf16 the tensor cores' 989 TFLOP/s would
// be the bound, which this kernel does not reach: it computes in fp32 on the
// CUDA cores in both dtypes.  The design answers the bound by skipping masked
// tiles (half the work when causal), keeping shared-memory traffic
// conflict-free and overlapping a tile's loads across its threads.  It still
// runs an order of magnitude above the bound (PERF.md): every 4 FMAs wait on
// a 16-byte shared load, and at the served shape only 256 blocks of 4 warps
// (about 2 per SM) are in flight to hide latency.  Two query rows per thread,
// mma.sync/wgmma in bf16, TMA and a pipelined KV ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int THREADS = 128;  // 4 threads per query row
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;

// 4 consecutive elements as fp32; p is 4-element aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
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

// NCH: float4 chunks of the head dim per thread (D <= 16 * NCH).
template <typename T, int NCH>
__global__ void __launch_bounds__(THREADS) flash_fwd(const Params p) {
  __shared__ __align__(16) float ks[BK][DMAX];
  __shared__ __align__(16) float vs[BK][DMAX];

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int c = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const int qpos = q0 + row;
  const int nch = p.D >> 2;

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + (long long)qpos * p.q_ss + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  float4 qr[NCH];
  float4 acc[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int ch = c + 4 * i;
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < nch && qpos < p.S) qr[i] = load4(qp + 4 * ch);
  }
  float m = NEG_INF;
  float l = 0.f;

  int kv_lo = 0;
  int kv_hi = p.T;
  if (p.causal) kv_hi = min(p.T, q0 + BQ);
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  kv_lo = (kv_lo / BK) * BK;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += BK) {
    // each thread moves NCH 4-element chunks of K and of V: a tile row holds
    // ROW_CH chunk slots, of which the first nch are the head dim
    constexpr int ROW_CH = 4 * NCH;
    float4 kbuf[NCH], vbuf[NCH];
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int f = tid + u * THREADS;
      const int j = f / ROW_CH;
      const int ch = f % ROW_CH;
      const int kpos = t0 + j;
      kbuf[u] = make_float4(0.f, 0.f, 0.f, 0.f);  // rows past T are zeros:
      vbuf[u] = kbuf[u];                          // 0 * V, never NaN
      if (ch < nch && kpos < p.T) {
        kbuf[u] = load4(kp + (long long)kpos * p.k_st + 4 * ch);
        vbuf[u] = load4(vp + (long long)kpos * p.v_st + 4 * ch);
      }
    }
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int u = 0; u < NCH; ++u) {
      const int f = tid + u * THREADS;
      const int j = f / ROW_CH;
      const int ch = f % ROW_CH;
      if (ch < nch) {
        *reinterpret_cast<float4*>(&ks[j][4 * ch]) = kbuf[u];
        *reinterpret_cast<float4*>(&vs[j][4 * ch]) = vbuf[u];
      }
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int ch = c + 4 * i;
        if (ch < nch) {
          const float4 kv = *reinterpret_cast<const float4*>(&ks[j][4 * ch]);
          dot += qr[i].x * kv.x + qr[i].y * kv.y + qr[i].z * kv.z + qr[i].w * kv.w;
        }
      }
      s[j] = dot;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
    }

    unsigned valid = 0u;
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kpos = t0 + j;
      bool ok = kpos < p.T && qpos < p.S;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      s[j] = ok ? s[j] * p.scale : NEG_INF;
      valid |= (ok ? 1u : 0u) << j;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = ((valid >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = alpha * l + psum;
    m = m_new;

#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int ch = c + 4 * i;
      if (ch < nch) {
        float4 a = acc[i];
        a.x *= alpha; a.y *= alpha; a.z *= alpha; a.w *= alpha;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[j][4 * ch]);
          a.x += s[j] * vv.x; a.y += s[j] * vv.y; a.z += s[j] * vv.z; a.w += s[j] * vv.w;
        }
        acc[i] = a;
      }
    }
  }

  if (qpos >= p.S) return;
  const float den = fmaxf(l, 1e-30f);
  T* op = static_cast<T*>(p.o) + b * p.o_sb + (long long)qpos * p.o_ss + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int ch = c + 4 * i;
    if (ch < nch) {
      store4(op + 4 * ch, make_float4(acc[i].x / den, acc[i].y / den,
                                      acc[i].z / den, acc[i].w / den));
    }
  }
}

template <typename T>
void launch(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + BQ - 1) / BQ, p.H, B);
  if (p.D <= 16) {
    flash_fwd<T, 1><<<grid, THREADS, 0, stream>>>(p);
  } else if (p.D <= 32) {
    flash_fwd<T, 2><<<grid, THREADS, 0, stream>>>(p);
  } else if (p.D <= 64) {
    flash_fwd<T, 4><<<grid, THREADS, 0, stream>>>(p);
  } else {
    flash_fwd<T, 8><<<grid, THREADS, 0, stream>>>(p);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The caller guarantees D % 4 == 0,
// D <= 128, H % KH == 0, a contiguous head dim, strides that are multiples
// of 4 and pointers aligned to 4 elements.  Each thread stores a whole row
// slice of 4 elements, so the output is written in the input dtype once.  Returns cudaGetLastError()
// after the launch (0 on success); the launch does not synchronise.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int S, int T, int H, int KH, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
  if (D % 4 != 0 || D > DMAX || D <= 0 || KH <= 0 || H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, o, S, T, H, KH, D,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           o_sb, o_ss, o_sh, causal, window, scale};
  if (S > 0 && B > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
      launch<float>(p, B, s);
    } else if (dtype == 1) {
      launch<__nv_bfloat16>(p, B, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
