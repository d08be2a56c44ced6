// Fused multi-head attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bhtd` / `_attn_kernel` in
// findtextcenternet_tpu/ops/attention.py (reached through
// `fused_attention`). Per (batch b, head h):
//
//     out = softmax(q . k^T * scale + mask[b]) . v
//
// with f32 score accumulation, an additive (B, Tk) key mask, and the output
// in the inputs' dtype (f32 or bf16). A fully masked row comes out NaN, as
// the einsum composition gives (0/0 below).
//
// Layout: q, k, v and out stay in the model's (B, T, H, hd) layout, row-major
// and contiguous, so the projections feed the kernel and the output
// projection reads its result with no transpose.
//
// Head width: any hd from 1 to 256 (the routing rule sends every multiple of
// 8). The kernel is built for the width padded up to a multiple of 16 (HDP):
// the padded columns of Q, K and V are zeros in shared memory, so they add
// exact zeros to the scores, and the padded output columns are not stored.
// At hd = 64 nothing is padded.
//
// Bound on this card: at the decode shapes (B=4 windows, H=12, T=400,
// hd=64) the work is 4*B*H*T*T*hd = 1.97 GFLOP against ~19.7 MB of
// operands, so it is bound by operations: ~29 us at the 67 TFLOP/s f32
// (non-tensor-core) peak, ~5.9 us of memory traffic. The TPU kernel holds
// the whole 400x400 f32 score tile (640 KB) on chip, which does not fit the
// 227 KB of shared memory a Hopper block can have. So a block takes one
// 64-row query tile of one (b, h) and walks over 64-key tiles with an online
// softmax (running row max and row sum in f32, accumulator rescaled per
// tile): scores never leave the SM, and device memory sees each operand
// once per query tile. This first version multiplies with plain f32 FMA
// loops (256 threads, each owning a 4x4 score patch and a 4x(HDP/16) output
// patch); tensor cores (mma/wgmma) and TMA are later work.
//
// Training: when `lse` is not null the kernel also writes each row's
// log-sum-exp, m + log(l) (-inf for a fully masked row), into `lse` laid out
// (B, H, Tq); the backward kernel (attention_bwd.cu) rebuilds the softmax
// from it. Serving passes null, and its output is the same either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kMaxHD = 256;   // 214 KB of shared memory at HDP = 256

template <int HDP>
constexpr size_t smem_bytes() {
  // Qs[kBQ][HDP+1], Ks[kBK][HDP+1], Vs[kBK][HDP], Ps[kBQ][kBK+1], Ms[kBK]
  return sizeof(float) * ((size_t)kBQ * (HDP + 1) + (size_t)kBK * (HDP + 1) +
                          (size_t)kBK * HDP + (size_t)kBQ * (kBK + 1) + kBK);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int Tq,
                     int Tk, int H, int hd, float scale) {
  static_assert(HDP % 16 == 0 && HDP <= kMaxHD, "padded head width");
  constexpr int kOJ = HDP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [kBQ][HDP + 1]
  float* Ks = Qs + kBQ * (HDP + 1);        // [kBK][HDP + 1]
  float* Vs = Ks + kBK * (HDP + 1);        // [kBK][HDP]
  float* Ps = Vs + kBK * HDP;              // [kBQ][kBK + 1]
  float* Ms = Ps + kBQ * (kBK + 1);        // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;   // rows ty*4 .. ty*4+3
  const int tx = tid % 16;   // score columns tx + 16*j, output columns too
  const size_t row_stride = (size_t)H * hd;
  const T* qb = q + ((size_t)b * Tq * H + h) * hd;
  const T* kb = k + ((size_t)b * Tk * H + h) * hd;
  const T* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* mb = mask + (size_t)b * Tk;

  for (int i = tid; i < kBQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    Qs[r * (HDP + 1) + d] = (q0 + r < Tq && d < hd)
        ? load_f(qb + (size_t)(q0 + r) * row_stride + d) : 0.f;
  }

  float m_run[4], l_run[4], acc[4][kOJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();  // previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < kBK * HDP; i += kThreads) {
      const int c = i / HDP, d = i % HDP;
      const bool in = k0 + c < Tk && d < hd;
      const size_t off = (size_t)(k0 + c) * row_stride + d;
      Ks[c * (HDP + 1) + d] = in ? load_f(kb + off) : 0.f;
      Vs[c * HDP + d] = in ? load_f(vb + off) : 0.f;
    }
    for (int c = tid; c < kBK; c += kThreads) {
      Ms[c] = (k0 + c < Tk) ? mb[k0 + c] : -INFINITY;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (HDP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (HDP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] * scale + Ms[tx + 16 * j];
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads sharing a row are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run[i], tmax);
      // all keys so far masked: keep p = 0 (not exp(-inf + inf) = NaN), so
      // a row is NaN only when every key is masked (l_run stays 0)
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
      float tsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_ref);
        Ps[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
        tsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      const float alpha = expf(m_run[i] - m_ref);
      l_run[i] = l_run[i] * alpha + tsum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[kOJ];
#pragma unroll
      for (int j = 0; j < kOJ; ++j) vv[j] = Vs[c * HDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
        for (int j = 0; j < kOJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = out + ((size_t)b * Tq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kOJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store_f(ob + (size_t)r * row_stride + d, acc[i][j] / l_run[i]);
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Tq + r] = m_run[i] + logf(l_run[i]);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, float* lse, int B, int Tq, int Tk, int H, int hd,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HDP>();
  auto kernel = attention_fwd_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, Tq, Tk, H,
      hd, scale);
  return (int)cudaGetLastError();
}

// the smallest padded width HDP >= hd of HDP = 16, 32, ..., kMaxHD
template <typename T, int HDP = 16>
int dispatch_hd(const void* q, const void* k, const void* v,
                const float* mask, void* out, float* lse, int B, int Tq,
                int Tk, int H, int hd, float scale, cudaStream_t stream) {
  if (hd <= HDP)
    return launch<T, HDP>(q, k, v, mask, out, lse, B, Tq, Tk, H, hd, scale,
                          stream);
  if constexpr (HDP < kMaxHD)
    return dispatch_hd<T, HDP + 16>(q, k, v, mask, out, lse, B, Tq, Tk, H,
                                    hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `lse` may be null (serving). Returns a
// cudaError_t code (0 = ok).
extern "C" int ftcn_attention_fwd(const void* q, const void* k, const void* v,
                                  const float* mask, void* out, float* lse,
                                  int B, int Tq, int Tk, int H, int hd,
                                  int dtype, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (hd < 1 || hd > kMaxHD) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, mask, out, lse, B, Tq, Tk, H, hd,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, mask, out, lse, B, Tq, Tk, H,
                                      hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
