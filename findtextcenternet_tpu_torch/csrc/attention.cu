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
// Bound on this card: at the decode shape (B=4 windows, H=12, T=400,
// hd=64, 768 of 1,600 keys unmasked) the work is 4*H*T*hd flops per
// unmasked key, 0.94 GFLOP, against ~19.7 MB of operands: ~5.7 us at the
// 165 TFLOP/s of split-tf32 tensor-core products, ~5.9 us of memory
// traffic. The TPU kernel holds the whole 400x400 f32 score tile (640 KB)
// on chip, which does not fit the 227 KB of shared memory a Hopper block
// can have. So a block (4 warps, 16 query rows each) takes one 64-row query
// tile of one (b, h) and walks over key tiles with an online softmax
// (running row max and row sum in f32, accumulator rescaled per tile):
// scores never leave the registers, and device memory sees each operand
// once per query tile. Both products, S = Q.K^T and O += P.V, run on the
// tensor cores (attention_mma.cuh: split tf32 for f32, one bf16 pass for
// bf16); the softmax works on the accumulator fragments, and P feeds P.V
// from the registers. K and V tiles stream through a two-stage `cp.async`
// ring, so the next tile loads while the current one is multiplied. A key
// tile whose mask entries are all -inf is skipped (it would add p = 0 and
// leave m, l and the accumulator as they are), so the work follows the
// unmasked keys.
//
// Training: when `lse` is not null the kernel also writes each row's
// log-sum-exp, m + log(l) (-inf for a fully masked row), into `lse` laid out
// (B, H, Tq); the backward kernel (attention_bwd.cu) rebuilds the softmax
// from it. Serving passes null, and its output is the same either way.
#include "attention_mma.cuh"

namespace {

// keys per streamed tile: 64, narrowed to 32 above HDP 128 so that shared
// memory stays under 227 KB (199,936 bytes at HDP = 256 in f32)
template <int HDP>
__host__ __device__ constexpr int key_rows() {
  return HDP <= 128 ? 64 : 32;
}

// Qs[kRows][LD], Ks[2][BK][LD], Vs[2][BK][LD], Ms[2][BK]
template <typename T, int HDP>
constexpr size_t smem_bytes() {
  constexpr size_t LD = row_stride<T, HDP>(), BK = key_rows<HDP>();
  return sizeof(T) * (kRows * LD + 4 * BK * LD) + sizeof(float) * 2 * BK;
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// s[nt] += Q.K^T over the warp's 16 rows and the tile's BK keys
template <int HDP, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const float* Qs, const float* K,
                                       int r0) {
  constexpr int LD = row_stride<float, HDP>();
#pragma unroll
  for (int ks = 0; ks < HDP / 8; ++ks) {
    const FragA a = load_a(Qs, LD, r0, ks * 8);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      mma_split(s[nt], a, load_b_nk(K, LD, nt * 8, ks * 8));
  }
}

template <int HDP, int BK>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const __nv_bfloat16* Qs,
                                       const __nv_bfloat16* K, int r0) {
  constexpr int LD = row_stride<__nv_bfloat16, HDP>();
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const __nv_bfloat16* pa = Qs + (r0 + g) * LD + ks * 16 + 2 * t;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * LD), ld_u32(pa + 8),
                           ld_u32(pa + 8 * LD + 8)};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const __nv_bfloat16* pb = K + (nt * 8 + g) * LD + ks * 16 + 2 * t;
      const uint32_t b[2] = {ld_u32(pb), ld_u32(pb + 8)};
      mma_bf16(s[nt], a, b);
    }
  }
}

// o[ot] = o[ot] * alpha + P.V, P the warp's probabilities in C layout;
// alpha[r] rescales the rows g + 8r. P.V sums in a fresh accumulator
// (`chunk` in attention_mma.cuh).
template <int HDP, int BK>
__device__ __forceinline__ void accumulate(float (&o)[HDP / 8][4],
                                           const float (&p)[BK / 8][4],
                                           const float* V,
                                           const float (&alpha)[2]) {
  constexpr int LD = row_stride<float, HDP>();
  constexpr int OT = HDP / 8, CH = chunk<OT>();
#pragma unroll
  for (int oc = 0; oc < OT; oc += CH) {
    float d[CH][4] = {};
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const FragA a = a_from_c(p[ks]);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        mma_split(d[c], a, load_b_kn(V, LD, ks * 8, (oc + c) * 8));
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[oc + c][i] = fmaf(o[oc + c][i], alpha[i >> 1], d[c][i]);
  }
}

template <int HDP, int BK>
__device__ __forceinline__ void accumulate(float (&o)[HDP / 8][4],
                                           const float (&p)[BK / 8][4],
                                           const __nv_bfloat16* V,
                                           const float (&alpha)[2]) {
  constexpr int LD = row_stride<__nv_bfloat16, HDP>();
  constexpr int OT = HDP / 8, CH = chunk<OT>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int oc = 0; oc < OT; oc += CH) {
    float d[CH][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // C tiles 2kk and 2kk+1 are the A fragment of keys kk*16 .. kk*16+15
      const uint32_t a[4] = {
          pack_bf16(p[2 * kk][0], p[2 * kk][1]),
          pack_bf16(p[2 * kk][2], p[2 * kk][3]),
          pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
          pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int c = 0; c < CH; c += 2) {
        // four 8x8 tiles of V (keys x columns), transposed into the B
        // layout of output column tiles oc + c and oc + c + 1
        const __nv_bfloat16* row =
            V + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
            (oc + c + (lane >> 4)) * 8;
        uint32_t b0[2], b1[2];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
            : "r"(smem_addr(row)));
        mma_bf16(d[c], a, b0);
        mma_bf16(d[c + 1], a, b1);
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[oc + c][i] = fmaf(o[oc + c][i], alpha[i >> 1], d[c][i]);
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int Tq,
                     int Tk, int H, int hd, float scale, bool vec) {
  static_assert(HDP % 16 == 0 && HDP <= kMaxHD, "padded head width");
  constexpr int LD = row_stride<T, HDP>();
  constexpr int BK = key_rows<HDP>();
  constexpr int NT = BK / 8;   // score column tiles a warp holds
  constexpr int OT = HDP / 8;  // output column tiles a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kRows][LD]
  T* Ks = Qs + kRows * LD;                 // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]
  float* Ms = reinterpret_cast<float*>(Vs + 2 * BK * LD);  // [2][BK]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t rs = (size_t)H * hd;
  const T* qb = q + ((size_t)b * Tq * H + h) * hd;
  const T* kb = k + ((size_t)b * Tk * H + h) * hd;
  const T* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* mb = mask + (size_t)b * Tk;
  const int ntiles = (Tk + BK - 1) / BK;

  auto fetch = [&](int tile, int stage, float mv) {
    load_rows<T, HDP>(Ks + stage * BK * LD, kb, BK, tile * BK, Tk, rs, hd,
                      vec);
    load_rows<T, HDP>(Vs + stage * BK * LD, vb, BK, tile * BK, Tk, rs, hd,
                      vec);
    if ((int)threadIdx.x < BK) Ms[stage * BK + threadIdx.x] = mv;
  };

  load_rows<T, HDP>(Qs, qb, kRows, q0, Tq, rs, hd, vec);
  float mv;
  int cur = next_live_tile<BK>(mb, 0, Tk, mv);
  if (cur < ntiles) fetch(cur, 0, mv);
  cp_commit();

  // rows g (registers 0, 1) and g + 8 (registers 2, 3) of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, alpha[2];
  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[ot][i] = 0.f;

  for (int stage = 0; cur < ntiles; stage ^= 1) {
    // the barrier in next_live_tile: every warp is done with stage ^ 1
    const int nxt = next_live_tile<BK>(mb, cur + 1, Tk, mv);
    if (nxt < ntiles) fetch(nxt, stage ^ 1, mv);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* K = Ks + stage * BK * LD;
    const T* V = Vs + stage * BK * LD;
    const float* M = Ms + stage * BK;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    scores<HDP, BK>(s, Qs, K, warp * 16);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * r + j];
          x = x * scale + M[nt * 8 + 2 * t + j];
          tmax = fmaxf(tmax, x);
        }
      // the four lanes of a quad hold one row
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run[r], tmax);
      // all keys so far masked: keep p = 0 (not exp(-inf + inf) = NaN), so
      // a row is NaN only when every key is masked (l_run stays 0)
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new;
      float tsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& x = s[nt][2 * r + j];
          x = expf(x - m_ref);
          tsum += x;
        }
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
      tsum += __shfl_xor_sync(0xffffffffu, tsum, 2);
      alpha[r] = expf(m_run[r] - m_ref);
      l_run[r] = l_run[r] * alpha[r] + tsum;
      m_run[r] = m_new;
    }
    accumulate<HDP, BK>(o, s, V, alpha);
    cur = nxt;
  }
  cp_wait<0>();

  T* ob = out + ((size_t)b * Tq * H + h) * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Tq) continue;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = ot * 8 + 2 * t + j;
        if (d < hd)
          store_f(ob + (size_t)row * rs + d, o[ot][2 * r + j] / l_run[r]);
      }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Tq + row] = m_run[r] + logf(l_run[r]);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, float* lse, int B, int Tq, int Tk, int H, int hd,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HDP>();
  auto kernel = attention_fwd_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = hd % (16 / (int)sizeof(T)) == 0 && aligned16(q) &&
                   aligned16(k) && aligned16(v);
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, Tq, Tk, H,
      hd, scale, vec);
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
