// Fused multi-head attention backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_bwd_bhtd` / `_attn_bwd_kernel` in
// findtextcenternet_tpu/ops/attention.py (the custom VJP of
// `fused_attention`). Per (batch b, head h), with A = softmax(q.k^T*scale +
// mask[b]) and g = dOut:
//
//     dV = A^T g
//     dS = A o (g.v^T - rowsum(g.v^T o A))
//     dQ = dS.k * scale,   dK = dS^T.q * scale
//
// f32 only (the routing guard sends only f32 training here). q, k, v, out,
// dOut and the gradients stay in the model's (B, T, H, hd) layout; the
// additive key mask is (B, Tk) f32; the forward's per-row log-sum-exp `lse`
// and the row dot D are (B, H, Tq) f32.
//
// Bound on this card: at the training shape (B=32, H=12, T=400, hd=64) the
// five products are 10*B*H*T*T*hd = 39.3 GFLOP against ~100 MB of operands,
// so it is bound by operations: 0.587 ms at the 67 TFLOP/s f32
// (non-tensor-core) peak. The TPU kernel recomputes the whole 400x400 f32
// softmax tile (640 KB) in VMEM, which does not fit the 227 KB of shared
// memory of a Hopper block. So the softmax is rebuilt tile by tile from the
// forward's log-sum-exp, P = exp(s*scale + mask - lse), and the work is
// split in three launches that never write a score to device memory:
//
//   1. attention_bwd_dot_kernel: D = rowsum(dOut o out), one warp per row
//      (equal to rowsum(g.v^T o A), since out = A.v);
//   2. attention_bwd_dkdv_kernel: one block per (b, h, 64-key tile) holds its
//      K and V rows and walks the query tiles, accumulating dK and dV in
//      registers;
//   3. attention_bwd_dq_kernel: one block per (b, h, 64-query tile) holds its
//      Q and dOut rows and walks the key tiles, accumulating dQ in registers.
//
// No atomics: every gradient element is summed by one thread in a fixed
// order, so the result is the same from run to run. Passes 2 and 3 both
// recompute P and g.v^T (14 T*T*hd multiply-adds per (b, h) where the
// algebra needs 10). Products are plain f32 FMA loops (256 threads, each
// owning a 4 x (BC/16) score patch and 4 x (HDP/16) gradient columns);
// tensor cores and TMA are later work.
//
// Numerics: masked keys get exact-zero gradients (P is exp(-inf) = 0 there).
// A fully masked row has lse = -inf and gives NaN, as autograd of the einsum
// composition does. Head widths: any hd from 1 to 256, built for the width
// padded to a multiple of 16 (HDP) as in attention.cu; above HDP 128 the
// streamed tile narrows to 32 rows to fit shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBR = 64;        // rows a block owns (keys in 2, queries in 3)
constexpr int kMaxHD = 256;

// rows of the tile streamed past the owned rows
template <int HDP>
__host__ __device__ constexpr int stream_rows() {
  return HDP <= 128 ? 64 : 32;
}

// two owned tiles [kBR][HDP+1], two streamed tiles [BC][HDP+1], two score
// tiles [kBR][BC+1] and three vectors (the largest use of passes 2 and 3;
// 214784 bytes at HDP = 256)
template <int HDP>
constexpr size_t smem_bytes() {
  constexpr size_t BC = stream_rows<HDP>();
  return sizeof(float) * (2 * kBR * (HDP + 1) + 2 * BC * (HDP + 1) +
                          2 * kBR * (BC + 1) + 2 * kBR + BC);
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_dot_kernel(const float* __restrict__ out,
                         const float* __restrict__ dout,
                         float* __restrict__ dvec, int rows, int Tq, int H,
                         int hd) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;  // (b, t, h)
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const float* o = out + (size_t)row * hd;
  const float* g = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int bt = row / H, h = row % H;
    const int b = bt / Tq, t = bt % Tq;
    dvec[((size_t)b * H + h) * Tq + t] = acc;
  }
}

// Load rows r0 .. r0+n-1 of one (b, h) slice of a (B, T, H, hd) tensor into
// tile[n][HDP+1], zero-padded past T and hd.
template <int HDP>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          int n, int r0, int T, size_t rs,
                                          int hd) {
  for (int i = threadIdx.x; i < n * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    tile[r * (HDP + 1) + d] =
        (r0 + r < T && d < hd) ? src[(size_t)(r0 + r) * rs + d] : 0.f;
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Tq, int Tk, int H, int hd, float scale) {
  constexpr int BC = stream_rows<HDP>();
  constexpr int kRC = BC / 16;   // query columns of the score patch
  constexpr int kOJ = HDP / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                   // [kBR][HDP + 1]
  float* Vs = Ks + kBR * (HDP + 1);   // [kBR][HDP + 1]
  float* Qs = Vs + kBR * (HDP + 1);   // [BC][HDP + 1]
  float* Gs = Qs + BC * (HDP + 1);    // [BC][HDP + 1]  dOut
  float* Ps = Gs + BC * (HDP + 1);    // [kBR][BC + 1]  P^T
  float* Ss = Ps + kBR * (BC + 1);    // [kBR][BC + 1]  dS^T
  float* Ms = Ss + kBR * (BC + 1);    // [kBR]
  float* Ls = Ms + kBR;               // [BC]
  float* Ds = Ls + BC;                // [BC]

  const int k0 = blockIdx.x * kBR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16;  // key rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // query columns / gradient columns
  const size_t rs = (size_t)H * hd;
  const float* qb = q + ((size_t)b * Tq * H + h) * hd;
  const float* gb = dout + ((size_t)b * Tq * H + h) * hd;
  const float* kb = k + ((size_t)b * Tk * H + h) * hd;
  const float* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* lb = lse + ((size_t)b * H + h) * Tq;
  const float* db = dvec + ((size_t)b * H + h) * Tq;

  load_rows<HDP>(Ks, kb, kBR, k0, Tk, rs, hd);
  load_rows<HDP>(Vs, vb, kBR, k0, Tk, rs, hd);
  for (int r = threadIdx.x; r < kBR; r += kThreads)
    Ms[r] = (k0 + r < Tk) ? mask[(size_t)b * Tk + k0 + r] : -INFINITY;

  float dK[4][kOJ], dV[4][kOJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOJ; ++j) dK[i][j] = dV[i][j] = 0.f;

  for (int c0 = 0; c0 < Tq; c0 += BC) {
    __syncthreads();  // the previous query tile is consumed
    load_rows<HDP>(Qs, qb, BC, c0, Tq, rs, hd);
    load_rows<HDP>(Gs, gb, BC, c0, Tq, rs, hd);
    for (int c = threadIdx.x; c < BC; c += kThreads) {
      const bool in = c0 + c < Tq;
      Ls[c] = in ? lb[c0 + c] : INFINITY;  // padded queries: P = 0
      Ds[c] = in ? db[c0 + c] : 0.f;
    }
    __syncthreads();

    // s = K.Q^T and dp = V.dOut^T on this thread's 4 x kRC patch
    float s[4][kRC], dp[4][kRC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float kv[4], vv[4], qv[kRC], gv[kRC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty * 4 + i) * (HDP + 1) + d];
        vv[i] = Vs[(ty * 4 + i) * (HDP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        qv[j] = Qs[(tx + 16 * j) * (HDP + 1) + d];
        gv[j] = Gs[(tx + 16 * j) * (HDP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kRC; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const float p = expf(s[i][j] * scale + Ms[r] - Ls[c]);
        Ps[r * (BC + 1) + c] = p;
        Ss[r * (BC + 1) + c] = p * (dp[i][j] - Ds[c]);
      }
    __syncthreads();

    // dV += P^T.dOut, dK += dS^T.Q over this query tile
#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float qv[kOJ], gv[kOJ];
#pragma unroll
      for (int j = 0; j < kOJ; ++j) {
        qv[j] = Qs[c * (HDP + 1) + tx + 16 * j];
        gv[j] = Gs[c * (HDP + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (BC + 1) + c];
        const float ds = Ss[(ty * 4 + i) * (BC + 1) + c];
#pragma unroll
        for (int j = 0; j < kOJ; ++j) {
          dV[i][j] = fmaf(p, gv[j], dV[i][j]);
          dK[i][j] = fmaf(ds, qv[j], dK[i][j]);
        }
      }
    }
  }

  float* dkb = dk + ((size_t)b * Tk * H + h) * hd;
  float* dvb = dv + ((size_t)b * Tk * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= Tk) continue;
#pragma unroll
    for (int j = 0; j < kOJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dkb[(size_t)r * rs + d] = dK[i][j] * scale;
        dvb[(size_t)r * rs + d] = dV[i][j];
      }
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        float* __restrict__ dq, int Tq, int Tk, int H, int hd,
                        float scale) {
  constexpr int BC = stream_rows<HDP>();
  constexpr int kRC = BC / 16;   // key columns of the score patch
  constexpr int kOJ = HDP / 16;  // gradient columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBR][HDP + 1]
  float* Gs = Qs + kBR * (HDP + 1);   // [kBR][HDP + 1]  dOut
  float* Ks = Gs + kBR * (HDP + 1);   // [BC][HDP + 1]
  float* Vs = Ks + BC * (HDP + 1);    // [BC][HDP + 1]
  float* Ss = Vs + BC * (HDP + 1);    // [kBR][BC + 1]  dS
  float* Ls = Ss + kBR * (BC + 1);    // [kBR]
  float* Ds = Ls + kBR;               // [kBR]
  float* Ms = Ds + kBR;               // [BC]

  const int q0 = blockIdx.x * kBR, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16;  // query rows ty*4 .. ty*4+3
  const int tx = threadIdx.x % 16;  // key columns / gradient columns
  const size_t rs = (size_t)H * hd;
  const float* qb = q + ((size_t)b * Tq * H + h) * hd;
  const float* gb = dout + ((size_t)b * Tq * H + h) * hd;
  const float* kb = k + ((size_t)b * Tk * H + h) * hd;
  const float* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* lb = lse + ((size_t)b * H + h) * Tq;
  const float* db = dvec + ((size_t)b * H + h) * Tq;

  load_rows<HDP>(Qs, qb, kBR, q0, Tq, rs, hd);
  load_rows<HDP>(Gs, gb, kBR, q0, Tq, rs, hd);
  for (int r = threadIdx.x; r < kBR; r += kThreads) {
    const bool in = q0 + r < Tq;
    Ls[r] = in ? lb[q0 + r] : INFINITY;  // padded queries: P = 0
    Ds[r] = in ? db[q0 + r] : 0.f;
  }

  float acc[4][kOJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kOJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Tk; c0 += BC) {
    __syncthreads();  // the previous key tile is consumed
    load_rows<HDP>(Ks, kb, BC, c0, Tk, rs, hd);
    load_rows<HDP>(Vs, vb, BC, c0, Tk, rs, hd);
    for (int c = threadIdx.x; c < BC; c += kThreads)
      Ms[c] = (c0 + c < Tk) ? mask[(size_t)b * Tk + c0 + c] : -INFINITY;
    __syncthreads();

    // s = Q.K^T and dp = dOut.V^T on this thread's 4 x kRC patch
    float s[4][kRC], dp[4][kRC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[4], gv[4], kv[kRC], vv[kRC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * (HDP + 1) + d];
        gv[i] = Gs[(ty * 4 + i) * (HDP + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (HDP + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (HDP + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kRC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kRC; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        const float p = expf(s[i][j] * scale + Ms[c] - Ls[r]);
        Ss[r * (BC + 1) + c] = p * (dp[i][j] - Ds[r]);
      }
    __syncthreads();

    // dQ += dS.K over this key tile
#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      float kv[kOJ];
#pragma unroll
      for (int j = 0; j < kOJ; ++j) kv[j] = Ks[c * (HDP + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ss[(ty * 4 + i) * (BC + 1) + c];
#pragma unroll
        for (int j = 0; j < kOJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

  float* dqb = dq + ((size_t)b * Tq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Tq) continue;
#pragma unroll
    for (int j = 0; j < kOJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dqb[(size_t)r * rs + d] = acc[i][j] * scale;
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *mask, *out, *dout, *lse;
  float *dvec, *dq, *dk, *dv;
  int B, Tq, Tk, H, hd;
  float scale;
  cudaStream_t stream;
};

template <int HDP>
int launch(const BwdArgs& a) {
  constexpr size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkdv_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;

  const int rows = a.B * a.Tq * a.H;
  const int warps_per_block = kThreads / 32;
  attention_bwd_dot_kernel<<<(rows + warps_per_block - 1) / warps_per_block,
                             kThreads, 0, a.stream>>>(
      a.out, a.dout, a.dvec, rows, a.Tq, a.H, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((a.Tk + kBR - 1) / kBR, a.H, a.B);
  attention_bwd_dkdv_kernel<HDP><<<kgrid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.dk, a.dv, a.Tq, a.Tk,
      a.H, a.hd, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 qgrid((a.Tq + kBR - 1) / kBR, a.H, a.B);
  attention_bwd_dq_kernel<HDP><<<qgrid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.dq, a.Tq, a.Tk, a.H,
      a.hd, a.scale);
  return (int)cudaGetLastError();
}

// the smallest padded width HDP >= hd of HDP = 16, 32, ..., kMaxHD
template <int HDP = 16>
int dispatch_hd(const BwdArgs& a) {
  if (a.hd <= HDP) return launch<HDP>(a);
  if constexpr (HDP < kMaxHD) return dispatch_hd<HDP + 16>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// f32 only. `dvec` is (B, H, Tq) scratch for the row dots. Returns a
// cudaError_t code (0 = ok).
extern "C" int ftcn_attention_bwd(const float* q, const float* k,
                                  const float* v, const float* mask,
                                  const float* out, const float* dout,
                                  const float* lse, float* dvec, float* dq,
                                  float* dk, float* dv, int B, int Tq, int Tk,
                                  int H, int hd, float scale, void* stream) {
  if (hd < 1 || hd > kMaxHD) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q,  k,  v, mask, out, dout, lse,   dvec,
                  dq, dk, dv, B,  Tq,  Tk,   H,   hd,
                  scale, (cudaStream_t)stream};
  return dispatch_hd(a);
}
