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
// Bound on this card: at the training shape (B=32, H=12, T=400, hd=64,
// 5,290 of 12,800 keys unmasked) the five products the algebra needs are
// 10*H*T*hd flops per unmasked key, 16.3 GFLOP, ~0.099 ms at the 165
// TFLOP/s of split-tf32 tensor-core products. It reads q, k, v, out and
// dOut and writes dq, dk and dv, 39.3 MB each: ~315 MB, ~0.094 ms at 3.35
// TB/s. The two times nearly meet; the operations set the bound by ~5 %.
// The TPU kernel recomputes the whole 400x400 f32
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
// Passes 2 and 3 run 4 warps, 16 owned rows each, and every product on the
// tensor cores in the split-tf32 form (attention_mma.cuh): S = K.Q^T and
// dP = V.dOut^T, then dV += P^T.dOut and dK += dS^T.Q from the score
// fragments in registers (pass 2); S = Q.K^T and dP = dOut.V^T, then
// dQ += dS.K (pass 3). The streamed tiles come through a two-stage
// `cp.async` ring. Masked key tiles are skipped: a pass-2 block whose 64 keys
// are all masked writes their (exact-zero) gradients and returns, and pass 3
// steps over such key tiles, where dS = 0.
//
// No atomics: every gradient element is summed by one thread in a fixed
// order, so the result is the same from run to run. Passes 2 and 3 both
// recompute P and g.v^T (14 T*T*hd multiply-adds per (b, h) where the
// algebra needs 10).
//
// Numerics: masked keys get exact-zero gradients (P is exp(-inf) = 0 there).
// A fully masked row has lse = -inf and gives NaN, as autograd of the einsum
// composition does: its window has no unmasked key, so every key tile of it
// is skipped, and the kernels write NaN where lse is -inf. Head widths: any
// hd from 1 to 256, built for the width padded to a multiple of 16 (HDP) as
// in attention.cu; the streamed tile narrows from 64 rows to 32 above HDP
// 64 and to 16 above HDP 128, for registers and shared memory.
#include "attention_mma.cuh"

namespace {

constexpr int kDotThreads = 256;

// rows of the tile streamed past the owned rows
template <int HDP>
__host__ __device__ constexpr int stream_rows() {
  return HDP <= 64 ? 64 : HDP <= 128 ? 32 : 16;
}

// two owned tiles [kRows][LD], two stages of two streamed tiles [BC][LD],
// and the row vectors of either pass (200,448 bytes at HDP = 256)
template <int HDP>
constexpr size_t smem_bytes() {
  constexpr size_t LD = row_stride<float, HDP>(), BC = stream_rows<HDP>();
  return sizeof(float) *
         (2 * kRows * LD + 4 * BC * LD + 2 * kRows + 4 * BC);
}

__global__ void __launch_bounds__(kDotThreads)
attention_bwd_dot_kernel(const float* __restrict__ out,
                         const float* __restrict__ dout,
                         float* __restrict__ dvec, int rows, int Tq, int H,
                         int hd) {
  const int row = (blockIdx.x * kDotThreads + threadIdx.x) / 32;  // (b, t, h)
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
                          int Tq, int Tk, int H, int hd, float scale,
                          bool vec) {
  constexpr int LD = row_stride<float, HDP>();
  constexpr int BC = stream_rows<HDP>();
  constexpr int NT = BC / 8;   // query column tiles of the warp's scores
  constexpr int OT = HDP / 8, CH = chunk<OT>();  // gradient column tiles
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [kRows][LD]
  float* Vs = Ks + kRows * LD;     // [kRows][LD]
  float* Qs = Vs + kRows * LD;     // [2][BC][LD]
  float* Gs = Qs + 2 * BC * LD;    // [2][BC][LD]  dOut
  float* Ls = Gs + 2 * BC * LD;    // [2][BC]
  float* Ds = Ls + 2 * BC;         // [2][BC]
  float* Ms = Ds + 2 * BC;         // [kRows]

  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t rs = (size_t)H * hd;
  const float* qb = q + ((size_t)b * Tq * H + h) * hd;
  const float* gb = dout + ((size_t)b * Tq * H + h) * hd;
  const float* kb = k + ((size_t)b * Tk * H + h) * hd;
  const float* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* lb = lse + ((size_t)b * H + h) * Tq;
  const float* db = dvec + ((size_t)b * H + h) * Tq;
  float* dkb = dk + ((size_t)b * Tk * H + h) * hd;
  float* dvb = dv + ((size_t)b * Tk * H + h) * hd;

  const int key = k0 + (int)threadIdx.x;
  const float mv = ((int)threadIdx.x < kRows && key < Tk)
                       ? mask[(size_t)b * Tk + key] : -INFINITY;
  if (!__syncthreads_or(mv != -INFINITY)) {
    // every key of the tile is masked: exact-zero gradients, or NaN where
    // the window has no unmasked key at all (lse = -inf)
    const float fill = lb[0] == -INFINITY ? NAN : 0.f;
    const int n = min(kRows, Tk - k0);
    for (int i = threadIdx.x; i < n * hd; i += kThreads) {
      const size_t off = (size_t)(k0 + i / hd) * rs + i % hd;
      dkb[off] = fill;
      dvb[off] = fill;
    }
    return;
  }
  if ((int)threadIdx.x < kRows) Ms[threadIdx.x] = mv;
  load_rows<float, HDP>(Ks, kb, kRows, k0, Tk, rs, hd, vec);
  load_rows<float, HDP>(Vs, vb, kRows, k0, Tk, rs, hd, vec);

  auto fetch = [&](int c0, int stage) {
    load_rows<float, HDP>(Qs + stage * BC * LD, qb, BC, c0, Tq, rs, hd, vec);
    load_rows<float, HDP>(Gs + stage * BC * LD, gb, BC, c0, Tq, rs, hd, vec);
    for (int c = threadIdx.x; c < BC; c += kThreads) {
      const bool in = c0 + c < Tq;
      Ls[stage * BC + c] = in ? lb[c0 + c] : INFINITY;  // padded: P = 0
      Ds[stage * BC + c] = in ? db[c0 + c] : 0.f;
    }
  };
  fetch(0, 0);
  cp_commit();

  float dK[OT][4], dV[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int i = 0; i < 4; ++i) dK[ot][i] = dV[ot][i] = 0.f;

  const int nq = (Tq + BC - 1) / BC;
  for (int i = 0; i < nq; ++i) {
    const int stage = i & 1;
    if (i + 1 < nq) fetch((i + 1) * BC, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* Q = Qs + stage * BC * LD;
    const float* G = Gs + stage * BC * LD;
    const float* L = Ls + stage * BC;
    const float* D = Ds + stage * BC;

    // S^T = K.Q^T and dP^T = V.dOut^T on the warp's 16 keys x BC queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HDP / 8; ++ks) {
      const FragA ak = load_a(Ks, LD, warp * 16, ks * 8);
      const FragA av = load_a(Vs, LD, warp * 16, ks * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_split(st[nt], ak, load_b_nk(Q, LD, nt * 8, ks * 8));
        mma_split(dpt[nt], av, load_b_nk(G, LD, nt * 8, ks * 8));
      }
    }
    // P^T and dS^T in place
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mk = Ms[warp * 16 + g + 8 * r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = nt * 8 + 2 * t + j;
          const float p = expf(st[nt][2 * r + j] * scale + mk - L[c]);
          st[nt][2 * r + j] = p;
          dpt[nt][2 * r + j] = p * (dpt[nt][2 * r + j] - D[c]);
        }
    }
    // dV += P^T.dOut, then dK += dS^T.Q, over this query tile, CH gradient
    // column tiles at a time in a fresh accumulator (`chunk`)
#pragma unroll
    for (int oc = 0; oc < OT; oc += CH) {
      float d[CH][4] = {};
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        const FragA ap = a_from_c(st[ks]);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          mma_split(d[c], ap, load_b_kn(G, LD, ks * 8, (oc + c) * 8));
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dV[oc + c][j] += d[c][j];
          d[c][j] = 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        const FragA ads = a_from_c(dpt[ks]);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          mma_split(d[c], ads, load_b_kn(Q, LD, ks * 8, (oc + c) * 8));
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) dK[oc + c][j] += d[c][j];
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= Tk) continue;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = ot * 8 + 2 * t + j;
        if (d < hd) {
          dkb[(size_t)row * rs + d] = dK[ot][2 * r + j] * scale;
          dvb[(size_t)row * rs + d] = dV[ot][2 * r + j];
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
                        float scale, bool vec) {
  constexpr int LD = row_stride<float, HDP>();
  constexpr int BC = stream_rows<HDP>();
  constexpr int NT = BC / 8;   // key column tiles of the warp's scores
  constexpr int OT = HDP / 8, CH = chunk<OT>();  // gradient column tiles
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [kRows][LD]
  float* Gs = Qs + kRows * LD;     // [kRows][LD]  dOut
  float* Ks = Gs + kRows * LD;     // [2][BC][LD]
  float* Vs = Ks + 2 * BC * LD;    // [2][BC][LD]
  float* Ls = Vs + 2 * BC * LD;    // [kRows]
  float* Ds = Ls + kRows;          // [kRows]
  float* Ms = Ds + kRows;          // [2][BC]

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const size_t rs = (size_t)H * hd;
  const float* qb = q + ((size_t)b * Tq * H + h) * hd;
  const float* gb = dout + ((size_t)b * Tq * H + h) * hd;
  const float* kb = k + ((size_t)b * Tk * H + h) * hd;
  const float* vb = v + ((size_t)b * Tk * H + h) * hd;
  const float* lb = lse + ((size_t)b * H + h) * Tq;
  const float* db = dvec + ((size_t)b * H + h) * Tq;
  const float* mb = mask + (size_t)b * Tk;
  const int ntiles = (Tk + BC - 1) / BC;

  load_rows<float, HDP>(Qs, qb, kRows, q0, Tq, rs, hd, vec);
  load_rows<float, HDP>(Gs, gb, kRows, q0, Tq, rs, hd, vec);
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const bool in = q0 + r < Tq;
    Ls[r] = in ? lb[q0 + r] : INFINITY;  // padded queries: P = 0
    Ds[r] = in ? db[q0 + r] : 0.f;
  }

  auto fetch = [&](int tile, int stage, float mv) {
    load_rows<float, HDP>(Ks + stage * BC * LD, kb, BC, tile * BC, Tk, rs, hd,
                          vec);
    load_rows<float, HDP>(Vs + stage * BC * LD, vb, BC, tile * BC, Tk, rs, hd,
                          vec);
    if ((int)threadIdx.x < BC) Ms[stage * BC + threadIdx.x] = mv;
  };
  float mv;
  int cur = next_live_tile<BC>(mb, 0, Tk, mv);
  if (cur < ntiles) fetch(cur, 0, mv);
  cp_commit();

  float acc[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[ot][i] = 0.f;

  for (int stage = 0; cur < ntiles; stage ^= 1) {
    // the barrier in next_live_tile: every warp is done with stage ^ 1
    const int nxt = next_live_tile<BC>(mb, cur + 1, Tk, mv);
    if (nxt < ntiles) fetch(nxt, stage ^ 1, mv);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* K = Ks + stage * BC * LD;
    const float* V = Vs + stage * BC * LD;
    const float* M = Ms + stage * BC;

    // S = Q.K^T and dP = dOut.V^T on the warp's 16 queries x BC keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = dp[nt][j] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HDP / 8; ++ks) {
      const FragA aq = load_a(Qs, LD, warp * 16, ks * 8);
      const FragA ag = load_a(Gs, LD, warp * 16, ks * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_split(s[nt], aq, load_b_nk(K, LD, nt * 8, ks * 8));
        mma_split(dp[nt], ag, load_b_nk(V, LD, nt * 8, ks * 8));
      }
    }
    // dS in place
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const float lr = Ls[row], dr = Ds[row];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p =
              expf(s[nt][2 * r + j] * scale + M[nt * 8 + 2 * t + j] - lr);
          dp[nt][2 * r + j] = p * (dp[nt][2 * r + j] - dr);
        }
    }
    // dQ += dS.K over this key tile, CH column tiles at a time in a fresh
    // accumulator (`chunk`)
#pragma unroll
    for (int oc = 0; oc < OT; oc += CH) {
      float d[CH][4] = {};
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        const FragA ads = a_from_c(dp[ks]);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          mma_split(d[c], ads, load_b_kn(K, LD, ks * 8, (oc + c) * 8));
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[oc + c][j] += d[c][j];
    }
    cur = nxt;
  }
  cp_wait<0>();

  float* dqb = dq + ((size_t)b * Tq * H + h) * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lrow = warp * 16 + g + 8 * r, row = q0 + lrow;
    if (row >= Tq) continue;
    // a fully masked row skipped every key tile: NaN, as the einsum gives
    const bool nan_row = Ls[lrow] == -INFINITY;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = ot * 8 + 2 * t + j;
        if (d < hd)
          dqb[(size_t)row * rs + d] = nan_row ? NAN : acc[ot][2 * r + j] * scale;
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
  const bool vec = a.hd % 4 == 0 && aligned16(a.q) && aligned16(a.k) &&
                   aligned16(a.v) && aligned16(a.dout);

  const int rows = a.B * a.Tq * a.H;
  const int warps_per_block = kDotThreads / 32;
  attention_bwd_dot_kernel<<<(rows + warps_per_block - 1) / warps_per_block,
                             kDotThreads, 0, a.stream>>>(
      a.out, a.dout, a.dvec, rows, a.Tq, a.H, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 kgrid((a.Tk + kRows - 1) / kRows, a.H, a.B);
  attention_bwd_dkdv_kernel<HDP><<<kgrid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.dk, a.dv, a.Tq, a.Tk,
      a.H, a.hd, a.scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 qgrid((a.Tq + kRows - 1) / kRows, a.H, a.B);
  attention_bwd_dq_kernel<HDP><<<qgrid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.dout, a.lse, a.dvec, a.dq, a.Tq, a.Tk, a.H,
      a.hd, a.scale, vec);
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
