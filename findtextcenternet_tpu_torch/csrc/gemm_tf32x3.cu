// f32 matrix product on Hopper's tensor cores (sm_90a), in split tf32.
//
//     C[M, N] = sum_k A(m, k) * B(n, k)  (+ bias[n])
//
// from f32 operands into f32, each operand stored K-major (A: a[m*lda + k],
// B: b[n*ldb + k]) or MN-major (A: a[k*lda + m], B: b[k*ldb + n]). The
// transformer's `Dense` (ops/gemm.py) takes its three products from here:
// the forward X.W^T (A and B K-major), the input gradient dY.W (A K-major,
// B N-major) and the weight gradient dY^T.X (A M-major, B N-major, K the
// batch's rows).
//
// Replaces no TPU kernel: the JAX package leaves its dense products to XLA.
// It was added because cuBLAS runs f32 products on the CUDA cores (67
// TFLOP/s on an H100 SXM), while the tensor cores give close to f32
// accuracy at 495 / 3 = 165 TFLOP/s in the 3-product split form of
// attention_mma.cuh: x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi),
// a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (about 2^-22 relative a product,
// against tf32's 2^-11). That rate bounds the train step's products (K of
// 106 to 12,800 over 12,800 rows); the decode's, at 1,600 rows, have fewer
// output tiles than the card has SMs.
//
// Design. A persistent grid (one block an SM, 192 KB of shared memory)
// walks the output's 128 x 128 tiles (and, where there are fewer tiles than
// SMs, slices of K, summed afterwards in a fixed order by
// `gemm_tf32x3_reduce`).
// A block is two consumer warpgroups (64 rows of the tile each, 232
// registers a thread by `setmaxnreg`) and a producer warpgroup (40):
//  * one producer thread keeps a four-stage ring of raw f32 tiles (A 128 x
//    32, B 128 x 32) full by TMA, 128-byte swizzled, across tile
//    boundaries, so that one tile's epilogue overlaps the next tile's
//    loads;
//  * `wgmma` takes 32-bit operands from shared memory only K-major and
//    tf32 ones split into two, so B reaches it as hi and lo tiles in the
//    K-major swizzled layout. Where B is a weight (the forward and the input
//    gradient), `gemm_tf32x3_split_b` splits it first into global memory
//    (a few MB), in a k order that lets A load as 16-byte vectors, and the
//    producer loads both parts. Where B is the batch (the weight gradient),
//    the consumers split its raw N-major tile, transposing on the way, into
//    a two-slot ring, the next k-block's while the tensor cores work;
//  * A is read from the raw tile into registers in `wgmma`'s fragment
//    layout, either major (the transpose of an M-major A costs nothing),
//    and split there;
//  * each k-block of 32 is 12 `wgmma.m64n128k8.f32.tf32.tf32` a warpgroup,
//    the cross terms of its four k-steps first (lo.hi, hi.lo), then the
//    hi.hi terms, into a fresh accumulator, which is then added to the
//    tile's running sum with f32 adds: the tensor cores drop the low bits
//    of products they align to a large accumulator (attention_mma.cuh), so
//    no sum runs through them longer than 32 terms.
// Edges: TMA reads zeros outside the operands (M, N and K tails); the
// epilogue masks its stores. TMA needs row strides that are multiples of 16
// bytes and 16-byte aligned bases: the wrapper pads what is not.
//
// The launch runs on the caller's stream, allocates nothing (the wrapper
// passes the split weight's buffer and the K slices' workspace) and does
// not synchronise, so a CUDA graph can capture it.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // BK: 32 f32 = one 128 B row
constexpr int kStages = 4;                  // raw tile ring
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kTile = BM * BK;              // floats of a tile (BN == BM)
constexpr int kTileBytes = kTile * 4;       // 16 KB

struct Params {
  int M, N;
  int nk;                // k-blocks of K
  int tiles_m, tiles_n;  // output tiles
  int splits, kps;       // K slices and k-blocks a slice
  const float* bias;     // [N] or null
  float* C;              // [M, ldc] (splits == 1)
  long ldc;
  int vec;               // float2 stores into C
  float* ws;             // [splits, M, N] partials (splits > 1)
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// 2-D TMA load of one box at (c0 inner, c1 outer) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// generic-proxy stores to shared memory made visible to `wgmma`
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of registers that `wgmma` writes
// across the instructions that order them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Descriptor of a K-major, 128-byte-swizzled operand tile (rows of 128 B,
// groups of 8 rows 1,024 B apart, the tile 1,024-byte aligned) at k-step s
// (32 bytes a step inside the swizzle atom).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, int s) {
  const uint32_t a = smem_u32(tile) + 32 * s;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= a . b for a 64 x 8 tf32 A in registers (per warp the m16n8k8
// layout: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)) and a 128 x 8
// K-major B in shared memory; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// ---- shared tile layouts -------------------------------------------------

// (row, k) of a K-major tile: 32 f32 a 128 B row, 16 B chunks swizzled by
// the row (TMA's CU_TENSOR_MAP_SWIZZLE_128B, and `wgmma`'s layout)
__device__ __forceinline__ int kmajor_at(int row, int k) {
  return row * BK + (((k >> 2) ^ (row & 7)) << 2) + (k & 3);
}

// (row, k) of an MN-major tile: four TMA boxes of 32 rows, each 32 k-rows
// of 32 f32, swizzled by k
__device__ __forceinline__ int mnmajor_at(int row, int k) {
  return (row >> 5) * (32 * BK) + k * 32 +
         ((((row & 31) >> 2) ^ (k & 7)) << 2) + (row & 3);
}

// B's raw N-major tile into hi and lo tiles in the K-major layout that
// `wgmma` reads. Each of the 256 consumer threads takes a 4 (n) x 4 (k)
// block, transposed in registers: four 16-byte loads along n, four 16-byte
// stores of each part along k. Lanes 0-7 of a quarter warp take n-blocks
// 0-3 of two k-blocks, so the loads hit 8 bank groups and the stores 4.
__device__ __forceinline__ void split_b(const float* raw, uint32_t* hi,
                                        uint32_t* lo, int tid) {
  const int l = tid & 7, r = tid >> 3;
  const int nb = 4 * (r & 7) + (l & 3), kb = 2 * (r >> 3) + (l >> 2);
  float v[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(
        raw + mnmajor_at(4 * nb, 4 * kb + j));
    v[j][0] = x.x;
    v[j][1] = x.y;
    v[j][2] = x.z;
    v[j][3] = x.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4 h, lw;
    split(v[0][i], h.x, lw.x);
    split(v[1][i], h.y, lw.y);
    split(v[2][i], h.z, lw.z);
    split(v[3][i], h.w, lw.w);
    const int c = kmajor_at(4 * nb + i, 4 * kb);
    *reinterpret_cast<uint4*>(hi + c) = h;
    *reinterpret_cast<uint4*>(lo + c) = lw;
  }
}

// This thread's A fragments of the four k-steps of a k-block, split; rows
// `row` and `row + 8` of an M-major raw tile, k in the natural order (k-step
// s, fragment column j: k = 8s + j).
__device__ __forceinline__ void load_a_mn(const float* raw, int row, int t,
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = 8 * s + t;
    split(raw[mnmajor_at(row, k)], hi[s][0], lo[s][0]);
    split(raw[mnmajor_at(row + 8, k)], hi[s][1], lo[s][1]);
    split(raw[mnmajor_at(row, k + 4)], hi[s][2], lo[s][2]);
    split(raw[mnmajor_at(row + 8, k + 4)], hi[s][3], lo[s][3]);
  }
}

// The same from a K-major raw tile, k in the permuted order of a pre-split
// B (k-step s, fragment column j: k = 8 (j % 4) + 2s + j / 4), so that a
// thread's eight k of a row are contiguous: two 16-byte loads a row.
__device__ __forceinline__ void load_a_perm(const float* raw, int row, int t,
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const float4 x =
        *reinterpret_cast<const float4*>(raw + kmajor_at(r, 8 * t));
    const float4 y =
        *reinterpret_cast<const float4*>(raw + kmajor_at(r, 8 * t + 4));
    const float v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split(v[2 * s], hi[s][h], lo[s][h]);
      split(v[2 * s + 1], hi[s][2 + h], lo[s][2 + h]);
    }
  }
}

// one k-block's 12 products into a fresh accumulator: the cross terms of
// the four k-steps, then the hi.hi terms
__device__ __forceinline__ void issue_kblock(float (&acc)[64],
                                             const uint32_t (&ahi)[4][4],
                                             const uint32_t (&alo)[4][4],
                                             const uint32_t* bhi,
                                             const uint32_t* blo) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma_tf32(acc, alo[s], desc_sw128(bhi, s), s > 0);
    wgmma_tf32(acc, ahi[s], desc_sw128(blo, s), 1);
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) wgmma_tf32(acc, ahi[s], desc_sw128(bhi, s), 1);
  wgmma_commit();
}

__device__ __forceinline__ void store2(float* out, long ld, int M, int N,
                                       int r, int c, float v0, float v1,
                                       bool vec) {
  if (r >= M) return;
  float* p = out + (size_t)r * ld + c;
  if (vec && c + 1 < N) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  if (c < N) p[0] = v0;
  if (c + 1 < N) p[1] = v1;
}

// an output tile and K slice of the block's walk, and its k-blocks
struct Item {
  int m0, n0, sl, kb0, kb1;
};

__device__ __forceinline__ Item item_at(const Params& p, int item,
                                        int ntiles) {
  const int tile = item % ntiles, sl = item / ntiles;
  return {(tile / p.tiles_n) * BM, (tile % p.tiles_n) * BN, sl, sl * p.kps,
          min(p.nk, (sl + 1) * p.kps)};
}

// a k-block's sum into the running sum (the first overwrites it)
__device__ __forceinline__ void add_kblock(float (&sum)[64],
                                           float (&acc)[64], bool first) {
  wgmma_wait_all();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = first ? acc[i] : sum[i] + acc[i];
}

// the tile's sum (+ bias) into C, or into the workspace slice of its K
// slice: rows row and row + 8, columns 8j + 2t and 8j + 2t + 1
__device__ __forceinline__ void store_tile(const Params& p, const Item& c,
                                           int row, int t,
                                           const float (&sum)[64]) {
  const bool whole = p.splits == 1;
  float* out = whole ? p.C : p.ws + (size_t)c.sl * p.M * p.N;
  const long ld = whole ? p.ldc : p.N;
  // a slice of the workspace starts 8-byte aligned where N is even
  const bool vec = whole ? p.vec != 0 : (p.N & 1) == 0;
  const int r = c.m0 + row;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = c.n0 + 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (whole && p.bias != nullptr) {
      if (col < p.N) b0 = p.bias[col];
      if (col + 1 < p.N) b1 = p.bias[col + 1];
    }
    store2(out, ld, p.M, p.N, r, col, sum[4 * j] + b0, sum[4 * j + 1] + b1,
           vec);
    store2(out, ld, p.M, p.N, r + 8, col, sum[4 * j + 2] + b0,
           sum[4 * j + 3] + b1, vec);
  }
}

// The raw ring's barriers (full: the producer's bytes; empty: every
// consumer thread) and `more` further ones that every consumer thread
// arrives at, set up by one thread before the roles split.
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              uint64_t* more = nullptr,
                                              int n_more = 0) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int s = 0; s < n_more; ++s) mbar_init(&more[s], kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// warp-uniform as the compiler sees it, so that no `wgmma` sits in a path
// it takes for divergent
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0);
}

// A K-major (raw f32) and B pre-split by `split_b_global` (hi and lo, both
// [N, Kp] K-major in the permuted k order): the forward and the input
// gradient. A stage holds A's raw tile and B's two parts; each consumer
// warpgroup runs on its own, so one's adds and loads overlap the other's
// products.
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_presplit_kernel(const __grid_constant__ CUtensorMap tmA,
                                const __grid_constant__ CUtensorMap tmBhi,
                                const __grid_constant__ CUtensorMap tmBlo,
                                const Params p) {
  float* ring = reinterpret_cast<float*>(smem_base());
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 3 * kStages * kTile);
  uint64_t* empty = full + kStages;
  init_barriers(full, empty);

  const int ntiles = p.tiles_m * p.tiles_n;
  const int items = ntiles * p.splits;
  const int wg = warpgroup();

  if (wg == kConsumers / 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item c = item_at(p, item, ntiles);
        for (int kb = c.kb0; kb < c.kb1; ++kb, ++it) {
          const int st = it % kStages;
          float* stage = ring + 3 * st * kTile;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], 3 * kTileBytes);
          tma_load(stage, &tmA, &full[st], kb * BK, c.m0);
          tma_load(stage + kTile, &tmBhi, &full[st], kb * BK, c.n0);
          tma_load(stage + 2 * kTile, &tmBlo, &full[st], kb * BK, c.n0);
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
    uint32_t ahi[4][4], alo[4][4];
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item c = item_at(p, item, ntiles);
      for (int kb = c.kb0; kb < c.kb1; ++kb, ++it) {
        const int st = it % kStages;
        const float* stage = ring + 3 * st * kTile;
        mbar_wait(&full[st], (it / kStages) & 1);
        load_a_perm(stage, row, t, ahi, alo);
        issue_kblock(acc, ahi, alo,
                     reinterpret_cast<const uint32_t*>(stage + kTile),
                     reinterpret_cast<const uint32_t*>(stage + 2 * kTile));
        add_kblock(sum, acc, kb == c.kb0);
        mbar_arrive(&empty[st]);
      }
      store_tile(p, c, row, t, sum);
    }
  }
}

// A M-major and B N-major, both raw f32: the weight gradient, K the batch's
// rows. B is split in the kernel, into a two-slot ring of hi and lo tiles,
// the next k-block's while the tensor cores work on the current one; the
// two consumer warpgroups meet once a k-block.
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32x3_split_kernel(const __grid_constant__ CUtensorMap tmA,
                             const __grid_constant__ CUtensorMap tmB,
                             const Params p) {
  float* rawA = reinterpret_cast<float*>(smem_base());
  float* rawB = rawA + kStages * kTile;
  uint32_t* bhi = reinterpret_cast<uint32_t*>(rawB + kStages * kTile);
  uint32_t* blo = bhi + 2 * kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(blo + 2 * kTile);
  uint64_t* empty = full + kStages;
  init_barriers(full, empty);

  const int ntiles = p.tiles_m * p.tiles_n;
  const int items = ntiles * p.splits;
  const int wg = warpgroup();

  if (wg == kConsumers / 128) {
    // ---- producer warpgroup: one thread keeps the raw ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Item c = item_at(p, item, ntiles);
        for (int kb = c.kb0; kb < c.kb1; ++kb, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[st], 2 * kTileBytes);
          for (int j = 0; j < 4; ++j) {
            tma_load(rawA + st * kTile + j * 32 * BK, &tmA, &full[st],
                     c.m0 + 32 * j, kb * BK);
            tma_load(rawB + st * kTile + j * 32 * BK, &tmB, &full[st],
                     c.n0 + 32 * j, kb * BK);
          }
        }
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 rows ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x;
    const int lane = tid & 31, t = lane & 3;
    const int row = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
    uint32_t ahi[4][4], alo[4][4];

    // one walk over the block's k-blocks, item after item; `it` counts
    // them (the raw stage and the split slot follow from it)
    int item = blockIdx.x, it = 0;
    Item c = item_at(p, item, ntiles);
    int kb = c.kb0;
    mbar_wait(&full[0], 0);
    split_b(rawB, bhi, blo, tid);
    fence_async_smem();
    consumers_sync();
    for (;;) {
      const int st = it % kStages;
      load_a_mn(rawA + st * kTile, row, t, ahi, alo);
      mbar_arrive(&empty[st]);
      issue_kblock(acc, ahi, alo, bhi + (it & 1) * kTile,
                   blo + (it & 1) * kTile);

      // split the next k-block's B while the tensor cores work
      const bool last = kb + 1 == c.kb1;
      const int next_item = last ? item + (int)gridDim.x : item;
      const bool more = next_item < items;
      const int nx = it + 1, nst = nx % kStages;
      if (more) {
        mbar_wait(&full[nst], (nx / kStages) & 1);
        split_b(rawB + nst * kTile, bhi + (nx & 1) * kTile,
                blo + (nx & 1) * kTile, tid);
        fence_async_smem();
      }
      add_kblock(sum, acc, kb == c.kb0);
      if (last) store_tile(p, c, row, t, sum);
      // both warpgroups have split the next B and finished this k-block,
      // whose split slot the one after next overwrites
      consumers_sync();
      if (!more) break;
      it = nx;
      if (last) {
        item = next_item;
        c = item_at(p, item, ntiles);
        kb = c.kb0;
      } else {
        ++kb;
      }
    }
  }
}

// hi and lo parts of B(n, k) (K-major b[n*ldb + k] or N-major b[k*ldb + n])
// into [N, Kp] K-major rows, zero past K, the k order permuted inside each
// block of 32 to the one `load_a_perm` reads: physical column 8s + j holds
// k = 8 (j % 4) + 2s + j / 4. A block of 256 threads takes 32 k of 32 rows
// through shared memory, so that reads and writes are coalesced either way.
__global__ void __launch_bounds__(256)
    gemm_tf32x3_split_b(const float* __restrict__ b, long ldb, int b_kmajor,
                        int N, int K, int Kp, uint32_t* __restrict__ hi,
                        uint32_t* __restrict__ lo) {
  __shared__ float tile[32][33];  // [k][n]
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    if (b_kmajor) {
      const int n = n0 + r, k = k0 + tx;
      tile[tx][r] = (n < N && k < K) ? b[(size_t)n * ldb + k] : 0.f;
    } else {
      const int k = k0 + r, n = n0 + tx;
      tile[r][tx] = (n < N && k < K) ? b[(size_t)k * ldb + n] : 0.f;
    }
  }
  __syncthreads();
  const int k = 8 * (tx & 3) + 2 * (tx >> 3) + ((tx >> 2) & 1);
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r;
    if (n < N) {
      uint32_t h, l;
      split(tile[k][r], h, l);
      hi[(size_t)n * Kp + k0 + tx] = h;
      lo[(size_t)n * Kp + k0 + tx] = l;
    }
  }
}

// C = sum over the K slices in order (+ bias)
__global__ void gemm_tf32x3_reduce(const float* __restrict__ ws, int splits,
                              int M, int N, const float* __restrict__ bias,
                              float* __restrict__ C, long ldc) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[(size_t)s * total + i];
    const int n = (int)(i % N);
    if (bias != nullptr) v += bias[n];
    C[(i / N) * ldc + n] = v;
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so that
// the library links no libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// A map over an f32 matrix of `rows` rows of `inner` elements (row stride
// `ld` elements), read in boxes of 32 x box_rows, 128-byte swizzled; reads
// outside the matrix give zeros
bool make_map(CUtensorMap* map, const float* ptr, int inner, int rows,
              long ld, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `kernel`'s shared memory (`bytes`) asked for once on each device; the
// caller's static `done` keeps the devices it was asked on
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes,
                         std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = (uint64_t)1 << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// C[M, N] = A . B^T (+ bias) in split tf32, on `stream`.
//  * a_kmajor: A is a[m*lda + k]; B is b[n*ldb + k] (b_kmajor) or
//    b[k*ldb + n]; `bsplit` holds 2 * N * Kp floats (Kp: K rounded up to
//    32), where B's parts are split first.
//  * else A is a[k*lda + m] and B b[k*ldb + n] (an M-major A with a K-major
//    B is not taken); `bsplit` is not read.
// A (and B where it is read by TMA) 16-byte aligned with lda (ldb) a
// multiple of 4; `ws` holds splits * M * N floats when splits > 1 (K cut
// into that many slices, summed in order). Returns a cudaError_t.
extern "C" int ftcn_gemm_tf32x3(const float* A, int a_kmajor, long lda,
                                const float* B, int b_kmajor, long ldb,
                                const float* bias, float* C, long ldc,
                                float* ws, float* bsplit, int M, int N, int K,
                                int splits, int sms, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || sms < 1 || (lda & 3) ||
      (reinterpret_cast<uintptr_t>(A) & 15) || (splits > 1 && !ws) ||
      (a_kmajor && !bsplit) ||
      (!a_kmajor && (b_kmajor || (ldb & 3) ||
                     (reinterpret_cast<uintptr_t>(B) & 15))))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.M = M;
  p.N = N;
  p.nk = (K + BK - 1) / BK;
  p.tiles_m = (M + BM - 1) / BM;
  p.tiles_n = (N + BN - 1) / BN;
  p.kps = (p.nk + splits - 1) / splits;
  p.splits = (p.nk + p.kps - 1) / p.kps;  // no empty slice
  p.bias = bias;
  p.C = C;
  p.ldc = ldc;
  p.vec = (ldc % 2 == 0) && (reinterpret_cast<uintptr_t>(C) % 8 == 0);
  p.ws = ws;
  const int items = p.tiles_m * p.tiles_n * p.splits;
  const int blocks = items < sms ? items : sms;

  cudaError_t err;
  CUtensorMap ma, mb, mc;
  if (a_kmajor) {
    const int Kp = p.nk * BK;
    float* lo = bsplit + (size_t)N * Kp;
    gemm_tf32x3_split_b<<<dim3(p.nk, (N + 31) / 32), 256, 0, stream>>>(
        B, ldb, b_kmajor, N, K, Kp, reinterpret_cast<uint32_t*>(bsplit),
        reinterpret_cast<uint32_t*>(lo));
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (!make_map(&ma, A, K, M, lda, BM) ||
        !make_map(&mb, bsplit, Kp, N, Kp, BN) ||
        !make_map(&mc, lo, Kp, N, Kp, BN))
      return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> done{0};
    constexpr size_t bytes = 1024 + 3 * kStages * kTileBytes + 8 * 2 * kStages;
    if ((err = reserve_smem(gemm_tf32x3_presplit_kernel, bytes, done)) !=
        cudaSuccess)
      return (int)err;
    gemm_tf32x3_presplit_kernel<<<blocks, kThreads, bytes, stream>>>(
        ma, mb, mc, p);
  } else {
    if (!make_map(&ma, A, M, K, lda, 32) || !make_map(&mb, B, N, K, ldb, 32))
      return (int)cudaErrorInvalidValue;
    static std::atomic<uint64_t> done{0};
    constexpr size_t bytes =
        1024 + (2 * kStages + 4) * kTileBytes + 8 * (2 * kStages + 4);
    if ((err = reserve_smem(gemm_tf32x3_split_kernel, bytes, done)) !=
        cudaSuccess)
      return (int)err;
    gemm_tf32x3_split_kernel<<<blocks, kThreads, bytes, stream>>>(ma, mb, p);
  }
  if ((err = cudaGetLastError()) != cudaSuccess || p.splits == 1)
    return (int)err;

  const size_t total = (size_t)M * N;
  size_t rb = (total + 255) / 256;
  if (rb > (size_t)sms * 8) rb = (size_t)sms * 8;
  gemm_tf32x3_reduce<<<(unsigned)rb, 256, 0, stream>>>(ws, p.splits, M, N,
                                                       bias, C, ldc);
  return (int)cudaGetLastError();
}
