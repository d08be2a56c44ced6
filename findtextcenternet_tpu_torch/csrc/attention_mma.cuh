// Tensor-core building blocks of the attention kernels (attention.cu and
// attention_bwd.cu), for Hopper (sm_90a).
//
// Products run through `mma.sync.aligned.m16n8k8` with tf32 operands and an
// f32 accumulator. The reference is f32, and one tf32 pass keeps 10
// mantissa bits (scores off by ~5e-4 at hd = 64), so f32 operands are split,
// x = hi + lo with hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a product
// takes three passes: lo_a*hi_b + hi_a*lo_b (the small cross terms first),
// then hi_a*hi_b. That keeps close to f32 accuracy at a third of the tf32
// rate (495 / 3 = 165 TFLOP/s on an H100 SXM). bf16 operands take one pass
// of `mma.sync.aligned.m16n8k16` with an f32 accumulator.
//
// Fragment layouts (PTX ISA), g = lane >> 2, t = lane & 3:
//   m16n8k8 tf32  A: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//                 B: b0 (k=t, n=g), b1 (k=t+4, n=g)
//                 C: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
//   m16n8k16 bf16 A: a0 (g, 2t..2t+1), a1 (g+8, ..), a2 (g, 2t+8..), a3
//                 B: b0 (k=2t..2t+1, n=g), b1 (k=2t+8..2t+9, n=g)
//
// A score tile in C layout feeds the next product as its A operand with no
// shuffle: the order of k inside one 8-wide step is free as long as A and
// B agree, so logical k = t is taken as column 2t and k = t + 4 as column
// 2t + 1. Then a = {c0, c2, c1, c3}, and B reads rows 2t and 2t + 1
// (`load_b_kn`).
//
// Shared tiles are row-major with rows padded to HDP + 4 floats (HDP + 8
// bf16): 16-byte aligned rows for `cp.async`, and every fragment load in 32
// different banks, whether its lanes read (row g, column t) or
// (row 2t, column g).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // 16 owned rows per warp
constexpr int kRows = 16 * kWarps;     // rows a block owns
constexpr int kMaxHD = 256;

// elements of a shared row of a tile of head width HDP
template <typename T, int HDP>
__host__ __device__ constexpr int row_stride() {
  return HDP + 16 / (int)sizeof(T);
}

// ---- tf32 split products ----------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in the 3-product split form
__device__ __forceinline__ void mma_split(float (&c)[4], const FragA& a,
                                          const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Column tiles of a second product summed at once: the largest even
// divisor of OT up to 8. A sum over many tiles (P.V over the keys, dV and dK
// over the queries, dQ over the keys) is taken one tile at a time in a fresh
// accumulator, CH column tiles at a time, and each tile's sum is added to
// the running sum with an f32 add (round to nearest). Chained through the
// mma accumulator across all tiles, the sum was 4-10x further from an f64
// reference than the f32 plain version on an H100: the tensor cores drop
// the low bits of the products that they align to a large accumulator.
template <int OT>
__host__ __device__ constexpr int chunk() {
  for (int c = 8; c > 2; c -= 2)
    if (OT % c == 0) return c;
  return 2;
}

// A (16 x 8) from rows r0.. and columns k0.. of a row-major tile
__device__ __forceinline__ FragA load_a(const float* s, int ld, int r0,
                                        int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (r0 + g) * ld + k0 + t;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// B (8 x 8) with B[k][n] = X[n0 + n][k0 + k]: X's rows are the n index
__device__ __forceinline__ FragB load_b_nk(const float* s, int ld, int n0,
                                           int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  return split_b(p[0], p[4]);
}

// B (8 x 8) with B[k][n] = X[k0 + k][n0 + n], in the permuted k order of
// `a_from_c` (rows 2t and 2t + 1)
__device__ __forceinline__ FragB load_b_kn(const float* s, int ld, int k0,
                                           int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return split_b(p[0], p[ld]);
}

// A (16 x 8) from one 8-column tile of an accumulator in C layout
__device__ __forceinline__ FragA a_from_c(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// ---- bf16 products -----------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- asynchronous tile loads -------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, zero-filled when !in (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows r0 .. r0+n-1 of one (b, h) slice of a (B, T, H, hd)
// tensor (row stride rs elements) into tile[n][LD], zero past T and hd.
// `vec`: 16-byte copies (hd a multiple of 16 bytes, the source 16-byte
// aligned); else one element a copy: 4-byte `cp.async` for f32, a plain
// load and store for bf16.
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(T* tile, const T* src, int n,
                                          int r0, int rows, size_t rs, int hd,
                                          bool vec) {
  constexpr int LD = row_stride<T, HDP>();
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    constexpr int C = HDP / E;
    for (int i = threadIdx.x; i < n * C; i += kThreads) {
      const int r = i / C, d = (i % C) * E;
      const bool in = r0 + r < rows && d < hd;
      cp_async16(tile + r * LD + d, in ? src + (size_t)(r0 + r) * rs + d : src,
                 in);
    }
    return;
  }
  for (int i = threadIdx.x; i < n * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    const bool in = r0 + r < rows && d < hd;
    const T* s = in ? src + (size_t)(r0 + r) * rs + d : src;
    if constexpr (sizeof(T) == 4) {
      cp_async4(tile + r * LD + d, s, in);
    } else {
      tile[r * LD + d] = in ? *s : T(0.f);
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- masked key tiles ----------------------------------------------------

// The first tile n >= from of R keys with a mask entry that is not -inf
// (ntiles if there is none). Uniform across the block: every thread takes
// the same branch. A tile whose keys are all masked adds exact zeros to the
// output and takes exact-zero gradients, so skipping it is exact. `mv` gets
// this thread's entry of the tile found (thread i < R holds key n*R + i).
template <int R>
__device__ __forceinline__ int next_live_tile(const float* mb, int from,
                                              int Tk, float& mv) {
  const int ntiles = (Tk + R - 1) / R;
  for (int n = from; n < ntiles; ++n) {
    const int c = n * R + (int)threadIdx.x;
    mv = ((int)threadIdx.x < R && c < Tk) ? mb[c] : -INFINITY;
    if (__syncthreads_or(mv != -INFINITY)) return n;
  }
  return ntiles;
}

}  // namespace
