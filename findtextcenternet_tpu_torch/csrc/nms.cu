// Fused sigmoid + 3x3 peak suppression + ownership mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel `nms_sigmoid_masked` / `_nms_kernel` in
// findtextcenternet_tpu/ops/pallas_kernels.py. For each pixel of a
// (B, H, W) f32 keymap-logit map:
//
//     out = (x >= max of its 3x3 neighbourhood ? sigmoid(x) : 0) * mask
//
// Neighbours outside the map count as -1e30, as in the Pallas kernel; `>=`
// keeps plateau ties (equal neighbours both survive).
//
// Bound on this card: memory. The kernel reads the logits and the mask once
// and writes the output once (12 bytes a pixel); at B=8, 192x192 that is
// 3.54 MB, 1.06 us at 3.35 TB/s, about what the smallest launch costs (a
// one-element fill takes 1.0 us of profiler time on an H100). So little
// data makes it a latency problem:
// every thread should wait for memory once, with all of its loads in
// flight together, and there should be many threads. Design:
//
// * Row bands. A block owns a full-width band of kRows = 4 rows of one map:
//   384 blocks at B=8 and 192 at B=4 on 192x192 maps (a page's two chunk
//   sizes), both above the 132 SMs. A height that is not a multiple of
//   kRows ends in a shorter band.
// * Threads. Each thread owns four adjacent columns of one row. It loads the
//   rows above, at and below as float4 (the band's rows are read by the
//   threads of three rows; the repeats hit in L1 and L2), the two halo
//   columns beside them and its float4 of mask, all before it uses any:
//   one wait for memory, no shared memory and no barrier. The horizontal
//   3-maxima of the three rows then give each pixel's 3x3 maximum in four
//   compares instead of eight, and the output is written as float4.
// * The sigmoid (`1.0f / (1.0f + expf(-v))`, as before) runs only where the
//   pixel is a peak and its mask is non-zero; elsewhere the output is
//   0 * mask, which is what the plain version gives there.
// * Tails. A width that is not a multiple of 4, or a pointer that is not
//   16-byte aligned, takes element loads and stores with bounds checks in
//   the same kernel.
//
// Staging the band in shared memory first (one `cp.async.bulk` on an
// `mbarrier`, or 16-byte `cp.async` by each thread) and walking each thread
// down the band with the row maxima in registers were both measured slower
// on the card than these independent loads; fewer threads a band made the
// chain of each thread longer.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;            // rows of a band (threads a column)
constexpr int kMaxWidth = 1024;     // 256 threads a row, 1,024 a block
constexpr float kNeg = -1e30f;

// the four values of columns c0..c0+3 of `row` and their horizontal
// 3-maxima; columns past W and rows outside the map read as kNeg
__device__ __forceinline__ void load_row(const float* row, int c0, int W,
                                         bool vec, bool live, float v[4],
                                         float& left, float& right) {
  if (live && vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + c0));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = live && c0 + j < W ? __ldg(row + c0 + j) : kNeg;
  }
  left = live && c0 > 0 ? __ldg(row + c0 - 1) : kNeg;
  right = live && c0 + 4 < W ? __ldg(row + c0 + 4) : kNeg;
}

__device__ __forceinline__ void row_max(const float v[4], float left,
                                        float right, float h[4]) {
  h[0] = fmaxf(fmaxf(left, v[0]), v[1]);
  h[1] = fmaxf(fmaxf(v[0], v[1]), v[2]);
  h[2] = fmaxf(fmaxf(v[1], v[2]), v[3]);
  h[3] = fmaxf(fmaxf(v[2], v[3]), right);
}

// block (ceil(W / 4), kRows), grid (ceil(H / kRows), B); `vec`: W % 4 == 0
// and the three pointers 16-byte aligned (the float4 path)
__global__ void __launch_bounds__(kMaxWidth)
nms_sigmoid_masked_kernel(const float* __restrict__ x,
                          const float* __restrict__ mask,
                          float* __restrict__ out, int H, int W, int vec) {
  const int y = blockIdx.x * kRows + threadIdx.y;
  if (y >= H) return;
  const int c0 = threadIdx.x * 4;
  const size_t plane = (size_t)H * W;
  const float* xb = x + blockIdx.y * plane;
  const size_t at = blockIdx.y * plane + (size_t)y * W + c0;

  float v[3][4], left[3], right[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int yy = y - 1 + d;
    const bool live = yy >= 0 && yy < H;
    load_row(xb + (size_t)(live ? yy : y) * W, c0, W, vec, live, v[d],
             left[d], right[d]);
  }
  float m[4];
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(mask + at));
    m[0] = q.x; m[1] = q.y; m[2] = q.z; m[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = c0 + j < W ? __ldg(mask + at + j) : 0.0f;
  }

  float h[3][4], o[4];
#pragma unroll
  for (int d = 0; d < 3; ++d) row_max(v[d], left[d], right[d], h[d]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float best = fmaxf(fmaxf(h[0][j], h[1][j]), h[2][j]);
    float p = 0.0f;
    if (v[1][j] >= best && m[j] != 0.0f) p = 1.0f / (1.0f + expf(-v[1][j]));
    o[j] = p * m[j];
  }
  if (vec) {
    *reinterpret_cast<float4*>(out + at) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < W) out[at + j] = o[j];
  }
}

}  // namespace

extern "C" int ftcn_nms_sigmoid_masked(const float* x, const float* mask,
                                       float* out, int B, int H, int W,
                                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  if (W > kMaxWidth || B > 65535) return (int)cudaErrorInvalidValue;
  const int vec = W % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(mask) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid((H + kRows - 1) / kRows, B);
  const dim3 block((W + 3) / 4, kRows);
  nms_sigmoid_masked_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, mask, out, H, W, vec);
  return (int)cudaGetLastError();
}
