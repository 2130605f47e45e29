// Region scatter-add for Hopper (sm_90a), plain C interface: the backward of
// the ROIAlign region gather.
//
// Replaces the Pallas TPU kernel
// maskrcnn_tpu/kernels/region_scatter_pallas.py (scatter_add_regions /
// _kernel). For every ROI r, window row j < t and column k < tx it computes
//
//   out[base[r] + j*stride[r] + k, c] += d_regs[r, j, k, c]
//
// over a zeroed (S, C) gradient of the flattened pyramid. A row index
// outside [0, S) is dropped: the forward read zero there, so those entries
// of d_regs carry no gradient.
//
// Design: window row j of ROI r is tx*C contiguous floats in d_regs and
// lands on tx*C contiguous floats of the output, so one block takes one
// (r, j) pair and its threads walk that segment as float4s: every read is a
// coalesced 16-byte load, and every write is one 16-byte vector reduction
// (red.global.add.v4.f32, which sm_90 has for float4). Windows of different
// ROIs overlap, and blocks run in no order, so the sums are atomic and
// their order varies from run to run (f32 rounding only). A float4 of zeros
// issues no reduction: the interpolation weights are zero outside the ROI's
// own extent inside its window, which is most of it.
// The TPU kernel's base-sorted ROI order, sequential output tiles with a
// carried halo and 128-lane row chunks answer a sequential grid without
// atomics and are not carried over.
//
// Bound: bytes. d_regs is read once and the output written once (335.5 MB
// and 139.7 MB at R=512, t=20, tx=32, C=256, S=136,416: 0.14 ms at 3.35
// TB/s); one add per element is nothing beside that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
region_scatter_kernel(const float4* __restrict__ d_regs,
                      const int* __restrict__ base,
                      const int* __restrict__ stride, float4* out, int t,
                      int tx, int c4, long long s_rows) {
  const int r = blockIdx.x / t;
  const int j = blockIdx.x - r * t;
  const long long row0 = (long long)base[r] + (long long)j * stride[r];
  if (row0 >= s_rows || row0 + tx <= 0) return;  // the whole row is outside
  const float4* src = d_regs + (size_t)blockIdx.x * tx * c4;
  const int n = tx * c4;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long row = row0 + i / c4;
    if (row < 0 || row >= s_rows) continue;
    const float4 v = src[i];
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    atomicAdd(out + (row0 * c4 + i), v);
  }
}

}  // namespace

extern "C" {

// d_regs (R, t, tx, C) f32, base/stride (R,) int32, out (S, C) f32 already
// zeroed. Returns the cudaError_t of the launch (0 on success).
int region_scatter_f32(const void* d_regs, const void* base,
                       const void* stride, void* out, int R, int t, int tx,
                       int C, long long S, void* stream) {
  if (R == 0 || t == 0 || tx == 0) return 0;
  if (R < 0 || t < 0 || tx < 0 || C < 4 || C % 4 != 0 || S < 0 ||
      (long long)R * t > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(R * t));
  const dim3 block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* src = static_cast<const float4*>(d_regs);
  const int* b = static_cast<const int*>(base);
  const int* st = static_cast<const int*>(stride);
  float4* dst = static_cast<float4*>(out);
  region_scatter_kernel<<<grid, block, 0, s>>>(src, b, st, dst, t, tx, C / 4,
                                               S);
  return (int)cudaGetLastError();
}

}  // extern "C"
