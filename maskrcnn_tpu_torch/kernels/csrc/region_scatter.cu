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
// of d_regs carry no gradient. As in the TPU kernel, d_regs comes in the
// feature dtype (float32 or bfloat16), the sums are taken in an accumulator
// dtype (float32 or bfloat16) and the gradient goes out in the feature
// dtype.
//
// Design: window row j of ROI r is tx*C contiguous values in d_regs and
// lands on tx*C contiguous values of the output, so one block takes one
// (r, j) pair and its threads walk that segment V channels at a time: every
// read is a coalesced 16- or 32-byte load, and every write a 16-byte vector
// reduction. Windows of different ROIs overlap, and blocks run in no order,
// so the sums are atomic and their order varies from run to run. A vector
// of zeros issues no reduction: the interpolation weights are zero outside
// the ROI's own extent inside its window, which is most of it.
//   - f32 accumulator: red.global.add.v4.f32 (atomicAdd on float4), V = 4
//     for f32 input; with bf16 input (V = 8) into a float32 scratch that a
//     second kernel of this file casts to the bf16 output.
//   - bf16 accumulator: red.global.add.noftz.v4.bf16x2, 8 bf16 sums in one
//     16-byte reduction, V = 8, straight into a bf16 output; with f32 input
//     (rounded to bf16 first, as the TPU kernel's astype) into a bf16
//     scratch cast to the f32 output by the second kernel.
// The TPU kernel's base-sorted ROI order, sequential output tiles with a
// carried halo and 128-lane row chunks answer a sequential grid without
// atomics and are not carried over.
//
// Bound: bytes. d_regs is read once and the output written once (at
// R=512, t=20, tx=32, C=256, S=136,416: 335.5 MB f32 or 167.8 MB bf16 in,
// 139.7 or 69.8 MB out; 0.14 or 0.07 ms at 3.35 TB/s), plus the scratch of a
// mixed-dtype call; one add per element is nothing beside that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the high half of the float with the same bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ bool all_zero(const float (&v)[V]) {
  bool z = true;
#pragma unroll
  for (int i = 0; i < V; ++i) z &= v[i] == 0.f;
  return z;
}

template <int V>
__device__ __forceinline__ void reduce(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4)
    atomicAdd(reinterpret_cast<float4*>(p + i),
              make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void reduce(__nv_bfloat16* p, const float (&v)[8]) {
  asm volatile(
      "red.global.v4.bf16x2.add.noftz [%0], {%1, %2, %3, %4};" ::"l"(p),
      "r"(pack_bf16x2(v[0], v[1])), "r"(pack_bf16x2(v[2], v[3])),
      "r"(pack_bf16x2(v[4], v[5])), "r"(pack_bf16x2(v[6], v[7]))
      : "memory");
}

// One block per (ROI, window row); cv = C / V vectors per window column.
template <typename In, typename Acc, int V>
__global__ void __launch_bounds__(kThreads)
region_scatter_kernel(const In* __restrict__ d_regs,
                      const int* __restrict__ base,
                      const int* __restrict__ stride, Acc* out, int t,
                      int tx, int cv, long long s_rows) {
  const int r = blockIdx.x / t;
  const int j = blockIdx.x - r * t;
  const long long row0 = (long long)base[r] + (long long)j * stride[r];
  if (row0 >= s_rows || row0 + tx <= 0) return;  // the whole row is outside
  const In* src = d_regs + (size_t)blockIdx.x * tx * cv * V;
  const int n = tx * cv;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long row = row0 + i / cv;
    if (row < 0 || row >= s_rows) continue;
    float v[V];
    load(src + (size_t)i * V, v);
    if (all_zero(v)) continue;
    reduce(out + (row0 * cv + i) * V, v);
  }
}

// The accumulator's scratch into the output dtype, 8 values a thread.
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

__device__ __forceinline__ void store(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename From, typename To>
__global__ void __launch_bounds__(kThreads)
cast_kernel(const From* __restrict__ in, To* __restrict__ out, long long n8) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kThreads) {
    float v[8];
    load(in + i * 8, v);
    store(out + i * 8, v);
  }
}

template <typename In, typename Acc, int V>
int scatter(const void* d_regs, const void* base, const void* stride,
            void* acc, int R, int t, int tx, int C, long long S,
            cudaStream_t s) {
  if (R < 0 || t < 0 || tx < 0 || C < V || C % V != 0 || S < 0 ||
      (long long)R * t > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || t == 0 || tx == 0) return 0;
  region_scatter_kernel<In, Acc, V><<<R * t, kThreads, 0, s>>>(
      static_cast<const In*>(d_regs), static_cast<const int*>(base),
      static_cast<const int*>(stride), static_cast<Acc*>(acc), t, tx, C / V,
      S);
  return (int)cudaGetLastError();
}

template <typename From, typename To>
int cast(const void* in, void* out, long long n, cudaStream_t s) {
  if (n % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long n8 = n / 8;
  if (n8 == 0) return 0;
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  cast_kernel<From, To><<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads,
                          0, s>>>(static_cast<const From*>(in),
                                  static_cast<To*>(out), n8);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point: d_regs (R, t, tx, C), base/stride (R,) int32, and the
// accumulator already zeroed; returns the cudaError_t of its launches (0 on
// success).

// f32 in, f32 accumulator = the (S, C) f32 output. C a multiple of 4.
int region_scatter_f32(const void* d_regs, const void* base,
                       const void* stride, void* out, int R, int t, int tx,
                       int C, long long S, void* stream) {
  return scatter<float, float, 4>(d_regs, base, stride, out, R, t, tx, C, S,
                                  static_cast<cudaStream_t>(stream));
}

// bf16 in, bf16 accumulator = the (S, C) bf16 output. C a multiple of 8.
int region_scatter_bf16(const void* d_regs, const void* base,
                        const void* stride, void* out, int R, int t, int tx,
                        int C, long long S, void* stream) {
  return scatter<__nv_bfloat16, __nv_bfloat16, 8>(
      d_regs, base, stride, out, R, t, tx, C, S,
      static_cast<cudaStream_t>(stream));
}

// bf16 in, f32 accumulator in `scratch` (S, C), then cast into the (S, C)
// bf16 output: two kernels. C a multiple of 8.
int region_scatter_bf16_acc_f32(const void* d_regs, const void* base,
                                const void* stride, void* scratch, void* out,
                                int R, int t, int tx, int C, long long S,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = scatter<__nv_bfloat16, float, 8>(d_regs, base, stride,
                                                   scratch, R, t, tx, C, S, s);
  if (err != 0) return err;
  return cast<float, __nv_bfloat16>(scratch, out, S * C, s);
}

// f32 in, rounded to a bf16 accumulator in `scratch` (S, C), then cast into
// the (S, C) f32 output: two kernels. C a multiple of 8.
int region_scatter_f32_acc_bf16(const void* d_regs, const void* base,
                                const void* stride, void* scratch, void* out,
                                int R, int t, int tx, int C, long long S,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = scatter<float, __nv_bfloat16, 8>(d_regs, base, stride,
                                                   scratch, R, t, tx, C, S, s);
  if (err != 0) return err;
  return cast<__nv_bfloat16, float>(scratch, out, S * C, s);
}

}  // extern "C"
