// Multilevel ROIAlign forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel maskrcnn_tpu/kernels/roi_align_pallas.py
// (_pallas_forward / _kernel). Per ROI r it computes
//
//   out[r, oy, ox, c] = sum_{j<ty} sum_{k<tx}
//       By[r, oy, j] * F[base[r] + j*stride[r] + k, c] * Bx[r, ox, k]
//
// over a flattened (S, C) feature pyramid. A row index outside [0, S)
// reads zero: the window is never shifted (the interpolation weights place
// the ROI at fixed offsets inside it).
//
// Design: one block per (ROI, 32-channel tile); a warp's 32 lanes own 32
// consecutive channels, so every read of a window row is one coalesced
// 128-byte (f32) or 64-byte (bf16) segment and every F element of the
// window is read once per block. Stage 1 contracts the window rows with By
// into shared memory (tmp[oy][k][c], oh*tx*32 floats: 57 KB at 14x32),
// stage 2 contracts tmp with Bx and writes the output with the same
// channel-contiguous coalescing. The per-lane accumulators live in
// registers (MO = 8 or 16 entries, fully unrolled). By and Bx sit in
// shared memory transposed and zero-padded to MO outputs, so one float4
// broadcast load serves four FMAs (with one scalar load per FMA, shared-
// memory loads bound the kernel).
// Accumulation is f32, in the same order as the plain version's two
// contractions.
//
// Bound: pass 1 of predict at 800x1024 (300 ROIs, 7x7, 20x32 windows)
// does 0.93 GFLOP of f32 FMAs on at most the 69.8 MB pyramid plus a 15 MB
// output; on real ROIs the union of windows is a few MB, so the FLOPs at
// the f32 CUDA-core rate and the bytes bound it about equally, far below
// the tensor cores' ridge. Blocks of neighbouring ROIs read overlapping
// windows again, from L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kChannels = 32;  // channels per block, one per lane
constexpr int kWarps = 8;      // warps per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int MO>
__global__ void __launch_bounds__(kChannels * kWarps)
roi_align_fwd_kernel(const T* __restrict__ feat, const int* __restrict__ base,
                     const int* __restrict__ stride,
                     const float* __restrict__ by,
                     const float* __restrict__ bx, float* __restrict__ out,
                     int S, int C, int ty, int tx, int oh, int ow) {
  // weights transposed and zero-padded to MO outputs, so one float4
  // shared-memory load serves four FMAs
  extern __shared__ float4 smem4[];
  float* s_by = reinterpret_cast<float*>(smem4);  // [ty][MO]
  float* s_bx = s_by + ty * MO;                    // [tx][MO]
  float* s_tmp = s_bx + tx * MO;                   // [oh][tx][kChannels]

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kChannels + lane;
  const int c = blockIdx.y * kChannels + lane;

  const float* by_r = by + (size_t)r * oh * ty;
  const float* bx_r = bx + (size_t)r * ow * tx;
  for (int i = tid; i < ty * MO; i += kChannels * kWarps) {
    const int j = i / MO, o = i % MO;
    s_by[i] = o < oh ? by_r[o * ty + j] : 0.f;
  }
  for (int i = tid; i < tx * MO; i += kChannels * kWarps) {
    const int k = i / MO, o = i % MO;
    s_bx[i] = o < ow ? bx_r[o * tx + k] : 0.f;
  }
  __syncthreads();

  const long long b0 = base[r];
  const long long st = stride[r];

  // stage 1: tmp[oy][k][c] = sum_j By[oy][j] * F[b0 + j*st + k][c]
  for (int k = warp; k < tx; k += kWarps) {
    float acc[MO];
#pragma unroll
    for (int o = 0; o < MO; ++o) acc[o] = 0.f;
    for (int j = 0; j < ty; ++j) {
      const long long row = b0 + j * st + k;
      const float v =
          (row >= 0 && row < S) ? to_f32(feat[row * C + c]) : 0.f;
      const float4* w = reinterpret_cast<const float4*>(s_by + j * MO);
#pragma unroll
      for (int q = 0; q < MO / 4; ++q) {
        const float4 wq = w[q];
        acc[4 * q] = fmaf(wq.x, v, acc[4 * q]);
        acc[4 * q + 1] = fmaf(wq.y, v, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(wq.z, v, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(wq.w, v, acc[4 * q + 3]);
      }
    }
#pragma unroll
    for (int o = 0; o < MO; ++o)
      if (o < oh) s_tmp[(o * tx + k) * kChannels + lane] = acc[o];
  }
  __syncthreads();

  // stage 2: out[oy][ox][c] = sum_k Bx[ox][k] * tmp[oy][k][c]
  for (int oy = warp; oy < oh; oy += kWarps) {
    float acc[MO];
#pragma unroll
    for (int o = 0; o < MO; ++o) acc[o] = 0.f;
    for (int k = 0; k < tx; ++k) {
      const float t = s_tmp[(oy * tx + k) * kChannels + lane];
      const float4* w = reinterpret_cast<const float4*>(s_bx + k * MO);
#pragma unroll
      for (int q = 0; q < MO / 4; ++q) {
        const float4 wq = w[q];
        acc[4 * q] = fmaf(wq.x, t, acc[4 * q]);
        acc[4 * q + 1] = fmaf(wq.y, t, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(wq.z, t, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(wq.w, t, acc[4 * q + 3]);
      }
    }
    float* dst = out + ((size_t)r * oh + oy) * ow * C + c;
#pragma unroll
    for (int o = 0; o < MO; ++o)
      if (o < ow) dst[(size_t)o * C] = acc[o];
  }
}

template <typename T, int MO>
int launch_mo(const void* feat, const void* base, const void* stride,
              const void* by, const void* bx, void* out, int R, int S, int C,
              int ty, int tx, int oh, int ow, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(ty + tx) * MO + (size_t)oh * tx * kChannels);
  auto kernel = roi_align_fwd_kernel<T, MO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R, C / kChannels);
  const dim3 block(kChannels, kWarps);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(feat), static_cast<const int*>(base),
      static_cast<const int*>(stride), static_cast<const float*>(by),
      static_cast<const float*>(bx), static_cast<float*>(out), S, C, ty, tx,
      oh, ow);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* feat, const void* base, const void* stride,
           const void* by, const void* bx, void* out, int R, int S, int C,
           int ty, int tx, int oh, int ow, void* stream) {
  if (R == 0) return 0;
  if (C % kChannels != 0 || oh < 1 || ow < 1 || oh > 16 || ow > 16 ||
      ty < 1 || tx < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (oh <= 8 && ow <= 8)
    return launch_mo<T, 8>(feat, base, stride, by, bx, out, R, S, C, ty, tx,
                           oh, ow, s);
  return launch_mo<T, 16>(feat, base, stride, by, bx, out, R, S, C, ty, tx,
                          oh, ow, s);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int roi_align_fwd_f32(const void* feat, const void* base, const void* stride,
                      const void* by, const void* bx, void* out, int R, int S,
                      int C, int ty, int tx, int oh, int ow, void* stream) {
  return launch<float>(feat, base, stride, by, bx, out, R, S, C, ty, tx, oh,
                       ow, stream);
}

int roi_align_fwd_bf16(const void* feat, const void* base, const void* stride,
                       const void* by, const void* bx, void* out, int R, int S,
                       int C, int ty, int tx, int oh, int ow, void* stream) {
  return launch<__nv_bfloat16>(feat, base, stride, by, bx, out, R, S, C, ty,
                               tx, oh, ow, stream);
}

}  // extern "C"
