// Exact greedy NMS for Hopper (sm_90a), plain C interface: the keep mask of
// P independent problems of N score-sorted boxes.
//
// No Pallas counterpart: the JAX package computes NMS in XLA ops. This
// replaces its Jacobi fixpoint, maskrcnn_tpu/ops/nms.py:128
// (_jacobi_fixpoint, a lax.while_loop over keep <- valid & !(keep . sup)),
// which the port ran as a Python loop with a device->host sync per sweep.
// For every problem p it computes the greedy recurrence
//
//   keep[i] = valid[i] and no kept j < i with IoU(j, i) > thresh
//
// over boxes already sorted by descending score, up to the n_out-th kept
// box: boxes after it are left unkept (their ranks lie past the n_out
// output slots, so the compacted result is the full fixpoint's).
//
// Design: mask, then walk. Two kernels on the caller's stream, no host
// sync:
//   1. nms_mask_kernel: one block of 64 threads for every 64x64 tile on or
//      above the diagonal of the N x N pair matrix. Thread r of the tile
//      owns row i (an earlier box) and sets bit c of one 64-bit word when
//      column box j = tile_col*64 + c lies after i and IoU(i, j) > thresh;
//      the tile's 64 column boxes and their areas are staged in shared
//      memory. Tiles below the diagonal are never computed nor read, so
//      the mask (P, N, ceil(N/64)) words needs no zero fill.
//   2. nms_walk_kernel: one block a problem. The "removed" bits of all N
//      boxes sit in shared memory (invalid boxes and the padding past N
//      start removed). 64 boxes at a time, thread 0 walks the block's
//      diagonal words (staged in shared memory) in registers and decides
//      which of the 64 are kept; then every thread ORs the kept rows' words
//      into the later removed words, one word a thread, so that lanes read
//      neighbouring words of a row. Two __syncthreads a 64 boxes; the walk
//      stops once n_out boxes are kept.
//
// The IoU is box_iou's (maskrcnn_tpu_torch/ops/boxes.py) to the bit: each
// product, sum and difference rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc would otherwise contract area_a + area_b - inter and the
// inter product into FMAs), the division is IEEE (__fdiv_rn), and the
// clamps and the union > 0 guard come in box_iou's order. The comparison
// is against the threshold rounded to float32, as torch compares a float32
// tensor with a Python float. So the keep sets equal the plain version's.
//
// Bound: operations in the mask pass. At the train step's 12000 boxes an
// image the upper triangle holds 72 M pairs of about 14 float32 operations
// (1 GFLOP, 0.015 ms at the H100 SXM's 67 TFLOP/s outside the tensor
// cores), and the mask written is 18 MB (0.005 ms at 3.35 TB/s); the
// greedy itself needs only the pairs of each box with the kept boxes
// before it, which chip_smoke.py counts from the run's keep mask. The walk
// is a chain of N/64 dependent steps on one SM per problem, bound by
// latency, not by the card's rates: the design keeps each step to a
// shared-memory walk of 64 bits and one coalesced pass over the kept rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;         // boxes a tile side, bits a word
constexpr int kWalkThreads = 256;

__device__ __forceinline__ float box_area(float4 b) {
  // (y1 - y0) * (x1 - x0), clamped at 0 (box_area(...).clamp(min=0))
  return fmaxf(__fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y)), 0.f);
}

__device__ __forceinline__ float box_iou(float4 a, float area_a, float4 b,
                                         float area_b) {
  const float ty = fmaxf(a.x, b.x);
  const float tx = fmaxf(a.y, b.y);
  const float by = fminf(a.z, b.z);
  const float bx = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(by, ty), 0.f),
                                fmaxf(__fsub_rn(bx, tx), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.f;
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes,
                unsigned long long* __restrict__ mask, int n, int words,
                float thresh) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;
  const float4* pb = boxes + static_cast<size_t>(blockIdx.z) * n;
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int t = threadIdx.x;
  const int col0 = col_tile * kTile;
  if (col0 + t < n) {
    const float4 b = pb[col0 + t];
    cbox[t] = b;
    carea[t] = box_area(b);
  }
  __syncthreads();
  const int row = row_tile * kTile + t;
  if (row >= n) return;
  const float4 a = pb[row];
  const float area_a = box_area(a);
  const int n_cols = min(kTile, n - col0);
  unsigned long long bits = 0ull;
  for (int c = col_tile == row_tile ? t + 1 : 0; c < n_cols; ++c) {
    if (box_iou(a, area_a, cbox[c], carea[c]) > thresh) bits |= 1ull << c;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + row) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int n, int words,
                int n_out) {
  extern __shared__ unsigned long long removed[];  // `words` of them
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long s_kept;
  __shared__ int s_count;
  const int t = threadIdx.x;
  const size_t p = blockIdx.x;
  const unsigned long long* pm = mask + p * n * words;
  const unsigned char* pv = valid + p * n;
  unsigned char* pk = keep + p * n;

  for (int w = t; w < words; w += blockDim.x) {
    unsigned long long bits = 0ull;
    for (int c = 0; c < kTile; ++c) {
      const int i = w * kTile + c;
      if (i >= n || !pv[i]) bits |= 1ull << c;
    }
    removed[w] = bits;
  }
  if (t == 0) s_count = 0;
  __syncthreads();

  for (int wb = 0; wb < words; ++wb) {
    if (t < kTile) {
      const int i = wb * kTile + t;
      diag[t] = i < n ? pm[static_cast<size_t>(i) * words + wb] : 0ull;
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long cur = removed[wb];
      unsigned long long kept = 0ull;
      int count = s_count;
      for (int c = 0; c < kTile && count < n_out; ++c) {
        if (!((cur >> c) & 1ull)) {
          kept |= 1ull << c;
          cur |= diag[c];
          ++count;
        }
      }
      s_kept = kept;
      s_count = count;
    }
    __syncthreads();
    const unsigned long long kept = s_kept;
    const bool done = s_count >= n_out;
    if (t < kTile && wb * kTile + t < n) pk[wb * kTile + t] = (kept >> t) & 1ull;
    if (done) {
      for (int i = (wb + 1) * kTile + t; i < n; i += blockDim.x) pk[i] = 0;
      return;
    }
    for (int w = wb + 1 + t; w < words; w += blockDim.x) {
      unsigned long long acc = removed[w];
      unsigned long long rest = kept;
      while (rest) {
        const int c = __ffsll(static_cast<long long>(rest)) - 1;
        rest &= rest - 1ull;
        acc |= pm[static_cast<size_t>(wb * kTile + c) * words + w];
      }
      removed[w] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// keep (P, N) bool from boxes (P, N, 4) float32 (score-sorted, 16-byte
// aligned) and valid (P, N) bool; `mask` is scratch of P*N*ceil(N/64)
// 64-bit words. Returns the cudaError_t of the launches (0 on success).
int nms_greedy(const void* boxes, const void* valid, void* mask, void* keep,
               int P, int N, int n_out, float thresh, void* stream) {
  if (P == 0 || N == 0) return 0;
  const int words = (N + kTile - 1) / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, P), kTile, 0, s>>>(
      static_cast<const float4*>(boxes),
      static_cast<unsigned long long*>(mask), N, words, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(words) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_walk_kernel<<<P, kWalkThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), N, words, n_out);
  return cudaGetLastError();
}

}  // extern "C"
