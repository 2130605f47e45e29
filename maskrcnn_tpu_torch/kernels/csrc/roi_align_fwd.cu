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
// Bound: the bytes. ROIAlign's By and Bx are banded: a row holds at most
// four nonzeros next to each other (two taps for each of two samples), so
// the arithmetic these inputs need is a few hundred FMAs per output
// channel of an ROI, well under a microsecond over the whole card, and far
// under the time to read the reached part of the windows once and write
// the output once. The design therefore spends no instruction on a zero
// weight and moves each reached window element into the SM once,
// asynchronously. What it still pays for at the main paths' sizes is not
// bytes but one block's chain of latencies and the instructions around the
// few FMAs (PERF.md has the readings).
//
// Design: one block per (ROI, 32-channel tile, group of 8 output rows) of
// 8 x ow threads; thread (lane, ox) owns 4 consecutive channels (one
// 16-byte access, 8 bytes in bf16) of output column ox and keeps the
// accumulators of its group's rows of that column in registers (14x14
// takes two groups, which halves both the registers and the window rows a
// block walks through).
// 1. Bands. The 8 lanes of an output column bring in one row of By (of the
//    block's group) and row ox of Bx with 4-byte cp.async, all in flight
//    together; each lane then scans the entries it copied itself, and the 8
//    lanes agree with shuffles on the row's band, its first to last
//    nonzero. Shared-memory atomics widen the hull [j0, j1) x [k0, k1) of
//    all bands. The bands come from the weights themselves, so dense
//    weights (a band is the whole row), clamped weights piled on the last
//    index and all-zero rows (an empty band) are handled alike.
// 2. Staging. Window row j of the hull is wx = k1 - k0 consecutive rows of
//    the pyramid: one contiguous slab of wx x 32 channels. The slabs go
//    through a ring of kStages buffers filled with cp.async (16 bytes a
//    thread; thread (lane, ox) copies columns ox, ox + ow, ..; zero-filled
//    where the pyramid row lies outside [0, S)); up to kStages - 1 slabs
//    are in flight while one is consumed, with one __syncthreads per window
//    row. Rows and columns outside the hull are never loaded. cp.async and
//    not TMA: a tensor map fixes the box at tx rows, where the hull is wx
//    of them (the hulls hold under a tenth of the windows at the main
//    paths' shapes), and it would have to be encoded on the host per call.
// 3. Arithmetic, Bx first. A thread contracts the slab with its own band
//    of Bx[ox] (t = sum_k Bx[ox, k] * slab[k], four columns a trip so their
//    loads overlap), then adds By[oy, j] * t to the accumulator of each oy
//    whose band holds j (a bit mask per window row; By sits transposed in
//    shared memory, so a window row's weights are two float4 loads). All
//    sums are float32 fmaf, k and j ascending.
// Only the ring (4 KB a stage at tx = 32, f32) and the weights live in
// shared memory, about 15 KB a block.
//
// Skipped terms: a term outside a band is 0 * v, which adds nothing when v
// is finite. When v is not finite (an Inf or NaN feature under a zero
// weight) the plain version's 0 * v is NaN and poisons that output, while
// this kernel skips the term and leaves the output finite. A nonzero
// weight on a non-finite feature gives a non-finite output in both.
// A window row inside the hull that no band reaches is loaded and unused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>

namespace {

constexpr int kLanes = 8;              // threads across the tile
constexpr int kChannels = 4 * kLanes;  // channels per block, 4 a thread
constexpr int kStages = 3;             // slabs in the ring
constexpr int kRows = 8;     // output rows per block, a multiple of 4
constexpr int kMaxOut = 16;  // largest oh / ow
// ints after the ring: jlo and jhi (kRows each) and the hull
constexpr int kBandInts = 2 * kRows + 4;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Asynchronous copy of BYTES (16, 8 or 4) from global to shared memory;
// with `ok` false nothing is read and the destination is filled with zeros.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const size_t s = __cvta_generic_to_global(src);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(s), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(s), "n"(BYTES), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int odd(int n) { return n | 1; }

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int component(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kMaxOut)
roi_align_fwd_kernel(const T* __restrict__ feat, const int* __restrict__ base,
                     const int* __restrict__ stride,
                     const float* __restrict__ by,
                     const float* __restrict__ bx, float* __restrict__ out,
                     int S, int C, int ty, int tx, int oh, int ow) {
  extern __shared__ float4 smem4[];
  T* s_ring = reinterpret_cast<T*>(smem4);  // [kStages][tx][kChannels]
  int* s_jlo = reinterpret_cast<int*>(s_ring + kStages * tx * kChannels);
  int* s_jhi = s_jlo + kRows;    // bands of this block's rows of By
  int* s_hull = s_jhi + kRows;   // j0, j1, k0, k1
  // By transposed, [ty][kRows], so a window row's weights are float4 loads
  float* s_by = reinterpret_cast<float*>(s_hull + 4);
  float* s_by_in = s_by + ty * kRows;  // [kRows][ty], as it arrives
  const int txp = odd(tx);             // odd row stride: no bank conflicts
  float* s_bx = s_by_in + kRows * ty;  // [ow][txp]
  unsigned* s_rows = reinterpret_cast<unsigned*>(s_bx + ow * txp);  // [ty]

  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  const int ox = threadIdx.y;
  const int tid = ox * kLanes + lane;
  const int n_thr = kLanes * ow;
  const int c0 = blockIdx.y * kChannels;
  const int oy0 = blockIdx.z * kRows;  // this block's output rows
  const int n_oy = min(kRows, oh - oy0);
  const long long b0 = base[r];  // asked for early, used after the bands
  const long long st = stride[r];

  // The 8 lanes of an output column bring in one weight row at a time,
  // each lane every 8th entry, all copies in flight together.
  const float* by_r = by + ((size_t)r * oh + oy0) * ty;
  const float* bx_r = bx + ((size_t)r * ow + ox) * tx;
  float* bx_o = s_bx + ox * txp;
  for (int o = ox; o < n_oy; o += ow)
    for (int j = lane; j < ty; j += kLanes)
      copy_async<4>(s_by_in + o * ty + j, by_r + o * ty + j);
  for (int k = lane; k < tx; k += kLanes) copy_async<4>(bx_o + k, bx_r + k);
  commit_copies();
  // the hull starts empty: first nonzeros past the end, last before the start
  if (tid < 4) s_hull[tid] = (tid & 1) ? 0 : INT_MAX;
  __syncthreads();
  wait_copies<0>();

  // A lane scans the entries it copied itself; the 8 lanes agree on the
  // row's band (first to last nonzero) with shuffles among themselves.
  const unsigned group = 0xFFu << (kLanes * (ox & 3));  // their warp lanes
  auto band = [&](int& lo, int& hi) {
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      lo = min(lo, __shfl_xor_sync(group, lo, d));
      hi = max(hi, __shfl_xor_sync(group, hi, d));
    }
  };
  for (int o = ox; o < kRows; o += ow) {  // rows past n_oy are zero
    int lo = INT_MAX, hi = 0;
    for (int j = lane; j < ty; j += kLanes) {
      const float w = o < n_oy ? s_by_in[o * ty + j] : 0.f;
      s_by[j * kRows + o] = w;
      if (w != 0.f) lo = min(lo, j), hi = j + 1;
    }
    band(lo, hi);
    if (lane == 0) {
      s_jlo[o] = lo;
      s_jhi[o] = hi;
      atomicMin(&s_hull[0], lo);
      atomicMax(&s_hull[1], hi);
    }
  }
  int klo = INT_MAX, khi = 0;  // this thread's own band of Bx[ox]
  for (int k = lane; k < tx; k += kLanes)
    if (bx_o[k] != 0.f) klo = min(klo, k), khi = k + 1;
  band(klo, khi);
  if (lane == 0) {
    atomicMin(&s_hull[2], klo);
    atomicMax(&s_hull[3], khi);
  }
  __syncthreads();

  const int j0 = s_hull[0], k0 = s_hull[2];
  const int wx = max(s_hull[3] - k0, 0);
  const int n_rows = wx > 0 ? max(s_hull[1] - j0, 0) : 0;
  const int slab = tx * kChannels;  // elements per ring buffer

  // copy the next window row, columns [k0, k0 + wx), into the next ring
  // buffer: thread (lane, ox) its 4 channels of columns ox, ox + ow, ..
  long long g = b0 + j0 * st + k0;  // pyramid row of the next copy
  int n_started = 0, fill = 0;
  auto start_copy = [&]() {
    if (n_started < n_rows) {
      T* dst = s_ring + fill * slab + 4 * lane;
      const T* src = feat + c0 + 4 * lane;
      for (int kk = ox; kk < wx; kk += ow) {
        const long long row = g + kk;
        const bool ok = row >= 0 && row < S;
        copy_async<4 * sizeof(T)>(dst + kk * kChannels,
                                  src + (ok ? row : 0) * C, ok);
      }
      g += st;
      ++n_started;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }
    commit_copies();  // an empty group keeps the count of groups in step
  };
  for (int i = 0; i < kStages - 1; ++i) start_copy();

  // per window row, the set of output rows whose band holds it (while the
  // first copies are in flight)
  int4 lo4[kRows / 4], hi4[kRows / 4];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    lo4[q] = reinterpret_cast<const int4*>(s_jlo)[q];
    hi4[q] = reinterpret_cast<const int4*>(s_jhi)[q];
  }
  for (int j = tid; j < ty; j += n_thr) {
    unsigned m = 0;
#pragma unroll
    for (int o = 0; o < kRows; ++o)
      if (component(lo4[o / 4], o % 4) <= j && j < component(hi4[o / 4], o % 4))
        m |= 1u << o;
    s_rows[j] = m;
  }

  float4 acc[kRows];
#pragma unroll
  for (int o = 0; o < kRows; ++o) acc[o] = make_float4(0.f, 0.f, 0.f, 0.f);

  int use = 0;
  for (int j = j0; j < j0 + n_rows; ++j) {
    wait_copies<kStages - 2>();  // this thread's part of row j has landed
    __syncthreads();  // everyone's has, and row j - 1 is consumed
    start_copy();     // into the buffer row j - 1 used
    const T* row = s_ring + use * slab + 4 * lane;
    use = use + 1 == kStages ? 0 : use + 1;
    const unsigned m = s_rows[j];
    float4 wy[kRows / 4];  // By[oy0 .. oy0 + kRows, j]
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      wy[q] = reinterpret_cast<const float4*>(s_by + j * kRows)[q];
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    // four columns a trip, so their loads are in flight together
    for (int k = klo; k < khi; k += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u < khi) {
          const float w = bx_o[k + u];
          const float4 v = load4(row + (k + u - k0) * kChannels);
          t.x = fmaf(w, v.x, t.x);
          t.y = fmaf(w, v.y, t.y);
          t.z = fmaf(w, v.z, t.z);
          t.w = fmaf(w, v.w, t.w);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kRows; ++o) {
      if (m >> o & 1u) {
        const float w = component(wy[o / 4], o % 4);
        acc[o].x = fmaf(w, t.x, acc[o].x);
        acc[o].y = fmaf(w, t.y, acc[o].y);
        acc[o].z = fmaf(w, t.z, acc[o].z);
        acc[o].w = fmaf(w, t.w, acc[o].w);
      }
    }
  }
  wait_copies<0>();

  float* dst = out + (((size_t)r * oh + oy0) * ow + ox) * C + c0 + 4 * lane;
#pragma unroll
  for (int o = 0; o < kRows; ++o)
    if (o < n_oy)
      *reinterpret_cast<float4*>(dst + (size_t)o * ow * C) = acc[o];
}

template <typename T>
int launch(const void* feat, const void* base, const void* stride,
           const void* by, const void* bx, void* out, int R, int S, int C,
           int ty, int tx, int oh, int ow, void* stream) {
  if (R == 0) return 0;
  if (C % kChannels != 0 || oh < 1 || ow < 1 || oh > kMaxOut ||
      ow > kMaxOut || ty < 1 || tx < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * kStages * tx * kChannels +
      sizeof(float) * (2 * (size_t)kRows * ty + (size_t)ow * odd(tx)) +
      sizeof(int) * ((size_t)kBandInts + ty);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = roi_align_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(R, C / kChannels, (oh + kRows - 1) / kRows);
  const dim3 block(kLanes, ow);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feat), static_cast<const int*>(base),
      static_cast<const int*>(stride), static_cast<const float*>(by),
      static_cast<const float*>(bx), static_cast<float*>(out), S, C, ty, tx,
      oh, ow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success). `feat` and
// `out` must be 16-byte aligned.
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
