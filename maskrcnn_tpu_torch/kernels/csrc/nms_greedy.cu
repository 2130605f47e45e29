// Exact greedy NMS for Hopper (sm_90a), plain C interface: the keep mask of
// P independent problems of N score-sorted boxes, in one launch of each of
// two kernels for all P.
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
// Mask layout: the upper triangle of 64x64 tiles, packed. Tile row t
// (boxes 64t .. 64t+63) is one contiguous block of 64 rows of W - t words
// (W = ceil(N/64)), row c holding the 64-bit words t .. W-1 of box 64t + c:
// bit b of word w is set when box 64w + b lies after the row's box and
// their IoU exceeds thresh. Each block ends with a copy of the next tile's
// 64 diagonal words, and the 64 words before block 0 hold tile 0's. So one
// bulk copy per 64 boxes stages the rows the walk ORs and the words it
// decides the next 64 boxes with.
//
// 1. nms_mask_kernel: one block of 64 threads for every tile on or above
//    the diagonal (a triangular grid: no block below it), all P problems
//    in one launch. Thread r owns row box 64 * tile_row + r and sets bit c
//    of its word when column box 64 * tile_col + c lies after it and
//    IoU > thresh, in an unrolled loop over the 64 column boxes, which sit
//    with their areas in shared memory (about 19 instructions a pair).
//    Rows past N get 0; a diagonal tile writes its words a second time,
//    after the previous block.
// 2. nms_walk_kernel: one block of 256 threads per problem, all P at once
//    on separate SMs (227 KB of shared memory a block: one block an SM).
//    The "removed" bits of all N boxes live in shared memory (invalid boxes
//    and the padding past N start removed). Step s decides boxes
//    64s .. 64s+63. Warps have fixed roles:
//    - warp 0 decides. It waits for block s-1 (staged a step ago), loads
//      the 64 diagonal words of tile s that end it into registers and the
//      previous step's kept rows' word s (two loads a lane, masked), ORs
//      those in with a warp-wide __reduce_or_sync, then walks the 64 bits
//      in an unrolled chain of predicated ORs in registers (a bit not yet
//      removed is kept and ORs in its row's word), with no load or barrier
//      inside it. The step's kept bits are trimmed at the n_out-th kept
//      box.
//    - warps 1..7 (224 threads), meanwhile, write step s-1's keep bytes and
//      OR its kept rows into words s+1 .. W-1, one word a thread: every row
//      of each group of 16 rows that holds a kept one is loaded, and a row
//      not kept is masked to 0, so no load waits on a branch or on another
//      load and a thread has 16 in flight before it combines them; lanes
//      read neighbouring words of a row, so shared memory serves a warp
//      without bank conflicts.
//    - warp 1's lane 0 also produces: at the end of step s it issues one
//      cp.async.bulk of tile block s+1 (64 rows of words s+1 .. W-1 and
//      tile s+2's diagonal words, 96 KB at the train step's 12000 boxes)
//      into the other half of a double buffer, completing on an mbarrier
//      (expect_tx); consumers wait on its phase a step later. A buffer is
//      refilled only after its last fill completed.
//    One block-wide barrier a step (__syncthreads_or, which also carries
//    the stop at the n_out-th kept box to every thread); on the staged
//    path no step waits on a global load of its own: each bulk copy is
//    issued a step before it is read.
//    Two buffers of the largest block, 2 * 64 * (W + 1) words, fit in
//    227 KB beside the removed bits up to W = 224 (N = 14336). Beyond that the blocks of
//    the first tiles (those with W - t above what fits) are not staged:
//    the workers read their kept rows straight from global memory by the
//    same loads (coalesced 256 bytes a warp), and staging starts at the
//    first tile whose block fits.
//
// The IoU is box_iou's (maskrcnn_tpu_torch/ops/boxes.py) to the bit: each
// product, sum and difference rounds on its own (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc would otherwise contract area_a + area_b - inter and the
// inter product into FMAs), the division is IEEE (__fdiv_rn), and the
// clamps and the union > 0 guard come in box_iou's order. The comparison
// is against the threshold rounded to float32, as torch compares a float32
// tensor with a Python float. The mask pass first divides by an
// approximate reciprocal (rcp.approx, 1 ulp): where that quotient lies more
// than 1e-5 of the threshold away from it, the exact IoU lies on the same
// side, and it decides; otherwise (and for a tile with a box that is not
// finite or lies beyond 1e18, or a threshold outside [1e-6, 1e6]) the IEEE
// division decides. So the keep sets equal the plain version's.
//
// Bound: the greedy needs only the pairs of each box with the kept boxes
// before it, up to the n_out-th kept box, which chip_smoke.py counts from
// the run's keep mask (14 float32 operations a pair), with the boxes and
// validity read once and the keep mask written once. The mask pass
// computes the whole upper triangle instead (72 M pairs an image at 12000
// boxes: 1 GFLOP, 0.015 ms at the H100 SXM's 67 TFLOP/s outside the tensor
// cores; 9 MB written), and the walk is a chain of dependent steps on one
// SM per problem, bound by latency, not by the card's rates: its cost is
// steps x (the decider's 64-bit chain, the loads before it and one
// barrier), with the staging and the workers' OR pass beside the chain.
// chip_smoke.py reports the steps walked and the microseconds a step.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;  // boxes a tile side, bits a word
constexpr int kWalkThreads = 256;
constexpr int kWorkers = kWalkThreads - 32;  // warps 1..7
constexpr int kProducer = 32;  // warp 1's lane 0 issues the bulk copies
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

__device__ __forceinline__ float box_area(float4 b) {
  // (y1 - y0) * (x1 - x0), clamped at 0 (box_area(...).clamp(min=0))
  return fmaxf(__fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y)), 0.f);
}

// box_iou's intersection and union of two boxes, each operation rounded on
// its own, in box_iou's order
__device__ __forceinline__ float2 inter_union(float4 a, float area_a, float4 b,
                                              float area_b) {
  const float ty = fmaxf(a.x, b.x);
  const float tx = fmaxf(a.y, b.y);
  const float by = fminf(a.z, b.z);
  const float bx = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(by, ty), 0.f),
                                fmaxf(__fsub_rn(bx, tx), 0.f));
  return make_float2(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// box_iou's IoU > thresh, exactly: IoU = inter / max(uni, 1e-12) rounded
// (__fdiv_rn) when uni > 0, else 0
__device__ __noinline__ bool iou_above(float4 a, float area_a, float4 b,
                                       float area_b, float thresh) {
  const float2 iu = inter_union(a, area_a, b, area_b);
  const float iou = iu.y > 0.f ? __fdiv_rn(iu.x, fmaxf(iu.y, 1e-12f)) : 0.f;
  return iou > thresh;
}

// approximate reciprocal (max error 1 ulp; subnormal results flush to 0)
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// one column of the fast pass: `bit` into `above` when the quotient q lies
// above hi_t, into `unsure` when it lies neither above hi_t nor below lo_t
// (or is NaN): a compare and a predicated OR each
__device__ __forceinline__ void classify(float q, float lo_t, float hi_t,
                                         unsigned bit, unsigned& above,
                                         unsigned& unsure) {
  asm("{\n"
      ".reg .pred pa, pu;\n"
      "setp.gt.f32 pa, %2, %4;\n"
      "setp.geu.and.f32 pu, %2, %3, !pa;\n"
      "@pa or.b32 %0, %0, %5;\n"
      "@pu or.b32 %1, %1, %5;\n"
      "}\n"
      : "+r"(above), "+r"(unsure)
      : "f"(q), "f"(lo_t), "f"(hi_t), "r"(bit));
}

// a box the fast pass may take: finite coordinates below 1e18 in
// magnitude, so every area, union and quotient is finite and a union <= 0
// comes only with an intersection of 0
__device__ __forceinline__ bool tame(float4 b) {
  return fabsf(b.x) < 1e18f && fabsf(b.y) < 1e18f && fabsf(b.z) < 1e18f &&
         fabsf(b.w) < 1e18f;
}

// Words of one problem's mask, and where tile block t starts: the first 64
// words hold tile 0's diagonal words; block t holds its 64 rows of words
// t .. W-1 (row c at c * (W - t)), then the 64 diagonal words of tile t+1,
// so that staging block t also stages the next step's diagonal words.
__host__ __device__ __forceinline__ size_t mask_words(int words) {
  return static_cast<size_t>(kTile) *
         (1 + static_cast<size_t>(words) * (words + 1) / 2 + words);
}

__device__ __forceinline__ size_t block_offset(int t, int words) {
  // 64 * (1 + t + t * words - t(t-1)/2)
  return static_cast<size_t>(kTile) *
         (1 + t + static_cast<size_t>(t) * (2 * words - t + 1) / 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, u64* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a lane's share of the OR of the kept rows' word at rows[c * pitch]
// (c = 0..63): rows lane and lane + 32, each loaded (no branch) and masked
// to 0 unless kept; warp_or then combines the lanes' shares
__device__ __forceinline__ u64 lane_rows(const u64* rows, int pitch, u64 kept,
                                         int lane) {
  const u64 v0 = rows[static_cast<size_t>(lane) * pitch];
  const u64 v1 = rows[static_cast<size_t>(lane + 32) * pitch];
  return (v0 & (0ull - ((kept >> lane) & 1ull))) |
         (v1 & (0ull - ((kept >> (lane + 32)) & 1ull)));
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(v >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// acc |= v if `bit` is set in `sel`: a test and a predicated OR
__device__ __forceinline__ void or_if(u64& acc, u64 v, unsigned sel,
                                      unsigned bit) {
  asm("{\n"
      ".reg .pred p;\n"
      ".reg .b32 t;\n"
      "and.b32 t, %2, %3;\n"
      "setp.ne.u32 p, t, 0;\n"
      "@p or.b64 %0, %0, %1;\n"
      "}\n"
      : "+l"(acc)
      : "l"(v), "r"(sel), "r"(bit));
}

// OR of the kept rows' word at rows[c * pitch] in one thread: the rows of
// each group of 16 that holds a kept one are all loaded (no branch a row:
// a row not kept is left out of the OR by a predicate), so the 16 loads
// are in flight together;
// groups with none kept are skipped (`kept` is the same in every thread
// of the block, so the branch does not diverge)
__device__ __forceinline__ u64 thread_or_rows(const u64* rows, int pitch,
                                              u64 kept) {
  constexpr int kGroup = 16;
  u64 acc = 0ull;
#pragma unroll
  for (int g = 0; g < kTile; g += kGroup) {
    const unsigned sel = static_cast<unsigned>(kept >> g) & 0xffffu;
    if (sel) {
      u64 v[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        v[c] = rows[static_cast<size_t>(g + c) * pitch];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) or_if(acc, v[c], sel, 1u << c);
    }
  }
  return acc;
}

// the 64 diagonal words of a step (row c's word: bit b > c set when box b
// is suppressed by box c) into registers
__device__ __forceinline__ void load_diag(const u64* diag, u64 (&d)[kTile]) {
#pragma unroll
  for (int c = 0; c < kTile; c += 2) {
    const ulonglong2 v = reinterpret_cast<const ulonglong2*>(diag)[c / 2];
    d[c] = v.x;
    d[c + 1] = v.y;
  }
}

// the 64 boxes of one step: `d` their diagonal words, `removed` their
// removed bits on entry → the kept bits, in registers: a box not yet
// removed is kept and removes what its word says. Unrolled on 32-bit
// halves: a box of the low half can remove boxes of both halves, one of
// the high half only of the high half.
__device__ __forceinline__ u64 decide(const u64 (&d)[kTile], u64 removed) {
  unsigned lo = static_cast<unsigned>(removed);
  unsigned hi = static_cast<unsigned>(removed >> 32);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (!((lo >> c) & 1u)) {
      lo |= static_cast<unsigned>(d[c]);
      hi |= static_cast<unsigned>(d[c] >> 32);
    }
  }
#pragma unroll
  for (int c = 32; c < kTile; ++c) {
    if (!((hi >> (c - 32)) & 1u)) hi |= static_cast<unsigned>(d[c] >> 32);
  }
  return ~((static_cast<u64>(hi) << 32) | lo);
}

// the lowest `r` set bits of `bits`
__device__ __forceinline__ u64 lowest_bits(u64 bits, int r) {
  u64 out = 0ull;
  for (int i = 0; i < r && bits; ++i) {
    const u64 low = bits & (~bits + 1ull);
    out |= low;
    bits ^= low;
  }
  return out;
}

// tile (row, col) of the upper triangle from its row-major index `l`:
// row r starts at r * (2W - r + 1) / 2
__device__ __forceinline__ int2 triangle_tile(int l, int words) {
  const double w = 2.0 * words + 1.0;
  int r = static_cast<int>((w - sqrt(w * w - 8.0 * l)) / 2.0);
  auto start = [&](int rr) {
    return static_cast<long long>(rr) * (2 * words - rr + 1) / 2;
  };
  while (r > 0 && start(r) > l) --r;
  while (r + 1 < words && start(r + 1) <= l) ++r;
  return make_int2(r, r + static_cast<int>(l - start(r)));
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask,
                int n, int words, float thresh, float lo_t, float hi_t) {
  const int2 tile = triangle_tile(blockIdx.x, words);
  const int row_tile = tile.x;
  const int col_tile = tile.y;
  const float4* pb = boxes + static_cast<size_t>(blockIdx.y) * n;
  u64* pm = mask + blockIdx.y * mask_words(words);
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  const int t = threadIdx.x;
  const int col0 = col_tile * kTile;
  const int row = row_tile * kTile + t;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 cb = col0 + t < n ? pb[col0 + t] : zero;
  const float4 a = row < n ? pb[row] : zero;
  cbox[t] = cb;
  carea[t] = box_area(cb);
  // the fast pass for the whole tile, or the exact IoU for every pair
  const bool fast = __syncthreads_and(tame(cb) && tame(a)) && lo_t > 0.f;
  const float area_a = box_area(a);
  u64 bits = 0ull;
  if (fast) {
    unsigned above[2] = {0u, 0u}, unsure[2] = {0u, 0u};
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const float2 iu = inter_union(a, area_a, cbox[c], carea[c]);
      const float q = iu.x * rcp_approx(fmaxf(iu.y, 1e-12f));
      classify(q, lo_t, hi_t, 1u << (c & 31), above[c >> 5], unsure[c >> 5]);
    }
    bits = (static_cast<u64>(above[1]) << 32) | above[0];
    u64 rest = (static_cast<u64>(unsure[1]) << 32) | unsure[0];
    while (rest) {  // rare: the exact quotient decides
      const int c = __ffsll(static_cast<long long>(rest)) - 1;
      rest &= rest - 1ull;
      if (iou_above(a, area_a, cbox[c], carea[c], thresh)) bits |= 1ull << c;
    }
  } else {
    for (int c = 0; c < kTile; ++c)
      if (iou_above(a, area_a, cbox[c], carea[c], thresh)) bits |= 1ull << c;
  }
  if (col_tile == row_tile)  // only the boxes after the row's
    bits &= t == kTile - 1 ? 0ull : ~0ull << (t + 1);
  if (n - col0 < kTile) bits &= (1ull << (n - col0)) - 1ull;
  if (row >= n) bits = 0ull;
  pm[block_offset(row_tile, words) +
     static_cast<size_t>(t) * (words - row_tile) + (col_tile - row_tile)] = bits;
  if (col_tile == row_tile)  // the diagonal word again, after block t-1
    pm[row_tile == 0 ? t
                     : block_offset(row_tile - 1, words) +
                           static_cast<size_t>(kTile) * (words - row_tile + 1) +
                           t] = bits;
}

// `stage`: words a staged block row may hold (tile t is staged when
// words - t <= stage); `first`: the first staged tile
__global__ void __launch_bounds__(kWalkThreads, 1)
nms_walk_kernel(const u64* __restrict__ mask,
                const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int n, int words,
                int n_out, int stage, int first) {
  extern __shared__ __align__(128) u64 smem[];
  const int per_buffer = kTile * (stage + 1);  // rows, then next diagonal
  u64* blocks = smem;                            // [2][per_buffer]
  u64* bars = blocks + 2 * per_buffer;           // [2]: the blocks' fills
  u64* s_kept = bars + 2;                        // [2]: the steps' kept bits
  u64* removed = s_kept + 2;                     // [words]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const u64* pm = mask + blockIdx.x * mask_words(words);
  const unsigned char* pv = valid + static_cast<size_t>(blockIdx.x) * n;
  unsigned char* pk = keep + static_cast<size_t>(blockIdx.x) * n;

  // tile block `tt`: staged in shared memory, or read in place
  auto staged = [&](int tt) { return tt >= first && tt <= words - 2; };
  auto fill_parity = [&](int tt) {
    return static_cast<uint32_t>(((tt - first) >> 1) & 1);
  };
  int fills[2] = {0, 0};  // the producer's count of fills of each buffer
  auto produce = [&](int tt) {  // the producer thread only
    if (!staged(tt)) return;
    u64* bar = bars + (tt & 1);
    if (fills[tt & 1] > 0) mbar_wait(bar, (fills[tt & 1] - 1) & 1);
    bulk_load(blocks + (tt & 1) * per_buffer, pm + block_offset(tt, words),
              static_cast<uint32_t>(kTile * (words - tt + 1) * sizeof(u64)),
              bar);
    ++fills[tt & 1];
  };

  if (t == 0) {
    for (int b = 0; b < 2; ++b) mbar_init(bars + b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = t; w < words; w += kWalkThreads) {  // 64 loads in flight
    u64 bits = 0ull;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const int i = w * kTile + c;
      if (i >= n || !pv[i]) bits |= 1ull << c;
    }
    removed[w] = bits;
  }
  __syncthreads();
  if (t == kProducer) produce(0);

  int count = 0;  // kept so far (warp 0)
  int s = 0;
  for (;; ++s) {
    bool stop = false;
    if (warp == 0) {
      // this step's diagonal words (the head of the mask, or the end of
      // block s-1, staged a step ago with the previous step's rows) into
      // registers, and this lane's share of the previous step's kept rows'
      // word s (column 1 of block s-1)
      const u64 prev = s > 0 ? s_kept[(s - 1) & 1] : 0ull;
      const int pitch = words - s + 1;  // block s-1's
      u64 d[kTile];
      u64 share = 0ull;
      if (s == 0) {
        load_diag(pm, d);
      } else if (staged(s - 1)) {
        mbar_wait(bars + ((s - 1) & 1), fill_parity(s - 1));
        const u64* rows = blocks + ((s - 1) & 1) * per_buffer;
        load_diag(rows + kTile * pitch, d);
        if (prev) share = lane_rows(rows + 1, pitch, prev, lane);
      } else {
        const u64* rows = pm + block_offset(s - 1, words);
        load_diag(rows + kTile * pitch, d);
        if (prev) share = lane_rows(rows + 1, pitch, prev, lane);
      }
      __syncwarp();  // no load sinks into the chain: it reads registers
      u64 cur = removed[s];
      if (prev) cur |= warp_or(share);
      u64 kept = decide(d, cur);
      const int k = __popcll(kept);
      if (count + k >= n_out) {
        kept = lowest_bits(kept, n_out - count);
        stop = true;
      }
      count += __popcll(kept);
      if (s == words - 1) stop = true;
      if (lane == 0) s_kept[s & 1] = kept;
    } else if (s > 0) {
      const u64 prev = s_kept[(s - 1) & 1];
      if (t < 32 + kTile) {  // the previous step's keep bytes
        const int i = (s - 1) * kTile + (t - 32);
        if (i < n) pk[i] = (prev >> (t - 32)) & 1ull;
      }
      const int w = s + 1 + (t - 32);
      if (prev && w < words) {  // word ww is column ww - s + 1 of block s-1
        const int pitch = words - s + 1;
        if (staged(s - 1)) {
          mbar_wait(bars + ((s - 1) & 1), fill_parity(s - 1));
          const u64* rows = blocks + ((s - 1) & 1) * per_buffer;
          for (int ww = w; ww < words; ww += kWorkers)
            removed[ww] |= thread_or_rows(rows + (ww - s + 1), pitch, prev);
        } else {
          const u64* rows = pm + block_offset(s - 1, words);
          for (int ww = w; ww < words; ww += kWorkers)
            removed[ww] |= thread_or_rows(rows + (ww - s + 1), pitch, prev);
        }
      }
    }
    if (__syncthreads_or(stop)) break;
    if (t == kProducer && s + 1 < words) produce(s + 1);
  }

  // leave no copy in flight
  if (t == kProducer) {
    for (int b = 0; b < 2; ++b)
      if (fills[b] > 0) mbar_wait(bars + b, (fills[b] - 1) & 1);
  }
  // the last step's keep bytes, and none after it
  const u64 last = s_kept[s & 1];
  for (int i = s * kTile + t; i < n; i += kWalkThreads)
    pk[i] = i < (s + 1) * kTile ? (last >> (i - s * kTile)) & 1ull : 0;
}

// words a staged block row may hold: two buffers of 64 rows and the next
// diagonal words, beside the removed bits, in 227 KB; -1 if the removed
// bits alone do not fit
int walk_stage(int words) {
  const size_t fixed = (2 * kTile + 4 + static_cast<size_t>(words)) * sizeof(u64);
  const size_t per = 2 * kTile * sizeof(u64);
  if (fixed > kSmemLimit) return -1;
  int stage = static_cast<int>((kSmemLimit - fixed) / per);
  return stage < words ? stage : words;
}

}  // namespace

extern "C" {

// The suppression mask of P problems of N boxes (P, N, 4) float32
// (score-sorted, 16-byte aligned) into `mask`: P blocks of
// 64 * (1 + W + W(W+1)/2) 64-bit words, W = ceil(N/64) (see the layout
// above). Returns the cudaError_t of the launch (0 on success).
int nms_mask(const void* boxes, void* mask, int P, int N, float thresh,
             void* stream) {
  if (P == 0 || N == 0) return 0;
  const int words = (N + kTile - 1) / kTile;
  // the fast pass's band around the threshold, far wider than its
  // quotient's error; outside [1e-6, 1e6] the exact quotient decides
  const bool band = thresh >= 1e-6f && thresh <= 1e6f;
  const float lo_t = band ? thresh * (1.f - 1e-5f) : 0.f;
  const float hi_t = band ? thresh * (1.f + 1e-5f) : 0.f;
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, P), kTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), N, words,
      thresh, lo_t, hi_t);
  return cudaGetLastError();
}

// The walk over a mask from nms_mask: keep (P, N) bool from valid (P, N)
// bool, stopping at the n_out-th kept box.
int nms_walk(const void* mask, const void* valid, void* keep, int P, int N,
             int n_out, void* stream) {
  if (P == 0 || N == 0) return 0;
  const int words = (N + kTile - 1) / kTile;
  const int stage = walk_stage(words);
  if (stage < 0) return cudaErrorInvalidValue;
  const int first = words - stage > 0 ? words - stage : 0;
  const size_t smem =
      (2 * static_cast<size_t>(kTile) * (stage + 1) + 4 + words) * sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      nms_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nms_walk_kernel<<<P, kWalkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), N, words, n_out, stage, first);
  return cudaGetLastError();
}

// keep (P, N) bool from boxes (P, N, 4) float32 (score-sorted, 16-byte
// aligned) and valid (P, N) bool; `mask` is scratch of P * 64 *
// (1 + W + W(W+1)/2) 64-bit words, W = ceil(N/64). Both kernels on
// `stream`, no host sync.
int nms_greedy(const void* boxes, const void* valid, void* mask, void* keep,
               int P, int N, int n_out, float thresh, void* stream) {
  const int err = nms_mask(boxes, mask, P, N, thresh, stream);
  if (err != 0) return err;
  return nms_walk(mask, valid, keep, P, N, n_out, stream);
}

}  // extern "C"
