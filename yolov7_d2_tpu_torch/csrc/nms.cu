// Greedy class-aware hard NMS for a batch of images, one launch.
//
// Replaces the TPU kernel yolov7_d2_tpu/ops/pallas_nms.py:_nms_kernel
// (entry points pallas_nms / pallas_batched_nms) with the batched
// semantics of yolov7_d2_tpu/ops/nms.py:nms_batched on class-offset boxes:
//   live = score if score > 0 else -1e10
//   repeat max_out times:
//     best = argmax(live), the lowest index on ties
//     if live[best] <= -5e9: write idx -1, valid 0
//     else: write idx best, valid 1; kill best and every box with
//           IoU(best, box) > thr, IoU = inter / (area_a + area_b - inter + 1e-9)
//
// That loop keeps the same boxes as a walk over the live candidates in the
// order (score descending, index ascending) that keeps a candidate unless a
// box kept before it has IoU > thr with it, and stops at max_out kept: the
// argmax's lowest index on ties is the second key.
//
// Bound on the H100: latency. An image's data (20 KB) is read once and the
// arithmetic is about 15 float32 operations a (kept box, candidate) pair;
// what costs is the chain of dependent steps. The TPU kernel's form, max_out
// block-wide argmax reductions, is 200 barriers over 32 warps in a chain.
// Design: one CTA of 1024 threads an image, kPer candidates a thread (the
// slots past K hold padding), three steps; at the serving path's [128,
// 1024] the sort and the scan take about equal time (tools/kernel_times.py
// measures each step). The capacity kPer * 1024 is a template parameter:
// the 1024 instance (kPer 1, the serving tails') and the 2048 one (kPer 2,
// Mask R-CNN's RPN: 5 levels x 256 candidates = 1280), the launcher taking
// the smallest that holds K. Thread t holds positions t + j * 1024 of the
// sort, j < kPer; the 2048 instance's shared memory (86 KB) is dynamic.
//  1. Key. A 64-bit key a candidate: the high word is the inverted bits of
//     its positive score (larger first), the low word its index (lower
//     first); a dead candidate (score <= 0) gets the high word all ones.
//     __syncthreads_count gives the live count L.
//  2. Sort. A bitonic sort of the kPer * 1024 keys inside the block,
//     unrolled: the stages of distance below 32 exchange through warp
//     shuffles, those of distance 32 to 512 through shared memory with one
//     barrier each, those of distance 1024 and more between a thread's own
//     keys (1024: 40, 15 and 0 stages; 2048: 45, 20 and 1). With 32 warps the sort is bound by
//     issue, so a compare-exchange is one 64-bit compare and a select. The
//     sorted boxes and their areas are then gathered into shared memory.
//  3. Scan in tiles of 32 sorted candidates, until max_out are kept or the
//     tiles pass L (4 tiles at the serving path's shapes). Warp w tests the
//     tile against its share of the kept boxes, four independent ones a
//     round (a ballot a round, OR-ed into a "suppressed" word), and builds
//     the tile's column w (the earlier candidates i with IoU(i, w) > thr).
//     One barrier; then warp 0 resolves the tile: lane j keeps its candidate
//     iff it is alive and no kept one of its column suppresses it, a ballot
//     iterated from "all alive kept" until it stops changing, which takes
//     as many rounds as the longest chain of suppressions in the tile
//     (candidate j depends only on earlier ones, so the answer is the
//     greedy one). It appends the kept ones and writes their indices. One
//     barrier.
// Every product, sum and quotient of the IoU is a single IEEE
// round-to-nearest operation (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn)
// and the library is built with -fmad=false: nvcc would otherwise contract
// area + area - inter into an FMA, whose different rounding flips
// IoU-at-threshold decisions against the plain PyTorch version. min, max and
// the one sum of the areas commute, so the IoU is symmetric bit for bit and
// the kept box may be either operand.

#include <cuda_runtime.h>

// Built with -DYOLO_NMS_CLOCKS (tools/kernel_times.py), thread 0 of each
// block stores clock64() as it enters each step, for yolo_nms_clocks to
// copy out; otherwise NMS_STEP is nothing.
#ifdef YOLO_NMS_CLOCKS
constexpr int kClockBlocks = 4096;
constexpr int kClockSlots = 8;
__device__ long long g_nms_clocks[kClockBlocks * kClockSlots];
#define NMS_STEP(i)                                   \
  if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) \
  g_nms_clocks[blockIdx.x * kClockSlots + (i)] = clock64()
#else
#define NMS_STEP(i)
#endif

namespace {

constexpr float kEps = 1e-9f;
constexpr int kThreads = 1024;
constexpr int kMaxBoxes = 2 * kThreads;  // the largest instance's capacity
constexpr int kTile = 32;  // one warp's width: a tile's columns are 32-bit words
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads / 32 == kTile, "a warp a column of the tile");

// The block's shared memory for a capacity of n candidates.
template <int n>
struct NmsShared {
  unsigned long long keys[2][n];  // sort, ping-pong
  float4 box[n];                  // by sorted position
  float area[n];
  int idx[n];
  short kept[n];          // sorted positions of the kept boxes
  unsigned cols[kTile];   // column j: the earlier i, IoU > thr
  unsigned supp;
  int nkept;
};

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(a, b) > thr. Where the boxes do not intersect the IoU is 0 / (a
// positive sum) = +0 exactly, so the division is skipped there: with class
// offsets most pairs are of two classes.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.f)) return 0.f > thr;
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), kEps);
  return __fdiv_rn(inter, denom) > thr;
}

// One block of kThreads threads an image, kPer candidates a thread,
// whatever k: a constant size lets the sort unroll into straight code.
template <int kPer>
__global__ void __launch_bounds__(kThreads)
    nms_kernel(const float4* __restrict__ boxes,  // [B, K]
               const float* __restrict__ scores,  // [B, K]
               int k, float thr, int max_out,
               int* __restrict__ out_idx,           // [B, max_out]
               unsigned char* __restrict__ out_valid) {
  constexpr int n = kThreads * kPer;
  constexpr int nwarps = kThreads / 32;
  using Shared = NmsShared<n>;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ __align__(16) unsigned char
      s_static[kPer == 1 ? sizeof(Shared) : 16];
  Shared& sm = *reinterpret_cast<Shared*>(kPer == 1 ? s_static : s_dyn);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float4* bb = boxes + static_cast<size_t>(blockIdx.x) * k;
  int* oidx = out_idx + static_cast<size_t>(blockIdx.x) * max_out;
  unsigned char* ovalid = out_valid + static_cast<size_t>(blockIdx.x) * max_out;

  NMS_STEP(0);
  // 1. key
  unsigned long long key[kPer];
  int n_live = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = t + j * kThreads;
    key[j] = ~0ull;  // the padding past k sorts last
    bool live = false;
    if (c < k) {
      const float s = scores[static_cast<size_t>(blockIdx.x) * k + c];
      live = s > 0.f;
      const unsigned hi = live ? ~__float_as_uint(s) : kFull;
      key[j] = (static_cast<unsigned long long>(hi) << 32) |
               static_cast<unsigned>(c);
    }
    if (j == 0 && t == 0) {
      sm.nkept = 0;
      sm.supp = 0;
    }
    n_live += __syncthreads_count(live);
  }

  NMS_STEP(1);
  // 2. bitonic sort, ascending; thread t ends with the keys of positions
  // t + j * kThreads
  int buf = 0;
#pragma unroll
  for (int size = 2; size <= n; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kThreads) {
        // between a thread's own keys: positions t + j kThreads and
        // t + (j ^ (stride / kThreads)) kThreads
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int jo = j ^ (stride / kThreads);
          if (jo > j) {
            const int e = t + j * kThreads;
            const bool take_min = (e & size) == 0;
            const unsigned long long lo = key[j] < key[jo] ? key[j] : key[jo];
            const unsigned long long hi = key[j] < key[jo] ? key[jo] : key[j];
            key[j] = take_min ? lo : hi;
            key[jo] = take_min ? hi : lo;
          }
        }
        continue;
      }
      unsigned long long other[kPer];
      if (stride >= 32) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) sm.keys[buf][t + j * kThreads] = key[j];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          other[j] = sm.keys[buf][(t ^ stride) + j * kThreads];
        buf ^= 1;  // the next write goes to the other buffer: no 2nd barrier
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          other[j] = __shfl_xor_sync(kFull, key[j], stride);
      }
      // keep the smaller key where the bits of the position at stride and
      // size agree, else the larger; keys differ but past k, where either
      // will do
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = t + j * kThreads;
        const bool take_min = ((e & stride) == 0) == ((e & size) == 0);
        if ((other[j] < key[j]) == take_min) key[j] = other[j];
      }
    }
  }
  NMS_STEP(2);
  // gather the boxes by sorted position
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int pos = t + j * kThreads;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    int idx = -1;
    if (pos < n_live) {
      idx = static_cast<int>(key[j] & kFull);
      box = bb[idx];
    }
    sm.box[pos] = box;
    sm.area[pos] = box_area(box);
    sm.idx[pos] = idx;
  }
  __syncthreads();

  NMS_STEP(3);
  // 3. scan in tiles of 32 sorted candidates
  for (int base = 0; base < n_live; base += kTile) {
    const int nkept = sm.nkept;
    if (nkept >= max_out) break;
    const float4 cb = sm.box[base + lane];  // lane's candidate of the tile
    const float ca = sm.area[base + lane];
    // the tile's own column j = warp: does an earlier candidate i = lane
    // suppress j? (worked out first, to overlap the kept boxes' tests)
    const bool own =
        lane < warp && iou_above(sm.box[base + warp], sm.area[base + warp],
                                 cb, ca, thr);
    // the kept boxes, four independent ones a round
    unsigned supp = 0;
    for (int m0 = warp; m0 < nkept; m0 += 4 * nwarps) {
      bool hit = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + u * nwarps;
        if (m < nkept) {
          const int p = sm.kept[m];
          hit |= iou_above(sm.box[p], sm.area[p], cb, ca, thr);
        }
      }
      supp |= __ballot_sync(kFull, hit);
    }
    if (lane == 0 && supp) atomicOr(&sm.supp, supp);
    const unsigned own_col = __ballot_sync(kFull, own);
    if (lane == 0) sm.cols[warp] = own_col;
    __syncthreads();
    if (warp == 0) {
      // Lane j keeps its candidate iff it is alive and no kept candidate
      // of its column suppresses it. Iterated from "every alive one kept",
      // the ballot settles on the greedy answer as soon as it stops
      // changing (candidate j depends only on earlier ones), after as many
      // rounds as the longest chain of suppressions in the tile.
      const unsigned col = sm.cols[lane];
      const int count = min(kTile, n_live - base);
      const unsigned alive =
          ~sm.supp & (count == kTile ? kFull : (1u << count) - 1u);
      unsigned kept = alive;
      for (;;) {
        const unsigned next =
            __ballot_sync(kFull, ((alive >> lane) & 1u) && !(col & kept));
        if (next == kept) break;
        kept = next;
      }
      // past max_out: drop the last kept ones (later ones never see them)
      while (__popc(kept) > max_out - nkept) {
        kept &= ~(1u << (31 - __clz(kept)));
      }
      if ((kept >> lane) & 1u) {
        const int slot = nkept + __popc(kept & ((1u << lane) - 1u));
        sm.kept[slot] = static_cast<short>(base + lane);
        oidx[slot] = sm.idx[base + lane];
        ovalid[slot] = 1;
      }
      __syncwarp();
      if (lane == 0) {
        sm.nkept = nkept + __popc(kept);
        sm.supp = 0;
      }
    }
    __syncthreads();
  }

  NMS_STEP(4);
  // 4. padding
  for (int j = sm.nkept + t; j < max_out; j += kThreads) {
    oidx[j] = -1;
    ovalid[j] = 0;
  }
}

}  // namespace

// boxes f32 [B, K, 4] (16-byte aligned), scores f32 [B, K], K <= 2048;
// writes out_idx int32 [B, max_out] and out_valid uint8 [B, max_out], with
// the smallest instance that holds K. Returns the cudaError_t of the launch.
extern "C" int yolo_nms_launch(const void* boxes, const void* scores,
                               void* out_idx, void* out_valid, int batch,
                               int k, float thr, int max_out, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxBoxes || max_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto b = static_cast<const float4*>(boxes);
  const auto s = static_cast<const float*>(scores);
  const auto oi = static_cast<int*>(out_idx);
  const auto ov = static_cast<unsigned char*>(out_valid);
  const auto st = static_cast<cudaStream_t>(stream);
  if (k <= kThreads) {
    nms_kernel<1><<<batch, kThreads, 0, st>>>(b, s, k, thr, max_out, oi, ov);
  } else {
    constexpr int bytes = static_cast<int>(sizeof(NmsShared<kMaxBoxes>));
    static const cudaError_t set = cudaFuncSetAttribute(
        nms_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    nms_kernel<2><<<batch, kThreads, bytes, st>>>(b, s, k, thr, max_out, oi,
                                                   ov);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef YOLO_NMS_CLOCKS
// Copies the clocks of the last launch out: int64 [kClockBlocks,
// kClockSlots], slot i the step NMS_STEP(i) entered.
extern "C" int yolo_nms_clocks(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, g_nms_clocks, sizeof(g_nms_clocks)));
}
#endif
