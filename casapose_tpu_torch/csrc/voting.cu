// Fused LS-voting accumulation for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/voting_kernel.py::voting_accumulate_pallas
// (_voting_accumulate_kernel). For every pixel of class o in 1..oc and every
// keypoint j it forms the features of voting_math.cuh (unit direction, zero
// guard, softplus weight, w*[a, b, d, qy, qx, 1]); S[img, o, j, :] sums them.
//
// What bounds it on this card: bytes. Each labelled pixel's record ([b, h,
// w, C] f32, C = 36 on the main path: 44 MB per 480x640 image) is read once
// with the label map; the ~40 flops per pixel and keypoint are far below the
// f32 rate.
//
// Design (one pass over the data, then a small fixed-order sum):
//   * Grid: gx blocks per image, keypoint group of 9 and class group of 8
//     (blockIdx = (x, img, group)), gx sized by the occupancy API so that
//     every block is resident at once (voting_grid). Block x takes a
//     contiguous part of its image's 32-pixel segments, and its 12 warps take
//     them round-robin, so that every warp gets a like share of the segments
//     that mix classes. Each block writes one partial [oc, k, 6]: 128 per
//     launch at b = 32 (0.2 MB) where one per pair of rows made 13 MB.
//   * Loads: a segment is the contiguous byte range of 32 pixel records.
//     Each warp streams its own segments through a ring of 3 stages (2 where
//     C is too wide for 3) in shared memory: lane 0 issues one TMA bulk copy
//     (cp.async.bulk) per segment, the range rounded out to 16 bytes (so any
//     C works), and an mbarrier per stage tells the warp when it has landed.
//     The next segments' copies are in flight while this one is computed, and
//     the warps need no block barrier. A segment without a pixel of the
//     block's classes is not copied: background costs no device-memory bytes
//     beyond its labels. Each lane loads its labels one segment ahead.
//   * Mapping: lane = pixel, all 9 keypoints of its group. A lane reads its
//     record from shared memory with 16-byte loads (8 a pixel at C = 36) and
//     moves the words into place (a warp-uniform branch where C % 4 == 0,
//     per-lane selects otherwise). A quarter-warp's 16-byte loads hit chunks
//     9p + c: distinct modulo 8, no bank conflict. Scalar loads with lanes
//     walking pixels would be 4-way conflicted (36 mod 32 = 4).
//   * Class sums: each warp holds its class sums [8][54] in registers, lane l
//     the slots l and 30 + l of every class. A warp also keeps a run class and
//     54 run sums per lane: the pixels of the run class add their features
//     there (6 adds per pixel and keypoint, no select). A segment whose
//     labelled pixels all carry one other class ends the run and starts one
//     of that class; a run ends by a fold. Pixels of other classes are folded
//     at once: their features are staged in shared memory (5 keypoints a
//     pass) and, class by class, each slot's lane sums the class's lanes in
//     lane order (32 predicated adds into four chains) and adds the sum to
//     its register for that class (a warp-uniform switch). All-background
//     segments are skipped. On the main path's labels (CC-filtered maps of a
//     network with random weights) 86% of the segments hold one class or
//     none (chip_smoke.py phase 6 counts them), so most pixels take the run.
//     Instructions per labelled pixel and keypoint: ~55 for the features (the
//     softplus's expf and log1pf most), 6 adds on a run, ~2 to stage and ~1
//     per class to fold where a segment mixes classes.
//   * Order: every sum is taken in a fixed order (lanes, then warps 0..11,
//     then blocks 0..gx-1). No atomics, so a run repeats bit for bit.
//     voting_host.cpp runs the same order on the host for the CPU tests.

#include <cuda_runtime.h>

#include <stdint.h>

#include "voting_math.cuh"

namespace {

using namespace cvote;

constexpr int kMaxStages = 3;  // per warp
constexpr unsigned kFull = 0xffffffffu;

struct Shape {
  int npix, w, c, seg_dim, k, oc, n_segs, stages;
  float fh;
};

// Shared memory of a block: an mbarrier per warp and stage, the stages (32 records, plus room for the
// 16-byte-aligned start and the aligned loads past the last record) and their labels, the warps' staging
// areas. After the loop the stages hold the warps' class sums.
__host__ __device__ inline int stage_floats(int c) { return kSeg * c + 32; }
__host__ __device__ inline size_t smem_bytes(int c, int stages) {
  return 16 * ((kWarps * kMaxStages * sizeof(uint64_t) + 15) / 16) +
         sizeof(float) * ((size_t)kWarps * stages * (stage_floats(c) + kSeg) + kWarps * kSeg * kStageStride);
}
// The most stages (at most kMaxStages) that fit the card's limit of shared memory per block, or 0.
__host__ inline int stages_for(int c, size_t limit) {
  for (int st = kMaxStages; st >= 2; --st)
    if (smem_bytes(c, st) <= limit) return st;
  return 0;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// First record of segment u of image img, and its word offset from the 16-byte aligned start.
__device__ __forceinline__ const float* segment_start(const float* raw, const Shape& s, int img, int u) {
  return raw + ((size_t)img * s.npix + (size_t)u * kSeg) * s.c;
}
__device__ __forceinline__ int segment_delta(const float* first) { return (int)(((uintptr_t)first & 15u) >> 2); }

// This lane's class in segment u within the block's class group, 1..8 (0: background, another group's class,
// a label outside 1..oc, or past the block's segments).
__device__ __forceinline__ int load_label(const int* __restrict__ labels, const Shape& s, int img, int u, int u_end,
                                          int class0, int lane) {
  const int pid = u * kSeg + lane;
  if (u >= u_end || pid >= s.npix) return 0;
  const int lab = __ldg(labels + (size_t)img * s.npix + pid);
  return (lab >= 1 && lab <= s.oc && lab > class0 && lab <= class0 + kClassGroup) ? lab - class0 : 0;
}

// Stage segment u (classes `q`, one a lane) into a stage of this warp: one bulk copy, or none if the segment
// holds no pixel of the block's classes; either way the stage's mbarrier completes a phase.
__device__ __forceinline__ void issue_segment(const float* raw, const Shape& s, int img, int u, int q, float* stage,
                                              int* stage_labels, uint64_t* bar, int lane) {
  stage_labels[lane] = q;
  const bool any = __any_sync(kFull, q != 0);
  if (lane == 0) {
    if (any) {
      const float* first = segment_start(raw, s, img, u);
      const int delta = segment_delta(first);
      const int np = min(kSeg, s.npix - u * kSeg);
      const unsigned bytes = (unsigned)(((delta + np * s.c) * 4 + 15) & ~15);
      mbar_arrive_tx(bar, bytes);
      bulk_load(stage, first - delta, bytes, bar);
    } else {
      mbar_arrive(bar);
    }
  }
}

// `N` words of a record from word `w0` of a stage, whose offset modulo 4 is SH: 16-byte loads, then moves.
template <int N, int SH>
__device__ __forceinline__ void read_shifted(const float* stage, int w0, float* out) {
  constexpr int kChunks = (N + SH + 3) / 4;
  float v[4 * kChunks];
  const float4* base = reinterpret_cast<const float4*>(stage) + (w0 >> 2);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 c4 = base[i];
    v[4 * i] = c4.x;
    v[4 * i + 1] = c4.y;
    v[4 * i + 2] = c4.z;
    v[4 * i + 3] = c4.w;
  }
#pragma unroll
  for (int x = 0; x < N; ++x) out[x] = v[x + SH];
}

// `N` words of a record from word `w0` of a stage. Where C % 4 == 0 every lane's w0 has the same offset
// modulo 4, and a warp-uniform branch picks the moves; otherwise each lane selects its own.
template <int N>
__device__ __forceinline__ void read_words(const float* stage, int w0, bool same_shift, float* out) {
  const int sh = w0 & 3;
  if (same_shift) {
    switch (sh) {
      case 0: read_shifted<N, 0>(stage, w0, out); break;
      case 1: read_shifted<N, 1>(stage, w0, out); break;
      case 2: read_shifted<N, 2>(stage, w0, out); break;
      default: read_shifted<N, 3>(stage, w0, out); break;
    }
    return;
  }
  constexpr int kChunks = (N + 3 + 3) / 4;
  float v[4 * kChunks];
  const float4* base = reinterpret_cast<const float4*>(stage) + (w0 >> 2);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const float4 c4 = base[i];
    v[4 * i] = c4.x;
    v[4 * i + 1] = c4.y;
    v[4 * i + 2] = c4.z;
    v[4 * i + 3] = c4.w;
  }
#pragma unroll
  for (int x = 0; x < N; ++x) out[x] = sh == 0 ? v[x] : sh == 1 ? v[x + 1] : sh == 2 ? v[x + 2] : v[x + 3];
}

// A[c - 1] += v for a warp-uniform class c in 1..8: the register is picked by a uniform branch.
__device__ __forceinline__ void add_to_class(float* A, int c, float v) {
  switch (c) {
    case 1: A[0] += v; break;
    case 2: A[1] += v; break;
    case 3: A[2] += v; break;
    case 4: A[3] += v; break;
    case 5: A[4] += v; break;
    case 6: A[5] += v; break;
    case 7: A[6] += v; break;
    default: A[7] += v; break;
  }
}

// The staged slots of one part (stg[lane][slot], one pixel a lane) into the class sums of that part: class by
// class (the classes of `q`, one a lane; 0 = none), each slot's lane sums the class's lanes: lane p into
// partial sum p % 4, in lane order, then (s0 + s1) + (s2 + s3).
__device__ __forceinline__ void fold_classes(const float* stg, int q, float* A, int slots, int lane) {
  unsigned pending = __ballot_sync(kFull, q != 0);
  while (pending) {
    const int c = __shfl_sync(kFull, q, __ffs(pending) - 1);
    const unsigned members = __ballot_sync(kFull, q == c);
    pending &= ~members;
    if (lane < slots) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // four chains of adds, not one of 32
#pragma unroll
      for (int p = 0; p < kSeg; ++p) {
        const float v = stg[p * kStageStride + lane];
        if ((members >> p) & 1u) part[p & 3] += v;
      }
      add_to_class(A, c, (part[0] + part[1]) + (part[2] + part[3]));
    }
  }
  __syncwarp();
}

// Flush a run: the run sums (54 a lane, every lane of class `run`) into the class sums, a part at a time.
__device__ __forceinline__ void flush_run(const float* acc, int run, float* stg, float (*A)[kClassGroup], int lane) {
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
#pragma unroll
    for (int sl = 0; sl < kPartSlots; ++sl)
      if (h * kPartSlots + sl < kSlots) stg[lane * kStageStride + sl] = acc[h * kPartSlots + sl];
    __syncwarp();
    fold_classes(stg, run, A[h], min(kPartSlots, kSlots - h * kPartSlots), lane);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    voting_accumulate_kernel(const float* __restrict__ raw, const int* __restrict__ labels,
                             float* __restrict__ partials, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* stages = reinterpret_cast<float*>(smem + 16 * ((kWarps * kMaxStages * sizeof(uint64_t) + 15) / 16));
  int* stage_labels = reinterpret_cast<int*>(stages + kWarps * s.stages * stage_floats(s.c));
  float* stg_all = reinterpret_cast<float*>(stage_labels + kWarps * s.stages * kSeg);

  const int x = blockIdx.x, img = blockIdx.y, gx = gridDim.x;
  const int n_class_groups = (s.oc + kClassGroup - 1) / kClassGroup;
  const int kgroup = blockIdx.z / n_class_groups, cgroup = blockIdx.z % n_class_groups;
  const int class0 = cgroup * kClassGroup;  // classes class0 + 1 .. class0 + 8
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kWarps * s.stages) mbar_init(bars + tid);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  float* my_stages = stages + warp * s.stages * stage_floats(s.c);
  int* my_labels = stage_labels + warp * s.stages * kSeg;
  uint64_t* my_bars = bars + warp * s.stages;
  float* stg = stg_all + warp * kSeg * kStageStride;
  // The block takes a contiguous part [b0, b1) of the image's segments; warp w of it takes b0 + w, b0 + w + 12,
  // ...: every warp sees a like share of the segments that mix classes, so none lags the rest.
  int b0, b1;
  split_range(x, gx, s.n_segs, &b0, &b1);
  const int workers = kWarps, worker = b0 + warp;
  const int n_mine = b1 > worker ? (b1 - worker + workers - 1) / workers : 0;
  // This group's channel offsets inside a record.
  const int dir0 = s.seg_dim + 2 * kGroupPoints * kgroup;
  const int conf0 = s.seg_dim + 2 * s.k + kGroupPoints * kgroup;
  const int nk = min(kGroupPoints, s.k - kGroupPoints * kgroup);  // keypoints of this group
  const bool same_shift = s.c % 4 == 0;

  float A[kParts][kClassGroup];  // class sums: lane l holds slot part * 30 + l of each class
#pragma unroll
  for (int h = 0; h < kParts; ++h)
#pragma unroll
    for (int c = 0; c < kClassGroup; ++c) A[h][c] = 0.0f;
  float acc[kSlots];  // run sums, one pixel a lane
#pragma unroll
  for (int i = 0; i < kSlots; ++i) acc[i] = 0.0f;
  int run = 0;  // class of the warp's run, 0 = none

  int q_next = load_label(labels, s, img, worker, b1, class0, lane);
  for (int i = 0; i < s.stages; ++i) {
    if (i < n_mine)
      issue_segment(raw, s, img, worker + i * workers, q_next, my_stages + i * stage_floats(s.c),
                    my_labels + i * kSeg, my_bars + i, lane);
    q_next = load_label(labels, s, img, worker + (i + 1) * workers, b1, class0, lane);
  }

  for (int i = 0; i < n_mine; ++i) {
    const int u = worker + i * workers, st = i % s.stages;
    while (!mbar_try_wait(my_bars + st, (unsigned)((i / s.stages) & 1))) {
    }
    const float* stage = my_stages + st * stage_floats(s.c);
    const int q = my_labels[st * kSeg + lane];
    const unsigned labelled = __ballot_sync(kFull, q != 0);
    if (labelled != 0) {
      // The run class takes this segment's pixels of its class; a segment whose labelled pixels are all of one
      // other class ends the run and starts one of that class. Pixels of other classes are folded.
      const int c0 = __shfl_sync(kFull, q, __ffs(labelled) - 1);
      const bool single = __ballot_sync(kFull, q != 0 && q != c0) == 0;
      if (run == 0 || (single && c0 != run)) {
        if (run != 0) flush_run(acc, run, stg, A, lane);
#pragma unroll
        for (int i2 = 0; i2 < kSlots; ++i2) acc[i2] = 0.0f;
        run = c0;
      }
      const bool mine = q == run;
      const int others = (q != 0 && !mine) ? q : 0;
      const bool fold = __any_sync(kFull, others != 0);
      const int pid = u * kSeg + lane;
      const int y = pid / s.w;
      const float cy = ((float)y + 0.5f) / s.fh;
      const float cx = ((float)(pid - y * s.w) + 0.5f) / s.fh;
      const int rec = segment_delta(segment_start(raw, s, img, u)) + lane * s.c;
      float dirs[2 * kGroupPoints], conf[kGroupPoints];
      read_words<2 * kGroupPoints>(stage, rec + dir0, same_shift, dirs);
      read_words<kGroupPoints>(stage, rec + conf0, same_shift, conf);
#pragma unroll
      for (int h = 0; h < kParts; ++h) {
#pragma unroll
        for (int jj = 0; jj < kPartPoints; ++jj) {
          const int j = h * kPartPoints + jj;
          if (j < kGroupPoints) {
            float f[kFeat];
            features(dirs[2 * j], dirs[2 * j + 1], conf[j], cy, cx, f);
            if (mine && j < nk) {
#pragma unroll
              for (int i2 = 0; i2 < kFeat; ++i2) acc[j * kFeat + i2] += f[i2];
            }
            if (fold) {
#pragma unroll
              for (int i2 = 0; i2 < kFeat; ++i2) stg[lane * kStageStride + jj * kFeat + i2] = (j < nk) ? f[i2] : 0.0f;
            }
          }
        }
        if (fold) {
          __syncwarp();
          fold_classes(stg, others, A[h], min(kPartSlots, kSlots - h * kPartSlots), lane);
        }
      }
    }
    __syncwarp();  // every lane is done with stage st
    if (i + s.stages < n_mine)
      issue_segment(raw, s, img, u + s.stages * workers, q_next, my_stages + st * stage_floats(s.c),
                    my_labels + st * kSeg, my_bars + st, lane);
    q_next = load_label(labels, s, img, u + (s.stages + 1) * workers, b1, class0, lane);
  }
  if (run != 0) flush_run(acc, run, stg, A, lane);
  __syncthreads();  // every warp is done with its stages: they now take the class sums [warp][class][slot]
  float* A_all = stages;
#pragma unroll
  for (int h = 0; h < kParts; ++h)
    if (h * kPartSlots + lane < kSlots && lane < kPartSlots)
#pragma unroll
      for (int c = 0; c < kClassGroup; ++c) A_all[(warp * kClassGroup + c) * kSlots + h * kPartSlots + lane] = A[h][c];
  __syncthreads();

  // partials: [b, gx, oc, k, 6]; the warps' class sums in warp order.
  const int n_cls = min(kClassGroup, s.oc - class0);
  const int per_class = nk * kFeat;
  float* dst = partials + (((size_t)img * gx + x) * s.oc + class0) * s.k * kFeat + (size_t)kgroup * kSlots;
  for (int i = tid; i < n_cls * per_class; i += kThreads) {
    const int c = i / per_class, r = i - c * per_class;
    float sum = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) sum += A_all[(wi * kClassGroup + c) * kSlots + r];
    dst[(size_t)c * s.k * kFeat + r] = sum;
  }
}

__global__ void voting_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int gx,
                                     int per_image) {
  const int img = blockIdx.x;
  const float* src = partials + (size_t)img * gx * per_image;
  for (int i = threadIdx.x; i < per_image; i += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < gx; ++t) s += src[(size_t)t * per_image + i];
    out[(size_t)img * per_image + i] = s;
  }
}

}  // namespace

// Blocks per image and group (keypoints x classes) that fill the card in one wave (at least 1, at most the
// image's segments), or a negative CUDA error; *stages: the stages per warp for this c. Lifts the kernel's
// shared-memory limit to the card's; call before voting_accumulate.
extern "C" int voting_grid(int b, int h, int w, int c, int seg_dim, int k, int* stages_out) {
  int dev = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -(int)err;
  const int stages = stages_for(c, (size_t)limit);
  if (stages == 0) return -(int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(c, stages);
  err = cudaFuncSetAttribute(voting_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voting_accumulate_kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  *stages_out = stages;
  const int groups = ((k + kGroupPoints - 1) / kGroupPoints) * ((seg_dim - 1 + kClassGroup - 1) / kClassGroup);
  const int n_segs = (h * w + kSeg - 1) / kSeg;
  const long long per_image = (long long)sms * per_sm / ((long long)b * groups);
  return (int)(per_image < 1 ? 1 : (per_image > n_segs ? n_segs : per_image));
}

// raw: [b, h, w, c] f32, 4-byte aligned; labels: [b, h, w] int32; partials: scratch [b, gx, oc, k, 6] f32;
// out: [b, oc, k, 6] f32, oc = seg_dim - 1; gx and stages from voting_grid with the same shape. Needs
// c >= seg_dim + 3k. Returns cudaGetLastError() after both launches.
extern "C" int voting_accumulate(const float* raw, const int* labels, float* partials, float* out, int b, int h,
                                 int w, int c, int seg_dim, int k, int gx, int stages, cudaStream_t stream) {
  Shape s;
  s.npix = h * w;
  s.w = w;
  s.c = c;
  s.seg_dim = seg_dim;
  s.k = k;
  s.oc = seg_dim - 1;
  s.n_segs = (s.npix + kSeg - 1) / kSeg;
  s.stages = stages;
  s.fh = (float)h;
  const int groups = ((k + kGroupPoints - 1) / kGroupPoints) * ((s.oc + kClassGroup - 1) / kClassGroup);
  const dim3 grid1(gx, b, groups);
  voting_accumulate_kernel<<<grid1, kThreads, smem_bytes(c, s.stages), stream>>>(raw, labels, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  voting_reduce_kernel<<<b, 256, 0, stream>>>(partials, out, gx, s.oc * k * kFeat);
  return (int)cudaGetLastError();
}
