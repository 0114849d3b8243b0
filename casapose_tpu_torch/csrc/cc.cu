// Connected-component labelling by flood sweeps, on the device in one launch, for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/connected_components.py::connected_components_labels,
// the lax.while_loop of flood sweeps that the JAX package runs in XLA (no
// Pallas kernel): the port's plain loop reads a "changed" flag on the host
// after every sweep; this kernel keeps the loop, and the flag, on the card.
// The line arithmetic is in cc_math.cuh, shared with the host build that the
// CPU tests run.
//
// What bounds it on this card: neither bytes nor operations, but instruction
// throughput and the sweeps' dependent steps. A mask is read once (1 byte a pixel) and
// its labels written once (4 bytes); a sweep is a pass over every row, then
// over every column, and a mask needs a handful of sweeps (chip_smoke.py
// counts them on every path: 15 at batch 32 on the main path). Each line pass
// is a chain of scans along the line, so the time is how many instructions
// an SM runs for the lines and how much of their latency the resident warps
// hide. The design cuts the dependent chain of a line pass from a
// thread walking the whole line (twice) to about 2 x (length / 32 + 6) steps,
// and scans only the lines that can change.
//
// Design: one block of 16 warps per mask (512 threads; two blocks fit an SM
// at 120 x 160, so the 256 masks of batch 32 run in one wave). A sweep is
//   - the row pass: a warp per row, lanes along it, each lane holding
//     E = ceil(w / 32) consecutive labels in registers (5 at w = 160): a
//     local forward scan, a 5-step __shfl_up_sync scan of the lanes'
//     (reset, max) aggregates, a fix-up, then the same backward with
//     __shfl_down_sync (cc_math.cuh); a lane writes back only the labels
//     that rose. A lane holds at most 5, so lines longer than 160 go tile
//     by tile with a carry, through the labels' memory.
//   - __syncthreads(), then the column pass, the same with a warp per column
//     (E = 4 at h = 120), ending on __syncthreads_or(changed): one barrier a
//     pass, and the vote whether to sweep again. Each mask stops after its
//     own first sweep that changed nothing, at most max_sweeps; the count
//     goes to sweeps[mask].
//   - Only lines that can change are scanned. After a row pass every row is
//     a fixed point of the row pass, and stays one until the column pass
//     changes one of its labels (and likewise for columns), so each pass
//     marks, one byte a line in shared memory, the crossing lines whose
//     labels it raised, and the next pass skips the rest. The first sweep
//     scans every line. The labels and sweep counts are those of scanning
//     every line: a skipped line would have changed nothing.
//   - Registers: 64 a thread at two blocks of 512 (ptxas: no spills). 1024
//     threads a block would leave 32 and spill, for the same time on the
//     main path's masks. One warp takes one line at a time: the 32 resident
//     warps of an SM are 32 independent chains, and a second line in flight
//     a warp would need registers it does not have.
//   - Shared memory: the labels of a mask (75 KB at 120 x 160) in a
//     swizzled layout (cc_math.cuh::Layout): row r shifted by r / ecol and,
//     where a row's chunk is even, a free slot after each chunk. A row's
//     lanes then read addresses E_row (+1) apart, odd, and a column's lanes
//     addresses E_col * stride + 1 apart, odd: both passes are free of bank
//     conflicts (a plain odd stride would give the column pass 4-way
//     conflicts at E_col = 4). A 32-strided chunk (lane l holding l, l + 32,
//     ...) would avoid conflicts without a swizzle, but needs a warp scan
//     per 32 elements instead of one per line: 5 times the shuffles.
//   - The initial labels come from fg in 16-byte loads (16 pixels of a row a
//     thread), written in an order rotated by lane so that each store meets
//     32 banks; the final labels go out in 128-byte rows, a warp per row.
//   - Masks larger than the opt-in shared memory (480 x 640 at
//     --cc_filter_downsample 1) sweep the output in device memory, row-major,
//     with the same line scans in tiles of 160: a row's lanes read
//     consecutive 20-byte chunks, a column's lanes rows 5 apart (the tiles
//     of neighbouring columns, scanned by neighbouring warps, share their
//     sectors in L1). The line marks stay in shared memory. Holding one such
//     mask in the distributed shared memory of a thread-block cluster is
//     untried.
// The labels equal the plain loop's exactly, the capped case included: each
// mask runs the same sweeps in the same order, and a mask that has converged
// is a fixed point of the sweeps the others still need.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cc_math.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

// Exclusive warp scan of the lanes' aggregates, up (lane 0 first) or down (lane 31 first): the aggregate of the
// lanes before this one in scan order, 0 for the first. With `total`, also the aggregate of all 32 lanes.
template <bool kUp>
__device__ __forceinline__ unsigned warp_exclusive(unsigned x, int lane, unsigned* total = nullptr) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned other = kUp ? __shfl_up_sync(kFull, x, d) : __shfl_down_sync(kFull, x, d);
    x = ccl::scan_step(x, other, kUp ? lane >= d : lane + d < 32);
  }
  if (total) *total = __shfl_sync(kFull, x, kUp ? 31 : 0);
  const unsigned before = kUp ? __shfl_up_sync(kFull, x, 1) : __shfl_down_sync(kFull, x, 1);
  return (kUp ? lane > 0 : lane < 31) ? before : 0u;
}

// A lane's chunk: elements i0 + j (j < E) of the line, at lab[at + j * step].
template <int E>
__device__ __forceinline__ void load_chunk(const int* lab, int at, int step, int i0, int n, unsigned (&v)[E]) {
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = (i0 + j < n) ? (unsigned)lab[at + j * step] : 0u;  // beyond the end: background
}

template <int E>
__device__ __forceinline__ void store_changed(int* lab, int at, int step, int i0, const unsigned (&v)[E], unsigned chg,
                                              unsigned char* mark) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if ((chg >> j) & 1u) {
      lab[at + j * step] = (int)v[j];
      mark[i0 + j] = 1;  // the crossing line through this label may change in the next pass
    }
  }
}

// One scan of a line longer than a tile, tile by tile from the left (kUp) or from the right, carrying the
// aggregate of the tiles before, each tile's values written back where they rose. Returns whether this lane raised
// a label.
template <bool kUp, int E, class Index>
__device__ __forceinline__ bool scan_tiles(int* lab, int n, Index index, int step, unsigned char* mark) {
  constexpr int kTile = 32 * E;
  const int lane = threadIdx.x & 31, tiles = (n + kTile - 1) / kTile;
  unsigned carry = 0;
  bool any = false;
  for (int s = 0; s < tiles; ++s) {
    const int t = kUp ? s : tiles - 1 - s;
    const int i0 = t * kTile + lane * E, at = index(i0, t * 32 + lane);
    unsigned v[E], chg = 0, total;
    load_chunk<E>(lab, at, step, i0, n, v);
    const unsigned agg = kUp ? ccl::scan_up<E>(v, chg) : ccl::scan_down<E>(v, chg);
    ccl::fix_up<E>(v, ccl::combine(carry, warp_exclusive<kUp>(agg, lane, &total)), chg);
    carry = ccl::combine(carry, total);
    store_changed<E>(lab, at, step, i0, v, chg, mark);
    any |= chg != 0;
  }
  return any;
}

// One line pass over a line of n labels, by the calling warp. index(i0, q) is where the chunk starting at element
// i0 lies (q = i0 / E, the chunk's number); a chunk's elements are `step` apart. Returns whether this lane raised
// a label, and marks each raised label's element in `mark`.
template <int E, class Index>
__device__ __forceinline__ bool flood_line(int* lab, int n, Index index, int step, unsigned char* mark) {
  if (n <= 32 * E) {  // one tile: the line stays in registers between the two scans
    const int lane = threadIdx.x & 31, i0 = lane * E, at = index(i0, lane);
    unsigned v[E], chg = 0;
    load_chunk<E>(lab, at, step, i0, n, v);
    ccl::fix_up<E>(v, warp_exclusive<true>(ccl::scan_up<E>(v, chg), lane), chg);
    ccl::fix_up<E>(v, warp_exclusive<false>(ccl::scan_down<E>(v, chg), lane), chg);
    store_changed<E>(lab, at, step, i0, v, chg, mark);
    return chg != 0;
  }
  bool any = false;
  if constexpr (E == ccl::kMaxChunk) {  // a longer line (only the largest chunk has one): through the labels' memory
    any = scan_tiles<true, E>(lab, n, index, step, mark);
    any |= scan_tiles<false, E>(lab, n, index, step, mark);
  }
  return any;
}

// Whether a line is marked, clearing its mark; the same answer in every lane of the warp.
__device__ __forceinline__ bool take_mark(unsigned char* mark) {
  const bool marked = *mark != 0;
  __syncwarp();
  if (marked && (threadIdx.x & 31) == 0) *mark = 0;
  return marked;
}

template <int E>
__device__ __forceinline__ bool row_pass(int* lab, const ccl::Layout& L, unsigned char* row_marks,
                                         unsigned char* col_marks) {
  const bool pad = L.swizzle && E % 2 == 0;  // the free slot after each chunk (cc_math.cuh::col_index)
  bool mine = false;
  for (int r = threadIdx.x >> 5; r < L.h; r += kThreads / 32) {
    if (!take_mark(row_marks + r)) continue;
    const int rb = ccl::row_base(L, r);
    mine |= flood_line<E>(lab, L.w, [&](int i0, int q) { return rb + i0 + (pad ? q : 0); }, 1, col_marks);
  }
  return mine;
}

template <int E>
__device__ __forceinline__ bool col_pass(int* lab, const ccl::Layout& L, unsigned char* col_marks,
                                         unsigned char* row_marks) {
  bool mine = false;
  for (int c = threadIdx.x >> 5; c < L.w; c += kThreads / 32) {
    if (!take_mark(col_marks + c)) continue;
    const int cb = ccl::col_index(L, c);
    // Rows i0 .. i0 + E - 1 start at i0 * stride + i0 / E (cc_math.cuh::row_base): the chunk's number q.
    mine |= flood_line<E>(lab, L.h, [&](int i0, int q) { return i0 * L.stride + (L.swizzle ? q : 0) + cb; },
                          L.stride, row_marks);
  }
  return mine;
}

// f(std::integral_constant<int, e>) for a chunk e in E..kMaxChunk.
template <int E = 1, class F>
__device__ __forceinline__ bool with_chunk(int e, F&& f) {
  if constexpr (E == ccl::kMaxChunk) {
    return f(std::integral_constant<int, E>{});
  } else {
    return e == E ? f(std::integral_constant<int, E>{}) : with_chunk<E + 1>(e, f);
  }
}

// The first labels of a mask into its layout, from 16-byte loads of fg where its rows are 16-byte multiples.
template <bool kShared>
__device__ __forceinline__ void fill_labels(const unsigned char* fg, int* lab, const ccl::Layout& L) {
  const int npix = L.h * L.w;
  if (L.w % 16 == 0 && (reinterpret_cast<uintptr_t>(fg) & 15) == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(fg);
    const int rot = (threadIdx.x >> 1) & 15;
    for (int v = threadIdx.x; v < npix / 16; v += kThreads) {
      const uint4 q = src[v];  // pixels p0 .. p0 + 15, all in row r
      const int p0 = v * 16, r = p0 / L.w, c0 = p0 - r * L.w;
      const unsigned words[4] = {q.x, q.y, q.z, q.w};
      if (kShared) {
        const int rb = ccl::row_base(L, r);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          // Lanes 2 apart write 32 elements apart, so each lane starts at its own element: one store, 32 banks.
          const int e = (k + rot) & 15;
          const unsigned word = e < 4 ? words[0] : e < 8 ? words[1] : e < 12 ? words[2] : words[3];
          lab[rb + ccl::col_index(L, c0 + e)] = ccl::initial_label((word >> ((e & 3) * 8)) & 0xffu, p0 + e);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int4 out;
          out.x = ccl::initial_label(words[k] & 0xffu, p0 + 4 * k);
          out.y = ccl::initial_label((words[k] >> 8) & 0xffu, p0 + 4 * k + 1);
          out.z = ccl::initial_label((words[k] >> 16) & 0xffu, p0 + 4 * k + 2);
          out.w = ccl::initial_label(words[k] >> 24, p0 + 4 * k + 3);
          reinterpret_cast<int4*>(lab + p0)[k] = out;
        }
      }
    }
  } else {
    for (int p = threadIdx.x; p < npix; p += kThreads) {
      const int r = p / L.w, c = p - r * L.w;
      lab[ccl::row_base(L, r) + ccl::col_index(L, c)] = ccl::initial_label(fg[p], p);
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    cc_label_kernel(const unsigned char* __restrict__ fg, int* labels, int* sweeps, ccl::Layout L, int max_sweeps) {
  extern __shared__ __align__(16) int smem[];
  const long long base = (long long)blockIdx.x * L.h * L.w;
  int* lab = kShared ? smem : labels + base;
  unsigned char* row_marks = reinterpret_cast<unsigned char*>(smem + (kShared ? L.size : 0));
  unsigned char* col_marks = row_marks + L.h;
  fill_labels<kShared>(fg + base, lab, L);
  for (int i = threadIdx.x; i < L.h + L.w; i += kThreads) row_marks[i] = 1;  // the first sweep scans every line
  __syncthreads();
  int s = 0;
  while (s < max_sweeps) {
    bool mine = with_chunk(L.erow, [&](auto e) { return row_pass<decltype(e)::value>(lab, L, row_marks, col_marks); });
    __syncthreads();
    mine |= with_chunk(L.ecol, [&](auto e) { return col_pass<decltype(e)::value>(lab, L, col_marks, row_marks); });
    ++s;
    if (!__syncthreads_or(mine)) break;
  }
  if (kShared) {
    for (int r = threadIdx.x >> 5; r < L.h; r += kThreads / 32) {
      const int rb = ccl::row_base(L, r);
      int* out = labels + base + (long long)r * L.w;
      for (int c = threadIdx.x & 31; c < L.w; c += 32) out[c] = lab[rb + ccl::col_index(L, c)];
    }
  }
  if (threadIdx.x == 0) sweeps[blockIdx.x] = s;
}

// The dynamic shared memory a block may have (the opt-in limit), read once a process.
cudaError_t shared_limit(int* limit) {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0, value = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    optin = value;
  }
  *limit = optin;
  return cudaSuccess;
}

// The launch for masks of h x w: which kernel, and its dynamic shared memory (the labels in shared memory, then a
// mark byte a row and a column). Raises the kernel's shared-memory limit once a process where it needs more than
// 48 KB (no stream operation, so never inside a graph capture).
cudaError_t plan(int h, int w, bool* shared, ccl::Layout* L, size_t* smem) {
  int limit = 0;
  cudaError_t err = shared_limit(&limit);
  if (err != cudaSuccess) return err;
  const size_t marks = (size_t)h + w;
  *L = ccl::make_layout(h, w, true);
  *smem = (size_t)L->size * sizeof(int) + marks;
  *shared = *smem <= (size_t)limit;
  if (!*shared) {
    *L = ccl::make_layout(h, w, false);
    *smem = marks;
    if (*smem > (size_t)limit) return cudaErrorInvalidValue;
  }
  static bool raised[2] = {false, false};
  if (*smem > 48 * 1024 && !raised[*shared]) {
    err = cudaFuncSetAttribute(*shared ? cc_label_kernel<true> : cc_label_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    raised[*shared] = true;
  }
  return cudaSuccess;
}

template <class Kernel>
cudaError_t describe(Kernel kernel, size_t smem, int* blocks, cudaFuncAttributes* attr) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? cudaFuncGetAttributes(attr, kernel) : err;
}

}  // namespace

// fg: [m, h, w] bytes (0 = background); labels: [m, h, w] int32 out; sweeps: [m] int32 out, the sweeps each
// mask ran (the last one changed nothing, unless the mask reached max_sweeps). One block per mask. Returns
// cudaGetLastError() after the launch.
extern "C" int cc_label(const unsigned char* fg, int* labels, int* sweeps, int m, int h, int w, int max_sweeps,
                        cudaStream_t stream) {
  if (m <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if ((long long)h * w >= (1LL << 31) - 1) return (int)cudaErrorInvalidValue;  // labels are int32
  bool shared = false;
  ccl::Layout L;
  size_t smem = 0;
  cudaError_t err = plan(h, w, &shared, &L, &smem);
  if (err != cudaSuccess) return (int)err;
  if (shared) {
    cc_label_kernel<true><<<m, kThreads, smem, stream>>>(fg, labels, sweeps, L, max_sweeps);
  } else {
    cc_label_kernel<false><<<m, kThreads, smem, stream>>>(fg, labels, sweeps, L, max_sweeps);
  }
  return (int)cudaGetLastError();
}

// What cc_label launches for masks of h x w, into out[0..4]: threads a block, blocks an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), dynamic shared memory in bytes, 1 for the shared-memory kernel
// (0: device memory), and registers a thread. Returns a cudaError_t.
extern "C" int cc_config(int h, int w, int* out) {
  bool shared = false;
  ccl::Layout L;
  size_t smem = 0;
  cudaError_t err = plan(h, w, &shared, &L, &smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  cudaFuncAttributes attr;
  err = shared ? describe(cc_label_kernel<true>, smem, &blocks, &attr)
               : describe(cc_label_kernel<false>, smem, &blocks, &attr);
  if (err != cudaSuccess) return (int)err;
  out[0] = kThreads;
  out[1] = blocks;
  out[2] = (int)smem;
  out[3] = shared ? 1 : 0;
  out[4] = attr.numRegs;
  return (int)cudaSuccess;
}
