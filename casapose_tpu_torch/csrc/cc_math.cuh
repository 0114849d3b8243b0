// The line arithmetic of connected-component labelling, shared by the CUDA kernel
// (cc.cu) and its host build (cc_host.cpp), so that the CPU tests check the
// card's lanes against the JAX package.
//
// A pixel is foreground iff its label is > 0: every foreground pixel starts at
// its linear index + 1 and labels only grow, background stays 0. One line pass
// replaces every run of foreground pixels along the line by the run's maximum:
// what the forward and backward segmented max-scans of
// casapose_tpu/ops/connected_components.py::_sweep give together. A sweep is
// the pass over every row, then over every column; sweeps repeat until one
// changes nothing, at most max_sweeps times, as the JAX package's
// lax.while_loop does.
//
// A line is scanned by one warp. Lane l holds E consecutive elements
// [l * E, l * E + E) of a tile of 32 * E elements (E = chunk_of(n)); a line
// longer than one tile is walked tile by tile with a carry. The scans work on
// JAX's (reset, max) pairs, packed in one word: bit 31 the reset flag (a
// background pixel, or one beyond the line's end), bits 0-30 the maximum since
// the last reset. A line pass is
//   scan_up     each lane's local forward scan of its elements;
//   (warp)      an exclusive scan of the lanes' aggregates, by shuffles up;
//   fix_up      each element combined with the carry of the lanes before it:
//               the forward scan F of the whole line;
//   scan_down   each lane's local backward scan of F;
//   (warp)      an exclusive scan of the aggregates, by shuffles down;
//   fix_up      the backward scan of F: each element its run's maximum (F
//               rises along a run, so its backward maximum is F at the run's
//               end, the run's maximum), which is max(forward, backward) of
//               the labels, as JAX takes it.
// Every step only raises a value, so an element changed in the pass iff some
// step changed it: the lanes keep one bit an element, and write back only those.
#pragma once

#ifdef __CUDACC__
#define CC_HD __host__ __device__ __forceinline__
#else
#define CC_HD inline
#endif

namespace ccl {

constexpr int kMaxChunk = 5;  // elements a lane holds: a tile is 32 * kMaxChunk = 160 elements of a line
constexpr unsigned kReset = 0x80000000u;

// First label of a pixel: its linear index + 1 where fg, else 0.
CC_HD int initial_label(unsigned char fg, int linear) { return fg ? linear + 1 : 0; }

// Elements a lane holds in a pass over lines of n elements.
CC_HD int chunk_of(int n) {
  const int e = (n + 31) / 32;
  return e < kMaxChunk ? e : kMaxChunk;
}

// A label as a (reset, max) pair: background resets the scan.
CC_HD unsigned pack(int label) { return label ? (unsigned)label : kReset; }
CC_HD int value(unsigned pair) { return (int)(pair & ~kReset); }

// JAX's combine of _segmented_max_scan, a before b: (ra | rb, rb ? vb : max(va, vb)). 0 is its identity.
CC_HD unsigned combine(unsigned a, unsigned b) {
  if (b & kReset) return b;
  const unsigned va = a & ~kReset;
  return (a & kReset) | (va > b ? va : b);
}

// Sets bit j of `bits` where `cond`. On the device an empty asm after each bit keeps the compiler from fusing the
// unrolled comparisons of a chunk: with 8 elements a lane, nvcc (CUDA 12.8) compiled the plain `bits |= cond << j`
// of these loops wrongly, and the card's labels differed from the host build's from the second sweep on; with the
// select and the fence they are the host build's.
CC_HD void set_bit(unsigned& bits, int j, bool cond) {
  bits |= cond ? 1u << j : 0u;
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(bits));
#endif
}

// One step of a lane's inclusive warp scan: combine what a lane `d` places earlier holds, if there is one.
CC_HD unsigned scan_step(unsigned mine, unsigned earlier, bool has_earlier) {
  return has_earlier ? combine(earlier, mine) : mine;
}

// Lane-local forward scan: labels v[0..E) -> their packed inclusive prefixes. Sets bit j of chg where an element's
// value rose. Returns the lane's aggregate.
template <int E>
CC_HD unsigned scan_up(unsigned (&v)[E], unsigned& chg) {
  unsigned acc = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    acc = combine(acc, pack((int)v[j]));
    set_bit(chg, j, value(acc) != (int)v[j]);
    v[j] = acc;
  }
  return acc;
}

// Lane-local backward scan: values v[0..E) -> their packed inclusive suffixes. As scan_up, from the right.
template <int E>
CC_HD unsigned scan_down(unsigned (&v)[E], unsigned& chg) {
  unsigned acc = 0;
#pragma unroll
  for (int j = E - 1; j >= 0; --j) {
    acc = combine(acc, pack((int)v[j]));
    set_bit(chg, j, value(acc) != (int)v[j]);
    v[j] = acc;
  }
  return acc;
}

// Fix-up: packed local scans v[0..E) -> the values of the whole line's scan, given `carry`, the aggregate of all
// that comes before this lane in scan order (0 if nothing does).
template <int E>
CC_HD void fix_up(unsigned (&v)[E], unsigned carry, unsigned& chg) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int before = value(v[j]);
    const int after = value(combine(carry, v[j]));
    set_bit(chg, j, after != before);
    v[j] = (unsigned)after;
  }
}

// Where the labels of a mask live while it is swept. In device memory the labels are the output itself, row-major
// (stride w). In shared memory they are swizzled, so that neither pass meets a bank conflict: a row's lanes read
// addresses erow (+ 1) apart, which must be odd, and a column's lanes rows ecol apart, so their addresses differ by
// ecol * stride + 1 (the shift of row r by r / ecol), which must be odd too.
//   element (r, c) at row_base(r) + col_index(c)
//   row_base(r)  = r * stride + r / ecol
//   col_index(c) = c + c / erow where erow is even (one free slot after each lane's chunk), else c
struct Layout {
  int h, w;
  int erow, ecol;  // chunk_of(w), chunk_of(h): elements a lane holds in the row and the column pass
  int stride;      // row stride in elements
  int swizzle;     // 1 in shared memory
  int size;        // elements the layout spans
};

CC_HD int col_index(const Layout& L, int c) { return c + ((L.swizzle && L.erow % 2 == 0) ? c / L.erow : 0); }
CC_HD int row_base(const Layout& L, int r) { return r * L.stride + (L.swizzle ? r / L.ecol : 0); }

CC_HD Layout make_layout(int h, int w, bool swizzle) {
  Layout L;
  L.h = h;
  L.w = w;
  L.erow = chunk_of(w);
  L.ecol = chunk_of(h);
  L.swizzle = swizzle ? 1 : 0;
  const int row_len = col_index(L, w - 1) + 1;
  // ecol * stride must be even: an odd ecol takes an even stride.
  L.stride = row_len + ((swizzle && L.ecol % 2 == 1 && row_len % 2 == 1) ? 1 : 0);
  L.size = row_base(L, h - 1) + row_len;
  return L;
}

}  // namespace ccl
