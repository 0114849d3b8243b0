// The flood sweep of connected-component labelling, shared by the CUDA kernel
// (cc.cu) and its host build (cc_host.cpp), so that the CPU tests check the
// card's sweeps against the JAX package.
//
// Labels live in a [h, w] grid with a row stride (>= w). A pixel is
// foreground iff its label is > 0: every foreground pixel starts at its
// linear index + 1 and labels only grow, background stays 0. One line pass
// replaces every run of foreground pixels along the line by the run's
// maximum: what the forward and backward segmented max-scans of
// casapose_tpu/ops/connected_components.py::_sweep give together. A sweep is
// the pass over every row, then over every column; sweeps repeat until one
// changes nothing, at most max_sweeps times, as the JAX package's
// lax.while_loop does.
#pragma once

#ifdef __CUDACC__
#define CC_HD __host__ __device__ __forceinline__
#else
#define CC_HD inline
#endif

namespace ccl {

// First label of a pixel: its linear index + 1 where fg, else 0.
CC_HD int initial_label(unsigned char fg, int linear) { return fg ? linear + 1 : 0; }

// Replace every foreground run of the line lab[0], lab[step], ..., lab[(n - 1) * step] by its maximum.
// Returns whether any label changed.
CC_HD bool flood_line(int* lab, int n, int step) {
  bool changed = false;
  int i = 0;
  while (i < n) {
    if (lab[i * step] == 0) {
      ++i;
      continue;
    }
    int j = i, best = 0;
    for (; j < n && lab[j * step] != 0; ++j) best = lab[j * step] > best ? lab[j * step] : best;
    for (int q = i; q < j; ++q) {
      if (lab[q * step] != best) {
        lab[q * step] = best;
        changed = true;
      }
    }
    i = j;
  }
  return changed;
}

// Row r of a grid with row stride `stride`, and column c.
CC_HD bool flood_row(int* lab, int r, int w, int stride) { return flood_line(lab + (long long)r * stride, w, 1); }
CC_HD bool flood_col(int* lab, int c, int h, int stride) { return flood_line(lab + c, h, stride); }

}  // namespace ccl
