// Host build of the CC labelling kernel's sweeps (cc.cu), for the CPU tests:
//   g++ -O2 -std=c++17 -shared -fPIC -o libcc_host.so cc_host.cpp
// Per mask, the kernel's loop on one thread: the initial labels, then sweeps of the row pass and the column pass
// of cc_math.cuh until a sweep changes nothing or max_sweeps sweeps ran. Lines of a pass are independent, so the
// kernel's threads and this loop give the same labels.

#include <vector>

#include "cc_math.cuh"

// fg: [m, h, w] bytes; labels: [m, h, w] int32 out; sweeps: [m] int32 out. Returns 0.
extern "C" int cc_label_host(const unsigned char* fg, int* labels, int* sweeps, int m, int h, int w, int max_sweeps) {
  const long long npix = (long long)h * w;
  for (int i = 0; i < m; ++i) {
    int* lab = labels + i * npix;
    for (long long p = 0; p < npix; ++p) lab[p] = ccl::initial_label(fg[i * npix + p], (int)p);
    int s = 0;
    while (s < max_sweeps) {
      bool changed = false;
      for (int r = 0; r < h; ++r) changed |= ccl::flood_row(lab, r, w, w);
      for (int c = 0; c < w; ++c) changed |= ccl::flood_col(lab, c, h, w);
      ++s;
      if (!changed) break;
    }
    sweeps[i] = s;
  }
  return 0;
}
