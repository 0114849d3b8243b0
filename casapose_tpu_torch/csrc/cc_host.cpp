// Host build of the CC labelling kernel (cc.cu), for the CPU tests:
//   g++ -O2 -std=c++17 -shared -fPIC -o libcc_host.so cc_host.cpp
// Per mask, the kernel's block on one thread: the first labels in the kernel's layout (shared memory's swizzled one,
// or device memory's row-major one), then sweeps of the row pass and the column pass until a sweep changes nothing
// or max_sweeps sweeps ran, each pass scanning only the lines the pass before marked. Each line is scanned as the
// kernel's warp scans it: 32 lanes, each with its chunk of the line, the lane-local steps of cc_math.cuh, and arrays
// of the 32 lanes' values standing in for the shuffles (a shuffle reads every lane's value from before the step).

#include <vector>

#include "cc_math.cuh"

namespace {

constexpr int kLanes = 32;

// The kernel's warp_exclusive over 32 emulated lanes: before[l] = the aggregate of the lanes before l in scan order
// (0 for the first), *total = that of all 32.
void warp_exclusive(bool up, const unsigned (&agg)[kLanes], unsigned (&before)[kLanes], unsigned* total) {
  unsigned x[kLanes], shuffled[kLanes];
  for (int l = 0; l < kLanes; ++l) x[l] = agg[l];
  for (int d = 1; d < kLanes; d <<= 1) {
    for (int l = 0; l < kLanes; ++l) {  // __shfl_up_sync / __shfl_down_sync: out of range, a lane reads its own
      const int src = up ? l - d : l + d;
      shuffled[l] = (src >= 0 && src < kLanes) ? x[src] : x[l];
    }
    for (int l = 0; l < kLanes; ++l) x[l] = ccl::scan_step(x[l], shuffled[l], up ? l >= d : l + d < kLanes);
  }
  *total = x[up ? kLanes - 1 : 0];
  for (int l = 0; l < kLanes; ++l) before[l] = up ? (l > 0 ? x[l - 1] : 0u) : (l < kLanes - 1 ? x[l + 1] : 0u);
}

// Element i of a line at lab[index(i)].
struct Line {
  int* lab;
  int n;
  const ccl::Layout* L;
  bool row;  // a row (index r) or a column (index c)
  int k;
  int at(int i) const {
    return row ? ccl::row_base(*L, k) + ccl::col_index(*L, i) : ccl::row_base(*L, i) + ccl::col_index(*L, k);
  }
};

// The kernel's flood_line: a tile of 32 * E elements, lane l holding [l * E, l * E + E), the forward scan tile by
// tile from the left (its values written back where they rose), then the backward scan from the right. The kernel
// keeps a line of one tile in registers between the scans; written back or not, the values are the same.
template <int E>
bool flood_line(const Line& line, unsigned char* mark) {
  constexpr int kTile = kLanes * E;
  const int tiles = (line.n + kTile - 1) / kTile;
  bool any = false;
  for (int dir = 0; dir < 2; ++dir) {
    const bool up = dir == 0;
    unsigned carry = 0;
    for (int s = 0; s < tiles; ++s) {
      const int t = up ? s : tiles - 1 - s;
      unsigned v[kLanes][E], chg[kLanes] = {}, agg[kLanes], before[kLanes], total;
      for (int l = 0; l < kLanes; ++l) {
        for (int j = 0; j < E; ++j) {
          const int i = t * kTile + l * E + j;
          v[l][j] = i < line.n ? (unsigned)line.lab[line.at(i)] : 0u;
        }
        agg[l] = up ? ccl::scan_up<E>(v[l], chg[l]) : ccl::scan_down<E>(v[l], chg[l]);
      }
      warp_exclusive(up, agg, before, &total);
      for (int l = 0; l < kLanes; ++l) {
        ccl::fix_up<E>(v[l], ccl::combine(carry, before[l]), chg[l]);
        for (int j = 0; j < E; ++j) {
          if ((chg[l] >> j) & 1u) {
            const int i = t * kTile + l * E + j;
            line.lab[line.at(i)] = (int)v[l][j];
            mark[i] = 1;
          }
        }
        any |= chg[l] != 0;
      }
      carry = ccl::combine(carry, total);
    }
  }
  return any;
}

// flood_line<e> for a chunk e in E..kMaxChunk, as the kernel's with_chunk.
template <int E = 1>
bool flood(const Line& line, int e, unsigned char* mark) {
  if constexpr (E == ccl::kMaxChunk) {
    return flood_line<E>(line, mark);
  } else {
    return e == E ? flood_line<E>(line, mark) : flood<E + 1>(line, e, mark);
  }
}

}  // namespace

// fg: [m, h, w] bytes; labels: [m, h, w] int32 out; sweeps: [m] int32 out. shared_layout: 1 for the layout of the
// kernel's shared-memory path, 0 for its device-memory path. Returns 0.
extern "C" int cc_label_host(const unsigned char* fg, int* labels, int* sweeps, int m, int h, int w, int max_sweeps,
                             int shared_layout) {
  const ccl::Layout L = ccl::make_layout(h, w, shared_layout != 0);
  const long long npix = (long long)h * w;
  for (int i = 0; i < m; ++i) {
    const unsigned char* mask = fg + i * npix;
    int* out = labels + i * npix;
    std::vector<int> lab(L.size, -1);  // a slot outside the layout's elements, if read, would break the labels
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c)
        lab[ccl::row_base(L, r) + ccl::col_index(L, c)] = ccl::initial_label(mask[r * w + c], r * w + c);
    std::vector<unsigned char> row_marks(h, 1), col_marks(w, 1);
    int s = 0;
    while (s < max_sweeps) {
      bool changed = false;
      for (int r = 0; r < h; ++r) {
        if (!row_marks[r]) continue;
        row_marks[r] = 0;
        changed |= flood(Line{lab.data(), w, &L, true, r}, L.erow, col_marks.data());
      }
      for (int c = 0; c < w; ++c) {
        if (!col_marks[c]) continue;
        col_marks[c] = 0;
        changed |= flood(Line{lab.data(), h, &L, false, c}, L.ecol, row_marks.data());
      }
      ++s;
      if (!changed) break;
    }
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) out[r * w + c] = lab[ccl::row_base(L, r) + ccl::col_index(L, c)];
    sweeps[i] = s;
  }
  return 0;
}
