// Host build of the voting kernel's arithmetic and summation order (voting.cu), for the CPU tests:
//   g++ -O2 -std=c++17 -shared -fPIC -o libvoting_host.so voting_host.cpp
// The same per-pixel features (voting_math.cuh) are summed in the kernel's order. Per block (gx per image,
// keypoint group and class group) and per warp w of the block, its 32-pixel segments b0 + w, b0 + w + 12,
// ... in order: the pixels of the warp's run class add to the run sums, lane by lane; a segment whose
// labelled pixels are all of one other class ends the run (folded into the warp's class sums) and starts one
// of that class; pixels of other classes are folded class by class, each slot summing the class's pixels
// into 4 partial sums (lane p into p % 4, in lane order), then (s0 + s1) + (s2 + s3). Then warps 0..11, then
// blocks 0..gx-1. Only the copies into shared memory are left out.

#include <algorithm>
#include <cstddef>
#include <vector>

#include "voting_math.cuh"

using namespace cvote;

namespace {

using Rows = float (*)[kSlots];

// Fold one pass of staged slots (vals[lane][slot], classes q[lane]) into the class sums A[class][slot].
void fold_classes(const Rows vals, const int* q, int slot0, int slots, float* A) {
  bool done[kSeg] = {};
  for (int first = 0; first < kSeg; ++first) {
    if (q[first] == 0 || done[first]) continue;
    const int c = q[first];
    for (int sl = 0; sl < slots; ++sl) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int p = 0; p < kSeg; ++p)
        if (q[p] == c) part[p & 3] += vals[p][slot0 + sl];
      A[(c - 1) * kSlots + slot0 + sl] += (part[0] + part[1]) + (part[2] + part[3]);
    }
    for (int p = 0; p < kSeg; ++p)
      if (q[p] == c) done[p] = true;
  }
}

void fold_all_parts(const Rows vals, const int* q, float* A) {
  for (int h = 0; h < kParts; ++h)
    fold_classes(vals, q, h * kPartSlots, std::min(kPartSlots, kSlots - h * kPartSlots), A);
}

void fold_run(const Rows run_sums, int run, float* A) {
  int q[kSeg];
  std::fill(q, q + kSeg, run);
  fold_all_parts(run_sums, q, A);
}

}  // namespace

// raw: [b, h, w, c] f32; labels: [b, h, w] int32; out: [b, oc, k, 6] f32, oc = seg_dim - 1; gx blocks per image
// and group.
extern "C" int voting_accumulate_host(const float* raw, const int* labels, float* out, int b, int h, int w, int c,
                                      int seg_dim, int k, int gx) {
  const int oc = seg_dim - 1, npix = h * w, n_segs = (npix + kSeg - 1) / kSeg;
  const int kgroups = (k + kGroupPoints - 1) / kGroupPoints, cgroups = (oc + kClassGroup - 1) / kClassGroup;
  std::vector<float> partials((size_t)b * gx * oc * k * kFeat, 0.0f);
  std::vector<float> A((size_t)kWarps * kClassGroup * kSlots);
  std::vector<float> acc((size_t)kSeg * kSlots), vals((size_t)kSeg * kSlots);
  const Rows run_sums = reinterpret_cast<Rows>(acc.data());
  const Rows f = reinterpret_cast<Rows>(vals.data());
  for (int img = 0; img < b; ++img)
    for (int kg = 0; kg < kgroups; ++kg)
      for (int cg = 0; cg < cgroups; ++cg)
        for (int x = 0; x < gx; ++x) {
          const int dir0 = seg_dim + 2 * kGroupPoints * kg, conf0 = seg_dim + 2 * k + kGroupPoints * kg;
          const int nk = std::min(kGroupPoints, k - kGroupPoints * kg);
          const int class0 = cg * kClassGroup;
          std::fill(A.begin(), A.end(), 0.0f);
          int b0, b1;
          split_range(x, gx, n_segs, &b0, &b1);
          for (int wi = 0; wi < kWarps; ++wi) {
            float* Aw = A.data() + (size_t)wi * kClassGroup * kSlots;
            int run = 0;
            for (int u = b0 + wi; u < b1; u += kWarps) {
              int q[kSeg];
              std::fill(vals.begin(), vals.end(), 0.0f);
              for (int lane = 0; lane < kSeg; ++lane) {
                const int pid = u * kSeg + lane;
                const int lab = pid < npix ? labels[(size_t)img * npix + pid] : 0;
                q[lane] = (lab >= 1 && lab <= oc && lab > class0 && lab <= class0 + kClassGroup) ? lab - class0 : 0;
                if (q[lane] == 0) continue;
                const int y = pid / w;
                const float cy = ((float)y + 0.5f) / (float)h;
                const float cx = ((float)(pid - y * w) + 0.5f) / (float)h;
                const float* rec = raw + ((size_t)img * npix + pid) * c;
                for (int j = 0; j < nk; ++j)
                  features(rec[dir0 + 2 * j], rec[dir0 + 2 * j + 1], rec[conf0 + j], cy, cx, f[lane] + j * kFeat);
              }
              int first = -1;
              for (int lane = kSeg - 1; lane >= 0; --lane)
                if (q[lane] != 0) first = lane;
              if (first < 0) continue;
              const int c0 = q[first];
              bool single = true;
              for (int lane = 0; lane < kSeg; ++lane) single = single && (q[lane] == 0 || q[lane] == c0);
              if (run == 0 || (single && c0 != run)) {
                if (run != 0) fold_run(run_sums, run, Aw);
                std::fill(acc.begin(), acc.end(), 0.0f);
                run = c0;
              }
              int others[kSeg];
              bool fold = false;
              for (int lane = 0; lane < kSeg; ++lane) {
                if (q[lane] == run)
                  for (int i = 0; i < nk * kFeat; ++i) run_sums[lane][i] += f[lane][i];
                others[lane] = (q[lane] != 0 && q[lane] != run) ? q[lane] : 0;
                fold = fold || others[lane] != 0;
              }
              if (fold) fold_all_parts(f, others, Aw);
            }
            if (run != 0) fold_run(run_sums, run, Aw);
          }
          const int n_cls = std::min(kClassGroup, oc - class0);
          float* dst = partials.data() + (((size_t)img * gx + x) * oc + class0) * k * kFeat + (size_t)kg * kSlots;
          for (int cl = 0; cl < n_cls; ++cl)
            for (int r = 0; r < nk * kFeat; ++r) {
              float sum = 0.0f;
              for (int wi = 0; wi < kWarps; ++wi) sum += A[((size_t)wi * kClassGroup + cl) * kSlots + r];
              dst[(size_t)cl * k * kFeat + r] = sum;
            }
        }
  const int per_image = oc * k * kFeat;
  for (int img = 0; img < b; ++img)
    for (int i = 0; i < per_image; ++i) {
      float s = 0.0f;
      for (int x = 0; x < gx; ++x) s += partials[((size_t)img * gx + x) * per_image + i];
      out[(size_t)img * per_image + i] = s;
    }
  return 0;
}
