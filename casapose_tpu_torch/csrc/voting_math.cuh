// Per-pixel voting arithmetic and the voting kernel's tiling constants, shared by
// the CUDA kernel (voting.cu) and its host build (voting_host.cpp), so that the
// CPU tests check the card's arithmetic and summation order.
//
// For a pixel centre (cy, cx) (divided by the image height), a keypoint's
// direction (dy, dx) and confidence logit conf: the unit direction n (zero
// where the direction is zero), the softplus weight w and
// w * [1 - ny^2, -ny nx, 1 - nx^2, qy, qx, 1] with (qy, qx) = [[a, b], [b, d]] (cy, cx).
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CV_HD __host__ __device__ __forceinline__
#else
#define CV_HD inline
#endif

namespace cvote {

constexpr int kFeat = 6;
constexpr int kThreads = 384;               // threads of a block: 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 32;                    // pixels of a segment: one per lane of a warp
constexpr int kGroupPoints = 9;             // keypoints a block handles
constexpr int kClassGroup = 8;              // classes a block handles
constexpr int kSlots = kGroupPoints * kFeat;  // 54 sums per class
constexpr int kPartPoints = 5;              // keypoints staged per pass: 2 passes, lane l owns slots l and 30 + l
constexpr int kParts = (kGroupPoints + kPartPoints - 1) / kPartPoints;
constexpr int kPartSlots = kPartPoints * kFeat;  // 30
constexpr int kStageStride = kPartSlots + 1;     // per-lane stride of the staging area, odd: no bank conflicts

// rsqrtf on the card (one MUFU op, as the plain version's torch.rsqrt rounds there); 1/sqrt on the host.
CV_HD float rsqrt_(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

CV_HD float softplus(float x) { return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))); }

// The six features of one pixel and keypoint into f[0..5].
CV_HD void features(float dy, float dx, float conf, float cy, float cx, float* f) {
  const float norm2 = dy * dy + dx * dx;
  const float inv = rsqrt_(fmaxf(norm2, 1e-30f));
  const bool good = norm2 > 0.0f;
  const float ny = good ? dy * inv : 0.0f;
  const float nx = good ? dx * inv : 0.0f;
  const float wgt = softplus(conf);
  const float a = (1.0f - ny * ny) * wgt;
  const float bb = (-ny * nx) * wgt;
  const float d = (1.0f - nx * nx) * wgt;
  f[0] = a;
  f[1] = bb;
  f[2] = d;
  f[3] = a * cy + bb * cx;
  f[4] = bb * cy + d * cx;
  f[5] = wgt;
}

// Part x of n of the range [0, total): contiguous, in order. Block x of gx takes its part of an image's
// segments.
CV_HD void split_range(int x, int n, int total, int* lo, int* hi) {
  *lo = (int)((long long)x * total / n);
  *hi = (int)((long long)(x + 1) * total / n);
}

}  // namespace cvote
