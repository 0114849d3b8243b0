// Fused LS-voting accumulation for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/voting_kernel.py::voting_accumulate_pallas
// (_voting_accumulate_kernel). For every pixel of class o > 0 and every
// keypoint j it forms the unit direction n (zero guard), the softplus weight
// w and w*[a, b, d, qy, qx, 1] with a = 1-ny^2, b = -ny*nx, d = 1-nx^2,
// (qy, qx) = [[a, b], [b, d]] (cy, cx), pixel centres divided by the image
// height; S[img, o, j, :] sums them.
//
// What bounds it on this card: bytes. It reads the raw output once
// ([b, h, w, C] f32, C = 36 on the main path: 44 MB per 480x640 image) and
// the label map; per pixel and keypoint it does ~40 flops, far below the
// 67 TFLOP/s f32 rate at 3.35 TB/s.
//
// Design: the TPU kernel built a [64, P] feature scratch and looped MXU dots
// over rows; none of that carries over. Here
//   pass 1: a block owns ROWS rows of one image and up to 8 classes
//           (blockIdx.y picks the group of 8). Warp j of the block handles
//           keypoint j; each lane walks the tile's pixels with stride 32,
//           skips background pixels without reading their raw channels,
//           and keeps 8 classes x 6 sums in registers (the class select is
//           an unrolled predicated add, no local-memory indexing). A warp
//           shuffle tree reduces the lanes, the per-keypoint results meet
//           in shared memory, and the block writes one partial
//           [oc_in_group, k, 6] to a scratch buffer.
//   pass 2: one block per image sums the partials over tiles in a fixed
//           order.
// No atomics anywhere, so a run repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kClassGroup = 8;
constexpr int kFeat = 6;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void voting_accumulate_kernel(const float* __restrict__ raw, const int* __restrict__ labels,
                                       float* __restrict__ partials, int h, int w, int c, int seg_dim,
                                       int k, int rows) {
  const int tile = blockIdx.x;
  const int group = blockIdx.y;
  const int img = blockIdx.z;
  const int n_tiles = gridDim.x;
  const int oc = seg_dim - 1;
  const int j = threadIdx.y;     // keypoint
  const int lane = threadIdx.x;  // 0..31
  const int row0 = tile * rows;
  const int row1 = min(row0 + rows, h);
  const int npix = (row1 - row0) * w;
  const float fh = (float)h;
  const int class0 = group * kClassGroup + 1;  // first class of this block

  float acc[kClassGroup][kFeat];
#pragma unroll
  for (int q = 0; q < kClassGroup; ++q)
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[q][f] = 0.0f;

  const size_t img_pix = (size_t)img * h * w;
  for (int p = lane; p < npix; p += 32) {
    const int y = row0 + p / w;
    const int x = p - (y - row0) * w;
    const size_t pix = img_pix + (size_t)y * w + x;
    const int q = __ldg(labels + pix) - class0;
    if (q < 0 || q >= kClassGroup) continue;  // background or another group
    const float* px = raw + pix * c;
    const float dy = __ldg(px + seg_dim + 2 * j);
    const float dx = __ldg(px + seg_dim + 2 * j + 1);
    const float conf = __ldg(px + seg_dim + 2 * k + j);
    const float norm2 = dy * dy + dx * dx;
    const float inv = rsqrtf(fmaxf(norm2, 1e-30f));
    const bool good = norm2 > 0.0f;
    const float ny = good ? dy * inv : 0.0f;
    const float nx = good ? dx * inv : 0.0f;
    const float wgt = softplus(conf);
    const float a = (1.0f - ny * ny) * wgt;
    const float bb = (-ny * nx) * wgt;
    const float d = (1.0f - nx * nx) * wgt;
    const float cy = ((float)y + 0.5f) / fh;
    const float cx = ((float)x + 0.5f) / fh;
    const float qy = a * cy + bb * cx;
    const float qx = bb * cy + d * cx;
#pragma unroll
    for (int s = 0; s < kClassGroup; ++s) {
      if (s == q) {
        acc[s][0] += a;
        acc[s][1] += bb;
        acc[s][2] += d;
        acc[s][3] += qy;
        acc[s][4] += qx;
        acc[s][5] += wgt;
      }
    }
  }

  // Lane reduction, fixed order.
#pragma unroll
  for (int s = 0; s < kClassGroup; ++s)
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
      float v = acc[s][f];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      acc[s][f] = v;
    }

  extern __shared__ float smem[];  // [kClassGroup][k][kFeat]
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kClassGroup; ++s)
#pragma unroll
      for (int f = 0; f < kFeat; ++f) smem[(s * k + j) * kFeat + f] = acc[s][f];
  }
  __syncthreads();

  // partials: [b, n_tiles, oc, k, 6]; this block owns classes class0..class0+7.
  const int n_cls = min(kClassGroup, oc - (class0 - 1));
  const int n_out = n_cls * k * kFeat;
  float* dst = partials + (((size_t)img * n_tiles + tile) * oc + (class0 - 1)) * k * kFeat;
  for (int i = threadIdx.y * 32 + lane; i < n_out; i += blockDim.x * blockDim.y) dst[i] = smem[i];
}

__global__ void voting_reduce_kernel(const float* __restrict__ partials, float* __restrict__ out, int n_tiles,
                                     int per_image) {
  const int img = blockIdx.x;
  const float* src = partials + (size_t)img * n_tiles * per_image;
  for (int i = threadIdx.x; i < per_image; i += blockDim.x) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t) s += src[(size_t)t * per_image + i];
    out[(size_t)img * per_image + i] = s;
  }
}

}  // namespace

// raw: [b, h, w, c] f32; labels: [b, h, w] int32; partials: scratch
// [b, ceil(h / rows), oc, k, 6] f32; out: [b, oc, k, 6] f32, oc = seg_dim - 1.
// Needs 1 <= k <= 32. Returns cudaGetLastError() after both launches.
extern "C" int voting_accumulate(const float* raw, const int* labels, float* partials, float* out, int b, int h,
                                 int w, int c, int seg_dim, int k, int rows, cudaStream_t stream) {
  const int oc = seg_dim - 1;
  const int n_tiles = (h + rows - 1) / rows;
  const int groups = (oc + kClassGroup - 1) / kClassGroup;
  const dim3 grid1(n_tiles, groups, b);
  const dim3 block1(32, k);
  const size_t smem = (size_t)kClassGroup * k * kFeat * sizeof(float);
  voting_accumulate_kernel<<<grid1, block1, smem, stream>>>(raw, labels, partials, h, w, c, seg_dim, k, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  voting_reduce_kernel<<<b, 256, 0, stream>>>(partials, out, n_tiles, oc * k * kFeat);
  return (int)cudaGetLastError();
}
