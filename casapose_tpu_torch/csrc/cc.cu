// Connected-component labelling by flood sweeps, on the device in one launch, for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/connected_components.py::connected_components_labels,
// the lax.while_loop of flood sweeps that the JAX package runs in XLA (no
// Pallas kernel): the port's plain loop reads a "changed" flag on the host
// after every sweep; this kernel keeps the loop, and the flag, on the card.
// The sweep itself is in cc_math.cuh, shared with the host build that the
// CPU tests run.
//
// What bounds it on this card: neither bytes nor operations, but the serial
// chain of the sweeps. A mask is read once (1 byte a pixel) and its labels
// written once (4 bytes); a sweep does a few integer operations a pixel, and
// a mask needs a handful of sweeps (chip_smoke.py counts them on every
// path). The time is the sweeps' dependent steps: each line pass is one
// thread walking its row or column.
//
// Design: one block per mask, so the masks of a batch (b x objects, 256 at
// batch 32 with 8 objects) run side by side and the sweep loop needs only
// block-wide barriers: a sweep is a row pass (a thread per row, serial
// along it), a barrier, a column pass (a thread per column), a barrier, and
// a block-wide "changed" flag decides whether to sweep again, at most
// max_sweeps times; no host read. Masks that fit keep their labels in
// shared memory (120 x 160 at the default --cc_filter_downsample 4: 77 KB
// with the row stride made odd, so that neither the row threads nor the
// column threads of a warp meet in a bank); larger ones (480 x 640 at
// --cc_filter_downsample 1) sweep the output in device memory, with the
// same barriers. The labels equal the plain loop's exactly, the capped case
// included: each mask runs the same sweeps in the same order, and a mask
// that has converged is a fixed point of the sweeps the others still need.

#include <cuda_runtime.h>

#include "cc_math.cuh"

namespace {

template <bool kShared>
__global__ void cc_label_kernel(const unsigned char* __restrict__ fg, int* labels, int* sweeps, int h, int w,
                                int stride, int max_sweeps) {
  extern __shared__ int smem[];
  __shared__ int changed;
  const long long base = (long long)blockIdx.x * h * w;
  int* lab = kShared ? smem : labels + base;
  const int npix = h * w;
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int r = p / w, c = p - r * w;
    lab[r * stride + c] = ccl::initial_label(fg[base + p], p);
  }
  __syncthreads();
  int s = 0;
  while (s < max_sweeps) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    bool mine = false;
    for (int r = threadIdx.x; r < h; r += blockDim.x) mine |= ccl::flood_row(lab, r, w, stride);
    __syncthreads();
    for (int c = threadIdx.x; c < w; c += blockDim.x) mine |= ccl::flood_col(lab, c, h, stride);
    if (mine) changed = 1;
    __syncthreads();
    ++s;
    const int any = changed;
    __syncthreads();  // every thread has read the flag before thread 0 clears it again
    if (!any) break;
  }
  if (kShared) {
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      const int r = p / w, c = p - r * w;
      labels[base + p] = lab[r * stride + c];
    }
  }
  if (threadIdx.x == 0) sweeps[blockIdx.x] = s;
}

}  // namespace

// fg: [m, h, w] bytes (0 = background); labels: [m, h, w] int32 out; sweeps: [m] int32 out, the sweeps each
// mask ran (the last one changed nothing, unless the mask reached max_sweeps). One block per mask. Returns
// cudaGetLastError() after the launch.
extern "C" int cc_label(const unsigned char* fg, int* labels, int* sweeps, int m, int h, int w, int max_sweeps,
                        cudaStream_t stream) {
  if (m <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  // The dynamic shared memory a block may have (the opt-in limit), and may have without asking (48 KB), each
  // less the kernel's static flag.
  static int dynamic_limit = -1, configured = -1;
  cudaError_t err = cudaSuccess;
  if (dynamic_limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, cc_label_kernel<true>);
    if (err != cudaSuccess) return (int)err;
    dynamic_limit = optin - (int)attr.sharedSizeBytes;
    configured = 48 * 1024 - (int)attr.sharedSizeBytes;
  }
  int longest = h > w ? h : w;
  const int threads = longest >= 1024 ? 1024 : ((longest + 31) / 32) * 32;
  const int stride = w | 1;  // odd: a warp's rows and its columns each fall in 32 different banks
  const size_t smem = (size_t)h * stride * sizeof(int);
  if (smem <= (size_t)dynamic_limit) {
    if ((int)smem > configured) {  // once a process: raising the limit is no stream operation, so not in a graph
      err = cudaFuncSetAttribute(cc_label_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_limit);
      if (err != cudaSuccess) return (int)err;
      configured = dynamic_limit;
    }
    cc_label_kernel<true><<<m, threads, smem, stream>>>(fg, labels, sweeps, h, w, stride, max_sweeps);
  } else {
    cc_label_kernel<false><<<m, threads, 0, stream>>>(fg, labels, sweeps, h, w, w, max_sweeps);
  }
  return (int)cudaGetLastError();
}
