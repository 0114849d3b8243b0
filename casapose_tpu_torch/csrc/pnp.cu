// Full PnP solve (EPnP init + LM refine), and LM refinement alone, for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/pnp_kernel.py::solve_pnp_pallas
// (_full_pnp_kernel) and ::lm_refine_pallas (_lm_kernel). The math is in
// pnp_math.cuh, shared with the host build that the CPU tests run.
//
// lm_refine is the LM stage of the solve from a given (R0, t0): per
// detection 9 + 3 floats and N points in, 13 floats out, and `iterations`
// dependent LM steps of ~168 N + 230 flops each. It is bound the same way as
// the solve below: by the latency of one thread's serial chain.
//
// What bounds it on this card: neither bytes nor operations. A detection is
// 9 points in and 13 floats out, and its solve is some 10^5 dependent
// flops (12x12 Cholesky, 12 triangular solves, 60 power steps, 20 LM
// iterations), so the whole batch (8 to 256 detections) is far below both
// the memory and the f32 roofline; the time is the latency of one thread's
// serial chain plus the launch.
//
// Design: one thread per detection, a grid of ceil(B / 128) blocks. The TPU
// kernel spread the batch over vector lanes and kept a 3x3 grid of [B]
// vectors; here each thread holds its own problem. The 12x12 matrices and
// the per-point arrays are indexed by loop counters, so they live in local
// memory (cached in L1), which keeps the register count bounded; ptxas -v
// reports the spill and stack bytes. One launch replaces the thousands of
// small launches an eager version would make.

#include <cuda_runtime.h>

#include "pnp_math.cuh"

namespace {

constexpr int kThreads = 128;

__device__ void load_problem(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                             const float* __restrict__ kparams, int b, int N, cpnp::Problem& P) {
  P.n = N;
  P.fx = kparams[0];
  P.fy = kparams[1];
  P.cx = kparams[2];
  P.cy = kparams[3];
  for (int i = 0; i < N; ++i) {
    for (int c = 0; c < 3; ++c) P.X[c][i] = pts3d[((size_t)b * N + i) * 3 + c];
    for (int c = 0; c < 2; ++c) P.U[c][i] = pts2d[((size_t)b * N + i) * 2 + c];
  }
}

__global__ void solve_pnp_kernel(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                                 const float* __restrict__ kparams, float* __restrict__ R_out,
                                 float* __restrict__ t_out, float* __restrict__ err_out, int B, int N,
                                 int iterations) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  cpnp::Problem P;
  load_problem(pts2d, pts3d, kparams, b, N, P);
  float R[9], t[3], err;
  cpnp::solve(P, iterations, R, t, &err);
  for (int i = 0; i < 9; ++i) R_out[(size_t)b * 9 + i] = R[i];
  for (int i = 0; i < 3; ++i) t_out[(size_t)b * 3 + i] = t[i];
  err_out[b] = err;
}

__global__ void lm_refine_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                                 const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                                 const float* __restrict__ kparams, float* __restrict__ R_out,
                                 float* __restrict__ t_out, float* __restrict__ err_out, int B, int N,
                                 int iterations) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  cpnp::Problem P;
  load_problem(pts2d, pts3d, kparams, b, N, P);
  float R[9], t[3];
  for (int i = 0; i < 9; ++i) R[i] = R0[(size_t)b * 9 + i];
  for (int i = 0; i < 3; ++i) t[i] = t0[(size_t)b * 3 + i];
  const float err = cpnp::lm_refine(P, iterations, R, t);
  for (int i = 0; i < 9; ++i) R_out[(size_t)b * 9 + i] = R[i];
  for (int i = 0; i < 3; ++i) t_out[(size_t)b * 3 + i] = t[i];
  err_out[b] = err;
}

}  // namespace

// pts2d: [B, N, 2] (x, y) f32; pts3d: [B, N, 3] f32; kparams: [fx, fy, cx, cy] f32;
// R: [B, 3, 3]; t: [B, 3]; err: [B]. N <= 32. Returns cudaGetLastError().
extern "C" int solve_pnp(const float* pts2d, const float* pts3d, const float* kparams, float* R, float* t,
                         float* err, int B, int N, int iterations, cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  solve_pnp_kernel<<<blocks, kThreads, 0, stream>>>(pts2d, pts3d, kparams, R, t, err, B, N, iterations);
  return (int)cudaGetLastError();
}

// R0: [B, 3, 3] f32; t0: [B, 3] f32; pts2d, pts3d, kparams, R, t, err as solve_pnp. N <= 32.
// Returns cudaGetLastError().
extern "C" int lm_refine(const float* R0, const float* t0, const float* pts2d, const float* pts3d,
                         const float* kparams, float* R, float* t, float* err, int B, int N, int iterations,
                         cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  lm_refine_kernel<<<blocks, kThreads, 0, stream>>>(R0, t0, pts2d, pts3d, kparams, R, t, err, B, N, iterations);
  return (int)cudaGetLastError();
}
