// Full PnP solve (EPnP init + LM refine), and LM refinement alone, for Hopper (sm_90a).
//
// Replaces: casapose_tpu/ops/pnp_kernel.py::solve_pnp_pallas
// (_full_pnp_kernel) and ::lm_refine_pallas (_lm_kernel). The math is in
// pnp_math.cuh, shared with the host build that the CPU tests run.
//
// What bounds it on this card: neither bytes nor operations. A detection is
// 9 points in and 13 floats out, and its solve is ~46,000 mostly dependent
// flops (12x12 Cholesky, 12 triangular solves, 60 power steps, 20 LM
// iterations), so the whole batch (8 to 256 detections) is far below both
// the memory and the f32 roofline; the time is the latency of the longest
// serial chain plus the launch.
//
// Design: one warp per detection, one warp a block (so B = 256 spreads over
// all 132 SMs, ~2 warps each, and B = 8 over 8 SMs). The warp shortens the
// chain that one thread per detection ran:
//   * the two EPnP candidates' pose fits and 10-step LM chains run at once,
//     one per half-warp (LM is 76% of a solve's operations);
//   * per-point work (residuals, Jacobian rows and their 28 products,
//     barycentrics, the 40 M^T M terms, camera points) is one point a lane,
//     and every sum over the points is a butterfly of warp shuffles
//     (pnp_math.cuh: lane_sums), in a fixed order;
//   * the rest (12x12 Cholesky factor, inverse iteration, Ritz step, Horn
//     power steps, the 6x6 LM solve and exp map) runs on every lane of the
//     group at once, in registers: no shared memory, no broadcast, no
//     per-thread local arrays (ptxas -v reports registers and any spills);
//   * the triangular solves multiply by the reciprocals of the factor's
//     diagonal, so each step of their serial chains is an FMA and a multiply
//     instead of an IEEE division.
// Only the detection's points are staged in shared memory (a 0.7 KB
// Problem). A run repeats bit for bit.
//
// lm_refine runs the same LM (cpnp::lm_refine), one detection per
// half-warp, two a block.

#include <cuda_runtime.h>

#include "pnp_math.cuh"

namespace {

// Points of detection b into P, one point a lane of the group of `width` lanes that `lane` belongs to;
// K: [3, 3] row-major intrinsics.
__device__ void load_problem(int lane, int width, const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                             const float* __restrict__ K, int b, int N, cpnp::Problem& P) {
  for (int i = lane; i < N; i += width) {
#pragma unroll
    for (int k = 0; k < 3; ++k) P.X[k][i] = pts3d[((size_t)b * N + i) * 3 + k];
#pragma unroll
    for (int k = 0; k < 2; ++k) P.U[k][i] = pts2d[((size_t)b * N + i) * 2 + k];
  }
  if (lane == 0) {
    P.n = N;
    P.fx = K[0];
    P.fy = K[4];
    P.cx = K[2];
    P.cy = K[5];
  }
}

__global__ void __launch_bounds__(32) solve_pnp_kernel(const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                                                       const float* __restrict__ K, float* __restrict__ R_out,
                                                       float* __restrict__ t_out, float* __restrict__ err_out, int N,
                                                       int iterations) {
  __shared__ cpnp::Problem P;
  const int b = blockIdx.x;
  load_problem(threadIdx.x, 32, pts2d, pts3d, K, b, N, P);
  __syncwarp();
  cpnp::solve(P, iterations, R_out + (size_t)b * 9, t_out + (size_t)b * 3, err_out + b);
}

__global__ void __launch_bounds__(32) lm_refine_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                                                       const float* __restrict__ pts2d, const float* __restrict__ pts3d,
                                                       const float* __restrict__ K, float* __restrict__ R_out,
                                                       float* __restrict__ t_out, float* __restrict__ err_out, int B,
                                                       int N, int iterations) {
  __shared__ cpnp::Problem problems[2];
  const int h = threadIdx.x >> 4, lane = threadIdx.x & 15;
  const int want = 2 * blockIdx.x + h;
  const int b = want < B ? want : B - 1;  // a spare half refines a copy and writes nothing
  cpnp::Problem& P = problems[h];
  load_problem(lane, 16, pts2d, pts3d, K, b, N, P);
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = R0[(size_t)b * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = t0[(size_t)b * 3 + i];
  __syncwarp();
  const float err = cpnp::lm_refine(P, iterations, R, t);
  if (lane == 0 && want < B) {
    for (int i = 0; i < 9; ++i) R_out[(size_t)b * 9 + i] = R[i];
    for (int i = 0; i < 3; ++i) t_out[(size_t)b * 3 + i] = t[i];
    err_out[b] = err;
  }
}

}  // namespace

// pts2d: [B, N, 2] (x, y) f32; pts3d: [B, N, 3] f32; K: [3, 3] f32 (fx = K[0], fy = K[4], cx = K[2], cy = K[5]);
// R: [B, 3, 3]; t: [B, 3]; err: [B]. N <= 32. Returns cudaGetLastError().
extern "C" int solve_pnp(const float* pts2d, const float* pts3d, const float* K, float* R, float* t, float* err,
                         int B, int N, int iterations, cudaStream_t stream) {
  solve_pnp_kernel<<<B, 32, 0, stream>>>(pts2d, pts3d, K, R, t, err, N, iterations);
  return (int)cudaGetLastError();
}

// R0: [B, 3, 3] f32; t0: [B, 3] f32; pts2d, pts3d, K, R, t, err as solve_pnp. N <= 32.
// Returns cudaGetLastError().
extern "C" int lm_refine(const float* R0, const float* t0, const float* pts2d, const float* pts3d, const float* K,
                         float* R, float* t, float* err, int B, int N, int iterations, cudaStream_t stream) {
  lm_refine_kernel<<<(B + 1) / 2, 32, 0, stream>>>(R0, t0, pts2d, pts3d, K, R, t, err, B, N, iterations);
  return (int)cudaGetLastError();
}
