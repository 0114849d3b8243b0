// Host build of the PnP kernels' warp-form math (pnp_math.cuh), for the CPU
// tests: g++ -O2 -std=c++17 -shared -fPIC -o libpnp_host.so pnp_host.cpp
// Same C interfaces as pnp.cu's solve_pnp and lm_refine, without the stream.
// The lanes of a warp become loops: every sum over the points runs the card's
// butterfly over virtual lanes (cpnp::lane_sums), so the host adds in the
// card's order, and the two candidates run one after the other.

#include <cstddef>

#include "pnp_math.cuh"

static void load_problem(const float* pts2d, const float* pts3d, const float* K, int b, int N, cpnp::Problem& P) {
  P.n = N;
  P.fx = K[0];
  P.fy = K[4];
  P.cx = K[2];
  P.cy = K[5];
  for (int i = 0; i < N; ++i) {
    for (int c = 0; c < 3; ++c) P.X[c][i] = pts3d[((size_t)b * N + i) * 3 + c];
    for (int c = 0; c < 2; ++c) P.U[c][i] = pts2d[((size_t)b * N + i) * 2 + c];
  }
}

extern "C" int solve_pnp_host(const float* pts2d, const float* pts3d, const float* K, float* R_out, float* t_out,
                              float* err_out, int B, int N, int iterations) {
  if (N > cpnp::kMaxPoints) return 1;
  for (int b = 0; b < B; ++b) {
    cpnp::Problem P;
    load_problem(pts2d, pts3d, K, b, N, P);
    cpnp::solve(P, iterations, R_out + (size_t)b * 9, t_out + (size_t)b * 3, err_out + b);
  }
  return 0;
}

extern "C" int lm_refine_host(const float* R0, const float* t0, const float* pts2d, const float* pts3d,
                              const float* K, float* R_out, float* t_out, float* err_out, int B, int N,
                              int iterations) {
  if (N > cpnp::kMaxPoints) return 1;
  for (int b = 0; b < B; ++b) {
    cpnp::Problem P;
    load_problem(pts2d, pts3d, K, b, N, P);
    float* R = R_out + (size_t)b * 9;
    float* t = t_out + (size_t)b * 3;
    for (int i = 0; i < 9; ++i) R[i] = R0[(size_t)b * 9 + i];
    for (int i = 0; i < 3; ++i) t[i] = t0[(size_t)b * 3 + i];
    err_out[b] = cpnp::lm_refine(P, iterations, R, t);
  }
  return 0;
}
