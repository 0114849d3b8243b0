// Host build of the PnP kernel's per-detection math (pnp_math.cuh), for the
// CPU tests: g++ -O2 -std=c++17 -shared -fPIC -o libpnp_host.so pnp_host.cpp
// Same C interface as pnp.cu's solve_pnp, without the stream.

#include <cstddef>

#include "pnp_math.cuh"

extern "C" int solve_pnp_host(const float* pts2d, const float* pts3d, const float* kparams, float* R_out,
                              float* t_out, float* err_out, int B, int N, int iterations) {
  if (N > cpnp::kMaxPoints) return 1;
  for (int b = 0; b < B; ++b) {
    cpnp::Problem P;
    P.n = N;
    P.fx = kparams[0];
    P.fy = kparams[1];
    P.cx = kparams[2];
    P.cy = kparams[3];
    for (int i = 0; i < N; ++i) {
      for (int c = 0; c < 3; ++c) P.X[c][i] = pts3d[((size_t)b * N + i) * 3 + c];
      for (int c = 0; c < 2; ++c) P.U[c][i] = pts2d[((size_t)b * N + i) * 2 + c];
    }
    cpnp::solve(P, iterations, R_out + (size_t)b * 9, t_out + (size_t)b * 3, err_out + b);
  }
  return 0;
}
