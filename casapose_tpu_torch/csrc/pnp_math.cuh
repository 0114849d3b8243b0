// PnP math in warp form: EPnP init + Levenberg-Marquardt refine of one
// detection, spread over the lanes of a warp. __host__ __device__, so the
// same source compiles for the card (pnp.cu) and with a host C++ compiler
// (pnp_host.cpp).
//
// Step for step this is casapose_tpu/ops/pnp_kernel.py's _full_pnp_kernel
// (_epnp_candidates_grid, _lm_body, _chol_solve6, _exp_so3_grid, winner
// pick) and casapose_tpu_torch/ops/pnp_kernel.py::solve_pnp_plain, with each
// [B, 1] entry of the TPU grid form become one float.
//
// Lanes. Every sum over the points is taken by lane_sums<W>: lane l of a
// group of W lanes adds the terms of points l, l + W, ... and a butterfly of
// __shfl_xor_sync (offsets W/2 .. 1) adds the lanes, so every lane ends with
// the sum. On the host, lane_sums loops over the W virtual lanes and runs
// the same butterfly, so the host build adds in the card's order. Everything
// else is computed by every lane of the group at once, from values that all
// its lanes hold (no shared memory, no broadcast): the 12x12 Cholesky
// factor, the inverse-iteration solves, the Horn power steps, the 6x6 LM
// solve. EPnP runs on the whole warp (W = 32); the two candidates' pose fits
// and LM chains run at once on its two halves (W = 16); on the host they run
// one after the other. The triangular solves multiply by the reciprocals of
// the factor's diagonal, which cuts a division out of each step of their
// serial chains.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CP_HD __host__ __device__ __forceinline__
#else
#define CP_HD inline
#endif

namespace cpnp {

constexpr int kMaxPoints = 32;
constexpr int kWarp = 32;
constexpr int kHalf = 16;

struct Problem {
  int n;
  float X[3][kMaxPoints];  // model points by coordinate
  float U[2][kMaxPoints];  // pixel targets (x, y)
  float fx, fy, cx, cy;
};

// NaN propagates through every helper, as through jnp.maximum / jnp.minimum / jnp.sign.
CP_HD float nan_max(float a, float b) { return (a != a || b != b) ? (a + b) : (a > b ? a : b); }
CP_HD float nan_min(float a, float b) { return (a != a || b != b) ? (a + b) : (a < b ? a : b); }
CP_HD float clamp_min(float x, float lo) { return x < lo ? lo : x; }
CP_HD bool finite_(float x) { return isfinite(x); }

// out[s] = sum over points i < n of f(i)[s], s < NS, in the order of W lanes and their butterfly.
template <int W, int NS, class F>
CP_HD void lane_sums(int n, const F& f, float* out) {
  float t[NS];
#ifdef __CUDA_ARCH__
  const int l = threadIdx.x & (W - 1);
  float v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = 0.0f;
  for (int i = l; i < n; i += W) {
    f(i, t);
#pragma unroll
    for (int s = 0; s < NS; ++s) v[s] += t[s];
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
    for (int s = 0; s < NS; ++s) v[s] += __shfl_xor_sync(0xffffffffu, v[s], off, W);
#pragma unroll
  for (int s = 0; s < NS; ++s) out[s] = v[s];
#else
  float v[W][NS], nv[W][NS];
  for (int l = 0; l < W; ++l) {
    for (int s = 0; s < NS; ++s) v[l][s] = 0.0f;
    for (int i = l; i < n; i += W) {
      f(i, t);
      for (int s = 0; s < NS; ++s) v[l][s] += t[s];
    }
  }
  for (int off = W / 2; off > 0; off >>= 1) {
    for (int l = 0; l < W; ++l)
      for (int s = 0; s < NS; ++s) nv[l][s] = v[l][s] + v[l ^ off][s];
    for (int l = 0; l < W; ++l)
      for (int s = 0; s < NS; ++s) v[l][s] = nv[l][s];
  }
  for (int s = 0; s < NS; ++s) out[s] = v[0][s];
#endif
}

// Packed lower triangle: entry (i, j), j <= i.
CP_HD constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Cholesky factor of the N x N matrix a(i, j) (lower part used) into packed L, with inv[i] = 1 / L(i, i);
// diagonal floored at 1e-30 before the sqrt.
template <int N, class A>
CP_HD void chol_factor(const A& a, float* L, float* inv) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[tri(i, k)] * L[tri(j, k)];
      if (i == j) {
        L[tri(i, i)] = sqrtf(clamp_min(s, 1e-30f));
        inv[i] = 1.0f / L[tri(i, i)];
      } else {
        L[tri(i, j)] = s * inv[j];
      }
    }
}

// Solve L L^T x = b with the packed factor and its diagonal's reciprocals.
template <int N>
CP_HD void chol_solve(const float* L, const float* inv, const float* b, float* x) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - L[tri(k, i)] * x[k];
    x[i] = s * inv[i];
  }
}

template <int N>
CP_HD float dot(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = s + a[i] * b[i];
  return s;
}

// Rodrigues exp map: I + a K + b (w w^T - |w|^2 I).
CP_HD void exp_so3(float wx, float wy, float wz, float* out) {
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(clamp_min(theta2, 1e-30f));
  const bool small = theta2 < 1e-12f;
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / clamp_min(theta2, 1e-30f);
  const float w[3] = {wx, wy, wz};
  const float K[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = (i == j ? 1.0f : 0.0f) + a * K[i * 3 + j] + b * (w[i] * w[j] - (i == j ? theta2 : 0.0f));
}

// Reprojection of point i under (R, t): camera point xc, guarded depth z, pixel residuals (u, v).
CP_HD void point_residual(const Problem& P, const float* R, const float* t, int i, float* xc, float& z, float& u,
                          float& v) {
#pragma unroll
  for (int r = 0; r < 3; ++r) xc[r] = R[r * 3 + 0] * P.X[0][i] + R[r * 3 + 1] * P.X[1][i] + R[r * 3 + 2] * P.X[2][i] + t[r];
  z = fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2];
  u = P.fx * xc[0] / z + P.cx - P.U[0][i];
  v = P.fy * xc[1] / z + P.cy - P.U[1][i];
}

// A point's terms of the LM sums: J^T J (upper, row by row: 21), J^T r (6), |r|^2.
struct LmTerms {
  const Problem& P;
  const float* R;
  const float* t;
  CP_HD void operator()(int i, float* o) const {
    float xc[3], z, u, v;
    point_residual(P, R, t, i, xc, z, u, v);
    const float iz = 1.0f / z;
    const float du0 = P.fx * iz;
    const float du2 = -P.fx * xc[0] * iz * iz;
    const float dv1 = P.fy * iz;
    const float dv2 = -P.fy * xc[1] * iz * iz;
    const float px = xc[0] - t[0];
    const float py = xc[1] - t[1];
    const float pz = xc[2] - t[2];
    const float Ju[6] = {du2 * py, du0 * pz - du2 * px, -du0 * py, du0, 0.0f, du2};
    const float Jv[6] = {-dv1 * pz + dv2 * py, -dv2 * px, dv1 * px, 0.0f, dv1, dv2};
    int s = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = a; b < 6; ++b) o[s++] = Ju[a] * Ju[b] + Jv[a] * Jv[b];
#pragma unroll
    for (int a = 0; a < 6; ++a) o[21 + a] = Ju[a] * u + Jv[a] * v;
    o[27] = u * u + v * v;
  }
};

struct ErrTerm {
  const Problem& P;
  const float* R;
  const float* t;
  CP_HD void operator()(int i, float* o) const {
    float xc[3], z, u, v;
    point_residual(P, R, t, i, xc, z, u, v);
    o[0] = u * u + v * v;
  }
};

struct HessAt {
  const float* H;
  CP_HD float operator()(int i, int j) const { return H[i * 6 + j]; }
};

// One LM iteration on (R, t, lam) by the W lanes of a group; returns min(err at the start, err of the trial step).
template <int W>
CP_HD float lm_body(const Problem& P, float* R, float* t, float& lam) {
  float S[28];
  lane_sums<W, 28>(P.n, LmTerms{P, R, t}, S);
  const float err = S[27];
  float H[36], g[6];
  int s = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) H[i * 6 + j] = H[j * 6 + i] = S[s++];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = S[21 + i];
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i * 6 + i] = H[i * 6 + i] + lam * (1.0f + H[i * 6 + i]);
  float L[21], inv[6], delta[6];
  chol_factor<6>(HessAt{H}, L, inv);
  chol_solve<6>(L, inv, g, delta);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = finite_(delta[i]) ? delta[i] : 0.0f;
  float dR[9], R_new[9], t_new[3];
  exp_so3(-delta[0], -delta[1], -delta[2], dR);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R_new[i * 3 + j] = dR[i * 3 + 0] * R[0 * 3 + j] + dR[i * 3 + 1] * R[1 * 3 + j] + dR[i * 3 + 2] * R[2 * 3 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i) t_new[i] = t[i] - delta[3 + i];
  float err_new;
  lane_sums<W, 1>(P.n, ErrTerm{P, R_new, t_new}, &err_new);
  const bool accept = finite_(err_new) && (err_new < err);
  if (accept) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = R_new[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = t_new[i];
    lam = clamp_min(lam / 3.0f, 1e-12f);
  } else {
    const float l5 = lam * 5.0f;
    lam = l5 > 1e6f ? 1e6f : l5;
  }
  return nan_min(err, err_new);
}

// LM refinement alone from (R, t), in place, on a half-warp: lambda starts at 1e-4 and err at 0, as
// casapose_tpu/ops/pnp_kernel.py's _lm_kernel; returns err of the last iteration.
CP_HD float lm_refine(const Problem& P, int iterations, float* R, float* t) {
  float lam = 1e-4f, err = 0.0f;
  for (int it = 0; it < iterations; ++it) err = lm_body<kHalf>(P, R, t, lam);
  return err;
}

// Normalisation of the model points: means c0 and the floored standard deviations s per coordinate.
struct CoordTerms {
  const Problem& P;
  CP_HD void operator()(int i, float* o) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = P.X[k][i];
  }
};
struct SpreadTerms {
  const Problem& P;
  const float* c0;
  CP_HD void operator()(int i, float* o) const {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = P.X[k][i] - c0[k];
      o[k] = d * d;
    }
  }
};

// Barycentric coordinates of point i with respect to the control points c0, c0 + s_k e_k.
CP_HD void barycentric(const Problem& P, const float* c0, const float* s, int i, float* alpha) {
#pragma unroll
  for (int k = 0; k < 3; ++k) alpha[1 + k] = (P.X[k][i] - c0[k]) / s[k];
  alpha[0] = 1.0f - alpha[1] - alpha[2] - alpha[3];
}

// A point's terms of M^T M's closed-form sums: for the 10 pairs a <= b, ab * [1, u, v, u^2 + v^2].
struct MTerms {
  const Problem& P;
  const float* c0;
  const float* s;
  CP_HD void operator()(int i, float* o) const {
    float alpha[4];
    barycentric(P, c0, s, i, alpha);
    const float u = (P.U[0][i] - P.cx) / P.fx;
    const float v = (P.U[1][i] - P.cy) / P.fy;
    int e = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = a; b < 4; ++b) {
        const float ab = alpha[a] * alpha[b];
        o[e++] = ab;
        o[e++] = ab * u;
        o[e++] = ab * v;
        o[e++] = ab * (u * u + v * v);
      }
  }
};

// Entry (r, c) of the 12x12 M^T M from the 40 sums (4 per pair a <= b: S, SU, SV, SQ).
CP_HD float m_entry(const float* S40, int r, int c) {
  const int a = r / 3, ra = r % 3, b = c / 3, rb = c % 3;
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  const float* S = S40 + 4 * (lo * 4 - (lo * (lo - 1)) / 2 + (hi - lo));
  if (ra == rb && ra < 2) return S[0];
  if ((ra == 0 && rb == 2) || (ra == 2 && rb == 0)) return -S[1];
  if ((ra == 1 && rb == 2) || (ra == 2 && rb == 1)) return -S[2];
  if (ra == 2 && rb == 2) return S[3];
  return 0.0f;
}

struct RidgedM {
  const float* S40;
  float ridge;
  CP_HD float operator()(int i, int j) const { return i == j ? m_entry(S40, i, i) + ridge : m_entry(S40, i, j); }
};

CP_HD void m_matvec(const float* S40, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) s = s + m_entry(S40, i, j) * v[j];
    out[i] = s;
  }
}

// The camera points of point i for scaled control points chat, times flip.
CP_HD void camera_point(const Problem& P, const float* c0, const float* s, const float* chat, float flip, int i,
                        float* pc) {
  float alpha[4];
  barycentric(P, c0, s, i, alpha);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) acc = acc + alpha[a] * chat[3 * a + k];
    pc[k] = acc * flip;
  }
}

struct DepthTerm {
  const Problem& P;
  const float* c0;
  const float* s;
  const float* chat;
  CP_HD void operator()(int i, float* o) const {
    float pc[3];
    camera_point(P, c0, s, chat, 1.0f, i, pc);
    o[0] = pc[2];
  }
};
struct CentroidTerms {
  const Problem& P;
  const float* c0;
  const float* s;
  const float* chat;
  float flip;
  CP_HD void operator()(int i, float* o) const {
    float pc[3];
    camera_point(P, c0, s, chat, flip, i, pc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = P.X[k][i];
      o[3 + k] = pc[k];
    }
  }
};
struct CrossTerms {
  const Problem& P;
  const float* c0;
  const float* s;
  const float* chat;
  float flip;
  const float* xb;
  const float* pb;
  CP_HD void operator()(int i, float* o) const {
    float pc[3];
    camera_point(P, c0, s, chat, flip, i, pc);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) o[3 * a + b] = (P.X[a][i] - xb[a]) * (pc[b] - pb[b]);
  }
};

// Control points in the camera frame vk (12) -> pose (R, t) by pairwise scale fit and Horn's quaternion
// Procrustes, on a group of W lanes.
template <int W>
CP_HD void pose_from_null(const Problem& P, const float* c0, const float* s, const float* vk, float* R, float* t) {
  float ctrl_w[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k) ctrl_w[a][k] = c0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) ctrl_w[1 + k][k] = c0[k] + s[k];
  float num = 0.0f, den = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      float dc[3], dw[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dc[k] = vk[3 * a + k] - vk[3 * b + k];
        dw[k] = ctrl_w[a][k] - ctrl_w[b][k];
      }
      const float ndc = sqrtf(clamp_min(dot<3>(dc, dc), 1e-30f));
      const float ndw = sqrtf(clamp_min(dot<3>(dw, dw), 1e-30f));
      num = num + ndc * ndw;
      den = den + ndc * ndc;
    }
  const float beta = num / clamp_min(den, 1e-30f);
  float chat[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) chat[i] = vk[i] * beta;
  const float fn = (float)P.n;
  float mean_z;
  lane_sums<W, 1>(P.n, DepthTerm{P, c0, s, chat}, &mean_z);
  const float flip = (mean_z / fn) < 0.0f ? -1.0f : 1.0f;
  float cent[6], xb[3], pb[3];
  lane_sums<W, 6>(P.n, CentroidTerms{P, c0, s, chat, flip}, cent);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xb[k] = cent[k] / fn;
    pb[k] = cent[3 + k] / fn;
  }
  float S3[9];
  lane_sums<W, 9>(P.n, CrossTerms{P, c0, s, chat, flip, xb, pb}, S3);
  const float Sxx = S3[0], Sxy = S3[1], Sxz = S3[2];
  const float Syx = S3[3], Syy = S3[4], Syz = S3[5];
  const float Szx = S3[6], Szy = S3[7], Szz = S3[8];
  float Ns[16] = {Sxx + Syy + Szz, Syz - Szy,        Szx - Sxz,         Sxy - Syx,
                  Syz - Szy,       Sxx - Syy - Szz,  Sxy + Syx,         Szx + Sxz,
                  Szx - Sxz,       Sxy + Syx,        -Sxx + Syy - Szz,  Syz + Szy,
                  Sxy - Syx,       Szx + Sxz,        Syz + Szy,         -Sxx - Syy + Szz};
  float shift = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float row = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) row = row + fabsf(Ns[i * 4 + j]);
    shift = (i == 0) ? row : nan_max(shift, row);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) Ns[i * 4 + i] = Ns[i * 4 + i] + shift;
  float q[4] = {0.5f, 0.5f, 0.5f, 0.5f}, q2[4];
  for (int it = 0; it < 30; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q2[i] = dot<4>(Ns + 4 * i, q);
    const float nq = sqrtf(clamp_min(dot<4>(q2, q2), 1e-30f));
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q2[i] / nq;
  }
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  R[0] = 1 - 2 * (qy * qy + qz * qz);
  R[1] = 2 * (qx * qy - qz * qw);
  R[2] = 2 * (qx * qz + qy * qw);
  R[3] = 2 * (qx * qy + qz * qw);
  R[4] = 1 - 2 * (qx * qx + qz * qz);
  R[5] = 2 * (qy * qz - qx * qw);
  R[6] = 2 * (qx * qz - qy * qw);
  R[7] = 2 * (qy * qz + qx * qw);
  R[8] = 1 - 2 * (qx * qx + qy * qy);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = pb[i] - (R[i * 3 + 0] * xb[0] + R[i * 3 + 1] * xb[1] + R[i * 3 + 2] * xb[2]);
}

// EPnP on the warp: the control-point normalisation (c0, s) and the beta-1 and beta-2 null vectors vk[0], vk[1]
// in normalised camera coordinates.
CP_HD void epnp_null_vectors(const Problem& P, float* c0, float* s, float (*vk)[12]) {
  const int n = P.n;
  const float fn = (float)n;
  float sums[3], std_[3];
  lane_sums<kWarp, 3>(n, CoordTerms{P}, sums);
#pragma unroll
  for (int k = 0; k < 3; ++k) c0[k] = sums[k] / fn;
  lane_sums<kWarp, 3>(n, SpreadTerms{P, c0}, sums);
#pragma unroll
  for (int k = 0; k < 3; ++k) std_[k] = sqrtf(clamp_min(sums[k] / fn, 1e-30f));
  const float mx = nan_max(nan_max(std_[0], std_[1]), std_[2]);
  const float floor_ = 1e-3f * clamp_min(mx, 1e-9f);
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = nan_max(std_[k], floor_);

  // M^T M from closed-form reductions.
  float S40[40];
  lane_sums<kWarp, 40>(n, MTerms{P, c0, s}, S40);

  // Two smallest eigenvectors: Cholesky inverse subspace iteration.
  float trace = 0.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i) trace = trace + m_entry(S40, i, i);
  const float ridge = 1e-6f * trace + 1e-30f;
  float L[78], inv[12];
  chol_factor<12>(RidgedM{S40, ridge}, L, inv);
  float w1[12], w2[12], tmp[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    w1[i] = (float)(1.0 + 0.1 * i);
    w2[i] = (float)(2.0 - 0.2 * i);
  }
  for (int it = 0; it < 6; ++it) {
    chol_solve<12>(L, inv, w1, tmp);
#pragma unroll
    for (int i = 0; i < 12; ++i) w1[i] = tmp[i];
    chol_solve<12>(L, inv, w2, tmp);
#pragma unroll
    for (int i = 0; i < 12; ++i) w2[i] = tmp[i];
    const float n1 = sqrtf(clamp_min(dot<12>(w1, w1), 1e-30f));
#pragma unroll
    for (int i = 0; i < 12; ++i) w1[i] = w1[i] / n1;
    const float d = dot<12>(w1, w2);
#pragma unroll
    for (int i = 0; i < 12; ++i) w2[i] = w2[i] - d * w1[i];
    const float n2 = sqrtf(clamp_min(dot<12>(w2, w2), 1e-30f));
#pragma unroll
    for (int i = 0; i < 12; ++i) w2[i] = w2[i] / n2;
  }
  // Rayleigh-Ritz rotation by half-angle identities.
  m_matvec(S40, w1, tmp);
  const float T11 = dot<12>(w1, tmp);
  m_matvec(S40, w2, tmp);
  const float T22 = dot<12>(w2, tmp);
  const float T12 = dot<12>(w1, tmp);
  const float aa = T11 - T22;
  const float bb = 2.0f * T12;
  const float rr = sqrtf(clamp_min(aa * aa + bb * bb, 1e-30f));
  const float cos2 = aa / rr;
  float cth = sqrtf(clamp_min((1.0f + cos2) * 0.5f, 0.0f));
  // sign(bb) with sign(0) = +1: where T12 is exactly 0 and T11 < T22 the TPU kernel's
  // jnp.sign(0) = 0 zeroes both Ritz vectors; +1 swaps w1 and w2 as the limit bb -> 0+ does.
  float sth = (bb < 0.0f ? -1.0f : 1.0f) * sqrtf(clamp_min((1.0f - cos2) * 0.5f, 0.0f));
  if ((aa * aa + bb * bb) < 1e-28f) {
    cth = 1.0f;
    sth = 0.0f;
  }
  float r1[12], r2[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    r1[i] = cth * w1[i] + sth * w2[i];
    r2[i] = -sth * w1[i] + cth * w2[i];
  }
  m_matvec(S40, r1, tmp);
  const float e1 = dot<12>(r1, tmp);
  m_matvec(S40, r2, tmp);
  const float e2 = dot<12>(r2, tmp);
  const bool fs = e1 <= e2;
  float v_min[12], v_2nd[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    v_min[i] = fs ? r1[i] : r2[i];
    v_2nd[i] = fs ? r2[i] : r1[i];
  }

  // World control points: ctrl[0] = c0, ctrl[1+k] = c0 + s_k e_k.
  float ctrl_w[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k) ctrl_w[a][k] = c0[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) ctrl_w[1 + k][k] = c0[k] + s[k];

  // Beta case N=2: 3-unknown normal equations over the 6 control-point pairs.
  float A00 = 0.0f, A01 = 0.0f, A02 = 0.0f, A11 = 0.0f, A12 = 0.0f, A22 = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a + 1; b < 4; ++b) {
      float d1c[3], d2c[3], dwc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d1c[k] = v_min[3 * a + k] - v_min[3 * b + k];
        d2c[k] = v_2nd[3 * a + k] - v_2nd[3 * b + k];
        dwc[k] = ctrl_w[a][k] - ctrl_w[b][k];
      }
      const float r0 = dot<3>(d1c, d1c);
      const float r1_ = 2.0f * dot<3>(d1c, d2c);
      const float r2_ = dot<3>(d2c, d2c);
      const float rhs = dot<3>(dwc, dwc);
      A00 = A00 + r0 * r0;
      A01 = A01 + r0 * r1_;
      A02 = A02 + r0 * r2_;
      A11 = A11 + r1_ * r1_;
      A12 = A12 + r1_ * r2_;
      A22 = A22 + r2_ * r2_;
      g0 = g0 + r0 * rhs;
      g1 = g1 + r1_ * rhs;
      g2 = g2 + r2_ * rhs;
    }
  const float trA = A00 + A11 + A22;
  A00 = A00 + 1e-8f * trA;
  A11 = A11 + 1e-8f * trA;
  A22 = A22 + 1e-8f * trA;
  const float c00 = A11 * A22 - A12 * A12;
  const float c01 = A02 * A12 - A01 * A22;
  const float c02 = A01 * A12 - A02 * A11;
  const float c11 = A00 * A22 - A02 * A02;
  const float c12 = A01 * A02 - A00 * A12;
  const float c22 = A00 * A11 - A01 * A01;
  float det = A00 * c00 + A01 * c01 + A02 * c02;
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  const float b11 = (c00 * g0 + c01 * g1 + c02 * g2) / det;
  const float b12 = (c01 * g0 + c11 * g1 + c12 * g2) / det;
  const float b22 = (c02 * g0 + c12 * g1 + c22 * g2) / det;
  const float bb1 = sqrtf(clamp_min(b11, 1e-12f));
  const float bb2m = sqrtf(clamp_min(b22, 1e-12f));
  const float bb2 = b12 < 0.0f ? -bb2m : bb2m;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    vk[0][i] = v_min[i];
    vk[1][i] = bb1 * v_min[i] + bb2 * v_2nd[i];
  }
}

// Full solve on a warp: EPnP on the whole warp, then the two candidates' pose fits and LM chains at once on
// its two halves; the lower error wins. Lane 0 writes R, t, err. On the host the halves run in turn.
CP_HD void solve(const Problem& P, int iterations, float* R_out, float* t_out, float* err_out) {
  float c0[3], s[3], vk[2][12];
  epnp_null_vectors(P, c0, s, vk);
#ifdef __CUDA_ARCH__
  const bool second = (threadIdx.x & 16) != 0;
  float v[12], R[9], t[3];
#pragma unroll
  for (int i = 0; i < 12; ++i) v[i] = second ? vk[1][i] : vk[0][i];
  pose_from_null<kHalf>(P, c0, s, v, R, t);
  const float err = lm_refine(P, iterations, R, t);
  // Lane 0 holds candidate a (beta-1), lane 16 candidate b (beta-2).
  const float err_b = __shfl_sync(0xffffffffu, err, 16);
  float Rb[9], tb[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rb[i] = __shfl_sync(0xffffffffu, R[i], 16);
#pragma unroll
  for (int i = 0; i < 3; ++i) tb[i] = __shfl_sync(0xffffffffu, t[i], 16);
  if (threadIdx.x == 0) {
    const bool use_a = err <= err_b;
    for (int i = 0; i < 9; ++i) R_out[i] = use_a ? R[i] : Rb[i];
    for (int i = 0; i < 3; ++i) t_out[i] = use_a ? t[i] : tb[i];
    *err_out = nan_min(err, err_b);
  }
#else
  float Ra[9], ta[3], Rb[9], tb[3];
  pose_from_null<kHalf>(P, c0, s, vk[0], Ra, ta);
  pose_from_null<kHalf>(P, c0, s, vk[1], Rb, tb);
  const float err_a = lm_refine(P, iterations, Ra, ta);
  const float err_b = lm_refine(P, iterations, Rb, tb);
  const bool use_a = err_a <= err_b;
  for (int i = 0; i < 9; ++i) R_out[i] = use_a ? Ra[i] : Rb[i];
  for (int i = 0; i < 3; ++i) t_out[i] = use_a ? ta[i] : tb[i];
  *err_out = nan_min(err_a, err_b);
#endif
}

}  // namespace cpnp
