// Per-detection PnP math: EPnP init + Levenberg-Marquardt refine, one problem
// in scalar registers / local arrays. __host__ __device__, so the same source
// compiles for the card (pnp.cu) and with a host C++ compiler.
//
// Step for step this is casapose_tpu/ops/pnp_kernel.py's _full_pnp_kernel
// (_epnp_candidates_grid, _lm_body, _chol_solve6, _exp_so3_grid, winner
// pick) and casapose_tpu_torch/ops/pnp_kernel.py::solve_pnp_plain, with each
// [B, 1] entry of the TPU grid form become one float.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define CP_HD __host__ __device__ __forceinline__
#else
#define CP_HD inline
#endif

namespace cpnp {

constexpr int kMaxPoints = 32;

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

// Cholesky factor (row-major n x n, lower part used), diagonal floored at 1e-30.
template <int N>
CP_HD void chol_factor(const float* A, float* L) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = A[i * N + j];
      for (int k = 0; k < j; ++k) s = s - L[i * N + k] * L[j * N + k];
      L[i * N + j] = (i == j) ? sqrtf(clamp_min(s, 1e-30f)) : s / L[j * N + j];
    }
}

template <int N>
CP_HD void chol_solve(const float* L, const float* b, float* x) {
  float y[N];
  for (int i = 0; i < N; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i * N + k] * y[k];
    y[i] = s / L[i * N + i];
  }
  for (int i = N - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < N; ++k) s = s - L[k * N + i] * x[k];
    x[i] = s / L[i * N + i];
  }
}

template <int N>
CP_HD float dot(const float* a, const float* b) {
  float s = 0.0f;
  for (int i = 0; i < N; ++i) s = s + a[i] * b[i];
  return s;
}

template <int N>
CP_HD void matvec(const float* A, const float* v, float* out) {
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    for (int j = 0; j < N; ++j) s = s + A[i * N + j] * v[j];
    out[i] = s;
  }
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
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[i * 3 + j] = (i == j ? 1.0f : 0.0f) + a * K[i * 3 + j] + b * (w[i] * w[j] - (i == j ? theta2 : 0.0f));
}

// Sum of squared reprojection residuals of (R, t); fills ru, rv, Xc, zs when given.
CP_HD float residuals(const Problem& P, const float* R, const float* t, float* ru, float* rv, float (*Xc)[kMaxPoints],
                      float* zs) {
  float err = 0.0f;
  for (int i = 0; i < P.n; ++i) {
    float xc[3];
    for (int r = 0; r < 3; ++r) xc[r] = R[r * 3 + 0] * P.X[0][i] + R[r * 3 + 1] * P.X[1][i] + R[r * 3 + 2] * P.X[2][i] + t[r];
    const float z = fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2];
    const float u = P.fx * xc[0] / z + P.cx - P.U[0][i];
    const float v = P.fy * xc[1] / z + P.cy - P.U[1][i];
    err = err + (u * u + v * v);
    if (ru) {
      ru[i] = u;
      rv[i] = v;
      zs[i] = z;
      for (int r = 0; r < 3; ++r) Xc[r][i] = xc[r];
    }
  }
  return err;
}

// One LM iteration on (R, t, lam); returns min(err at the start, err of the trial step).
CP_HD float lm_body(const Problem& P, float* R, float* t, float& lam) {
  float ru[kMaxPoints], rv[kMaxPoints], zs[kMaxPoints], Xc[3][kMaxPoints];
  const float err = residuals(P, R, t, ru, rv, Xc, zs);
  float H[36], g[6];
  for (int i = 0; i < 36; ++i) H[i] = 0.0f;
  for (int i = 0; i < 6; ++i) g[i] = 0.0f;
  for (int n = 0; n < P.n; ++n) {
    const float iz = 1.0f / zs[n];
    const float du0 = P.fx * iz;
    const float du2 = -P.fx * Xc[0][n] * iz * iz;
    const float dv1 = P.fy * iz;
    const float dv2 = -P.fy * Xc[1][n] * iz * iz;
    const float px = Xc[0][n] - t[0];
    const float py = Xc[1][n] - t[1];
    const float pz = Xc[2][n] - t[2];
    const float Ju[6] = {du2 * py, du0 * pz - du2 * px, -du0 * py, du0, 0.0f, du2};
    const float Jv[6] = {-dv1 * pz + dv2 * py, -dv2 * px, dv1 * px, 0.0f, dv1, dv2};
    for (int i = 0; i < 6; ++i) {
      for (int j = i; j < 6; ++j) H[i * 6 + j] += Ju[i] * Ju[j] + Jv[i] * Jv[j];
      g[i] += Ju[i] * ru[n] + Jv[i] * rv[n];
    }
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < i; ++j) H[i * 6 + j] = H[j * 6 + i];
  for (int i = 0; i < 6; ++i) H[i * 6 + i] = H[i * 6 + i] + lam * (1.0f + H[i * 6 + i]);
  float L[36], delta[6];
  chol_factor<6>(H, L);
  chol_solve<6>(L, g, delta);
  for (int i = 0; i < 6; ++i) delta[i] = finite_(delta[i]) ? delta[i] : 0.0f;
  float dR[9], R_new[9], t_new[3];
  exp_so3(-delta[0], -delta[1], -delta[2], dR);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R_new[i * 3 + j] = dR[i * 3 + 0] * R[0 * 3 + j] + dR[i * 3 + 1] * R[1 * 3 + j] + dR[i * 3 + 2] * R[2 * 3 + j];
  for (int i = 0; i < 3; ++i) t_new[i] = t[i] - delta[3 + i];
  const float err_new = residuals(P, R_new, t_new, nullptr, nullptr, nullptr, nullptr);
  const bool accept = finite_(err_new) && (err_new < err);
  if (accept) {
    for (int i = 0; i < 9; ++i) R[i] = R_new[i];
    for (int i = 0; i < 3; ++i) t[i] = t_new[i];
    lam = clamp_min(lam / 3.0f, 1e-12f);
  } else {
    const float l5 = lam * 5.0f;
    lam = l5 > 1e6f ? 1e6f : l5;
  }
  return nan_min(err, err_new);
}

// Camera control points vk (12) -> pose by pairwise scale fit and Horn's quaternion Procrustes.
CP_HD void pose_from_null(const Problem& P, const float (*alpha)[kMaxPoints], const float (*ctrl_w)[3], const float* vk,
                          float* R, float* t) {
  float num = 0.0f, den = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = a + 1; b < 4; ++b) {
      float dc[3], dw[3];
      for (int c = 0; c < 3; ++c) {
        dc[c] = vk[3 * a + c] - vk[3 * b + c];
        dw[c] = ctrl_w[a][c] - ctrl_w[b][c];
      }
      const float ndc = sqrtf(clamp_min(dot<3>(dc, dc), 1e-30f));
      const float ndw = sqrtf(clamp_min(dot<3>(dw, dw), 1e-30f));
      num = num + ndc * ndw;
      den = den + ndc * ndc;
    }
  const float beta = num / clamp_min(den, 1e-30f);
  float chat[12];
  for (int i = 0; i < 12; ++i) chat[i] = vk[i] * beta;
  const int n = P.n;
  const float fn = (float)n;
  float pc[3][kMaxPoints];
  float mean_z = 0.0f;
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) {
      float s = 0.0f;
      for (int a = 0; a < 4; ++a) s = s + alpha[a][i] * chat[3 * a + c];
      pc[c][i] = s;
    }
    mean_z += pc[2][i];
  }
  const float flip = (mean_z / fn) < 0.0f ? -1.0f : 1.0f;
  float xb[3], pb[3];
  for (int c = 0; c < 3; ++c) {
    float sx = 0.0f, sp = 0.0f;
    for (int i = 0; i < n; ++i) {
      pc[c][i] = pc[c][i] * flip;
      sx += P.X[c][i];
      sp += pc[c][i];
    }
    xb[c] = sx / fn;
    pb[c] = sp / fn;
  }
  float S3[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
      for (int p = 0; p < n; ++p) s += (P.X[i][p] - xb[i]) * (pc[j][p] - pb[j]);
      S3[i][j] = s;
    }
  const float Sxx = S3[0][0], Sxy = S3[0][1], Sxz = S3[0][2];
  const float Syx = S3[1][0], Syy = S3[1][1], Syz = S3[1][2];
  const float Szx = S3[2][0], Szy = S3[2][1], Szz = S3[2][2];
  float Ns[16] = {Sxx + Syy + Szz, Syz - Szy,        Szx - Sxz,         Sxy - Syx,
                  Syz - Szy,       Sxx - Syy - Szz,  Sxy + Syx,         Szx + Sxz,
                  Szx - Sxz,       Sxy + Syx,        -Sxx + Syy - Szz,  Syz + Szy,
                  Sxy - Syx,       Szx + Sxz,        Syz + Szy,         -Sxx - Syy + Szz};
  float shift = 0.0f;
  for (int i = 0; i < 4; ++i) {
    float row = 0.0f;
    for (int j = 0; j < 4; ++j) row = row + fabsf(Ns[i * 4 + j]);
    shift = (i == 0) ? row : nan_max(shift, row);
  }
  for (int i = 0; i < 4; ++i) Ns[i * 4 + i] = Ns[i * 4 + i] + shift;
  float q[4] = {0.5f, 0.5f, 0.5f, 0.5f}, q2[4];
  for (int it = 0; it < 30; ++it) {
    matvec<4>(Ns, q, q2);
    const float nq = sqrtf(clamp_min(dot<4>(q2, q2), 1e-30f));
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
  for (int i = 0; i < 3; ++i) t[i] = pb[i] - (R[i * 3 + 0] * xb[0] + R[i * 3 + 1] * xb[1] + R[i * 3 + 2] * xb[2]);
}

// EPnP beta-1 and beta-2 candidates in normalised camera coordinates.
CP_HD void epnp_candidates(const Problem& P, float* R1, float* t1, float* R2, float* t2) {
  const int n = P.n;
  const float fn = (float)n;
  float c0[3], s[3], std_[3];
  float alpha[4][kMaxPoints];
  for (int c = 0; c < 3; ++c) {
    float m = 0.0f;
    for (int i = 0; i < n; ++i) m += P.X[c][i];
    c0[c] = m / fn;
    float v = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float d = P.X[c][i] - c0[c];
      v += d * d;
    }
    std_[c] = sqrtf(clamp_min(v / fn, 1e-30f));
  }
  const float mx = nan_max(nan_max(std_[0], std_[1]), std_[2]);
  const float floor_ = 1e-3f * clamp_min(mx, 1e-9f);
  for (int c = 0; c < 3; ++c) s[c] = nan_max(std_[c], floor_);
  for (int i = 0; i < n; ++i) {
    for (int c = 0; c < 3; ++c) alpha[1 + c][i] = (P.X[c][i] - c0[c]) / s[c];
    alpha[0][i] = 1.0f - alpha[1][i] - alpha[2][i] - alpha[3][i];
  }

  // M^T M from closed-form reductions.
  float S[4][4], SU[4][4], SV[4][4], SQ[4][4];
  for (int a = 0; a < 4; ++a)
    for (int b = a; b < 4; ++b) {
      float s0 = 0.0f, su = 0.0f, sv = 0.0f, sq = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float u = (P.U[0][i] - P.cx) / P.fx;
        const float v = (P.U[1][i] - P.cy) / P.fy;
        const float ab = alpha[a][i] * alpha[b][i];
        s0 += ab;
        su += ab * u;
        sv += ab * v;
        sq += ab * (u * u + v * v);
      }
      S[a][b] = S[b][a] = s0;
      SU[a][b] = SU[b][a] = su;
      SV[a][b] = SV[b][a] = sv;
      SQ[a][b] = SQ[b][a] = sq;
    }
  float M[144];
  for (int i = 0; i < 144; ++i) M[i] = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) {
      M[(3 * a + 0) * 12 + 3 * b + 0] = S[a][b];
      M[(3 * a + 1) * 12 + 3 * b + 1] = S[a][b];
      M[(3 * a + 0) * 12 + 3 * b + 2] = -SU[a][b];
      M[(3 * a + 2) * 12 + 3 * b + 0] = -SU[a][b];
      M[(3 * a + 1) * 12 + 3 * b + 2] = -SV[a][b];
      M[(3 * a + 2) * 12 + 3 * b + 1] = -SV[a][b];
      M[(3 * a + 2) * 12 + 3 * b + 2] = SQ[a][b];
    }

  // Two smallest eigenvectors: Cholesky inverse subspace iteration.
  float trace = 0.0f;
  for (int i = 0; i < 12; ++i) trace = trace + M[i * 12 + i];
  const float ridge = 1e-6f * trace + 1e-30f;
  float L[144];
  {
    float Mn[144];
    for (int i = 0; i < 144; ++i) Mn[i] = M[i];
    for (int i = 0; i < 12; ++i) Mn[i * 12 + i] = M[i * 12 + i] + ridge;
    chol_factor<12>(Mn, L);
  }
  float w1[12], w2[12], tmp[12];
  for (int i = 0; i < 12; ++i) {
    w1[i] = (float)(1.0 + 0.1 * i);
    w2[i] = (float)(2.0 - 0.2 * i);
  }
  for (int it = 0; it < 6; ++it) {
    chol_solve<12>(L, w1, tmp);
    for (int i = 0; i < 12; ++i) w1[i] = tmp[i];
    chol_solve<12>(L, w2, tmp);
    for (int i = 0; i < 12; ++i) w2[i] = tmp[i];
    const float n1 = sqrtf(clamp_min(dot<12>(w1, w1), 1e-30f));
    for (int i = 0; i < 12; ++i) w1[i] = w1[i] / n1;
    const float d = dot<12>(w1, w2);
    for (int i = 0; i < 12; ++i) w2[i] = w2[i] - d * w1[i];
    const float n2 = sqrtf(clamp_min(dot<12>(w2, w2), 1e-30f));
    for (int i = 0; i < 12; ++i) w2[i] = w2[i] / n2;
  }
  // Rayleigh-Ritz rotation by half-angle identities.
  matvec<12>(M, w1, tmp);
  const float T11 = dot<12>(w1, tmp);
  matvec<12>(M, w2, tmp);
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
  for (int i = 0; i < 12; ++i) {
    r1[i] = cth * w1[i] + sth * w2[i];
    r2[i] = -sth * w1[i] + cth * w2[i];
  }
  matvec<12>(M, r1, tmp);
  const float e1 = dot<12>(r1, tmp);
  matvec<12>(M, r2, tmp);
  const float e2 = dot<12>(r2, tmp);
  const bool fs = e1 <= e2;
  float v_min[12], v_2nd[12];
  for (int i = 0; i < 12; ++i) {
    v_min[i] = fs ? r1[i] : r2[i];
    v_2nd[i] = fs ? r2[i] : r1[i];
  }

  // World control points: ctrl[0] = c0, ctrl[1+c] = c0 + s_c e_c.
  float ctrl_w[4][3];
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 3; ++c) ctrl_w[a][c] = c0[c];
  for (int c = 0; c < 3; ++c) ctrl_w[1 + c][c] = c0[c] + s[c];

  pose_from_null(P, alpha, ctrl_w, v_min, R1, t1);

  // Beta case N=2: 3-unknown normal equations over the 6 control-point pairs.
  float A00 = 0.0f, A01 = 0.0f, A02 = 0.0f, A11 = 0.0f, A12 = 0.0f, A22 = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = a + 1; b < 4; ++b) {
      float d1c[3], d2c[3], dwc[3];
      for (int c = 0; c < 3; ++c) {
        d1c[c] = v_min[3 * a + c] - v_min[3 * b + c];
        d2c[c] = v_2nd[3 * a + c] - v_2nd[3 * b + c];
        dwc[c] = ctrl_w[a][c] - ctrl_w[b][c];
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
  float vker2[12];
  for (int i = 0; i < 12; ++i) vker2[i] = bb1 * v_min[i] + bb2 * v_2nd[i];
  pose_from_null(P, alpha, ctrl_w, vker2, R2, t2);
}

// LM refinement alone from (R, t), in place: lambda starts at 1e-4 and err at 0, as
// casapose_tpu/ops/pnp_kernel.py's _lm_kernel; returns err of the last iteration.
CP_HD float lm_refine(const Problem& P, int iterations, float* R, float* t) {
  float lam = 1e-4f, err = 0.0f;
  for (int it = 0; it < iterations; ++it) err = lm_body(P, R, t, lam);
  return err;
}

// Full solve: both EPnP candidates, LM from each, the lower error wins.
CP_HD void solve(const Problem& P, int iterations, float* R, float* t, float* err) {
  float Ra[9], ta[3], Rb[9], tb[3];
  epnp_candidates(P, Ra, ta, Rb, tb);
  const float err_a = lm_refine(P, iterations, Ra, ta);
  const float err_b = lm_refine(P, iterations, Rb, tb);
  const bool use_a = err_a <= err_b;
  for (int i = 0; i < 9; ++i) R[i] = use_a ? Ra[i] : Rb[i];
  for (int i = 0; i < 3; ++i) t[i] = use_a ? ta[i] : tb[i];
  *err = nan_min(err_a, err_b);
}

}  // namespace cpnp
