"""Full PnP solve (EPnP init + Levenberg-Marquardt refine) and LM refinement alone:
kernel wrappers and plain versions.

Counterparts of ``casapose_tpu/ops/pnp_kernel.py::solve_pnp_pallas`` and
``::lm_refine_pallas``. One solve per detection:

  * EPnP with axis-aligned control points: a 12x12 M^T M from closed-form
    sums in normalised camera coordinates, its two smallest eigenvectors by
    6 steps of Cholesky inverse subspace iteration and a Rayleigh-Ritz
    rotation, the beta-1 and beta-2 (3x3 adjugate) candidates, and a Horn
    quaternion Procrustes fit for each by 30 shifted power iterations;
  * 10 LM iterations from each candidate (6x6 Cholesky, local SO(3)
    increment, lambda x1/3 on accept and x5 on reject); the candidate with
    the lower reprojection error wins.

:func:`solve_pnp_kernel` launches the CUDA kernel ``csrc/pnp.cu`` for CUDA
tensors and runs :func:`solve_pnp_plain` for CPU tensors; :func:`lm_refine`
and :func:`lm_refine_plain` do the same for the LM stage alone from a given
(R0, t0). The plain version
follows the kernel's algorithm step by step (the Pallas kernel's
``_epnp_candidates_grid``, ``_lm_body``, ``_chol_solve6``,
``_exp_so3_grid`` and winner pick), on [B, 1] and [B, N] tensors; it is not
the XLA algorithm of ``casapose_tpu/pose/epnp.py``.
"""

import ctypes

import torch

from casapose_tpu_torch.ops import _build

# ----------------------------------------------------------------- plain version


def _mean_n(x):
    return torch.mean(x, dim=1, keepdim=True)


def _sum_n(x):
    return torch.sum(x, dim=1, keepdim=True)


def _chol_factor(A, n):
    """Cholesky factor of an n x n grid of [B, 1] entries (diagonal floored at 1e-30 before sqrt)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, 1e-30)) if i == j else s / L[j][j]
    return L


def _chol_solve(L, b):
    n = len(b)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _matvec(A, v):
    n = len(v)
    return [sum(A[i][j] * v[j] for j in range(n)) for i in range(n)]


def _dot(a, b):
    return sum(x * y for x, y in zip(a, b))


def _exp_so3(wx, wy, wz):
    """Rodrigues exp map of [B, 1] components -> 3x3 grid: I + a K + b (w w^T - |w|^2 I)."""
    theta2 = wx * wx + wy * wy + wz * wz
    theta = torch.sqrt(torch.clamp(theta2, 1e-30))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp(theta2, 1e-30))
    w = [wx, wy, wz]
    zero = torch.zeros_like(wx)
    K = [[zero, -wz, wy], [wz, zero, -wx], [-wy, wx, zero]]
    return [
        [(1.0 if i == j else 0.0) + a * K[i][j] + b * (w[i] * w[j] - (theta2 if i == j else 0.0)) for j in range(3)]
        for i in range(3)
    ]


def _lm_body(R, t, lam, X, U, fx, fy, cx, cy):
    """One LM iteration. R: 3x3 grid of [B, 1]; t: 3 x [B, 1]; X: 3 x [B, N]; U: 2 x [B, N]."""

    def residuals(R, t):
        Xc = [R[i][0] * X[0] + R[i][1] * X[1] + R[i][2] * X[2] + t[i] for i in range(3)]
        z = Xc[2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        ru = fx * Xc[0] / zs + cx - U[0]
        rv = fy * Xc[1] / zs + cy - U[1]
        return ru, rv, Xc, zs

    ru, rv, Xc, z = residuals(R, t)
    err = _sum_n(ru * ru + rv * rv)
    iz = 1.0 / z
    du0 = fx * iz
    du2 = -fx * Xc[0] * iz * iz
    dv1 = fy * iz
    dv2 = -fy * Xc[1] * iz * iz
    px = Xc[0] - t[0]
    py = Xc[1] - t[1]
    pz = Xc[2] - t[2]
    zero = torch.zeros_like(du0)
    Ju = [du2 * py, du0 * pz - du2 * px, -du0 * py, du0, zero, du2]
    Jv = [-dv1 * pz + dv2 * py, -dv2 * px, dv1 * px, zero, dv1, dv2]
    H = [[None] * 6 for _ in range(6)]
    g = [None] * 6
    for i in range(6):
        for j in range(i, 6):
            H[i][j] = _sum_n(Ju[i] * Ju[j] + Jv[i] * Jv[j])
        g[i] = _sum_n(Ju[i] * ru + Jv[i] * rv)
    for i in range(6):
        for j in range(i):
            H[i][j] = H[j][i]
    for i in range(6):
        H[i][i] = H[i][i] + lam * (1.0 + H[i][i])
    delta = _chol_solve(_chol_factor(H, 6), g)
    delta = [torch.where(torch.isfinite(d), d, torch.zeros_like(d)) for d in delta]
    dR = _exp_so3(-delta[0], -delta[1], -delta[2])
    R_new = [[sum(dR[i][k] * R[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    t_new = [t[i] - delta[3 + i] for i in range(3)]
    ru2, rv2, _, _ = residuals(R_new, t_new)
    err_new = _sum_n(ru2 * ru2 + rv2 * rv2)
    accept = torch.isfinite(err_new) & (err_new < err)
    R = [[torch.where(accept, R_new[i][j], R[i][j]) for j in range(3)] for i in range(3)]
    t = [torch.where(accept, t_new[i], t[i]) for i in range(3)]
    lam = torch.where(accept, torch.clamp(lam / 3.0, 1e-12), torch.clamp(lam * 5.0, max=1e6))
    return R, t, lam, torch.minimum(err, err_new)


def _epnp_candidates(X, u, v):
    """EPnP beta-1 / beta-2 candidates; X: 3 x [B, N] model points, u, v: [B, N] normalised coordinates."""
    c0 = [_mean_n(X[c]) for c in range(3)]
    cent = [X[c] - c0[c] for c in range(3)]
    std = [torch.sqrt(torch.clamp(_mean_n(cent[c] * cent[c]), 1e-30)) for c in range(3)]
    mx = torch.maximum(torch.maximum(std[0], std[1]), std[2])
    floor = 1e-3 * torch.clamp(mx, 1e-9)
    s = [torch.maximum(std[c], floor) for c in range(3)]
    a123 = [cent[c] / s[c] for c in range(3)]
    alpha = [1.0 - a123[0] - a123[1] - a123[2]] + a123

    q2 = u * u + v * v
    S = [[None] * 4 for _ in range(4)]
    SU = [[None] * 4 for _ in range(4)]
    SV = [[None] * 4 for _ in range(4)]
    SQ = [[None] * 4 for _ in range(4)]
    for a in range(4):
        for b_ in range(a, 4):
            ab = alpha[a] * alpha[b_]
            S[a][b_] = S[b_][a] = _sum_n(ab)
            SU[a][b_] = SU[b_][a] = _sum_n(ab * u)
            SV[a][b_] = SV[b_][a] = _sum_n(ab * v)
            SQ[a][b_] = SQ[b_][a] = _sum_n(ab * q2)
    zero = torch.zeros_like(S[0][0])
    M = [[zero] * 12 for _ in range(12)]
    for a in range(4):
        for b_ in range(4):
            M[3 * a + 0][3 * b_ + 0] = S[a][b_]
            M[3 * a + 1][3 * b_ + 1] = S[a][b_]
            M[3 * a + 0][3 * b_ + 2] = -SU[a][b_]
            M[3 * a + 2][3 * b_ + 0] = -SU[a][b_]
            M[3 * a + 1][3 * b_ + 2] = -SV[a][b_]
            M[3 * a + 2][3 * b_ + 1] = -SV[a][b_]
            M[3 * a + 2][3 * b_ + 2] = SQ[a][b_]

    # Two smallest eigenvectors: Cholesky inverse subspace iteration.
    trace = sum(M[i][i] for i in range(12))
    ridge = 1e-6 * trace + 1e-30
    Mn = [[M[i][j] + ridge if i == j else M[i][j] for j in range(12)] for i in range(12)]
    L = _chol_factor(Mn, 12)
    w1 = [torch.full_like(zero, 1.0 + 0.1 * i) for i in range(12)]
    w2 = [torch.full_like(zero, 2.0 - 0.2 * i) for i in range(12)]
    for _ in range(6):
        w1 = _chol_solve(L, w1)
        w2 = _chol_solve(L, w2)
        n1 = torch.sqrt(torch.clamp(_dot(w1, w1), 1e-30))
        w1 = [x / n1 for x in w1]
        d = _dot(w1, w2)
        w2 = [y - d * x for x, y in zip(w1, w2)]
        n2 = torch.sqrt(torch.clamp(_dot(w2, w2), 1e-30))
        w2 = [x / n2 for x in w2]
    # Rayleigh-Ritz rotation by half-angle identities.
    T11 = _dot(w1, _matvec(M, w1))
    Aw2 = _matvec(M, w2)
    T22 = _dot(w2, Aw2)
    T12 = _dot(w1, Aw2)
    aa = T11 - T22
    bb = 2.0 * T12
    rr = torch.sqrt(torch.clamp(aa * aa + bb * bb, 1e-30))
    cos2 = aa / rr
    cth = torch.sqrt(torch.clamp((1.0 + cos2) * 0.5, 0.0))
    # sign(bb) with sign(0) = +1: where T12 is exactly 0 and T11 < T22 the TPU kernel's
    # jnp.sign(0) = 0 zeroes both Ritz vectors; +1 swaps w1 and w2 as the limit bb -> 0+ does.
    sth = torch.where(bb < 0, -torch.ones_like(bb), torch.ones_like(bb)) * torch.sqrt(torch.clamp((1.0 - cos2) * 0.5, 0.0))
    degenerate_rr = (aa * aa + bb * bb) < 1e-28
    cth = torch.where(degenerate_rr, torch.ones_like(cth), cth)
    sth = torch.where(degenerate_rr, torch.zeros_like(sth), sth)
    r1 = [cth * a_ + sth * b_ for a_, b_ in zip(w1, w2)]
    r2 = [-sth * a_ + cth * b_ for a_, b_ in zip(w1, w2)]
    e1 = _dot(r1, _matvec(M, r1))
    e2 = _dot(r2, _matvec(M, r2))
    fs = e1 <= e2
    v_min = [torch.where(fs, a_, b_) for a_, b_ in zip(r1, r2)]
    v_2nd = [torch.where(fs, b_, a_) for a_, b_ in zip(r1, r2)]

    # World control points: ctrl[0] = c0, ctrl[1+c] = c0 + s_c e_c.
    ctrl_w = [[c0[c] for c in range(3)] for _ in range(4)]
    for c in range(3):
        ctrl_w[1 + c][c] = c0[c] + s[c]

    def pose_from_null(vk):
        num = torch.zeros_like(zero)
        den = torch.zeros_like(zero)
        for a in range(4):
            for b_ in range(a + 1, 4):
                dc = [vk[3 * a + c] - vk[3 * b_ + c] for c in range(3)]
                dw = [ctrl_w[a][c] - ctrl_w[b_][c] for c in range(3)]
                ndc = torch.sqrt(torch.clamp(_dot(dc, dc), 1e-30))
                ndw = torch.sqrt(torch.clamp(_dot(dw, dw), 1e-30))
                num = num + ndc * ndw
                den = den + ndc * ndc
        beta = num / torch.clamp(den, 1e-30)
        chat = [vk[i] * beta for i in range(12)]
        pc = [sum(alpha[a] * chat[3 * a + c] for a in range(4)) for c in range(3)]
        flip = torch.where(_mean_n(pc[2]) < 0, torch.full_like(zero, -1.0), torch.ones_like(zero))
        pc = [p * flip for p in pc]
        # Horn Procrustes.
        xb = [_mean_n(X[c]) for c in range(3)]
        pb = [_mean_n(pc[c]) for c in range(3)]
        S3 = [[_sum_n((X[i] - xb[i]) * (pc[j] - pb[j])) for j in range(3)] for i in range(3)]
        Sxx, Sxy, Sxz = S3[0]
        Syx, Syy, Syz = S3[1]
        Szx, Szy, Szz = S3[2]
        Nq = [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
        shift = None
        for i in range(4):
            row = sum(torch.abs(Nq[i][j]) for j in range(4))
            shift = row if shift is None else torch.maximum(shift, row)
        Ns = [[Nq[i][j] + shift if i == j else Nq[i][j] for j in range(4)] for i in range(4)]
        q = [torch.full_like(zero, 0.5) for _ in range(4)]
        for _ in range(30):
            q = _matvec(Ns, q)
            nq = torch.sqrt(torch.clamp(_dot(q, q), 1e-30))
            q = [x / nq for x in q]
        qw, qx, qy, qz = q
        R = [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
        ]
        t = [pb[i] - sum(R[i][j] * xb[j] for j in range(3)) for i in range(3)]
        return R, t

    cand1 = pose_from_null(v_min)

    # Beta case N=2: 3-unknown normal equations over the 6 control-point pairs.
    A00 = A01 = A02 = A11 = A12 = A22 = g0 = g1 = g2 = 0.0
    for a in range(4):
        for b_ in range(a + 1, 4):
            d1c = [v_min[3 * a + c] - v_min[3 * b_ + c] for c in range(3)]
            d2c = [v_2nd[3 * a + c] - v_2nd[3 * b_ + c] for c in range(3)]
            dwc = [ctrl_w[a][c] - ctrl_w[b_][c] for c in range(3)]
            r0 = _dot(d1c, d1c)
            r1_ = 2.0 * _dot(d1c, d2c)
            r2_ = _dot(d2c, d2c)
            rhs = _dot(dwc, dwc)
            A00, A01, A02 = A00 + r0 * r0, A01 + r0 * r1_, A02 + r0 * r2_
            A11, A12, A22 = A11 + r1_ * r1_, A12 + r1_ * r2_, A22 + r2_ * r2_
            g0, g1, g2 = g0 + r0 * rhs, g1 + r1_ * rhs, g2 + r2_ * rhs
    trA = A00 + A11 + A22
    A00 = A00 + 1e-8 * trA
    A11 = A11 + 1e-8 * trA
    A22 = A22 + 1e-8 * trA
    c00 = A11 * A22 - A12 * A12
    c01 = A02 * A12 - A01 * A22
    c02 = A01 * A12 - A02 * A11
    c11 = A00 * A22 - A02 * A02
    c12 = A01 * A02 - A00 * A12
    c22 = A00 * A11 - A01 * A01
    det = A00 * c00 + A01 * c01 + A02 * c02
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    b11 = (c00 * g0 + c01 * g1 + c02 * g2) / det
    b12 = (c01 * g0 + c11 * g1 + c12 * g2) / det
    b22 = (c02 * g0 + c12 * g1 + c22 * g2) / det
    bb1 = torch.sqrt(torch.clamp(b11, 1e-12))
    bb2m = torch.sqrt(torch.clamp(b22, 1e-12))
    bb2 = torch.where(b12 < 0, -bb2m, bb2m)
    cand2 = pose_from_null([bb1 * v_min[i] + bb2 * v_2nd[i] for i in range(12)])
    return cand1, cand2


def solve_pnp_plain(pts2d, pts3d, K, iterations=10):
    """Plain PyTorch version of the PnP kernel.

    Args:
      pts2d: [B, N, 2] (x, y) pixels; pts3d: [B, N, 3] model points;
      K: [3, 3] intrinsics shared by the batch.
    Returns: (R [B, 3, 3], t [B, 3], err [B]) of the winning candidate.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X = [pts3d[:, :, c] for c in range(3)]
    U = [pts2d[:, :, 0], pts2d[:, :, 1]]
    (R1, t1), (R2, t2) = _epnp_candidates(X, (U[0] - cx) / fx, (U[1] - cy) / fy)
    B = pts2d.shape[0]

    Ra, ta, erra = _refine(R1, t1, X, U, fx, fy, cx, cy, iterations)
    Rb, tb, errb = _refine(R2, t2, X, U, fx, fy, cx, cy, iterations)
    use_a = erra <= errb
    R = torch.cat([torch.where(use_a, Ra[i][j], Rb[i][j]) for i in range(3) for j in range(3)], dim=1)
    t = torch.cat([torch.where(use_a, ta[i], tb[i]) for i in range(3)], dim=1)
    return R.view(B, 3, 3), t, torch.minimum(erra, errb)[:, 0]


def _refine(R, t, X, U, fx, fy, cx, cy, iterations):
    """``iterations`` LM steps from grids R (3x3 of [B, 1]) and t (3 of [B, 1]); lambda from 1e-4, err from 0."""
    lam = torch.full_like(t[0], 1e-4)
    err = torch.zeros_like(t[0])
    for _ in range(iterations):
        R, t, lam, err = _lm_body(R, t, lam, X, U, fx, fy, cx, cy)
    return R, t, err


def lm_refine_plain(R0, t0, pts2d, pts3d, K, iterations=10):
    """Plain PyTorch version of the LM kernel.

    Args:
      R0: [B, 3, 3] initial rotations; t0: [B, 3] initial translations;
      pts2d: [B, N, 2] (x, y) pixels; pts3d: [B, N, 3]; K: [3, 3].
    Returns: (R [B, 3, 3], t [B, 3], err [B]) after ``iterations`` LM steps.
    """
    B = pts2d.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    X = [pts3d[:, :, c] for c in range(3)]
    U = [pts2d[:, :, 0], pts2d[:, :, 1]]
    R = [[R0[:, i, j : j + 1] for j in range(3)] for i in range(3)]
    t = [t0[:, i : i + 1] for i in range(3)]
    R, t, err = _refine(R, t, X, U, fx, fy, cx, cy, iterations)
    return torch.cat([R[i][j] for i in range(3) for j in range(3)], dim=1).view(B, 3, 3), torch.cat(t, dim=1), err[:, 0]


# ----------------------------------------------------------------- kernel wrapper

_MAX_POINTS = 32


def _check(fn, name, x, shape, device):
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{fn}: `{name}` must be contiguous float32 {shape} on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_problem(fn, pts2d, pts3d, K):
    """Check the shared inputs; return (B, N, kparams [fx, fy, cx, cy], R, t, err outputs)."""
    B, N, _ = pts2d.shape
    if N > _MAX_POINTS:
        raise ValueError(f"{fn}: at most {_MAX_POINTS} points per detection, got {N}")
    dev = pts2d.device
    _check(fn, "pts2d", pts2d, (B, N, 2), dev)
    _check(fn, "pts3d", pts3d, (B, N, 3), dev)
    _check(fn, "K", K, (3, 3), dev)
    kparams = torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]).contiguous()
    R = torch.empty((B, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((B, 3), dtype=torch.float32, device=dev)
    err = torch.empty((B,), dtype=torch.float32, device=dev)
    return B, N, kparams, R, t, err


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def solve_pnp_kernel(pts2d, pts3d, K, iterations=10):
    """Full PnP per detection: the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args / returns as :func:`solve_pnp_plain`. Degenerate (all-zero) rows
    are the caller's to replace (see pose/epnp.py::solve_pnp).
    """
    if not pts2d.is_cuda:
        return solve_pnp_plain(pts2d, pts3d, K, iterations)
    B, N, kparams, R, t, err = _check_problem("solve_pnp_kernel", pts2d, pts3d, K)
    if B == 0:
        return R, t, err
    lib = _build.load("pnp")
    rc = lib.solve_pnp(
        _ptr(pts2d), _ptr(pts3d), _ptr(kparams), _ptr(R), _ptr(t), _ptr(err),
        B, N, iterations, ctypes.c_void_p(torch.cuda.current_stream(pts2d.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"solve_pnp kernel launch failed: CUDA error {rc}")
    solve_pnp_kernel.launches += 1
    return R, t, err


solve_pnp_kernel.launches = 0


def lm_refine(R0, t0, pts2d, pts3d, K, iterations=10):
    """LM refinement from (R0, t0): the CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    Args / returns as :func:`lm_refine_plain`.
    """
    if not pts2d.is_cuda:
        return lm_refine_plain(R0, t0, pts2d, pts3d, K, iterations)
    B, N, kparams, R, t, err = _check_problem("lm_refine", pts2d, pts3d, K)
    _check("lm_refine", "R0", R0, (B, 3, 3), pts2d.device)
    _check("lm_refine", "t0", t0, (B, 3), pts2d.device)
    if B == 0:
        return R, t, err
    lib = _build.load("pnp")
    rc = lib.lm_refine(
        _ptr(R0), _ptr(t0), _ptr(pts2d), _ptr(pts3d), _ptr(kparams), _ptr(R), _ptr(t), _ptr(err),
        B, N, iterations, ctypes.c_void_p(torch.cuda.current_stream(pts2d.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"lm_refine kernel launch failed: CUDA error {rc}")
    lm_refine.launches += 1
    return R, t, err


lm_refine.launches = 0
