"""Batched PnP: ``solve_pnp`` and ``pose_matrix_from_p6d``.

Counterpart of ``casapose_tpu/pose/epnp.py``. ``solve_pnp`` chooses its
branch as the JAX package does on an accelerator, from
``CASAPOSE_PNP_REFINE``:

  * unset or ``pallas``: the whole solve (EPnP init + LM refine) is the PnP
    kernel (ops/pnp_kernel.py), which runs the CUDA kernel for CUDA tensors
    and its plain version for CPU tensors (and on any device inside
    ``ops/plain.py::plain_kernels("pnp")``);
  * any other value: the JAX package's XLA algorithm, on any device:
    ``epnp_candidates`` (axis-aligned control points, a 12x12 normal matrix,
    its two smallest eigenvectors by 6 steps of Cholesky inverse subspace
    iteration and a Rayleigh-Ritz rotation, the beta N=1 and N=2 cases, Horn's
    quaternion Procrustes fit by 30 power iterations), then ``_refine``: LM on
    p6d = [rvec | t] from both candidates in one doubled batch, the Jacobian by
    ``torch.func.jacfwd`` under ``torch.func.vmap``, the branch-free
    accept/reject and lambda schedule; the lower final error wins. This is
    the JAX package's own CPU path, many small operations on the card.

Degenerate rows (all-zero 2D points, the reference's "missing object"
convention) are swapped for a consistent synthetic problem before the solve
and come out as the placeholder pose [rvec = 0, t = (0, 0, 1)]; non-finite
results are spliced to the identity / (0, 0, 1) (the kernel) or 0 (XLA).
"""

import os

import torch
from torch.func import jacfwd, vmap

from casapose_tpu_torch.core.numerics import divide_no_nan, f32_precision
from casapose_tpu_torch.ops.plain import is_plain
from casapose_tpu_torch.ops.pnp_kernel import solve_pnp_kernel, solve_pnp_plain
from casapose_tpu_torch.pose.geometry import rodrigues, rotation_to_rvec


def _project_placeholder(pts3d, K):
    """Pixels of ``pts3d`` [B, N, 3] under the placeholder pose R = I, t = (0, 0, 1)."""
    cam = pts3d + (torch.arange(3, device=pts3d.device) == 2).to(pts3d.dtype)  # + (0, 0, 1), made on the device
    uv = divide_no_nan(cam[..., :2], cam[..., 2:])
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])


@torch.library.custom_op("casapose::solve_pnp", mutates_args=())
def _solve_pnp_op(pts2d: torch.Tensor, pts3d: torch.Tensor, K: torch.Tensor,
                  iterations: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The PnP kernel's call site as one operator, so that ``torch.export`` records it (core/export.py): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors, through this module's ``solve_pnp_kernel``."""
    return solve_pnp_kernel(pts2d, pts3d, K, iterations)


@_solve_pnp_op.register_fake
def _(pts2d, pts3d, K, iterations):
    b = pts2d.shape[0]
    return pts2d.new_empty((b, 3, 3)), pts2d.new_empty((b, 3)), pts2d.new_empty((b,))


def substitute_degenerate(pts2d, pts3d, K):
    """Swap all-(near-)zero rows of ``pts2d`` for the projection under the placeholder pose.

    Returns (safe_pts2d [B, N, 2], degenerate [B] bool); the PnP kernel sees
    only ``safe_pts2d``, so all its linear algebra stays finite.
    """
    b = pts2d.shape[0]
    degenerate = torch.abs(torch.sum(pts2d.reshape(b, -1), dim=1)) < 1e-4
    return torch.where(degenerate[:, None, None], _project_placeholder(pts3d, K), pts2d), degenerate


# ----------------------------------------------------------------- the XLA algorithm (casapose_tpu/pose/epnp.py:33-425)

_TRIU_I, _TRIU_J = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)  # jnp.triu_indices(4, k=1)


def _control_points(pts3d):
    """Axis-aligned control points [B, 4, 3]: the centroid, then one point along each axis at its spread."""
    c0 = torch.mean(pts3d, dim=1, keepdim=True)
    std = torch.sqrt(torch.mean(torch.square(pts3d - c0), dim=1))  # [B, 3]
    floor = 1e-3 * torch.clamp(torch.amax(std, dim=1, keepdim=True), min=1e-9)
    scale = torch.maximum(std, floor)[:, :, None]
    ctrl = c0 + torch.eye(3, dtype=pts3d.dtype, device=pts3d.device)[None] * scale
    return torch.cat([c0, ctrl], dim=1)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([torch.stack([A11, A12, A13], -1), torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], dim=-2)
    return adj / det[..., None, None]


def _chol_factor(A):
    """Unrolled Cholesky factor of [..., n, n] SPD as a grid of [...] entries (lower triangle)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30)) if i == j else s / L[j][j]
    return L


def _chol_solve_list(L, b):
    """Solve L L^T x = b given a factor grid; ``b`` is a list of n [...] entries."""
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


def _cholesky_solve_spd(A, b):
    """Solve A x = b for small SPD A [..., n, n], b [..., n] with an unrolled Cholesky."""
    n = A.shape[-1]
    return torch.stack(_chol_solve_list(_chol_factor(A), [b[..., i] for i in range(n)]), dim=-1)


def _quad(u, A, v):
    """u^T A v per row: [B, n], [B, n, n], [B, n] -> [B]."""
    return torch.einsum("bi,bij,bj->b", u, A, v)


def _smallest_eigvecs2(A, iters=6):
    """Two smallest eigenvectors of symmetric PSD [B, 12, 12]: inverse subspace iteration, then Rayleigh-Ritz."""
    b, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    trace = torch.diagonal(A, dim1=1, dim2=2).sum(-1)[:, None, None]
    L = _chol_factor(A + (1e-6 * trace + 1e-30) * torch.eye(n, dtype=dtype, device=dev)[None])
    v1 = [torch.full((b,), 1.0 + 0.1 * i, dtype=dtype, device=dev) for i in range(n)]
    v2 = [torch.full((b,), 2.0 - 0.2 * i, dtype=dtype, device=dev) for i in range(n)]
    for _ in range(iters):
        v1 = _chol_solve_list(L, v1)
        v2 = _chol_solve_list(L, v2)
        n1 = torch.sqrt(torch.clamp(sum(v * v for v in v1), min=1e-30))
        v1 = [v / n1 for v in v1]
        d = sum(a_ * b_ for a_, b_ in zip(v1, v2))
        v2 = [b_ - d * a_ for a_, b_ in zip(v1, v2)]
        n2 = torch.sqrt(torch.clamp(sum(v * v for v in v2), min=1e-30))
        v2 = [v / n2 for v in v2]
    V1, V2 = torch.stack(v1, -1), torch.stack(v2, -1)
    T11, T22, T12 = _quad(V1, A, V1), _quad(V2, A, V2), _quad(V1, A, V2)
    theta = 0.5 * torch.atan2(2.0 * T12, T11 - T22 + 1e-30)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    r1, r2 = c * V1 + s * V2, -s * V1 + c * V2
    first_smaller = (_quad(r1, A, r1) <= _quad(r2, A, r2))[:, None]
    return torch.where(first_smaller, r1, r2), torch.where(first_smaller, r2, r1)


def _barycentric(pts3d, ctrl):
    """Barycentric coordinates [B, N, 4] in the axis-aligned control frame, in closed form."""
    c0 = ctrl[:, 0:1]
    s = ctrl[:, 1:4] - c0
    s_diag = torch.stack([s[:, 0, 0], s[:, 1, 1], s[:, 2, 2]], dim=-1)
    a123 = (pts3d - c0) / s_diag[:, None, :]
    return torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)


def _build_M(alphas, pts2d_norm):
    """The constraint normal matrix M^T M [B, 12, 12] in normalised camera coordinates."""
    b, n, _ = alphas.shape
    u, v = pts2d_norm[..., 0], pts2d_norm[..., 1]
    zeros = torch.zeros_like(alphas)
    ru = torch.stack([alphas, zeros, alphas * (-u)[..., None]], dim=-1)  # [B, N, 4, 3]
    rv = torch.stack([zeros, alphas, alphas * (-v)[..., None]], dim=-1)
    M = torch.cat([ru.reshape(b, n, 12)[:, :, None], rv.reshape(b, n, 12)[:, :, None]], dim=2).reshape(b, 2 * n, 12)
    return torch.einsum("bri,brj->bij", M, M)


def _solve_scale(v_ctrl, ctrl_w):
    """Least-squares scale beta matching the pairwise camera distances to the world's."""
    dc = v_ctrl[:, _TRIU_I] - v_ctrl[:, _TRIU_J]
    dw = ctrl_w[:, _TRIU_I] - ctrl_w[:, _TRIU_J]
    num = torch.sum(torch.linalg.vector_norm(dc, dim=-1) * torch.linalg.vector_norm(dw, dim=-1), dim=-1)
    return divide_no_nan(num, torch.sum(torch.square(dc), dim=(-2, -1)))


def _quat_to_matrix(q):
    """Unit quaternions (w, x, y, z) [B, 4] -> rotation matrices [B, 3, 3]."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _procrustes(pts_w, pts_c, iters=30):
    """Rigid (R, t) minimising ||R pts_w + t - pts_c||: Horn's quaternion by shifted power iteration."""
    cw = torch.mean(pts_w, dim=1, keepdim=True)
    cc = torch.mean(pts_c, dim=1, keepdim=True)
    S = torch.einsum("bni,bnj->bij", pts_w - cw, pts_c - cc)
    Sxx, Sxy, Sxz = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    Syx, Syy, Syz = S[:, 1, 0], S[:, 1, 1], S[:, 1, 2]
    Szx, Szy, Szz = S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    # The Gershgorin shift makes the dominant eigenvalue of N + sI the largest of N.
    shift = torch.amax(torch.sum(torch.abs(N), dim=-1), dim=-1)[:, None, None]
    Ns = N + shift * torch.eye(4, dtype=N.dtype, device=N.device)[None]
    q = torch.full((N.shape[0], 4), 0.5, dtype=N.dtype, device=N.device)
    for _ in range(iters):
        q = torch.einsum("bij,bj->bi", Ns, q)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)
    R = _quat_to_matrix(q)
    return R, cc[:, 0] - torch.einsum("bij,bj->bi", R, cw[:, 0])


def _pose_from_null(vker, alphas, pts3d, ctrl_w):
    """Camera-frame control points (up to sign and scale) -> (R, t)."""
    v_ctrl = vker.reshape(-1, 4, 3)
    pts_c = alphas @ (v_ctrl * _solve_scale(v_ctrl, ctrl_w)[:, None, None])
    flip = torch.where(torch.mean(pts_c[..., 2], dim=1, keepdim=True) < 0, -1.0, 1.0)[..., None]  # cheirality
    return _procrustes(pts3d, pts_c * flip)


def _reproj_sq_err(pts2d, pts3d, K, R, t):
    cam = torch.einsum("bij,bnj->bni", R, pts3d) + t[:, None]
    uv = divide_no_nan(cam[..., :2], cam[..., 2:]) * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    return torch.mean(torch.sum(torch.square(uv - pts2d), dim=-1), dim=-1)


@f32_precision()
def epnp_candidates(pts2d, pts3d, K):
    """EPnP candidate poses of the beta N=1 and N=2 cases: ((R1, t1), (R2, t2)), R [B, 3, 3], t [B, 3].

    Args: pts2d [B, N, 2] (x, y) pixels, pts3d [B, N, 3], K [3, 3] shared.
    """
    ctrl_w = _control_points(pts3d)
    alphas = _barycentric(pts3d, ctrl_w)
    pts2d_norm = (pts2d - torch.stack([K[0, 2], K[1, 2]]).to(pts2d.dtype)) / torch.stack([K[0, 0], K[1, 1]]).to(pts2d.dtype)
    v_min, v_2nd = _smallest_eigvecs2(_build_M(alphas, pts2d_norm))
    first = _pose_from_null(v_min, alphas, pts3d, ctrl_w)
    # Beta N=2: ||b1 d1 + b2 d2||^2 = |dw|^2 over the six control-point pairs, in (b11, b12, b22).
    v1, v2 = v_min.reshape(-1, 4, 3), v_2nd.reshape(-1, 4, 3)
    d1, d2 = v1[:, _TRIU_I] - v1[:, _TRIU_J], v2[:, _TRIU_I] - v2[:, _TRIU_J]
    dw = ctrl_w[:, _TRIU_I] - ctrl_w[:, _TRIU_J]
    A = torch.stack([torch.sum(d1 * d1, -1), 2.0 * torch.sum(d1 * d2, -1), torch.sum(d2 * d2, -1)], dim=-1)
    rhs = torch.sum(dw * dw, dim=-1)[..., None]
    AtA = torch.einsum("bij,bik->bjk", A, A)
    AtA = AtA + 1e-8 * torch.diagonal(AtA, dim1=1, dim2=2).sum(-1)[:, None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    sol = torch.einsum("bij,bj->bi", _inv3x3(AtA), torch.einsum("bij,bik->bjk", A, rhs)[..., 0])
    b1 = torch.sqrt(torch.clamp(sol[:, 0], min=1e-12))
    b2_mag = torch.sqrt(torch.clamp(sol[:, 2], min=1e-12))
    b2 = torch.where(sol[:, 1] < 0, -b2_mag, b2_mag)
    vker2 = (b1[:, None, None] * v1 + b2[:, None, None] * v2).reshape(-1, 12)
    return first, _pose_from_null(vker2, alphas, pts3d, ctrl_w)


@f32_precision()
def epnp(pts2d, pts3d, K):
    """EPnP pose (R [B, 3, 3], t [B, 3]): the candidate with the lower reprojection error."""
    (R1, t1), (R2, t2) = epnp_candidates(pts2d, pts3d, K)
    use1 = _reproj_sq_err(pts2d, pts3d, K, R1, t1) <= _reproj_sq_err(pts2d, pts3d, K, R2, t2)
    return torch.where(use1[:, None, None], R1, R2), torch.where(use1[:, None], t1, t2)


def _residuals(p6d, pts3d, K):
    """Projections [N, 2] of one row's model points under p6d = [rvec | t] (a single pose, vmapped)."""
    R = rodrigues(p6d[None, 0:3])[0]
    cam = pts3d @ R.T + p6d[3:6]
    uv = divide_no_nan(cam[:, :2], cam[:, 2:])
    return uv * torch.stack([K[0, 0], K[1, 1]]).to(p6d.dtype) + torch.stack([K[0, 2], K[1, 2]]).to(p6d.dtype)


def _lm_step(p6d, lam, pts2d, pts3d, K):
    """One Levenberg-Marquardt step of one row with branch-free accept / reject: (p6d [6], lam [])."""

    def f(p):
        return (_residuals(p, pts3d, K) - pts2d).reshape(-1)

    r = f(p6d)
    err = torch.sum(torch.square(r))
    J = jacfwd(f)(p6d)  # [2N, 6]
    JtJ = J.T @ J
    H = JtJ + lam * torch.eye(6, dtype=p6d.dtype, device=p6d.device) * (1.0 + torch.diagonal(JtJ))
    delta = _cholesky_solve_spd(H, J.T @ r)
    delta = torch.where(torch.all(torch.isfinite(delta)), delta, torch.zeros_like(delta))
    p_new = p6d - delta
    err_new = torch.sum(torch.square(f(p_new)))
    accept = torch.isfinite(err_new) & (err_new < err)
    return (torch.where(accept, p_new, p6d),
            torch.where(accept, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 5.0, max=1e6)))


def _refine(p6d0, pts2d, pts3d, K, iterations):
    """``iterations`` LM steps of every row [B, 6] from ``p6d0``, lambda starting at 1e-4."""
    step = vmap(_lm_step, in_dims=(0, 0, 0, 0, None))
    p6d, lam = p6d0, torch.full((p6d0.shape[0],), 1e-4, dtype=p6d0.dtype, device=p6d0.device)
    for _ in range(iterations):
        p6d, lam = step(p6d, lam, pts2d, pts3d, K)
    return p6d


def _solve_xla(safe_pts2d, pts3d, K, iterations):
    """The XLA branch of the JAX ``solve_pnp`` (``:464-486``): LM from both EPnP candidates in one doubled batch,
    the lower final error wins; p6d [B, 6]."""
    b = safe_pts2d.shape[0]
    (R1, t1), (R2, t2) = epnp_candidates(safe_pts2d, pts3d, K)

    def to_p6d(R, t):
        p = torch.cat([rotation_to_rvec(R), t], dim=1)
        tz = p[:, 5:6]
        p = torch.cat([p[:, :5], torch.where(torch.abs(tz) < 1e-6, torch.full_like(tz, 1e-6), tz)], dim=1)
        return torch.where(torch.isfinite(p), p, torch.zeros_like(p))

    pts2d_2, pts3d_2 = torch.cat([safe_pts2d, safe_pts2d]), torch.cat([pts3d, pts3d])
    refined = _refine(torch.cat([to_p6d(R1, t1), to_p6d(R2, t2)]), pts2d_2, pts3d_2, K, iterations)
    final_err = torch.sum(torch.square(vmap(_residuals, in_dims=(0, 0, None))(refined, pts3d_2, K) - pts2d_2), dim=(1, 2))
    return torch.where((final_err[:b] <= final_err[b:])[:, None], refined[:b], refined[b:])


@f32_precision()
def solve_pnp(pts2d, pts3d, K, iterations=10):
    """Full PnP per row, down the branch ``CASAPOSE_PNP_REFINE`` names (the module's docstring).

    Args:
      pts2d: [B, N, 2] (x, y) pixels; all-(near-)zero rows give the placeholder pose.
      pts3d: [B, N, 3] model points.
      K: [3, 3] intrinsics.
      iterations: LM iterations.
    Returns:
      p6d [B, 6] = [rvec | t].
    """
    dtype, dev = pts2d.dtype, pts2d.device
    placeholder = (torch.arange(6, device=dev) == 5).to(dtype)  # (0, 0, 0, 0, 0, 1), made on the device
    safe_pts2d, degenerate = substitute_degenerate(pts2d, pts3d, K)
    if os.environ.get("CASAPOSE_PNP_REFINE", "pallas") != "pallas":
        p6d = _solve_xla(safe_pts2d, pts3d, K, iterations)
    else:
        if is_plain("pnp"):
            R, t, _ = solve_pnp_plain(safe_pts2d.contiguous(), pts3d.contiguous(), K.contiguous(), iterations)
        else:
            R, t, _ = _solve_pnp_op(safe_pts2d.contiguous(), pts3d.contiguous(), K.contiguous(), iterations)
        R = torch.where(torch.isfinite(R), R, torch.eye(3, dtype=dtype, device=dev))
        t = torch.where(torch.isfinite(t), t, placeholder[3:])
        p6d = torch.cat([rotation_to_rvec(R), t], dim=1)
    p6d = torch.where(torch.isfinite(p6d), p6d, torch.zeros_like(p6d))
    return torch.where(degenerate[:, None], placeholder, p6d)


def pose_matrix_from_p6d(p6d):
    """[B, 6] -> [B, 3, 4], negated where t_z < 0 (the reference's sign fix)."""
    R = rodrigues(p6d[:, 0:3])
    t = p6d[:, 3:6, None]
    RT = torch.cat([R, t], dim=-1)
    return torch.where(t[:, 2:3] < 0, -RT, RT)
