"""PnP as a layer: ``bpnp_pose``, the forward of ``casapose_tpu/pose/bpnp.py``.

The JAX package differentiates the solve through the stationarity condition
of the reprojection objective (a ``custom_vjp``); that backward belongs to
the training slice of the port and is not here. The forward is
``solve_pnp``, through the PnP kernel on the card. Asking for a gradient
raises rather than returning a wrong one.
"""

import torch

from casapose_tpu_torch.pose.epnp import solve_pnp


def bpnp_pose(pts2d, pts3d, K):
    """Batched PnP, forward only.

    Args:
      pts2d: [B, N, 2] (x, y) pixels (all-zero rows give the placeholder pose).
      pts3d: [B, N, 3] model points.
      K: [3, 3] intrinsics.
    Returns: p6d [B, 6] = [rvec | t].
    Raises: NotImplementedError where autograd would track the result.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (pts2d, pts3d, K)):
        raise NotImplementedError(
            "bpnp_pose: the implicit-function backward is not ported yet (training slice); "
            "call it under torch.no_grad() or on tensors that do not require grad"
        )
    return solve_pnp(pts2d, pts3d, K)
