"""Numerically-safe primitives and the float32 precision guard.

PyTorch counterpart of ``casapose_tpu/core/numerics.py``. The zero-safe
helpers double-``where`` the operand so that no NaN gradient leaks through
the branch that is not taken.
"""

import contextlib

import torch


@contextlib.contextmanager
def f32_precision():
    """Run the enclosed code in full float32: TF32 off for cuDNN and matmuls.

    The JAX reference runs its float32 math at ``highest`` precision
    (docs/DESIGN.md section 5). PyTorch's cuDNN convolutions default to TF32,
    which keeps about three decimal digits, so the guard turns it off and
    restores the previous flags on exit.
    """
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def divide_no_nan(a, b):
    """a / b, returning 0 where b == 0, safe under autograd."""
    b_ok = b != 0
    safe_b = torch.where(b_ok, b, torch.ones_like(b))
    return torch.where(b_ok, a / safe_b, torch.zeros_like(safe_b))


def multiply_no_nan(a, b):
    """a * b, returning 0 where b == 0 even if a is inf/NaN there."""
    b_ok = b != 0
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    safe_a = torch.where(b_ok, a, zero)
    return torch.where(b_ok, safe_a * b, zero)


def safe_l2_normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along ``dim``; zero vectors stay zero (no NaN)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    inv = torch.sqrt(1.0 / torch.clamp(sq, min=eps))
    return x * torch.where(sq > eps, inv, torch.zeros_like(inv))
