"""Numerically-safe primitives and the float32 precision guard.

PyTorch counterpart of ``casapose_tpu/core/numerics.py``. The zero-safe
helpers double-``where`` the operand so that no NaN gradient leaks through
the branch that is not taken.
"""

import contextlib
import functools

import torch


# --matmul_precision -> TF32 in cuBLAS and cuDNN, as XLA's GPU backend reads the JAX flag: "highest" computes
# float32 dots and convolutions in float32; "high" and "default" let them take TF32 (a 10-bit mantissa) on the
# tensor cores.
MATMUL_PRECISIONS = {"highest": False, "high": True, "default": True}


@contextlib.contextmanager
def matmul_precision(precision="highest"):
    """Run the enclosed code at the JAX harness's ``--matmul_precision``: TF32 off for cuDNN and matmuls at
    ``highest``, on at ``high`` and ``default``; the previous flags are restored on exit.

    The counterpart of ``jax_default_matmul_precision`` around the train and
    eval steps. The pose and voting numerics that the JAX package pins to
    float32 whatever the flag (its ``f32_precision`` and ``HIGHEST``
    contractions) enter :func:`f32_precision` here, or :func:`f32_pinned`
    where a gradient flows through them.
    """
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul precision {precision!r}: expected one of {sorted(MATMUL_PRECISIONS)}")
    tf32 = MATMUL_PRECISIONS[precision]
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def f32_precision():
    """Run the enclosed code (or the decorated function) in full float32: TF32 off for cuDNN and matmuls.

    The JAX reference runs its float32 math at ``highest`` precision
    (docs/DESIGN.md section 5). PyTorch's cuDNN convolutions default to TF32,
    which keeps about three decimal digits, so the guard turns it off and
    restores the previous flags on exit.
    """
    return matmul_precision("highest")


def f32_pinned(fn):
    """Decorator: run ``fn`` and its gradient in full float32 whatever ``--matmul_precision`` says.

    JAX pins the precision on each dot, and the transposed dots of its
    gradient inherit it. The TF32 switches of ``torch.backends`` are global
    instead, and autograd runs a backward after the forward's context has
    exited: :func:`f32_precision` around the forward alone would leave the
    gradient's matmuls at the step's setting. So where an input requires a
    gradient, ``fn`` runs on detached inputs inside :func:`f32_precision`,
    and its backward takes the gradient of that inner graph inside
    :func:`f32_precision` again (:class:`_F32Graph`). Tensors are passed
    positionally; keyword arguments are constants.
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
            return _F32Graph.apply(functools.partial(fn, **kwargs), *args)
        with f32_precision():
            return fn(*args, **kwargs)

    return wrapper


class _F32Graph(torch.autograd.Function):
    """``fn(*args)`` as one node whose forward and backward both run with TF32 off (:func:`f32_pinned`)."""

    @staticmethod
    def forward(ctx, fn, *args):
        inner = [a.detach().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor) else a for a in args]
        with torch.enable_grad(), f32_precision():
            out = fn(*inner)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.inner_in, ctx.inner_out, ctx.is_tuple = inner, outs, isinstance(out, tuple)
        detached = tuple(o.detach() for o in outs)
        ctx.mark_non_differentiable(*[d for o, d in zip(outs, detached) if not o.requires_grad])
        return detached if ctx.is_tuple else detached[0]

    @staticmethod
    def backward(ctx, *grads):
        pairs = [(o, g) for o, g in zip(ctx.inner_out, grads) if o.requires_grad and g is not None]
        wants = [isinstance(a, torch.Tensor) and a.requires_grad for a in ctx.inner_in]
        with f32_precision():
            got = iter(torch.autograd.grad([o for o, _ in pairs], [a for a, w in zip(ctx.inner_in, wants) if w],
                                           [g for _, g in pairs], allow_unused=True))
        ctx.inner_in = ctx.inner_out = None
        return (None,) + tuple(next(got) if w else None for w in wants)


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
