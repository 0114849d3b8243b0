"""Routing of the kernels' call sites to the kernels' plain versions.

Three call sites launch a kernel for CUDA tensors: the voting sums in
``ops/voting.py::ls_voting`` (kernel "voting"), the solve in
``pose/epnp.py::solve_pnp`` (kernel "pnp") and the CC labelling in
``ops/connected_components.py::connected_components_labels`` (kernel "cc").
Inside ``with
plain_kernels(...)`` they call the named kernels' plain PyTorch versions
instead, on any device, and take the same branch as on the card. That holds
a kernel against its plain version on the inputs a whole path gives it; the
package itself never enters this context.

    with plain_kernels("pnp"):      # voting and CC kernels, plain PnP
        out = step(batch)
"""

import contextlib
import contextvars

KERNELS = ("voting", "pnp", "cc")
# Per thread (and per asyncio task), as torch.no_grad is: one caller's context does not reach another's.
_plain = contextvars.ContextVar("casapose_tpu_torch_plain_kernels", default=frozenset())


@contextlib.contextmanager
def plain_kernels(*names):
    """Route the call sites of ``names`` (default: every kernel) to their plain versions while inside."""
    chosen = frozenset(names or KERNELS)
    unknown = chosen - frozenset(KERNELS)
    if unknown:
        raise ValueError(f"plain_kernels: unknown kernels {sorted(unknown)}; known: {KERNELS}")
    token = _plain.set(_plain.get() | chosen)
    try:
        yield
    finally:
        _plain.reset(token)


def is_plain(name):
    """Whether the call site of kernel ``name`` takes its plain version."""
    return name in _plain.get()
