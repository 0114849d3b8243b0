"""``--profile_dir`` of both harnesses: a torch.profiler trace written as a Chrome trace.

The JAX harnesses write a ``jax.profiler`` trace of a window of steps; the
port records the same window with ``torch.profiler`` (CPU activity, and CUDA
activity on the card: every kernel, the hand-written ones included) and
writes ``<profile_dir>/<name>.json``, which ``chrome://tracing`` and
Perfetto read.
"""

import os

import torch


class ProfileWindow:
    """A trace of the steps ``start`` to ``stop - 1`` of a loop, written as ``<profile_dir>/<name>.json``; nothing
    where ``profile_dir`` is empty.

    Call :meth:`before` with each step's index before the step, and
    :meth:`close` after the loop, which writes the trace if the loop ended
    inside the window.
    """

    def __init__(self, profile_dir, start, stop, dev, name):
        self.dir, self.start, self.stop, self.dev, self.name = profile_dir, start, stop, dev, name
        self.prof = None

    def before(self, step):
        if not self.dir:
            return
        if step == self.start and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU]
                                + ([ProfilerActivity.CUDA] if self.dev.type == "cuda" else []))
            self.prof.__enter__()
        elif step == self.stop and self.prof is not None:
            self.close()

    def close(self):
        """Stop the trace after the device's queued work and write it, if one is running."""
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, f"{self.name}.json"))
        print(f"wrote profiler trace to {self.dir}")
        self.prof, self.dir = None, None
