"""Serving export: the inference pipeline as a ``torch.export`` program.

Counterpart of ``casapose_tpu/core/export.py``. :func:`export_inference`
exports the inference step (network forward -> CC-filtered LS voting -> PnP,
the program ``python -m casapose_tpu_torch.test_minimal`` times) with
``torch.export.export`` at static shapes, one program per (batch, height,
width, device), and returns the bytes of ``torch.export.save``; the weights
travel inside the artifact. :func:`load_exported` turns the bytes back into a
callable ``(img, keypoints3d, camera) -> poses``.

What a serving host needs differs from the JAX package's artifact, which
needs only ``jax``: this program calls three custom operators,
``casapose::voting_accumulate``, ``casapose::connected_components`` and
``casapose::solve_pnp`` (the voting kernel, the CC labelling loop, which stops
on a host read and so cannot be traced, and the PnP kernel). Loading it needs
``torch`` and ``import casapose_tpu_torch.ops``, which registers them; on the
card their kernels build from ``casapose_tpu_torch/csrc`` at first use, as in
the live step, and their launch counters count inside the program.

A program records operators, not the process-wide TF32 switches:
:func:`load_exported`'s callable runs it with TF32 off (``highest``), as the
JAX artifact carries ``HIGHEST`` in its HLO.

CLI: ``python -m casapose_tpu_torch.export_model`` (``--export_path``,
``--export_platforms`` and the model and weights flags).
"""

import io

import torch

import casapose_tpu_torch.ops  # noqa: F401  (registers the casapose:: operators the program calls)
from casapose_tpu_torch.core.device import resolve_device
from casapose_tpu_torch.core.numerics import matmul_precision
from casapose_tpu_torch.ops.voting import ls_voting
from casapose_tpu_torch.pose.evaluation import poses_pnp


def build_serving_fn(model, no_objects, no_points, estimate_confidence=True, filter_estimates=True,
                     choose_second=False, cc_downsample=4):
    """The deployable inference program: ``fn(img [b, h, w, 3], keypoints3d [b, oc, 1, k, 3], camera [b, 3, 3])
    -> poses [b, oc, 1, 3, 4]``, wired as the eval harness wires its voting (``raw_output`` only with confidence
    channels; without them unit weights). ``model`` is called as it is: in eval mode for serving."""
    seg_dim = 1 + no_objects
    k = no_points

    def fn(img, keypoints3d, camera):
        out = model(img)
        seg = out[..., :seg_dim]
        dirs = out[..., seg_dim : seg_dim + 2 * k]
        conf = out[..., seg_dim + 2 * k :] if estimate_confidence else torch.ones(
            img.shape[:3] + (k,), dtype=out.dtype, device=out.device)
        coords = ls_voting(seg, dirs, conf, num_points=k, filter_estimates=filter_estimates,
                           output_second_largest_component=choose_second, cc_downsample=cc_downsample,
                           raw_output=out if estimate_confidence else None)
        return poses_pnp(coords, seg, keypoints3d, camera, no_objects)

    return fn


class _Serving(torch.nn.Module):
    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, img, keypoints3d, camera):
        return self.fn(img, keypoints3d, camera)


def export_inference(model, batch, height, width, no_objects, no_points, device="cuda", **serving_kwargs):
    """Export the inference program for one (batch, height, width, device) and return the artifact's bytes.

    ``model`` must be in eval mode on ``device`` ("cuda", the default, or "cpu"); ``serving_kwargs`` are those of
    :func:`build_serving_fn`. The program is traced with TF32 off.
    """
    dev = resolve_device(device)
    if any(p.device.type != dev.type or dev.index not in (None, p.device.index) for p in model.parameters()):
        raise ValueError(f"export_inference: the model's parameters must lie on {dev}")
    if model.training:
        raise ValueError("export_inference: the model must be in eval mode")
    args = (torch.zeros(batch, height, width, 3, device=dev),
            torch.zeros(batch, no_objects, 1, no_points, 3, device=dev),
            torch.zeros(batch, 3, 3, device=dev))
    with torch.no_grad(), matmul_precision("highest"):
        program = torch.export.export(_Serving(model, build_serving_fn(model, no_objects, no_points, **serving_kwargs)),
                                      args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob):
    """The callable ``(img, keypoints3d, camera) -> poses`` of an artifact of :func:`export_inference`, run without
    gradients and with TF32 off."""
    module = torch.export.load(io.BytesIO(bytes(blob))).module()

    def call(img, keypoints3d, camera):
        with torch.no_grad(), matmul_precision("highest"):
            return module(img, keypoints3d, camera)

    return call
