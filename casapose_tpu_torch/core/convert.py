"""Weight bridge: the JAX package's flax variables -> the port's state_dict.

Takes ``{params, batch_stats}`` flattened to numpy arrays keyed by
``"collection/module/.../leaf"`` (the format of
``casapose_tpu/core/checkpoint.py::flatten_params``). The port's module
names are the flax names, so a key maps by joining the path with dots and
renaming the leaf:

  params/.../kernel     -> .../weight  (conv HWIO -> OIHW, dense transposed)
  params/.../scale      -> .../weight
  params/.../bias       -> .../bias
  params/.../gamma|beta -> .../gamma|beta   (CLADE, unchanged)
  batch_stats/.../mean  -> .../running_mean
  batch_stats/.../var   -> .../running_var

BatchNorm keeps the reference's eps of 2e-5 in
``casapose_tpu_torch/models/layers.py``.
"""

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "gamma"): "gamma",
    ("params", "beta"): "beta",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _convert_array(leaf, arr):
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T  # dense [in, out] -> [out, in]
    return arr


def from_jax_variables(flat, model=None):
    """Build a state_dict from flattened flax variables.

    Args:
      flat: ``{"params/...": np.ndarray, "batch_stats/...": np.ndarray}``.
      model: optional module; when given, every one of its state_dict
        entries must be produced, with the same shape, and no key of
        ``flat`` may be left over.
    Raises:
      KeyError on a key whose collection or leaf has no mapping, or, with
      ``model``, on missing or unused keys; ValueError on a shape mismatch.
    """
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        name = _LEAVES.get((parts[0], parts[-1]))
        if name is None or len(parts) < 3:
            raise KeyError(f"no mapping for flax variable `{key}`")
        out[".".join(parts[1:-1] + [name])] = torch.tensor(_convert_array(parts[-1], np.asarray(arr, np.float32)))
    if model is not None:
        expected = model.state_dict()
        missing = sorted(set(expected) - set(out))
        unused = sorted(set(out) - set(expected))
        if missing or unused:
            raise KeyError(f"weight bridge: missing {missing}, unused {unused}")
        for k, v in expected.items():
            if tuple(v.shape) != tuple(out[k].shape):
                raise ValueError(f"weight bridge: `{k}` has shape {tuple(out[k].shape)}, expected {tuple(v.shape)}")
    return out
