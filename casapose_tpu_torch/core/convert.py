"""Weight bridge, both ways: the JAX package's flax variables <-> the port's state_dict.

Takes ``{params, batch_stats}`` flattened to numpy arrays keyed by
``"collection/module/.../leaf"`` (the format of
``casapose_tpu/core/checkpoint.py::flatten_params``). The port's module
names are the flax names, so a key maps by joining the path with dots and
renaming the leaf:

  params/.../kernel     -> .../weight  (conv HWIO -> OIHW, dense transposed)
  params/.../scale      -> .../weight
  params/.../bias       -> .../bias
  params/.../gamma|beta -> .../gamma|beta   (CLADE, unchanged)
  params/.../alpha_1|2  -> .../alpha_1|2     (CLADE with input, learned blend)
  batch_stats/.../mean  -> .../running_mean
  batch_stats/.../var   -> .../running_var

The trainable ``HalfSize`` matrix of ``casapose_c`` is a (1, 1, d, d) HWIO
kernel that the JAX package applies as ``x @ kernel[0, 0]``; the port keeps
it as the equivalent 1x1 convolution weight, so the conv rule maps it.
BatchNorm keeps the reference's eps of 2e-5 in
``casapose_tpu_torch/models/layers.py``. :func:`to_jax_variables` is the
inverse: a 1-D ``weight`` is a BatchNorm scale, any other a kernel.
"""

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("params", "gamma"): "gamma",
    ("params", "beta"): "beta",
    ("params", "alpha_1"): "alpha_1",
    ("params", "alpha_2"): "alpha_2",
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


_INVERSE = {name: key for key, name in _LEAVES.items() if name != "weight"}


def to_jax_variables(state_dict):
    """The inverse of :func:`from_jax_variables`: a state_dict -> ``{"params/...": array, "batch_stats/...": array}``.

    Arrays are float32 numpy in the JAX layout (conv OIHW -> HWIO, dense
    transposed).
    """
    out = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight" and arr.ndim == 1:
            collection, jax_leaf = "params", "scale"
        elif (leaf, arr.ndim) == ("weight", 4):
            collection, jax_leaf, arr = "params", "kernel", arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif (leaf, arr.ndim) == ("weight", 2):
            collection, jax_leaf, arr = "params", "kernel", arr.T
        elif leaf in _INVERSE:
            collection, jax_leaf = _INVERSE[leaf]
        else:
            raise KeyError(f"no flax name for state_dict entry `{name}`")
        out["/".join([collection, *path, jax_leaf])] = np.ascontiguousarray(arr)
    return out
