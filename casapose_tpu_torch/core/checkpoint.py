"""Portable weights, Keras ``.h5`` weights, weight surgery and training checkpoints.

Counterpart of ``casapose_tpu/core/checkpoint.py``:

  * ``load_weights_npz`` / ``save_weights_npz``: the JAX package's ``.npz``
    export (one array per flattened flax name, ``params/...`` and
    ``batch_stats/...``), read into and written from the port's module by
    name through the weight bridge of ``core/convert.py``. Like the JAX
    loader (Keras ``load_weights(by_name=True, skip_mismatch=True)``), names
    the model lacks and arrays of another shape are skipped and reported. A
    port-trained model written here loads in the JAX package's
    ``load_weights_npz`` and its eval harness.
  * ``import_keras_h5`` / ``export_keras_h5``: the reference's Keras
    ``save_weights`` files, mapped onto the flax names of
    ``to_jax_variables(model.state_dict())`` exactly as the JAX functions map
    them, so the weight bridge is the only name map. ``h5py`` is imported
    when a function needs it; without it they raise an ImportError that
    names the ``.npz`` route (``python -m casapose_tpu_torch.convert_h5_weights``).
  * ``find_imagenet_h5`` / ``load_imagenet_backbone``: the qubvel ImageNet
    backbone ``.h5``, from ``$CASAPOSE_IMAGENET_H5`` or the Keras cache
    (``~/.keras/models``). The JAX package's download is not copied: where
    neither place holds the file, training starts from random weights, as
    JAX's does offline.
  * the weight surgery (``copy_weights_segmentation``, ``copy_clade_weights``,
    ``copy_weights_vertex``, ``apply_expansion_surgery``) on state_dicts: an
    HWIO kernel's output columns ``[0, 0, :, cols]`` are the OIHW weight's
    rows ``[cols, :, 0, 0]``.
  * ``save_checkpoint`` / ``latest_checkpoint_step`` / ``restore_checkpoint``:
    the train state (model, optimizer, step) as ``torch.save`` under
    ``<path>/step_N/state.pt``, the newest 5 kept: the layout of the JAX
    package's orbax checkpoints, which the card's machine cannot read.
"""

import os
import re
import shutil

import numpy as np
import torch

from casapose_tpu_torch.core.convert import from_jax_variables, to_jax_variables

CHECKPOINT_FILE = "state.pt"


def load_weights_npz(path, model):
    """Load ``path`` into ``model`` in place; returns (number of arrays loaded, skipped keys)."""
    state = model.state_dict()
    loaded, skipped = 0, []
    with np.load(path) as data:
        for key in data.files:
            try:
                ((name, value),) = from_jax_variables({key: data[key]}).items()
            except KeyError:
                skipped.append(key)
                continue
            if name in state and tuple(state[name].shape) == tuple(value.shape):
                with torch.no_grad():
                    state[name].copy_(value)
                loaded += 1
            else:
                skipped.append(key)
    return loaded, skipped


def save_weights_npz(path, model):
    """Write ``model``'s weights and running statistics under the JAX package's ``.npz`` names."""
    np.savez(path, **to_jax_variables(model.state_dict()))


def _steps(path):
    if not os.path.isdir(path):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_") and d.split("_")[1].isdigit())


def save_checkpoint(path, model, optimizer, step, keep=5):
    """Save the train state under ``path/step_<step>`` and keep the newest ``keep`` checkpoints."""
    path = os.path.abspath(path)
    target = os.path.join(path, f"step_{step}")
    os.makedirs(target, exist_ok=True)
    tmp = os.path.join(target, CHECKPOINT_FILE + ".tmp")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, os.path.join(target, CHECKPOINT_FILE))
    for s in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s}"), ignore_errors=True)


def latest_checkpoint_step(path):
    """The newest ``step_N`` under ``path``, or None."""
    steps = _steps(path)
    return steps[-1] if steps else None


def checkpoint_file(path, step):
    """The port's state file of checkpoint ``step`` under ``path`` (None if that step holds none, as orbax's)."""
    f = os.path.join(path, f"step_{step}", CHECKPOINT_FILE)
    return f if os.path.isfile(f) else None


def restore_checkpoint(path, model, optimizer=None, step=None):
    """Load checkpoint ``step`` (default: the newest) into ``model`` (and ``optimizer``) in place.

    Returns the step restored, or None when ``path`` holds no checkpoint.
    Raises ValueError for a ``step_N`` without the port's state file (an
    orbax checkpoint of the JAX package).
    """
    if step is None:
        step = latest_checkpoint_step(path)
        if step is None:
            return None
    f = checkpoint_file(path, step)
    if f is None:
        raise ValueError(f"{os.path.join(path, f'step_{step}')} holds no {CHECKPOINT_FILE}: an orbax checkpoint of the "
                         "JAX package cannot be read here; export it with the JAX package's save_weights_npz and "
                         "load the .npz (--load_h5_weights 1 --load_h5_filename <path without extension>)")
    state = torch.load(f, map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return step


# ------------------------------------------------------------ .h5 import and export

_H5_ROUTE = ("python -m casapose_tpu_torch.convert_h5_weights (or the JAX package's util_scripts/convert_h5_weights.py) "
             "turns an .h5 into the .npz that load_weights_npz reads, on a host with h5py")


def h5py_available():
    """Whether h5py imports (the card's machine has none)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading or writing Keras .h5 weights needs h5py, which is not installed; {_H5_ROUTE}") from e
    return h5py


def _h5_weight_map(h5_path):
    """Flat {group path/weight name: array} of a Keras ``save_weights`` file."""
    h5py = _h5py()
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(h5_path, "r") as f:
        f.visititems(visit)
    return out


def _split_collections(flat):
    """``to_jax_variables``' flat dict -> ({name: array} of params, {name: array} of batch_stats)."""
    params = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("params/")}
    stats = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    return params, stats


def import_keras_h5(h5_path, model, verbose=False):
    """Load a reference Keras ``.h5`` into ``model`` in place; returns (number of arrays loaded, skipped datasets).

    The mapping of ``casapose_tpu/core/checkpoint.py::import_keras_h5``, onto
    the flax names of the model's own weights (``to_jax_variables``):
    backbone layers nested under the backbone group (``model/<layer>/...``)
    go to ``backbone/<layer>``; decoder layers double their name
    (``<layer>/<layer>/<weight>:0``); CLADE's running statistics sit one
    group deeper, under its parameter-free BatchNorm; non-shared partial
    convolutions (``pv_block_N_prepare_conv2d``) store their kernel as
    (ch, 3, 3, dim); the trainable HalfSize wraps an auto-named Conv2D.
    Datasets without a place of the same shape are skipped.
    """
    raw = _h5_weight_map(h5_path)
    params, stats = _split_collections(to_jax_variables(model.state_dict()))

    def owner_of(groups):
        """The Keras layer that owns a dataset: auto-named inner sublayers belong to the enclosing group."""
        owner = groups[-1]
        if owner.split("_")[0] in ("sync", "conv2d", "batch") or owner.startswith(
            ("sync_batch_normalization", "conv2d", "batch_normalization")
        ):
            if len(groups) >= 2:
                owner = groups[-2]
        return owner

    def candidates(layer):
        names = [layer]
        if layer.endswith("_prepare_conv2d"):  # non-shared PartialConvolution
            names.append(layer[: -len("_prepare_conv2d")] + "_conv2d")
        return [n for base in names for n in (base, f"backbone/{base}")]

    loaded, skipped = 0, []
    for key, value in raw.items():
        parts = [p for p in key.split("/") if p]
        wname = parts[-1].split(":")[0]
        groups = parts[:-1]
        if not groups:
            skipped.append(key)
            continue
        placed = False
        for base in candidates(owner_of(groups)):
            if wname == "kernel":
                k = f"{base}/kernel"
                if k in params and params[k].shape == value.shape:
                    params[k] = value
                    placed = True
            elif wname in ("gamma", "beta") or wname.endswith("_gamma") or wname.endswith("_beta"):
                is_gamma = wname.endswith("gamma")
                kbn, kclade = f"{base}/{'scale' if is_gamma else 'bias'}", f"{base}/{'gamma' if is_gamma else 'beta'}"
                if kbn in params and params[kbn].shape == value.shape:
                    params[kbn] = value
                    placed = True
                elif kclade in params and params[kclade].shape == value.shape:
                    params[kclade] = value
                    placed = True
            elif wname in ("moving_mean", "moving_variance"):
                suffix = "mean" if wname == "moving_mean" else "var"
                for k in (f"{base}/{suffix}", f"{base}/bn/{suffix}"):
                    if k in stats and stats[k].shape == value.shape:
                        stats[k] = value
                        placed = True
                        break
            elif wname.endswith("_weights"):  # PartialConvolution, stored (ch, 3, 3, dim)
                k = f"{base}/kernel"
                if k in params and value.ndim == 4:
                    transposed = value.transpose(1, 2, 0, 3)
                    if params[k].shape == transposed.shape:
                        params[k] = transposed
                        placed = True
            elif wname.endswith("_alpha_1") or wname.endswith("_alpha_2"):
                k = f"{base}/alpha_{wname[-1]}"
                if k in params and params[k].shape == value.shape:
                    params[k] = value
                    placed = True
            if placed:
                break
        if placed:
            loaded += 1
        else:
            skipped.append(key)
    if verbose and skipped:
        print(f"import_keras_h5: loaded {loaded}, skipped {len(skipped)}: {skipped[:10]}...")
    flat = {**{f"params/{k}": v for k, v in params.items()}, **{f"batch_stats/{k}": v for k, v in stats.items()}}
    model.load_state_dict(from_jax_variables(flat, model))
    return loaded, skipped


def _backbone_layer_order(layer_names):
    """The qubvel ResNet's layer creation order, the order Keras ``save_weights`` writes the backbone in: bn_data,
    conv0, bn0, the stages (per unit bn1, conv1, bn2, conv2, [bn3, conv3], sc), the final bn1."""

    def key(n):
        if n == "bn_data":
            return (0, 0, 0, 0)
        if n == "conv0":
            return (1, 0, 0, 0)
        if n == "bn0":
            return (2, 0, 0, 0)
        m = re.match(r"stage(\d+)_unit(\d+)_(bn|conv|sc)(\d*)$", n)
        if m:
            s, u, kind, idx = int(m.group(1)), int(m.group(2)), m.group(3), m.group(4)
            return (3, s, u, 99 if kind == "sc" else int(idx) * 2 + (0 if kind == "bn" else 1))
        if n == "bn1":
            return (4, 0, 0, 0)
        return (5, 0, 0, n)  # unknown names after the known groups, by name (deterministic across processes)

    return sorted(layer_names, key=key)


def partial_conv_layer_names(spec):
    """The decoder-2 blocks that the reference builds as non-shared ``PartialConvolution`` layers (h5 group
    ``pv_block_N_prepare_conv2d``, a (ch, 3, 3, dim) ``_weights`` dataset)."""
    return {
        f"pv_block_{i + 6}_conv2d"
        for i, dp in enumerate(getattr(spec, "decoder_params", ()))
        if dp.partial_conv and not dp.reuse_conv
    }


def export_keras_h5(h5_path, model, spec=None, backbone_name="model"):
    """Write ``model``'s weights as a Keras ``save_weights`` ``.h5``: the inverse of :func:`import_keras_h5`.

    The groups and each group's ``weight_names`` order of
    ``casapose_tpu/core/checkpoint.py::export_keras_h5`` (what Keras itself
    writes, so that the reference's ``load_weights(by_name=True)`` assigns
    each weight): the backbone as one sub-Model group, all its trainable
    weights in layer creation order, then all its running statistics; a
    BatchNorm as gamma, beta, moving mean, moving variance; CLADE as beta,
    gamma (alpha_1, alpha_2 for the learned blend), then its inner
    BatchNorm's statistics; non-shared partial convolutions (``spec``, by
    default ``model.spec``, says which) and the shared ``pv_block_X_Y_conv2d``
    as (ch, 3, 3, dim) ``_weights``; the trainable HalfSize as
    ``<group>/conv2d/kernel``.
    """
    h5py = _h5py()
    if spec is None:
        spec = getattr(model, "spec", None)
    partial_layers = partial_conv_layer_names(spec) if spec is not None else set()
    params, stats = _split_collections(to_jax_variables(model.state_dict()))

    def top(k):
        return k.split("/", 1)[0]

    backbone_p = {k.split("/", 1)[1]: v for k, v in params.items() if top(k) == "backbone"}
    backbone_s = {k.split("/", 1)[1]: v for k, v in stats.items() if top(k) == "backbone"}
    decoder_layers = sorted({top(k) for k in params if top(k) != "backbone"})

    groups = []  # (group name, [(dataset path under the group, array), ...])
    if backbone_p:
        bb_layers = _backbone_layer_order(sorted({k.split("/")[0] for k in list(backbone_p) + list(backbone_s)}))
        wlist = []
        for layer in bb_layers:  # trainable, in creation order
            for leaf, keras in (("kernel", "kernel"), ("scale", "gamma"), ("bias", "beta")):
                if f"{layer}/{leaf}" in backbone_p:
                    wlist.append((f"{layer}/{keras}:0", backbone_p[f"{layer}/{leaf}"]))
        for layer in bb_layers:  # then every non-trainable weight, in the same order
            if f"{layer}/mean" in backbone_s:
                wlist.append((f"{layer}/moving_mean:0", backbone_s[f"{layer}/mean"]))
                wlist.append((f"{layer}/moving_variance:0", backbone_s[f"{layer}/var"]))
        groups.append((backbone_name, wlist))

    for layer in decoder_layers:
        p = {k.split("/", 1)[1]: v for k, v in params.items() if top(k) == layer}
        st = {k.split("/", 1)[1]: v for k, v in stats.items() if top(k) == layer}
        shared = re.match(r"pv_block_\d+_\d+_conv2d$", layer) is not None
        if "kernel" in p and (shared or layer in partial_layers):  # PartialConvolution storage: (ch, kh, kw, dim)
            gname = layer if shared else layer.replace("_conv2d", "_prepare_conv2d")
            groups.append((gname, [(f"{gname}_weights:0", p["kernel"].transpose(2, 0, 1, 3))]))
        elif "kernel" in p and layer.startswith("segmentation_"):  # trainable HalfSize: an auto-named Conv2D
            groups.append((layer, [("conv2d/kernel:0", p["kernel"])]))
        elif "kernel" in p:
            groups.append((layer, [("kernel:0", p["kernel"])]))
        elif "gamma" in p:  # CLADE: beta before gamma (creation order)
            wlist = [(f"{layer}_beta:0", p["beta"]), (f"{layer}_gamma:0", p["gamma"])]
            for a in ("alpha_1", "alpha_2"):
                if a in p:
                    wlist.append((f"{layer}_{a}:0", p[a]))
            if "bn/mean" in st:
                wlist.append(("sync_batch_normalization/moving_mean:0", st["bn/mean"]))
                wlist.append(("sync_batch_normalization/moving_variance:0", st["bn/var"]))
            groups.append((layer, wlist))
        elif "scale" in p or "bias" in p:  # BatchNorm
            wlist = [(f"{keras}:0", p[leaf]) for leaf, keras in (("scale", "gamma"), ("bias", "beta")) if leaf in p]
            if "mean" in st:
                wlist += [("moving_mean:0", st["mean"]), ("moving_variance:0", st["var"])]
            groups.append((layer, wlist))
        else:  # other layer kinds: by name
            groups.append((layer, [(f"{k}:0", v) for k, v in sorted(p.items())]
                           + [(f"{k}:0", v) for k, v in sorted(st.items())]))

    os.makedirs(os.path.dirname(os.path.abspath(h5_path)) or ".", exist_ok=True)
    with h5py.File(h5_path, "w") as f:
        str_dt = h5py.special_dtype(vlen=str)
        f.attrs.create("layer_names", [g for g, _ in groups], dtype=str_dt)
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "2.21.0"
        for gname, wlist in groups:
            g = f.create_group(gname)
            names = []
            for rel, arr in wlist:
                # Backbone datasets sit at <sublayer>/<weight>; every other layer prefixes its own name.
                path = rel if gname == backbone_name else f"{gname}/{rel}"
                names.append(path)
                g.create_dataset(path, data=np.asarray(arr, np.float32))
            g.attrs.create("weight_names", names, dtype=str_dt)
    return h5_path


# ------------------------------------------------------------ ImageNet backbone

# The qubvel classification_models ImageNet exports (no top) that the reference loads for its backbone.
IMAGENET_FILES = {name: f"{name}_imagenet_1000_no_top.h5"
                  for name in ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")}


def find_imagenet_h5(base_model):
    """The ImageNet backbone ``.h5`` of ``base_model``: ``$CASAPOSE_IMAGENET_H5``, else the Keras cache
    (``~/.keras/models/<file>``), else None, with a line that says so (nothing is downloaded)."""
    fname = IMAGENET_FILES.get(base_model)
    if fname is None:
        return None
    override = os.environ.get("CASAPOSE_IMAGENET_H5")
    if override and os.path.exists(override):
        return override
    cache = os.path.join(os.path.expanduser("~"), ".keras", "models", fname)
    if os.path.exists(cache):
        return cache
    print(f"imagenet weights unavailable for {base_model}: no file at $CASAPOSE_IMAGENET_H5 or {cache} "
          "(nothing is downloaded)")
    return None


def load_imagenet_backbone(model, base_model="resnet18", path=None, verbose=False):
    """Load a qubvel-format ImageNet ``.h5`` into ``model``'s backbone in place; returns the number of arrays
    loaded (0: nothing was found, the weights are unchanged)."""
    if path is None:
        path = find_imagenet_h5(base_model)
    if path is None:
        return 0
    loaded, _ = import_keras_h5(path, model, verbose=verbose)
    return loaded


# ------------------------------------------------------------ weight surgery


def _numpy(t):
    return t.detach().to("cpu").numpy().copy()


def _like(arr, t):
    return torch.from_numpy(arr).to(device=t.device, dtype=t.dtype)


def copy_weights_segmentation(state, state_backup, range_out, range_in, layer="pv_final_conv_segmentation"):
    """``state`` with the final segmentation conv's output channels ``range_out`` copied from ``range_in`` of
    ``state_backup`` (both state_dicts; the kernel only, as the reference copies it)."""
    k = f"{layer}.weight"
    w = _numpy(state[k])
    w[list(range_out), :, 0, 0] = _numpy(state_backup[k])[list(range_in), :, 0, 0]
    return {**state, k: _like(w, state[k])}


def copy_clade_weights(state, state_backup, range_out, range_in, layer):
    """``state`` with the rows ``range_out`` of CLADE ``layer``'s gamma and beta tables copied from ``range_in``."""
    out = dict(state)
    for wname in ("gamma", "beta"):
        k = f"{layer}.{wname}"
        table = _numpy(state[k])
        table[list(range_out)] = _numpy(state_backup[k])[list(range_in)]
        out[k] = _like(table, state[k])
    return out


def copy_weights_vertex(state, state_backup, ver_dim, layer="pv_final_conv_vertex"):
    """``state`` with the first ``ver_dim`` output channels of the vertex conv copied (to add confidence maps to a
    network trained without them)."""
    k = f"{layer}.weight"
    w = _numpy(state[k])
    w[:ver_dim, :, 0, 0] = _numpy(state_backup[k])[:ver_dim, :, 0, 0]
    return {**state, k: _like(w, state[k])}


def apply_expansion_surgery(state, state_backup, objects_to_copy):
    """The expansion to more objects: the segmentation conv and the five CLADE tables ``pv_block_6..10_clade``,
    per the [n, 2] (from, to) mapping ``objects_to_copy``."""
    range_in = objects_to_copy[:, 0].tolist()
    range_out = objects_to_copy[:, 1].tolist()
    state = copy_weights_segmentation(state, state_backup, range_out, range_in)
    for n in range(6, 11):
        state = copy_clade_weights(state, state_backup, range_out, range_in, f"pv_block_{n}_clade")
    return state
