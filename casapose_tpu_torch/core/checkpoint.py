"""Portable weights and training checkpoints.

Counterpart of ``casapose_tpu/core/checkpoint.py``:

  * ``load_weights_npz`` / ``save_weights_npz``: the JAX package's ``.npz``
    export (one array per flattened flax name, ``params/...`` and
    ``batch_stats/...``), read into and written from the port's module by
    name through the weight bridge of ``core/convert.py``. Like the JAX
    loader (Keras ``load_weights(by_name=True, skip_mismatch=True)``), names
    the model lacks and arrays of another shape are skipped and reported. A
    port-trained model written here loads in the JAX package's
    ``load_weights_npz`` and its eval harness.
  * ``save_checkpoint`` / ``latest_checkpoint_step`` / ``restore_checkpoint``:
    the train state (model, optimizer, step) as ``torch.save`` under
    ``<path>/step_N/state.pt``, the newest 5 kept: the layout of the JAX
    package's orbax checkpoints, which the card's machine cannot read.

``.h5`` import and export are not ported (``util_scripts/convert_h5_weights.py``
turns an ``.h5`` into the ``.npz`` on a host with JAX and h5py).
"""

import os
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
