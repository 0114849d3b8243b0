"""Portable weights: ``load_weights_npz``, counterpart of ``casapose_tpu/core/checkpoint.py``.

Reads the JAX package's ``.npz`` export (``save_weights_npz``: one array per
flattened flax name, ``params/...`` and ``batch_stats/...``) into the port's
module by name, through the weight bridge of ``core/convert.py``. Like the
JAX loader (Keras ``load_weights(by_name=True, skip_mismatch=True)``), names
the model lacks and arrays of another shape are skipped and reported.
``.h5`` import and orbax checkpoints are not ported yet.
"""

import numpy as np
import torch

from casapose_tpu_torch.core.convert import from_jax_variables


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
