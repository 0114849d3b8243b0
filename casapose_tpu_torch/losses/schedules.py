"""Learning-rate schedules and the loss-weight handler.

Counterpart of ``casapose_tpu/losses/schedules.py``, as plain functions of an
int step that return float32 numbers, computed in float32 in the JAX
functions' order of operations (the optax / jnp versions are float32):

  * ``lr_epochs_steps`` set: a piecewise-constant schedule with boundaries
    at ``e * batches - 1``, where a boundary's scale applies once
    ``count >= boundary`` (``optax.piecewise_constant_schedule``'s rule);
  * otherwise the late-start exponential decay, whose exponent gets +1 the
    moment the decay starts when the start is not 0 (the reference's
    ``ExponentialDecayLateStart``).

The piecewise schedule equals the JAX one bit for bit; the exponential one
has the same exponent at every step and its value within one ulp.
"""

import numpy as np

from casapose_tpu_torch.losses.losses import LossWeights


def exponential_decay_late_start(initial_learning_rate, decay_steps, decay_steps_start, decay_rate, staircase=True):
    """lr(step) = lr0 * rate ** p, p = 0 before the start, else offset + (step - start) / decay_steps (floored)."""
    offset = np.float32(0.0 if decay_steps_start == 0 else 1.0)

    def schedule(step):
        if step < decay_steps_start:
            p = np.float32(0.0)
        else:
            p = offset + np.float32(step - decay_steps_start) / np.float32(decay_steps)
        if staircase:
            p = np.floor(p)
        # The power rounded once from float64: within one ulp of XLA's float32 pow (the two libraries' roundings
        # differ on about 1 argument in 1000), and subnormal results flushed to 0 as XLA flushes them.
        power = np.float32(np.float64(np.float32(decay_rate)) ** np.float64(p))
        if abs(power) < np.finfo(np.float32).tiny:
            power = np.float32(0.0)
        return np.float32(initial_learning_rate) * power

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales):
    """``init_value`` times the product of the scales whose boundary the count has reached (count >= boundary)."""
    items = sorted(boundaries_and_scales.items())

    def schedule(count):
        v = np.float32(init_value)
        for threshold, scale in items:
            indicator = np.float32(max(0.0, np.sign(threshold - count)))
            v = v * indicator + (np.float32(1.0) - indicator) * np.float32(scale) * v
        return v

    return schedule


def make_lr_schedule(lr, lr_decay, lr_epochs, lr_epochs_start, lr_epochs_steps, train_batches):
    """Config -> schedule (train_casapose.py:334-345 of the reference)."""
    if lr_epochs_steps is not None:
        return piecewise_constant_schedule(lr, {int(e * train_batches - 1): lr_decay for e in lr_epochs_steps})
    return exponential_decay_late_start(lr, decay_steps=train_batches * lr_epochs,
                                        decay_steps_start=train_batches * lr_epochs_start, decay_rate=lr_decay)


class LossWeightHandler:
    """Mutable loss weights with the reference's update / clamp API (the default pipeline never updates them)."""

    def __init__(self, mask_loss_weight=1.0, vertex_loss_weight=0.5, proxy_loss_weight=0.015, kp_loss_weight=0.0,
                 filter_vertex_with_segmentation=False, filter_high_proxy_errors=False, update_rate=1.0,
                 min_weight=0.0001, max_weight=1.0):
        self.mask_loss_weight = mask_loss_weight
        self.vertex_loss_weight = vertex_loss_weight
        self.proxy_loss_weight = proxy_loss_weight
        self.kp_loss_weight = kp_loss_weight
        self.filter_vertex_with_segmentation = filter_vertex_with_segmentation
        self.filter_high_proxy_errors = filter_high_proxy_errors
        self.update_rate = update_rate
        self.min_weight = min_weight
        self.max_weight = max_weight

    def update(self):
        def clamp(w):
            return min(max(w * self.update_rate, self.min_weight), self.max_weight)

        self.mask_loss_weight = clamp(self.mask_loss_weight)
        self.vertex_loss_weight = clamp(self.vertex_loss_weight)
        self.proxy_loss_weight = clamp(self.proxy_loss_weight)
        self.kp_loss_weight = clamp(self.kp_loss_weight)

    def as_loss_weights(self):
        return LossWeights(
            mask_loss_weight=float(self.mask_loss_weight),
            vertex_loss_weight=float(self.vertex_loss_weight),
            proxy_loss_weight=float(self.proxy_loss_weight),
            kp_loss_weight=float(self.kp_loss_weight),
            filter_vertex_with_segmentation=bool(self.filter_vertex_with_segmentation),
            filter_high_proxy_errors=bool(self.filter_high_proxy_errors),
        )

    def print(self):
        print(f"loss weights: mask {self.mask_loss_weight}, vertex {self.vertex_loss_weight}, "
              f"proxy {self.proxy_loss_weight}, keypoint {self.kp_loss_weight}")
