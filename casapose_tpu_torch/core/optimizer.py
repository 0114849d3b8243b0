"""Adam with the reference's (tf.keras legacy) update rule: ``AdamTF``.

Counterpart of ``casapose_tpu/core/optimizer.py::adam_tf``. It differs from
``torch.optim.Adam`` in three ways, each of which moves the first steps:

  * the bias correction is folded into the step size,
    ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``;
  * eps (1e-7) is added to the *uncorrected* ``sqrt(v)``:
    ``p -= lr_t * m / (sqrt(v) + eps)``;
  * a schedule is called with the step count *before* the increment (TF
    evaluates it at ``optimizer.iterations``, 0 during the first update).

Every parameter is updated at every step, with a zero gradient where it has
none, as the JAX transform updates every leaf of the tree.
"""

import torch


class AdamTF(torch.optim.Optimizer):
    """tf.keras legacy Adam.

    Args:
      params: parameters or parameter groups.
      lr: a float, or a schedule ``lr(count) -> float`` of the int step count.
      betas, eps: as the reference's defaults (0.9, 0.999), 1e-7.

    The step count lives in each parameter group (``count``), so
    ``state_dict`` carries it; a schedule is kept outside the groups and is
    not saved: the caller builds it again, as the JAX trainer does.
    """

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-7):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, {"lr": 0.0 if callable(lr) else float(lr), "betas": betas, "eps": eps, "count": 0})

    def learning_rate(self, count=None):
        """The learning rate at ``count`` (default: the next update's count), as a float."""
        group = self.param_groups[0]
        if self.schedule is None:
            return float(group["lr"])
        return float(self.schedule(group["count"] if count is None else count))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps = group["eps"]
            lr = group["lr"] if self.schedule is None else self.schedule(group["count"])
            group["count"] += 1
            # A float32 scalar, in the JAX transform's order of operations; copied once per device.
            t = torch.tensor(float(group["count"]), dtype=torch.float32)
            neg_lr_t = -(torch.tensor(float(lr), dtype=torch.float32) * torch.sqrt(1.0 - b2**t) / (1.0 - b1**t))
            on_device = {}
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.copy_(b1 * mu + (1.0 - b1) * g)
                nu.copy_(b2 * nu + (1.0 - b2) * (g * g))
                if p.device not in on_device:
                    on_device[p.device] = neg_lr_t.to(p.device, non_blocking=True)
                p.add_(on_device[p.device] * mu / (torch.sqrt(nu) + eps))
        return loss
