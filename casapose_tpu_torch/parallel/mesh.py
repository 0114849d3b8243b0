"""Data parallelism over cards: counterpart of ``casapose_tpu/parallel/mesh.py``.

The JAX trainer jits its step over a (data, model) mesh with the batch
sharded on ``data``, and GSPMD inserts the collectives: the gradient mean,
BatchNorm moments of the global batch, the global sums of the losses. The
port runs one process per card (``torchrun``) and makes each of those
reductions itself:

  * the gradient mean: ``DistributedDataParallel`` (``train.py``);
  * BatchNorm moments of the global batch: ``models/layers.py::BatchNorm``
    all-reduces its per-channel sums (:func:`sync_batchnorm`);
  * the keypoint loss's count of available objects, the logged losses and
    the pose-validation sums: :func:`all_reduce_sum` / :func:`all_reduce_mean`.

``--batchsize`` is the global batch, as in JAX; each rank feeds its own
equal rows of it (:meth:`DataParallel.rows`), so that every mean over
images is a mean over the global batch. The loaders of all ranks share one
seed, so each decodes only its rows of the same global batch.

Not ported: ``spatial_sharding`` (one image's rows over the ``model`` axis,
with halo exchange), which serves latency-bound inference, not training.
"""

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel process group."""

    rank: int
    world_size: int
    device: torch.device  # cuda:LOCAL_RANK on cards

    def rows(self, global_batch):
        """The slice of a global batch of ``global_batch`` images that this rank feeds."""
        if global_batch % self.world_size:
            raise ValueError(f"--batchsize {global_batch} is the global batch and must divide by the {self.world_size} "
                             "ranks: each rank feeds equal rows, so that every mean over images is the global one")
        n = global_batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


def init_data_parallel(device="cuda", rank=None, world_size=None, local_rank=None, init_method="env://"):
    """Join a process group and return this rank's :class:`DataParallel`.

    Rank, world size and local rank default to ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; the store's address from
    ``MASTER_ADDR``/``MASTER_PORT`` under ``env://``). On cards the backend is
    NCCL and the device ``cuda:LOCAL_RANK``; on the CPU it is gloo.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init_method, rank=rank,
                                world_size=world_size)
    return DataParallel(rank=rank, world_size=world_size, device=dev)


def shutdown():
    """Leave the process group (after every rank's last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its gradient is the sum over the ranks of the gradients (each rank's loss depends on
    every rank's input through the sum). ``torch.distributed.nn.functional.all_reduce`` computes the same, but
    PyTorch 2.13 deprecates it (a FutureWarning on each call) for ``_functional_collectives``, whose gradient
    support differs between versions; these dozen lines behave alike in each."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x, dp):
    """The sum of ``x`` over the ranks of ``dp``, differentiable; ``x`` itself without a group of several ranks."""
    if dp is None or dp.world_size == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_mean(x, dp):
    """The mean of ``x`` over the ranks of ``dp`` (for the logged losses); ``x`` itself on one rank."""
    if dp is None or dp.world_size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out)
    return out / dp.world_size


def sync_batchnorm(model, dp):
    """Let every BatchNorm of ``model`` take its training statistics over the global batch of ``dp``'s ranks."""
    from casapose_tpu_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_parallel = dp if dp is not None and dp.world_size > 1 else None
    return model
