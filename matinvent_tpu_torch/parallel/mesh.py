"""Data parallelism on ``torch.distributed`` (``matinvent_tpu/parallel/mesh.py``).

The JAX package's 1-D ``dp`` mesh, in PyTorch's idiom: one process per
card, each a rank of one process group. A ``Mesh`` holds that group, the
world size, this rank and its ``torch.device``. A batch is sharded on its
leading axis as ``PartitionSpec("dp")`` lays rows out, each rank keeping
one contiguous block of equal size; parameters are replicated (broadcast
from rank 0). Where XLA derives the gradient all-reduce from the sharding
annotations, the port's data-parallel steps (``parallel/train.py``) call
``Mesh.all_reduce_`` on their gradients themselves.

Bring-up: ``init_distributed`` joins the process group over ``tcp://``
(``nccl`` on the card, ``gloo`` on the CPU or when asked for, as for two
ranks on one card, which NCCL refuses), after pinning the rank's card.
With no address and a single process it does nothing, as JAX's does.
``gloo`` reduces and broadcasts CUDA tensors but does not gather them:
``Mesh.all_gather_rows`` gathers through host tensors there.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from matinvent_tpu_torch.device import resolve_device

def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> torch.device | None:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port``) as rank ``process_id``, on
    ``cuda:{process_id % device_count}`` (pinned as the current card) or on
    the CPU when ``device`` is ``cpu``; returns that device. Without an
    address it does nothing and returns None (a single process). Joining
    twice with the same world is a no-op."""
    if coordinator_address is None:
        return None
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        # before the first collective: NCCL binds the rank to this card
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise RuntimeError(
                f"already in a process group of {dist.get_world_size()} as rank "
                f"{dist.get_rank()}, asked for {num_processes} as {process_id}")
    else:
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{coordinator_address}", world_size=num_processes,
            rank=process_id,
        )
    return dev


def init_from_env(device: str | torch.device | None = None,
                  backend: str | None = None) -> torch.device | None:
    """``init_distributed`` from ``MATINVENT_COORDINATOR``,
    ``MATINVENT_NUM_PROCESSES`` (1) and ``MATINVENT_PROCESS_ID`` (0), as the
    entry point reads them; None when no coordinator is set."""
    if not os.environ.get("MATINVENT_COORDINATOR"):
        return None
    return init_distributed(
        coordinator_address=os.environ["MATINVENT_COORDINATOR"],
        num_processes=int(os.environ.get("MATINVENT_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("MATINVENT_PROCESS_ID", "0")),
        device=device, backend=backend,
    )


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``size`` ranks of ``group`` (None for a
    single process), this ``rank`` and its ``device``."""

    size: int
    rank: int
    device: torch.device
    group: Any = None

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks: "
                             "pad to a multiple (pad_to_multiple)")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def all_reduce_(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``tensor`` reduced over the ranks in place (``sum`` or ``max``)."""
        if self.size > 1:
            dist.all_reduce(tensor, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                            group=self.group)
        return tensor

    def all_reduce_grads_(self, params, extra: torch.Tensor | None = None) -> torch.Tensor | None:
        """The gradients of ``params`` summed over the ranks, in one
        collective that also sums the 1-D ``extra`` (returned summed, or as
        it is on one rank)."""
        grads = [p.grad for p in params if p.grad is not None]
        if self.size == 1 or not (grads or extra is not None):
            return extra
        parts = [g.reshape(-1) for g in grads] + ([] if extra is None else [extra.reshape(-1)])
        flat = self.all_reduce_(torch.cat(parts))
        off = 0
        for g in grads:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()
        return None if extra is None else flat[off:]

    def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
        """The ranks' ``tensor``s (of one shape: ``rows`` splits evenly)
        concatenated in rank order on their leading axis."""
        if self.size == 1:
            return tensor
        host = tensor.is_cuda and dist.get_backend(self.group) == "gloo"
        x = (tensor.cpu() if host else tensor).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts)
        return out.to(tensor.device) if host else out


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """The mesh of every rank of the process group (one card each), or of
    this process alone outside one; ``n_devices``, when given, must be that
    size. The device is ``device``, the card unless the CPU is asked for:
    the current card (the one ``init_distributed`` pinned) when no index
    is given."""
    if dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh spans every rank: {size}, not {n_devices} "
                         "(one process per card)")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(size=size, rank=rank, device=dev, group=group)


def batch_sharding(mesh: Mesh) -> Mesh:
    """Leading-axis sharding for batched tensors: the mesh itself, whose
    ``rows`` give each rank's block."""
    return mesh


def _map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init})
    return tree


def replicate(tree, mesh: Mesh):
    """Every parameter and buffer of a module (or tensor of a tree) set to
    rank 0's, in place; returns ``tree``."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []
        _map(lambda t: tensors.append(t) if isinstance(t, torch.Tensor) else None, tree)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0, group=mesh.group)
    return tree


def shard_batch(tree, mesh: Mesh):
    """Every leaf of a batch tree (tensors, arrays; dicts, lists, named
    tuples and dataclasses of them) cut to this rank's rows of its leading
    axis, tensors moved to the mesh's device."""
    def cut(x):
        x = x[mesh.rows(x.shape[0])]
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    return _map(cut, tree)


def gather_batch(tree, mesh: Mesh):
    """The inverse of ``shard_batch`` for tensor leaves: the ranks' rows
    concatenated in rank order."""
    return _map(lambda x: mesh.all_gather_rows(x) if isinstance(x, torch.Tensor) else x, tree)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
