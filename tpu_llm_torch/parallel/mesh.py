"""Ranks and process groups (``tpu_llm/parallel/mesh.py``).

The JAX package builds a named device mesh that one process drives. The
port runs one process a rank on ``torch.distributed`` (SPMD): every rank
runs the same host loop, and the model calls the collectives itself.
``make_mesh(data, model)`` lays the ranks out as a (data, model) grid with
model innermost (adjacent ranks, the fastest links), as the JAX mesh
does, and makes

- one ``model`` group a data index (tensor parallelism: the all-reduces
  after the row-parallel projections, the classifier's vocab gather);
- one ``data`` group a model index (data parallelism: the batch rows'
  last hidden states gathered, a slot's prefill logits broadcast from its
  owner);
- a CPU (gloo) control group over the mesh for host objects (the server's
  per-step plan), which is the world group itself under gloo.

Backends: NCCL when each rank has a GPU of its own; gloo otherwise. On a
machine with fewer GPUs than ranks (one H100 for two ranks) NCCL refuses
two ranks on one device, and gloo runs there: its ``all_reduce`` and
``broadcast`` take CUDA tensors (through host copies), and the gathers
are built from one ``all_reduce`` of a zero-filled full-width buffer. A
gloo group on one card is a correctness path, not a speed figure.
Sums run in f32 whatever the tensor's dtype (a bf16 partial sum is
widened, reduced and rounded once).

A 1x1 mesh (``single_device_mesh``) needs no process group: its
collectives return their input.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional

import torch


def device_count(device_type: str) -> int:
    """The devices ranks can be laid over: the visible GPUs, or the one CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def rank_device(device_type: str, rank: int) -> torch.device:
    """This rank's device: ``cuda:{local rank % GPUs}`` on the card, the CPU
    only when asked."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


@dataclasses.dataclass
class Mesh:
    data: int
    model: int
    rank: int                     # this process's rank in the world
    device: torch.device
    backend: str                  # "nccl", "gloo", or "none" (1x1)
    model_group: Any = None       # this rank's model group (None: size 1)
    data_group: Any = None        # this rank's data group (None: size 1)
    ctrl_group: Any = None        # CPU control group over the mesh's ranks
    ranks: List[int] = dataclasses.field(default_factory=list)

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def member(self) -> bool:
        """False on a world rank the mesh leaves out (a smaller mesh over
        the first ranks of the world)."""
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def data_index(self) -> int:
        return self.index // self.model

    @property
    def model_index(self) -> int:
        return self.index % self.model

    def describe(self) -> str:
        return f"mesh: dp={self.data} tp={self.model} backend={self.backend}" + (
            " (one card shared by the ranks: a correctness path, not a speed figure)"
            if self.backend == "gloo" and self.device.type == "cuda"
            and torch.cuda.device_count() < self.size else "")

    # -- collectives ---------------------------------------------------------

    def _all_reduce(self, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        y = x.float().contiguous()
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    def reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the model group's partial results (the row-parallel
        projections), in f32, rounded to x's dtype once."""
        if self.model_group is None:
            return x
        return self._all_reduce(x, self.model_group)

    def _gather(self, x: torch.Tensor, dim: int, group, n: int, idx: int) -> torch.Tensor:
        import torch.distributed as dist

        dim = dim % x.dim()
        if self.backend == "nccl":
            out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
            return torch.cat(out.unbind(0), dim=dim)
        # gloo takes no CUDA all_gather: one all_reduce of a zero-filled
        # full-width buffer, this rank's slice written in place (x + 0 is x)
        shape = list(x.shape)
        w = shape[dim]
        shape[dim] = w * n
        full = torch.zeros(shape, dtype=x.dtype, device=x.device)
        full.narrow(dim, idx * w, w).copy_(x)
        dist.all_reduce(full, group=group)
        return full

    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model group's shards of ``x`` tiled along ``dim`` in rank
        order (the vocab-split classifier's logits)."""
        if self.model_group is None:
            return x
        return self._gather(x, dim, self.model_group, self.model, self.model_index)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's batch rows tiled along ``dim``."""
        if self.data_group is None:
            return x
        return self._gather(x, dim, self.data_group, self.data, self.data_index)

    def broadcast_data(self, x: torch.Tensor, src_index: int) -> torch.Tensor:
        """``x`` from the data rank ``src_index`` of this rank's data group,
        in place."""
        import torch.distributed as dist

        if self.data_group is None:
            return x
        src = self.ranks[src_index * self.model + self.model_index]
        x = x.contiguous()
        dist.broadcast(x, src, group=self.data_group)
        return x

    def broadcast_object(self, obj=None):
        """A picklable host object from the mesh's first rank to every rank
        (on the CPU control group)."""
        import torch.distributed as dist

        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.ctrl_group)
        return box[0]

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.size > 1:
            dist.barrier(group=self.ctrl_group)


def make_mesh(data: int = 1, model: Optional[int] = None, device: str = "cuda",
              ranks: Optional[List[int]] = None) -> Mesh:
    """A (data, model) grid over ``ranks`` (default: the first data * model
    ranks of the world), model innermost. ``model`` defaults to the world
    size over ``data``. Every rank of the world must call it with the same
    arguments (a process group is made collectively)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model is None:
        model = max(1, world // data)
    n = data * model
    if n > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} ranks (the world)")
    ranks = list(ranks if ranks is not None else range(n))
    if len(ranks) != n:
        raise ValueError(f"mesh {data}x{model} over {len(ranks)} ranks")
    dev = rank_device(device, rank)
    if n == 1:
        return Mesh(data, model, rank, dev, "none", ranks=ranks)
    backend = dist.get_backend()
    mesh = Mesh(data, model, rank, dev, backend, ranks=ranks)
    grid = [ranks[d * model:(d + 1) * model] for d in range(data)]
    for d in range(data):                        # the model groups
        g = dist.new_group(grid[d]) if model > 1 else None
        if rank in grid[d]:
            mesh.model_group = g
    for m in range(model):                       # the data groups
        members = [grid[d][m] for d in range(data)]
        g = dist.new_group(members) if data > 1 else None
        if rank in members:
            mesh.data_group = g
    mesh.ctrl_group = dist.new_group(ranks, backend="gloo") \
        if backend != "gloo" or n != world else None
    return mesh


def single_device_mesh(device: str = "cuda") -> Mesh:
    return make_mesh(1, 1, device=device)
