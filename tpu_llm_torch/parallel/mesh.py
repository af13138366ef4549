"""Ranks and process groups (``tpu_llm/parallel/mesh.py``).

The JAX package builds a named device mesh that one process drives. The
port runs one process a rank on ``torch.distributed`` (SPMD): every rank
runs the same host loop, and the model calls the collectives itself.
``make_mesh(data, model, pipe=)`` lays the ranks out as a (pipe, data,
model) grid with model innermost (adjacent ranks, the fastest links) and
pipe outermost, as the JAX mesh does, and makes

- one ``model`` group a (pipe, data) index (tensor parallelism: the
  all-reduces after the row-parallel projections, the classifier's vocab
  gather; the sequence axis of ring, Ulysses and sequence parallelism);
- one ``data`` group a (pipe, model) index (data parallelism: the batch
  rows' last hidden states gathered, a slot's prefill logits broadcast
  from its owner);
- one ``pipe`` group a (data, model) index (pipeline stages: the hops of
  the hidden rows from stage to stage, the last stage's broadcast);
- a CPU (gloo) control group over the mesh for host objects (the server's
  per-step plan), which is the world group itself under gloo.

Collectives: sums and maxima (``reduce_model``), tiled gathers, the
reduce-scatter of sequence parallelism, broadcasts, the ring shift
``ppermute``, the tiled ``all_to_all`` and point-to-point ``send`` /
``recv``. Each call adds one to ``counts[kind]`` and its payload's bytes
to ``counts[kind + "_bytes"]`` on the calling rank.

Backends: NCCL when each rank has a GPU of its own; gloo otherwise. On a
machine with fewer GPUs than ranks (one H100 for several ranks) NCCL
refuses two ranks on one device, and gloo runs there: its ``all_reduce``
and ``broadcast`` take CUDA tensors (through host copies), the gathers
are built from one ``all_reduce`` of a zero-filled full-width buffer, the
reduce-scatter from an ``all_reduce`` and a narrow, and the ring shift,
the all-to-all and the point-to-point sends, which gloo takes on CPU
tensors only, copy a CUDA tensor to the host and back (every compute
stays on the card). A gloo group on one card is a correctness path, not
a speed figure. Sums run in f32 whatever the tensor's dtype (a bf16
partial sum is widened, reduced and rounded once).

A 1x1 mesh (``single_device_mesh``) needs no process group: its
collectives return their input.
"""

from __future__ import annotations

import collections
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
    pipe: int = 1
    pipe_group: Any = None        # this rank's pipe group (None: size 1)
    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def shape(self):
        return {"pipe": self.pipe, "data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.pipe * self.data * self.model

    @property
    def member(self) -> bool:
        """False on a world rank the mesh leaves out (a smaller mesh over
        the first ranks of the world)."""
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        return self.ranks.index(self.rank)

    @property
    def pipe_index(self) -> int:
        return self.index // (self.data * self.model)

    @property
    def data_index(self) -> int:
        return self.index // self.model % self.data

    @property
    def model_index(self) -> int:
        return self.index % self.model

    def describe(self) -> str:
        pp = f" pp={self.pipe}" if self.pipe > 1 else ""
        return f"mesh: dp={self.data} tp={self.model}{pp} backend={self.backend}" + (
            " (one card shared by the ranks: a correctness path, not a speed figure)"
            if self.backend == "gloo" and self.device.type == "cuda"
            and torch.cuda.device_count() < self.size else "")

    # -- collectives ---------------------------------------------------------

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.counts[kind + "_bytes"] += x.numel() * x.element_size()

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend takes it for the ring shift, the all-to-all and
        point-to-point: gloo takes those on CPU tensors only."""
        x = x.contiguous()
        return x.cpu() if self.backend == "gloo" and x.is_cuda else x

    def _all_reduce(self, x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
        import torch.distributed as dist

        y = x.float().contiguous()
        if y.data_ptr() == x.data_ptr():
            y = y.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=group)
        return y.to(x.dtype)

    def reduce_model(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or, ``op="max"``, maximum) of the model group's partial
        results (the row-parallel projections), in f32, rounded to x's
        dtype once."""
        if self.model_group is None:
            return x
        self._count("all_reduce", x)
        return self._all_reduce(x, self.model_group, op)

    def reduce_scatter_model(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The model group's sum of ``x`` (in f32, rounded to x's dtype
        once), each rank keeping its 1/tp slice along ``dim`` in rank
        order: sequence parallelism's reduce after wo and w2."""
        import torch.distributed as dist

        if self.model_group is None:
            return x
        self._count("reduce_scatter", x)
        dim = dim % x.dim()
        w = x.shape[dim] // self.model
        if self.backend == "nccl":
            y = x.float().movedim(dim, 0).contiguous()
            out = torch.empty((w,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
            dist.reduce_scatter_tensor(out, y, group=self.model_group)
            return out.movedim(0, dim).to(x.dtype).contiguous()
        # gloo has no CUDA reduce-scatter: an all-reduce and a narrow
        full = self._all_reduce(x, self.model_group)
        return full.narrow(dim, self.model_index * w, w).contiguous()

    def _gather(self, x: torch.Tensor, dim: int, group, n: int, idx: int) -> torch.Tensor:
        import torch.distributed as dist

        self._count("gather", x)
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
        order (the vocab-split classifier's logits; sequence parallelism's
        rows)."""
        if self.model_group is None:
            return x
        return self._gather(x, dim, self.model_group, self.model, self.model_index)

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's batch rows tiled along ``dim``."""
        if self.data_group is None:
            return x
        return self._gather(x, dim, self.data_group, self.data, self.data_index)

    def broadcast(self, x: torch.Tensor, src_index: int, group) -> torch.Tensor:
        """``x`` from the member ``src_index`` of ``group`` to every member,
        in place."""
        import torch.distributed as dist

        if group is None:
            return x
        self._count("broadcast", x)
        x = x.contiguous()
        dist.broadcast(x, dist.get_process_group_ranks(group)[src_index], group=group)
        return x

    def broadcast_data(self, x: torch.Tensor, src_index: int) -> torch.Tensor:
        """``x`` from the data rank ``src_index`` of this rank's data group,
        in place."""
        return self.broadcast(x, src_index, self.data_group)

    def ppermute(self, x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
        """The ring shift over ``group``: ``x`` goes to the member ``shift``
        places on, and the one ``shift`` places back is returned (JAX's
        ``ppermute`` with the permutation [(j, (j + shift) % n)])."""
        import torch.distributed as dist

        if group is None:
            return x
        members = dist.get_process_group_ranks(group)
        n = len(members)
        if shift % n == 0:
            return x
        self._count("ppermute", x)
        i = members.index(self.rank)
        send = self._wire(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, members[(i + shift) % n], group),
               dist.P2POp(dist.irecv, recv, members[(i - shift) % n], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(x.device)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
        """Tiled all-to-all over ``group`` (``jax.lax.all_to_all(...,
        tiled=True)``): ``x`` is cut into n blocks along ``split_dim``, block
        j goes to member j, and the blocks received are tiled along
        ``concat_dim`` in member order."""
        import torch.distributed as dist

        if group is None:
            return x
        n = dist.get_world_size(group)
        sd, cd = split_dim % x.dim(), concat_dim % x.dim()
        if x.shape[sd] % n:
            raise ValueError(f"all_to_all: axis {sd} of {tuple(x.shape)} does not split by {n}")
        self._count("all_to_all", x)
        w = x.shape[sd] // n
        send = self._wire(x.movedim(sd, 0))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        blocks = recv.to(x.device).reshape(n, w, *send.shape[1:]).movedim(1, sd + 1)
        shape = list(x.shape)
        shape[sd] = w
        shape[cd] *= n
        return blocks.movedim(0, cd).reshape(shape)

    def send(self, x: torch.Tensor, dst_index: int, group) -> None:
        """``x`` to the member ``dst_index`` of ``group`` (a pipeline hop)."""
        import torch.distributed as dist

        self._count("send", x)
        dist.send(self._wire(x), dist.get_process_group_ranks(group)[dst_index], group=group)

    def recv(self, shape, dtype, src_index: int, group) -> torch.Tensor:
        """A tensor of ``shape`` / ``dtype`` from the member ``src_index`` of
        ``group``, on this rank's device."""
        import torch.distributed as dist

        wire = "cpu" if self.backend == "gloo" else self.device
        buf = torch.empty(tuple(shape), dtype=dtype, device=wire)
        dist.recv(buf, dist.get_process_group_ranks(group)[src_index], group=group)
        self._count("recv", buf)
        return buf.to(self.device)

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


def make_mesh(data: int = 1, model: Optional[int] = None, *, pipe: int = 1,
              device: str = "cuda", ranks: Optional[List[int]] = None) -> Mesh:
    """A (pipe, data, model) grid over ``ranks`` (default: the first pipe *
    data * model ranks of the world), model innermost, pipe outermost.
    ``model`` defaults to the world size over pipe * data. Every rank of
    the world must call it with the same arguments (a process group is
    made collectively)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if model is None:
        model = max(1, world // (data * pipe))
    n = pipe * data * model
    if n > world:
        raise ValueError(f"mesh {pipe}x{data}x{model} exceeds {world} ranks (the world)")
    ranks = list(ranks if ranks is not None else range(n))
    if len(ranks) != n:
        raise ValueError(f"mesh {pipe}x{data}x{model} over {len(ranks)} ranks")
    dev = rank_device(device, rank)
    if n == 1:
        return Mesh(data, model, rank, dev, "none", ranks=ranks)
    backend = dist.get_backend()
    mesh = Mesh(data, model, rank, dev, backend, ranks=ranks, pipe=pipe)

    def at(p, d, m):
        return ranks[(p * data + d) * model + m]

    def group(members, size):
        g = dist.new_group(members) if size > 1 else None
        return g if rank in members else False

    axes = (("model_group", model, lambda p, d, i: at(p, d, i), (pipe, data)),
            ("data_group", data, lambda p, m, i: at(p, i, m), (pipe, model)),
            ("pipe_group", pipe, lambda d, m, i: at(i, d, m), (data, model)))
    for attr, size, member, (na, nb) in axes:
        for a in range(na):
            for b in range(nb):
                g = group([member(a, b, i) for i in range(size)], size)
                if g is not False:
                    setattr(mesh, attr, g)
    mesh.ctrl_group = dist.new_group(ranks, backend="gloo") \
        if backend != "gloo" or n != world else None
    return mesh


def single_device_mesh(device: str = "cuda") -> Mesh:
    return make_mesh(1, 1, device=device)
