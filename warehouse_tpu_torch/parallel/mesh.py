"""The data mesh (counterpart of ``warehouse_tpu/parallel/mesh.py``).

The JAX package shards the env batch over the ``data`` axis of a device
mesh, replicates the params, and ``pmean``s the gradient once per
minibatch. Here the ``data`` axis is the world of a ``torch.distributed``
group, one rank per card: ``DataMesh`` names the group, this rank, the
world and the rank's device, and carries the collectives the trainers
take. The env batch of ``num_envs`` rows is cut into ``world`` equal
blocks, rank ``r`` holding rows ``[r b, (r + 1) b)``; the params and the
optimizer state are the same on every rank, kept so by averaging each
minibatch's gradient over the ranks before the step.

The average is ``pmean``'s: the sum over the ranks (``all_reduce``), then
a division by the world. With two ranks the sum is the same in either
order; with more, the backend's order holds and each element's sum reaches
every rank alike, so the ranks stay bit-identical. The model axis is 1
(``make_mesh(model_parallel > 1)`` raises).

The ``(pop, data)`` mesh of the sweeps and PBT (``make_pop_mesh``,
``PopMesh``) lays the ranks out as JAX's ``reshape(pop, n // pop)``: rank
``r`` is slice ``r // data`` at data index ``r % data``. Each slice is a
``DataMesh`` of its own group (every rank forms every slice's group, in
slice order), which the meshed trainers take unchanged; a population
member or a sweep seed lives on one slice, its envs sharded over the
slice's data ranks. Between slices there is no collective but the ones the
callers ask for: the metrics gathered over the slices, and a member's state
copied from one slice to another, rank ``(s, d)`` to rank ``(s', d)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
POP_AXIS = "pop"  # population axis (PBT members / sweep seed replicas)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data mesh. ``group`` None is the default
    group."""
    group: object
    rank: int
    world: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world, MODEL_AXIS: 1}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row batch."""
        if n % self.world:
            raise ValueError(f"{n} rows not divisible by {self.world} shards")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def mean_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the ranks in place (the sum, then the
        division by the world), one ``all_reduce``; returns ``x``."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x.div_(self.world)

    def mean(self, tensors: list) -> list:
        """The float tensors ``tensors`` each averaged over the ranks in one
        ``all_reduce`` of their concatenation (summed in float32)."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        self.mean_(flat)
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
            off += t.numel()
        return out

    def mean_grads(self, grads: dict, row: list):
        """A step's gradient dict and its loss row averaged over the ranks
        in one ``all_reduce``: ``(grads, row)`` (the JAX scaffold's
        ``pmean`` of the grads, the loss and its aux terms)."""
        keys = list(grads)
        out = self.mean([grads[k] for k in keys] + list(row))
        return dict(zip(keys, out[:len(keys)])), out[len(keys):]

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (the same shape on each), in rank order, on
        ``x``'s device. Bool and bfloat16 tensors travel as their bits."""
        src = x.contiguous()
        bits = {torch.bool: torch.uint8, torch.bfloat16: torch.int16}.get(
            src.dtype)
        if bits is not None:
            src = src.view(bits)
        # gloo gathers host tensors only, NCCL the card's.
        buf = src.cpu() if self.backend == "gloo" else src.to(self.device)
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf, group=self.group)
        return [o.to(x.device).view(x.dtype) for o in out]


def make_mesh(group=None, model_parallel: int = 1, device=None) -> DataMesh:
    """The data mesh over the ranks of ``group`` (the default group when
    None, which must be formed: ``distributed.maybe_initialize_distributed``
    or ``process_group``). ``device``: this rank's, by default the current
    card under NCCL and the CPU under gloo."""
    if model_parallel != 1:
        raise ValueError(f"model={model_parallel}: the port's mesh has a "
                         "data axis only (model = 1)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is formed")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return DataMesh(group=group, rank=dist.get_rank(group),
                    world=dist.get_world_size(group),
                    device=torch.device(device))


def pop_layout(world: int, pop_shards: int) -> list:
    """The ranks of each slice of a ``(pop, data)`` mesh over ``world``
    ranks, as JAX's ``reshape(pop, world // pop)`` lays out its devices:
    slice ``s`` holds ranks ``[s d, (s + 1) d)``, ``d = world // pop``.
    ``ValueError`` where ``pop_shards`` does not divide ``world``."""
    if pop_shards < 1 or world % pop_shards:
        raise ValueError(f"{world} ranks not divisible by pop={pop_shards}")
    d = world // pop_shards
    return [list(range(s * d, (s + 1) * d)) for s in range(pop_shards)]


@dataclasses.dataclass(frozen=True)
class PopMesh:
    """One rank's view of a ``(pop, data)`` mesh: ``whole``, the mesh's
    ranks as one ``DataMesh`` (its rank this rank's index in ``ranks``, the
    global ranks in mesh order); ``data``, this rank's slice, the
    ``DataMesh`` of its data ranks' group; ``pop``, the number of slices."""
    whole: DataMesh
    data: DataMesh
    pop: int
    ranks: tuple

    @property
    def shape(self) -> dict:
        return {POP_AXIS: self.pop, DATA_AXIS: self.data.world}

    @property
    def rank(self) -> int:
        return self.whole.rank

    @property
    def slice(self) -> int:
        """This rank's slice: the population members or sweep seeds it
        holds."""
        return self.whole.rank // self.data.world

    @property
    def device(self) -> torch.device:
        return self.whole.device

    def gather_slices(self, x: torch.Tensor) -> list:
        """Every slice's ``x``, in slice order (a collective over the mesh):
        the value of each slice's first data rank, which its data ranks hold
        alike where they agree."""
        out = self.whole.all_gather(x)
        return out[::self.data.world]

    def copy_tree(self, tree, src: int, dst: int):
        """Slice ``src``'s ``tree`` copied bit for bit to slice ``dst``, rank
        ``(src, d)`` to rank ``(dst, d)`` for each data index ``d`` (the
        slices hold the same shard ``d`` of what they carry): returns the
        received copy on a rank of ``dst``, whose ``tree`` gives its
        structure and shapes, else ``tree``. Every rank of the mesh makes
        the same calls in the same order; the ranks of the two slices send
        and receive one buffer each (its leaves' bytes), the others do
        nothing."""
        s, d = self.slice, self.data.rank
        if src == dst or s not in (src, dst):
            return tree
        leaves = []
        _tree_map(lambda x: leaves.append(x) or x, tree)
        sizes = [x.numel() * x.element_size() for x in leaves]
        # gloo moves host tensors, NCCL the card's.
        dev = (torch.device("cpu") if self.whole.backend == "gloo"
               else self.device)
        peer = self.ranks[(dst if s == src else src) * self.data.world + d]
        if s == src:
            buf = torch.cat([x.detach().contiguous().reshape(-1)
                             .view(torch.uint8).to(dev) for x in leaves])
            dist.send(buf, peer)
            return tree
        buf = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
        dist.recv(buf, peer)
        parts = iter(torch.split(buf, sizes))
        return _tree_map(lambda x: next(parts).clone().view(x.dtype)
                         .view(x.shape).to(x.device), tree)


def make_pop_mesh(pop_shards: int, group=None, device=None) -> PopMesh:
    """The ``(pop, data)`` mesh over the ranks of ``group`` (the default
    group when None, which must be formed), ``pop_shards`` slices of
    ``world // pop_shards`` data ranks each (``pop_layout``): one
    ``torch.distributed`` group per slice, which every rank forms, slice
    after slice. ``device``: this rank's, as ``make_mesh`` picks it. Either
    axis may be 1: a slice of one rank is a world-1 data mesh."""
    whole = make_mesh(group, device=device)
    ranks = tuple(dist.get_process_group_ranks(group)
                  if group is not None else range(whole.world))
    layout = pop_layout(whole.world, pop_shards)
    mine = None
    for members in layout:
        g = dist.new_group([ranks[r] for r in members])
        if whole.rank in members:
            mine = DataMesh(group=g, rank=members.index(whole.rank),
                            world=len(members), device=whole.device)
    return PopMesh(whole=whole, data=mine, pop=pop_shards, ranks=ranks)


class Sharding(NamedTuple):
    """How a leaf lies on the mesh: ``spec`` ``(DATA_AXIS,)`` for the
    leading axis cut over the ranks, ``()`` for a copy on every rank."""
    mesh: DataMesh
    spec: tuple


def data_sharding(mesh: DataMesh) -> Sharding:
    """Leading-axis batch sharding over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: DataMesh) -> Sharding:
    return Sharding(mesh, ())


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, tuples, named tuples and
    dataclasses (an ``EnvState``)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: DataMesh, tree):
    """This rank's rows ``[rank b, (rank + 1) b)`` of the leading axis of
    every tensor of ``tree``."""
    return _tree_map(lambda x: x[mesh.rows(x.shape[0])], tree)


def gather_batch(mesh: DataMesh, tree):
    """The inverse of ``shard_batch``: every tensor of ``tree`` with the
    ranks' rows joined in rank order (a collective: every rank calls it)."""
    return _tree_map(lambda x: torch.cat(mesh.all_gather(x)), tree)
