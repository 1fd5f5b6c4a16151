"""A mesh with named axes over the ranks of one ``torch.distributed`` job,
and the mesh context (port of ``repro.sharding.ctx``).

JAX places arrays on a ``jax.sharding.Mesh`` of devices and lets GSPMD
insert the collectives.  The port runs one process per rank, and the
ranks are the mesh: :class:`Mesh` wraps a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
gives each named axis its process group and this rank's coordinate on
it, and runs the collectives the sharded train step, GPipe and the
gradient compression need, explicitly.  Every collective counts one
(``collective_count``), and its bytes are tallied (``wire_bytes``).

On the card the ranks are gloo ranks sharing the device (NCCL refuses two
ranks on one device), and gloo runs its collectives on host buffers: a
CUDA tensor is copied through pinned host memory before the collective
and back after it, explicitly, for every collective alike (gloo's own
CUDA support covers some collectives and not its point-to-point ops).

``Mesh.abstract`` builds a mesh from axis sizes alone, with no process
group, so the sharding rules (``sharding.rules``) can be computed, and
pieces cut, without ranks.  ``Mesh.abstract(..., dry=True)`` also runs
the collectives dry: each returns a tensor of the shape and dtype the
real one returns (on fake tensors, the dry run's), counts in
``collective_count`` / ``wire_bytes`` exactly as a real mesh counts, and
communicates nothing.  Every collective, real or dry (and those of the
tensor-parallel serving context, ``sharding.tp``), is also tallied by
kind with its ring wire cost over its group of n ranks
(``collectives_by_kind``): all-gather (n-1)/n of the gathered tensor,
reduce-scatter (n-1)/n of its input, all-reduce 2(n-1)/n, a shift the
tensor once.

``Mesh.split(axis, n)`` names the blocks of ``n`` consecutive
coordinates of an axis as an axis of their own (the tensor-parallel
groups of a training step that splits its compute ``n`` ways along
``model``, the rest of the axis holding replicas): the collectives take
its name as they take any axis's.

``use_mesh`` / ``current_mesh`` mark the mesh a step runs over;
``constrain`` is the identity (its docstring says why).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist

_STATE = threading.local()
_COUNTS = {"collectives": 0, "bytes": 0}
# kind -> {"count", "bytes" (input tensors), "wire" (ring wire cost)}
_KINDS: dict[str, dict[str, float]] = {}
_WIRE = {"all-gather": lambda b, n: b * (n - 1),  # n x b gathered
         "reduce-scatter": lambda b, n: b * (n - 1) / n,
         "all-reduce": lambda b, n: 2.0 * b * (n - 1) / n,
         "collective-permute": lambda b, n: float(b)}


def collective_count() -> int:
    """Collectives run since the last ``reset_counts``."""
    return _COUNTS["collectives"]


def wire_bytes() -> int:
    """Bytes this rank handed to its collectives since the last
    ``reset_counts`` (each input tensor's size, once per collective)."""
    return _COUNTS["bytes"]


def reset_counts() -> None:
    _COUNTS["collectives"] = 0
    _COUNTS["bytes"] = 0
    _KINDS.clear()


def record_collective(kind: str, nbytes: int, n: int) -> None:
    """Tally one collective of ``kind`` over ``n`` ranks whose input
    tensor holds ``nbytes``."""
    c = _KINDS.setdefault(kind, {"count": 0, "bytes": 0, "wire": 0.0})
    c["count"] += 1
    c["bytes"] += nbytes
    c["wire"] += _WIRE[kind](nbytes, n)


def collectives_by_kind() -> dict[str, dict[str, float]]:
    """{kind: {"count", "bytes", "wire"}} since the last ``reset_counts``."""
    return {k: dict(v) for k, v in _KINDS.items()}


def world_size() -> int:
    """The default group's size; 1 where ``torch.distributed`` is not
    initialized (a mesh built over it then says what is missing)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank_device(device) -> torch.device:
    """This rank's device: ``device`` when given, else the card of its
    local rank (``LOCAL_RANK`` modulo the visible cards); never the CPU by
    default."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "build the mesh over CPU ranks")
    from repro_torch.sharding import dist as rank_dist
    dev = torch.device("cuda",
                       rank_dist.local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """Named axes over the ranks of the default process group, row-major:
    rank r sits at the coordinate of r in ``shape`` (the last axis
    fastest), as ``jax.make_mesh`` lays out its devices.

    ``axis_names``, ``shape`` ({name: size}), ``axis_size(axis)``,
    ``coord(axis)`` (this rank's index on the axis), ``group(axis)`` (the
    process group of the ranks that differ from this one only on
    ``axis``, in coordinate order) and ``device`` (where this rank's
    tensors live)."""

    dry = False

    def __init__(self, sizes, axis_names, device=None):
        sizes = tuple(int(s) for s in sizes)
        axis_names = tuple(axis_names)
        if len(sizes) != len(axis_names):
            raise ValueError(f"mesh shape {sizes} and axes {axis_names} "
                             "differ in length")
        n = math.prod(sizes)
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a mesh of {sizes} needs torch.distributed initialized "
                f"with {n} ranks (repro_torch.sharding.dist.init)")
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"a mesh of {dict(zip(axis_names, sizes))} "
                             f"needs {n} ranks; the world has {world}")
        from torch.distributed.device_mesh import DeviceMesh
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.device = _rank_device(device)
        self.backend = dist.get_backend()
        # the collectives run where the backend runs them: gloo on host
        # buffers, so the DeviceMesh is a host mesh under gloo
        kind = "cpu" if self.backend == "gloo" else self.device.type
        self.device_mesh = DeviceMesh(
            kind, torch.arange(n).reshape(sizes), mesh_dim_names=axis_names)
        self.rank = dist.get_rank()
        self._coords = dict(zip(axis_names, self.device_mesh.get_coordinate()))
        self._groups = {a: self.device_mesh.get_group(a) for a in axis_names}
        self._sub = {}

    @classmethod
    def abstract(cls, sizes: dict, rank: int = 0, dry: bool = False,
                 device="cpu") -> "Mesh":
        """A mesh of these axis sizes with no process group, on
        ``device``: the rules and ``rules.shard`` work on it (as rank
        ``rank``); the collectives raise, or with ``dry`` run dry (the
        module docstring)."""
        self = cls.__new__(cls)
        self.dry = dry
        self.axis_names = tuple(sizes)
        self.shape = {a: int(s) for a, s in sizes.items()}
        self.device = torch.device(device)
        self.backend = None
        self.device_mesh = None
        self.rank = rank
        coords, r = {}, rank
        for a in reversed(self.axis_names):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self._coords = {a: coords[a] for a in self.axis_names}
        self._groups = None
        self._sub = {}
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def axis_size(self, axis: str) -> int:
        if axis in self._sub:
            return self._sub[axis][0]
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        if axis in self._sub:
            return self._sub[axis][1]
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        if self._groups is None:
            raise RuntimeError(f"{self!r} is abstract: it has no process "
                               "groups")
        if axis in self._sub:
            return self._sub[axis][2]
        return self._groups[axis]

    def split(self, axis: str, n: int) -> str:
        """The name of an axis over the blocks of ``n`` consecutive
        coordinates of ``axis`` (``n`` divides its size): this rank's
        block, at coordinate ``coord(axis) % n`` in it.  ``axis`` itself
        when ``n`` is its size.  On a mesh of ranks every rank of the job
        must call it (the first call of each ``n`` builds the groups of
        every block, in one order on every rank)."""
        size = self.axis_size(axis)
        if size % n:
            raise ValueError(f"{n} does not divide the {axis!r} axis "
                             f"({size})")
        if n == size:
            return axis
        name = f"{axis}/{n}"
        if name not in self._sub:
            group = None
            if self._groups is not None:
                blocks: dict = {}
                for r in range(math.prod(self.shape.values())):
                    key, rest = [], r
                    for a in reversed(self.axis_names):
                        c = rest % self.shape[a]
                        rest //= self.shape[a]
                        key.append(c // n if a == axis else c)
                    blocks.setdefault(tuple(key), []).append(r)
                for key in sorted(blocks):
                    g = dist.new_group(blocks[key])
                    if self.rank in blocks[key]:
                        group = g
            self._sub[name] = (n, self.coord(axis) % n, group)
        return name

    def peer(self, axis: str, coord: int) -> int:
        """The global rank that differs from this one only in having
        ``coord`` on ``axis``."""
        stride = math.prod(self.shape[a] for a in
                           self.axis_names[self.axis_names.index(axis) + 1:])
        return self.rank + (coord - self.coord(axis)) * stride

    # ------------------------------------------------------- collectives
    def _host(self, x: torch.Tensor, kind: str, n: int) -> torch.Tensor:
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        _COUNTS["collectives"] += 1
        _COUNTS["bytes"] += nbytes
        record_collective(kind, nbytes, n)
        if self.dry:
            return x
        if x.is_cuda and self.backend == "gloo":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host
        return x

    def _back(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(like.device) if y.device != like.device else y

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every coordinate's ``x`` on ``axis``, concatenated along ``dim``
        in coordinate order."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        h = self._host(x, "all-gather", n)
        if self.dry:
            return torch.cat([h] * n, dim)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=self.group(axis))
        return self._back(torch.cat(parts, dim), x)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, cut along ``dim`` into the
        axis' size of equal chunks: this coordinate's chunk."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        h = self._host(x.movedim(dim, 0), "reduce-scatter", n)
        out = torch.empty((h.shape[0] // n,) + tuple(h.shape[1:]),
                          dtype=h.dtype, device=h.device)
        if self.dry:
            return out.movedim(0, dim)
        # reduce_scatter_single where torch has it (reduce_scatter_tensor,
        # the same call, is deprecated there)
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, h, group=self.group(axis))
        return self._back(out.movedim(0, dim), x)

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"):
        """``x`` reduced (``sum`` or ``max``) over every axis of ``axes``
        (one after the other, in the order given)."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        axes = [a for a in ((axes,) if isinstance(axes, str) else axes)
                if self.axis_size(a) > 1]
        if not axes:
            return x
        h = self._host(x, "all-reduce", self.axis_size(axes[0]))
        h = h.clone() if h is x else h
        for i, a in enumerate(axes):
            if i:
                nbytes = h.numel() * h.element_size()
                _COUNTS["collectives"] += 1
                _COUNTS["bytes"] += nbytes
                record_collective("all-reduce", nbytes, self.axis_size(a))
            if not self.dry:
                dist.all_reduce(h, op=red, group=self.group(a))
        return self._back(h, x)

    def shift(self, x: torch.Tensor, axis: str, step: int = 1):
        """``lax.ppermute`` by ``step`` along ``axis``, cyclic: this rank
        sends ``x`` to coordinate + step and returns what coordinate -
        step sent."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        c = self.coord(axis)
        h = self._host(x, "collective-permute", n)
        out = torch.empty_like(h)
        if self.dry:
            return out
        group = self.group(axis)
        ops = [dist.P2POp(dist.isend, h, self.peer(axis, (c + step) % n),
                          group),
               dist.P2POp(dist.irecv, out, self.peer(axis, (c - step) % n),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, x)

    def barrier(self) -> None:
        if self._groups is not None:
            dist.barrier()


def current_mesh() -> Mesh | None:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def constrain(x, *roles):
    """The identity.  JAX's ``constrain`` is a
    ``with_sharding_constraint``: a hint to the GSPMD partitioner about
    how to lay out a transient it cannot infer (the MoE dispatch buffer).
    The port has no partitioner: a step runs each rank's whole local
    computation, and the explicit collectives of the sharded step place
    the data, so there is nothing to hint."""
    return x
