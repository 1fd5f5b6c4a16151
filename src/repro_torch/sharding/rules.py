"""Logical-axis sharding rules with divisibility-aware fallback (port of
``repro.sharding.rules``), and the cuts they describe.

Mesh axes (DESIGN.md section 4):
  pod   -- DCN data parallelism (2 pods); only gradient all-reduce crosses it
  data  -- FSDP: parameters/optimizer state sharded; batch sharded
  model -- TP/EP: heads / FFN hidden / vocab / experts

A spec is a tuple mirroring ``jax.sharding.PartitionSpec``: per dim,
``None``, an axis name, or a tuple of names (the first the major one); a
spec shorter than its leaf leaves the trailing dims whole, and ``()`` is
replicated.  The ``*_shardings`` functions return one spec per leaf, in
``tree.leaves`` order.

The rules are JAX's, name and rank based, and key on the rank JAX stores.
JAX stacks a model's units (``[U, ...]``); the port keeps them as a list
of per-unit dicts.  So a leaf under a list (``units[u]``, an encoder or
decoder layer, a one-shot cache's unit) gets the spec that JAX gives its
stacked shape ``(len(list),) + shape``, with the unit dim dropped; the
rules raise where that dim would be sharded (no registered config does
that).

:func:`shard` cuts this rank's pieces out of whole tensors, :func:`gather`
rebuilds whole tensors from the pieces (a collective over the mesh).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_util
from repro_torch.sharding.ctx import Mesh
from repro_torch.sharding.seq import SeqShard

REPLICATED_NAMES = {"g", "A_log", "dt_bias", "D", "s_w", "_k"}


def _axis(mesh: Mesh, name: str) -> int:
    # an axis of the mesh or a block axis of ``Mesh.split``
    return mesh.axis_size(name)


def _dp_axes(mesh: Mesh):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(axes) if axes else None


def _fits(shape, dim, size):
    return size > 1 and shape[dim] % size == 0


def _canon(spec) -> tuple:
    """As ``PartitionSpec`` stores a spec: a one-name tuple as the name,
    an empty one as None."""
    return tuple(None if isinstance(ax, tuple) and not ax else
                 ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax
                 for ax in spec)


def axes_of(ax) -> tuple:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


# ------------------------------------------------- JAX's rules, stacked
def param_spec(names, shape, mesh: Mesh) -> tuple:
    """JAX's ``param_spec`` on a leaf's path names (dict keys) and the
    shape JAX stores (units stacked)."""
    names = [str(n) for n in names]
    last = names[-1] if names else ""
    nd = len(shape)
    model = _axis(mesh, "model")
    data = _axis(mesh, "data")

    if last in REPLICATED_NAMES or nd <= 1:
        return ()
    if last == "conv_w":  # [*, K, d_inner]
        spec = [None] * nd
        if _fits(shape, nd - 1, model):
            spec[nd - 1] = "model"
        return _canon(spec)
    if "router" in names:
        return _canon((None,) * nd)

    # weight matrices: trailing dims are (out, in); leading dims are
    # (unit-stack) and, for MoE expert stacks, (experts)
    spec: list = [None] * nd
    out_dim, in_dim = nd - 2, nd - 1
    expert_dim = 1 if nd == 4 else None

    if expert_dim is not None and _fits(shape, expert_dim, model):
        spec[expert_dim] = "model"          # expert parallelism
        if _fits(shape, in_dim, data):
            spec[in_dim] = "data"           # FSDP on the contraction dim
        return _canon(spec)

    if expert_dim is not None and "w_down" in names:
        # non-EP expert down-projection: contraction over 'model'
        if _fits(shape, in_dim, model):
            spec[in_dim] = "model"
        if _fits(shape, out_dim, data):
            spec[out_dim] = "data"
        return _canon(spec)

    if _fits(shape, out_dim, model):
        spec[out_dim] = "model"             # tensor parallelism
    elif _fits(shape, in_dim, model):
        spec[in_dim] = "model"
    if spec[in_dim] is None and _fits(shape, in_dim, data):
        spec[in_dim] = "data"               # FSDP
    elif spec[out_dim] is None and _fits(shape, out_dim, data):
        spec[out_dim] = "data"
    return _canon(spec)


def _tp_only_spec(names, shape, mesh: Mesh) -> tuple:
    cleaned = []
    for ax in param_spec(names, shape, mesh):
        axes = tuple(a for a in axes_of(ax) if a == "model")
        cleaned.append(axes[0] if len(axes) == 1 else (axes or None))
    return tuple(cleaned)


def batch_spec(leaf, mesh: Mesh, batch_dim: int = 0) -> tuple:
    """Batch inputs: shard the batch dim over (pod, data) when divisible."""
    dp = _dp_axes(mesh)
    nd = len(leaf.shape)
    spec = [None] * nd
    if dp:
        size = math.prod(_axis(mesh, a) for a in dp)
        if leaf.shape[batch_dim] % size == 0:
            spec[batch_dim] = dp
    return _canon(spec)


def cache_spec(names, shape, mesh: Mesh) -> tuple:
    """JAX's ``cache_spec`` on a cache leaf's path names and the shape JAX
    stores: attn 'k'/'v' [U, B, S, KVH, HD] (B over dp, else S takes the
    dp axes too; S over 'model'), ssm 'conv' [U, B, K-1, dI], 'ssd'
    [U, B, H, P, N], 'enc_out' [B, T, D]; else the largest divisible dim
    over dp."""
    names = [str(n) for n in names]
    last = names[-1] if names else ""
    nd = len(shape)
    model = _axis(mesh, "model")
    dp = _dp_axes(mesh)
    dp_size = math.prod(_axis(mesh, a) for a in dp) if dp else 1
    spec: list = [None] * nd

    if last in ("k", "v", "k_scale", "v_scale") and nd == 5:
        seq_axes: list = []
        if dp and shape[1] % dp_size == 0 and shape[1] >= dp_size:
            spec[1] = dp
        elif dp:
            seq_axes.extend(dp)             # batch=1: S takes dp too
        if model > 1:
            seq_axes.append("model")
        n = math.prod(_axis(mesh, a) for a in seq_axes)
        if seq_axes and shape[2] % n == 0:
            spec[2] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
        return _canon(spec)
    if last == "conv" and nd == 4:
        if dp and shape[1] % dp_size == 0:
            spec[1] = dp
        if _fits(shape, 3, model):
            spec[3] = "model"
        return _canon(spec)
    if last == "ssd" and nd == 5:
        if dp and shape[1] % dp_size == 0:
            spec[1] = dp
        if _fits(shape, 2, model):
            spec[2] = "model"
        return _canon(spec)
    if last == "enc_out" and nd == 3:
        if dp and shape[0] % dp_size == 0:
            spec[0] = dp
        if _fits(shape, 2, model):
            spec[2] = "model"
        return _canon(spec)
    if dp:  # fallback: shard the largest divisible dim over dp
        order = sorted(range(nd), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % dp_size == 0 and shape[i] >= dp_size:
                spec[i] = dp
                break
    return _canon(spec)


# ---------------------------------------------- the port's unit lists
def stacked_leaves(tree) -> list[tuple[list, tuple, bool]]:
    """Per leaf (in ``tree.leaves`` order): its path's dict keys, the
    shape JAX stores (the length of the list it sits in prepended), and
    whether it sits in such a list."""
    out = []

    def walk(node, names, stack):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], names + [k], stack)
        elif isinstance(node, list):
            if stack is not None:
                raise ValueError(f"a list inside the list at {names}: the "
                                 "rules know one level of unit stacking")
            for c in node:
                walk(c, names, len(node))
        elif isinstance(node, tuple):
            for c in node:
                walk(c, names, stack)
        else:
            shape = tuple(node.shape)
            out.append((names, shape if stack is None else (stack,) + shape,
                        stack is not None))

    walk(tree, [], None)
    return out


def _unstack(spec: tuple, stacked: bool, names) -> tuple:
    if not stacked:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"the rules shard the unit dim of {names} "
                         f"({spec}); the port keeps units unstacked")
    return spec[1:]


def params_shardings(params, mesh: Mesh, serve_tp_only: bool = False):
    """One spec per parameter leaf.  serve_tp_only: shard over 'model'
    only, replicated across 'data'/'pod'."""
    rule = _tp_only_spec if serve_tp_only else param_spec
    return [_unstack(rule(names, shape, mesh), stacked, names)
            for names, shape, stacked in stacked_leaves(params)]


def batch_shardings(batch, mesh: Mesh):
    return [batch_spec(leaf, mesh) for leaf in tree_util.leaves(batch)]


def cache_shardings(cache, mesh: Mesh):
    return [_unstack(cache_spec(names, shape, mesh), stacked, names)
            for names, shape, stacked in stacked_leaves(cache)]


def scale_spec(param_spec_: tuple, scale_shape, mesh: Mesh) -> tuple:
    """An int8 moment's block scales: the parameter's spec on the leading
    dims; the blocked last dim sharded only when the block count still
    divides the axis."""
    nd = len(scale_shape)
    spec = (list(param_spec_) + [None] * nd)[:nd]
    last = nd - 1
    if spec[last] is not None:
        n = math.prod(_axis(mesh, a) for a in axes_of(spec[last]))
        if scale_shape[last] % max(n, 1):
            spec[last] = None
    return _canon(spec)


def opt_state_shardings(opt_state, params_sh: list, mesh: Mesh):
    """One spec per leaf of an ``adamw.OptState``: the step replicated,
    the moments mirroring their parameters (fp32 and the shape-preserving
    int8 layout alike), the int8 block scales per :func:`scale_spec`."""
    specs = [()]  # step
    specs += list(params_sh) * 2  # mu, nu
    if opt_state.mu_scale is not None:
        for scales in (opt_state.mu_scale, opt_state.nu_scale):
            specs += [scale_spec(p, s.shape, mesh) for p, s in
                      zip(params_sh, tree_util.leaves(scales))]
    return specs


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a train state lies on a mesh: one spec per parameter leaf and
    one per ``adamw.OptState`` leaf (``opt_state_shardings``)."""
    mesh: Mesh
    params: list
    opt: list

    @property
    def scales(self) -> list:
        """The specs of the int8 first moment's block scales (the second
        moment's are the same), one per parameter; [] for fp32 state."""
        n = len(self.params)
        return self.opt[1 + 2 * n:1 + 3 * n]

    @property
    def state(self) -> list:
        """The specs of ``{"params": params, "opt": opt_state}`` (the
        checkpointed tree), in ``tree.leaves`` order."""
        return self.opt + self.params


def layout(params, opt_state, mesh: Mesh) -> Layout:
    """The rules' layout of whole (or meta) parameter and optimizer
    trees on ``mesh``."""
    p = params_shardings(params, mesh)
    return Layout(mesh, p, opt_state_shardings(opt_state, p, mesh))


# ------------------------------------------------------------ the cuts
def sharded_dims(spec: tuple, nd: int):
    """(dim, axes major to minor) of every sharded dim."""
    return [(d, axes_of(ax)) for d, ax in enumerate(spec[:nd]) if ax]


def local_shape(shape, spec: tuple, mesh: Mesh) -> tuple:
    """The shape of one rank's piece of a leaf of ``shape``."""
    shape = list(shape)
    for d, axes in sharded_dims(spec, len(shape)):
        n = math.prod(_axis(mesh, a) for a in axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        shape[d] //= n
    return tuple(shape)


def global_shape(shape, spec: tuple, mesh: Mesh) -> tuple:
    """The whole leaf's shape from one piece's."""
    shape = list(shape)
    for d, axes in sharded_dims(spec, len(shape)):
        shape[d] *= math.prod(_axis(mesh, a) for a in axes)
    return tuple(shape)


def offset(spec: tuple, dim: int, length: int, mesh: Mesh) -> int:
    """Where this rank's piece starts along ``dim`` of a whole leaf whose
    dim is ``length`` long."""
    axes = axes_of(spec[dim]) if dim < len(spec) else ()
    start = 0
    for a in axes:
        length //= _axis(mesh, a)
        start += mesh.coord(a) * length
    return start


def cut(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's piece of the whole tensor ``x`` (a view)."""
    for d, _ in sharded_dims(spec, x.dim()):
        n = x.shape[d] // math.prod(_axis(mesh, a) for a in axes_of(spec[d]))
        x = x.narrow(d, offset(spec, d, x.shape[d], mesh), n)
    return x


def shard(tree, specs: list, mesh: Mesh):
    """This rank's pieces of a tree of whole tensors, each a fresh
    contiguous tensor on ``mesh.device`` (so the whole can be freed)."""
    leaves = tree_util.leaves(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_util.unflatten(tree, [
        cut(x, s, mesh).to(mesh.device, copy=True).contiguous()
        for x, s in zip(leaves, specs)])


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from this rank's piece (every rank of the mesh
    calls it with its own piece)."""
    for d, axes in sharded_dims(spec, x.dim()):
        for a in reversed(axes):  # minor axis first
            x = mesh.all_gather(x, a, d)
    return x


def gather(tree, specs: list, mesh: Mesh):
    """The inverse of :func:`shard`: whole tensors on every rank."""
    leaves = tree_util.leaves(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_util.unflatten(tree, [
        gather_leaf(x.detach(), s, mesh) for x, s in zip(leaves, specs)])


# ------------------------------------------- the sequence-sharded cache
ATTN_CACHE = ("k", "v", "k_scale", "v_scale")
# an SSM state leaf -> its per-head / per-feature dim (unit dim dropped)
SSM_CACHE_DIM = {"conv": 2, "ssd": 1}


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """How a one-shot decoder cache (``transformer.make_cache``'s list of
    unit dicts) lies on a mesh in the sequence-sharded serve step: one
    spec per leaf (``tree.leaves`` order), and this rank's S offset and
    length, which every attention leaf shares, as a
    :class:`~repro_torch.sharding.seq.SeqShard` (None where no leaf has
    an S)."""
    mesh: Mesh
    specs: list
    seq: SeqShard | None


def serve_cache_layout(cache, mesh: Mesh, tp_axis: str | None = None
                       ) -> CacheLayout:
    """The layout of a whole (or meta) one-shot cache: each attention
    leaf by :func:`cache_spec` (B over the data-parallel axes when it
    divides, else S over them and ``model``; KVH whole), each SSM state
    leaf with B as :func:`cache_spec` puts it and its heads / d_inner
    cut as the serving tensor parallelism cuts them, over ``tp_axis``
    (``model`` or a block axis of ``Mesh.split``; None: whole)."""
    specs, seqs = [], set()
    for names, shape, stacked in stacked_leaves(cache):
        spec = _unstack(cache_spec(names, shape, mesh), stacked, names)
        nd = len(shape) - stacked
        if names[-1] in SSM_CACHE_DIM:
            spec = (list(spec) + [None] * nd)[:nd]
            spec[SSM_CACHE_DIM[names[-1]]] = tp_axis
            spec = _canon(spec)
        specs.append(spec)
        if names[-1] in ATTN_CACHE:
            s = shape[1 + stacked]
            n = math.prod(_axis(mesh, a) for a in axes_of(spec[1]))
            seqs.add((axes_of(spec[1]), offset(spec, 1, s, mesh), s // n))
    if len(seqs) > 1:
        raise ValueError(f"the attention caches split S differently: {seqs}")
    seq = SeqShard(mesh, *seqs.pop()) if seqs else None
    return CacheLayout(mesh, specs, seq)


def cut_cache(cache, mesh: Mesh, tp_axis: str | None = None):
    """This rank's piece of a whole one-shot cache and its
    :class:`CacheLayout` (:func:`serve_cache_layout`): each leaf a fresh
    contiguous tensor on ``mesh.device``."""
    layout = serve_cache_layout(cache, mesh, tp_axis)
    return shard(cache, layout.specs, mesh), layout


def local_cache(whole_meta, layout: CacheLayout, device):
    """A rank's zeroed piece of the cache ``whole_meta`` describes (its
    meta tensors give shapes and dtypes), built at the local shapes: no
    rank holds the whole cache."""
    return tree_util.unflatten(whole_meta, [
        torch.zeros(local_shape(x.shape, s, layout.mesh), dtype=x.dtype,
                    device=device)
        for x, s in zip(tree_util.leaves(whole_meta), layout.specs)])


def resident_bytes(tree) -> int:
    """Bytes of the tensors a tree holds (one rank's pieces)."""
    return sum(x.numel() * x.element_size() for x in tree_util.leaves(tree))
