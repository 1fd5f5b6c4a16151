"""Tensor-parallel serving: context, collectives and shard functions (port
of ``repro.sharding.tp``, DESIGN.md §9).

JAX runs the engine's steps under ``shard_map`` over a 1-D ``('tp',)``
mesh of devices.  The port runs one process per rank of a
``torch.distributed`` process group, and the ranks are the mesh: each rank
holds only its shard of the weights and of the paged KV / SSM cache, and
runs the same kernels as a single-device engine on its local shapes.

* :class:`TPContext` / :func:`activate`: a thread-local marker that the
  surrounding code runs as one rank's share of a step.  Model code stays
  rank-agnostic: :func:`reduce` (the row-parallel all-reduce),
  :func:`reduce_max` and the spec helpers in ``models.transformer`` are
  the identity / trivial without an active context.
* :func:`shard_params`: one rank's slice of a loaded parameter tree, by
  JAX's Megatron role table:

  ==================  =========================================  =========
  role                parameters                                 sharded dim
  ==================  =========================================  =========
  column-parallel     wq wk wv wx wz wdt w_gate w_up lm_head     out
  row-parallel        wo w_down                                  in (K)
  replicated          embed router wB wC norms(d_model)          --
  head-sharded        conv_w A_log dt_bias D mixer-norm g        heads/dI
  ==================  =========================================  =========

  Compressed operands (``values`` / ``indices``) slice like their dense
  ``w``: the layout is group-major, so a row-parallel K-slice is a
  contiguous run of whole L-groups (``compressed.split_k``).  The slided
  operand of the fused kernel (``sp_values`` / ``sp_meta``) is stored in
  ``mma.sp`` fragment order, padded to 16 rows and 64 lifted columns, so
  slicing it gives no shard: it is decoded to Phi(W), Phi(W) is sliced
  (rows, or whole groups of gamma*L lifted columns), and each slice is
  encoded again.
* :func:`validate`: JAX's fail-fast divisibility checks and messages.
* :func:`rmsnorm`: RMSNorm over a feature axis sharded across the ranks
  (the SSM's gated norm over d_inner): the sum of squares is all-reduced.
* :func:`argmax_tokens`: greedy ids from vocab-sharded logits, the lowest
  global index winning ties, replicated on every rank; :func:`gather`
  and :func:`gather_last`: a sharded tensor made whole on every rank.
* :func:`degree`: the split degree of a config over an axis of ``n``
  ranks, the largest divisor of ``n`` that :func:`validate` accepts.

Training (``runtime.steps``) keeps that table and adds an LM head that
splits the tokens where t does not divide the vocabulary
(``vocab_parallel=False``): the leaf whole on every rank, each rank
taking its 1/t block of the sequence (``models.transformer``).  So
``validate(train=True)`` refuses no vocabulary.

Training splits its compute the same way (``runtime.steps``, Megatron's
column- and row-parallel linears), so the collectives are autograd
functions there:

====================  ==========================  ==========================
function              forward                     backward
====================  ==========================  ==========================
:func:`reduce`        all-reduce (row-parallel)   identity
:func:`copy_in`       identity                    all-reduce
:func:`total`         all-reduce                  identity
rmsnorm's sum         all-reduce                  all-reduce
:func:`reduce_max`    all-reduce (max)            none (no gradient)
====================  ==========================  ==========================

:func:`copy_in` marks a replicated tensor where it enters computation
that differs between the ranks (the input of a column-parallel group,
a replicated weight such as the router's): each rank's gradient of it
is a partial sum.  :func:`enter` is the column-parallel group's form of
it; under sequence parallelism (:func:`sequence_parallel`, Megatron-SP)
it all-gathers the S-sharded residual stream along S instead, and
:func:`reduce` reduce-scatters along S in place of the all-reduce.
``activate(mesh=..., axis=...)`` binds the context to an axis of a
``sharding.ctx.Mesh``: its collectives then run through the mesh
(host-staged under gloo, counted and tallied as the mesh's own).  A
backward can run on another thread than its forward (autograd's device
threads), so each function keeps its context, and :func:`bind` carries
the context into a rematerialized forward.

The paged KV pool is allocated per rank at KVH/tp heads and the SSM state
at d_inner/tp and heads/tp (``models.transformer`` under an active
context); the page structure and page table are the same on every rank.
Every collective counts one in ``_COUNTS`` (``collective_count``) and is
tallied by kind in ``sharding.ctx.collectives_by_kind``.
:func:`activate_dry` marks a step as rank ``rank`` of ``size`` ranks
with no process group: its collectives return tensors of the real ones'
shapes and dtypes (on fake tensors, the dry run's), count as real ones
count, and communicate nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.distributed as dist

from . import ctx as _ctx


class _State(threading.local):
    # a thread without a context reads the class attribute: no
    # AttributeError raised and caught on each kernel launch's lookup
    ctx = None


_STATE = _State()
_COUNTS = {"collectives": 0}

# parent-dict names -> role (see the module docstring's table)
# ``w_in`` / ``w_out`` (the encoder-decoder's GELU MLP) are not in JAX's
# serving table: serving never splits an encoder-decoder, training does
_COL_PARALLEL = {"wq", "wk", "wv", "wx", "wz", "wdt", "w_gate", "w_up",
                 "w_in", "lm_head"}
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
_REPLICATED = {"embed", "router", "wB", "wC"}
# per-head / per-feature leaves sharded on their trailing dim
_HEAD_SHARDED_LEAVES = {"conv_w", "A_log", "dt_bias", "D"}


@dataclasses.dataclass(frozen=True)
class TPContext:
    """The active tensor-parallel context: the process group, its size and
    this process's rank in it; or a mesh and the axis the ranks lie on;
    and whether the residual stream is split along S (sequence
    parallelism)."""
    group: Any = None
    size: int = 1
    rank: int = 0
    dry: bool = False
    mesh: Any = None
    axis: str | None = None
    sp: bool = False


def current() -> TPContext | None:
    return _STATE.ctx


def size() -> int:
    """TP degree of the active context (1 without one)."""
    ctx = current()
    return ctx.size if ctx is not None else 1


def rank() -> int:
    """This process's rank in the active context (0 without one)."""
    ctx = current()
    return ctx.rank if ctx is not None else 0


@contextlib.contextmanager
def activate(group=None, *, mesh=None, axis: str = "model"):
    """Mark the dynamic extent as one rank's share of a step over
    ``group`` (default: the default process group), or over the axis
    ``axis`` of ``mesh`` (a ``sharding.ctx.Mesh``, whose collectives then
    run the context's)."""
    if mesh is not None:
        ctx = TPContext(size=mesh.axis_size(axis), rank=mesh.coord(axis),
                        dry=mesh.dry, mesh=mesh, axis=axis)
    else:
        ctx = TPContext(group=group, size=dist.get_world_size(group),
                        rank=dist.get_rank(group))
    with _using(ctx):
        yield


@contextlib.contextmanager
def _using(ctx):
    prev = current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def sequence_parallel(on: bool = True):
    """Split the residual stream along S over the ranks in the dynamic
    extent (Megatron-SP), where ``on`` and a context of more than one
    rank is active (one bound to a mesh: its collectives split S); else
    nothing changes."""
    ctx = current()
    if not on or ctx is None or ctx.size == 1:
        yield
        return
    if ctx.mesh is None:
        raise ValueError("sequence parallelism runs over a mesh's axis "
                         "(activate(mesh=...))")
    with _using(dataclasses.replace(ctx, sp=True)):
        yield


def sp() -> bool:
    """Whether the residual stream is split along S (sequence
    parallelism)."""
    ctx = current()
    return ctx is not None and ctx.sp


def bind(fn):
    """``fn`` run under the context active now, wherever it is called: a
    rematerialized forward runs again in the backward, which autograd may
    run on another thread."""
    ctx = current()

    def bound(*args, **kwargs):
        with _using(ctx):
            return fn(*args, **kwargs)
    return bound


@contextlib.contextmanager
def activate_dry(size: int, rank: int = 0):
    """Mark the dynamic extent as rank ``rank``'s share of a step over
    ``size`` ranks that do not exist: the collectives run dry."""
    prev = current()
    _STATE.ctx = TPContext(group=None, size=size, rank=rank, dry=True)
    try:
        yield
    finally:
        _STATE.ctx = prev


def collective_count() -> int:
    return _COUNTS["collectives"]


def reset_counts() -> None:
    _COUNTS["collectives"] = 0


def _all_reduce(x: torch.Tensor, op, ctx: TPContext) -> torch.Tensor:
    if ctx.mesh is not None:
        return ctx.mesh.all_reduce(
            x, ctx.axis, "max" if op == dist.ReduceOp.MAX else "sum")
    out = x.contiguous().clone()
    if not ctx.dry:
        dist.all_reduce(out, op=op, group=ctx.group)
    _COUNTS["collectives"] += 1
    _ctx.record_collective("all-reduce", out.numel() * out.element_size(),
                           ctx.size)
    return out


def _all_gather(x: torch.Tensor, ctx: TPContext) -> list[torch.Tensor]:
    if ctx.mesh is not None:
        return list(ctx.mesh.all_gather(x[None], ctx.axis, 0).unbind(0))
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ctx.size)]
    if not ctx.dry:
        dist.all_gather(parts, x, group=ctx.group)
    _COUNTS["collectives"] += 1
    _ctx.record_collective("all-gather", x.numel() * x.element_size(),
                           ctx.size)
    return parts


SEQ_DIM = 1   # S of the [B, S, ...] activations sequence parallelism splits


def _gather_seq(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    return ctx.mesh.all_gather(x, ctx.axis, SEQ_DIM)


def _scatter_seq(x: torch.Tensor, ctx: TPContext) -> torch.Tensor:
    return ctx.mesh.reduce_scatter(x, ctx.axis, SEQ_DIM)


class _Sum(torch.autograd.Function):
    """All-reduce; the backward is the identity (every rank uses the sum
    alike, so each already holds its whole gradient) or, with
    ``grad_sum``, an all-reduce too (each rank uses the sum in its own
    computation)."""

    @staticmethod
    def forward(c, x, ctx, grad_sum):
        c.tp, c.grad_sum = ctx, grad_sum
        return _all_reduce(x, dist.ReduceOp.SUM, ctx)

    @staticmethod
    def backward(c, g):
        if c.grad_sum:
            g = _all_reduce(g, dist.ReduceOp.SUM, c.tp)
        return g, None, None


class _CopyIn(torch.autograd.Function):
    """The identity; the backward all-reduces the gradient."""

    @staticmethod
    def forward(c, x, ctx):
        c.tp = ctx
        return x.view_as(x)

    @staticmethod
    def backward(c, g):
        return _all_reduce(g, dist.ReduceOp.SUM, c.tp), None


class _GatherSeq(torch.autograd.Function):
    """All-gather along S; the backward reduce-scatters along S."""

    @staticmethod
    def forward(c, x, ctx):
        c.tp = ctx
        return _gather_seq(x, ctx)

    @staticmethod
    def backward(c, g):
        return _scatter_seq(g, c.tp), None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along S; the backward all-gathers along S."""

    @staticmethod
    def forward(c, x, ctx):
        c.tp = ctx
        return _scatter_seq(x, ctx)

    @staticmethod
    def backward(c, g):
        return _gather_seq(g, c.tp), None


class _SplitSeq(torch.autograd.Function):
    """This rank's block along S; the backward all-gathers along S."""

    @staticmethod
    def forward(c, x, ctx):
        c.tp = ctx
        n = x.shape[SEQ_DIM] // ctx.size
        return x.narrow(SEQ_DIM, ctx.rank * n, n).contiguous()

    @staticmethod
    def backward(c, g):
        return _gather_seq(g, c.tp), None


def _active():
    ctx = current()
    return None if ctx is None or ctx.size == 1 else ctx


def reduce(x: torch.Tensor) -> torch.Tensor:
    """Row-parallel sum over the ranks: an all-reduce whose backward is
    the identity; under sequence parallelism a reduce-scatter along S
    (backward: all-gather).  The identity without an active context."""
    ctx = _active()
    if ctx is None:
        return x
    if ctx.sp:
        return _ScatterSeq.apply(x, ctx)
    return _Sum.apply(x, ctx, False)


def total(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks of a value every rank then uses alike (the
    vocab-parallel cross entropy's sums): backward the identity."""
    ctx = _active()
    if ctx is None:
        return x
    return _Sum.apply(x, ctx, False)


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering computation that differs between the
    ranks: the identity, whose backward all-reduces the gradient (each
    rank's is a partial sum).  The identity without an active context."""
    ctx = _active()
    if ctx is None:
        return x
    return _CopyIn.apply(x, ctx)


def enter(x: torch.Tensor) -> torch.Tensor:
    """The residual stream [B, S, ...] entering a column-parallel group:
    :func:`copy_in`, or under sequence parallelism the all-gather of its
    S-shards (backward: reduce-scatter along S)."""
    ctx = _active()
    if ctx is not None and ctx.sp:
        return _GatherSeq.apply(x, ctx)
    return copy_in(x)


def replicated(p: dict) -> dict:
    """A replicated projection's parameters (``{"w": ...}``) where its
    output enters computation that differs between the ranks (the SSM's
    wB / wC, the MoE router): its weight through :func:`copy_in`, so each
    rank's weight gradient is the ranks' sum.  ``p`` itself without an
    active context."""
    if _active() is None:
        return p
    return {k: copy_in(v) if k == "w" else v for k, v in p.items()}


def split_seq(x: torch.Tensor) -> torch.Tensor:
    """This rank's block along S of a replicated [B, S, ...] tensor under
    sequence parallelism (backward: all-gather); else ``x``."""
    ctx = _active()
    if ctx is None or not ctx.sp:
        return x
    return _SplitSeq.apply(x, ctx)


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the ranks, with no gradient; the identity
    without an active context.  ``linear.apply`` turns a row-parallel
    projection's per-shard per-token absmax into the global absmax with
    it, so every rank quantizes to the values and scale of the unsharded
    run; the vocab-parallel cross entropy takes its row maxima."""
    ctx = _active()
    if ctx is None:
        return x
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, ctx)


def gather_last(x: torch.Tensor) -> torch.Tensor:
    """The whole of a tensor sharded on its last dim (vocab-sharded
    logits), on every rank; the identity without an active context."""
    return gather(x, -1)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    heads of a head-sharded tensor, whole); the identity without an
    active context."""
    ctx = _active()
    if ctx is None:
        return x
    return torch.cat(_all_gather(x, ctx), dim=dim)


def argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy int32 ids from (possibly vocab-sharded) logits ``[..., V/tp]``
    (``[B, V/tp]`` decode and ``[B, K+1, V/tp]`` verify logits alike): a
    local argmax and max, then one all-gather of each in rank order and an
    argmax across the ranks.  Ties go to the lowest global vocab index, as
    ``jnp.argmax`` on the whole logits: ``torch.argmax`` picks the first
    maximal index within a shard and the lowest rank across shards."""
    ctx = current()
    if ctx is None or ctx.size == 1:
        return torch.argmax(logits, -1).to(torch.int32)
    vloc = logits.shape[-1]
    loc = torch.argmax(logits, -1)
    best = torch.take_along_dim(logits, loc[..., None], dim=-1)[..., 0]
    gidx = (loc + ctx.rank * vloc).to(torch.int32)
    allv = torch.stack(_all_gather(best, ctx))         # [tp, ...] maxima
    alli = torch.stack(_all_gather(gidx, ctx))         # [tp, ...] indices
    shard = torch.argmax(allv, 0)                      # ties: lowest rank
    return torch.take_along_dim(alli, shard[None], dim=0)[0]


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over a feature axis sharded across the ranks: the mean of
    squares is the all-reduced sum of the local sums over the global
    width.  Without an active context this is ``layers.rmsnorm``."""
    ctx = _active()
    dt = x.dtype
    xf = x.to(torch.float32)
    if ctx is None:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        # each rank normalizes its own features by the sum: the backward
        # sums the ranks' gradients of it
        ss = _Sum.apply(torch.sum(xf * xf, dim=-1, keepdim=True), ctx, True)
        ms = ss / (x.shape[-1] * ctx.size)
    xf = xf * torch.rsqrt(ms + eps)
    return (xf * params["g"]).to(dt)


# ----------------------------------------------------------- shard functions
def shard_dim(names: list[str], ndim: int, *,
              vocab_parallel: bool = True) -> int | None:
    """The dim JAX's role table shards for a leaf at the path ``names``
    (the dict keys from the root; list indices are ignored), or None when
    the leaf is replicated.  ``_leaf_spec`` of ``repro.sharding.tp``.
    Without ``vocab_parallel`` the LM head is whole (the token-split
    head)."""
    last = names[-1]
    if "lm_head" in names and not vocab_parallel:
        return None
    if any(n in _REPLICATED for n in names):
        return None
    if last in _HEAD_SHARDED_LEAVES:
        return ndim - 1
    if last == "g":
        # the mixer's gated norm spans the sharded d_inner; every other
        # norm spans the replicated d_model residual stream
        return ndim - 1 if "mixer" in names and "norm" in names else None
    parent = names[-2] if len(names) >= 2 else ""
    if parent in _COL_PARALLEL:
        return (ndim - 2) % ndim          # out; s_w [out, 1] too
    if parent in _ROW_PARALLEL:
        return None if last == "s_w" else ndim - 1
    return None


def _cut(t: torch.Tensor, dim: int, rank_: int, tp: int,
         names: list[str]) -> torch.Tensor:
    """Rank ``rank_``'s contiguous block of ``t`` along ``dim``, in storage
    of its own (the full tensor can be freed)."""
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"TP={tp} cannot shard {'/'.join(names)} shape "
                         f"{tuple(t.shape)} on dim {dim}")
    step = n // tp
    return t.narrow(dim, rank_ * step, step).clone(
        memory_format=torch.contiguous_format)


def _in_features(names: list[str], mixer: dict | None, cfg) -> int:
    """K of the projection at ``names``: the residual width for a
    column-parallel one, else the width its row-parallel input has."""
    name = names[-1]
    if name in _COL_PARALLEL:
        return cfg.d_model
    if name in ("w_down", "w_out"):
        return cfg.d_ff
    if mixer is not None and "wx" in mixer:          # the SSM block's wo
        return cfg.ssm_expand * cfg.d_model
    return cfg.num_heads * cfg.resolved_head_dim


def _shard_operand(node: dict, names: list[str], mixer, cfg, rank_: int,
                   tp: int) -> dict:
    """One rank's share of a projection stored as the fused slided
    kernel's 2:4 operand: Phi(W) decoded, sliced (rows for a column-
    parallel projection; whole groups of gamma*L lifted columns for a
    row-parallel one, since Phi is group-major) and encoded again.  ``s_w``
    follows the rows and stays whole on a row-parallel projection."""
    from repro_torch.kernels import fused_slide_matmul as fsm

    name = names[-1]
    if name not in _COL_PARALLEL and name not in _ROW_PARALLEL:
        return node
    sp = cfg.sparsity
    packed = sp.recipe.packed_weights
    gk = fsm.lifted_width(_in_features(names, mixer, cfg),
                          sp.decomposition().source.family_n)
    ws = fsm.dense_from_operand(node["sp_values"], node["sp_meta"],
                                node["s_w"].shape[0], gk, packed=packed)
    out = {k: v for k, v in node.items() if k not in ("sp_values", "sp_meta")}
    if name in _COL_PARALLEL:
        ws = _cut(ws, 0, rank_, tp, names + ["sp_values"])
        out["s_w"] = _cut(node["s_w"], 0, rank_, tp, names + ["s_w"])
    else:
        # K/tp holds whole L-groups (validate): the byte slices of 'w4'
        # nibbles stay aligned
        ws = _cut(ws, 1, rank_, tp, names + ["sp_values"])
    out["sp_values"], out["sp_meta"] = fsm.sparse_operand(ws, packed=packed)
    return out


def shard_params(params, cfg, rank_: int, tp: int):
    """Rank ``rank_``'s shard of a loaded (packed or dense) parameter tree:
    each sharded leaf's contiguous block in storage of its own, each
    replicated leaf the same tensor.  Raises ValueError on a sharded dim
    that ``tp`` does not divide, as JAX's ``serve_param_specs`` does: there
    is no silent replication."""
    if tp == 1:
        return params

    def walk(node, names, mixer):
        if isinstance(node, list):
            return [walk(v, names + [str(i)], mixer)
                    for i, v in enumerate(node)]
        if isinstance(node, dict):
            if "sp_values" in node:
                return _shard_operand(node, names, mixer, cfg, rank_, tp)
            inner = node if names and names[-1] == "mixer" else mixer
            return {k: walk(v, names + [k], inner) for k, v in node.items()}
        if not torch.is_tensor(node):
            return node
        dim = shard_dim(names, node.dim())
        return node if dim is None else _cut(node, dim, rank_, tp, names)

    return walk(params, [], None)


# ------------------------------------------------------------ validation
def degree(cfg, n: int, *, train: bool = False) -> int:
    """The split degree of ``cfg`` over an axis of ``n`` ranks: the
    largest divisor of ``n`` that :func:`validate` accepts (the rest of
    the axis holds replicas); ``train`` for a training step's."""
    for t in sorted((d for d in range(1, n + 1) if n % d == 0),
                    reverse=True):
        try:
            validate(cfg, t, train=train)
            return t
        except ValueError:
            continue
    return 1


def vocab_parallel(cfg, tp: int) -> bool:
    """Whether a training step over ``tp`` ranks splits the LM head's
    vocabulary (tp divides it), or else the tokens (the head whole)."""
    return cfg.vocab_size % tp == 0


def validate(cfg, tp: int, *, train: bool = False) -> None:
    """Fail fast on configs the TP partitioning cannot express: attention
    heads and KV heads divide tp (head-parallel KV pool), d_ff and vocab
    divide tp, SSM heads divide tp, and, for a packed ``compressed`` /
    ``slided`` model or a ``masked`` one (STE-pruned per shard in
    training), each row-parallel K shard holds whole L-groups.  A
    training step (``train``) takes any vocabulary: where tp does not
    divide it, its LM head splits the tokens (:func:`vocab_parallel`)."""
    if tp <= 1:
        return
    errs = []
    if cfg.num_heads % tp:
        errs.append(f"num_heads={cfg.num_heads}")
    if cfg.num_kv_heads % tp:
        errs.append(f"num_kv_heads={cfg.num_kv_heads}")
    if cfg.d_ff and cfg.d_ff % tp:
        errs.append(f"d_ff={cfg.d_ff}")
    if cfg.vocab_size % tp and not train:
        errs.append(f"vocab_size={cfg.vocab_size}")
    if "ssm" in cfg.unit_pattern:
        d_inner = cfg.ssm_expand * cfg.d_model
        n_heads = d_inner // cfg.ssm_head_dim
        if n_heads % tp:
            errs.append(f"ssm heads={n_heads}")
    sp = cfg.sparsity
    if sp.pattern is not None and sp.mode in ("slided", "compressed",
                                              "masked"):
        l = sp.pattern[1]
        qdim = cfg.num_heads * cfg.resolved_head_dim
        mlp = ("w_out" if getattr(cfg, "is_encoder_decoder", False)
               else "w_down")
        row_ks = [("attn wo", qdim), (mlp, cfg.d_ff)]
        if "ssm" in cfg.unit_pattern:
            row_ks.append(("ssm wo", cfg.ssm_expand * cfg.d_model))
        for name, k in row_ks:
            # a layer is only packed when L divides its K (pack_params);
            # ste_prune refuses any other K
            if k and k % l == 0 and (k // tp) % l:
                errs.append(f"{name}: K/tp={k // tp} not a multiple of "
                            f"L={l} (pattern group would straddle shards)")
    if errs:
        raise ValueError(f"config incompatible with tp={tp}: "
                         + "; ".join(errs))
