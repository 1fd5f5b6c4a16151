"""The step functions shared by the trainer and the server (port of
``repro.runtime.steps``).

``train_step`` given a ``rules.Layout`` runs the sharded step, the port's
form of JAX's ``jit(train_step, in_shardings=...)`` on a mesh.  Between
steps each rank holds only its pieces of the parameters and optimizer
state, laid out by JAX's rules.  The step splits its compute along the
mesh's ``model`` axis, as GSPMD splits JAX's, Megatron-style: over t
ranks, t the largest divisor of the axis the config allows
(:func:`split_degree`: whole heads, KV heads, SSM heads, d_ff and vocab
slices a rank, or where t does not divide the vocabulary a block of the
sequence for the LM head; the axis' other ranks are replicas that
compute the same).  In the step:
- each parameter piece becomes this rank's compute shard (``_Shard``):
  gathered over the data-parallel axes, and cut to this rank's block of
  t along the dim its role splits (``tp.shard_dim``: column-parallel
  leaves on their output, row-parallel on their input, per-head SSM
  leaves on the heads; replicated leaves whole, and the LM head whole
  where it splits the tokens: :func:`shard_dims`).  Where the piece is
  stored split along ``model`` on that dim over all t ranks it is kept
  as it is; elsewhere (``wo`` and ``w_down``, stored ``out:model``;
  granite's expert stacks, stored on the expert dim) it is gathered
  whole and cut;
- ``M.loss_fn`` runs on this rank's ``batch_spec`` slice under a
  tensor-parallel context over the t ranks (``tp.activate(mesh=...)``),
  so each rank computes its heads, F-slices and vocab slice with the
  autograd collectives of ``sharding.tp``, and with
  ``cfg.sequence_parallel`` splits the residual stream along S; the
  loss is weighted by the slice's share of the global count of labels
  (the ranks' weighted losses sum to the global ``total / count``, where
  a mean of the local means would not);
- the backward mirrors the forward: a compute shard's gradient is
  all-gathered over the t ranks where its piece was gathered whole,
  then summed over the data-parallel axes (``pod``, ``data``) and cut
  to the rank's piece (``reduce_grad``);
- AdamW updates the pieces (``adamw.update`` given the layout).
An encoder-decoder splits the same way: its encoder, decoder and
cross-attention by heads, its GELU MLP by d_ff (``models.encdec``).

``serve_step`` given a mesh runs the sequence-sharded serve step, the
port's form of JAX's decode under ``rules.cache_spec`` (the long_500k
cells: a batch of 1 over a cache split along S over every axis): each
rank holds its S-slice of every attention cache (:func:`seq_cache`) and
its tensor-parallel shard of the weights (:func:`serve_params`), runs its
heads under ``tp`` over the ``model`` axis and attends over its S-slice
under ``sharding.seq``; :func:`decode` is a greedy loop over it.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import transformer
from repro_torch.optim import adamw, schedule
from repro_torch.sharding import rules, seq, tp


def trainable(params) -> list[torch.Tensor]:
    """The parameter tree's float leaves, each set to require grad (in
    visiting order, as ``tree.leaves``)."""
    out = tree.leaves(params)
    for p in out:
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    return out


def _grads(cfg: ModelConfig, params, leaves, batch):
    loss = M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def reduce_grad(g: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """A whole leaf's gradient on this rank (of its weighted batch slice)
    -> the piece's gradient: summed over the data-parallel axes, cut to
    the piece.  A dim sharded over a data-parallel axis is
    reduce-scattered over it, a dim sharded over another axis (whose
    ranks hold the same gradient) narrowed locally, and the leaf summed
    over the data-parallel axes that shard none of its dims; fp32."""
    g = g.to(torch.float32)
    dp = dp_axes(mesh)
    dims = rules.sharded_dims(spec, g.dim())
    for d, axes in dims:  # narrow first: less to send
        if not set(axes) & set(dp):
            g = rules.cut(g, (None,) * d + (spec[d],), mesh)
    done = set()
    for d, axes in dims:
        if not set(axes) & set(dp):
            continue
        for a in axes:  # major to minor
            if a in dp:
                g = mesh.reduce_scatter(g, a, d)
                done.add(a)
            else:
                n = g.shape[d] // mesh.axis_size(a)
                g = g.narrow(d, mesh.coord(a) * n, n)
    return mesh.all_reduce(g, [a for a in dp if a not in done], "sum")


def split_degree(cfg: ModelConfig, mesh) -> int:
    """t, the ranks of the ``model`` axis a step's compute splits over:
    its largest divisor that ``tp.validate`` accepts for a training step
    of ``cfg`` (any vocabulary: the LM head splits the tokens where t
    does not divide it)."""
    return tp.degree(cfg, mesh.axis_size("model"), train=True)


def _drop(spec: tuple, dim: int) -> tuple:
    return tuple(None if d == dim else ax for d, ax in enumerate(spec))


class _Shard(torch.autograd.Function):
    """This rank's compute shard of a leaf from its piece: the whole leaf
    (``dim`` None), or its block along ``dim`` on ``axis`` (the t ranks
    of the split), with the piece's ``model`` split kept where it is that
    block; the backward gives the piece its gradient (``reduce_grad``).
    Every rank runs the same graph, so the backward collectives run in
    the same order on every rank."""

    @staticmethod
    def forward(ctx, piece, spec, dim, mesh, axis):
        ctx.spec, ctx.dim, ctx.mesh, ctx.axis = spec, dim, mesh, axis
        if dim is None:
            return rules.gather_leaf(piece, spec, mesh)
        if _kept(spec, dim, axis):
            return rules.gather_leaf(piece, _drop(spec, dim), mesh)
        whole = rules.gather_leaf(piece, spec, mesh)
        n = whole.shape[dim] // mesh.axis_size(axis)
        return whole.narrow(dim, mesh.coord(axis) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        spec, dim, mesh, axis = ctx.spec, ctx.dim, ctx.mesh, ctx.axis
        if dim is None:
            return reduce_grad(g, spec, mesh), None, None, None, None
        if _kept(spec, dim, axis):
            return (reduce_grad(g, _drop(spec, dim), mesh), None, None,
                    None, None)
        whole = mesh.all_gather(g, axis, dim)
        return reduce_grad(whole, spec, mesh), None, None, None, None


def _kept(spec: tuple, dim: int, axis: str) -> bool:
    """Whether the piece is stored split over all the split's ranks on
    the split's own dim (the split spans the whole ``model`` axis)."""
    return axis == "model" and dim < len(spec) and spec[dim] == "model"


def shard_dims(params, cfg: ModelConfig, t: int) -> list:
    """Per leaf (``tree.leaves`` order) the dim its tensor-parallel role
    in a training step over ``t`` ranks splits (``tp.shard_dim``), or
    None for a leaf every rank computes whole (the LM head where ``t``
    does not divide the vocabulary)."""
    vp = tp.vocab_parallel(cfg, t)
    return [tp.shard_dim(names, len(shape) - stacked, vocab_parallel=vp)
            for names, shape, stacked in rules.stacked_leaves(params)]


def loss_weight(count, total):
    """This rank's weight on its local mean loss: its slice's share of the
    global label count, so the weighted losses sum to ``total / count``
    over the global batch."""
    return torch.clamp_min(count, 1.0) / torch.clamp_min(total, 1.0)


def check_moe_groups(cfg: ModelConfig, local_tokens: int, dp: int):
    """The MoE dispatch groups of a sharded step must be JAX's: tokens
    are grouped ``tg = min(group_size, tokens)`` over the global batch.
    A rank that holds whole global groups dispatches the same groups; so
    does one whose groups, and the global ones, can drop no token (``cap
    >= tg``).  Anything else would compute other drops and raises."""
    if not cfg.uses_moe:
        return
    spec = transformer.moe_spec(cfg)
    total = local_tokens * dp
    tg_global = min(spec.group_size, total)
    tg_local = min(spec.group_size, local_tokens)
    if local_tokens % tg_global == 0 and tg_local == tg_global:
        return

    def cap(tg):
        return max(1, int(spec.capacity_factor * tg * spec.top_k
                          / spec.num_experts))

    if cap(tg_global) >= tg_global and cap(tg_local) >= tg_local:
        return
    raise ValueError(
        f"{cfg.name}: a rank's {local_tokens} tokens are not whole MoE "
        f"groups of the global batch's {tg_global}, and the capacity "
        f"(factor {spec.capacity_factor}) can drop tokens, so the sharded "
        "step would drop others than JAX's; give each rank whole groups "
        "(ROADMAP C, the MoE group rule)")


def sharded_grads(cfg: ModelConfig, params, batch, layout):
    """(global mean loss, the pieces' gradients) of this rank's batch
    slice under ``layout``; every rank of the mesh calls it."""
    mesh = layout.mesh
    dp = dp_axes(mesh)
    labels = batch["labels"]
    check_moe_groups(cfg, labels.numel(),
                     math.prod(mesh.axis_size(a) for a in dp))
    pieces = trainable(params)
    t = split_degree(cfg, mesh)
    axis = mesh.split("model", t)
    dims = shard_dims(params, cfg, t) if t > 1 else [None] * len(pieces)
    shards = [_Shard.apply(p, s, d, mesh, axis)
              for p, s, d in zip(pieces, layout.params, dims)]
    count = (labels >= 0).sum().to(torch.float32)
    total = mesh.all_reduce(count, dp, "sum")
    with contextlib.ExitStack() as stack:
        if t > 1:
            stack.enter_context(tp.activate(mesh=mesh, axis=axis))
        loss = M.loss_fn(tree.unflatten(params, shards), cfg, batch)
        weighted = loss * loss_weight(count, total)
        grads = torch.autograd.grad(weighted, pieces, allow_unused=True,
                                    materialize_grads=True)
    return mesh.all_reduce(weighted.detach(), dp, "sum"), grads


def train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
               params, opt_state: adamw.OptState, batch, accum: int = 1,
               layout=None):
    """loss -> grads -> global-norm clip -> AdamW (params updated in
    place).  Returns (params, opt_state, metrics {'loss', 'grad_norm',
    'lr'}), every metric a device tensor.

    accum > 1: the batch is split into ``accum`` microbatches along its
    first axis, run in turn, their grads summed in fp32; loss and grads
    are divided by ``accum`` (one big batch's math, ~1/accum of its
    activation memory).

    layout: a ``rules.Layout``: ``params`` and ``opt_state`` are this
    rank's pieces, ``batch`` its slice of the global batch, and every
    rank of ``layout.mesh`` calls the step (the module docstring)."""
    leaves = trainable(params)
    if layout is None:
        grads_of = functools.partial(_grads, cfg, params, leaves)
    else:
        grads_of = functools.partial(sharded_grads, cfg, params,
                                     layout=layout)
    if accum <= 1:
        loss, grads = grads_of(batch)
    else:
        n = next(iter(batch.values())).shape[0] // accum
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(accum):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, g = grads_of(mb)
            loss = loss + l
            for a, b in zip(acc, g):
                a.add_(b.to(torch.float32))
        loss = loss / accum
        grads = [a / accum for a in acc]
    grads = tree.unflatten(params, grads)
    lr_scale = schedule.warmup_cosine(opt_state.step)
    params, opt_state, metrics = adamw.update(params, grads, opt_state,
                                              opt_cfg, lr_scale, layout)
    return params, opt_state, dict(metrics, loss=loss)


def prefill_step(cfg: ModelConfig, max_len: int, params, batch):
    return M.prefill(params, cfg, batch["tokens"], max_len=max_len,
                     extra_embeds=M._extra_embeds(cfg, batch))


# ---------------------------------------- the sequence-sharded serve step
def serve_axis(cfg: ModelConfig, mesh) -> str:
    """The axis the sequence-sharded serve step's tensor parallelism runs
    over: blocks of t ranks of ``model``, t its largest divisor that
    ``tp.validate`` accepts (the dry run's ``serve_tp``; the axis' other
    ranks are replicas).  Every rank of the mesh calls it."""
    if getattr(cfg, "is_encoder_decoder", False):
        raise ValueError(f"{cfg.name}: the sequence-sharded serve step "
                         "covers decoder-only stacks")
    return mesh.split("model", tp.degree(cfg, mesh.axis_size("model")))


def serve_params(params, cfg: ModelConfig, mesh):
    """This rank's tensor-parallel shard of a whole (packed) parameter
    tree for the sequence-sharded serve step (``tp.shard_params``)."""
    axis = serve_axis(cfg, mesh)
    return tp.shard_params(params, cfg, mesh.coord(axis),
                           mesh.axis_size(axis))


def seq_cache(cfg: ModelConfig, batch: int, max_len: int, mesh,
              device=None):
    """(this rank's zeroed piece of the one-shot cache, its
    ``rules.CacheLayout``) for a batch of ``batch`` rows and ``max_len``
    positions, built at the local shapes (no rank holds the whole
    cache).  Attention caches split as ``rules.cache_spec`` says, SSM
    state by the step's tensor parallelism (:func:`serve_axis`)."""
    axis = serve_axis(cfg, mesh)
    whole = M.make_cache(cfg, batch, max_len, device="meta")
    layout = rules.serve_cache_layout(
        whole, mesh, axis if mesh.axis_size(axis) > 1 else None)
    return rules.local_cache(whole, layout,
                             mesh.device if device is None else device), \
        layout


@contextlib.contextmanager
def serving(cfg: ModelConfig, mesh, layout):
    """The dynamic extent of one rank's share of the sequence-sharded
    serve step: tensor parallelism over :func:`serve_axis` of ``mesh``,
    and the cache's S-slice (``layout.seq``) for the attention layers."""
    with tp.activate(mesh=mesh, axis=serve_axis(cfg, mesh)), \
            seq.activate(layout.seq):
        yield


def serve_step(cfg: ModelConfig, params, token, cache, kv_len, mesh=None,
               layout=None):
    """One decode token: (logits [B, V], cache, kv_len + 1).  With
    ``mesh`` (a ``sharding.ctx.Mesh``; every rank calls the step) this is
    the sequence-sharded step: ``params`` this rank's shard
    (:func:`serve_params`), ``cache`` its piece and ``layout`` that
    piece's layout (:func:`seq_cache`), ``token`` / ``kv_len`` its rows
    of the batch; the logits come back whole on every rank."""
    if mesh is None:
        return M.serve_step(params, cfg, token, cache, kv_len)
    if layout is None:
        raise ValueError("a serve step over a mesh needs the cache's "
                         "layout (steps.seq_cache)")
    with serving(cfg, mesh, layout):
        logits, cache, kv_len = M.serve_step(params, cfg, token, cache,
                                             kv_len)
        return tp.gather_last(logits), cache, kv_len


@torch.no_grad()
def decode(cfg: ModelConfig, params, token, cache, kv_len, n: int,
           mesh=None, layout=None):
    """Greedy-decode ``n`` tokens from a given cache, the first fed
    ``token`` [B] at ``kv_len`` [B], each step :func:`serve_step` (over
    ``mesh``, its sequence-sharded one): (tokens [B, n] int32, the whole
    logits [B, n, V] of each step, cache, kv_len + n).  The ids are the
    logits' argmax, ties to the lowest index as ``jnp.argmax``."""
    toks, outs = [], []
    for _ in range(n):
        lg, cache, kv_len = serve_step(cfg, params, token, cache, kv_len,
                                       mesh, layout)
        token = torch.argmax(lg, -1).to(torch.int32)
        toks.append(token)
        outs.append(lg)
    return torch.stack(toks, 1), torch.stack(outs, 1), cache, kv_len


def bind(fn, *static):
    """``functools.partial`` keeping the function's ``__name__``."""
    out = functools.partial(fn, *static)
    out.__name__ = fn.__name__  # type: ignore[attr-defined]
    return out
