"""The step functions shared by the trainer and the server (port of
``repro.runtime.steps``)."""
from __future__ import annotations

import functools

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw, schedule


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


def train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
               params, opt_state: adamw.OptState, batch, accum: int = 1):
    """loss -> grads -> global-norm clip -> AdamW (params updated in
    place).  Returns (params, opt_state, metrics {'loss', 'grad_norm',
    'lr'}), every metric a device tensor.

    accum > 1: the batch is split into ``accum`` microbatches along its
    first axis, run in turn, their grads summed in fp32; loss and grads
    are divided by ``accum`` (one big batch's math, ~1/accum of its
    activation memory)."""
    leaves = trainable(params)
    if accum <= 1:
        loss, grads = _grads(cfg, params, leaves, batch)
    else:
        n = next(iter(batch.values())).shape[0] // accum
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(accum):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l, g = _grads(cfg, params, leaves, mb)
            loss = loss + l
            for a, b in zip(acc, g):
                a.add_(b.to(torch.float32))
        loss = loss / accum
        grads = [a / accum for a in acc]
    grads = tree.unflatten(params, grads)
    lr_scale = schedule.warmup_cosine(opt_state.step)
    params, opt_state, metrics = adamw.update(params, grads, opt_state,
                                              opt_cfg, lr_scale)
    return params, opt_state, dict(metrics, loss=loss)


def prefill_step(cfg: ModelConfig, max_len: int, params, batch):
    return M.prefill(params, cfg, batch["tokens"], max_len=max_len,
                     extra_embeds=M._extra_embeds(cfg, batch))


def serve_step(cfg: ModelConfig, params, token, cache, kv_len):
    return M.serve_step(params, cfg, token, cache, kv_len)


def bind(fn, *static):
    """``functools.partial`` keeping the function's ``__name__``."""
    out = functools.partial(fn, *static)
    out.__name__ = fn.__name__  # type: ignore[attr-defined]
    return out
