"""Cross-pod gradient compression with error feedback (port of
``repro.runtime.compression``, DESIGN.md section 4).

The pod axis is the slow link: compressing the cross-pod gradient
exchange to int8 (blockwise absmax scales) cuts its wire bytes 2x vs
bf16 / 4x vs fp32.  Int8 summation would overflow, so the exchange is an
all-gather of the int8 blocks and fp32 scales over the ``pod`` group and
a local dequantize-and-mean in pod order; error feedback keeps the
quantization residual on the rank for the next step, so compression
noise does not bias convergence (1-bit-Adam / EF-SGD style).  Within a
pod the reduction stays full precision.

The arithmetic is JAX's as ``compressed_crosspod_mean`` runs it: its
``shard_map`` is called outside ``jit``, so the body runs op by op and
the scale is ``absmax / 127``, a true division.  Under ``jit`` XLA would
rewrite that as ``absmax * (1/127)``, which differs in the last bit on
some blocks (ROADMAP C); the port divides, as the call JAX makes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree

def _quant_block(x: torch.Tensor, block: int = 256):
    """x -> (int8 [nblocks, block], fp32 scales [nblocks, 1]), the
    flattened x zero-padded to whole blocks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.clamp_min(blocks.abs().amax(1, keepdim=True),
                            1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_block(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for dim in shape:
        n *= dim
    return flat[:n].reshape(tuple(shape))


def compressed_crosspod_mean(grad: torch.Tensor, err: torch.Tensor, mesh,
                             block: int = 256):
    """Mean-reduce ``grad`` across the 'pod' axis with the int8 wire
    format; every rank of the mesh calls it with its pod's value.

    err is this rank's error-feedback buffer (fp32, grad's shape).
    Returns (mean_grad in grad's dtype, new_err).  Without a 'pod' axis:
    the identity."""
    if "pod" not in mesh.axis_names:
        return grad, err
    target = grad.to(torch.float32) + err
    q, scale = _quant_block(target, block)
    new_err = target - _dequant_block(q, scale, grad.shape)  # stays local
    qg = mesh.all_gather(q[None], "pod", 0)          # int8 on the wire
    sg = mesh.all_gather(scale[None], "pod", 0)      # fp32 scales (tiny)
    npod = qg.shape[0]
    total = torch.zeros(grad.shape, dtype=torch.float32, device=grad.device)
    for i in range(npod):
        total = total + _dequant_block(qg[i], sg[i], grad.shape)
    return (total / npod).to(grad.dtype), new_err


def tree_compressed_crosspod_mean(grads, errs, mesh, block: int = 256):
    outs = [compressed_crosspod_mean(g, e, mesh, block)
            for g, e in zip(tree.leaves(grads), tree.leaves(errs))]
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))
