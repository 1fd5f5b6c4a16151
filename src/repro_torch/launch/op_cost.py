"""FLOP and byte accounting of a step, from the aten ops it runs (the
counterpart of ``repro.launch.jaxpr_cost``).

JAX walks the jaxpr of a traced step.  The port has no traced program:
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op the
step runs, forward and backward, on real, meta or fake tensors, and
returns JAX's keys:

* ``flops``: matmul, ``bmm``, ``addmm``, ``baddbmm``, convolution and
  SDPA FLOPs, by ``torch.utils.flop_counter``'s formulas (2 x the
  products of a contraction; SDPA as its two matmuls);
* ``bytes``: the unfused operand-plus-result bytes of every op that is
  not a view (an upper bound on device traffic);
* ``bytes_dots``: those bytes of the counted ops only (the weights and
  matmul activations, the fusion-aware proxy of the memory term).

Which of JAX's conventions this changes:

* no trip-count multiplier: the port has no ``scan``; its layer stacks
  are lists, so each unit's ops run, and count, once each;
* remat's recompute is counted where it runs: a backward run under the
  mode replays the checkpointed forwards (JAX's jaxpr holds the
  ``remat`` body once, inside the transposed program);
* a ``cond``'s dearer branch is JAX's; the port counts the branch that
  ran;
* the attention of a step on the card is one SDPA op (its FLOPs by the
  flop counter's formula), where JAX's jaxpr holds two ``dot_general``s.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry, sdpa_flop_count

aten = torch.ops.aten


def _cpu_sdpa_flops(query, key, value, *args, out_val=None, **kwargs):
    """The CPU's fused SDPA (``_scaled_dot_product_flash_attention_for_
    cpu``), which the flop counter's registry lacks: its two matmuls."""
    return sdpa_flop_count(query.shape, key.shape, value.shape)


_FLOPS = dict(flop_registry)
_FLOPS[aten._scaled_dot_product_flash_attention_for_cpu] = _cpu_sdpa_flops


def tensors(xs):
    """The tensors among ``xs`` and in its (nested) lists and tuples."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from tensors(x)


class OpCounter(TorchDispatchMode):
    """Counts ``flops``, ``bytes`` and ``bytes_dots`` (the module
    docstring) of every op run under it, in ``counts``; ``outputs`` sees
    each op's output tensors (a subclass's hook)."""

    def __init__(self):
        super().__init__()
        self.counts = {"flops": 0.0, "bytes": 0.0, "bytes_dots": 0.0}

    def outputs(self, outs: list) -> None:
        pass

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(tensors((out,)))
        self.outputs(outs)
        if getattr(func, "is_view", False):
            return out
        io = sum(t.numel() * t.element_size() for t in tensors(
            (args, tuple(kwargs.values()), outs)))
        self.counts["bytes"] += io
        packet = func.overloadpacket
        if packet in _FLOPS:
            self.counts["flops"] += float(
                _FLOPS[packet](*args, **kwargs, out_val=out))
            self.counts["bytes_dots"] += io
        return out


def of_function(fn, *args, **kwargs) -> dict[str, float]:
    """``fn(*args, **kwargs)`` run under an :class:`OpCounter`: its counts
    (JAX's ``jaxpr_cost.of_function`` keys)."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return dict(counter.counts)
