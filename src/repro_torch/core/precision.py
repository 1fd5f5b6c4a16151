"""PrecisionRecipe — the dtype axis of the SlideSparse pipeline (§3.3/§4.2).

Port of ``repro.core.precision``.  A recipe names the per-token activation
quantizer (``act``: None | 'int8' | 'fp8'), the weight storage
(``weight``: None | 'int8' | 'w4' nibble-packed int4) and the output
dtype (``out``: None follows the input).  int8 activations against
integer weights accumulate exactly in int32; any fp8 operand accumulates
in fp32.

====== ====== ======== ===========
name   act    weight   accumulate
====== ====== ======== ===========
none   —      —        fp32
int8   int8   int8     int32
fp8    fp8    int8     fp32
w4     int8   w4       int32
fp8w4  fp8    w4       fp32
====== ====== ======== ===========
"""
from __future__ import annotations

import dataclasses

import torch

from . import quant

_ACTS = (None, "int8", "fp8")
_WEIGHTS = (None, "int8", "w4")


@dataclasses.dataclass(frozen=True)
class PrecisionRecipe:
    """One point on the (activation x weight-storage x out-dtype) grid."""

    name: str = "none"
    act: str | None = None
    weight: str | None = None
    out: str | None = None

    def __post_init__(self):
        if self.act not in _ACTS:
            raise ValueError(f"unknown activation precision {self.act!r};"
                             f" expected one of {_ACTS}")
        if self.weight not in _WEIGHTS:
            raise ValueError(f"unknown weight storage {self.weight!r};"
                             f" expected one of {_WEIGHTS}")
        if (self.act is None) != (self.weight is None):
            raise ValueError(
                f"recipe {self.name!r}: act={self.act!r} and "
                f"weight={self.weight!r} must be both quantized or both "
                "float")

    @property
    def quantized(self) -> bool:
        return self.act is not None

    @property
    def packed_weights(self) -> bool:
        return self.weight == "w4"

    def out_dtype(self, x_dtype: torch.dtype) -> torch.dtype:
        return getattr(torch, self.out) if self.out is not None else x_dtype

    def quantize_act(self, x: torch.Tensor,
                     absmax: torch.Tensor | None = None) -> quant.Quantized:
        if self.act == "int8":
            return quant.quantize_int8(x, absmax)
        if self.act == "fp8":
            return quant.quantize_fp8(x, absmax)
        raise ValueError(f"recipe {self.name!r} has no activation quantizer")

    def quantize_weight(self, w: torch.Tensor) -> quant.Quantized:
        """UNPACKED int8 values even for 'w4'; nibble packing happens
        after Phi/compression."""
        if self.weight == "int8":
            return quant.quantize_weight_int8_rowwise(w)
        if self.weight == "w4":
            return quant.quantize_weight_int4_rowwise(w)
        raise ValueError(f"recipe {self.name!r} has no weight quantizer")


RECIPES: dict[str, PrecisionRecipe] = {
    "none": PrecisionRecipe("none"),
    "int8": PrecisionRecipe("int8", act="int8", weight="int8"),
    "fp8": PrecisionRecipe("fp8", act="fp8", weight="int8"),
    "w4": PrecisionRecipe("w4", act="int8", weight="w4"),
    "fp8w4": PrecisionRecipe("fp8w4", act="fp8", weight="w4"),
}

NONE = RECIPES["none"]


def resolve(recipe, act_quant: str | None = None) -> PrecisionRecipe:
    """Normalize ``recipe`` (PrecisionRecipe | name | None) to a recipe;
    with ``recipe=None`` the legacy ``act_quant`` (None | 'int8') maps
    onto the equivalent registry entry."""
    if isinstance(recipe, PrecisionRecipe):
        return recipe
    if isinstance(recipe, str):
        if recipe not in RECIPES:
            raise ValueError(f"unknown precision recipe {recipe!r}; known:"
                             f" {sorted(RECIPES)}")
        return RECIPES[recipe]
    if recipe is not None:
        raise TypeError(f"recipe must be a PrecisionRecipe, a registry name"
                        f" or None, got {type(recipe).__name__}")
    if act_quant is None:
        return NONE
    if act_quant != "int8":
        raise ValueError(f"unknown act_quant {act_quant!r} (legacy axis:"
                         " None | 'int8'); use recipe=... for anything else")
    return RECIPES["int8"]
