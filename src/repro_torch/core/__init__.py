"""Core SlideSparse algebra (patterns, packer, slide, compression, quant),
re-exported as ``repro.core`` exports it."""
from .patterns import (  # noqa: F401
    Pattern, HardwarePattern, SlideDecomposition, TWO_FOUR, ONE_FOUR,
    family_table,
)
from .slide import (  # noqa: F401
    phi, lift, lift_index_map, slided_matmul, unslid_matmul, dense_matmul,
    decomposition_for,
)
from .packer import (  # noqa: F401
    pack_slided, pack_slided_ref, unslide, is_hw_compliant, prune_to_pattern,
    pattern_violations, pack_nibbles, unpack_nibbles,
)
from .compressed import (  # noqa: F401
    CompressedSlided, compress, decompress_slided, decompress_original,
    pack_meta, unpack_meta,
)
from .quant import (  # noqa: F401
    Quantized, quantize_int8, quantize_fp8, dequantize,
    quantize_weight_int8_rowwise, quantize_weight_int4_rowwise,
    int8_matmul_dequant, matmul_dequant,
)
from .masks import magnitude_mask, ste_prune  # noqa: F401
from .precision import PrecisionRecipe, RECIPES  # noqa: F401
from .linear import SparsityConfig, DENSE  # noqa: F401
from . import linear, precision  # noqa: F401
