"""Quickstart: the SlideSparse pipeline on one linear layer, end to end
(port of ``examples/quickstart.py``).

Mirrors the paper's Figure 5 phases: offline prune + pack -> load-time
compression -> online fused quant(+slide) execution, and checks the
mathematical equivalence (Thm 1) and the storage accounting (Cor 1.2).
The three executions of the 6:8 layer: the dense product, the paper's
slided product (``slide.slided_matmul``, plain fp32) and the compressed
product (``ops.compressed_matmul``: B1's float instance on the card);
then w8a8 through ``ops.slided_matmul_int8`` (B3 on the card).  With
``--device cpu`` the kernels' plain versions run.  Weights and
activations come from a seeded ``torch.Generator``.

Run:  python -m repro_torch.launch.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (Pattern, SlideDecomposition, TWO_FOUR,
                              compress, dense_matmul, family_table,
                              is_hw_compliant, pack_slided, prune_to_pattern,
                              quantize_weight_int8_rowwise, slide)
from repro_torch.kernels import ops

K_IN, M_OUT, BATCH = 1024, 512, 64


def draw(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The layer's weights w [M_OUT, K_IN] (scaled by K^-1/2) and the
    activations x [BATCH, K_IN], from a generator seeded with 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    w = torch.randn((M_OUT, K_IN), generator=gen, device=device) \
        * K_IN ** -0.5
    x = torch.randn((BATCH, K_IN), generator=gen, device=device)
    return w, x


def run(w: torch.Tensor, x: torch.Tensor, device=None) -> dict:
    """The pipeline on ``w`` [M, K] and ``x`` [R, K] (fp32), moved to
    ``device`` (the card unless another is named).  Returns every figure
    the script prints (``family``, ``w_shape``, ``slided_shape``,
    ``gamma``, ``dense_bytes``, ``compressed_bytes``, ``slided_err``,
    ``compressed_err``, ``int8_rel_err``), the outputs (``y_dense``,
    ``y_slided``, ``y_compressed``, ``y_int8``) and what the two kernels
    were given (``x``, ``c``, ``ws_q``, ``s_w``, ``dec``)."""
    device = resolve_device(device)
    w, x = w.to(device), x.to(device)
    dec = SlideDecomposition(Pattern(6, 8), TWO_FOUR)

    # offline phase (§4.1): magnitude prune to 6:8, then Phi (Alg. 2)
    w_sparse = prune_to_pattern(w, dec.source)
    w_slided = pack_slided(w_sparse, dec)
    if not is_hw_compliant(w_slided, dec):
        raise RuntimeError("a 4-window of Phi(W) holds more than 2 non-zeros")

    # initialization phase (§4.3): compress to values + 2-bit metadata
    c = compress(w_slided, dec)
    dense_bytes = w_sparse.numel() * 2  # bf16 reference
    comp_bytes = c.values.numel() * 2 + c.nbytes_meta_packed

    # online phase (§4.2): three equivalent executions
    y_dense = dense_matmul(x, w_sparse)
    y_slided = slide.slided_matmul(x, w_slided, dec)   # paper-faithful
    y_compressed = ops.compressed_matmul(x, c)         # B1

    # w8a8 with the fused quant(+slide) path
    qw = quantize_weight_int8_rowwise(w_sparse)
    ws_q = pack_slided(qw.q, dec)
    y_int8 = ops.slided_matmul_int8(x, ws_q, qw.scale, dec,
                                    out_dtype=torch.float32)   # B3
    rel = (y_int8 - y_dense).abs() / (y_dense.abs() + 1e-2)
    return {
        "family": family_table(8),
        "w_shape": tuple(w.shape), "slided_shape": tuple(w_slided.shape),
        "gamma": float(dec.gamma),
        "dense_bytes": dense_bytes, "compressed_bytes": comp_bytes,
        "slided_err": float((y_slided - y_dense).abs().max()),
        "compressed_err": float((y_compressed - y_dense).abs().max()),
        "int8_rel_err": float(rel.mean()),
        "y_dense": y_dense, "y_slided": y_slided,
        "y_compressed": y_compressed, "y_int8": y_int8,
        "x": x, "c": c, "ws_q": ws_q, "s_w": qw.scale, "dec": dec,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("=== SlideSparse quickstart ===")
    out = run(*draw(device), device)
    print("\n(2N-2):2N family (paper App C.1.5):")
    for row in out["family"]:
        print("  {pattern:>6}  density={density:.3f}  gamma={gamma:.3f}  "
              "S_eff={s_eff:.3f}".format(**row))
    print(f"\nweights: {out['w_shape']} -> slided {out['slided_shape']} "
          f"(gamma={out['gamma']:.2f})")
    dense_b, comp_b = out["dense_bytes"], out["compressed_bytes"]
    print(f"storage: dense {dense_b} B -> compressed {comp_b} B "
          f"({comp_b / dense_b:.3f}x)")
    print("max |slided - dense|   :", out["slided_err"])
    print("max |compressed - dense|:", out["compressed_err"])
    print(f"int8 pipeline mean rel err: {out['int8_rel_err']:.4f}")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"device: {name}")
    print("\nOK — lossless decomposition + near-lossless w8a8.")
    return out


if __name__ == "__main__":
    main()
