"""SlideSparse on PyTorch and CUDA: the port of the ``repro`` JAX package.

Laid out module for module like ``repro`` (``core``, ``kernels``,
``models``, ``runtime``, ``launch``, ``configs``) so each counterpart is
found under the same name.  Plain tensor code is PyTorch; the kernels
(compressed matmul, paged attention, the fused slided matmul, quant+lift
and the dense quantized matmul) are hand-written CUDA C++ for sm_90a
under ``csrc/``, built with nvcc at first use.

TF32 is switched off for the whole process on import: the JAX float path
accumulates in full fp32, and the port's float matmuls (plain versions,
the one-shot attention) must do the same to be held against it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; asking for
    nothing when CUDA is missing is an error, never a silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(or --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
