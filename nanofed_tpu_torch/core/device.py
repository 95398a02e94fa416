"""Device selection for every entry point of the port.

The port runs on the card unless the caller asks for the CPU: ``device=None`` means
``"cuda"``, and a missing card is an error, never a silent fall back to the CPU
(a CPU run measures PyTorch's CPU kernels, not the port).
"""

from __future__ import annotations

import torch

DeviceLike = str | torch.device | None


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent.

    On CUDA this also turns TF32 off for cuDNN convolutions and cuBLAS matrix
    products: the port's float32 path is held to full-float32 references (the JAX
    package's ``Precision.HIGHEST`` reduce, the CPU cross-check), and TF32 keeps
    only about three decimal digits.  The bf16 path casts explicitly inside the
    loss and is not affected.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: nanofed_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
