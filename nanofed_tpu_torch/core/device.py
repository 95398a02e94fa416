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


def device_record(device: DeviceLike = None) -> dict:
    """Where a run took place, for its artifact: the device's type, the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (``"not available"`` where it cannot be read), the torch and CUDA
    versions, and the port's kernel launches so far by kernel
    (``ops.launch_counts()``: zero them before the run, read them with this)."""
    import subprocess

    from nanofed_tpu_torch import ops

    dev = torch.device("cuda" if device is None else device)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not available"
    return {
        "type": dev.type,
        "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "nvidia_smi": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_launches": ops.launch_counts(),
    }
