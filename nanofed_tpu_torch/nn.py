"""Minimal functional layer library (counterpart of ``nanofed_tpu/nn.py``).

Models are pure functions over explicit param dicts, as in the JAX package, so a
whole cohort of clients trains under one ``torch.func.vmap``.  The interface keeps
the JAX package's layouts — NHWC activations, HWIO conv kernels, ``[in, out]`` dense
kernels — so weights interchange with no transposes; :func:`conv2d` and
:func:`max_pool` permute to PyTorch's NCHW/OIHW inside (the NHWC tensor permuted is
exactly a channels-last NCHW tensor, which cuDNN takes without a copy).

Randomness is explicit: init draws from a ``torch.Generator``, and dropout takes a
keep-mask drawn by the caller (``trainer.local``, through :func:`keep_mask`), never a
generator of its own.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from nanofed_tpu_torch.core.device import DeviceLike, resolve_device
from nanofed_tpu_torch.core.types import Params

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _fan_in(shape: Sequence[int]) -> int:
    if len(shape) == 2:  # dense [in, out]
        return shape[0]
    return shape[-2] * math.prod(shape[:-2])  # conv [kh, kw, cin, cout]


def _uniform(gen: torch.Generator, shape: Sequence[int], bound: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return u * (2.0 * bound) - bound


def kaiming_uniform(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's default Conv2d/Linear bound, the
    same bound as the JAX package's init (``nanofed_tpu/nn.py:38-44``)."""
    return _uniform(gen, shape, 1.0 / math.sqrt(_fan_in(shape)))


def uniform_bias(gen: torch.Generator, fan_in: int, shape: Sequence[int]) -> torch.Tensor:
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_features: int, out_features: int) -> Params:
    return {
        "bias": uniform_bias(gen, in_features, (out_features,)),
        "kernel": kaiming_uniform(gen, (in_features, out_features)),
    }


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"] + params["bias"]


def conv2d_init(
    gen: torch.Generator, in_channels: int, out_channels: int, kernel_size: int,
    use_bias: bool = True,
) -> Params:
    k = kernel_size
    params = {}
    if use_bias:
        params["bias"] = uniform_bias(gen, in_channels * k * k, (out_channels,))
    params["kernel"] = kaiming_uniform(gen, (k, k, in_channels, out_channels))
    return params


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dimension: ``ceil(size / stride)``
    outputs, the total padding split with the smaller half before (``lo = total //
    2``).  A 3x3 stride-2 window over an even size pads (0, 1), where torch's
    ``padding=1`` would pad (1, 1) and shift every window by a pixel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(
    params: Params, x: torch.Tensor, *, stride: int = 1, padding: str = "VALID"
) -> torch.Tensor:
    """NHWC input, HWIO kernel, NHWC output; ``padding`` is ``"VALID"`` or XLA's
    ``"SAME"`` (:func:`same_padding`, padded explicitly when it is asymmetric).

    A 1x1 kernel is a product over the channels of every ``stride``-th pixel (SAME
    pads nothing there), computed as one: torch's CPU backward of a strided 1x1
    convolution over a channels-last input aborts the process at some shapes (an
    input of [6, 32, 32, 8] into 16 channels at stride 2)."""
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    if params["kernel"].shape[:2] == (1, 1):
        out = x[:, ::stride, ::stride, :] @ params["kernel"][0, 0]
        return out + params["bias"] if "bias" in params else out
    kernel = params["kernel"].permute(3, 2, 0, 1)
    xc = x.permute(0, 3, 1, 2)
    pad: tuple[int, int] | int = 0
    if padding == "SAME":
        (top, bottom), (left, right) = (
            same_padding(size, k, stride) for size, k in zip(xc.shape[2:], kernel.shape[2:]))
        if top == bottom and left == right:
            pad = (top, left)
        else:
            xc = F.pad(xc, (left, right, top, bottom))
    out = F.conv2d(xc, kernel, params.get("bias"), stride=stride, padding=pad)
    return out.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """NHWC non-overlapping max pooling (stride = window, VALID padding)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window)
    return out.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int = 2, stride: int | None = None) -> torch.Tensor:
    """NHWC average pooling, VALID padding (stride defaults to the window)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), window, window if stride is None else stride)
    return out.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, C]."""
    return x.mean(dim=(1, 2))


def group_norm_init(num_channels: int, dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> Params:
    """GroupNorm's unit scale and zero bias; ``device=None`` is the card."""
    dev = resolve_device(device)
    return {"bias": torch.zeros(num_channels, dtype=dtype, device=dev),
            "scale": torch.ones(num_channels, dtype=dtype, device=dev)}


def group_norm(params: Params, x: torch.Tensor, num_groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC input, groups of contiguous channels, as the JAX package's
    (``nanofed_tpu/nn.py:174-184``).  The statistics are the population mean and
    variance taken in float32 and rounded to ``x``'s dtype, as ``jnp.mean`` and
    ``jnp.var`` give them for bf16; the normalisation then runs in ``x``'s dtype."""
    n, h, w, c = x.shape
    g = min(num_groups, c)
    while c % g != 0:
        g -= 1
    xg = x.reshape(n, h, w, g, c // g)
    xf = xg.float()
    mean = xf.mean(dim=(1, 2, 4), keepdim=True).to(x.dtype)
    var = xf.var(dim=(1, 2, 4), keepdim=True, correction=0).to(x.dtype)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return xg.reshape(n, h, w, c) * params["scale"] + params["bias"]


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """Inverted dropout with a caller-drawn boolean keep-mask shaped like ``x``;
    identity when ``keep`` is None (eval, or dropout off)."""
    if keep is None or rate == 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


# lowbias32's multipliers (C. Wellons' integer-hash search), as int32 values.
_M1, _M2 = 0x7FEB352D, 0x846CA68B - (1 << 32)
_INT32_MIN = -(1 << 31)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of an int32 tensor (``>>`` sign-extends)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a bijective hash of int32 tensors.  Products wrap modulo 2^32, so
    the bits are the same on the CPU and on the card."""
    x = x ^ _shr(x, 16)
    x = x * _M1
    x = x ^ _shr(x, 15)
    x = x * _M2
    return x ^ _shr(x, 16)


def keep_mask(
    row_keys: torch.Tensor, position_keys: torch.Tensor, shape: Sequence[int], rate: float
) -> torch.Tensor:
    """Bernoulli(1 - rate) keep-masks ``[k, *shape]``, counter-based: element
    ``(i, j)`` is kept iff a hash of ``row_keys[i] + position_keys[j]`` (int32 ``[k]``
    and ``[prod(shape)]``, both already hashed), read as an unsigned 32-bit number, is
    at least ``rate * 2^32``.  A mask is a function of its keys only, whatever else
    the call holds."""
    x = row_keys[:, None] + position_keys[None, :]
    x = x * _M1
    x ^= _shr(x, 15)
    x *= _M2
    x ^= _INT32_MIN  # now signed order is the unsigned order shifted by 2^31
    threshold = min(round(rate * 2**32), 2**32 - 1) + _INT32_MIN
    return (x >= threshold).view(row_keys.shape[0], *shape)


relu = torch.relu


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    return F.log_softmax(x, dim=-1)


def flatten(x: torch.Tensor) -> torch.Tensor:
    """[N, ...] -> [N, prod(...)]."""
    return x.reshape(x.shape[0], -1)
