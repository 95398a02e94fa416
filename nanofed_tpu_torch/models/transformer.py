"""The GPT-style causal transformer LM (counterpart of
``nanofed_tpu/models/transformer.py``).

Token embedding plus a learned positional embedding, ``depth`` pre-LN blocks of
multi-head causal self-attention and a 4x GELU MLP, a final LayerNorm and an untied
head.  ``apply`` returns the LAST position's next-token log-probs ``[N, vocab]``, so
the model trains through the masked-NLL fit with ``y`` the true next token;
:func:`apply_sequence` gives every position's ``[N, T, vocab]``.

Params are one flat dict in the JAX package's ravel order (sorted keys per level, so
at depth 12 ``block_10`` and ``block_11`` come before ``block_2``).  Two layouts, as
in the JAX package: unrolled ``block_<i>/...`` leaves, or (``scan_layers=True``, the
``transformer_lm_scan`` name) stacked ``blocks/...`` leaves with a leading
``[depth]`` dim, which the forward loops over; each layout's checkpoints interchange
with the JAX package's, and :func:`stack_blocks`/:func:`unstack_blocks` migrate
between them.

What the JAX forward does, kept here: ``jax.nn.gelu``'s tanh approximation, the
population variance in LayerNorm, the causal mask filled with the dtype's most
negative finite value (not ``-inf``), and a log-softmax over all ``[N, T, vocab]``
positions before ``apply`` keeps the last one.

Init draws from the generator's device: N(0, 0.02) embeddings, the zoo's
``dense_init`` elsewhere, the output projections ``wo`` and ``fc2`` scaled by
``1/sqrt(2*depth)``; the draws follow the JAX distributions, not its bits (parity
tests carry the JAX weights across with ``utils.trees.from_numpy_params``).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from nanofed_tpu_torch import nn
from nanofed_tpu_torch.core.types import Params
from nanofed_tpu_torch.models.base import Model, register_model
from nanofed_tpu_torch.utils.trees import flatten_with_names, unflatten_names

DEFAULT_VOCAB = 256
DEFAULT_SEQ_LEN = 32
DEFAULT_WIDTH = 64
DEFAULT_DEPTH = 2
DEFAULT_HEADS = 4


def _block_shapes(width: int) -> dict[str, Any]:
    dense = lambda i, o: {"bias": (o,), "kernel": (i, o)}  # noqa: E731
    norm = {"bias": (width,), "scale": (width,)}
    return {
        "attn": {"wk": dense(width, width), "wo": dense(width, width),
                 "wq": dense(width, width), "wv": dense(width, width)},
        "ln1": dict(norm), "ln2": dict(norm),
        "mlp": {"fc1": dense(width, 4 * width), "fc2": dense(4 * width, width)},
    }


def transformer_param_shapes(
    vocab: int, seq_len: int, width: int, depth: int, scan_layers: bool = False
) -> dict[str, tuple[int, ...]]:
    """Every leaf's shape, in the ravel order of :func:`init_transformer`'s params,
    computed without drawing anything (the flagships' counts and order)."""
    tree: dict[str, Any] = {
        "head": {"bias": (vocab,), "kernel": (width, vocab)},
        "ln_f": {"bias": (width,), "scale": (width,)},
        "pos_emb": (seq_len, width),
        "tok_emb": (vocab, width),
    }
    if scan_layers:
        tree["blocks"] = {name: (depth, *shape)
                          for name, shape in flatten_with_names(_block_shapes(width)).items()}
    else:
        for i in range(depth):
            tree[f"block_{i}"] = _block_shapes(width)
    return flatten_with_names(tree)


def _layer_norm_init(dim: int, device: torch.device) -> Params:
    return {"bias": torch.zeros(dim, device=device), "scale": torch.ones(dim, device=device)}


def init_transformer(
    gen: torch.Generator,
    vocab: int,
    seq_len: int,
    width: int,
    depth: int,
    scan_layers: bool = False,
) -> Params:
    """The LM's params drawn from ``gen`` on its device; ``scan_layers=True`` stacks
    the per-layer draws into ``blocks/...`` leaves (the same values layer for
    layer)."""
    dev = gen.device
    normal = lambda *shape: 0.02 * torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    params: dict[str, Any] = {
        "tok_emb": normal(vocab, width),
        "pos_emb": normal(seq_len, width),
        "head": nn.dense_init(gen, width, vocab),
        "ln_f": _layer_norm_init(width, dev),
    }
    resid_scale = 1.0 / math.sqrt(2.0 * depth)
    blocks = []
    for _ in range(depth):
        attn = {name: nn.dense_init(gen, width, width) for name in ("wq", "wk", "wv", "wo")}
        attn["wo"]["kernel"] = attn["wo"]["kernel"] * resid_scale
        mlp = {"fc1": nn.dense_init(gen, width, 4 * width),
               "fc2": nn.dense_init(gen, 4 * width, width)}
        mlp["fc2"]["kernel"] = mlp["fc2"]["kernel"] * resid_scale
        blocks.append({"ln1": _layer_norm_init(width, dev), "attn": attn,
                       "ln2": _layer_norm_init(width, dev), "mlp": mlp})
    if scan_layers:
        flat = [flatten_with_names(b) for b in blocks]
        params["blocks"] = {name: torch.stack([b[name] for b in flat]) for name in flat[0]}
    else:
        for i, blk in enumerate(blocks):
            params[f"block_{i}"] = blk
    return flatten_with_names(params)


def _depth(params: Params) -> int:
    if "blocks/ln1/scale" in params:
        return int(params["blocks/ln1/scale"].shape[0])
    return sum(1 for name in params if name.startswith("block_") and name.endswith("/ln1/scale"))


def stack_blocks(params: Params) -> Params:
    """Unrolled layout (``block_0 .. block_{L-1}``) -> scan layout (stacked ``blocks``
    leaves); :func:`unstack_blocks` is the exact inverse.  Other leaves are shared."""
    depth = _depth(params)
    if depth == 0 or "blocks/ln1/scale" in params:
        raise ValueError("no block_<i> entries to stack — already scan layout?")
    out = {k: v for k, v in params.items() if not k.startswith("block_")}
    for suffix in (k[len("block_0/"):] for k in params if k.startswith("block_0/")):
        out[f"blocks/{suffix}"] = torch.stack(
            [params[f"block_{i}/{suffix}"] for i in range(depth)])
    return flatten_with_names(unflatten_names(out))


def unstack_blocks(params: Params) -> Params:
    """Scan layout -> unrolled layout (inverse of :func:`stack_blocks`)."""
    if "blocks/ln1/scale" not in params:
        raise ValueError("no stacked 'blocks' subtree — already unrolled?")
    out = {k: v for k, v in params.items() if not k.startswith("blocks/")}
    for i in range(_depth(params)):
        for k, v in params.items():
            if k.startswith("blocks/"):
                out[f"block_{i}/{k[len('blocks/'):]}"] = v[i]
    return flatten_with_names(unflatten_names(out))


def _layer_norm(p: Params, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)  # population variance, as jnp's
    return (x - mean) * torch.rsqrt(var + eps) * p[f"{prefix}/scale"] + p[f"{prefix}/bias"]


def _dense(p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{prefix}/kernel"] + p[f"{prefix}/bias"]


def _attention(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head causal self-attention over ``x`` [N, T, D]."""
    n, t, d = x.shape
    hd = d // heads

    def split_heads(y: torch.Tensor) -> torch.Tensor:  # [N, T, D] -> [N, H, T, hd]
        return y.reshape(n, t, heads, hd).transpose(1, 2)

    q = split_heads(_dense(p, "attn/wq", x))
    k = split_heads(_dense(p, "attn/wk", x))
    v = split_heads(_dense(p, "attn/wv", x))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    # The dtype's most negative finite value, as the JAX forward fills (not -inf).
    scores = torch.where(causal, scores, torch.finfo(scores.dtype).min)
    att = torch.softmax(scores, dim=-1)
    out = (att @ v).transpose(1, 2).reshape(n, t, d)
    return _dense(p, "attn/wo", out)


def _block(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    x = x + _attention(p, _layer_norm(p, "ln1", x), heads)
    h = _dense(p, "mlp/fc1", _layer_norm(p, "ln2", x))
    return x + _dense(p, "mlp/fc2", F.gelu(h, approximate="tanh"))


def apply_sequence(
    params: Params, tokens: torch.Tensor, *, heads: int = DEFAULT_HEADS
) -> torch.Tensor:
    """Every position's next-token log-probs ``[N, T, vocab]`` for integer token ids
    ``[N, T]``, in either layout.  Deterministic: the LM has no dropout."""
    tokens = tokens.long()
    t = tokens.shape[1]
    x = params["tok_emb"][tokens] + params["pos_emb"][:t]
    depth = _depth(params)
    if "blocks/ln1/scale" in params:
        stacked = {k[len("blocks/"):]: v for k, v in params.items() if k.startswith("blocks/")}
        for i in range(depth):
            x = _block({k: v[i] for k, v in stacked.items()}, x, heads)
    else:
        for i in range(depth):
            prefix = f"block_{i}/"
            x = _block({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)},
                       x, heads)
    x = _layer_norm(params, "ln_f", x)
    return nn.log_softmax(_dense(params, "head", x))


def transformer_param_count(vocab: int, seq_len: int, width: int, depth: int) -> int:
    """Exact parameter count of :func:`init_transformer` (either layout)."""
    per_block = (
        4 * (width * width + width)  # wq/wk/wv/wo kernels + biases
        + (width * 4 * width + 4 * width)  # fc1
        + (4 * width * width + width)  # fc2
        + 4 * width  # ln1 + ln2 scale/bias
    )
    return (vocab * width + seq_len * width + width * vocab + vocab + 2 * width
            + depth * per_block)


@register_model("transformer_lm")
def transformer_lm(
    vocab: int = DEFAULT_VOCAB,
    seq_len: int = DEFAULT_SEQ_LEN,
    width: int = DEFAULT_WIDTH,
    depth: int = DEFAULT_DEPTH,
    heads: int = DEFAULT_HEADS,
    scan_layers: bool = False,
) -> Model:
    """The causal-LM zoo entry: ``apply`` gives the last position's log-probs
    ``[N, vocab]``; ``scan_layers=True`` (also ``transformer_lm_scan``) the stacked
    layout."""
    if width % heads != 0:
        raise ValueError(f"width {width} must be divisible by heads {heads}")

    def init(gen: torch.Generator) -> Params:
        return init_transformer(gen, vocab, seq_len, width, depth, scan_layers=scan_layers)

    def apply(params: Params, x: torch.Tensor, *,
              dropout: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        return apply_sequence(params, x, heads=heads)[:, -1, :]

    return Model(
        name="transformer_lm_scan" if scan_layers else "transformer_lm",
        init=init, apply=apply, input_shape=(seq_len,), num_classes=vocab,
        token_stream=True,
    )


@register_model("transformer_lm_scan")
def transformer_lm_scan(**kwargs: Any) -> Model:
    """The stacked-layout LM under its own name (a different parameter layout, so
    name-keyed caches never share an entry between the two)."""
    kwargs.pop("scan_layers", None)
    return transformer_lm(scan_layers=True, **kwargs)


#: The JAX package's flagship shapes: name -> (vocab, seq_len, width, depth, heads).
FLAGSHIP_CONFIGS = {
    "tiny": (DEFAULT_VOCAB, DEFAULT_SEQ_LEN, DEFAULT_WIDTH, DEFAULT_DEPTH, DEFAULT_HEADS),
    "small": (512, 64, 128, 4, 4),
    "evidence": (1024, 64, 256, 4, 4),
    "base": (8192, 128, 768, 12, 12),
    "large": (32768, 256, 2048, 24, 16),
}


def flagship(name: str, scan_layers: bool = False) -> Model:
    """A named flagship configuration (:data:`FLAGSHIP_CONFIGS`)."""
    vocab, seq_len, width, depth, heads = FLAGSHIP_CONFIGS[name]
    return transformer_lm(vocab=vocab, seq_len=seq_len, width=width, depth=depth,
                          heads=heads, scan_layers=scan_layers)
