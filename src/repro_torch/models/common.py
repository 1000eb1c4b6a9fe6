"""Shared model building blocks: the port of ``repro.models.common``.

The pieces the LM needs, with the reference's numerics: Gemma-style
RMSNorm (``1 + scale``, f32 accumulation), the tanh-approximate GELU, the
logit softcap, half-split (not interleaved) rotary embeddings with f32
angles, the f32 token cross-entropy and the global norm of a tree of
gradients.  Initialisation draws a truncated normal from an explicit
``torch.Generator``: the numbers differ from ``jax.random``'s, so the tests
carry the JAX weights across instead (:func:`tensor_from_numpy`, under
``transformer.params_from_numpy`` and ``recsys.params_from_numpy``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def truncated_normal(
    shape, stddev: float, dtype: torch.dtype, generator: torch.Generator, device
) -> torch.Tensor:
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in f32
    on ``device`` (the generator's) and cast to ``dtype``, as
    ``repro.models.common.truncated_normal`` does."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    x.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(stddev)
    return x.to(dtype)


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor on ``device`` with the bits of the array ``np.array`` makes
    of ``a`` (ml_dtypes' bfloat16 included: the same bits as torch's)."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # Gemma-style (1 + scale) parameterisation, f32 accumulation
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu,
    "silu": F.silu,
    "relu": F.relu,
}


def top_k_ids(x: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest entries' indices along the last axis, descending,
    the lower index first among equal values (as ``jax.lax.top_k``): a
    stable sort, since ``torch.topk`` on the card does not fix the order of
    ties."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) f32, computed on the CPU once per device: a decode step
    then copies nothing from the host (a copy would wait for the card)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    angles = angles[..., None, :]  # (..., seq, 1, hd/2): broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Losses / metrics
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token cross-entropy, f32 log-softmax."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp(min=1)
    return nll.mean()


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and modules with a
    ``tree()`` (a transformer's ``ParamTree``) in the reference's order:
    dict keys sorted, sequences in order, depth first; ``None`` holds none."""
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``tree``'s structure (a module as its ``tree()``) with ``fn`` of each
    leaf and the leaves at the same place in ``rest``, called in
    :func:`tree_leaves`' order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    rest = [r.tree() if isinstance(r, torch.nn.Module) else r for r in rest]
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a named tuple (OptState)
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """:func:`tree_map` with each leaf's path: dict keys, list indices and a
    named tuple's field names joined by ``/`` (``layers/attn/q``,
    ``mu/embed``), as the reference's ``path_of`` spells a key path."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.tree()
    if tree is None:
        return None
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], join(k)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, join(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Every tensor a function makes lands on ``meta``: a ``device`` it
    names is replaced (factories without one follow ``torch.device``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def meta_init(init_fn: Callable[..., Any], *args, **kwargs):
    """``init_fn(generator, *args)``'s tree with every tensor on ``meta``:
    the shapes and dtypes of the weights, none of their bytes (arctic's
    ~960 GB tree included).  Meta kernels ignore the generator's draws."""
    with torch.device("meta"), _OnMeta():
        return init_fn(torch.Generator(), *args, **kwargs)


def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm of every leaf together, a 0-d tensor on the leaves'
    device: the leaves' sums of squares added in tree order."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves))
