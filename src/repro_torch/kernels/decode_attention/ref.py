"""Plain PyTorch version of the decode-attention kernel.

A copy of the JAX package's oracle (``repro.kernels.decode_attention.ref.
decode_attention_ref``): f32 scores ``q . k * scale``, an optional logit
softcap, the mask ``pos <= cur`` (and ``pos > cur - window`` with a
window), masked scores set to -1e30, an f32 softmax over S and the f32
weights times the upcast V, cast to q's dtype.  With ``window_slice`` it
reads only the window slice, as the reference's ``decode_window_slice``
lever does on a local layer (``repro.models.transformer.layer_forward``):
the ``w = min(window_slice, S)`` keys from ``start = clip(cur - (w - 1), 0,
S - w)``, masked by ``pos <= cur`` alone, ``start`` computed on the device.
Used by the CPU tests, by ``device="cpu"``, and on the card only to check
the kernel against.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def decode_attention_plain(
    q: torch.Tensor,  # (B, Hkv, G, d) current-token queries
    k: torch.Tensor,  # (B, S, Hkv, d) cache keys
    v: torch.Tensor,  # (B, S, Hkv, d) cache values
    cur_len: Union[int, torch.Tensor],  # query position: attends to pos <= cur_len
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    window_slice: Optional[int] = None,
) -> torch.Tensor:
    cur = torch.as_tensor(cur_len, device=k.device)
    if window_slice is not None:
        if window is not None:
            raise ValueError("window_slice reads the window itself: pass no window with it")
        s_len = k.shape[1]
        w = min(int(window_slice), s_len)
        pos = (cur - (w - 1)).clamp(0, s_len - w) + torch.arange(w, device=k.device)
        k, v = k.index_select(1, pos), v.index_select(1, pos)
    else:
        pos = torch.arange(k.shape[1], device=k.device)
    s = torch.einsum("bngd,bsnd->bngs", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = pos <= cur
    if window is not None:
        mask = mask & (pos > cur - window)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bngs,bsnd->bngd", w, v.float()).to(q.dtype)
