"""Public op: GQA decode attention.

``decode_attention_op`` is the port of ``repro.kernels.decode_attention.
ops.decode_attention_op``.  The TPU op pads S to a multiple of its 512-key
block; the CUDA kernel bounds-checks S instead, so the op passes its
operands through unpadded: on the card to the kernel, on the CPU to the
plain version.  ``use_kernel=False`` runs the plain version on any device,
as the JAX op's flag runs its oracle: a caller that wants the plain path
(a comparison) asks for it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import kernel
from .ref import decode_attention_plain


def decode_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cur_len: Union[int, torch.Tensor],
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    use_kernel: bool = True,
    window_slice: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Hkv, G, d), k and v (B, S, Hkv, d) -> (B, Hkv, G, d) in q's
    dtype.  Query head ``kv * G + g`` of a layer is ``q[:, kv, g]``.

    ``cur_len`` is the query position; on the card pass it as a 0-d int32
    tensor on the device (an int is copied there first).  ``window_slice``
    (with no ``window``) reads only the window slice of that many keys
    that ends at ``cur_len`` (the ``decode_window_slice`` lever)."""
    if not use_kernel:
        return decode_attention_plain(q, k, v, cur_len, scale, softcap, window, window_slice)
    if not isinstance(cur_len, torch.Tensor) or cur_len.device != q.device:
        cur_len = torch.as_tensor(cur_len, dtype=torch.int32).to(q.device)
    return kernel.decode_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), cur_len.to(torch.int32).reshape(()),
        scale, softcap, window, window_slice,
    )
