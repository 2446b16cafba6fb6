"""Move parameter and cache trees between the JAX package and the port.

The two packages share layouts (``x @ W`` with ``W`` (d_in, d_out), a
stacked leading ``layers`` axis, caches (L, B, S, K, D), pages
(L, N, bs, K, D)), so a tree crosses leaf for leaf in the same nesting.
Trees cross as numpy arrays: the port never imports JAX, so the caller
turns JAX arrays into numpy (``jax.device_get`` or ``np.asarray``) and
back.

bf16 needs care: ``np.asarray`` of a JAX bf16 leaf has the
``ml_dtypes.bfloat16`` dtype, which ``torch.from_numpy`` rejects, and is
read-only.  It crosses as its bit pattern: ``.view(np.uint16)`` on a copy,
then ``.view(torch.bfloat16)``.  Back to numpy, bf16 widens to float32,
which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(x: Any, device) -> torch.Tensor:
    arr = np.array(x, copy=True)  # writable, owned copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_torch(tree: Any, device="cpu") -> Any:
    """Nested dicts of arrays -> the same nesting of torch tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """The inverse of ``to_torch``: tensors -> numpy arrays on the host
    (bf16 widened exactly to float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
