"""Plain PyTorch version of the splitter-rank kernel (K2)."""
from __future__ import annotations

import torch

#: elements of the (rows, n, queries) comparison formed at once
_CHUNK_ELEMS = 1 << 26


def ranks(x, qkey, qproc, qidx, me) -> torch.Tensor:
    """rank[r, q] = #{i : (x[r,i], me[r], i) < (qkey, qproc, qidx)[r, q]}.

    The lexicographic masked count of the JAX package's kernel, over the
    n real elements of each row, in chunks of queries. x (B, n) of any key
    dtype the kernel takes (int64 included); qkey of x's dtype, qproc, qidx
    (B, S) int32; me (B,). Returns (B, S) int32.
    """
    B, n = x.shape
    S = qkey.shape[1]
    out = torch.empty((B, S), dtype=torch.int32, device=x.device)
    i = torch.arange(n, device=x.device).view(1, n, 1)
    xk = x.unsqueeze(2)
    m = me.view(B, 1, 1)
    chunk = max(1, _CHUNK_ELEMS // max(B * n, 1))
    for s0 in range(0, S, chunk):
        qk = qkey[:, None, s0 : s0 + chunk]
        qp = qproc[:, None, s0 : s0 + chunk]
        qi = qidx[:, None, s0 : s0 + chunk]
        less = (xk < qk) | ((xk == qk) & ((m < qp) | ((m == qp) & (i < qi))))
        out[:, s0 : s0 + chunk] = less.sum(dim=1, dtype=torch.int32)
    return out
