"""Linear-work integer sort — the paper's radixsort ([DSR]/[RSR] variants).

An LSD radix sort of every processor's run at once: ``bits``-wide digits
from the least significant up, each pass a stable counting sort. A pass
places element j of digit d at ``base[d] + #{i < j : digit_i = d}``, where
``base`` is the exclusive prefix of the row's digit counts; the
occurrence counts are one running sum per digit value, so a pass is
``2^bits`` cumulative sums over the row and one scatter (no sort, and no
``(p, n_p, 2^bits)`` one-hot tensor). Stable per pass, hence stable
overall: the result is the stable argsort, as the JAX package's is.

Keys are held in the order-preserving unsigned form of their width. torch
has no unsigned 64-bit arithmetic and few uint32 operations, so that form
is carried in the signed type of the same width (the sign bit flipped),
and digits are read as ``(u >> shift) & (2^bits - 1)``: an arithmetic
shift is harmless under the mask.
"""
from __future__ import annotations

import torch

#: float key dtype -> (width of its unsigned image, signed dtype of that width)
_FLOAT_IMAGES = {
    torch.float16: (16, torch.int16),
    torch.bfloat16: (16, torch.int16),
    torch.float32: (32, torch.int32),
}
_SIGNED = {8: torch.int8, 16: torch.int16, 32: torch.int32, 64: torch.int64}


def _saturating_unsigned(keys: torch.Tensor, nbits: int) -> torch.Tensor:
    """``keys.astype(uint<nbits>)`` as the JAX package computes it on float
    keys: truncation toward zero, saturating at 0 and 2^nbits - 1, NaN to 0.
    Returned as int64 (every such value fits)."""
    f = keys.double()
    top = float(2**nbits - 1)
    f = torch.where(torch.isnan(f), torch.zeros((), dtype=f.dtype, device=f.device), f)
    return f.clamp(0.0, top).trunc().long()


def _to_unsigned_order_preserving(keys: torch.Tensor) -> torch.Tensor:
    """The JAX package's map of keys to a same-width unsigned dtype, carried
    in the signed dtype of that width (the unsigned value's bits).

    Signed integers flip the sign bit, which makes unsigned order agree
    with signed order. Float keys take the value cast (saturating, NaN to
    0), as the JAX package's ``astype`` does when ``route="radix"`` gets
    them; 64-bit float keys are not taken.
    """
    if keys.is_floating_point():
        if keys.dtype not in _FLOAT_IMAGES:
            raise TypeError(f"no unsigned image for {keys.dtype} keys")
        nbits, sdtype = _FLOAT_IMAGES[keys.dtype]
        u = _saturating_unsigned(keys, nbits)
        return (u - (u >= 2 ** (nbits - 1)).long() * 2**nbits).to(sdtype)
    nbits = keys.element_size() * 8
    if not keys.is_signed():  # unsigned keys are their own image
        return keys.view(_SIGNED[nbits])
    return keys ^ -(2 ** (nbits - 1))


def unsigned_value(u: torch.Tensor) -> torch.Tensor:
    """The unsigned value of :func:`_to_unsigned_order_preserving`'s result,
    as int64; for images of at most 32 bits (a 64-bit one does not fit)."""
    nbits = u.element_size() * 8
    if nbits > 32:
        raise TypeError("a 64-bit unsigned value does not fit int64")
    return u.long() & (2**nbits - 1)


def _counting_pass(digits: torch.Tensor, radix: int) -> torch.Tensor:
    """Destination of every element of a stable counting sort of (p, n)
    digits in [0, radix): ``base[d] + #{i < j : digit_i = d}``."""
    pos = torch.zeros(digits.shape, dtype=torch.int32, device=digits.device)
    base = torch.zeros((digits.shape[0], 1), dtype=torch.int32, device=digits.device)
    for d in range(radix):
        hit = digits == d
        seen = torch.cumsum(hit, dim=1, dtype=torch.int32)  # occurrences of d up to j
        pos = torch.where(hit, base + seen - 1, pos)
        base = base + seen[:, -1:]
    return pos.long()


def radix_argsort(keys: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Stable argsort of integer keys along the last dimension by LSD
    counting passes; (p, n) or (n,) keys, int32 indices of the same shape
    (the JAX package's index dtype)."""
    if keys.is_floating_point() or keys.dtype == torch.bool:
        raise TypeError(f"radix_argsort takes integer keys, got {keys.dtype}")
    squeeze = keys.ndim == 1
    k = keys.reshape(1, -1) if squeeze else keys
    u = _to_unsigned_order_preserving(k)
    nbits = u.element_size() * 8
    mask = (1 << bits) - 1
    order = torch.arange(k.shape[1], device=k.device).expand(k.shape).contiguous()
    for shift in range(0, nbits, bits):
        digits = ((u.gather(1, order) >> shift) & mask).int()
        pos = _counting_pass(digits, 1 << bits)
        order = torch.empty_like(order).scatter_(1, pos, order)
    order = order.to(torch.int32)
    return order[0] if squeeze else order


def radix_sort(keys: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Stable LSD radix sort of integer keys (the paper's radixsort)."""
    return keys.gather(-1, radix_argsort(keys, bits=bits).long())
