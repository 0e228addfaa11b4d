"""Scalar quantization onto the odd-integer grid V_b (Eq. 4/7 of the paper).

V_b = {2c - 2^b + 1 | c = 0..2^b-1}.  ``quant_exact`` solves
``argmax_{v in V_b^d} cosSim(v, u)`` exactly with the sorted breakpoint
sweep of ``repro.core.quantization``; ``quant_grid`` is the
candidate-scale fast path used for b > 6.

Packed words are int32 tensors holding the reference's uint32 bit
patterns: torch has no right shift for uint32, and an arithmetic shift
of an int32 followed by the b-bit mask reads the same bits.
"""
from __future__ import annotations

import torch

_EPS = 1e-30


def grid_values(b: int, device=None) -> torch.Tensor:
    """The 2^b odd-integer grid values of V_b (int32)."""
    c = torch.arange(2**b, dtype=torch.int32, device=device)
    return 2 * c - (2**b - 1)


def levels_to_values(levels: torch.Tensor, b: int) -> torch.Tensor:
    """Levels in [0, 2^b) -> grid values in V_b (int32)."""
    return (2 * levels.to(torch.int32) - (2**b - 1)).to(torch.int32)


def values_to_levels(values: torch.Tensor, b: int) -> torch.Tensor:
    """Grid values in V_b -> levels in [0, 2^b) (int32; the reference
    returns uint32, same values)."""
    return torch.div(
        values.to(torch.int32) + (2**b - 1), 2, rounding_mode="floor"
    ).to(torch.int32)


# ---------------------------------------------------------------------------
# Exact quantizer (breakpoint sweep)
# ---------------------------------------------------------------------------


def quant_exact(u: torch.Tensor, b: int) -> torch.Tensor:
    """Exact quant_b for a batch of vectors (..., d) -> int32 values.

    Tied breakpoints are ordered by a STABLE sort (flat index order, as
    ``jnp.argsort``) and the best state is the first maximum, so ties in
    |u_j| resolve exactly as in the reference.
    """
    if b == 1:
        return torch.where(u >= 0, 1, -1).to(torch.int32)
    batch_shape = u.shape[:-1]
    d = u.shape[-1]
    a = u.reshape(-1, d).to(torch.float32).abs()
    N = a.shape[0]
    sgn = torch.where(u.reshape(-1, d) >= 0, 1, -1).to(torch.int32)
    n_bp = 2 ** (b - 1) - 1
    m = torch.arange(1, n_bp + 1, dtype=torch.float32, device=u.device)
    t = (2.0 * m[None, None, :]) / torch.clamp(a[:, :, None], min=_EPS)
    dS1 = (2.0 * a[:, :, None]).expand(N, d, n_bp).reshape(N, -1)
    dS2 = (8.0 * m).expand(N, d, n_bp).reshape(N, -1)
    order = torch.argsort(t.reshape(N, -1), dim=1, stable=True)
    sum_a = a.sum(dim=1, keepdim=True)
    S1 = torch.cumsum(torch.gather(dS1, 1, order), dim=1) + sum_a
    S2 = torch.cumsum(torch.gather(dS2, 1, order), dim=1) + d
    obj0 = sum_a / torch.sqrt(torch.tensor(float(d), device=u.device))
    obj = torch.cat([obj0, S1 / torch.sqrt(S2)], dim=1)
    k_star = torch.argmax(obj, dim=1)  # first maximum, as jnp.argmax
    ranks = torch.empty_like(order)
    ranks.scatter_(
        1, order,
        torch.arange(order.shape[1], device=u.device).expand(N, -1),
    )
    taken = (ranks < k_star[:, None]).reshape(N, d, n_bp)
    mag = 1 + 2 * taken.sum(dim=2, dtype=torch.int32)
    return (sgn * mag).to(torch.int32).reshape(batch_shape + (d,))


# ---------------------------------------------------------------------------
# Fast-path quantizer (candidate-scale grid)
# ---------------------------------------------------------------------------


def quant_grid(u: torch.Tensor, b: int, n_scales: int = 64) -> torch.Tensor:
    """Approximate quant_b by a log-spaced candidate-scale search."""
    if b == 1:
        return torch.where(u >= 0, 1, -1).to(torch.int32)
    gmax = 2**b - 1
    batch_shape = u.shape[:-1]
    d = u.shape[-1]
    uv = u.reshape(-1, d).to(torch.float32)
    a = uv.abs()
    a_max = torch.clamp(a.max(dim=1).values, min=_EPS)
    a_min = torch.where(a > 1e-4 * a_max[:, None], a, a_max[:, None])
    a_min = a_min.min(dim=1).values
    lo = torch.log10(0.5 / a_max)
    hi = torch.log10((gmax + 1.0) / torch.clamp(a_min, min=_EPS))
    frac = torch.linspace(0.0, 1.0, n_scales, device=u.device)
    ts = 10.0 ** (lo[:, None] + (hi - lo)[:, None] * frac[None, :])
    scaled = uv[:, None, :] * ts[:, :, None]  # (N, S, d)
    mag = torch.clamp(2 * torch.floor(scaled.abs() / 2.0) + 1, 1, gmax)
    v = torch.where(uv[:, None, :] >= 0, mag, -mag)
    num = (v * uv[:, None, :]).sum(-1)
    den = torch.sqrt((v * v).sum(-1))
    best = torch.argmax(num / torch.clamp(den, min=_EPS), dim=1)
    out = v[torch.arange(v.shape[0], device=u.device), best]
    return out.to(torch.int32).reshape(batch_shape + (d,))


def quant(u: torch.Tensor, b: int, exact: bool = True) -> torch.Tensor:
    """quant_b dispatcher: exact sweep for b <= 6, grid search beyond."""
    if b == 1:
        return quant_exact(u, 1)
    if exact and b <= 6:
        return quant_exact(u, b)
    return quant_grid(u, b)


# ---------------------------------------------------------------------------
# Bit packing (payload layout)
# ---------------------------------------------------------------------------


def codes_per_word(b: int) -> int:
    if b not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"unsupported bitrate {b}")
    return 32 // b


def packed_width(d: int, b: int) -> int:
    k = codes_per_word(b)
    return (d + k - 1) // k


def pack_codes(values: torch.Tensor, b: int) -> torch.Tensor:
    """Grid values (..., d) -> (..., ceil(d/k)) packed words (int32 bit
    patterns of the reference's uint32 words).

    Little-endian within a word: code j of a group occupies bits
    [j*b, (j+1)*b), stored as levels (value + 2^b - 1) / 2.
    """
    levels = values_to_levels(values, b).to(torch.int64)
    k = codes_per_word(b)
    d = levels.shape[-1]
    n_words = packed_width(d, b)
    pad = n_words * k - d
    if pad:
        levels = torch.nn.functional.pad(levels, (0, pad))
    grouped = levels.reshape(levels.shape[:-1] + (n_words, k))
    shifts = torch.arange(k, dtype=torch.int64, device=values.device) * b
    words = (grouped << shifts).sum(dim=-1)  # in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_codes(words: torch.Tensor, d: int, b: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> (..., d) int32 grid values."""
    k = codes_per_word(b)
    shifts = torch.arange(k, dtype=torch.int32, device=words.device) * b
    grouped = (words.to(torch.int32)[..., None] >> shifts) & (2**b - 1)
    levels = grouped.reshape(words.shape[:-1] + (-1,))[..., :d]
    return levels_to_values(levels, b)


def code_norms(values: torch.Tensor) -> torch.Tensor:
    """||v||_2 per vector for grid-valued codes (..., d)."""
    v = values.to(torch.float32)
    return torch.sqrt(torch.sum(v * v, dim=-1))
