"""Gradient compression for data-parallel all-reduce (counterpart of
``repro.train.compression``).

EDEN [Vargaftik et al. 2022], one of the paper's baselines, is a
distributed mean-estimation scheme; here it is a gradient
transformation: each 2048-wide block of a flattened gradient leaf is
rotated by a seeded randomized Hadamard transform, scalar-quantized to
b bits on the Lloyd-Max grid, rescaled to keep the block's norm and
unrotated.  Error feedback (the residual carried to the next step)
keeps the bias bounded.  With one seeded rotation for every worker the
payloads can be summed before the unrotation; ``compress_decompress``
is the round trip whose noise equals that compressed all-reduce.

The signs of leaf i at key ``key`` come from a CPU ``torch.Generator``
seeded ``fold_seed(key, i)`` (the same on the card and the CPU, not
jax.random's bits); ``compress_decompress`` takes the signs as an
argument, so the reference's ``jax.random.rademacher`` signs can be
passed in.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.baselines.eden import lloyd_max_grid_np
from repro_torch.data.synthetic import fold_seed
from repro_torch.train.optim import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 2
    enabled: bool = False
    error_feedback: bool = True
    block: int = 2048  # rotation block size (power of 2)


def _hadamard(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis (power of 2),
    orthonormal (divided by sqrt(n))."""
    n = x.shape[-1]
    h = 1
    while h < n:
        x = x.reshape(x.shape[:-1] + (n // (2 * h), 2, h))
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.cat([a + b, a - b], dim=-1).reshape(x.shape[:-3] + (n,))
        h *= 2
    return x / math.sqrt(n)


def rand_signs(seed: int, n: int) -> torch.Tensor:
    """(n,) fp32 Rademacher signs from a CPU generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, (n,), generator=gen).to(torch.float32) * 2 - 1


@functools.lru_cache(maxsize=None)
def _grid(bits: int) -> np.ndarray:
    return lloyd_max_grid_np(bits)


def encode_blocks(g: torch.Tensor, cfg: CompressionConfig,
                  signs: torch.Tensor):
    """The encode half of the round trip on a flat vector ``g``: its
    zero-padded ``cfg.block``-wide blocks times ``signs``, rotated, each
    normalized to unit coordinate variance and coded to the nearest
    Lloyd-Max level.  Returns (codes (n_blocks, block) int64, the
    blocks' norms (n_blocks, 1) fp32, the normalized values the codes
    quantize (n_blocks, block) fp32)."""
    n, B = g.shape[0], cfg.block
    x = torch.nn.functional.pad(g.to(torch.float32), (0, -n % B))
    y = _hadamard(x.reshape(-1, B) * signs.to(g.device, torch.float32))
    grid = torch.from_numpy(_grid(cfg.bits)).to(g.device)
    norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    yn = y / torch.clamp(norm, min=1e-12) * math.sqrt(B)
    mids = (grid[1:] + grid[:-1]) / 2.0
    return torch.searchsorted(mids, yn.contiguous()), norm, yn


def compress_decompress(g: torch.Tensor, cfg: CompressionConfig,
                        signs: torch.Tensor) -> torch.Tensor:
    """EDEN round trip on a flat vector ``g`` with the block's ``signs``
    (block,): rotate -> b-bit Lloyd-Max quantization -> scale ->
    unrotate (:func:`encode_blocks`, then each block's levels rescaled
    to its norm).  The wire payload between workers would be the b-bit
    codes and one fp16 scale a block."""
    codes, norm, _ = encode_blocks(g, cfg, signs)
    deq = torch.from_numpy(_grid(cfg.bits)).to(g.device)[codes]
    s = norm[:, 0] / torch.clamp(torch.linalg.vector_norm(deq, dim=-1),
                                 min=1e-12)
    x_hat = _hadamard(deq * s[:, None]) * signs.to(g.device, torch.float32)
    return x_hat.reshape(-1)[:g.shape[0]].to(g.dtype)


class EFState(NamedTuple):
    residual: Any  # error-feedback memory, same tree as the grads (fp32)


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


@torch.no_grad()
def compress_tree(key: int, grads, ef: Optional[EFState],
                  cfg: CompressionConfig,
                  signs: Optional[Sequence[torch.Tensor]] = None):
    """The EDEN round trip with error feedback on every leaf (sorted key
    order): leaf i uses ``rand_signs(fold_seed(key, i), block)``, or
    ``signs[i]`` when given.  Returns (grads, ef): new gradient tensors
    in each leaf's dtype; the residuals are updated in place."""
    if not cfg.enabled:
        return grads, ef
    out = []
    for i, (g, r) in enumerate(zip(tree_leaves(grads),
                                   tree_leaves(ef.residual))):
        gi = g.to(torch.float32)
        if cfg.error_feedback:
            gi = gi + r
        sg = signs[i] if signs is not None else rand_signs(
            fold_seed(key, i), cfg.block)
        deq = compress_decompress(gi.reshape(-1), cfg, sg).reshape(g.shape)
        if cfg.error_feedback:
            r.copy_(gi - deq)
        else:
            r.zero_()
        out.append(deq.to(g.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), grads), ef
