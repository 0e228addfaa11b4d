"""Product Quantization [Jégou et al., TPAMI 2011] + OPQ rotation option.

Counterpart of ``repro.baselines.pq``.  PQ splits D dims into M
segments, k-means with 2^b centroids per segment; asymmetric ADC scoring
via per-segment lookup tables (Eq. 29 of the ASH paper).  OPQ [Ge et
al. 2014] learns a global rotation by alternating PQ training with an
orthogonal Procrustes step.

Every OPQ iteration trains its codebooks from the same generator state,
as the reference's, whose loop derives a per-iteration key and never
uses it.  ADC sums the M segment gathers into one (m, n) accumulator,
a block of queries at a time, where the reference materializes an
(M, m, n) tensor and sums it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import learning as L
from repro_torch.core.types import _tensor
from repro_torch.device import full_fp32, resolve_device

_ASSIGN_ELEMS = 2**27  # (M, rows, 2^b) distance elements per assign block
_SCORE_ELEMS = 2**28  # (m, n) accumulator elements per ADC query block


@dataclasses.dataclass(frozen=True)
class PQState:
    M: int  # number of segments
    b: int  # bits per segment (2^b centroids)
    codebooks: torch.Tensor  # (M, 2^b, D/M) f32
    rotation: Optional[torch.Tensor]  # (D, D) or None (OPQ)

    @property
    def bits_per_vector(self) -> int:
        return self.M * self.b


def from_numpy(*, M: int, b: int, codebooks, rotation=None,
               device="cuda") -> PQState:
    """The reference state's fields (numpy) as a :class:`PQState`."""
    dev = resolve_device(device)
    return PQState(M=M, b=b, codebooks=_tensor(codebooks, dev, torch.float32),
                   rotation=None if rotation is None
                   else _tensor(rotation, dev, torch.float32))


def _split(X: torch.Tensor, M: int) -> torch.Tensor:
    n, D = X.shape
    return X.reshape(n, M, D // M)


def derive(gen: torch.Generator, count: int) -> list[torch.Generator]:
    """``count`` generators seeded from draws of ``gen``, on its device
    (the port's ``jax.random.split``)."""
    seeds = torch.randint(0, 2**62, (count,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def _train_codebooks(gen, X, M, b, iters=25):
    """k-means of each segment, one derived generator a segment:
    (M, 2^b, D/M)."""
    seg = _split(X, M)
    return torch.stack([
        L.kmeans(g, seg[:, m].contiguous(), 2**b, iters=iters)[0]
        for m, g in enumerate(derive(gen, M))])


def train(
    gen: torch.Generator,
    X: torch.Tensor,
    M: int,
    b: int = 8,
    *,
    opq_iters: int = 0,
    kmeans_iters: int = 25,
    device="cuda",
) -> PQState:
    """Train PQ (opq_iters == 0) or OPQ (alternating rotation)."""
    dev = resolve_device(device)
    full_fp32()
    X32 = X.to(device=dev, dtype=torch.float32)
    D = X32.shape[1]
    if D % M:
        raise ValueError(f"D={D} not divisible by M={M}")
    if opq_iters == 0:
        cb = _train_codebooks(gen, X32, M, b, iters=kmeans_iters)
        return PQState(M=M, b=b, codebooks=cb, rotation=None)

    start = gen.get_state()
    R = torch.eye(D, dtype=torch.float32, device=dev)
    cb = None
    for _ in range(opq_iters):
        XR = X32 @ R
        gen.set_state(start)  # the same key every iteration
        cb = _train_codebooks(gen, XR, M, b, iters=kmeans_iters)
        recon = _decode_rotated(cb, _assign(cb, XR))
        # Procrustes: max Tr(R^T X^T recon) -> R = U V^T of X^T recon
        u, _, vt = torch.linalg.svd(X32.T @ recon, full_matrices=False)
        R = u @ vt
    return PQState(M=M, b=b, codebooks=cb, rotation=R)


def _assign(codebooks: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each segment, ``argmin ||x||^2 - 2 x.c +
    ||c||^2`` (first index on ties): (n, M) int32, in row blocks."""
    full_fp32()
    M_, K, _ = codebooks.shape
    n = X.shape[0]
    cb_sq = (codebooks * codebooks).sum(dim=-1)[:, None, :]  # (M, 1, K)
    cb_T = codebooks.transpose(1, 2)  # (M, ds, K)
    out = torch.empty(n, M_, dtype=torch.int32, device=X.device)
    step = max(1, _ASSIGN_ELEMS // (M_ * K))
    for r0 in range(0, n, step):
        seg = _split(X[r0:r0 + step], M_).transpose(0, 1)  # (M, r, ds)
        d2 = ((seg * seg).sum(dim=-1)[..., None]
              - 2 * torch.bmm(seg, cb_T) + cb_sq)
        out[r0:r0 + step] = torch.argmin(d2, dim=-1).T.to(torch.int32)
    return out


def encode(state: PQState, X: torch.Tensor) -> torch.Tensor:
    """-> (n, M) int32 centroid indices."""
    full_fp32()
    X32 = X.to(device=state.codebooks.device, dtype=torch.float32)
    if state.rotation is not None:
        X32 = X32 @ state.rotation
    return _assign(state.codebooks, X32)


def _decode_rotated(codebooks, codes):
    """(n, D) in the (possibly rotated) space."""
    M = codebooks.shape[0]
    seg = torch.arange(M, device=codes.device)[None, :]
    return codebooks[seg, codes.long()].reshape(codes.shape[0], -1)


def decode(state: PQState, codes: torch.Tensor) -> torch.Tensor:
    recon = _decode_rotated(state.codebooks, codes)
    if state.rotation is not None:
        recon = recon @ state.rotation.T
    return recon


def adc(T: torch.Tensor, codes_T: torch.Tensor,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_s T[s, :, codes_T[s]]: tables T (M, m, 2^b), codes (M, n)
    -> (m, n), segments added in order 0..M-1 into one accumulator
    (``out``, or a new one)."""
    M, m, _ = T.shape
    if out is None:
        out = torch.zeros(m, codes_T.shape[1], dtype=T.dtype,
                          device=T.device)
    for s in range(M):
        out += T[s].index_select(1, codes_T[s])
    return out


def score(state: PQState, codes: torch.Tensor, Qm: torch.Tensor
          ) -> torch.Tensor:
    """ADC: <q, quant(x)> via per-segment LUTs (m, n).

    LUT T[s] = q^(s) @ codebook_s^T; per vector, the sum of M gathers.
    """
    full_fp32()
    dev = state.codebooks.device
    Q32 = Qm.to(device=dev, dtype=torch.float32)
    if state.rotation is not None:
        Q32 = Q32 @ state.rotation
    qseg = _split(Q32, state.M).transpose(0, 1)  # (M, m, ds)
    T = torch.bmm(qseg, state.codebooks.transpose(1, 2))  # (M, m, 2^b)
    codes_T = codes.to(dev).T.contiguous()
    n = codes_T.shape[1]
    out = torch.zeros(Q32.shape[0], n, dtype=torch.float32, device=dev)
    step = max(1, _SCORE_ELEMS // max(n, 1))
    for q0 in range(0, Q32.shape[0], step):
        adc(T[:, q0:q0 + step], codes_T, out=out[q0:q0 + step])
    return out
