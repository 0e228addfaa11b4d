"""Locally-Optimized Product Quantization [Kalantidis & Avrithis 2014].

Counterpart of ``repro.baselines.lopq``.  Coarse k-means into C
clusters; for each cluster, residuals are encoded with a per-cluster
rotation (learned by alternating PQ <-> Procrustes, Eq. 32 of the ASH
paper) followed by PQ.  This is the expensive-to-train additive baseline
the paper contrasts with ASH's single shared rotation.

Encoding and scoring loop over the C clusters: each cluster's rows are
rotated by their one R_c and assigned against that cluster's codebooks
(the reference gathers an (n, D, D) stack of rotations, 262 GB at
n = 10^6, D = 256), and each cluster's rows take the ADC sum of its own
tables.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.baselines import pq as PQ
from repro_torch.core import learning as L
from repro_torch.core.types import _tensor
from repro_torch.device import full_fp32, resolve_device


@dataclasses.dataclass(frozen=True)
class LOPQState:
    M: int
    b: int
    C: int
    centroids: torch.Tensor  # (C, D)
    rotations: torch.Tensor  # (C, D, D)
    codebooks: torch.Tensor  # (C, M, 2^b, D/M)

    @property
    def bits_per_vector(self) -> int:
        return self.M * self.b + math.ceil(math.log2(max(self.C, 2)))


def from_numpy(*, M: int, b: int, C: int, centroids, rotations, codebooks,
               device="cuda") -> LOPQState:
    """The reference state's fields (numpy) as a :class:`LOPQState`."""
    dev = resolve_device(device)
    return LOPQState(M=M, b=b, C=C, **{
        f: _tensor(a, dev, torch.float32) for f, a in (
            ("centroids", centroids), ("rotations", rotations),
            ("codebooks", codebooks))})


def train(
    gen: torch.Generator,
    X: torch.Tensor,
    M: int,
    b: int = 8,
    C: int = 8,
    *,
    local_iters: int = 3,
    kmeans_iters: int = 25,
    device="cuda",
) -> LOPQState:
    dev = resolve_device(device)
    full_fp32()
    X32 = X.to(device=dev, dtype=torch.float32)
    n = X32.shape[0]
    g_km, g_pq = PQ.derive(gen, 2)
    centroids, assign = L.kmeans(g_km, X32, C, iters=kmeans_iters)
    rotations, codebooks = [], []
    for c, g_c in enumerate(PQ.derive(g_pq, C)):
        idx = torch.nonzero(assign == c)[:, 0]
        take = max(idx.numel(), 2 * M)
        if take > idx.numel():  # the reference pads with row 0 of X
            idx = torch.cat([idx, idx.new_zeros(take - idx.numel())])
        Xc = X32[idx[:min(take, n)]] - centroids[c]
        st = PQ.train(g_c, Xc, M, b, opq_iters=local_iters,
                      kmeans_iters=kmeans_iters, device=dev)
        rotations.append(st.rotation)
        codebooks.append(st.codebooks)
    return LOPQState(M=M, b=b, C=C, centroids=centroids,
                     rotations=torch.stack(rotations),
                     codebooks=torch.stack(codebooks))


def _clusters(assign: torch.Tensor, C: int):
    """(c, rows of cluster c) for the clusters that hold rows."""
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign.long(), minlength=C).tolist()
    r0 = 0
    for c, cnt in enumerate(counts):
        if cnt:
            yield c, order[r0:r0 + cnt]
        r0 += cnt


def encode(state: LOPQState, X: torch.Tensor):
    """-> (cluster (n,) int32, codes (n, M) int32)."""
    full_fp32()
    X32 = X.to(device=state.centroids.device, dtype=torch.float32)
    assign = L.assign_clusters(X32, state.centroids)
    codes = torch.empty(X32.shape[0], state.M, dtype=torch.int32,
                        device=X32.device)
    for c, rows in _clusters(assign, state.C):
        rotated = (X32[rows] - state.centroids[c]) @ state.rotations[c]
        codes[rows] = PQ._assign(state.codebooks[c], rotated)
    return assign, codes


def score(state: LOPQState, encoded, Qm: torch.Tensor) -> torch.Tensor:
    """<q, mu_c + R_c^T quant(residual)> per vector: (m, n), each
    cluster's rows scored against its own segment LUTs."""
    full_fp32()
    assign, codes = encoded
    dev = state.centroids.device
    assign, codes = assign.to(dev), codes.to(dev)
    Q32 = Qm.to(device=dev, dtype=torch.float32)
    m, M = Q32.shape[0], state.M
    ds = Q32.shape[1] // M
    # rotate the query into every cluster's frame once: (C, m, D)
    Qrot = torch.einsum("qd,cde->cqe", Q32, state.rotations)
    Qseg = Qrot.reshape(state.C, m, M, ds).permute(0, 2, 1, 3)
    T = torch.einsum("cmqd,cmkd->cmqk", Qseg, state.codebooks)
    out = (Q32 @ state.centroids.T)[:, assign.long()]  # coarse term
    for c, rows in _clusters(assign, state.C):
        out[:, rows] += PQ.adc(T[c], codes[rows].T.contiguous())
    return out
