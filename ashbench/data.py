"""The benchmark's data: index rows and query rows drawn on the device
from the run's seed, with the paper's non-isotropy (Table 4):
anisotropic covariance with a power-law spectrum, a non-zero mean and
cluster structure.  Each draw is a few large calls on one
``torch.Generator``, so 10^7 rows take about a second on the card.
"""
from __future__ import annotations

import torch

from ashbench.reference.ash import precision

_MASK64 = 0xFFFFFFFFFFFFFFFF


def stream_seed(seed: int, stream: int) -> int:
    """The seed of draw ``stream`` (0-7) of a run seeded ``seed``:
    splitmix64 of ``8 * seed + stream``, cut to 63 bits (what
    ``manual_seed`` takes).  Any whole number seeds a run.  Streams: 1
    the index rows, 2 the queries, 3 the traffic, 4 the build's
    generator, 5 the sample of judged requests."""
    if not 0 <= stream < 8:
        raise ValueError(f"stream {stream} not in 0-7")
    z = (8 * seed + stream) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def embedding_rows(n: int, D: int, *, seed: int, device,
                   spectrum_pow: float = 0.7, mean_shift: float = 0.5,
                   n_clusters: int = 8, cluster_spread: float = 2.0
                   ) -> torch.Tensor:
    """(n, D) float32 anisotropic, shifted, clustered rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(D, D, generator=gen, device=device) * (
        torch.arange(1, D + 1, dtype=torch.float32, device=device)
        ** -spectrum_pow)[None, :]
    centers = (torch.randn(n_clusters, D, generator=gen, device=device)
               @ A.T * cluster_spread)
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    X = torch.randn(n, D, generator=gen, device=device) @ A.T
    X += centers[assign] + mean_shift
    return X


def draw(config: dict, n_queries: int, seed: int, device):
    """(index rows, query rows) of a configuration for a run seeded
    ``seed``.  ``queries.draw`` is ``held_out`` (the queries are further
    rows of the index's own draw: in-distribution) or ``independent`` (a
    second draw with its own covariance and parameters: out of
    distribution)."""
    n, D = config["n"], config["dim"]
    qcfg = dict(config["queries"])
    how = qcfg.pop("draw")
    with precision(tf32=False):
        if how == "held_out":
            rows = embedding_rows(n + n_queries, D,
                                  seed=stream_seed(seed, 1), device=device,
                                  **config["data"])
            return rows[:n], rows[n:]
        if how != "independent":
            raise ValueError(f"queries.draw {how!r}: held_out or independent")
        X = embedding_rows(n, D, seed=stream_seed(seed, 1), device=device,
                           **config["data"])
        Q = embedding_rows(n_queries, D, seed=stream_seed(seed, 2),
                           device=device, **qcfg)
        return X, Q
