"""Synthetic data (counterpart of ``repro.data.synthetic``).

``embedding_dataset`` reproduces the paper's Table-4 non-isotropy:
anisotropic covariance (power-law spectrum), non-zero mean and cluster
structure; ``isotropy_diagnostics`` measures it.  Draws come from a
``torch.Generator`` seeded with ``seed`` on the target device, so a
million-row set is made on the card.

``TokenStream`` is the resumable LM batch stream of training: batch t
is a pure function of (seed, t) with the reference's Markov recurrence
(:func:`markov_tokens`), its draws from a CPU ``torch.Generator``
seeded ``fold_seed(seed, t)`` (not jax.random's bits); a checkpointed
``IteratorState`` cursor restarts it exactly.  ``ClickStream`` (CTR
batches with the reference's planted rule) and ``SequenceStream``
(SASRec histories with its drifting item walk) draw the same way; their
transformations of the draws are :func:`click_batch` and
:func:`sequence_batch`, which also take the reference's own draws.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import full_fp32, resolve_device


def embedding_dataset(
    n: int,
    D: int,
    *,
    seed: int = 0,
    device="cuda",
    spectrum_pow: float = 0.7,
    mean_shift: float = 0.5,
    n_clusters: int = 8,
    cluster_spread: float = 2.0,
    normalize: bool = False,
) -> torch.Tensor:
    """(n, D) f32 anisotropic, shifted, clustered embedding-like vectors."""
    dev = resolve_device(device)
    full_fp32()
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(D, D, generator=gen, device=dev) * (
        torch.arange(1, D + 1, dtype=torch.float32, device=dev)
        ** -spectrum_pow
    )[None, :]
    centers = (
        torch.randn(n_clusters, D, generator=gen, device=dev) @ A.T
        * cluster_spread
    )
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=dev)
    X = torch.randn(n, D, generator=gen, device=dev) @ A.T
    X += centers[assign] + mean_shift
    if normalize:
        X /= torch.linalg.norm(X, dim=-1, keepdim=True)
    return X


def isotropy_diagnostics(X: torch.Tensor, sample: int = 2048) -> dict:
    """The paper's Table-4 statistics of ``X`` (on its device): min
    pairwise cosSim over the first ``sample`` rows, and ||mean||_inf."""
    full_fp32()
    Xs = X[:sample].to(torch.float32)
    Xn = Xs / torch.linalg.norm(Xs, dim=-1, keepdim=True)
    cos = Xn @ Xn.T
    return {
        "min_cos_sim": float(cos.min()),
        "mean_inf_norm": float(X.to(torch.float32).mean(0).abs().max()),
    }


# ---------------------------------------------------------------------------
# Resumable host-side iterators (checkpointable cursor)
# ---------------------------------------------------------------------------

_MASK64 = 0xFFFFFFFFFFFFFFFF


def fold_seed(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (a step, a leaf index):
    the splitmix64 finalizer of ``seed * 2^32 + data``, cut to 63 bits
    (``torch.Generator`` takes a non-negative int64)."""
    z = ((seed << 32) + data) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass
class IteratorState:
    seed: int
    step: int = 0

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


def markov_tokens(start: torch.Tensor, steps: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """The reference's token recurrence: row b starts at ``start[b]``
    (B,) and token t + 1 = (31 * token t + ``steps[b, t]``) mod vocab,
    ``steps`` (B, S - 1) in [0, 7).  Returns (B, S) int32 on the CPU
    (a column loop over numpy int64: no value exceeds 31 * vocab + 6)."""
    carry = start.cpu().numpy().astype(np.int64)
    s = steps.cpu().numpy().astype(np.int64)
    out = np.empty((carry.shape[0], s.shape[1] + 1), np.int64)
    out[:, 0] = carry
    for t in range(s.shape[1]):
        carry = (carry * 31 + s[:, t]) % vocab
        out[:, t + 1] = carry
    return torch.from_numpy(out.astype(np.int32))


class TokenStream:
    """Deterministic synthetic LM token stream: batch t is a pure function
    of (seed, t), so restart from a checkpointed cursor is exact.  Tokens
    follow :func:`markov_tokens` (something learnable); batches are CPU
    int32 ``{"tokens", "labels"}`` (the same tensor), as the reference's
    host-side iterator."""

    def __init__(self, state: IteratorState, batch: int, seq: int,
                 vocab: int):
        self.state = state
        self.batch, self.seq, self.vocab = batch, seq, vocab

    def next(self) -> dict:
        gen = torch.Generator().manual_seed(
            fold_seed(self.state.seed, self.state.step))
        start = torch.randint(0, self.vocab, (self.batch,), generator=gen)
        steps = torch.randint(0, 7, (self.batch, self.seq - 1),
                              generator=gen)
        tokens = markov_tokens(start, steps, self.vocab)
        self.state.step += 1
        return {"tokens": tokens, "labels": tokens}


def click_batch(sparse: torch.Tensor, dense: torch.Tensor,
                uniform: torch.Tensor) -> dict:
    """The reference's planted CTR rule over its draws: ``sparse``
    (B, F) ids, ``dense`` (B, nd) N(0, 1), ``uniform`` (B,) U[0, 1).
    A row's score counts its ids divisible by 5, less half its mean
    dense feature; the label is 1 where ``uniform`` < sigmoid(score -
    the batch's mean score) (the reference's ``bernoulli``)."""
    n_dense = dense.shape[1]
    score = ((sparse % 5 == 0).to(torch.float32).sum(-1)
             - 0.5 * dense.sum(-1) / max(n_dense, 1))
    p = torch.sigmoid(score - score.mean())
    return {"sparse": sparse.to(torch.int32),
            "dense": dense.to(torch.float32),
            "labels": (uniform < p).to(torch.float32)}


class ClickStream:
    """Synthetic CTR batches with a learnable planted rule
    (:func:`click_batch`); batch t is a pure function of (seed, t)."""

    def __init__(self, state: IteratorState, batch: int, n_dense: int,
                 n_sparse: int, vocab: int):
        self.state = state
        self.batch, self.n_dense = batch, n_dense
        self.n_sparse, self.vocab = n_sparse, vocab

    def next(self) -> dict:
        gen = torch.Generator().manual_seed(
            fold_seed(self.state.seed, self.state.step))
        sparse = torch.randint(0, self.vocab, (self.batch, self.n_sparse),
                               generator=gen)
        dense = torch.randn(self.batch, self.n_dense, generator=gen)
        uniform = torch.rand(self.batch, generator=gen)
        self.state.step += 1
        return click_batch(sparse, dense, uniform)


def sequence_batch(start: torch.Tensor, drift: torch.Tensor,
                   negatives: torch.Tensor, n_items: int) -> dict:
    """The reference's user histories over its draws: row b walks from
    ``start[b]`` in [1, n_items) by the cumulative ``drift`` (B, S) in
    [1, 17), wrapped into [1, n_items); labels are the next item (0 at
    the last position); ``negatives`` (n_neg,) pass through."""
    seq = (start.long()[:, None] + torch.cumsum(drift.long(), dim=1)) % (
        n_items - 1) + 1
    labels = torch.roll(seq, -1, dims=1)
    labels[:, -1] = 0
    return {"seq": seq.to(torch.int32), "labels": labels.to(torch.int32),
            "negatives": negatives.to(torch.int32)}


class SequenceStream:
    """SASRec-style user histories with sequential structure
    (:func:`sequence_batch`); batch t is a pure function of (seed, t)."""

    def __init__(self, state: IteratorState, batch: int, seq: int,
                 n_items: int, n_neg: int = 128):
        self.state = state
        self.batch, self.seq = batch, seq
        self.n_items, self.n_neg = n_items, n_neg

    def next(self) -> dict:
        gen = torch.Generator().manual_seed(
            fold_seed(self.state.seed, self.state.step))
        start = torch.randint(1, self.n_items, (self.batch,), generator=gen)
        drift = torch.randint(1, 17, (self.batch, self.seq), generator=gen)
        negs = torch.randint(1, self.n_items, (self.n_neg,), generator=gen)
        self.state.step += 1
        return sequence_batch(start, drift, negs, self.n_items)
