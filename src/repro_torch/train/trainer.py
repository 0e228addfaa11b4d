"""The train step (counterpart of ``repro.train.trainer``): a
microbatched (gradient-accumulation) step with mixed precision, optional
gradient compression, and a ``TrainState`` that checkpoints and
restores in the reference's layout.

The parameters are a ``models.transformer.Transformer`` or another
family's nested dict/list tree (``models.sasrec``, ``recsys``,
``nequip``); :func:`trainable` is the one family hook: it makes them
trainable and gives the training tree (the reference's leaves, a
transformer's layer weights stacked along L) that the optimizer updates
in place, and the tensors autograd differentiates.  The step returns a new
``TrainState`` whose ``params``, ``opt_state`` and ``ef_state`` are the
same objects, updated.  Each step's work is in three spans
(``repro_torch.tracing``, profiler ranges while tracing is on),
``train.forward_backward``, ``train.compression`` and
``train.optimizer``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tracing
from repro_torch.data.synthetic import fold_seed
from repro_torch.device import full_fp32, host_scalars
from repro_torch.models import common as cm
from repro_torch.models import transformer as TT
from repro_torch.train import optim as O
from repro_torch.train.compression import (
    CompressionConfig, EFState, compress_tree, ef_init,
)


class TrainState(NamedTuple):
    params: Any  # a trainable Transformer (its tree is saved) or a tree
    opt_state: Any
    ef_state: Optional[EFState]
    step: torch.Tensor  # int32 (), on the CPU
    rng: torch.Tensor  # uint32 (2,), on the CPU: the words of PRNGKey(seed)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    microbatches: int = 1  # gradient-accumulation chunks per step
    compression: CompressionConfig = CompressionConfig()
    grad_accum_dtype: torch.dtype = torch.float32


@host_scalars()
def rng_key(seed: int) -> torch.Tensor:
    """The reference's ``PRNGKey(seed)`` words, [seed >> 32, seed mod 2^32]."""
    return torch.tensor([seed >> 32, seed & 0xFFFFFFFF], dtype=torch.uint32)


def key_seed(rng: torch.Tensor) -> int:
    hi, lo = (int(w) for w in rng.to(torch.int64))
    return (hi << 32) | lo


def trainable(params):
    """Make ``params`` trainable: returns (tree, leaves).  ``tree`` is
    the training tree the optimizer updates in place; ``leaves`` holds,
    per reference leaf in its flatten order, (stacked, tensors): the
    tensors autograd differentiates and whether their grads stack along
    a new leading axis into the leaf (a transformer's per-layer weights)
    or the leaf is its one tensor (every other leaf, and every leaf of a
    family with a plain parameter tree)."""
    if isinstance(params, TT.Transformer):
        tree = TT.make_trainable(params)
        return tree, [(path[0] == "layers", ts)
                      for path, ts in TT.train_leaves(params)]
    tree = cm.make_trainable(params)
    return tree, [(False, [t]) for t in O.tree_leaves(tree)]


def init_state(seed: int, params, tcfg: TrainConfig) -> TrainState:
    tree, _ = trainable(params)
    opt_init, _ = O.make_optimizer(tcfg.opt)
    return TrainState(
        params=params,
        opt_state=opt_init(tree),
        ef_state=ef_init(tree) if tcfg.compression.enabled else None,
        step=O._step0(),
        rng=rng_key(seed),
    )


def make_train_step(loss_fn: Callable, tcfg: TrainConfig,
                    constrain_grads: Callable = lambda g: g):
    """Returns train_step(state, batch) -> (state, metrics).

    ``loss_fn(params, batch)`` -> scalar loss.  ``microbatches`` = k > 1
    splits the batch along axis 0 of every leaf with the microbatches
    INTERLEAVED (row r of microbatch m is global row r*k + m, as the
    reference's) and accumulates ``a + g / k`` in ``grad_accum_dtype``
    (the loss as ``loss + loss_m / k`` in fp32); with k = 1 the
    gradients stay in the parameter dtype.  Compression (if enabled)
    runs before the optimizer.  ``constrain_grads`` maps the gradient
    tree before compression and the optimizer (the cell programs of
    ``configs.base`` pin it to the parameters' sharding; identity by
    default).  Metrics (device tensors): ``loss``,
    ``grad_norm`` (after compression, before clipping) and ``step``.
    """
    _, opt_update = O.make_optimizer(tcfg.opt)
    k = tcfg.microbatches

    def grads_of(params, leaves, batch):
        """(loss, per reference leaf (stacked, its tensors' grads))."""
        flat = [t for _, ts in leaves for t in ts]
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            gs = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                          materialize_grads=True))
        return loss.detach(), [(st, [next(gs) for _ in ts])
                               for st, ts in leaves]

    def stacked(grads):
        return [torch.stack(g) if st else g[0] for st, g in grads]

    def train_step(state: TrainState, batch):
        full_fp32()
        params = state.params
        tree, leaves = trainable(params)
        dev = O.tree_leaves(tree)[0].device
        batch = {n: v.to(dev) for n, v in batch.items()}
        with tracing.span("train.forward_backward"):
            if k > 1:
                acc = O.tree_map(lambda p: torch.zeros_like(
                    p, dtype=tcfg.grad_accum_dtype), tree)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for m in range(k):
                    mb = {n: v[m::k] for n, v in batch.items()}
                    loss_m, grads = grads_of(params, leaves, mb)
                    for a, (st, gs) in zip(O.tree_leaves(acc), grads):
                        parts = a if st else [a]
                        for a_l, g in zip(parts, gs):
                            a_l.add_(g.to(tcfg.grad_accum_dtype) / k)
                    del grads
                    loss = loss + loss_m / k
                grads = acc
            else:
                loss, grads = grads_of(params, leaves, batch)
                it = iter(stacked(grads))
                grads = O.tree_map(lambda _: next(it), tree)
        grads = constrain_grads(grads)

        ef = state.ef_state
        if tcfg.compression.enabled:
            with tracing.span("train.compression"):
                with host_scalars():
                    ck = fold_seed(key_seed(state.rng), int(state.step))
                grads, ef = compress_tree(ck, grads, ef, tcfg.compression)

        with tracing.span("train.optimizer"):
            grad_norm = O.global_norm(grads)
            updates, opt_state = opt_update(grads, state.opt_state, tree)
            O.apply_updates(tree, updates)
        new_state = TrainState(params=params, opt_state=opt_state,
                               ef_state=ef, step=O.next_step(state.step),
                               rng=state.rng)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "step": new_state.step}
        return new_state, metrics

    return train_step
