"""Training launcher of the port (counterpart of ``repro.launch.train``),
with the same flags plus ``--device`` (default ``cuda``; ``cpu`` only
when asked for)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 8 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --batch 8 --seq 128 --reduced --device cpu \\
      --ckpt-dir /tmp/ckpt

``--reduced`` scales the architecture down (layers, widths, vocab,
tables) so any of the ten ids trains on a CPU; without it the arch
trains at its full widths and depth.  Batches: an LM's ``TokenStream``
(``--batch`` sequences of ``--seq`` tokens), sasrec's
``SequenceStream`` and the recsys models' ``ClickStream`` (``--batch``
rows at the config's widths), and for nequip ``batch // 8`` small
molecules of 12 atoms and 32 edges a batch (``data.graphs.
batch_small_graphs``) with energy and force targets from a seeded
generator.  The loop is fault tolerant: it resumes from the
latest committed checkpoint (state, data cursor and seed), and
``--die-at-step N`` exits with code 42 at step N (after the save in
flight is committed, so the resume point does not depend on the
writer thread) so that tests and demos can kill and resurrect it
deterministically.  It runs under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the first cuBLAS call,
unless the environment sets it), so a resumed run repeats the killed
run's losses bit for bit; the previous setting is restored on return.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

from repro_torch.configs import registry
from repro_torch.data import graphs as G
from repro_torch.data.synthetic import (
    ClickStream, IteratorState, SequenceStream, TokenStream, fold_seed,
)
from repro_torch.device import resolve_device
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import init_state, make_train_step


def reduced_arch(arch):
    """Scale a config down to CPU size, same family and topology, as the
    reference's: an LM to 2 layers, d_model 64, vocab 512, fp32, at most
    8 experts; nequip to 2 layers of 8 channels; sasrec to 1,000 items
    of 16 dims, seq 16, 32 negatives; a recsys model to 1,000 rows a
    field of 8 dims (DCN-v2's MLP 64, 32).  One microbatch and a 10-step
    warmup."""
    cfg = arch.cfg
    if arch.family == "transformer":
        moe = cfg.moe
        if moe is not None:
            moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                      d_ff=64, group_size=64)
        cfg = dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 4), d_head=16, d_ff=128,
            vocab=512, moe=moe, dtype=torch.float32,
            param_dtype=torch.float32, q_chunk=0)
    elif arch.family == "nequip":
        cfg = dataclasses.replace(cfg, n_layers=2, channels=8)
    elif arch.family == "sasrec":
        cfg = dataclasses.replace(cfg, n_items=1000, embed_dim=16,
                                  seq_len=16, n_neg=32)
    else:  # recsys
        kw = dict(vocab_per_field=1000, embed_dim=8)
        if cfg.kind == "dcn_v2":
            kw["mlp_dims"] = (64, 32)
        cfg = dataclasses.replace(cfg, **kw)
    return dataclasses.replace(
        arch, cfg=cfg,
        train_cfg=dataclasses.replace(
            arch.train_cfg, microbatches=1,
            opt=dataclasses.replace(arch.train_cfg.opt, warmup_steps=10,
                                    total_steps=1000)),
    )


class GraphStream:
    """NequIP batches: ``n_graphs`` small molecules of 12 atoms and 32
    edges, ``batch_small_graphs(seed * 100003 + step, ...)`` as the
    reference's launcher draws them, with per-graph energies N(0, 1)
    and forces N(0, 0.01) from a CPU generator seeded ``fold_seed(seed,
    step)``.  ``n_graphs`` is static; the loss closes over it
    (:func:`stream_loss`)."""

    def __init__(self, state: IteratorState, n_graphs: int, n_species: int):
        self.state = state
        self.n_graphs, self.n_species = n_graphs, n_species

    def next(self) -> dict:
        b = G.batch_small_graphs(
            self.state.seed * 100003 + self.state.step,
            n_graphs=self.n_graphs, nodes_per=12, edges_per=32,
            n_species=self.n_species)
        b.pop("n_graphs")
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        gen = torch.Generator().manual_seed(
            fold_seed(self.state.seed, self.state.step))
        b["energy"] = torch.randn(self.n_graphs, generator=gen)
        b["forces"] = torch.randn(b["positions"].shape, generator=gen) * 0.1
        self.state.step += 1
        return b


def make_stream(arch, batch: int, seq: int, seed: int, step: int = 0):
    """The arch family's batch stream from ``step`` on (``seq`` is the
    LMs' sequence length; the other families take theirs from the
    config)."""
    st = IteratorState(seed=seed, step=step)
    cfg = arch.cfg
    if arch.family == "transformer":
        return TokenStream(st, batch, seq, cfg.vocab)
    if arch.family == "sasrec":
        return SequenceStream(st, batch, cfg.seq_len, cfg.n_items,
                              cfg.n_neg)
    if arch.family == "recsys":
        return ClickStream(st, batch, cfg.n_dense, cfg.n_sparse,
                           cfg.vocab_per_field)
    if arch.family == "nequip":
        return GraphStream(st, max(batch // 8, 1), cfg.n_species)
    raise ValueError(arch.family)


def stream_loss(arch, stream):
    """The arch's ``loss_fn(params, batch)`` over ``stream``'s batches:
    NequIP's closes over the stream's static graph count."""
    if isinstance(stream, GraphStream):
        return arch.loss_fn(n_graphs=stream.n_graphs)
    return arch.loss_fn()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--die-at-step", type=int, default=0,
                   help="simulate a node failure (for FT tests)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    args = p.parse_args(argv)

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _run(args)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _run(args) -> int:
    dev = resolve_device(args.device)
    arch = registry.get(args.arch)
    if args.reduced:
        arch = reduced_arch(arch)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = arch.model.init_params(gen, arch.cfg, device=dev)
    state = init_state(args.seed, params, arch.train_cfg)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
        latest = mgr.latest_step()
        if latest is not None:
            state, extra = mgr.restore(state, latest)
            start_step = latest
            args.seed = extra.get("seed", args.seed)
            print(f"[restore] resumed from step {latest}")

    stream = make_stream(arch, args.batch, args.seq, args.seed,
                         step=start_step)
    step_fn = make_train_step(stream_loss(arch, stream), arch.train_cfg)

    t0 = time.time()
    for i in range(start_step, args.steps):
        if args.die_at_step and i == args.die_at_step:
            print(f"[failure-sim] dying at step {i}", flush=True)
            if mgr:
                mgr.wait()
            sys.exit(42)
        batch = stream.next()
        state, metrics = step_fn(state, batch)
        if (i + 1) % args.log_every == 0 or i == start_step:
            dt = time.time() - t0
            print(
                f"step {i+1:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt:.1f}s)", flush=True,
            )
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, extra={"seed": args.seed})
    if mgr:
        mgr.save(args.steps, state, extra={"seed": args.seed})
        mgr.wait()
    print("[done]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
