"""Training launcher of the port (counterpart of ``repro.launch.train``),
with the same flags plus ``--device`` (default ``cuda``; ``cpu`` only
when asked for)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 8 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --batch 8 --seq 128 --reduced --device cpu \\
      --ckpt-dir /tmp/ckpt

``--reduced`` scales the architecture down (layers, widths, vocab) so
any LM config trains on a CPU; without it the arch trains at its full
widths and depth.  The loop is fault tolerant: it resumes from the
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
from repro_torch.data.synthetic import IteratorState, TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TT
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import init_state, make_train_step


def reduced_arch(arch):
    """Scale an LM config down to CPU size, same family and topology:
    2 layers, d_model 64, vocab 512, fp32, at most 8 experts; one
    microbatch and a 10-step warmup."""
    cfg = arch.cfg
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  d_ff=64, group_size=64)
    return dataclasses.replace(
        arch,
        cfg=dataclasses.replace(
            cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 4), d_head=16, d_ff=128,
            vocab=512, moe=moe, dtype=torch.float32,
            param_dtype=torch.float32, q_chunk=0),
        train_cfg=dataclasses.replace(
            arch.train_cfg, microbatches=1,
            opt=dataclasses.replace(arch.train_cfg.opt, warmup_steps=10,
                                    total_steps=1000)),
    )


def make_stream(arch, batch: int, seq: int, seed: int, step: int = 0):
    if arch.family != "transformer":
        raise ValueError(arch.family)
    return TokenStream(IteratorState(seed=seed, step=step), batch, seq,
                       arch.cfg.vocab)


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
    params = TT.init_params(gen, arch.cfg, device=dev)
    state = init_state(args.seed, params, arch.train_cfg)
    step_fn = make_train_step(arch.loss_fn(), arch.train_cfg)

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
