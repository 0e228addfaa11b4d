"""Dry-run on the H100 meshes: trace every (arch x cell) program on fake
DTensors and report per-card memory, cost and collectives
(counterpart of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --cell train_4k --multi-pod single --json out.jsonl

Single mesh: (data=32, model=8) = 256 cards.
Multi-pod mesh: (pod=2, data=32, model=8) = 512 cards.

It runs on the CPU with no card and allocates nothing of the model: the
tensors are fake and the process group is a fake one of 256 or 512
ranks, made for each mesh and destroyed after it (``launch.mesh``).
A row's figures come from datasheet constants (``launch.roofline``):
they are a plan, not a measurement.  ``argument_size_gib_per_dev`` is
exact from the shardings; the names in ``estimated`` are figures of a
model (the traced peak, HBM bytes without fusion, the three times).
``--jobs N`` traces cells in N worker processes, the costliest first.
``--mesh 1x1`` (or any ``DxM`` / ``PxDxM``) replaces the production
meshes, and ``--cells JSON`` names the cells, each with overrides of
its shape entries, e.g. one-card plans at the batch a card runs:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 1x1 \\
      --cells '[["llama3.2-3b", "train_4k", {"global_batch": 2}]]'
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

from repro_torch.configs import registry
from repro_torch.launch import analysis as AN
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (PRODUCTION, fake_world, make_mesh,
                                     mesh_context, mesh_size)
from repro_torch.launch.sharding import ShardingPolicy

ESTIMATED = ["peak_gib_per_dev", "fits_80g_hbm", "hbm_bytes_per_dev",
             "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
             "useful_flops_frac", "roofline_frac"]


def _gib(b):
    return round(b / 2**30, 3)


def run_cell(arch, cell, mesh, *, policy=None, verbose=True,
             with_probes: bool = False) -> dict:
    pol = policy or ShardingPolicy()
    tr = AN.trace_cell(arch, cell, mesh, pol)
    roof = AN.corrected_roofline(arch, cell, mesh, pol, tr)
    peak = max(tr.peak_bytes, tr.argument_bytes)
    result = {
        "arch": arch.arch_id,
        "cell": cell.name,
        "kind": cell.kind,
        "mesh": mesh.name,
        "chips": mesh_size(mesh),
        "trace_s": round(tr.seconds, 1),
        "argument_size_gib_per_dev": _gib(tr.argument_bytes),
        "argument_bytes_by_arg": tr.arg_bytes,
        "output_size_gib_per_dev": _gib(tr.output_bytes),
        "peak_gib_per_dev": _gib(peak),
        "fits_80g_hbm": bool(peak < RL.HBM_BYTES),
        "collective_counts": tr.coll.count_by_kind,
        "collective_bytes_by_axis": tr.coll.bytes_by_axis,
        "flops_per_dev": roof.flops,
        "hbm_bytes_per_dev": roof.hbm_bytes,
        "collective_bytes_per_dev": roof.collective_bytes,
        **{k: (round(v, 6) if isinstance(v, float) else v)
           for k, v in roof.row().items()
           if k.startswith("t_") or k in (
               "bottleneck", "useful_flops_frac", "roofline_frac")},
        "estimated": ESTIMATED,
    }
    if with_probes and arch.family == "transformer":
        result.update(AN.probe_check(arch, cell, mesh, pol, full=tr))
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def mesh_spec(name: str):
    """(shape, axes) of a mesh named ``DxM`` or ``PxDxM``."""
    shape = tuple(int(x) for x in name.split("x"))
    return shape, ("pod", "data", "model")[-len(shape):]


def _cost(arch, cell) -> float:
    """A rough relative cost of a cell's trace (the costliest start first)."""
    if arch.family != "transformer":
        return 1.0
    k = arch.train_cfg.microbatches if cell.kind == "train" else 1
    return arch.cfg.n_layers * k * (4.0 if arch.cfg.moe else 1.0) * (
        3.0 if cell.kind == "train" else 1.0)


def _one(mesh, arch_id, cell_name, shape, pol, with_probes):
    """(row, None) or (None, (tag, error)) of one cell on ``mesh``."""
    arch = registry.get(arch_id)
    cell = arch.cell(cell_name)
    if shape:
        cell = dataclasses.replace(cell, shape={**cell.shape, **shape})
        arch = dataclasses.replace(arch, cells={**arch.cells,
                                                cell_name: cell})
    tag = f"{arch_id}/{cell_name}/{mesh.name}"
    print(f"=== {tag} ===", flush=True)
    try:
        return run_cell(arch, cell, mesh, policy=pol,
                        with_probes=with_probes), None
    except Exception as e:
        traceback.print_exc()
        return None, (tag, repr(e))


_WORKER = {}


def _init_worker(spec):
    import torch

    torch.set_num_threads(1)
    shape, axes = spec
    world = fake_world(math.prod(shape))
    world.__enter__()  # the group lives as long as the worker
    _WORKER.update(world=world, mesh=make_mesh(shape, axes))


def _worker(task):
    return _one(_WORKER["mesh"], *task)


def run_mesh(spec, todo: list, pol, with_probes: bool, jobs: int = 1):
    """Trace ``todo`` [(arch_id, cell_name, shape overrides)] on the mesh
    ``spec`` = (shape, axes); returns (rows, failures)."""
    tasks = [(a, c, sh, pol, with_probes) for a, c, sh in todo]
    if jobs > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(
                jobs, initializer=_init_worker, initargs=(spec,)) as pool:
            parts = pool.map(_worker, tasks, chunksize=1)
    else:
        with mesh_context(*spec) as mesh:
            parts = [_one(mesh, *t) for t in tasks]
    return ([r for r, _ in parts if r is not None],
            [f for _, f in parts if f is not None])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="arch id (default: all)")
    p.add_argument("--cell", default=None, help="cell name (default: all)")
    p.add_argument("--multi-pod", choices=("single", "multi", "both"),
                   default="both")
    p.add_argument("--include-skipped", action="store_true")
    p.add_argument("--json", default=None, help="append results to file")
    p.add_argument("--seq-parallel", action="store_true")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--with-probes", action="store_true",
                   help="check F(L) = e + L*l on the LM cells (slower)")
    p.add_argument("--jobs", type=int, default=1,
                   help="worker processes (cells split among them)")
    p.add_argument("--mesh", default=None,
                   help="DxM or PxDxM in place of the production meshes")
    p.add_argument("--cells", default=None,
                   help='JSON [[arch, cell, {shape overrides}], ...]')
    args = p.parse_args(argv)

    pol = ShardingPolicy(seq_parallel=args.seq_parallel,
                         fsdp=not args.no_fsdp)
    pods = {"single": (False,), "multi": (True,), "both": (False, True)}[
        args.multi_pod]
    specs = ([mesh_spec(args.mesh)] if args.mesh
             else [PRODUCTION[mp] for mp in pods])
    cells = sorted(((a, c) for a, c in registry.all_cells(
        args.include_skipped or bool(args.cell))
        if (not args.arch or a.arch_id == args.arch)
        and (not args.cell or c.name == args.cell)),
        key=lambda ac: -_cost(*ac))
    todo = ([tuple(t) for t in json.loads(args.cells)] if args.cells
            else [(a.arch_id, c.name, {}) for a, c in cells])
    t0 = time.time()
    results, failures = [], []
    for spec in specs:
        rs, fs = run_mesh(spec, todo, pol, args.with_probes
                          and spec == PRODUCTION[False], args.jobs)
        results += rs
        failures += fs
    print(f"\n==== dry-run done: {len(results)} ok, "
          f"{len(failures)} failed, {time.time() - t0:.1f} s ====")
    for tag, err in failures:
        print(f"FAILED {tag}: {err[:200]}")
    if args.json:
        mode = "a" if os.path.exists(args.json) else "w"
        with open(args.json, mode) as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
