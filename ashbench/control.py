#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the system's place and computed one precision lower
than the configurations state (TF32 products for float32 with TF32
off), at a cell's own size, judged exactly as a run judges the system.

    python3 ashbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10]

One JSON line a seed with each number the check compares; the control
has to fail at least one of them.  ``PERF.md`` keeps the readings that
the limits in ``configs/*.json`` were set from.  The benchmark's own
runs never run this.
"""
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def judged_rows(plan, seed):
    """The query rows a run judges: the batch pool, or the rows of the
    online requests sampled from the seed."""
    import numpy as np

    from ashbench import harness

    if plan.kind == "batch":
        return np.arange(plan.pool_rows)
    pick = harness.judged_requests(plan, seed)
    return np.concatenate([plan.first[i] + np.arange(plan.sizes[i])
                           for i in pick])


def readings(cell, seed: int, seconds: float, device="cuda",
             tf32: bool = True) -> dict:
    """The numbers of the control (``tf32``) or of the reference itself,
    in the system's place, for a run seeded ``seed``."""
    import torch

    from ashbench import check, data, harness, traffic
    from ashbench import reference as R

    dev = torch.device(device)
    cfg = cell.config
    plan = traffic.plan(cell.traffic, cell.cell, seconds,
                        data.stream_seed(seed, 3))
    X, Q = data.draw(cfg, plan.pool_rows + harness.WARM_ROWS, seed, dev)
    rows = judged_rows(plan, seed)
    queries = Q[torch.as_tensor(rows, device=dev)]
    nprobe = cfg["search"].get("nprobe") if cfg["backend"] == "ivf" else None
    raw = X.to(torch.bfloat16)

    def side(lower: bool):
        with R.precision(tf32=lower):
            gen = torch.Generator(device=dev).manual_seed(
                data.stream_seed(seed, 4))
            model = R.train(gen, X, **cfg["ash"], **cfg["train"])
            payload = R.encode(model, X)
        return model, payload

    model_c, payload_c = side(tf32)
    with R.precision(tf32=tf32):
        short = R.shortlists(model_c, payload_c, raw,
                             R.prepare(model_c, queries), cfg["metric"],
                             plan.rerank, nprobe=nprobe)
        scores, ids = R.answers(short, plan.k, plan.rerank)
    out = check.Outputs(
        W=model_c.W, landmarks=model_c.landmarks, codes=payload_c.codes,
        scale=payload_c.scale, offset=payload_c.offset,
        cluster=payload_c.cluster, row_ids=None,
        probe=None if nprobe is None else short.probe.cpu().numpy(),
        scores=scores.cpu().numpy(), ids=ids.cpu().numpy())
    model, payload = side(False)
    with R.precision(tf32=False):
        numbers = check.setup_numbers(out, model, payload)
        gaps, probes = check.answer_gaps(out, model, payload, raw, queries,
                                         cfg["metric"], plan.rerank,
                                         cfg["tie"], nprobe)
    if probes is not None:
        numbers["probes"] = probes
    numbers["answers"] = float(gaps.max())
    return numbers


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from ashbench import spec

    p = argparse.ArgumentParser(prog="ashbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(a.workload)
    for s in a.seeds.split(","):
        nums = readings(cell, int(s), a.seconds)
        print(json.dumps({"workload": a.workload, "seed": int(s),
                          "control": nums}), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
