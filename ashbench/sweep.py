#!/usr/bin/env python3
"""Find the highest rate an online cell sustains: one index, then the
cell's open loop at each rate in turn, each through a fresh engine.

    python3 ashbench/sweep.py --workload t2i-10m-flat.online \
        --seed <n> --seconds 8 --rates 2000,3000,4000

One JSON line a rate: the p50 and p99 from due time, the median
latency of the first and the last fifth of the requests (a backlog that
grows shows as a last fifth far above the first), how long after the
window the last answer came, rows a fused call and the sender's lag.
The cell's ``rate_per_s`` is then set at 80 % of the highest rate
whose latency does not grow.  Each line also counts the interpreter's
garbage collections by generation with the longest pause of each, in
ms.  The engine, its warm-up and the p99 are the harness's own
(``harness.open_engine``, ``metrics/p99_ms.py``).
"""
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "ashbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(
    ROOT / "build" / "ashbench" / "torch_extensions")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def sweep(cell, seed: int, seconds: float, rates, device="cuda", emit=print):
    import json

    import numpy as np
    import torch

    from ashbench import data, harness, traffic

    dev = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    p99 = cell.reader("p99_ms")
    plans = [traffic.plan(mix, {**cell.cell, "rate_per_s": r}, seconds,
                          data.stream_seed(seed, 3)) for r in rates]
    rows = max(p.pool_rows for p in plans)
    X, Q = data.draw(cfg, rows + harness.WARM_ROWS, seed, dev)
    index = harness.build_index(cfg, X, seed, dev)
    del X
    pool = Q[:rows].cpu().numpy()
    kw = dict(k=plans[0].k, rerank=plans[0].rerank, **cfg["search"])
    for rate, plan in zip(rates, plans):
        engine, fe = harness.open_engine(index, Q[rows:].cpu().numpy(), kw)
        c0 = harness.counters(engine)
        harness.settle()
        with harness.GcPauses() as pauses:
            out = traffic.run_open_loop(lambda r: fe.submit(r, **kw), pool,
                                        plan)
            traffic.wait_answers(out, harness.ANSWER_WAIT_S)
        c = harness.diff(c0, harness.counters(engine))
        fe.stop()
        lat = out.latency_s()
        fifth = max(1, lat.size // 5)
        done = out.done[np.isfinite(out.done)]
        rec = harness.Record("open_loop", cfg, seconds, 0.0, {},
                             latency_s=lat)
        emit(json.dumps({
            "rate_per_s": rate, "requests": int(lat.size),
            "unanswered": int(np.isinf(lat).sum()),
            "p50_ms": float(np.median(lat)) * 1e3,
            "p99_ms": p99.read(rec),
            "first_fifth_p50_ms": float(np.median(lat[:fifth])) * 1e3,
            "last_fifth_p50_ms": float(np.median(lat[-fifth:])) * 1e3,
            "last_answer_after_window_s":
                float(done.max() - seconds) if done.size else None,
            "rows_per_call": c["rows"] / max(1, c["batches"]),
            "sender_lag_p50_ms": float(np.median(out.lag_s())) * 1e3,
            "sender_lag_max_ms": float(out.lag_s().max()) * 1e3,
            "gc_pauses": pauses.summary(),
        }), flush=True)
        time.sleep(1.0)


def main(argv=None) -> int:
    import argparse

    import torch

    from ashbench import spec

    p = argparse.ArgumentParser(prog="ashbench/sweep.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True,
                   help="comma-separated requests a second")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    sweep(spec.Cell(a.workload), a.seed, a.seconds,
          [float(r) for r in a.rates.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
