"""ANN serving launcher of the port: build an ASH index on the card over a
synthetic embedding set and serve a request stream through the
micro-batching engine — the paper's end-to-end scenario.

Counterpart of ``repro.launch.serve``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` only when asked for)::

  PYTHONPATH=src python -m repro_torch.launch.serve --n 100000 \\
      --dim 256 --bits 2 --reduce 2 --landmarks 64 --queries 1000 \\
      --req-batch 8

The index rows and the queries are two independent ``embedding_dataset``
draws on the device, as the reference's ``kx`` and ``kq`` keys split
from ``--seed`` (:func:`dataset`): each draw makes its own covariance
and cluster centers, so the queries come from their own distribution;
the model trains from
``torch.Generator().manual_seed(--seed)``.  Requests of ``--req-batch``
rows stream through a ``QueryEngine`` (flush-on-size/timeout, padded
buckets, prep cache); the launcher reports build time, QPS, p50/p99
request latency, engine stats, and 10-recall@{10,100} against exact
ground truth.  ``--engine ivf`` serves through the inverted-file index
(the paper's Fig. 9 setup); ``--engine flat`` scans everything;
``--engine sharded`` scatter-gathers over one shard per visible card;
``--tiered`` pages IVF lists from host memory into a ``--hot-bytes``
device hot set.

``--concurrent N`` switches to the concurrent serving subsystem: a
``ServingFrontend`` driver thread owns the flush cadence while N
closed-loop client threads (each: submit, block on the ticket, repeat)
share the batching — with a ``BackgroundCompactor`` attached when
``--auto-compact`` is set, so tombstone eviction happens off the
serving path.  ``--http PORT`` instead serves a minimal JSON API
(stdlib ``http.server`` atop the asyncio facade, :class:`HttpServer`):
POST ``/search`` with ``{"queries": [[...]], "k": 10}``, GET ``/stats``
for the live engine snapshot; Ctrl-C (SIGINT) stops it.

``--wal DIR`` serves under a write-ahead log with atomic checkpoints
(``serving.wal.DurableIndex``): if DIR already holds a checkpoint the
index is recovered from it (checkpoint + log replay) instead of served
from the fresh build; a clean end writes a final checkpoint, so the
next start replays nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.core.types import ASHConfig
from repro_torch.data.synthetic import embedding_dataset, isotropy_diagnostics
from repro_torch.device import resolve_device
from repro_torch.index import AshIndex
from repro_torch.index import metrics as MET
from repro_torch.kernels import ash_score as TK
from repro_torch.serving.compactor import BackgroundCompactor
from repro_torch.serving.engine import QueryEngine
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.wal import DurableIndex


def stream_seed(seed: int, stream: int) -> int:
    """The seed of draw ``stream`` of ``seed``: the splitmix64 finalizer
    of ``4 * seed + stream``, cut to 63 bits (``torch.Generator`` takes
    a non-negative int64).  Streams 1 and 2 are the index rows and the
    queries, the reference's ``kx, kq = split(PRNGKey(seed), 3)[:2]``."""
    z = (4 * seed + stream) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def dataset(n: int, dim: int, queries: int, seed: int, device):
    """(X, Q): ``n`` index rows and ``queries`` query rows on ``device``,
    two independent ``embedding_dataset`` draws seeded with
    ``stream_seed(seed, 1)`` and ``stream_seed(seed, 2)`` (a caller that
    re-creates the launcher's data, e.g. to search a ``--save-dir``
    index, calls this)."""
    X = embedding_dataset(n, dim, seed=stream_seed(seed, 1), device=device)
    Q = embedding_dataset(queries, dim, seed=stream_seed(seed, 2),
                          device=device)
    return X, Q


def _where(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "the CPU"


def _print_engine_report(engine):
    """The shared observability block: engine snapshot, prep cache,
    flush-reason mix, queue/compaction telemetry."""
    snap = engine.stats.snapshot()
    print(f"[engine] {snap}")
    print(f"[prep-cache] hit_rate={snap['prep_hit_rate']:.3f} "
          f"({snap['prep_hits']}/{snap['prep_hits'] + snap['prep_misses']} "
          f"rows) resident={engine.prep_cache_bytes / 1024:.1f}KiB "
          f"budget={engine.config.prep_cache_bytes / 2**20:.0f}MiB")
    reasons = ", ".join(
        f"{r}={c}" for r, c in snap["flushes"].items() if c
    )
    print(f"[queue] hwm={snap['queue_hwm']} rows "
          f"depth={snap['queue_depth']} "
          f"oldest_ticket={1e3 * snap['oldest_ticket_age_s']:.2f}ms "
          f"deadline_missed={snap['deadline_missed']} "
          f"flushes: {reasons or 'none'}")
    ic = snap.get("ivf_cost", {})
    if ic.get("effective_nprobe") or ic.get("splits"):
        eff = ", ".join(
            f"nprobe={n}:{c}" for n, c in sorted(
                ic["effective_nprobe"].items(), key=lambda kv: int(kv[0])
            )
        )
        print(f"[ivf-cost] rows_per_q={ic['rows_per_query']} "
              f"splits={ic['splits']} degraded={ic['degraded']} "
              f"flushes: {eff or 'none'}")
    comp = snap["compaction"]
    if comp["runs"] or comp["retries"] or snap["compactions"]:
        print(f"[compaction] background runs={comp['runs']} "
              f"retries={comp['retries']} swap={comp['swap_ms']:.2f}ms "
              f"blocked={comp['blocked_ms']:.2f}ms "
              f"synchronous={snap['compactions']}")
    for name, ts in snap.get("tier", {}).items():
        print(f"[tier] index={name} hit_rate={ts['hit_rate']:.3f} "
              f"({ts['hits']}/{ts['hits'] + ts['misses']} lists) "
              f"resident={ts['resident_lists']}/{ts['nlist']} lists "
              f"{ts['resident_bytes'] / 1024:.1f}KiB of "
              f"{ts['hot_bytes'] / 2**20:.0f}MiB budget "
              f"(index {ts['total_bytes'] / 2**20:.1f}MiB) "
              f"paged={ts['paged_rows']} rows "
              f"{ts['paged_bytes'] / 1024:.1f}KiB "
              f"in {ts['transfers']} transfers "
              f"evictions={ts['evictions']}")
    dur = snap.get("durability", {})
    for name, ws in dur.get("indexes", {}).items():
        print(f"[durability] index={name} wal_seq={ws['last_seqno']} "
              f"appends={ws['appends']} "
              f"({ws['appended_bytes'] / 1024:.1f}KiB) "
              f"fsync={ws['fsync']}:{ws['fsyncs']} "
              f"checkpoints={ws['checkpoints']}"
              f"@seq{ws['checkpoint_seqno']} "
              f"failures={dur.get('wal_failures', 0)}")
    launched = {n: c for n, c in TK.launch_counts.items() if c}
    print(f"[launches] {json.dumps(launched)} (kernel launches in this "
          f"process; the plain versions on the CPU count none)")
    sup = snap.get("supervision", {})
    if sup.get("driver_failures") or sup.get("compact_failures"):
        print(f"[supervision] driver_failures="
              f"{sup['driver_failures']} "
              f"(streak {sup['driver_consecutive_failures']}, "
              f"last {sup['driver_last_error']}) "
              f"compact_failures={sup['compact_failures']} "
              f"(last {sup['compact_last_error']})")
    return snap


def _final_checkpoint(engine):
    """Clean-shutdown checkpoint: fold the WAL into a fresh checkpoint
    so the next start replays nothing."""
    durable = engine.durability("default")
    if durable is None:
        return
    seq = durable.checkpoint(barrier=engine.mutation_barrier())
    durable.close()
    print(f"[checkpoint] seq={seq} (wal truncated)")


def _run_concurrent(args, index, engine, Q, search_kw, where):
    """Closed-loop multi-client serving: N threads each submit one
    request, block on its ticket, and immediately submit the next —
    the frontend driver owns every flush, so concurrent clients share
    buckets that a single caller would underfill."""
    import threading

    compactor = None
    if args.auto_compact is not None:
        compactor = BackgroundCompactor(engine).start()
    n_clients = args.concurrent
    per_client = max(1, args.queries // (n_clients * args.req_batch))
    latencies = [[] for _ in range(n_clients)]
    errors = []

    t0 = time.time()
    with ServingFrontend(engine) as fe:
        def client(cid):
            rng = np.random.RandomState(args.seed + 100 + cid)
            try:
                for _ in range(per_client):
                    lo = rng.randint(0, max(1, len(Q) - args.req_batch))
                    t_req = time.perf_counter()
                    fe.search(Q[lo:lo + args.req_batch], k=100,
                              timeout=60.0, **search_kw)
                    latencies[cid].append(time.perf_counter() - t_req)
                    if args.mutate_fraction > 0 and (
                        rng.rand() < args.mutate_fraction
                    ):
                        if rng.rand() < 0.5:
                            fe.submit_add(
                                Q[lo:lo + args.req_batch]
                            ).result(60.0)
                        else:
                            fe.submit_delete(
                                rng.randint(0, index.n, args.req_batch)
                            ).result(60.0)
            except Exception as e:  # surface, don't hang the join
                errors.append((cid, e))

        threads = [
            threading.Thread(target=client, args=(c,), daemon=True)
            for c in range(n_clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if compactor is not None:
        compactor.wait_idle(30.0)
        compactor.stop()
    dt = time.time() - t0
    if errors:
        raise errors[0][1]
    lat = np.concatenate([np.asarray(x) for x in latencies])
    served = lat.size * args.req_batch
    p50, p99 = np.percentile(lat, [50, 99])
    print(f"[serve] {served} queries via {n_clients} closed-loop "
          f"clients in {dt:.2f}s ({served / dt:.0f} QPS on {where})")
    print(f"[latency] p50={1e3 * p50:.1f}ms p99={1e3 * p99:.1f}ms "
          f"per request")
    _print_engine_report(engine)
    _final_checkpoint(engine)
    return 0


class HttpServer:
    """The launcher's JSON API: a stdlib ``ThreadingHTTPServer`` on
    127.0.0.1 whose handlers dispatch into a ``ServingFrontend``'s
    asyncio facade — each request awaits its ticket on an event loop
    thread, so handler threads never park inside a flush.

    ``port=0`` binds a free port (read it from :attr:`port`).
    :meth:`serve_forever` blocks (run it on a thread, or on the main
    thread until Ctrl-C); :meth:`close` stops the server, the loop, the
    frontend and the compactor, in that order."""

    def __init__(self, engine, search_kw, port: int = 0, *,
                 auto_compact: bool = False):
        import asyncio
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.engine = engine
        self.compactor = (BackgroundCompactor(engine).start()
                          if auto_compact else None)
        self.frontend = fe = ServingFrontend(engine).start()
        self.loop = loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=loop.run_forever, name="ash-http-loop", daemon=True
        )
        self._loop_thread.start()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # stay quiet; stats has the counts
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload, default=str).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path != "/stats":
                    return self._reply(404, {"error": "GET /stats only"})
                snap = engine.stats.snapshot()
                snap["compiled_buckets"] = snap.pop("unique_buckets", 0)
                self._reply(200, snap)

            def do_POST(self):
                if self.path != "/search":
                    return self._reply(404, {"error": "POST /search only"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    q = np.asarray(req["queries"], dtype=np.float32)
                    k = int(req.get("k", 10))
                    fut = asyncio.run_coroutine_threadsafe(
                        fe.asearch(q, k, **search_kw), loop
                    )
                    scores, ids = fut.result(timeout=60.0)
                    self._reply(200, {"scores": scores.tolist(),
                                      "ids": ids.tolist()})
                except Exception as e:
                    self._reply(400, {"error": str(e)})

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]

    def serve_forever(self) -> None:
        self.server.serve_forever()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join(timeout=5.0)
        self.frontend.stop()
        if self.compactor is not None:
            self.compactor.stop()


def _run_http(args, index, engine, search_kw):
    """Serve the JSON API on 127.0.0.1:``--http`` until Ctrl-C."""
    srv = HttpServer(engine, search_kw, args.http,
                     auto_compact=args.auto_compact is not None)
    print(f"[http] serving {index!r}")
    print(f"[http] POST http://127.0.0.1:{srv.port}/search "
          f'{{"queries": [[...x{index.model.landmarks.shape[1]}]], '
          f'"k": 10}} | GET /stats | Ctrl-C to stop', flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        _print_engine_report(engine)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--queries", type=int, default=1000)
    p.add_argument("--req-batch", type=int, default=8,
                   help="rows per request submitted to the engine")
    p.add_argument("--buckets", default="8,32,128",
                   help="engine batch buckets (padded shapes)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="engine flush-on-timeout age")
    p.add_argument("--bits", type=int, default=2)
    p.add_argument("--reduce", type=int, default=2,
                   help="dimensionality reduction factor (d = D / r)")
    p.add_argument("--landmarks", type=int, default=64)
    p.add_argument("--engine", choices=("flat", "ivf", "sharded"),
                   default="flat")
    p.add_argument("--tiered", action="store_true",
                   help="serve the IVF index host-tiered "
                        "(backend=tiered_ivf): codes/stats live in "
                        "pinned host memory, only a --hot-bytes LRU of "
                        "inverted lists stays on the device; probes "
                        "page cold lists in one batched transfer.  "
                        "Results stay bit-identical to --engine ivf "
                        "at equal probe sets (implies --engine ivf)")
    p.add_argument("--hot-bytes", type=int, default=64 << 20,
                   help="device-resident hot-set byte budget for "
                        "--tiered (0 = page every probe)")
    p.add_argument("--metric", choices=("dot", "l2", "cos"),
                   default="dot")
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--row-budget", type=int, default=None,
                   help="IVF cost model: cap the deduped candidate-row "
                        "bill per fused call — over-budget groups "
                        "flush early and split into within-budget "
                        "sub-batches (requires --engine ivf)")
    p.add_argument("--adaptive-nprobe", type=int, default=None,
                   metavar="NPROBE_MIN",
                   help="scale nprobe down a halving ladder toward "
                        "this floor under queue pressure, trading "
                        "recall for tail latency (requires "
                        "--engine ivf)")
    p.add_argument("--rerank", type=int, default=0)
    p.add_argument("--coarse", choices=("int8",), default=None,
                   help="run the symmetric int8 first-pass scan and "
                        "asymmetrically rescore only the top "
                        "--shortlist candidates per query")
    p.add_argument("--shortlist", type=int, default=None,
                   metavar="L",
                   help="coarse first-pass shortlist size (requires "
                        "--coarse; default: kernels.ops."
                        "DEFAULT_SHORTLIST)")
    p.add_argument("--mutate-fraction", type=float, default=0.0,
                   help="fraction of stream slots that carry a "
                        "mutation (engine-queued batched add or "
                        "tombstone delete) alongside the query traffic")
    p.add_argument("--auto-compact", type=float, default=None,
                   help="dead-fraction threshold for automatic "
                        "tombstone eviction after mutation batches "
                        "(off-thread under --concurrent/--http)")
    p.add_argument("--concurrent", type=int, default=0, metavar="N",
                   help="serve through a ServingFrontend driver with "
                        "N closed-loop client threads instead of the "
                        "single-caller stream")
    p.add_argument("--http", type=int, default=0, metavar="PORT",
                   help="serve a minimal JSON API on 127.0.0.1:PORT "
                        "(POST /search, GET /stats) atop the asyncio "
                        "facade until Ctrl-C")
    p.add_argument("--save-dir", default=None,
                   help="persist the built index (npz + JSON) here")
    p.add_argument("--wal", default=None, metavar="DIR",
                   help="durability directory: mutation WAL + atomic "
                        "checkpoints.  If DIR already holds a "
                        "checkpoint the index is RECOVERED from it "
                        "(checkpoint + WAL replay) instead of served "
                        "from the fresh build")
    p.add_argument("--fsync", choices=("always", "interval", "off"),
                   default="interval",
                   help="WAL fsync policy: 'always' makes every "
                        "acknowledged mutation survive power loss, "
                        "'interval' bounds the loss window, 'off' "
                        "leaves it to the OS (process crashes lose "
                        "nothing under any policy)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and the data (the "
                        "CPU only when asked for: --device cpu)")
    args = p.parse_args(argv)
    if args.tiered and args.engine not in ("flat", "ivf"):
        p.error("--tiered requires --engine ivf")
    if args.shortlist is not None and args.coarse is None:
        p.error("--shortlist requires --coarse")
    engine_kw = {}
    if args.row_budget is not None:
        engine_kw["row_budget"] = args.row_budget
    if args.adaptive_nprobe is not None:
        engine_kw["nprobe_min"] = args.adaptive_nprobe
    if engine_kw and args.engine != "ivf" and not args.tiered:
        p.error("--row-budget/--adaptive-nprobe require --engine ivf")

    dev = resolve_device(args.device)
    where = _where(dev)
    X, Q = dataset(args.n, args.dim, args.queries, args.seed, dev)
    print("[data] isotropy:", isotropy_diagnostics(X))

    cfg = ASHConfig(
        b=args.bits, d=args.dim // args.reduce,
        n_landmarks=args.landmarks,
    )
    print(f"[config] b={cfg.b} d={cfg.d} C={cfg.n_landmarks} "
          f"payload={cfg.payload_bits()} bits/vec "
          f"({32 * args.dim / cfg.payload_bits():.1f}x compression)")

    t0 = time.time()
    opts = {"keep_raw": args.rerank > 0}
    backend = args.engine
    if args.tiered:
        backend = "tiered_ivf"
        opts["hot_bytes"] = args.hot_bytes
    index = AshIndex.build(
        torch.Generator().manual_seed(args.seed), X, cfg,
        backend=backend, metric=args.metric, device=dev, **opts,
    )
    print(f"[build] {time.time() - t0:.2f}s  {index!r}")
    if args.save_dir:
        index.save(args.save_dir)
        print(f"[save] {args.save_dir}")

    durable = None
    if args.wal:
        if DurableIndex.exists(args.wal):
            index_opts = {"device": dev}
            if args.tiered:
                index_opts["hot_bytes"] = args.hot_bytes
            durable = DurableIndex.open(
                args.wal, fsync=args.fsync, index_opts=index_opts
            )
            index = durable.index
            print(f"[recovery] {durable.report.describe()}")
            print(f"[recovery] serving the recovered index "
                  f"(fresh build discarded): {index!r}")
        else:
            durable = DurableIndex.create(
                index, args.wal, fsync=args.fsync
            )
            print(f"[wal] durability at {args.wal} "
                  f"(fsync={args.fsync}, checkpoint 0 written)")

    gt_s, gt_i = MET.exact_topk(Q, X, k=10, metric=args.metric)
    Q = Q.cpu().numpy()  # requests arrive as host rows

    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = QueryEngine(
        index, batch_buckets=buckets,
        max_wait_s=args.max_wait_ms / 1e3,
        auto_compact=args.auto_compact,
        **engine_kw,
    )
    if durable is not None:
        engine.attach_durability(durable)
    search_kw = dict(nprobe=args.nprobe, rerank=args.rerank)
    if args.coarse is not None:
        search_kw["coarse"] = args.coarse
        if args.shortlist is not None:
            search_kw["shortlist"] = args.shortlist

    if args.http:
        return _run_http(args, index, engine, search_kw)

    # warmup on a throwaway engine: run EVERY bucket shape the stream
    # can hit (steady-state size flushes AND whatever bucket the final
    # remainder pads to) without pre-warming the timed engine's prep
    # cache or polluting its stats — kernel loads and first-call
    # allocations inside the timed window would be charged to QPS/p99
    warm = QueryEngine(
        index, batch_buckets=buckets,
        max_wait_s=args.max_wait_ms / 1e3,
    )
    for b in buckets:
        warm.search(Q[: min(b, args.queries)], k=100, **search_kw)
    if args.adaptive_nprobe is not None:
        # under pressure flushes walk the halving ladder from --nprobe
        # down to the floor; run every rung now so a degraded flush
        # never charges a first call to a live ticket
        n_w = args.nprobe
        while n_w > args.adaptive_nprobe:
            n_w = max(args.adaptive_nprobe, n_w // 2)
            for b in buckets:
                warm.search(Q[: min(b, args.queries)], k=100,
                            nprobe=n_w, rerank=args.rerank)
    del warm

    if args.concurrent:
        return _run_concurrent(args, index, engine, Q, search_kw, where)

    mut_rng = np.random.RandomState(args.seed + 1)
    mut_tickets = []
    t0 = time.time()
    tickets = []
    for i in range(0, args.queries, args.req_batch):
        if args.mutate_fraction > 0 and mut_rng.rand() < args.mutate_fraction:
            # live mutation traffic rides the same engine queue: adds
            # re-ingest existing rows (no re-training), deletes
            # tombstone random live ids; both barrier this index's
            # queued queries and apply batched at the next flush
            if mut_rng.rand() < 0.5:
                pick = mut_rng.randint(0, args.n, args.req_batch)
                rows = X[torch.from_numpy(pick).to(X.device)]
                mut_tickets.append(engine.submit_add(rows.cpu().numpy()))
            else:
                victims = mut_rng.randint(0, index.n, args.req_batch)
                mut_tickets.append(engine.submit_delete(victims))
        tickets.append(
            engine.submit(Q[i:i + args.req_batch], k=100, **search_kw)
        )
    engine.flush()
    dt = time.time() - t0
    ids = torch.cat([t.result()[1] for t in tickets], dim=0)

    p50, p99 = np.percentile([t.stats.latency_s for t in tickets],
                             [50, 99])
    print(f"[serve] {args.queries} queries "
          f"({len(tickets)} requests x {args.req_batch}) in {dt:.2f}s "
          f"({args.queries / dt:.0f} QPS on {where})")
    print(f"[latency] p50={1e3 * p50:.1f}ms "
          f"p99={1e3 * p99:.1f}ms per request")
    snap = _print_engine_report(engine)
    if mut_tickets:
        added = sum(t.n_rows for t in mut_tickets if t.kind == "add")
        removed = sum(t.result() for t in mut_tickets
                      if t.kind == "delete")
        print(f"[mutations] {len(mut_tickets)} submissions "
              f"({added} rows added, {removed} removed) in "
              f"{snap['mutation_batches']} batched applies, "
              f"{snap['compactions']} compactions; index now "
              f"n={index.n} live={index.n_live}")
        print("[recall] skipped (index mutated during the stream; "
              "ground truth is stale)")
    else:
        rec = MET.recall_curve(ids, gt_i.cpu(), Rs=(10, 100))
        print(f"[recall] 10-recall@10={rec.get(10):.4f} "
              f"10-recall@100={rec.get(100):.4f}")
    _final_checkpoint(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
