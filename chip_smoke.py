#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Runs the paper's pipeline through the port at the scale of the standard
1M-vector ANN sets: n = 1,000,000 vectors at D = 256 (synthetic,
``embedding_dataset(seed=0)``, with 1,128 more rows of it held out as
queries), ASHConfig(b=2, d=128, n_landmarks=64), with a bf16 raw copy
for exact rerank.  Phases, one line each:

  1. device: name and power limit;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
     nvcc, one process per source in parallel (into
     ``build/repro_torch/``);
  3. train and encode on the card (``AshIndex.build``), and the IVF
     index over the same model and payload (``AshIndex.from_parts``,
     nlist = 64);
  4. the dense kernels against their plain PyTorch versions on the same
     inputs (8 queries, the full index, metrics dot/l2/cos), and the
     fused kernel EXACTLY equal to a stable top-k of the materializing
     kernel's scores, with no mask, a tombstone mask and ``n_valid``;
  4b. the gathered and coarse kernels at the phase shape (8 queries;
     their IVF candidate table at nprobe = 8 for the gathered ones):
     gathered scores within the bound of their plain version and
     bit-equal to the dense kernel's, the fused gathered selection
     EXACTLY a stable top-k over positions of them, the coarse scan
     bit-equal to its plain version, the fused coarse selection EXACTLY
     a stable top-k of it under the four masks;
  5. a request stream through ``AshIndex.search``: 125 requests of 8
     queries at k=100 (fused route) and 16 at k=10, rerank=256
     (materializing kernel + exact rerank); launch counts are zeroed
     just before and read just after;
  5b. a stream of 32 requests of 8 queries on each new route: IVF k=100
     (fused gathered), IVF k=10 rerank=256 (materializing gathered),
     flat coarse k=10 (fused coarse -> fused gathered), flat coarse k=10
     rerank=256 (materializing coarse -> materializing gathered), IVF
     coarse k=10 (plain gathered coarse -> fused gathered); counts are
     zeroed before it and each route's kernels must have launched at
     least once per request; a single query searched alone equals its
     row of the batch on every route;
  6. 10-recall@10/@100 against exact search, kernel route and plain
     route on the card; 6b the same for each new route;
  7. per-kernel times, bounds and library yardsticks of all six kernels
     (a ``kernels`` JSON line), the fused strip merge alone, and a
     ``torch.profiler`` breakdown of flat and IVF requests (device time
     by kernel, idle share);
  8. save, load, search again, flat and IVF: results bit-identical.

Any failed check raises; the script exits 0 only when every phase
passed.  The last line is ``{"ok": true, "device": {...}}``.  Detailed
results go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

N, DIM = 1_000_000, 256
CFG = dict(b=2, d=128, n_landmarks=64)
REQ_M, N_REQ, N_RERANK_REQ, K, RERANK = 8, 125, 16, 100, 256
NPROBE, N_ROUTE_REQ = 8, 32  # IVF probes; requests per phase-5b route
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
U32 = 2.0**-24  # fp32 unit roundoff


def log(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def sync_time(fn, *args, **kw):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def score_tolerance(A, bias, off, qterm, rowterm, base, metric, d_pad):
    """Elementwise bound on |kernel - plain| for one score matrix.

    Both sum d_pad products q_k v_k in fp32, in different orders: each
    is within gamma_d * sum|q_k v_k| of the exact sum (gamma_d =
    d_pad*u / (1 - d_pad*u)), so they differ by at most 2 gamma_d A
    with A = |scale| * (|q| @ |V|^T).  The epilogue's few roundings
    (<= 4 per side, each within u of its operands) add 16 u of the
    magnitudes involved.  l2 doubles the base term; cos scales it by
    qterm * rowterm.
    """
    gamma = d_pad * U32 / (1 - d_pad * U32)
    mag = A + bias.abs() + off.abs()[None, :]
    if metric == "dot":
        return 2 * gamma * A + 16 * U32 * mag
    if metric == "l2":
        extra = qterm.abs()[:, None] + rowterm.abs()[None, :]
        return 4 * gamma * A + 16 * U32 * (2 * mag + extra + base.abs())
    f = (qterm[:, None] * rowterm[None, :]).abs()
    return f * (2 * gamma * A + 16 * U32 * mag) + 16 * U32 * base.abs()


def bound(ops_ms, bytes_):
    """(bound_ms, bound_by): the larger of the operations' time at the
    peak rates of their types and the bytes' time at the memory rate."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return max(ops_ms, t_bytes), ("operations" if ops_ms >= t_bytes
                                  else "bytes")


def pct(v, p):
    v = sorted(v)
    return v[min(len(v) - 1, int(round(p / 100 * (len(v) - 1))))]


def profile_requests(search, queries, n_prof=20):
    """torch.profiler over ``n_prof`` requests of REQ_M queries: wall
    and device-busy ms per request, the device's idle share, and the
    device time per request of the 8 busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(n_prof):
            search(queries[r * REQ_M:(r + 1) * REQ_M])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
    busy_ms = sum(dev_us.values()) / 1e3
    by_name = {}  # template names are long: group by their first 80 chars
    for name, us in dev_us.items():
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        requests=n_prof, wall_ms_per_request=wall_ms / n_prof,
        device_busy_ms_per_request=busy_ms / n_prof,
        # None when the profiler saw no device activity (not measured)
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_device_us_per_request={k: v / n_prof for k, v in top},
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ash as A
    from repro_torch.core import quantization as Q
    from repro_torch.core import scoring as S
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex, exact_topk, recall_curve
    from repro_torch.index import ivf as IV
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ref

    results = {}
    dev = torch.device("cuda")

    # -- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    results["device"] = dict(name=kind, nvidia_smi=smi,
                             count=torch.cuda.device_count(),
                             torch=torch.__version__,
                             cuda=torch.version.cuda)
    log("device", **results["device"])

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    TK.load_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for lib in libs.values():
        logf = lib.with_suffix(".log")
        if logf.exists():
            ptxas += [ln.strip() for ln in logf.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    results["build"] = dict(seconds=build_s, libs=[str(p.name) for p in
                                                   libs.values()],
                            ptxas=ptxas)
    log("build", seconds=build_s,
        libs=results["build"]["libs"],
        max_registers=max([int(ln.split("Used ")[1].split()[0])
                           for ln in ptxas if "Used " in ln] or [0]),
        spills=sorted({ln for ln in ptxas if "spill" in ln
                       and not ln.startswith("0 bytes stack frame, 0 bytes "
                                             "spill stores, 0 bytes spill")}
                      )[:4])

    # -- 3. train + encode on the card ----------------------------------
    # queries are held-out rows of the same distribution as the index
    n_q = (N_REQ + N_RERANK_REQ) * REQ_M
    data, t_data = sync_time(embedding_dataset, N + n_q, DIM, seed=0,
                             device=dev)
    X, queries = data[:N], data[N:]
    cfg = ASHConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    (model, history), t_train = sync_time(A.train, gen, X, cfg, device=dev)
    index, t_encode = sync_time(
        AshIndex.build, gen, X, cfg, metric="dot", device=dev,
        model=model, keep_raw=True,
    )
    payload = index.payload
    check(payload.codes.shape == (N, 8) and payload.codes.is_cuda,
          "payload shape/device")
    results["build_index"] = dict(
        data_s=t_data, train_s=t_train, encode_s=t_encode,
        itq_iters=len(history), payload_bits=cfg.payload_bits(),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
    )
    log("train_encode", **results["build_index"])
    # the IVF index over the same model and payload: nlist = 64 lists
    ivf, t_ivf = sync_time(AshIndex.from_parts, model, payload,
                           backend="ivf", metric="dot",
                           raw=index._state.raw)
    st = ivf._state
    counts = torch.bincount(st.payload.cluster.long(),
                            minlength=cfg.n_landmarks)
    results["build_ivf"] = dict(
        seconds=t_ivf, nlist=int(st.invlists.shape[0]),
        max_list_len=st.max_list_len, mean_list_len=N / cfg.n_landmarks,
        min_list_len=int(counts.min()), R=NPROBE * st.max_list_len,
    )
    log("build_ivf", **results["build_ivf"])

    # -- 4. kernels against their plain versions ------------------------
    q8 = queries[:REQ_M]
    d_pad = payload.codes.shape[1] * Q.codes_per_word(payload.b)
    V_abs = Q.unpack_codes(payload.codes, d_pad, payload.b).float().abs()
    max_err = {"ash_score": 0.0, "ash_score_topk": 0.0}
    compare = {}
    for metric in ("dot", "l2", "cos"):
        idx_m = index if metric == "dot" else AshIndex.from_parts(
            model, payload, metric=metric)
        prep = idx_m.prepare(q8)
        args = ops._score_args(prep, payload)
        qterm, rowterm = ops._metric_operands(model, prep, payload,
                                              idx_m.stats, metric)
        got = TK.ash_score_cuda(*args, qterm, rowterm, b=payload.b,
                                metric=metric)
        want = ref.ash_score_metric_ref(*args, qterm, rowterm, b=payload.b,
                                        metric=metric)
        codes, qp, scale, offset, cluster, ipq = args
        Amat = (qp.abs() @ V_abs.T) * scale.abs()[None, :]
        bias = ipq[:, cluster.long()]
        tol = score_tolerance(Amat, bias, offset, qterm, rowterm, want,
                              metric, d_pad)
        err = (got - want).abs()
        ratio = float((err / tol).max())
        check(ratio <= 1.0, f"{metric}: |kernel - plain| above bound "
                            f"(max ratio {ratio})")
        max_err["ash_score"] = max(max_err["ash_score"], float(err.max()))
        # fused kernel vs its plain version: scores within the bound,
        # ids equal wherever the score gap exceeds it
        ts, ti = TK.ash_score_topk_cuda(*args, qterm, rowterm, b=payload.b,
                                        k=K, metric=metric)
        ps, pi = ref.ash_score_topk_ref(*args, qterm, rowterm, None,
                                        b=payload.b, k=K, metric=metric)
        max_err["ash_score_topk"] = max(max_err["ash_score_topk"],
                                        float((ts - ps).abs().max()))
        row_tol = tol.max(dim=1, keepdim=True).values
        differ = ti != pi
        gap = (want.gather(1, ti.long()) - want.gather(1, pi.long())).abs()
        check(bool((gap[differ] <= 2 * row_tol.expand_as(gap)[differ])
                   .all()), f"{metric}: top-k ids differ beyond the bound")
        check(bool(((ts - ps).abs() <= row_tol).all()),
              f"{metric}: top-k scores beyond the bound")
        # fused == stable two-key sort of the materializing kernel
        rv = torch.rand(N, device=dev, generator=torch.Generator(
            device=dev).manual_seed(7)) > 0.1
        exact_eq = []
        for n_valid, row_valid in ((None, None), (None, rv),
                                   (N - 12345, None), (N - 12345, rv)):
            fs, fi = TK.ash_score_topk_cuda(*args, qterm, rowterm, n_valid,
                                            row_valid, b=payload.b, k=K,
                                            metric=metric)
            ms_, mi = ref.stable_top_k(
                ref.mask_rows_ref(got, n_valid, row_valid), K)
            exact_eq.append(bool(torch.equal(fs, ms_)
                                 and torch.equal(fi, mi.to(torch.int32))))
        check(all(exact_eq), f"{metric}: fused != sorted materialized "
                             f"{exact_eq}")
        compare[metric] = dict(max_abs_err=float(err.max()),
                               max_err_over_bound=ratio,
                               max_bound=float(tol.max()),
                               topk_id_mismatch=int(differ.sum()),
                               fused_equals_sorted=exact_eq)
        log("compare", metric=metric, **compare[metric])
    del V_abs, Amat, bias, tol, err, got, want
    results["compare"] = compare

    # -- 4b. gathered and coarse kernels against their plain versions ----
    pl = st.payload
    prep = ivf.prepare(q8)
    cand = IV.candidate_rows(st, IV._probe_lists(st, prep, NPROBE))
    live = cand >= 0
    safe = cand.clamp(min=0).long()
    V_abs = Q.unpack_codes(pl.codes, d_pad, pl.b).float().abs()
    args = ops._score_args(prep, pl)
    codes, qp, scale, offset, cluster, ipq = args
    Amat = (qp.abs() @ V_abs.T) * scale.abs()[None, :]
    bias = ipq[:, cluster.long()]
    del V_abs
    cprep = S.prepare_coarse_queries(prep, st.coarse.mean)
    cargs = ops._coarse_score_args(prep, cprep, pl)
    L = ops.DEFAULT_SHORTLIST
    rv = torch.rand(N, device=dev, generator=torch.Generator(
        device=dev).manual_seed(7)) > 0.1
    for name in ("ash_score_gather", "ash_score_gather_topk",
                 "ash_score_coarse", "ash_score_coarse_topk"):
        max_err[name] = 0.0
    compare_b = {}
    for metric in ("dot", "l2", "cos"):
        qterm, rowterm = ops._metric_operands(model, prep, pl, st.stats,
                                              metric)
        dense = TK.ash_score_cuda(*args, qterm, rowterm, b=pl.b,
                                  metric=metric)
        want_d = ref.ash_score_metric_ref(*args, qterm, rowterm, b=pl.b,
                                          metric=metric)
        tol = score_tolerance(Amat, bias, offset, qterm, rowterm, want_d,
                              metric, d_pad).gather(1, safe)
        del want_d
        # kernel 3: within the bound of its plain version, bit-equal to
        # kernel 1 on the same (query, row), -inf on pad ids
        g = TK.ash_score_gather_cuda(codes, cand, *args[1:], qterm, rowterm,
                                     b=pl.b, metric=metric)
        gp = ref.ash_score_gather_ref(codes, cand, *args[1:], qterm,
                                      rowterm, b=pl.b, metric=metric)
        err = (g - gp).abs()[live]
        ratio = float((err / tol[live]).max())
        check(ratio <= 1.0, f"{metric}: |gather - plain| above bound "
                            f"(max ratio {ratio})")
        check(bool(torch.isneginf(g[~live]).all()
                   and torch.isneginf(gp[~live]).all()),
              f"{metric}: pad ids not -inf")
        bit_dense = torch.equal(g[live], dense.gather(1, safe)[live])
        check(bit_dense, f"{metric}: gathered != dense scores")
        max_err["ash_score_gather"] = max(max_err["ash_score_gather"],
                                          float(err.max()))
        # kernel 4: a stable top-k over positions of kernel 3, mapped back
        ts, tr = TK.ash_score_gather_topk_cuda(
            codes, cand, *args[1:], qterm, rowterm, b=pl.b, k=K,
            metric=metric)
        vs, vp = ref.stable_top_k(g, K)
        exact4 = bool(torch.equal(ts, vs)
                      and torch.equal(tr, cand.gather(1, vp)))
        check(exact4, f"{metric}: fused gather != sorted gather")
        ps, _ = ref.ash_score_gather_topk_ref(
            codes, cand, *args[1:], qterm, rowterm, b=pl.b, k=K,
            metric=metric)
        fin = torch.isfinite(ps) & torch.isfinite(ts)
        max_err["ash_score_gather_topk"] = max(
            max_err["ash_score_gather_topk"],
            float((ts - ps).abs()[fin].max()))
        # kernel 5: bit-equal to its plain version
        c = TK.ash_score_coarse_cuda(*cargs, qterm, rowterm, b=pl.b,
                                     metric=metric)
        cp = ref.ash_score_coarse_ref(*cargs, qterm, rowterm, b=pl.b,
                                      metric=metric)
        exact5 = torch.equal(c, cp)
        check(exact5, f"{metric}: coarse kernel != plain")
        max_err["ash_score_coarse"] = max(max_err["ash_score_coarse"],
                                          float((c - cp).abs().max()))
        # kernel 6: a stable top-k of kernel 5 under the four masks
        exact6 = []
        for n_valid, row_valid in ((None, None), (None, rv),
                                   (N - 12345, None), (N - 12345, rv)):
            fs, fi = TK.ash_score_coarse_topk_cuda(
                *cargs, qterm, rowterm, n_valid, row_valid, b=pl.b, k=L,
                metric=metric)
            ms_, mi = ref.stable_top_k(
                ref.mask_rows_ref(c, n_valid, row_valid), L)
            exact6.append(bool(torch.equal(fs, ms_)
                               and torch.equal(fi, mi.to(torch.int32))))
        check(all(exact6), f"{metric}: fused coarse != sorted {exact6}")
        ps6, _ = ref.ash_score_coarse_topk_ref(
            *cargs, qterm, rowterm, None, b=pl.b, k=L, metric=metric)
        fs, _ = TK.ash_score_coarse_topk_cuda(*cargs, qterm, rowterm,
                                              b=pl.b, k=L, metric=metric)
        max_err["ash_score_coarse_topk"] = max(
            max_err["ash_score_coarse_topk"], float((fs - ps6).abs().max()))
        compare_b[metric] = dict(
            gather_max_abs_err=float(err.max()),
            gather_max_err_over_bound=ratio,
            gather_bit_equal_dense=bit_dense,
            gather_fused_equals_sorted=exact4,
            coarse_bit_equal_plain=exact5,
            coarse_fused_equals_sorted=exact6,
            live_pairs=int(live.sum()), R=int(cand.shape[1]))
        log("compare_gather_coarse", metric=metric, **compare_b[metric])
    del Amat, bias, tol, dense, g, gp, c, cp
    results["compare_gather_coarse"] = compare_b

    # -- 5. request stream through AshIndex.search -----------------------
    torch.cuda.synchronize()
    TK.reset_launch_counts()
    lat_fused, lat_rerank, ids_fused, ids_rerank = [], [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    for r in range(N_REQ + N_RERANK_REQ):
        q = queries[r * REQ_M:(r + 1) * REQ_M]
        start.record()
        if r < N_REQ:
            _, ids = index.search(q, k=K)
        else:
            _, ids = index.search(q, k=10, rerank=RERANK)
        end.record()
        end.synchronize()
        (lat_fused if r < N_REQ else lat_rerank).append(
            start.elapsed_time(end))
        (ids_fused if r < N_REQ else ids_rerank).append(ids)
    wall = time.perf_counter() - t0
    launches = dict(TK.launch_counts)
    check(launches["ash_score_topk"] >= N_REQ,
          f"fused kernel launches {launches}")
    check(launches["ash_score"] >= N_RERANK_REQ,
          f"materializing kernel launches {launches}")

    results["serve"] = dict(
        requests=N_REQ + N_RERANK_REQ, queries_per_request=REQ_M,
        qps=(N_REQ + N_RERANK_REQ) * REQ_M / wall,
        fused_k100=dict(p50_ms=pct(lat_fused, 50), p99_ms=pct(lat_fused, 99),
                        mean_ms=sum(lat_fused) / len(lat_fused)),
        rerank256_k10=dict(p50_ms=pct(lat_rerank, 50),
                           p99_ms=pct(lat_rerank, 99),
                           mean_ms=sum(lat_rerank) / len(lat_rerank)),
        launches=launches,
    )
    log("serve", **results["serve"])

    # -- 5b. request streams on the gathered and coarse routes ----------
    routes = (
        ("ivf_k100", ivf, dict(k=K, nprobe=NPROBE),
         ("ash_score_gather_topk",)),
        ("ivf_k10_rerank256", ivf, dict(k=10, nprobe=NPROBE, rerank=RERANK),
         ("ash_score_gather",)),
        ("flat_coarse_k10", index, dict(k=10, coarse="int8"),
         ("ash_score_coarse_topk", "ash_score_gather_topk")),
        ("flat_coarse_k10_rerank256", index,
         dict(k=10, coarse="int8", rerank=RERANK),
         ("ash_score_coarse", "ash_score_gather")),
        ("ivf_coarse_k10", ivf, dict(k=10, nprobe=NPROBE, coarse="int8"),
         ("ash_score_gather_topk",)),
    )
    torch.cuda.synchronize()
    TK.reset_launch_counts()
    stream, route_ids = {}, {}
    for name, idx, kw, kernels in routes:
        before = dict(TK.launch_counts)
        lat, ids_r = [], []
        t0 = time.perf_counter()
        for r in range(N_ROUTE_REQ):
            start.record()
            _, ids = idx.search(queries[r * REQ_M:(r + 1) * REQ_M], **kw)
            end.record()
            end.synchronize()
            lat.append(start.elapsed_time(end))
            ids_r.append(ids)
        wall = time.perf_counter() - t0
        delta = {k: TK.launch_counts[k] - before[k] for k in kernels}
        check(all(v >= N_ROUTE_REQ for v in delta.values()),
              f"{name}: launches {delta} over {N_ROUTE_REQ} requests")
        route_ids[name] = torch.cat(ids_r)
        stream[name] = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99),
                            mean_ms=sum(lat) / len(lat),
                            qps=N_ROUTE_REQ * REQ_M / wall,
                            launches=delta)
        log("serve_route", route=name, **stream[name])
    launches_b = dict(TK.launch_counts)
    # a query searched alone equals its row of the batch search
    single = {}
    for name, idx, kw, _ in routes:
        prep = idx.prepare(q8)
        sb, ib = idx.search_prepped(prep, **kw)
        one = dataclasses.replace(prep, **{
            f.name: getattr(prep, f.name)[3:4]
            for f in dataclasses.fields(prep)})
        s1, i1 = idx.search_prepped(one, **kw)
        single[name] = bool(torch.equal(s1, sb[3:4])
                            and torch.equal(i1, ib[3:4]))
    check(all(single.values()), f"single row != batch row: {single}")
    results["serve_routes"] = dict(routes=stream, launches=launches_b,
                                   single_row_equals_batch_row=single)
    log("single_row", **single)

    # -- 6. recall, kernel route vs plain route -------------------------
    ids_fused = torch.cat(ids_fused)
    ids_rerank = torch.cat(ids_rerank)
    qf = queries[:N_REQ * REQ_M]
    qr = queries[N_REQ * REQ_M:]
    gt = torch.cat([exact_topk(qf[i:i + 125], X, k=10)[1]
                    for i in range(0, qf.shape[0], 125)])
    gt_r = exact_topk(qr, X, k=10)[1]
    plain = torch.cat([index.search(qf[i:i + 125], k=K, use_kernel=False)[1]
                       for i in range(0, qf.shape[0], 125)])
    plain_r = index.search(qr, k=10, rerank=RERANK, use_kernel=False)[1]
    rec = dict(
        kernel=recall_curve(ids_fused, gt, Rs=(10, 100)),
        plain=recall_curve(plain, gt, Rs=(10, 100)),
        kernel_rerank256=recall_curve(ids_rerank, gt_r, Rs=(10,)),
        plain_rerank256=recall_curve(plain_r, gt_r, Rs=(10,)),
    )
    for R in (10, 100):
        check(abs(rec["kernel"][R] - rec["plain"][R]) <= 0.005,
              f"recall@{R} kernel vs plain route: {rec}")
    check(abs(rec["kernel_rerank256"][10] - rec["plain_rerank256"][10])
          <= 0.005, f"rerank recall: {rec}")
    results["recall"] = rec
    log("recall", **{k: {str(r): v for r, v in c.items()}
                     for k, c in rec.items()})

    # -- 6b. recall of the new routes, kernel vs plain -------------------
    gt_b = gt[:N_ROUTE_REQ * REQ_M]
    rec_b = {}
    for name, idx, kw, _ in routes:
        plain_r = torch.cat([
            idx.search(queries[r * REQ_M:(r + 1) * REQ_M], use_kernel=False,
                       **kw)[1] for r in range(N_ROUTE_REQ)])
        kr = recall_curve(route_ids[name], gt_b, Rs=(10, 100))
        pr = recall_curve(plain_r, gt_b, Rs=(10, 100))
        for R in kr:
            check(abs(kr[R] - pr[R]) <= 0.005,
                  f"{name}: recall@{R} kernel {kr[R]} vs plain {pr[R]}")
        rec_b[name] = dict(kernel={str(r): v for r, v in kr.items()},
                           plain={str(r): v for r, v in pr.items()})
    results["recall_routes"] = rec_b
    log("recall_routes", **rec_b)

    # -- 7. kernel times at the request shape (m=8, dot) -----------------
    prep = index.prepare(q8)
    args = ops._score_args(prep, payload)
    n, wd = payload.codes.shape
    C = args[5].shape[1]
    V32 = Q.unpack_codes(payload.codes, d_pad, payload.b).float()
    qp = args[1]
    flops = 2 * REQ_M * n * d_pad + 3 * REQ_M * n
    in_bytes = (n * wd * 4 + REQ_M * d_pad * 4 + 3 * n * 4 + REQ_M * C * 4)
    n_blocks, k_tilde, _ = ref.topk_geometry(n, K)
    strip_vals = torch.randn(REQ_M, n_blocks * k_tilde, device=dev)
    strip_ids = torch.randperm(n, device=dev)[:n_blocks * k_tilde].to(
        torch.int32).expand(REQ_M, -1).contiguous()
    merge_ms = event_ms(lambda: ref.merge_strip(strip_vals, strip_ids, K))
    rows = []
    for name, fn, plain_fn, lib_fn, lib_call, out_bytes, line in (
        ("ash_score",
         lambda: TK.ash_score_cuda(*args, b=payload.b),
         lambda: ref.ash_score_metric_ref(*args, None, None, b=payload.b),
         lambda: torch.matmul(qp, V32.T),
         "torch.matmul on pre-dequantized fp32 codes",
         REQ_M * n * 4, 368),
        ("ash_score_topk",
         lambda: TK.ash_score_topk_cuda(*args, b=payload.b, k=K),
         lambda: ref.ash_score_topk_ref(*args, None, None, None,
                                        b=payload.b, k=K),
         lambda: torch.topk(torch.matmul(qp, V32.T), K, dim=1),
         "torch.topk(torch.matmul) on pre-dequantized fp32 codes",
         REQ_M * K * 8, 428),
    ):
        bound_ms, bound_by = bound(flops / PEAK_FP32_FLOPS * 1e3,
                                   in_bytes + out_bytes)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/ash_score.cu",
            replaces=f"src/repro/kernels/ash_score.py:{line}",
            launches=launches[name],
            max_abs_err=max_err[name],
            ms=event_ms(fn), plain_ms=event_ms(plain_fn, iters=10),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=event_ms(lib_fn), library_call=lib_call,
        ))
    # gathered kernels at the IVF request shape: the 8 queries' nprobe=8
    # candidate table; codes and headers of each distinct live row are
    # counted once, the row table and the output once per slot
    gprep = ivf.prepare(q8)
    gargs = ops._score_args(gprep, pl)
    grows = IV.candidate_rows(st, IV._probe_lists(st, gprep, NPROBE))
    R = grows.shape[1]
    pairs = int((grows >= 0).sum())
    uniq = int(torch.unique(grows[grows >= 0]).numel())
    g_in = (REQ_M * R * 4 + uniq * (wd * 4 + 12) + REQ_M * d_pad * 4
            + REQ_M * C * 4)
    g_ops_ms = (2 * d_pad + 3) * pairs / PEAK_FP32_FLOPS * 1e3
    V32s = Q.unpack_codes(pl.codes, d_pad, pl.b).float()
    Vg = V32s[grows.clamp(min=0).long()]  # pre-gathered, for the yardstick
    del V32s
    gq = gargs[1][:, :, None]
    # coarse kernels at the flat request shape (the coarse routes' scan)
    cprep = S.prepare_coarse_queries(prep, index._state.coarse.mean)
    cargs = ops._coarse_score_args(prep, cprep, payload)
    c_in = n * (wd * 4 + 12) + REQ_M * d_pad + REQ_M * 8 + REQ_M * C * 4
    c_ops_ms = (2 * REQ_M * n * d_pad / PEAK_INT8_OPS
                + 5 * REQ_M * n / PEAK_FP32_FLOPS) * 1e3
    # torch._int_mm takes at least 17 rows: queries zero-padded to 32
    qi32 = torch.nn.functional.pad(cargs[1], (0, 0, 0, 32 - REQ_M))
    V8 = Q.unpack_codes(payload.codes, d_pad, payload.b).to(torch.int8)
    for name, fn, plain_fn, lib_fn, lib_call, ops_ms, bytes_, line in (
        ("ash_score_gather",
         lambda: TK.ash_score_gather_cuda(gargs[0], grows, *gargs[1:],
                                          b=pl.b),
         lambda: ref.ash_score_gather_ref(gargs[0], grows, *gargs[1:], None,
                                          None, b=pl.b),
         lambda: torch.bmm(Vg, gq),
         "torch.bmm over pre-gathered fp32 candidate rows",
         g_ops_ms, g_in + REQ_M * R * 4, 777),
        ("ash_score_gather_topk",
         lambda: TK.ash_score_gather_topk_cuda(gargs[0], grows, *gargs[1:],
                                               b=pl.b, k=K),
         lambda: ref.ash_score_gather_topk_ref(gargs[0], grows, *gargs[1:],
                                               None, None, b=pl.b, k=K),
         lambda: torch.topk(torch.bmm(Vg, gq)[:, :, 0], K, dim=1),
         "torch.topk(torch.bmm) over pre-gathered fp32 candidate rows",
         g_ops_ms, g_in + REQ_M * K * 8, 843),
        ("ash_score_coarse",
         lambda: TK.ash_score_coarse_cuda(*cargs, b=payload.b),
         lambda: ref.ash_score_coarse_ref(*cargs, None, None, b=payload.b),
         lambda: torch._int_mm(qi32, V8.T),
         "torch._int_mm on pre-dequantized int8 codes",
         c_ops_ms, c_in + REQ_M * n * 4, 1103),
        ("ash_score_coarse_topk",
         lambda: TK.ash_score_coarse_topk_cuda(*cargs, b=payload.b, k=L),
         lambda: ref.ash_score_coarse_topk_ref(*cargs, None, None, None,
                                               b=payload.b, k=L),
         lambda: torch.topk(torch._int_mm(qi32, V8.T)[:REQ_M], L, dim=1),
         "torch.topk(torch._int_mm) on pre-dequantized int8 codes",
         c_ops_ms, c_in + REQ_M * L * 8, 1163),
    ):
        bound_ms, bound_by = bound(ops_ms, bytes_)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" + (
                "ash_gather.cu" if "gather" in name else "ash_coarse.cu"),
            replaces=f"src/repro/kernels/ash_score.py:{line}",
            launches=launches_b[name],
            max_abs_err=max_err[name],
            ms=event_ms(fn), plain_ms=event_ms(plain_fn, iters=10),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=event_ms(lib_fn), library_call=lib_call,
        ))
    results["kernels"] = rows
    results["gather_shape"] = dict(R=R, live_pairs=pairs,
                                   distinct_live_rows=uniq)
    results["fused_strip"] = dict(candidates_per_query=n_blocks * k_tilde,
                                  merge_ms=merge_ms)
    log("fused_strip", **results["fused_strip"])
    log("gather_shape", **results["gather_shape"])
    del V32, Vg, V8

    # -- 7b. where a request's time goes (torch.profiler) ---------------
    results["profile_fused_request"] = profile_requests(
        lambda q: index.search(q, k=K), queries)
    log("profile", **results["profile_fused_request"])
    results["profile_ivf_request"] = profile_requests(
        lambda q: ivf.search(q, k=K, nprobe=NPROBE), queries)
    log("profile_ivf", **results["profile_ivf_request"])

    # -- 8. save, load, search again -------------------------------------
    save_dir = ROOT / "build" / "chip_smoke" / "idx"
    shutil.rmtree(save_dir.parent, ignore_errors=True)
    try:
        _, t_save = sync_time(index.save, save_dir)
        loaded, t_load = sync_time(AshIndex.load, save_dir, device=dev)
        same = []
        for kw in (dict(k=K), dict(k=10, rerank=RERANK),
                   dict(k=10, coarse="int8")):
            s1, i1 = index.search(q8, **kw)
            s2, i2 = loaded.search(q8, **kw)
            same.append(bool(torch.equal(s1, s2) and torch.equal(i1, i2)))
        check(all(same), f"save/load changed search results {same}")
        del loaded
        ivf_dir = save_dir.parent / "ivf"
        _, t_save_ivf = sync_time(ivf.save, ivf_dir)
        loaded, t_load_ivf = sync_time(AshIndex.load, ivf_dir, device=dev)
        same_ivf = []
        for kw in (dict(k=K), dict(k=10, rerank=RERANK),
                   dict(k=10, coarse="int8"), dict(k=10, nprobe=64)):
            s1, i1 = ivf.search(q8, **kw)
            s2, i2 = loaded.search(q8, **kw)
            same_ivf.append(bool(torch.equal(s1, s2)
                                 and torch.equal(i1, i2)))
        check(loaded.backend == "ivf" and all(same_ivf),
              f"IVF save/load changed search results {same_ivf}")
    finally:
        shutil.rmtree(save_dir.parent, ignore_errors=True)
    results["save_load"] = dict(save_s=t_save, load_s=t_load,
                                bit_identical=same, ivf_save_s=t_save_ivf,
                                ivf_load_s=t_load_ivf,
                                ivf_bit_identical=same_ivf)
    log("save_load", **results["save_load"])

    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 was enabled")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
