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
     nvcc (into ``build/repro_torch/``);
  3. train and encode on the card (``AshIndex.build``);
  4. each kernel against its plain PyTorch version on the same inputs
     (8 queries, the full index, metrics dot/l2/cos), and the fused
     kernel EXACTLY equal to a stable top-k of the materializing
     kernel's scores, with no mask, a tombstone mask and ``n_valid``;
  5. a request stream through ``AshIndex.search``: 125 requests of 8
     queries at k=100 (fused route) and 16 at k=10, rerank=256
     (materializing kernel + exact rerank); launch counts are zeroed
     just before and read just after;
  6. 10-recall@10/@100 against exact search, kernel route and plain
     route on the card;
  7. per-kernel times, bounds and library yardsticks (a ``kernels``
     JSON line), the fused strip merge alone, and a ``torch.profiler``
     breakdown of fused requests (device time by kernel, idle share);
  8. save, load, search again: results bit-identical.

Any failed check raises; the script exits 0 only when every phase
passed.  The last line is ``{"ok": true, "device": {...}}``.  Detailed
results go to ``chiprun_out/chip_smoke.json``.
"""
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
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ash as A
    from repro_torch.core import quantization as Q
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex, exact_topk, recall_curve
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
    TK._kernels()
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

    def pct(v, p):
        v = sorted(v)
        return v[min(len(v) - 1, int(round(p / 100 * (len(v) - 1))))]

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
    for name, fn, plain_fn, lib_fn, out_bytes, line in (
        ("ash_score",
         lambda: TK.ash_score_cuda(*args, b=payload.b),
         lambda: ref.ash_score_metric_ref(*args, None, None, b=payload.b),
         lambda: torch.matmul(qp, V32.T),
         REQ_M * n * 4, 368),
        ("ash_score_topk",
         lambda: TK.ash_score_topk_cuda(*args, b=payload.b, k=K),
         lambda: ref.ash_score_topk_ref(*args, None, None, None,
                                        b=payload.b, k=K),
         lambda: torch.topk(torch.matmul(qp, V32.T), K, dim=1),
         REQ_M * K * 8, 428),
    ):
        t_flops = flops / PEAK_FP32_FLOPS * 1e3
        t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/ash_score.cu",
            replaces=f"src/repro/kernels/ash_score.py:{line}",
            launches=launches[name],
            max_abs_err=max_err[name],
            ms=event_ms(fn), plain_ms=event_ms(plain_fn, iters=10),
            bound_ms=max(t_flops, t_bytes),
            bound_by="operations" if t_flops >= t_bytes else "bytes",
            library_ms=event_ms(lib_fn),
        ))
    results["kernels"] = rows
    results["fused_strip"] = dict(candidates_per_query=n_blocks * k_tilde,
                                  merge_ms=merge_ms)
    log("fused_strip", **results["fused_strip"])
    del V32

    # -- 7b. where a fused request's time goes (torch.profiler) ---------
    from torch.profiler import ProfilerActivity, profile

    n_prof = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(n_prof):
            index.search(queries[r * REQ_M:(r + 1) * REQ_M], k=K)
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
    results["profile_fused_request"] = dict(
        requests=n_prof, wall_ms_per_request=wall_ms / n_prof,
        device_busy_ms_per_request=busy_ms / n_prof,
        # None when the profiler saw no device activity (not measured)
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_device_us_per_request={k: v / n_prof for k, v in top},
    )
    log("profile", **results["profile_fused_request"])

    # -- 8. save, load, search again -------------------------------------
    save_dir = ROOT / "build" / "chip_smoke" / "idx"
    shutil.rmtree(save_dir.parent, ignore_errors=True)
    try:
        _, t_save = sync_time(index.save, save_dir)
        loaded, t_load = sync_time(AshIndex.load, save_dir, device=dev)
        same = []
        for kw in (dict(k=K), dict(k=10, rerank=RERANK)):
            s1, i1 = index.search(q8, **kw)
            s2, i2 = loaded.search(q8, **kw)
            same.append(bool(torch.equal(s1, s2) and torch.equal(i1, i2)))
        check(all(same), f"save/load changed search results {same}")
    finally:
        shutil.rmtree(save_dir.parent, ignore_errors=True)
    results["save_load"] = dict(save_s=t_save, load_s=t_load,
                                bit_identical=same)
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
