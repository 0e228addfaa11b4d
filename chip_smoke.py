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
     ``build/repro_torch/``), and report ``-Xptxas -v`` registers and
     spills of kernels 7, 4, 1, 3, 5 and 6;
  3. train and encode on the card (``AshIndex.build``), train a second
     time from the same seed (the models must be bit-identical), encode
     one vector twice alone and once as a row of a 64-row batch (all
     three bit-identical; each of the 64 rows alone EQUAL to its batch
     row), and the IVF index over the same model and
     payload (``AshIndex.from_parts``, nlist = 64);
  4. the dense kernels against their plain PyTorch versions on the same
     inputs (8 queries, the full index, metrics dot/l2/cos), and the
     fused kernel (scan + strip merge) EXACTLY equal to a stable top-k
     of the materializing kernel's scores, with no mask, a tombstone
     mask and ``n_valid``, on rows reordered so that every query's
     scores ascend (every key passes the selection's threshold), and
     for k~ < k equal to the per-tile selection ``ref.tile_topk_ref``;
  4b. the gathered and coarse kernels at the phase shape (8 queries;
     their IVF candidate table at nprobe = 8 for the gathered ones):
     gathered scores within the bound of their plain version and
     bit-equal to the dense kernel's, the fused gathered selection
     (scan + merge, one launch each) EXACTLY a stable top-k over
     positions of them mapped through the table, also on positions
     ordered so that the scores ascend, for R below a tile and ragged,
     with a query of pads only, and for k~ < k the per-tile selection,
     and its merge with the table EQUAL to ``ref.positions_to_rows`` of
     the merge without; the coarse scan bit-equal to its plain version,
     the fused coarse selection EXACTLY a stable top-k of it under the
     four masks and on ascending rows, and the per-tile selection for
     k~ < k;
  5. a request stream through ``AshIndex.search``: 125 requests of 8
     queries at k=100 (fused route) and 16 at k=10, rerank=256
     (materializing kernel + exact rerank); launch counts are zeroed
     just before and read just after: exactly one scan launch of kernel
     2 and one merge launch, counted under kernel 2, per fused request;
  5b. a stream of 32 requests of 8 queries on each new route: IVF k=100
     (fused gathered), IVF k=10 rerank=256 (materializing gathered),
     flat coarse k=10 (fused coarse -> fused gathered), flat coarse k=10
     rerank=256 (materializing coarse -> materializing gathered), IVF
     coarse k=10 (plain gathered coarse -> fused gathered); counts are
     zeroed before it and each route's kernels must have launched at
     least once per request, kernels 6 and 4 exactly once, and the
     merge exactly once per fused scan, counted under that scan's name
     (``ash_score.merge_launches``: the rows' ``merge_launches``); a
     single query searched alone
     equals its row of the batch on every route;
  6. 10-recall@10/@100 against exact search, kernel route and plain
     route on the card; 6b the same for each new route;
  7. per-kernel times, bounds and library yardsticks of kernels 1-6
     (a ``kernels`` JSON line; kernels 2, 4 and 6 with their merge), the
     scan alone and the merge kernel alone on the strip the scan emits
     (and the merge EQUAL to its plain version there), a ``scans`` line
     with the four asymmetric scans alone (kernels 1, 3 and the scans of
     2, 4, which share their scoring routine), and a
     ``torch.profiler`` breakdown of flat k=100, IVF and flat coarse
     requests (device time by kernel, idle share);
  8. save, load, search again, flat and IVF: results bit-identical;
  9. LM build: llama3.2-3B (``repro_torch.configs.llama32_3b``, 28
     layers at full width, bf16 weights drawn from a seeded generator
     on the card) with the ``decode_32k_ashkv`` cell's ASH-KV cache
     (b = 4, d_code = 128, max_len 32768) at batch 32, cut from the
     cell's 128, whose 124 GB cache does not fit the card's 80 GB;
  10. kernel 7 (``csrc/ash_kv_attn.cu``) against its plain version at
     one layer of the decode shape (256 streams, G = 3, S = 32768) and
     at 35 edge shapes (every (b_k, b_v), ragged S, leading masked
     stretches, bias, G in {1, 3, 8}, bf16 and fp32 scales, rows not a
     multiple of 16 bytes), with its
     time, bound, bound share and the SDPA yardstick;
  11. a decode stream: 32704 positions of every layer's cache filled by
     encoding seeded random K/V (``_encode_kv``), then 64 greedy
     ``decode_step``s at batch 32 (counts zeroed just before; exactly
     28 kernel-7 launches a step), p50/p99 and tokens/s; 11b a profile
     of one decode step;
  12. fidelity at batch 4 over 256 teacher-forced tokens: every
     kernel-7 call of the ASH-KV kernel route against its plain version
     on the same operands; the kernel route's logits against the plain
     route run from the kernel route's cache before each step, held to
     the noise floor of an fp32-sized jitter of the attention output;
     the plain route run free (reported); the ASH-KV cache against the
     bf16 cache (reported); ``prefill`` against the bf16-cache decode's
     last step;
  13. the serving engine (``repro_torch.serving``) over phase 3's flat
     and IVF indexes (run before phases 9-12): 13a fresh prepares and
     searches of rows alone and in 8 rows EQUAL to the same rows among
     128, on every route of phases 5 and 5b and flat k=10 (and 32 rows
     for the prep), and kernels 1-6 on fresh 32- and 128-row preps
     against their plain versions as in phases 4 and 4b (the flat scan,
     the coarse shortlists of 32 and 256 rows, the IVF candidates);
     13b a ``ServingFrontend`` over one ``QueryEngine``
     (buckets 8/32/128, k buckets 10/100, row budget 500,000) serving
     32 client threads of 40 requests of 1-8 rows over nine routes
     (13a's routes and IVF k=10, so that each of kernels 1-6 is
     launched through the engine):
     every ticket EQUAL to a direct ``AshIndex.search`` of its rows, no
     failed ticket, a healthy frontend, fewer fused calls than
     requests, and each route's scan launches equal to its fused
     engine calls, one merge each under its scan's name (the kernels
     line's launches add this stream's); 13c a flush at pressure 1.0
     with ``nprobe_min=2`` EQUAL to direct search at nprobe 2; 13d 8
     threads of searches, adds and deletes over a fresh flat index with
     a ``BackgroundCompactor`` (at least one swap mid-stream): no ticket
     lost or resolved twice, every search EQUAL to a serial replay of
     the submission log on a twin index, and after compaction EQUAL to
     ``from_parts`` over the survivors; 13e closed loops of 1, 8 and 32
     client threads of 1-query k=10 requests, engine against direct
     search from the same threads (QPS, p50/p99 over at least 1,000
     timed requests after a warm-up, kernel launches per query, bucket
     fill, prep-cache hits), a ``torch.profiler`` window over 20 engine
     flushes at bucket 32 against as many direct requests (device busy
     and operations a query, idle share), and the host ms of each
     engine step in those flushes (a ``serving`` JSON line);
  14. phase 3's payload as ``backend="sharded"`` (run after phase 13),
     4 and 3 logical shards on the card (3 leave 2 pad rows): flat k=10
     and k=100 (fused) and ``use_kernel=False``, dot and l2, each EQUAL
     to the flat backend, rerank 256 (reranked inside each shard, as the
     reference) EQUAL to a merge of flat rerank searches of each shard's
     rows alone with an exact score at every rank at least flat's, and
     a query alone EQUAL to its batch row; coarse k=10 (and with rerank
     256) EQUAL to flat coarse searches of each shard's rows alone,
     merged; 1 % deleted, 1,000 rows added, compacted: EQUAL to a flat
     twin after each step (rerank: to the twin's per-shard merge);
     exactly 4 kernel-2 scans, 4 merges under kernel 2 and 5 merge
     launches in all (the global one) per fused 4-shard request, read
     from ``ash_score.launch_counts`` and ``merge_launches``; a
     ``QueryEngine`` over it, every ticket EQUAL to direct search;
     save/load bit-identical; p50/p99 at k=100 against flat, and a
     profile (device time, idle share); with more than one card
     visible, one shard per card with the same gates and the gather's
     time (skipped, with a printed line, on one card);
  15. phase 3's IVF index as ``backend="tiered_ivf"`` at hot sets of
     0 bytes (every probe pages), 64 MiB (the default) and one that
     covers every list: IVF k=100, k=10 rerank 256, coarse k=10 and
     nprobe 64 (the dense full scan), each EQUAL to ``backend="ivf"``,
     exactly one host-to-device transfer for each search that missed
     the hot set and none for one that hit, none at all at the
     covering budget once warm, tombstones EQUAL; a ``QueryEngine``
     over it (tickets EQUAL to direct search, a ``tier`` gauge, cold
     lists billed at ``page_row_cost``); paged bytes a request, p50
     against HBM IVF at each budget, and the batched copy's GB/s
     against a plain pinned copy of the same bytes;
  16. durability (``repro_torch.serving.wal``, run after phase 15) over
     fresh copies of phase 3's model and payload: 16a the reference's
     crash matrix (every registered fault point at its first hit, the
     WAL and engine points also at their third, two torn appends) for
     flat and IVF at the first 10^5 rows, an undriven engine,
     ``fsync="always"`` and a checkpoint mid-traffic, each recovered
     with ``DurableIndex.open`` onto the card: every acknowledged seqno
     inside the durable prefix, searches (kernels 2, 1, 6 -> 4, 5 -> 3
     flat; 4 and 3 IVF) EQUAL to the durable prefix applied one
     mutation at a time on the card; 16b the full 10^6-row flat and IVF
     indexes under a log with a ``ServingFrontend``, a
     ``BackgroundCompactor`` (auto_compact 0.0003) and 8 client threads
     mixing 8-query searches with 8-row adds and deletes (about 200
     mutations; at least one compactor checkpoint), then a crash at
     ``engine.apply.logged`` and recovery, EQUAL to the serial replay of
     every logged mutation in seqno order; the same cycle with fewer
     mutations for 4 logical shards on the card and ``tiered_ivf`` at
     64 MiB; checkpoint seconds and GB/s, ``open``'s load and replay
     seconds, records replayed a second (a tail of 20 mutations after the
     traffic is replayed at least), append p50/p99 under each fsync
     policy, engine QPS at C = 32 with and without a log (interval);
  17. the launcher, ``python -m repro_torch.launch.serve``, as child
     processes: 17a a WAL run (IVF, n = 10^6, 10 % mutations,
     ``fsync="always"``) printing its ``[wal]``, ``[serve]``,
     ``[latency]``, ``[mutations]`` and ``[checkpoint]`` lines; 17b the
     same over the same directory, whose ``[recovery]`` replays nothing
     past 17a's final checkpoint; 17c flat at n = 10^6 with
     ``--save-dir``, its printed recall equal to direct searches of the
     saved index; 17d ``--http`` on a free loopback port, ``POST
     /search`` ids EQUAL to a direct search, ``GET /stats``, and SIGINT
     ending it with exit 0 and its report; 17e ``--concurrent 32
     --auto-compact 0.2 --mutate-fraction 0.1``, ``--engine sharded`` and
     ``--tiered --hot-bytes 67108864`` at the CLI's default n = 10^5;
  18. the paper's baselines (``repro_torch.baselines``, run after phase
     17) at about 256 code bits a vector on phase 3's rows, trained on
     the card: ASH itself (phase 3's index, 294 bits), PQ (M = 32 x 8
     bits), OPQ (2 iterations), LOPQ (C = 4, 2 local iterations; OPQ and
     LOPQ trained on the first 10^5 rows, a printed cut, every row
     encoded), EDEN and TurboQuant (b = 1), LeanVec (d = 64, b = 4) and
     RaBitQ (b = 1, d = 256): bits, train and encode seconds, the ms of
     an 8-query score + top-10 and 10-recall@10 over phase 6's 1,000
     queries and exact top-10 (a ``baselines`` JSON line; the paper's
     ordering reported, not gated); gates: PQ's ADC equal to <q,
     decode(codes)> on 1,000 rows to 1e-3, EDEN's decode keeping each
     row's norm to 1e-3, and RaBitQ through ``AshIndex.from_parts`` on
     the card at b = 1, d = 256, C = 1 (kernel 1 within phase 4's bound
     of its plain version, the fused k = 100 search within it of its
     plain route, recall of fused k = 10 and of rerank 256 within 0.005
     of the plain route);
  19. granite-moe-3b (``repro_torch.configs.granite_moe_3b``, 32 layers,
     d_model 1536, 40 experts top-8, d_head 64, bf16 seeded weights) in
     the ``decode_32k_ashkv`` cell at batch 128 (cut to 64, printed with
     the peak memory, only if it does not fit; run right after phase 2,
     while the card's memory is empty): 19a kernel 7 at one layer (1,024
     streams, G = 3, S = 32768, d = 64) against its plain version, with
     time, bound and the SDPA yardstick; 19b 64 greedy ``decode_step``s
     over 32704 positions (exactly 32 kernel-7 launches a step), p50/p99,
     tokens/s, a profiled step and every layer's MoE block profiled
     alone; 19c phase 12's fidelity at batch 4, cut to 128 tokens and
     without the free-running plain route (a step costs ~165 ms of host
     time), with the share of (token, layer) top-8 routings the kernel
     route changes (prefill reported, not gated: capacity drops follow
     the batch);
  20. LM training (``repro_torch.train``, run right after phase 19 on
     the memory it frees; no kernel of the ``kernels`` line runs here:
     training's products are cuBLAS and its attention the plain fp32
     einsums, as the reference's jnp): 20a llama3.2-3B at all 28 layers
     and full widths, bf16, remat, in the ``train_4k`` cell's seq 4096
     with its TrainConfig (AdamW, fp32 moments, 2 microbatches) at a
     global batch of 2 (the cell's 256, cut: one sequence a
     microbatch), 8 steps on the TokenStream (the first is warm-up),
     then 3 under deterministic algorithms (their cost), and a profiled
     step (bf16 cuBLAS, the fp32 attention's cuBLAS, the optimizer's
     range, the rest, the idle share); step p50/p99 (CUDA events),
     tokens/s, the model-FLOP share at 989 TFLOP/s (H100 SXM dense bf16)
     and the peak memory; gates: every loss and grad norm finite, step
     1's loss (less its microbatches' router aux for an MoE model)
     within 1.0 of ln V + 1/2, the step count, every leaf's
     first moment non-zero and every leaf changed but bf16 norm scales
     (the warmup's updates are below half their ulp); 20b granite-moe-3b
     at all 32 layers, 4 steps at a global batch of 4 in its 4
     microbatches, 20a's gates plus a finite, positive router aux loss; 20c the
     reduced llama and granite (fp32) on the card against the CPU, 3
     steps each of AdamW, Adafactor (b1 = 0.9; b1 = 0 with bf16
     moments), Muon and AdamW with 2-bit compression (the same signs):
     losses to 1e-4 relative, parameters within twice the summed
     learning rates and to 1e-6 but for at most 1 % of the elements
     (AdamW's m/sqrt(v) where the clipped |g| is near eps; not with
     compression, where a code flipping at a midpoint moves its block),
     and the round trip at 1, 2, 4 bits on 10^6 elements (codes EQUAL
     off midpoints, outputs to 1e-5 of the largest); 20d restart: in process
     under deterministic algorithms, save at step 3, three more steps,
     restore and replay (losses EQUAL as fp32 bits), then
     ``python -m repro_torch.launch.train --reduced`` on the card as a
     child process: ``--die-at-step 5`` exits 42; the rerun, through the
     same ``main`` in this process, resumes from step 4 (``[restore]
     resumed from step 4``, step 5's line equal to the first run's) and
     returns 0;
  21. the recommender and interatomic families (run right after phase
     20, on the memory it frees; the cells' numbers read from the
     port's ``configs.base``):
     21a SASRec at full width (1,048,576 items, e = 50, 2 blocks, seq
     50, 128 negatives), 4 AdamW steps at 65,536 sequences of the
     ``SequenceStream`` (step p50/p99 by CUDA events, sequences/s, peak
     memory), the ``retrieval_cand_ash`` index over the trained item
     table (b = 4, d = 25, so d_pad = 32; 16 learned landmarks, dot;
     build seconds), kernels 1 and 2 at that shape against their plain
     versions under phase 4's rule (and their pad lanes 0), kernel 2's
     time, bound and yardstick there, then 30 requests of 512 user
     sequences each at k = 10 and k = 100 through ``sasrec_retrieve``
     (launch counts zeroed just before and read just after: one merge
     per kernel-2 scan), p50/p99, tickets EQUAL to a direct
     ``AshIndex.search`` of the same user states, and 10-recall@10
     against the exact top-10 over every item, kernel route within
     0.005 of the plain route; 21b DCN-v2, FM and AutoInt at full width
     (26 or 39 fields of 1,048,576 rows), 4 AdamW steps each at 65,536
     rows of the ``ClickStream`` (dense grads of the whole table; step
     p50, examples/s, peak memory), 50 forwards at 512 rows (p50/p99)
     and one user against 10^6 candidates (in chunks of 2^18), every
     logit finite; 21c NequIP (5 layers, 32 channels, l_max 2) on 128
     molecules of 30 atoms and 64 edges: ``energy_and_forces`` p50, the
     second-order train step's p50 over 4 steps, energies invariant
     (1e-5) and forces equivariant (1e-4, relative to the largest
     value) under a rotation and a translation; 21d the five ids at
     ``reduced_arch`` on the card against the CPU, 3 steps from the same
     parameters and batches (losses to 1e-4 relative), and the train
     launcher's ``main`` for nequip on the card, in process: ``--die-at-
     step 3`` exits 42, the rerun resumes from step 2 with step 3's
     line EQUAL. 21a-c profile one more train step of each model
     (device time by group, the optimizer's range, the idle share);
  22. the launch tools' plan against the card.  Two CPU children start
     right after the build and run beside phases 19-12 (no card
     visible to them, niced): ``python -m repro_torch.launch.dryrun
     --multi-pod single`` over every non-skipped cell of the ten archs
     on the 256-card H100 mesh (no failed row; its seconds printed),
     and the same tool on a 1 x 1 mesh for the cells phases 20a, 9-11
     and 21a-c run, at their shapes.  No model runs again: each plan is
     set beside what its phase measured (``plan_vs_card`` lines, with
     the card's name and power limit): argument bytes against
     ``memory_allocated()`` after the state was built (within 1 %),
     the traced peak against ``max_memory_allocated()`` (a ratio), and
     the counted FLOPs a step over the measured step time as a share
     of the dense bf16 peak (a hardware-FLOP share, beside 20a's
     model-FLOP share).

The kernels line's launches add those of phases 14-15's own searches,
phase 16's engine traffic and recovered-index searches, the launches
phase 17's launcher processes print, phase 18's RaBitQ searches,
phase 19's decode steps (kernel 7's row also gives its granite shape)
and phase 21a's requests (kernel 2's row also gives its time at the
SASRec catalog's shape, ``sasrec``).
Any failed check raises; the script exits 0 only when every phase
passed.  The last line is ``{"ok": true, "device": {...}}``.  Detailed
results go to ``chiprun_out/chip_smoke.json``.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
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


def bound(ops_ms, bytes_):
    """(bound_ms, bound_by): the larger of the operations' time at the
    peak rates of their types and the bytes' time at the memory rate."""
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return max(ops_ms, t_bytes), ("operations" if ops_ms >= t_bytes
                                  else "bytes")


def pct(v, p):
    v = sorted(v)
    return v[min(len(v) - 1, int(round(p / 100 * (len(v) - 1))))]


def device_times(prof, ranges=()):
    """One pass over a torch.profiler trace's raw events: (device us by
    kernel name, kernels run, device ms of each CPU range named in
    ``ranges``: the kernels whose launch, a CUDA runtime or driver call
    of the same correlation id, falls inside the range's time window).
    Launches are matched by time window on any thread, so a kernel that
    another thread launches inside the window counts for the range too.
    Kernels, copies and memsets count; annotations do not.
    ``key_averages()`` gives the same kernel sums but first builds a
    Python event tree (about 50 s for one granite-moe-3b training
    step's events on an H100 host), and its range sums leave out what
    the autograd thread launches."""
    import torch

    cuda_t = torch.autograd.DeviceType.CUDA
    dev_us, kernels, launch, spans = {}, [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda_t:
            if not e.is_user_annotation() and e.duration_ns() > 0:
                us = e.duration_ns() / 1e3
                dev_us[name] = dev_us.get(name, 0.0) + us
                kernels.append((e.correlation_id(), us))
        elif name in ranges:
            spans.setdefault(name, []).append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel...
            launch[e.correlation_id()] = e.start_ns()
    range_ms = {}
    for name, windows in spans.items():
        range_ms[name] = sum(
            us for c, us in kernels if c in launch
            and any(a <= launch[c] <= b for a, b in windows)) / 1e3
    return dev_us, len(kernels), range_ms


def ascending_operands(args, qterm, rowterm, rows, q_ops, order):
    """Operands whose rows are reordered by ``order`` (query 0's scores
    ascending) and whose every query is query 0: every span of the fused
    selection then sees improving keys, all of which pass its threshold.
    ``rows`` and ``q_ops`` index the row and query operands of ``args``."""
    out = list(args)
    for t in rows:
        out[t] = out[t][order].contiguous()
    for t in q_ops:
        out[t] = out[t][:1].expand_as(out[t]).contiguous()
    if rowterm is not None:
        rowterm = rowterm[order].contiguous()
        qterm = qterm[:1].expand_as(qterm).contiguous()
    return out, qterm, rowterm


def capture_strip(fn):
    """Run a fused wrapper once and return the key strip its scan
    handed to the merge (the merge runs as usual)."""
    from repro_torch.kernels import ash_score as TK

    merge, got = TK.ash_topk_merge_cuda, {}

    def keep(keys, k, run=0, rows=None, scan=None):
        got["keys"], got["run"] = keys.clone(), run
        return merge(keys, k, run, rows=rows, scan=scan)

    TK.ash_topk_merge_cuda = keep
    try:
        fn()
    finally:
        TK.ash_topk_merge_cuda = merge
    return got["keys"], got["run"]


def scan_only_ms(fn):
    """Device ms of a fused wrapper's scan alone: the merge replaced by
    a no-op for the timing."""
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import probe

    merge = TK.ash_topk_merge_cuda
    TK.ash_topk_merge_cuda = lambda keys, *_, **__: (keys, keys)
    try:
        return probe.graph_ms(fn)
    finally:
        TK.ash_topk_merge_cuda = merge


def gather_topk_cases(codes, cand, rest, qterm, rowterm, b, metric, g):
    """Kernel 4 (with its merge) EXACTLY against a stable top-k over
    positions of kernel 3's scores ``g`` on the candidate table
    ``cand``, mapped through the table, in the cases its selection
    treats apart: every query's positions ordered so that the scores
    ascend (every key beats the running bound); k~ < k (one-tile spans:
    ``ref.tile_topk_ref`` over positions); R below one tile and ragged;
    a query of pads only ((-inf, -1)); and the merge with the table
    equal to ``ref.positions_to_rows`` of the merge without."""
    import torch

    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ref

    def fused(rows, k, k_tilde=None):
        return TK.ash_score_gather_topk_cuda(
            codes, rows, *rest, qterm, rowterm, b=b, k=k, k_tilde=k_tilde,
            metric=metric)

    def exact(rows, k):
        scores = TK.ash_score_gather_cuda(codes, rows, *rest, qterm,
                                          rowterm, b=b, metric=metric)
        ts, tr = fused(rows, k)
        vs, vp = ref.stable_top_k(scores, k)
        r = rows.gather(1, vp)
        r = torch.where(torch.isneginf(vs) & (r < 0), -1, r)
        return bool(torch.equal(ts, vs) and torch.equal(tr, r))

    out = {}
    order = torch.sort(g, dim=1, stable=True).indices  # pads (-inf) first
    out["ascending"] = exact(cand.gather(1, order).contiguous(), K)
    ts, tr = fused(cand, 10, 4)
    ws, wp = ref.tile_topk_ref(g, cand >= 0, 10, 4)
    out["k_tilde_below_k"] = bool(torch.equal(ts, ws) and torch.equal(
        tr, ref.positions_to_rows(cand, wp)))
    R = cand.shape[1]
    out["R_300"] = exact(cand[:, :300].contiguous(), K)
    out["R_ragged"] = exact(cand[:, :R - 77].contiguous(), K)
    pads = cand.clone()
    pads[0] = -1
    out["pad_query"] = exact(pads, K)
    ts, tr = fused(pads, K)
    out["pad_query_exhausted"] = bool(torch.isneginf(ts[0]).all()
                                      and (tr[0] == -1).all())
    keys, run = capture_strip(lambda: fused(cand, K))
    s0, p0 = TK.ash_topk_merge_cuda(keys, K, run)
    s1, r1 = TK.ash_topk_merge_cuda(keys, K, run, rows=cand)
    out["merge_rows_equals_positions_to_rows"] = bool(
        torch.equal(s0, s1) and torch.equal(r1, ref.positions_to_rows(
            cand, p0)))
    return out


def ptxas_report(libs, kernel, main_instance):
    """Registers and spills (``nvcc -Xptxas -v``, in each library's build
    log) of every instance of ``kernel``: the largest register count,
    the instances that spill, and the main path's instance (its mangled
    template arguments contain ``main_instance``)."""
    import re

    found = []
    for lib in libs.values():
        logf = lib.with_suffix(".log")
        if not logf.exists():
            continue
        cur, spill = None, (0, 0)
        for ln in logf.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur, spill = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and cur:
                if kernel in cur:
                    found.append((cur, int(m.group(1)), spill))
                cur = None
    main = [f for f in found if main_instance in f[0]]
    return dict(
        instances=len(found),
        max_registers=max([f[1] for f in found] or [0]),
        spilling_instances=[f[0] for f in found if sum(f[2])],
        main_instance=main[0][0] if main else None,
        main_registers=main[0][1] if main else None,
        main_spill_bytes=(list(main[0][2]) if main else None))


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
    dev_us = device_times(prof)[0]
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


# -- the LM serving path (phases 9-12) ----------------------------------
# llama3.2-3B at full width and depth, the decode_32k_ashkv cell's cache
# (b = 4, d_code = d_head = 128, max_len 32768) at batch 32: the cell's
# batch of 128 needs 124 GB of cache, above the card's 80 GB.
LM_BATCH, LM_MAX_LEN, LM_CONTEXT, LM_STEPS = 32, 32768, 32704, 64
FID_BATCH, FID_LEN = 4, 256  # phase 12: fidelity and prefill
FILL_POSITIONS = 1024  # positions per encode chunk of the phase-11 fill
KV_SDPA = "torch.nn.functional.scaled_dot_product_attention"


def kv_close(got, want):
    """Kernel 7 against its plain version: rtol 1e-4 (the reference's
    kernel test) and atol 1e-5 x max(1, largest |plain value|): fp32
    sums over S positions in another order, errors in proportion to
    the values (grid values reach 255 at b = 8)."""
    atol = 1e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs()
    ok = bool((err <= atol + 1e-4 * want.abs()).all())
    return ok, float(err.max())


def kv_operands(gen, N1, N2, S, G, bk, bv, dk, dv, dev, *, bias=True,
                mask_from=0, scale_dtype=None, layer_layout=False):
    """Random kernel-7 operands on the card: uniform codes; scales near
    their decode values at b = 4 (0.05-0.15), times 15 / (2^b - 1) at
    other bitrates, as the encoder's scale = |x| / |V| shrinks with the
    grid; q_k of unit scale, so logits are a few units at every
    bitrate; a mask valid on [mask_from, S - 3).  ``layer_layout`` lays
    codes and scales out as the (B, S, KV, W) layer cache, read as a
    view."""
    import torch

    from repro_torch.core import quantization as Q

    scale_dtype = scale_dtype or torch.float32
    Wk, Wv = Q.packed_width(dk, bk), Q.packed_width(dv, bv)

    def codes(W):
        shape = (N1, S, N2, W) if layer_layout else (N1, N2, S, W)
        c = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                          device=dev, dtype=torch.int32)
        return c.permute(0, 2, 1, 3) if layer_layout else c

    def scales(b):
        shape = (N1, S, N2) if layer_layout else (N1, N2, S)
        t = (torch.rand(shape, generator=gen, device=dev) * 0.1 + 0.05)
        t = (t * (15 / (2**b - 1))).to(scale_dtype)
        return t.permute(0, 2, 1) if layer_layout else t

    pos = torch.arange(S, device=dev)
    return dict(
        q=torch.randn(N1, N2, G, Wk * 32 // bk, generator=gen, device=dev)
        * (3.0 / dk ** 0.5),
        kc=codes(Wk), ks=scales(bk),
        kb=(torch.randn(N1, N2, S, generator=gen, device=dev) * 0.1
            if bias else None),
        vc=codes(Wv), vs=scales(bv),
        mask=(pos >= mask_from) & (pos < S - 3),
    )


def kv_call(fn, t, bk, bv):
    return fn(t["q"], t["kc"], t["ks"], t["kb"], t["vc"], t["vs"], t["mask"],
              b_k=bk, b_v=bv)


def profile_step(step, n_prof=2):
    """torch.profiler over ``n_prof`` calls of ``step``: wall and device
    busy ms per call, idle share, device ms per call by kernel group
    (kernel 7, matrix products, the rest) and the 8 busiest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = device_times(prof)[0]
    busy_ms = sum(dev_us.values()) / 1e3
    groups = {"ash_kv_attn": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in dev_us.items():
        low = name.lower()
        if "ash_kv" in low:
            groups["ash_kv_attn"] += us / 1e3 / n_prof
        elif any(w in low for w in ("gemm", "xmma", "cutlass", "gemv",
                                    "splitk", "nvjet")):
            groups["matmul"] += us / 1e3 / n_prof
        else:
            groups["other"] += us / 1e3 / n_prof
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        calls=n_prof, wall_ms_per_call=wall_ms / n_prof,
        device_busy_ms_per_call=busy_ms / n_prof,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        device_ms_by_group=groups,
        top_device_ms_per_call={k[:80]: v / 1e3 / n_prof for k, v in top},
    )


def kv_layer_check(cfg, batch, dev, gen, plain_rows=None):
    """Kernel 7 against its plain version at one layer of the decode
    shape (``batch`` x KV streams, G query heads each, LM_MAX_LEN
    positions of which the first LM_CONTEXT + 1 are valid), with its
    time, bound, bound share and the SDPA yardstick.  ``plain_rows``:
    batch rows per call of the plain version, whose fp32 K and V of a
    whole layer need not fit at once."""
    import torch

    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.kernels import ref

    b, dc = cfg.kv_quant_bits, cfg.code_dim
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    main = kv_operands(gen, batch, KV, LM_MAX_LEN, G, b, b, dc, dc, dev,
                       bias=False, scale_dtype=cfg.dtype, layer_layout=True)
    main["mask"] = torch.arange(LM_MAX_LEN, device=dev) <= LM_CONTEXT
    rows = plain_rows or batch

    def plain():
        return torch.cat([ref.ash_kv_attn_ref(
            main["q"][r:r + rows], main["kc"][r:r + rows],
            main["ks"][r:r + rows], None, main["vc"][r:r + rows],
            main["vs"][r:r + rows], b, b, mask=main["mask"])[0]
            for r in range(0, batch, rows)])

    ok_main, err_main = kv_close(kv_call(KA.ash_kv_attn_cuda, main, b, b),
                                 plain())
    check(ok_main, f"kernel 7 at the decode shape of {cfg.name}: "
                   f"max |err| {err_main}")
    # times: kernel, plain, and SDPA over pre-dequantized bf16 K and V
    # (scales folded in) as the yardstick
    ms = event_ms(lambda: kv_call(KA.ash_kv_attn_cuda, main, b, b), iters=20)
    plain_ms = event_ms(plain, iters=2, warmup=1)
    N, S = batch * KV, LM_MAX_LEN
    W = main["kc"].shape[-1]
    kv_bytes = (N * S * 2 * W * 4 + N * S * 2 * main["ks"].element_size()
                + N * G * W * (32 // b) * 4 * 2 + S)
    kv_ops_ms = 4 * N * G * S * dc / PEAK_FP32_FLOPS * 1e3
    bound_ms, bound_by = bound(kv_ops_ms, kv_bytes)
    Kd = (Q.unpack_codes(main["kc"], dc, b).to(torch.bfloat16)
          * main["ks"][..., None]).contiguous()  # (B, KV, S, dc)
    Vd = (Q.unpack_codes(main["vc"], dc, b).to(torch.bfloat16)
          * main["vs"][..., None]).contiguous()
    qd = main["q"].reshape(batch, KV * G, 1, dc).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask4 = main["mask"][None, None, None, :]
    lib_ms = event_ms(lambda: sdpa(qd, Kd, Vd, attn_mask=mask4,
                                   enable_gqa=True), iters=10)
    del Kd, Vd, qd, main
    torch.cuda.empty_cache()
    return dict(
        shape=dict(streams=N, G=G, S=S, b=b, d_code=dc), max_abs_err=err_main,
        splits=KA.split_geometry(N, S), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=kv_bytes,
        library_ms=lib_ms, bound_share=bound_ms / ms)


def fill_cache(params, cfg, cache, batch, dev, gen, chunk, block=None):
    """Layer 0's first LM_CONTEXT positions: seeded random K/V encoded
    (``_encode_kv``) ``chunk`` positions at a time, over the first
    ``block`` positions (all when None) and copied along the rest; then
    layer 0 copied to every layer.  Returns the seconds taken."""
    import torch

    from repro_torch.models import transformer as TT

    b, KV = cfg.kv_quant_bits, cfg.n_kv_heads
    span = block or LM_CONTEXT
    t0 = time.perf_counter()
    for name, Wp in (("k", params.kv_Wk[0]), ("v", params.kv_Wv[0])):
        codes_l, scale_l = cache[f"{name}_codes"][0], cache[f"{name}_scale"][0]
        for s0 in range(0, span, chunk):
            s1 = min(span, s0 + chunk)
            vec = torch.randn(batch, s1 - s0, KV, cfg.head_dim,
                              generator=gen, device=dev).to(cfg.dtype)
            codes, sc = TT._encode_kv(Wp, vec, b)
            codes_l[:, s0:s1] = codes
            scale_l[:, s0:s1] = sc.to(cfg.dtype)
        for s0 in range(span, LM_CONTEXT, span):
            s1 = min(LM_CONTEXT, s0 + span)
            codes_l[:, s0:s1] = codes_l[:, :s1 - s0]
            scale_l[:, s0:s1] = scale_l[:, :s1 - s0]
    for k_ in cache:
        cache[k_][1:] = cache[k_][0]
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def decode_stream(params, cfg, cache, batch, dev, gen):
    """LM_STEPS greedy ``decode_step``s after LM_CONTEXT positions,
    counts zeroed just before (exactly ``n_layers`` kernel-7 launches a
    step), then a profile of one step (the cache at its last length).
    Returns (results, kernel-7 launches, profile)."""
    import torch

    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.kernels import ash_score as TK
    from repro_torch.models import transformer as TT

    tokens = torch.randint(0, cfg.vocab, (batch,), generator=gen,
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    TK.reset_launch_counts()
    KA.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lat, finite = [], True
    t0 = time.perf_counter()
    for i in range(LM_STEPS):
        start.record()
        logits, cache = TT.decode_step(params, cache, tokens, LM_CONTEXT + i,
                                       cfg)
        tokens = torch.argmax(logits, dim=-1)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end))
        finite = finite and bool(torch.isfinite(logits).all())
    wall = time.perf_counter() - t0
    launches = {**TK.launch_counts, **KA.launch_counts}
    check(launches["ash_kv_attn"] == cfg.n_layers * LM_STEPS,
          f"kernel 7 launches {launches['ash_kv_attn']} over {LM_STEPS} "
          f"steps of {cfg.n_layers} layers")
    check(finite and logits.shape == (batch, cfg.vocab),
          "decode logits not finite or misshapen")
    res = dict(
        config=cfg.name, batch=batch, context=LM_CONTEXT, steps=LM_STEPS,
        p50_ms=pct(lat, 50), p99_ms=pct(lat, 99),
        mean_ms=sum(lat) / len(lat), tokens_per_s=batch * LM_STEPS / wall,
        kernel7_launches=launches["ash_kv_attn"],
        kernel7_launches_per_step=launches["ash_kv_attn"] / LM_STEPS,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = profile_step(
        lambda: TT.decode_step(params, cache, tokens, LM_CONTEXT + LM_STEPS
                               - 1, cfg))
    return res, launches["ash_kv_attn"], prof


def fidelity(params, cfg, dev, gen, tokens=FID_LEN, free=True):
    """Decode fidelity at FID_BATCH over ``tokens`` teacher-forced tokens
    (phases 12, 19c): every kernel-7 call of the kernel route against its
    plain version on the same operands; the kernel route's logits
    against the plain route run from the kernel route's cache before
    each step, held to twice the noise floor of an fp32-sized jitter of
    the attention output; the plain route run free (``free``) and the
    bf16 cache (reported); ``prefill`` against the bf16 cache's last
    step (gated for a dense model; for MoE reported, as the reference's
    own MoE tolerance there is 10x looser: capacity drops follow the
    batch shape).  For MoE also the share of (token, layer) top-k
    routings that differ from the same-cache plain route's."""
    import dataclasses as dc_

    import torch

    from repro_torch.kernels import ops as KO
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    cfg_e = dc_.replace(cfg, kv_quant_bits=0)
    toks = torch.randint(0, cfg.vocab, (FID_BATCH, tokens), generator=gen,
                         device=dev)
    # routes: the ASH-KV kernel route; its plain route run from the
    # kernel route's own cache before each step (same history: the
    # kernel's one-step error); the plain route run free (its own cache:
    # the one-step errors compounded through 256 steps of re-encoded
    # K/V); the bf16 cache
    caches = {"kernel": TT.init_cache(cfg, FID_BATCH, tokens, device=dev),
              "bf16": TT.init_cache(cfg_e, FID_BATCH, tokens, device=dev)}
    if free:
        caches["free"] = TT.init_cache(cfg, FID_BATCH, tokens, device=dev)
    out = {k: [] for k in ("kernel", "same", "jitter", "bf16")
           + (("free",) if free else ())}
    # on the kernel route every layer's kernel-7 call is also held to the
    # plain version on the same operands
    op = KO.ash_kv_attention
    layer_check = dict(calls=0, max_abs_err=0.0, max_rel_err=0.0,
                       all_close=True)

    def checked(*args, use_kernel=True, **kw):
        got = op(*args, use_kernel=use_kernel, **kw)
        if use_kernel:
            want = op(*args, use_kernel=False, **kw)
            ok, err = kv_close(got, want)
            layer_check["calls"] += 1
            layer_check["all_close"] &= ok
            layer_check["max_abs_err"] = max(layer_check["max_abs_err"], err)
            layer_check["max_rel_err"] = max(  # of the largest |value|
                layer_check["max_rel_err"], err / float(want.abs().max()))
        return got

    # the noise floor of the logit comparison: the plain route from the
    # same cache with every attention output moved by a random +-2^-20
    # relative (8 fp32 ulps, the size of the kernel's own error on these
    # operands), which the random model amplifies as it does the
    # kernel's (with MoE, through the routings it flips too)
    jgen = torch.Generator(device=dev).manual_seed(12)

    def jittered(*args, **kw):
        red = op(*args, **kw)
        sign = torch.randint(0, 2, red.shape, generator=jgen, device=dev)
        return red * (1 + (2 * sign - 1) * 2.0**-20)

    # each route's top-k choices per (step, layer), as the router made them
    routes = {"kernel": [], "same": [], "jitter": []}
    route_of = [None]
    router = TM.route

    def recording(p, x, c):
        out = router(p, x, c)
        if route_of[0] is not None:
            routes[route_of[0]].append(out[2])
        return out

    def step(name, cache, tok, t, c, attn=op, **kw):
        route_of[0] = name if name in routes else None
        KO.ash_kv_attention, TM.route = attn, recording
        try:
            return TT.decode_step(params, cache, tok, t, c, **kw)
        finally:
            KO.ash_kv_attention, TM.route = op, router

    for t in range(tokens):
        tok = toks[:, t]
        snap = {k: v.clone() for k, v in caches["kernel"].items()}
        out["same"].append(step("same", snap, tok, t, cfg,
                                use_kernel=False)[0])
        snap = {k: v.clone() for k, v in caches["kernel"].items()}
        out["jitter"].append(step("jitter", snap, tok, t, cfg, jittered,
                                  use_kernel=False)[0])
        lg, caches["kernel"] = step("kernel", caches["kernel"], tok, t, cfg,
                                    checked)
        out["kernel"].append(lg)
        if free:
            lg, caches["free"] = step("free", caches["free"], tok, t, cfg,
                                      use_kernel=False)
            out["free"].append(lg)
        lg, caches["bf16"] = step("bf16", caches["bf16"], tok, t, cfg_e)
        out["bf16"].append(lg)
    del caches, snap
    logits = {k: torch.stack(v) for k, v in out.items()}  # (T, B, V)
    lk, le = logits["kernel"], logits["bf16"]

    def agree(a, b):
        err = float((a - b).abs().max())
        return (err, err / float(b.abs().max()),
                float((a.argmax(-1) == b.argmax(-1)).float().mean()))

    def corr(a, b):
        return float(torch.corrcoef(torch.stack([a.flatten(),
                                                 b.flatten()]))[0, 1])

    def flips(name):
        """Share of (token, layer) whose set of top-k experts differs
        from the same-cache plain route's."""
        if not routes[name]:
            return None
        a = torch.sort(torch.stack(routes[name]), dim=-1).values
        b = torch.sort(torch.stack(routes["same"]), dim=-1).values
        return float((a != b).any(dim=-1).float().mean())

    same_err, same_rel, same_top1 = agree(lk, logits["same"])
    jit_err, jit_rel, jit_top1 = agree(logits["jitter"], logits["same"])
    free_err, free_rel, free_top1 = (agree(lk, logits["free"]) if free
                                     else (None, None, None))
    _, _, ae_top1 = agree(lk, le)
    pre = TT.prefill(params, toks, cfg_e)
    pre_err, pre_rel, _ = agree(pre, le[-1])
    fid = dict(
        config=cfg.name, batch=FID_BATCH, tokens=tokens,
        layer_calls_checked=layer_check["calls"],
        layer_max_abs_err=layer_check["max_abs_err"],
        layer_max_rel_err=layer_check["max_rel_err"],
        layer_all_close=layer_check["all_close"],
        kernel_vs_plain_max_abs=same_err, kernel_vs_plain_rel=same_rel,
        kernel_vs_plain_top1=same_top1,
        noise_floor_max_abs=jit_err, noise_floor_rel=jit_rel,
        noise_floor_top1=jit_top1,
        kernel_vs_free_plain_max_abs=free_err,
        kernel_vs_free_plain_rel=free_rel,
        kernel_vs_free_plain_top1=free_top1,
        ashkv_vs_bf16_corr=corr(lk, le), ashkv_vs_bf16_top1=ae_top1,
        prefill_vs_decode_max_abs=pre_err, prefill_vs_decode_rel=pre_rel,
        prefill_vs_decode_corr=corr(pre, le[-1]),
        routing_flip_share=flips("kernel"),
        noise_floor_routing_flip_share=flips("jitter"),
        finite=bool(all(torch.isfinite(v).all() for v in logits.values())
                    and torch.isfinite(pre).all()))
    # kernel 7 == its plain version on every layer's operands (the
    # tolerance of phase 10).  The logits of one step from the same cache
    # differ by more: fp32-sized differences flip bf16 roundings of
    # activations, which move codes of the step's own K/V (and top-k
    # routings), and the random model amplifies that.  So the logits are
    # held to the noise floor: the kernel route's divergence from the
    # plain route at most twice the jittered route's, its top-1
    # agreement at most 3 points below the jittered route's
    check(layer_check["all_close"] and layer_check["calls"]
          == tokens * cfg.n_layers, f"kernel 7 on decode operands: {fid}")
    check(same_rel <= 2 * jit_rel and same_top1 >= jit_top1 - 0.03,
          f"kernel route vs plain route, against the noise floor: {fid}")
    if not cfg.moe:
        check(fid["prefill_vs_decode_rel"] <= 0.1
              and fid["prefill_vs_decode_corr"] >= 0.99,
              f"prefill vs bf16 decode: {fid}")
    check(fid["finite"], "fidelity logits not finite")
    return fid


def lm_phases(results, dev):
    """Phases 9-12; returns kernel 7's row of the ``kernels`` line."""
    import torch

    from repro_torch.configs import llama32_3b as LC
    from repro_torch.models import transformer as TT

    # -- 9. LM build ------------------------------------------------------
    cfg = LC.ashkv_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, t_init = sync_time(TT.init_params, torch.Generator(
        device=dev).manual_seed(0), cfg, device=dev)
    cache, t_cache = sync_time(TT.init_cache, cfg, LM_BATCH, LM_MAX_LEN,
                               device=dev)
    results["lm_build"] = lm_build_row(params, cfg, cache, LM_BATCH, t_init,
                                       t_cache)
    # phase 22's: the weights and the cache as the allocator holds them
    results["lm_build"]["state_allocated_b"] = (
        torch.cuda.memory_allocated() - base)
    log("lm_build", **results["lm_build"])

    # -- 10. kernel 7 against its plain version --------------------------
    gen = torch.Generator(device=dev).manual_seed(10)
    kv = kv_layer_check(cfg, LM_BATCH, dev, gen)
    b, dc = cfg.kv_quant_bits, cfg.code_dim
    edges = []
    for bk in (1, 2, 4, 8):
        for bv in (1, 2, 4, 8):
            edges.append(dict(bk=bk, bv=bv, N1=4, N2=8, S=1000, G=3,
                              dk=128, dv=128, bias=True, mask_from=0))
    # rows of 5 and 6 words: the kernel's 4-byte copy path
    edges.append(dict(bk=4, bv=8, N1=3, N2=2, S=700, G=3, dk=40, dv=24,
                      bias=True, mask_from=0))
    for G_ in (1, 3, 8):
        for S_, mf in ((77, 0), (4099, 700), (300, 200)):
            for sd in (torch.float32, torch.bfloat16):
                edges.append(dict(bk=4, bv=2, N1=5, N2=1, S=S_, G=G_, dk=96,
                                  dv=64, bias=G_ != 3, mask_from=mf,
                                  scale_dtype=sd))
    edge_err, edge_ok = kv_edges(edges, gen, dev)
    check(all(edge_ok), f"kernel 7 edge shapes: {edge_ok}")
    results["kv_kernel"] = dict(
        kv, edge_cases=len(edges), edge_max_abs_err=edge_err,
        ptxas=results["ptxas"]["ash_kv_attn_kernel"])
    log("kv_kernel", **results["kv_kernel"])

    # -- 11. decode stream ------------------------------------------------
    # layer 0's cache holds LM_CONTEXT encoded random K/V vectors, copied
    # to every layer; then LM_STEPS greedy steps
    gen = torch.Generator(device=dev).manual_seed(11)
    fill_s = fill_cache(params, cfg, cache, LM_BATCH, dev, gen,
                        FILL_POSITIONS)
    dec, k7_launches, prof = decode_stream(params, cfg, cache, LM_BATCH, dev,
                                           gen)
    results["decode"] = dict(dec, fill_s=fill_s)
    log("decode", **results["decode"])
    # 11b. where a decode step's time goes (the cache at its last length)
    results["profile_decode_step"] = prof
    log("profile_decode", **prof)
    del cache
    torch.cuda.empty_cache()

    # -- 12. fidelity and prefill ------------------------------------------
    results["fidelity"] = fidelity(params, cfg, dev, gen)
    log("fidelity", **results["fidelity"])
    del params
    torch.cuda.empty_cache()
    return dict(
        name="ash_kv_attn", route="cuda",
        source="src/repro_torch/kernels/csrc/ash_kv_attn.cu",
        replaces="src/repro/kernels/ash_kv_attn.py:96",
        launches=k7_launches, max_abs_err=kv["max_abs_err"], ms=kv["ms"],
        plain_ms=kv["plain_ms"], bound_ms=kv["bound_ms"],
        bound_by=kv["bound_by"], library_ms=kv["library_ms"],
        library_call=f"{KV_SDPA} over pre-dequantized bf16 K and V")


def lm_build_row(params, cfg, cache, batch, t_init, t_cache):
    """Phase 9's (and 19's) build line: parameter count held to the
    config's, weight and cache sizes, peak memory."""
    import torch

    n_params = sum(p.numel() for p in params.parameters())
    kvq = params.kv_Wk.numel() + params.kv_Wv.numel()
    check(n_params - kvq == cfg.param_count(), "parameter count")
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    c_bytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    return dict(
        config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        kv_quant_bits=cfg.kv_quant_bits, code_dim=cfg.code_dim,
        batch=batch, max_len=LM_MAX_LEN, params=n_params,
        weight_gb=w_bytes / 1e9, cache_gb=sum(c_bytes.values()) / 1e9,
        cache_codes_gb=(c_bytes["k_codes"] + c_bytes["v_codes"]) / 1e9,
        cache_scales_gb=(c_bytes["k_scale"] + c_bytes["v_scale"]) / 1e9,
        init_s=t_init, cache_s=t_cache,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def kv_edges(edges, gen, dev):
    """Kernel 7 against its plain version at each edge shape: (largest
    |err|, each case's verdict)."""
    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.kernels import ref

    edge_err, edge_ok = 0.0, []
    for e in edges:
        e = dict(e)
        bk, bv = e.pop("bk"), e.pop("bv")
        t = kv_operands(gen, e.pop("N1"), e.pop("N2"), e.pop("S"), e.pop("G"),
                        bk, bv, e.pop("dk"), e.pop("dv"), dev, **e)
        ok, err = kv_close(
            kv_call(KA.ash_kv_attn_cuda, t, bk, bv),
            kv_call(lambda *a, **kw: ref.ash_kv_attn_ref(
                *a[:6], kw["b_k"], kw["b_v"], mask=a[6])[0], t, bk, bv))
        edge_ok.append(ok)
        edge_err = max(edge_err, err)
    return edge_err, edge_ok


# -- the serving engine (phase 13) --------------------------------------
# phase 3's flat and IVF indexes behind repro_torch.serving: one engine
# for both, 32 client threads through a ServingFrontend, the degraded
# nprobe rung, mutations with a background compactor, and closed-loop
# numbers against direct search from the same client threads
ENG_BUCKETS, ENG_K_BUCKETS = (8, 32, 128), (10, 100)
ENG_ROW_BUDGET = 500_000  # about half the index: IVF groups split
ENG_CLIENTS, ENG_REQUESTS = 32, 40  # 13b: threads, requests each
MUT_THREADS, MUT_OPS, MUT_DELETE_IDS = 8, 40, 20_000  # 13d
# 13e: at least 1,000 timed requests a loop, so that p99 has ten
# samples beyond it
LOOP_CLIENTS, LOOP_REQUESTS, LOOP_MIN = (1, 8, 32), 1000, 40
PROF_FLUSHES, PROF_BUCKET = 20, 32  # 13e profile window


def _same(got, want):
    """(scores, ids) of a ticket (host tensors) EQUAL to a direct search
    (device tensors)."""
    import torch

    return bool(torch.equal(got[0], want[0].cpu())
                and torch.equal(got[1], want[1].cpu()))


def _run_threads(n, target, timeout=300.0):
    """Start ``n`` threads of ``target(i)`` together; join them all and
    fail if one is still running after ``timeout`` seconds."""
    import threading

    threads = [threading.Thread(target=target, args=(i,), daemon=True)
               for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, timeout - (time.perf_counter() - t0)))
    check(not any(t.is_alive() for t in threads),
          f"client threads still running after {timeout} s")
    return time.perf_counter() - t0


def _closed_loop(clients, per_client, request, n_q):
    """``clients`` threads, each issuing ``per_client`` requests back to
    back (``request(i)`` for query row i): QPS and host-clock p50/p99,
    after one untimed request from every client at once (the first
    flush of a bucket shape grows the allocator).  Launch counts are
    zeroed after that warm-up."""
    import torch

    from repro_torch.kernels import ash_score as TK

    lat = [[] for _ in range(clients)]
    errors = []
    _run_threads(clients, lambda c: request((n_q - 1 - c) % n_q))
    torch.cuda.synchronize()
    TK.reset_launch_counts()

    def client(c):
        try:
            for j in range(per_client):
                i = (c * per_client + j) % n_q
                t0 = time.perf_counter()
                request(i)
                lat[c].append(time.perf_counter() - t0)
        except Exception as e:  # recorded, then failed below
            errors.append(repr(e))

    wall = _run_threads(clients, client)
    check(not errors, f"closed-loop client failed: {errors[:2]}")
    flat = [x for c in lat for x in c]
    return dict(clients=clients, requests=len(flat), wall_s=wall,
                qps=len(flat) / wall, p50_ms=pct(flat, 50) * 1e3,
                p99_ms=pct(flat, 99) * 1e3)


def _timed(obj, name, acc):
    """Wrap ``obj.name`` (as an instance attribute) to add its seconds
    to ``acc[name]``; ``del obj.name`` restores a method."""
    inner = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, timed)


def _profile(run, n_queries):
    """torch.profiler around ``run()``: wall and device-busy ms per
    query, device operations per query, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us, n_ops, _ = device_times(prof)
    busy_ms = sum(dev_us.values()) / 1e3
    return dict(queries=n_queries, wall_ms_per_query=wall_ms / n_queries,
                device_busy_ms_per_query=busy_ms / n_queries,
                device_ops_per_query=n_ops / n_queries,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms
                else None)


def scan_operands(model, idx, pl, stats, queries, metric):
    """The kernels' operands on ``idx.prepare(queries)`` over payload
    ``pl`` (the queries' pad lanes checked to be zeros), the plain dense
    scores and their elementwise bound ``ref.score_tolerance``: (prep,
    args, qterm, rowterm, want, tol)."""
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops, ref

    prep = idx.prepare(queries)
    args = ops._score_args(prep, pl)
    codes, qp, scale, offset, cluster, ipq = args
    check(not bool(qp[:, prep.q_proj.shape[-1]:].any()),
          "a query's pad lanes are not 0")
    qterm, rowterm = ops._metric_operands(model, prep, pl, stats, metric)
    want = ref.ash_score_metric_ref(*args, qterm, rowterm, b=pl.b,
                                    metric=metric)
    d_pad = pl.codes.shape[1] * Q.codes_per_word(pl.b)
    V_abs = Q.unpack_codes(pl.codes, d_pad, pl.b).float().abs()
    Amat = (qp.abs() @ V_abs.T) * scale.abs()[None, :]
    del V_abs
    tol = ref.score_tolerance(Amat, ipq[:, cluster.long()], offset, qterm,
                              rowterm, want, metric, d_pad)
    return prep, args, qterm, rowterm, want, tol


def within_bound(what, got, want, tol):
    """The largest |got - want| over its bound, checked to be <= 1."""
    r = float(((got - want).abs() / tol).max())
    check(r <= 1.0, f"{what}: |kernel - plain| above bound (max ratio {r})")
    return r


def selection_within(what, ts, tr, ps, pr, want, row_tol):
    """A kernel's top-k against its plain selection: scores within the
    row's bound, ids equal wherever the dense plain scores of the two ids
    differ by more than twice it.  Returns the largest error over
    bound."""
    import torch

    differ = tr != pr
    gap = (want.gather(1, tr.clamp(min=0).long())
           - want.gather(1, pr.clamp(min=0).long())).abs()
    fin = torch.isfinite(ps)
    err = torch.where(fin, (ts - ps).abs(), 0.0)
    r = float((err / row_tol).max())
    check(bool((gap[differ] <= 2 * row_tol.expand_as(gap)[differ]).all())
          and r <= 1.0 and torch.equal(fin, torch.isfinite(ts)),
          f"{what} != its plain selection beyond the bound")
    return r


def flat_scan_check(index, queries, ks, what, metric="dot"):
    """Phase 4's rule for kernels 1 and 2 on the flat scan of ``index``
    for ``queries``, launched at their row count: kernel 1 within
    ``ref.score_tolerance`` of its plain version; at each k of ``ks`` the
    fused top-k EXACTLY the stable top-k of kernel 1's scores, and
    against the plain fused route (:func:`selection_within`).  Returns
    (the operands, plain scores, bound and kernel 1's scores, for the
    caller's further checks; the errors)."""
    import torch

    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ref

    pl = index.payload
    prep, args, qterm, rowterm, want, tol = scan_operands(
        index.model, index, pl, index.stats, queries, metric)
    got = TK.ash_score_cuda(*args, qterm, rowterm, b=pl.b, metric=metric)
    out = dict(m=int(queries.shape[0]), d=int(prep.q_proj.shape[-1]),
               d_pad=int(args[1].shape[1]),
               max_abs_err=float((got - want).abs().max()),
               max_err_over_bound=within_bound(f"{what}: kernel 1", got,
                                               want, tol),
               max_bound=float(tol.max()), topk={})
    row_tol = tol.max(dim=1, keepdim=True).values
    vs, vi = ref.stable_top_k(got, max(ks))  # its prefixes: each k
    for k in ks:
        ts, ti = TK.ash_score_topk_cuda(*args, qterm, rowterm, b=pl.b, k=k,
                                        metric=metric)
        exact = bool(torch.equal(ts, vs[:, :k])
                     and torch.equal(ti, vi[:, :k].to(torch.int32)))
        check(exact, f"{what}: fused k = {k} != stable top-k of kernel 1")
        ps, pi = ref.ash_score_topk_ref(*args, qterm, rowterm, None, b=pl.b,
                                        k=k, metric=metric)
        out["topk"][k] = dict(
            max_abs_err=float((ts - ps).abs().max()),
            max_err_over_bound=selection_within(
                f"{what}: kernel 2 at k = {k}", ts, ti, ps, pi, want,
                row_tol),
            id_mismatch=int((ti != pi).sum()), fused_equals_sorted=exact)
    del vs, vi
    return dict(prep=prep, args=args, qterm=qterm, rowterm=rowterm,
                want=want, tol=tol, got=got), out


def flat_scan_rows(index, queries):
    """Kernels 1 and 2 (k = K) timed on the flat scan of ``index`` for
    ``queries`` (dot): CUDA-graph ms, the plain version's ms, the bound
    (each input read once, each output written once; fp32 operations)
    and the library yardstick on pre-dequantized fp32 codes.  Returns
    their two rows of the ``kernels`` line, less launches and errors."""
    import torch

    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ops, probe, ref

    payload = index.payload
    args = ops._score_args(index.prepare(queries), payload)
    m = int(queries.shape[0])
    n, wd = payload.codes.shape
    d_pad = wd * Q.codes_per_word(payload.b)
    C = args[5].shape[1]
    V32 = Q.unpack_codes(payload.codes, d_pad, payload.b).float()
    qp = args[1]
    flops = 2 * m * n * d_pad + 3 * m * n
    in_bytes = n * wd * 4 + m * d_pad * 4 + 3 * n * 4 + m * C * 4
    rows = []
    for name, fn, plain_fn, lib_fn, lib_call, out_bytes, line in (
        ("ash_score",
         lambda: TK.ash_score_cuda(*args, b=payload.b),
         lambda: ref.ash_score_metric_ref(*args, None, None, b=payload.b),
         lambda: torch.matmul(qp, V32.T),
         "torch.matmul on pre-dequantized fp32 codes",
         m * n * 4, 368),
        ("ash_score_topk",
         lambda: TK.ash_score_topk_cuda(*args, b=payload.b, k=K),
         lambda: ref.ash_score_topk_ref(*args, None, None, None,
                                        b=payload.b, k=K),
         lambda: torch.topk(torch.matmul(qp, V32.T), K, dim=1),
         "torch.topk(torch.matmul) on pre-dequantized fp32 codes",
         m * K * 8, 428),
    ):
        bound_ms, bound_by = bound(flops / PEAK_FP32_FLOPS * 1e3,
                                   in_bytes + out_bytes)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/ash_score.cu",
            replaces=f"src/repro/kernels/ash_score.py:{line}",
            ms=probe.graph_ms(fn), plain_ms=event_ms(plain_fn, iters=10),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=event_ms(lib_fn), library_call=lib_call,
        ))
    del V32
    return rows


def kernels_at_rows(index, ivf, queries, m):
    """Kernels 1-6 on a fresh ``prepare`` of ``m`` rows, held against
    their plain versions as phases 4 and 4b hold them at 8 rows: kernels
    1 and 3 within ``ref.score_tolerance``; kernels 2 and 4 EQUAL to the
    stable top-k of kernels 1 and 3, and against their plain selections
    with scores within the row's bound and ids equal wherever the score
    gap exceeds it; kernels 5 and 6 EQUAL to the plain coarse scan and
    its stable top-k.  The engine's buckets run the kernels at 32 and
    128 rows, on the operands of its routes: the flat scan (k = 10 and
    k = 100), the IVF candidate table at nprobe = NPROBE, and the flat
    coarse shortlists of L = 32 (refined by kernel 4) and L = RERANK
    (refined by kernel 3).  Returns the largest |kernel - plain| over
    bound of kernels 1-4 and the equalities, by kernel name."""
    import torch

    from repro_torch.index import ivf as IV
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ops, ref

    metric = "dot"  # the metric of phase 3's indexes
    model = index.model
    out = {"ash_score": 0.0, "ash_score_topk": 0.0,
           "ash_score_gather": 0.0, "ash_score_gather_topk": 0.0}
    exact = {}

    def ratio(name, got, want, tol):
        out[name] = max(out[name],
                        within_bound(f"m = {m}: {name}", got, want, tol))

    def selection(name, ts, tr, ps, pr, want, row_tol):
        out[name] = max(out[name], selection_within(
            f"m = {m}: {name}", ts, tr, ps, pr, want, row_tol))

    def gathered(cand, args, qterm, rowterm, want, tol, ks):
        """kernels 3 and 4 over one candidate table"""
        codes, rest = args[0], args[1:]
        b = index.payload.b
        live = cand >= 0
        safe = cand.clamp(min=0).long()
        g = TK.ash_score_gather_cuda(codes, cand, *rest, qterm, rowterm,
                                     b=b, metric=metric)
        gp = ref.ash_score_gather_ref(codes, cand, *rest, qterm, rowterm,
                                      b=b, metric=metric)
        tol_g = tol.gather(1, safe)
        ratio("ash_score_gather", g[live], gp[live], tol_g[live])
        check(bool(torch.isneginf(g[~live]).all()),
              f"m = {m}: kernel 3 pad ids not -inf")
        row_tol = torch.where(live, tol_g, 0.0).max(dim=1,
                                                    keepdim=True).values
        for k in ks:
            ts, tr = TK.ash_score_gather_topk_cuda(
                codes, cand, *rest, qterm, rowterm, b=b, k=k,
                metric=metric)
            vs, vp = ref.stable_top_k(g, k)
            exact[f"ash_score_gather_topk/R{cand.shape[1]}/k{k}"] = bool(
                torch.equal(ts, vs) and torch.equal(tr, cand.gather(1, vp)))
            ps, pp = ref.stable_top_k(gp, k)
            selection("ash_score_gather_topk", ts, tr, ps,
                      cand.gather(1, pp), want, row_tol)

    # the flat scan: kernels 1 and 2
    pl = index.payload
    flat, errs = flat_scan_check(index, queries[:m], (10, K), f"m = {m}")
    prep, args, qterm, rowterm, want, tol = (
        flat[k] for k in ("prep", "args", "qterm", "rowterm", "want", "tol"))
    out["ash_score"] = errs["max_err_over_bound"]
    out["ash_score_topk"] = max(t["max_err_over_bound"]
                                for t in errs["topk"].values())
    exact.update({f"ash_score_topk/k{k}": t["fused_equals_sorted"]
                  for k, t in errs["topk"].items()})
    del flat
    # the flat coarse scan: kernels 5 and 6, then its two shortlists
    cprep = ops._coarse_prep(prep, pl, index._state.coarse, None)
    cargs = ops._coarse_score_args(prep, cprep, pl)
    c = TK.ash_score_coarse_cuda(*cargs, qterm, rowterm, b=pl.b,
                                 metric=metric)
    cp = ref.ash_score_coarse_ref(*cargs, qterm, rowterm, b=pl.b,
                                  metric=metric)
    exact["ash_score_coarse"] = bool(torch.equal(c, cp))
    L = ops.DEFAULT_SHORTLIST
    fs, fi = TK.ash_score_coarse_topk_cuda(*cargs, qterm, rowterm, None,
                                           None, b=pl.b, k=L, metric=metric)
    vs, vi = ref.stable_top_k(cp, L)
    exact[f"ash_score_coarse_topk/k{L}"] = bool(
        torch.equal(fs, vs) and torch.equal(fi, vi.to(torch.int32)))
    _, deep = ref.stable_top_k(cp, RERANK)
    del c, cp
    for short, ks in ((fi, (10,)), (deep.to(torch.int32), ())):
        gathered(ops.sort_candidate_rows(short), args, qterm, rowterm,
                 want, tol, ks)
    del want, tol
    # the IVF candidate table: kernels 3 and 4
    st = ivf._state
    prep, args, qterm, rowterm, want, tol = scan_operands(
        model, ivf, st.payload, st.stats, queries[:m], metric)
    cand = IV.candidate_rows(st, IV._probe_lists(st, prep, NPROBE))
    gathered(cand, args, qterm, rowterm, want, tol, (10, K))
    del want, tol
    check(all(exact.values()), f"m = {m}: kernels != their plain "
                               f"versions: {exact}")
    return dict(max_err_over_bound=out, equal=exact)


def serving_phases(results, index, ivf, queries):
    """Phase 13 (13a-13e); returns the kernel launches and merges of
    13b's engine stream, by kernel name."""
    import threading

    import numpy as np
    import torch

    from repro_torch.index import AshIndex
    from repro_torch.kernels import ash_score as TK
    from repro_torch.serving import (
        BackgroundCompactor, EngineConfig, QueryEngine, ServingFrontend,
    )

    t_phase = time.perf_counter()
    qh = queries.cpu().numpy()  # clients hold their rows on the host
    n_q = qh.shape[0]
    out = {}

    # -- 13a. row invariance on the card: fresh prepares and searches of
    # rows alone, in 8 and 32 rows, against the same rows among 128
    routes = (
        ("flat_k100", index, dict(k=K)),
        ("flat_k10", index, dict(k=10)),
        ("flat_k10_rerank256", index, dict(k=10, rerank=RERANK)),
        ("ivf_k100", ivf, dict(k=K, nprobe=NPROBE)),
        ("ivf_k10_rerank256", ivf, dict(k=10, nprobe=NPROBE,
                                        rerank=RERANK)),
        ("flat_coarse_k10", index, dict(k=10, coarse="int8")),
        ("flat_coarse_k10_rerank256", index,
         dict(k=10, coarse="int8", rerank=RERANK)),
        ("ivf_coarse_k10", ivf, dict(k=10, nprobe=NPROBE, coarse="int8")),
    )
    q128 = queries[:128]
    parts = ((3, 1), (100, 1), (5, 8), (40, 32))  # (offset, rows)
    prep128 = index.prepare(q128)
    prep_same = all(
        torch.equal(getattr(index.prepare(q128[o:o + m]), f),
                    getattr(prep128, f)[o:o + m])
        for o, m in parts
        for f in ("q", "q_proj", "ip_q_landmarks", "q_sq_norm"))
    search_same = {}
    for name, idx, kw in routes:
        sb, ib = idx.search(q128, **kw)
        search_same[name] = all(
            torch.equal(s, sb[o:o + m]) and torch.equal(i, ib[o:o + m])
            for o, m in parts[:3]
            for s, i in [idx.search(q128[o:o + m], **kw)])
    # the engine's buckets run kernels 1-6 at 32 and 128 rows: each
    # against its plain version there, as phases 4 and 4b at 8 rows
    plain = {f"m{m}": kernels_at_rows(index, ivf, queries, m)
             for m in ENG_BUCKETS[1:]}
    out["13a_row_invariance"] = dict(prepare=prep_same, search=search_same,
                                     kernels_vs_plain=plain)
    check(prep_same, "prepare: rows alone != the same rows in a batch")
    check(all(search_same.values()),
          f"search: rows alone != the same rows in a batch: {search_same}")
    log("engine_row_invariance", **out["13a_row_invariance"])

    # -- 13b. engine parity under 32 concurrent clients ------------------
    mix = (
        ("flat", dict(k=10)), ("flat", dict(k=K)),
        ("flat", dict(k=10, rerank=RERANK)),
        ("flat", dict(k=10, coarse="int8")),
        ("flat", dict(k=10, coarse="int8", rerank=RERANK)),
        ("ivf", dict(k=10, nprobe=NPROBE)), ("ivf", dict(k=K, nprobe=NPROBE)),
        ("ivf", dict(k=10, nprobe=NPROBE, rerank=RERANK)),
        ("ivf", dict(k=10, nprobe=NPROBE, coarse="int8")),
    )
    indexes = {"flat": index, "ivf": ivf}
    eng = QueryEngine(indexes, EngineConfig(
        batch_buckets=ENG_BUCKETS, k_buckets=ENG_K_BUCKETS,
        row_budget=ENG_ROW_BUDGET))
    # the engine's fused calls, by (index, rerank, coarse): what each
    # route's kernel launches are held to
    calls, calls_lock = {}, threading.Lock()

    def counted(name, inner):
        def search_prepped(prep, **kw):
            key = (name, bool(kw.get("rerank")), kw.get("coarse"))
            with calls_lock:
                calls[key] = calls.get(key, 0) + 1
            return inner(prep, **kw)
        return search_prepped

    for name, idx in indexes.items():
        idx.search_prepped = counted(name, idx.search_prepped)
    log_b = [[] for _ in range(ENG_CLIENTS)]
    errors = []
    go = threading.Barrier(ENG_CLIENTS)

    def client(c):
        rng = np.random.RandomState(1300 + c)
        try:
            go.wait()
            for _ in range(ENG_REQUESTS):
                name, kw = mix[rng.randint(len(mix))]
                m = rng.randint(1, 9)
                o = rng.randint(0, n_q - m)
                t = fe.submit(qh[o:o + m], index=name, **kw)
                t.result(timeout=120.0)
                log_b[c].append((name, kw, o, m, t))
        except Exception as e:  # recorded, then failed below
            errors.append(repr(e))

    torch.cuda.synchronize()
    TK.reset_launch_counts()
    try:
        with ServingFrontend(eng) as fe:
            wall = _run_threads(ENG_CLIENTS, client)
            healthy = fe.healthy()
        torch.cuda.synchronize()
        launches = dict(TK.launch_counts)
        merges = dict(TK.merge_launches)
    finally:
        for idx in indexes.values():
            del idx.search_prepped  # back to the class's method
    snap = eng.stats.snapshot()
    tickets = [e for c in log_b for e in c]
    check(not errors, f"13b clients failed: {errors[:3]}")
    failed = sum(t.error is not None for *_, t in tickets)
    mismatched = [
        (name, kw, m) for name, kw, o, m, t in tickets
        if not _same(t.result(), indexes[name].search(queries[o:o + m],
                                                      **kw))]
    def n(name, rerank, coarse=None):
        return calls.get((name, rerank, coarse), 0)

    # each route's scan launches equal its fused engine calls, and each
    # fused scan launches one merge, counted under its own name.  A
    # shortlist of RERANK rows is above the fused selections' cap: the
    # rerank routes materialize (kernels 1 and 3, and kernel 5 for the
    # coarse pass of L = RERANK) and sort
    want = {"ash_score_topk": n("flat", False),
            "ash_score": n("flat", True),
            "ash_score_coarse_topk": n("flat", False, "int8"),
            "ash_score_coarse": n("flat", True, "int8"),
            "ash_score_gather_topk": (n("ivf", False) + n("ivf", False, "int8")
                                      + n("flat", False, "int8")),
            "ash_score_gather": n("ivf", True) + n("flat", True, "int8")}
    check(all(v > 0 for v in want.values()),
          f"13b: a kernel no fused engine call reaches: {want}")
    launches_ok = (all(launches[k] == v for k, v in want.items())
                   and all(merges[k] == launches[k] for k in merges)
                   and launches["ash_topk_merge"] == sum(merges.values()))
    out["13b_engine_parity"] = dict(
        clients=ENG_CLIENTS, requests=len(tickets),
        query_rows=sum(t.n_rows for *_, t in tickets), wall_s=wall,
        failed=failed, mismatched=len(mismatched), healthy=healthy,
        fused_calls={"/".join(map(str, k)): v for k, v in calls.items()},
        launches=launches, merges=merges, launches_equal_calls=launches_ok,
        stats={k: snap[k] for k in ("requests", "batches", "rows",
                                    "bucket_fill", "prep_hit_rate",
                                    "flushes", "ivf_cost",
                                    "unique_buckets")})
    log("engine_parity", **out["13b_engine_parity"])
    check(failed == 0 and healthy, f"13b: {failed} tickets failed, "
          f"frontend healthy={healthy}")
    check(not mismatched, f"13b: engine != direct search for "
          f"{len(mismatched)} tickets, e.g. {mismatched[:3]}")
    check(snap["batches"] < snap["requests"],
          f"13b: {snap['batches']} fused calls for {snap['requests']} "
          "requests")
    check(launches_ok, f"13b: launches {launches}, merges {merges}, "
          f"fused engine calls {calls}")

    # -- 13c. the degraded rung: pressure 1.0 lands on nprobe_min = 2 ----
    eng_c = QueryEngine(ivf, batch_buckets=ENG_BUCKETS,
                        k_buckets=ENG_K_BUCKETS, max_wait_s=60.0,
                        nprobe_min=2)
    tix = [eng_c.submit(qh[i:i + 1], k=10, nprobe=NPROBE)
           for i in range(16)]
    eng_c._flush_all("manual", pressure=1.0)
    rung_same = all(
        _same(t.result(), ivf.search(queries[i:i + 1], k=10, nprobe=2))
        for i, t in enumerate(tix))
    rung = sorted({t.stats.effective_nprobe for t in tix})
    out["13c_degraded_rung"] = dict(equal_to_direct_nprobe2=rung_same,
                                    effective_nprobe=rung)
    log("engine_degraded_rung", **out["13c_degraded_rung"])
    check(rung_same and rung == [2],
          f"13c: degraded flush {out['13c_degraded_rung']}")

    # -- 13d. mutations behind the frontend, a compactor swapping -------
    model, payload, raw = index.model, index.payload, index._state.raw
    live = AshIndex.from_parts(model, payload, raw=raw)
    twin = AshIndex.from_parts(model, payload, raw=raw)
    eng_m = QueryEngine(live, batch_buckets=ENG_BUCKETS,
                        k_buckets=ENG_K_BUCKETS, auto_compact=0.05)
    comp = BackgroundCompactor(eng_m, max_retries=10).start()
    log_d, resolutions, errors = [], [], []
    log_lock = threading.Lock()

    def worker(w):
        rng = np.random.RandomState(1400 + w)
        try:
            for i in range(MUT_OPS):
                if i % 20 == 3:  # 5 % adds of held-out rows
                    rows = qh[rng.randint(0, n_q, 4)]
                    with log_lock:
                        t = fe.submit_add(rows)
                        log_d.append(("add", rows, t))
                elif i % 20 == 13:  # 5 % deletes
                    with log_lock:
                        victims = rng.randint(0, live.next_id,
                                              MUT_DELETE_IDS)
                        t = fe.submit_delete(victims)
                        log_d.append(("del", victims, t))
                else:  # 90 % searches
                    m = rng.randint(1, 9)
                    o = rng.randint(0, n_q - m)
                    with log_lock:
                        t = fe.submit(qh[o:o + m], k=10)
                        log_d.append(("search", (o, m), t))
                t.add_done_callback(resolutions.append)
                t.result(timeout=120.0)
        except Exception as e:  # recorded, then failed below
            errors.append(repr(e))

    try:
        with ServingFrontend(eng_m) as fe:
            wall_d = _run_threads(MUT_THREADS, worker)
            swaps_mid = eng_m.stats.compact_runs
        comp.wait_idle(60.0)
    finally:
        comp.stop()
    check(not errors, f"13d workers failed: {errors[:3]}")
    lost = sum(not t.done for *_, t in log_d)
    twice = len(resolutions) - len(set(map(id, resolutions)))
    replay_bad = 0
    for kind, arg, t in log_d:  # the serial replay on the twin
        if kind == "add":
            twin.add(torch.from_numpy(arg))
        elif kind == "del":
            twin.delete(arg)
        else:
            o, m = arg
            replay_bad += not _same(t.result(), twin.search(
                queries[o:o + m], k=10))
    live.compact()
    twin.compact()
    fresh = AshIndex.from_parts(model, twin.payload, raw=twin._state.raw)
    s_l, i_l = live.search(q128, k=10)
    s_f, i_f = fresh.search(q128, k=10)
    fresh_same = bool(live.n == twin.n and torch.equal(s_l, s_f)
                      and torch.equal(i_l, torch.where(
                          i_f < 0, -1, twin._state.ids[i_f.clamp(min=0)
                                                       .long()])))
    snap_m = eng_m.stats.snapshot()
    out["13d_mutations"] = dict(
        threads=MUT_THREADS, submissions=len(log_d),
        adds=sum(e[0] == "add" for e in log_d),
        deletes=sum(e[0] == "del" for e in log_d), wall_s=wall_d,
        lost=lost, resolved_twice=twice,
        resolutions=len(resolutions), swaps_mid_stream=swaps_mid,
        compaction=snap_m["compaction"], replay_mismatched=replay_bad,
        n_after=live.n, equals_fresh_from_parts=fresh_same)
    log("engine_mutations", **out["13d_mutations"])
    check(lost == 0 and twice == 0 and len(resolutions) == len(log_d),
          f"13d: {lost} tickets lost, {twice} resolved twice")
    check(swaps_mid >= 1, "13d: no compactor swap during the stream")
    check(replay_bad == 0,
          f"13d: {replay_bad} searches != the serial replay")
    check(fresh_same, "13d: compacted index != from_parts over survivors")
    del live, twin, fresh, eng_m

    # -- 13e. closed loop: engine against direct search, same clients ---
    loops = {}
    for name, idx, kw in (("flat", index, {}),
                          ("ivf", ivf, dict(nprobe=NPROBE))):
        for C in LOOP_CLIENTS:
            per = max(LOOP_REQUESTS // C, LOOP_MIN)
            e = QueryEngine(idx, batch_buckets=ENG_BUCKETS,
                            k_buckets=ENG_K_BUCKETS)
            with ServingFrontend(e) as fe:
                row = dict(engine=_closed_loop(
                    C, per, lambda i: fe.search(qh[i:i + 1], k=10,
                                                timeout=120.0, **kw), n_q))
            s = e.stats.snapshot()  # the warm-up included: C rows
            row["engine"].update(
                kernel_launches_per_query=TK.kernel_launches()
                / row["engine"]["requests"],
                fused_calls=s["batches"], bucket_fill=s["bucket_fill"],
                prep_hit_rate=s["prep_hit_rate"], flushes={
                    r: v for r, v in s["flushes"].items() if v})
            row["direct"] = _closed_loop(
                C, per, lambda i: [t.cpu() for t in idx.search(
                    queries[i:i + 1], k=10, **kw)], n_q)
            row["direct"]["kernel_launches_per_query"] = \
                TK.kernel_launches() / row["direct"]["requests"]
            loops[f"{name}_C{C}"] = row
            log("engine_closed_loop", cell=f"{name}_C{C}", **row)
    # where an engine flush's time goes: PROF_FLUSHES fused calls of
    # PROF_BUCKET single-row requests each, against as many single-row
    # direct requests
    profiles = {}
    for name, idx, kw in (("flat", index, {}),
                          ("ivf", ivf, dict(nprobe=NPROBE))):
        e = QueryEngine(idx, batch_buckets=ENG_BUCKETS,
                        k_buckets=ENG_K_BUCKETS, max_wait_s=60.0)
        n_p = PROF_FLUSHES * PROF_BUCKET

        def flushes():
            for f in range(PROF_FLUSHES):
                for i in range(f * PROF_BUCKET, (f + 1) * PROF_BUCKET):
                    e.submit(qh[i % n_q:i % n_q + 1], k=10, **kw)
                e.flush()

        def direct():
            for i in range(n_p):
                [t.cpu() for t in idx.search(queries[i % n_q:i % n_q + 1],
                                             k=10, **kw)]

        profiles[name] = dict(engine=_profile(flushes, n_p),
                              direct=_profile(direct, n_p))
        profiles[name]["engine"]["bucket_fill"] = e.stats.snapshot()[
            "bucket_fill"]
        # the same flushes on a fresh engine (a cold prep cache again),
        # without the profiler: host ms a flush in each engine step
        e = QueryEngine(idx, batch_buckets=ENG_BUCKETS,
                        k_buckets=ENG_K_BUCKETS, max_wait_s=60.0)
        acc = {}
        for step in ("submit", "_prep_for", "_run_batch"):
            _timed(e, step, acc)
        _timed(idx, "search_prepped", acc)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flushes()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del idx.search_prepped
        ms = {k: v * 1e3 / PROF_FLUSHES for k, v in acc.items()}
        profiles[name]["engine_host_ms_per_flush"] = dict(
            wall=wall * 1e3 / PROF_FLUSHES,
            submits=ms["submit"], prep=ms["_prep_for"],
            search_enqueue=ms["search_prepped"],
            # the wait for the card, the copies and the scatter
            copy_and_resolve=(ms["_run_batch"] - ms["_prep_for"]
                              - ms["search_prepped"]))
    out["13e_closed_loop"] = loops
    out["13e_profile"] = profiles
    out["phase_seconds"] = time.perf_counter() - t_phase
    results["serving"] = out
    log("serving", closed_loop=loops, profile=profiles,
        phase_seconds=out["phase_seconds"])
    del eng, eng_c
    torch.cuda.empty_cache()
    return launches, merges


# -- the sharded and tiered backends (phases 14, 15) -----------------------
# phase 3's index placed two more ways: row shards (several logical
# shards on the one card; one shard per card where more are visible) and
# inverted lists in pinned host memory paged in by probe
SHARD_COUNTS = (4, 3)  # 10^6 rows: 4 divide, 3 leave 2 pad rows
SHARD_DELETE = 10_000  # 1 % of the rows
SHARD_ADD = 1_000
IDX_TIMED = 100  # timed 8-query requests a side for p50/p99
TIER_BUDGETS = (0, 64 << 20, 1 << 40)  # every probe pages; default; all
TIER_TIMED = 20  # timed requests a budget (a request at 0 pages ~0.4 GB)


class _Tally:
    """Kernel launches and merges of the calls made through
    :meth:`run` (the new backends' own searches; the flat and IVF
    searches they are compared with are not counted)."""

    def __init__(self):
        self.launches, self.merges = {}, {}

    def run(self, fn, *a, **kw):
        from repro_torch.kernels import ash_score as TK

        before, before_m = dict(TK.launch_counts), dict(TK.merge_launches)
        out = fn(*a, **kw)
        for tally, now, then in ((self.launches, TK.launch_counts, before),
                                 (self.merges, TK.merge_launches, before_m)):
            for name in now:
                tally[name] = tally.get(name, 0) + now[name] - then[name]
        return out


def _eq(a, b):
    import torch

    return bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))


def _latency(search, queries, n=IDX_TIMED):
    """Host-clock ms of ``n`` 8-query requests (synchronized), after
    three untimed ones: (p50, p99)."""
    import torch

    for r in range(3):
        search(queries[r * REQ_M:(r + 1) * REQ_M])
    lat = []
    for r in range(n):
        q = queries[(r % 100) * REQ_M:(r % 100 + 1) * REQ_M]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search(q)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return pct(lat, 50), pct(lat, 99)


def _shard_merge(flat, S, q, k, **kw):
    """Flat searches (``kw``: coarse, rerank) over ``from_parts`` of each
    of ``S`` shards' rows alone (its raw rows and tombstones), merged by
    a stable top-k of the union, rows mapped to the flat index's ids:
    the sharded result computed without the sharded backend (coarse and
    exact rerank run per shard, as the reference's)."""
    import torch

    from repro_torch.core.types import ASHPayload
    from repro_torch.index import AshIndex

    st, pay = flat._state, flat.payload
    nl = -(-pay.n // S)
    vals, rows = [], []
    for s in range(S):
        r0, r1 = s * nl, min((s + 1) * nl, pay.n)
        if r1 <= r0:
            continue
        part = ASHPayload(b=pay.b, d=pay.d, **{
            f: getattr(pay, f)[r0:r1] for f in ASHPayload.ARRAY_FIELDS})
        one = AshIndex.from_parts(
            flat.model, part, metric=flat.metric,
            raw=None if st.raw is None else st.raw[r0:r1])
        if st.live is not None:
            one.delete(torch.nonzero(~st.live[r0:r1])[:, 0].tolist())
        v, i = one.search(q, k=min(k, r1 - r0), **kw)
        vals.append(v)
        rows.append(torch.where(i < 0, -1, i + r0))
    v, i = torch.cat(vals, 1), torch.cat(rows, 1)
    o = torch.sort(torch.where(i < 0, 2**31 - 1, i), dim=1,
                   stable=True).indices
    v, i = v.gather(1, o), i.gather(1, o)
    o = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    v, i = v.gather(1, o), i.gather(1, o)
    if st.ids is not None:
        i = torch.where(i < 0, -1, st.ids[i.clamp(min=0).long()])
    return v, i.to(torch.int32)


def _sharded_equal(got, flat, S, q, kw):
    """A sharded result's gate: EQUAL to flat's, or with rerank (run per
    shard) EQUAL to the per-shard merge and an exact score at every rank
    at least flat's (a superset of flat's shortlist was reranked)."""
    if not kw.get("rerank"):
        return _eq(got, flat.search(q, **kw))
    return (_eq(got, _shard_merge(flat, S, q, **kw))
            and bool((got[0] >= flat.search(q, **kw)[0]).all()))


def _engine_equal(eng, idx, qh, routes, n_req=48):
    """Submit ``n_req`` requests of 1-8 rows over ``routes`` to an
    undriven engine, flush, and count tickets EQUAL to ``idx.search``."""
    import torch

    tickets = []
    for j in range(n_req):
        m = 1 + (j * 5) % 8
        off = (j * 37) % (qh.shape[0] - m)
        kw = routes[j % len(routes)]
        tickets.append((off, m, kw, eng.submit(qh[off:off + m], **kw)))
    eng.flush()
    equal = sum(_same(t.result(timeout=300),
                      idx.search(torch.from_numpy(qh[off:off + m]), **kw))
                for off, m, kw, t in tickets)
    return equal, len(tickets)


def sharded_phase(results, index, queries, tally):
    """Phase 14: the sharded backend over phase 3's payload, 4 and 3
    logical shards on the one card (and one per card where more are
    visible), held EQUAL to the flat backend, or with coarse and rerank
    (run per shard) to a merge of per-shard flat searches."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex
    from repro_torch.kernels import ash_score as TK
    from repro_torch.serving import QueryEngine

    t_phase = time.perf_counter()
    dev = index.model.device
    model, payload, raw = index.model, index.payload, index._state.raw
    q8, q1 = queries[:REQ_M], queries[3:4]
    out = {"shards": {}}
    routes = (dict(k=10), dict(k=K), dict(k=10, rerank=RERANK),
              dict(k=10, use_kernel=False))
    flats = {m: AshIndex.from_parts(model, payload, metric=m, raw=raw)
             for m in ("dot", "l2")}
    shd = {}
    for S in SHARD_COUNTS:
        for metric, flat in flats.items():
            sh, t_place = sync_time(
                AshIndex.from_parts, model, payload, backend="sharded",
                metric=metric, raw=raw, mesh=[dev] * S)
            rows = sh._state.shards
            check(sum(rows.n_valid) == N and rows.n_local == -(-N // S),
                  f"S={S}: shard geometry {rows.n_local} {rows.n_valid}")
            eq = {}
            for kw in routes:
                got = tally.run(sh.search, q8, **kw)
                alone = tally.run(sh.search, q1, **kw)
                eq[str(kw)] = [_sharded_equal(got, flat, S, q8, kw),
                               _eq(alone, tuple(t[3:4] for t in got))]
                check(all(eq[str(kw)]), f"S={S} {metric} {kw}: sharded "
                      f"!= flat (rerank: != per-shard merge or below "
                      f"flat) or a query alone != its batch row")
            if metric == "dot":
                # coarse keeps its shortlist per shard: EQUAL to flat
                # coarse searches of each shard's rows alone, merged
                for rr in (0, RERANK):
                    got = tally.run(sh.search, q8, k=10, coarse="int8",
                                    rerank=rr)
                    merged = _shard_merge(flat, S, q8, 10, coarse="int8",
                                          rerank=rr)
                    eq[f"coarse_k10_rerank{rr}_vs_merge"] = _eq(got, merged)
                    check(_eq(got, merged),
                          f"S={S} rerank={rr}: coarse != per-shard merge")
                shd[S] = sh
            out["shards"][f"S{S}_{metric}"] = dict(
                place_s=t_place, pad_rows=S * rows.n_local - N, equal=eq)
    sh4 = shd.pop(4)
    shd.clear()

    # launches on the fused route: S scans and S merges per request, plus
    # the one global merge (ash_score.launch_counts, merge_launches)
    n_req = 16
    torch.cuda.synchronize()
    before, before_m = dict(TK.launch_counts), dict(TK.merge_launches)
    for r in range(n_req):
        tally.run(sh4.search, queries[r * REQ_M:(r + 1) * REQ_M], k=K)
    scans = TK.launch_counts["ash_score_topk"] - before["ash_score_topk"]
    merges = TK.launch_counts["ash_topk_merge"] - before["ash_topk_merge"]
    under = (TK.merge_launches["ash_score_topk"]
             - before_m["ash_score_topk"])
    check(scans == 4 * n_req and under == 4 * n_req
          and merges == 5 * n_req,
          f"fused sharded launches: {scans} scans, {under} shard merges, "
          f"{merges} merges for {n_req} requests of 4 shards")
    out["fused_launches"] = dict(requests=n_req, scans=scans,
                                 shard_merges=under, merges=merges)

    # deletes, add, compact: EQUAL to a flat twin with the same mutations
    # (rerank: to the twin's per-shard merge)
    flat_m = AshIndex.from_parts(model, payload, metric="dot", raw=raw)
    sh_m = AshIndex.from_parts(model, payload, backend="sharded",
                               raw=raw, mesh=[dev] * 3)
    victims = np.random.default_rng(14).choice(N, SHARD_DELETE,
                                               replace=False)
    check(sh_m.delete(victims) == flat_m.delete(victims) == SHARD_DELETE,
          "sharded delete count")
    new = embedding_dataset(SHARD_ADD, DIM, seed=14, device=dev)
    mut = {}
    for step in ("deleted", "added", "compacted"):
        if step == "added":
            sh_m.add(new)
            flat_m.add(new)
        elif step == "compacted":
            sh_m.compact()
            flat_m.compact()
        mut[step] = all(_sharded_equal(tally.run(sh_m.search, q8, **kw),
                                       flat_m, 3, q8, kw)
                        for kw in routes[:3])
        check(mut[step], f"sharded != flat after the {step} step")
    check(sh_m.n == flat_m.n == N - SHARD_DELETE + SHARD_ADD,
          "sharded rows after compaction")
    out["mutations"] = mut
    del flat_m, sh_m

    # behind a QueryEngine: every ticket EQUAL to direct search
    eng = QueryEngine(sh4, batch_buckets=ENG_BUCKETS,
                      k_buckets=ENG_K_BUCKETS, max_wait_s=60.0)
    eq_t, n_t = tally.run(_engine_equal, eng, sh4, queries.cpu().numpy(),
                          (dict(k=10), dict(k=K), dict(k=10, rerank=RERANK)))
    check(eq_t == n_t, f"sharded engine: {n_t - eq_t} of {n_t} tickets "
                       "differ from direct search")
    out["engine"] = dict(tickets=n_t, equal=eq_t,
                         fused_calls=eng.stats.snapshot()["batches"])

    # save and load: bit-identical
    save_dir = ROOT / "build" / "chip_smoke" / "sharded"
    shutil.rmtree(save_dir, ignore_errors=True)
    try:
        sh4.save(save_dir)
        back = AshIndex.load(save_dir, device=dev, mesh=[dev] * 4)
        same = [_eq(back.search(q8, **kw), sh4.search(q8, **kw))
                for kw in routes[:3]]
        check(all(same) and back._state.axes == ("data",),
              f"sharded save/load changed results {same}")
    finally:
        shutil.rmtree(save_dir.parent, ignore_errors=True)
    out["save_load_bit_identical"] = same

    # reported: 8-query k = 100 requests, 4 shards against flat
    flat = flats["dot"]
    p = {}
    for name, fn in (("flat", lambda q: flat.search(q, k=K)),
                     ("sharded4", lambda q: sh4.search(q, k=K)),
                     ("sharded4_again", lambda q: sh4.search(q, k=K)),
                     ("flat_again", lambda q: flat.search(q, k=K))):
        p[name] = dict(zip(("p50_ms", "p99_ms"),
                           tally.run(_latency, fn, queries)
                           if name.startswith("sharded")
                           else _latency(fn, queries)))
    out["latency_k100"] = p
    out["profile_sharded4"] = tally.run(
        profile_requests, lambda q: sh4.search(q, k=K), queries)
    out["profile_flat"] = profile_requests(lambda q: flat.search(q, k=K),
                                           queries)

    # one shard per card, where more than one card is visible
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        mesh = [torch.device("cuda", i) for i in range(n_dev)]
        shm = AshIndex.from_parts(model, payload, backend="sharded",
                                  raw=raw, mesh=mesh)
        same = [_sharded_equal(tally.run(shm.search, q8, **kw), flat,
                               n_dev, q8, kw) for kw in routes]
        check(all(same), f"one shard per card != flat {same}")
        res = shm.search(q8, k=K)
        torch.cuda.synchronize()
        parts = [torch.empty(REQ_M, K, device=d) for d in mesh[1:]]
        gather_ms = event_ms(lambda: [t.to(mesh[0]) for t in parts])
        out["per_card"] = dict(
            cards=n_dev, equal=same, gather_ms=gather_ms,
            latency_k100=dict(zip(("p50_ms", "p99_ms"), tally.run(
                _latency, lambda q: shm.search(q, k=K), queries))),
            result_device=str(res[1].device))
    else:
        out["per_card"] = "skipped: one card visible"
        print("phase 14: one shard per card skipped (one card visible)",
              flush=True)
    out["phase_seconds"] = time.perf_counter() - t_phase
    results["sharded"] = out
    log("sharded", **{k: v for k, v in out.items() if k != "shards"},
        shards={k: {kk: vv for kk, vv in v.items() if kk != "equal"}
                for k, v in out["shards"].items()})


def tiered_phase(results, ivf, queries, tally):
    """Phase 15: phase 3's IVF index as backend="tiered_ivf" at three
    hot-set budgets, held EQUAL to backend="ivf" at equal probe sets."""
    import numpy as np
    import torch

    from repro_torch.index import AshIndex
    from repro_torch.index import tiered as T
    from repro_torch.index.tiered import TieredIVFBackend, TieredState
    from repro_torch.serving import QueryEngine

    t_phase = time.perf_counter()
    dev = ivf.model.device
    q8 = queries[:REQ_M]
    routes = (dict(k=K, nprobe=NPROBE), dict(k=10, rerank=RERANK),
              dict(k=10, coarse="int8"), dict(k=10, nprobe=64))
    out = {"budgets": {}}
    tiers = {}
    for hot in TIER_BUDGETS:
        state, t_host = sync_time(TieredState.from_ivf, ivf._state, hot)
        tv = AshIndex("tiered_ivf", "dot", state)
        tiers[hot] = tv
        eq, transfers_ok = {}, True
        for r, kw in enumerate(routes * 2):
            q = queries[(r + 1) * REQ_M:(r + 2) * REQ_M]
            before = TieredIVFBackend.tier_stats(state)
            got = tally.run(tv.search, q, **kw)
            after = TieredIVFBackend.tier_stats(state)
            missed = after["misses"] > before["misses"]
            moved = after["transfers"] - before["transfers"]
            transfers_ok &= moved == (1 if missed else 0)
            eq[f"{r}:{kw}"] = _eq(got, ivf.search(q, **kw))
            check(eq[f"{r}:{kw}"], f"hot={hot} {kw}: tiered != ivf")
        check(transfers_ok, f"hot={hot}: a search that missed made other "
                            "than one transfer")
        if hot == TIER_BUDGETS[-1]:
            tally.run(tv.search, q8, k=10, nprobe=64)  # every list warm
            before = TieredIVFBackend.tier_stats(state)
            for r in range(8):
                tally.run(tv.search, queries[r * REQ_M:(r + 1) * REQ_M],
                          k=K, nprobe=NPROBE)
            after = TieredIVFBackend.tier_stats(state)
            check(after["transfers"] == before["transfers"]
                  and after["resident_lists"] == after["nlist"],
                  f"covering budget paged after warm-up: {after}")
        # reported: paged bytes a request and p50 against HBM IVF
        s0 = TieredIVFBackend.tier_stats(state)
        lat = tally.run(_latency, lambda q: tv.search(q, k=K, nprobe=NPROBE),
                        queries, TIER_TIMED)
        s1 = TieredIVFBackend.tier_stats(state)
        n_req = TIER_TIMED + 3  # _latency's warm-up requests too
        out["budgets"][str(hot)] = dict(
            host_s=t_host, equal=all(eq.values()), one_transfer=transfers_ok,
            paged_bytes_per_request=(s1["paged_bytes"] - s0["paged_bytes"])
            / n_req,
            transfers_per_request=(s1["transfers"] - s0["transfers"]) / n_req,
            p50_ms=lat[0], p99_ms=lat[1], tier=s1)
    out["ivf_latency_k100"] = dict(zip(("p50_ms", "p99_ms"), _latency(
        lambda q: ivf.search(q, k=K, nprobe=NPROBE), queries, TIER_TIMED)))

    # the batched copy against a plain pinned copy of the same bytes
    state = TieredState.from_ivf(ivf._state, 0)
    lists = list(range(state.nlist))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = state.fetch_blocks(lists)
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    nbytes = sum(t.nbytes for b in blocks.values() for t in b)
    pin = dev.type == "cuda"
    bufs = T.pack_blocks([state._host_block(c) for c in lists], pin=pin)[0]
    copy_ms = event_ms(lambda: bufs.to(dev, non_blocking=True), iters=5,
                       warmup=1)
    plain = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
    plain_ms = event_ms(lambda: plain.to(dev, non_blocking=True), iters=5,
                        warmup=1)
    out["copy"] = dict(
        bytes=nbytes, fetch_all_s=fetch_s,
        fetch_all_gbs=nbytes / fetch_s / 1e9,
        batched_copy_gbs=bufs.numel() / copy_ms / 1e6,
        plain_pinned_copy_gbs=nbytes / plain_ms / 1e6)
    del blocks, bufs, plain, state

    # tombstones: 1 % of the rows deleted on both
    victims = np.random.default_rng(15).choice(N, 10_000, replace=False)
    tv = tiers[TIER_BUDGETS[1]]
    check(tv.delete(victims) == ivf.delete(victims) == 10_000,
          "tiered delete count")
    dead = [_eq(tally.run(tv.search, q8, **kw), ivf.search(q8, **kw))
            for kw in routes]
    check(all(dead), f"tiered != ivf with tombstones {dead}")
    out["tombstones_equal"] = dead

    # behind a QueryEngine: tickets EQUAL, the tier gauge, the paging bill
    eng = QueryEngine(tv, batch_buckets=ENG_BUCKETS,
                      k_buckets=ENG_K_BUCKETS, max_wait_s=60.0,
                      row_budget=ENG_ROW_BUDGET, page_row_cost=2.0)
    eq_t, n_t = tally.run(_engine_equal, eng, tv, queries.cpu().numpy(),
                          (dict(k=10), dict(k=K), dict(k=10, rerank=RERANK)))
    check(eq_t == n_t, f"tiered engine: {n_t - eq_t} of {n_t} tickets "
                       "differ from direct search")
    snap = eng.stats.snapshot()
    check("tier" in snap and "default" in snap["tier"], "no tier gauge")
    live = eng._live_list_sizes("default", tv)
    billed = eng._billed_list_sizes("default", tv)
    resident = TieredIVFBackend.resident_mask(tv._state)
    want = np.where(resident, live, np.ceil(live * 2.0).astype(np.int64))
    check(np.array_equal(billed, want) and (~resident).any(),
          "cold lists not billed at page_row_cost")
    out["engine"] = dict(tickets=n_t, equal=eq_t, tier=snap["tier"],
                         cold_lists=int((~resident).sum()))
    out["profile_tiered_64mib"] = tally.run(
        profile_requests, lambda q: tv.search(q, k=K, nprobe=NPROBE),
        queries)
    out["phase_seconds"] = time.perf_counter() - t_phase
    results["tiered"] = out
    log("tiered", **{k: v for k, v in out.items()
                     if k not in ("engine",)})


# -- durability and the launcher (phases 16, 17) ----------------------------
# phase 3's model and payload under a write-ahead log: crashes at every
# fault point (16a), full-size traffic with background checkpoints and
# recovery on the card (16b); then the serving launcher as child
# processes (17)
DUR_ROWS = 100_000  # 16a: the crash matrix's index rows
DUR_CLIENTS, DUR_ITERS = 8, 50  # 16b: threads, iterations each
DUR_MUT_P = 0.5  # 16b: a mutation after every other search (~200)
DUR_SMALL_ITERS = 10  # 16b: sharded and tiered cycles
DUR_COMPACT = 0.0003  # 16b: ~300 dead rows trigger a compaction
DUR_TAIL = 20  # 16b: mutations after the traffic, replayed by recovery
DUR_HOT = 64 << 20  # 16b: the tiered cycle's hot set
DUR_SHARDS = 4
DUR_APPENDS = 200  # 16b: timed appends a fsync policy
DUR_QPS_CLIENTS, DUR_QPS_ITERS = 32, 40  # 16b: engine QPS with/without log
SERVE_N, SERVE_SMALL_N = 1_000_000, 100_000  # 17a-d; 17e
SERVE_TIMEOUT = 300  # seconds a launcher run may take
SERVE_DEVICE = "cuda"


def _crash_cases(faults, points):
    """The reference's crash matrix: every point at its first hit, the
    WAL and engine points also at their third, two torn appends."""
    cases = []
    for name in sorted(points):
        cases.append((name, faults.Crash(at=1)))
        if name.startswith(("wal.", "engine.")):
            cases.append((name, faults.Crash(at=3)))
    cases.append(("wal.append", faults.Torn(at=2, fraction=0.3)))
    cases.append(("wal.append", faults.Torn(at=4, fraction=0.8)))
    return cases


def _dur_routes(backend):
    """Searches that hold a recovered index: kernels 2, 1, 6 -> 4 and
    5 -> 3 on the flat placements, 4 and 3 on the IVF ones."""
    if backend in ("ivf", "tiered_ivf"):
        return (dict(k=K, nprobe=NPROBE),
                dict(k=10, nprobe=NPROBE, rerank=RERANK))
    return (dict(k=K), dict(k=10, rerank=RERANK), dict(k=10, coarse="int8"),
            dict(k=10, coarse="int8", rerank=RERANK))


def _replay(idx, muts):
    """Apply ``muts`` one at a time (the serial replay): ("add", rows,
    logged ids or None) or ("del", ids)."""
    for m in muts:
        if m[0] == "add":
            got = idx.stage_add(m[1])
            check(m[2] is None or bool((got == m[2]).all()),
                  "serial replay assigned other ids than the log")
            idx.apply_pending()
        else:
            idx.delete(m[1])
    return idx


def _dur_drive(durable, eng, pool, faults, plan, n0, steps=8):
    """The reference's crash script on an undriven engine: 8 mutations
    (55 % 8-row adds of pool rows, else 4-id deletes), a checkpoint
    before the fifth.  (muts, acked, crashed)."""
    import numpy as np

    rng = np.random.RandomState(1234)
    muts, acked, crashed = [], [], False
    try:
        with faults.active(plan):
            for step in range(steps):
                if step == steps // 2:
                    durable.checkpoint(barrier=eng.mutation_barrier())
                total = n0 + 8 * sum(1 for m in muts if m[0] == "add")
                if rng.rand() < 0.55:
                    rows = pool[rng.randint(0, len(pool), 8)]
                    muts.append(("add", rows, None))
                    t = eng.submit_add(rows)
                else:
                    victims = rng.randint(0, total, 4)
                    muts.append(("del", victims))
                    t = eng.submit_delete(victims)
                t.result()
                acked.append((len(muts) - 1, t))
    except faults.SimulatedCrash:
        crashed = True
    durable.wal.close()
    return muts, acked, crashed


def durability_phase(results, index, queries, tally):
    """Phase 16: phase 3's model and payload under a write-ahead log on
    the card; every recovery EQUAL to the serial replay of its durable
    prefix."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.core.types import ASHPayload
    from repro_torch.index import AshIndex
    from repro_torch.serving import (
        BackgroundCompactor, DurableIndex, QueryEngine, ServingFrontend,
        WriteAheadLog,
    )
    from repro_torch.testing import faults

    t_phase = time.perf_counter()
    out = {}
    model, payload, raw = index.model, index.payload, index._state.raw
    dev = model.device
    pool = queries.cpu().numpy()  # rows the adds ingest
    q8 = queries[:REQ_M]
    points = {p.name for p in faults.points()}
    check(len(points) == 11, f"fault points {sorted(points)}")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ash-durability-"))

    def copy_of(backend, n=None, **opts):
        """A fresh index over phase 3's model and (the first n rows
        of) its payload: new state objects over shared tensors."""
        p, r = payload, raw
        if n is not None:
            p = ASHPayload(b=payload.b, d=payload.d, **{
                f: getattr(payload, f)[:n] for f in ASHPayload.ARRAY_FIELDS})
            r = raw[:n]
        return AshIndex.from_parts(model, p, backend=backend, raw=r, **opts)

    def equal(rec, twin, backend):
        return all(_eq(tally.run(rec.search, q8, **kw), twin.search(q8, **kw))
                   for kw in _dur_routes(backend))

    try:
        # -- 16a: the crash matrix at the first 10^5 rows -----------------
        t0 = time.perf_counter()
        matrix = []
        for backend in ("flat", "ivf"):
            for point, action in _crash_cases(faults, points):
                root = tmp / f"a{len(matrix)}"
                idx = copy_of(backend, DUR_ROWS)
                dur = DurableIndex.create(idx, root, fsync="always")
                eng = QueryEngine(idx)
                eng.attach_durability(dur)
                muts, acked, crashed = _dur_drive(
                    dur, eng, pool, faults, {point: action}, DUR_ROWS)
                rec = DurableIndex.open(root, fsync="always",
                                        index_opts={"device": dev})
                n_dur = rec.report.last_seqno
                case = f"{backend} {point} {type(action).__name__}@{action.at}"
                check(crashed or n_dur == len(muts),
                      f"{case}: clean run lost records")
                check(all(t.wal_seqno == pos + 1 <= n_dur
                          for pos, t in acked),
                      f"{case}: an acknowledged mutation is outside the "
                      f"durable prefix ({n_dur})")
                twin = _replay(copy_of(backend, DUR_ROWS), muts[:n_dur])
                check(equal(rec.index, twin, backend),
                      f"{case}: recovery differs from the serial replay")
                rec.close()
                matrix.append(dict(backend=backend, point=point,
                                   action=f"{type(action).__name__}"
                                          f"@{action.at}",
                                   crashed=crashed, acked=len(acked),
                                   durable=n_dur,
                                   replayed=rec.report.replayed_adds
                                   + rec.report.replayed_deletes))
                shutil.rmtree(root)
        out["16a"] = dict(cases=len(matrix), seconds=time.perf_counter() - t0,
                          crashed=sum(c["crashed"] for c in matrix),
                          matrix=matrix)
        log("durability_matrix", cases=len(matrix),
            crashed=out["16a"]["crashed"], seconds=out["16a"]["seconds"])

        # -- 16b: full size, concurrent traffic, recovery -----------------
        def cycle(name, backend, iters, load_opts=None, **opts):
            root = tmp / f"b-{name}"
            idx = copy_of(backend, **opts)
            dur, t_create = sync_time(DurableIndex.create, idx, root,
                                      fsync="interval")
            ckpt0 = sum(f.stat().st_size for f in root.glob("ckpt-*/*"))
            eng = QueryEngine(idx, batch_buckets=(8, 32, 128),
                              k_buckets=(10, 100), auto_compact=DUR_COMPACT)
            eng.attach_durability(dur)
            comp = BackgroundCompactor(eng).start()
            log_lock, tickets, errors = threading.Lock(), [], []
            route = _dur_routes(backend)[0]

            def client(c):
                rng = np.random.RandomState(100 + c)
                try:
                    for _ in range(iters):
                        o = rng.randint(0, len(pool) - REQ_M)
                        fe.search(pool[o:o + REQ_M], timeout=120.0, **route)
                        if rng.rand() >= DUR_MUT_P:
                            continue
                        if rng.rand() < 0.5:
                            rows = pool[rng.randint(0, len(pool), 8)]
                            t, m = fe.submit_add(rows), ["add", rows]
                        else:
                            ids = rng.randint(0, idx.next_id, 8)
                            t, m = fe.submit_delete(ids), ["del", ids]
                        t.result(120.0)
                        with log_lock:
                            tickets.append((t, m))
                except Exception as e:  # recorded, then failed below
                    errors.append(repr(e))

            def traffic():
                nonlocal fe
                with ServingFrontend(eng) as fe:
                    _run_threads(DUR_CLIENTS, client)
                check(comp.wait_idle(300.0), f"{name}: compactor busy")
                comp.stop()

            fe = None
            _, t_traffic = sync_time(tally.run, traffic)
            check(not errors, f"{name}: client failed: {errors[:2]}")
            # a tail of mutations past the last checkpoint, so that
            # recovery replays at least DUR_TAIL + 1 records
            rng = np.random.RandomState(7)
            for j in range(DUR_TAIL):
                if j % 2 == 0:
                    m = ["add", pool[rng.randint(0, len(pool), 8)]]
                    t = eng.submit_add(m[1])
                else:
                    m = ["del", rng.randint(0, idx.next_id, 8)]
                    t = eng.submit_delete(m[1])
                t.result()
                tickets.append((t, m))
            stats = dur.stats()
            # one more add: logged, then the process dies before it
            # applies (its ticket never resolves)
            crash_rows = pool[:8]
            with faults.active({"engine.apply.logged": faults.Crash(at=1)}):
                tc = eng.submit_add(crash_rows)
                try:
                    tc.result()
                    crashed = False
                except faults.SimulatedCrash:
                    crashed = True
            check(crashed and tc.wal_seqno is not None,
                  f"{name}: the crash did not fire after logging")
            dur.wal.close()
            del eng, comp, idx, dur
            torch.cuda.synchronize()
            rec, t_open = sync_time(DurableIndex.open, root,
                                    index_opts={"device": dev,
                                                **(load_opts or {})})
            rep = rec.report
            check(rep.last_seqno == tc.wal_seqno,
                  f"{name}: recovered through {rep.last_seqno}, logged "
                  f"{tc.wal_seqno}")
            check(rep.checkpoint_seqno == stats["checkpoint_seqno"],
                  f"{name}: recovered from checkpoint "
                  f"{rep.checkpoint_seqno}, last written "
                  f"{stats['checkpoint_seqno']}")
            # the serial replay: every logged mutation in seqno order
            log_order = sorted(
                [(t.wal_seqno, m[0], m[1], t.ids) for t, m in tickets]
                + [(tc.wal_seqno, "add", crash_rows, tc.ids)],
                key=lambda r: r[0])
            muts = [(k, a, ids) if k == "add" else (k, a)
                    for _, k, a, ids in log_order]
            twin, t_twin = sync_time(
                lambda: _replay(copy_of(backend, **opts), muts))
            same = equal(rec.index, twin, backend)
            check(same, f"{name}: recovery differs from the serial replay")
            n_rec = rep.replayed_adds + rep.replayed_deletes
            res = dict(
                backend=backend, mutations=len(tickets) + 1,
                records=int(tc.wal_seqno), traffic_s=t_traffic,
                create_s=t_create, checkpoint0_gb=ckpt0 / 1e9,
                checkpoint0_gb_s=ckpt0 / 1e9 / t_create,
                checkpoints=stats["checkpoints"],
                checkpoint_seqno=rep.checkpoint_seqno,
                replayed_adds=rep.replayed_adds,
                replayed_deletes=rep.replayed_deletes,
                open_s=t_open, load_s=rep.load_s, replay_s=rep.replay_s,
                records_per_s=n_rec / max(rep.replay_s, 1e-9),
                serial_replay_s=t_twin, equal=same)
            rec.close()
            del rec, twin
            torch.cuda.empty_cache()
            shutil.rmtree(root)
            log("durability_cycle", name=name, **res)
            return res

        cycles = {
            "flat": cycle("flat", "flat", DUR_ITERS),
            "ivf": cycle("ivf", "ivf", DUR_ITERS),
            "sharded": cycle("sharded", "sharded", DUR_SMALL_ITERS,
                             load_opts=dict(mesh=[dev] * DUR_SHARDS),
                             mesh=[dev] * DUR_SHARDS),
            "tiered_ivf": cycle("tiered_ivf", "tiered_ivf", DUR_SMALL_ITERS,
                                load_opts=dict(hot_bytes=DUR_HOT),
                                hot_bytes=DUR_HOT),
        }
        for name in ("flat", "ivf"):
            check(cycles[name]["checkpoints"] >= 2,
                  f"{name}: no compactor checkpoint during the traffic")
        out["16b"] = cycles

        # a timed checkpoint of the full flat index (the bytes a
        # card-resident index copies to the host and writes)
        root = tmp / "timed"
        idx = copy_of("flat")
        dur = DurableIndex.create(idx, root, fsync="interval")
        idx.delete([0])  # one logged mutation: the next checkpoint writes
        dur.log_delete([0])
        _, t_ckpt = sync_time(dur.checkpoint)
        nbytes = sum(f.stat().st_size
                     for f in (root / f"ckpt-{1:020d}").glob("*"))
        check(nbytes > 0, "the timed checkpoint wrote nothing")
        dur.close()
        shutil.rmtree(root)
        out["checkpoint"] = dict(seconds=t_ckpt, gb=nbytes / 1e9,
                                 gb_s=nbytes / 1e9 / t_ckpt)

        # append latency of one 8-row add record under each fsync policy
        appends = {}
        rows8 = pool[:8]
        for policy in ("always", "interval", "off"):
            wal = WriteAheadLog(tmp / f"wal-{policy}", fsync=policy)
            lat = []
            for i in range(DUR_APPENDS):
                t0 = time.perf_counter()
                wal.append_add(rows8, np.arange(8 * i, 8 * i + 8))
                lat.append((time.perf_counter() - t0) * 1e3)
            appends[policy] = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99),
                                   fsyncs=wal.stats()["fsyncs"])
            wal.close()
        out["append"] = appends

        # engine QPS at C = 32 with and without a log, same traffic
        def engine_qps(with_log):
            idx = copy_of("flat")
            eng = QueryEngine(idx, batch_buckets=(8, 32, 128),
                              k_buckets=(10, 100))
            dur = None
            if with_log:
                dur = DurableIndex.create(idx, tmp / "qps", fsync="interval")
                eng.attach_durability(dur)
            errors = []

            def client(c):
                rng = np.random.RandomState(500 + c)
                try:
                    for _ in range(DUR_QPS_ITERS):
                        o = rng.randint(0, len(pool) - REQ_M)
                        fe.search(pool[o:o + REQ_M], k=10, timeout=120.0)
                        if rng.rand() < 0.1:
                            fe.submit_add(pool[o:o + 8]).result(120.0)
                        elif rng.rand() < 0.1:
                            fe.submit_delete(
                                rng.randint(0, N, 8)).result(120.0)
                except Exception as e:  # recorded, then failed below
                    errors.append(repr(e))

            with ServingFrontend(eng) as fe:
                wall = _run_threads(DUR_QPS_CLIENTS, client)
            check(not errors, f"QPS client failed: {errors[:2]}")
            if dur is not None:
                dur.close()
                shutil.rmtree(tmp / "qps")
            return DUR_QPS_CLIENTS * DUR_QPS_ITERS * REQ_M / wall

        engine_qps(False)  # warm-up: bucket shapes, allocator
        qps = [engine_qps(False), engine_qps(True), engine_qps(True),
               engine_qps(False)]
        out["engine_qps"] = dict(
            clients=DUR_QPS_CLIENTS, without_log=[qps[0], qps[3]],
            with_log_interval=[qps[1], qps[2]])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    results["durability"] = out
    log("durability", **{k: v for k, v in out.items() if k not in ("16a",)})


def _serve_cmd(args):
    """(argv, env) of ``python -m repro_torch.launch.serve ARGS`` run
    from this checkout's ``src``, unbuffered."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PYTHONUNBUFFERED": "1"}
    return [sys.executable, "-m", "repro_torch.launch.serve",
            *map(str, args), "--device", SERVE_DEVICE], env


def _serve_run(args, timeout=SERVE_TIMEOUT):
    """The launcher in a child process: (exit code, stdout and stderr,
    seconds, {tag: [stdout lines]})."""
    cmd, env = _serve_cmd(args)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr, \
        time.perf_counter() - t0, _tags(proc.stdout)


def _tags(stdout):
    tags = {}
    for ln in stdout.splitlines():
        if ln.startswith("[") and "]" in ln:
            tags.setdefault(ln[:ln.index("]") + 1], []).append(ln)
    return tags


def _serve_numbers(tags):
    """QPS, p50/p99 ms, recall and kernel launches of a launcher run."""
    import re

    out = {}
    m = re.search(r"\(([0-9.]+) QPS on ", " ".join(tags.get("[serve]", [])))
    if m:
        out["qps"] = float(m.group(1))
    m = re.search(r"p50=([0-9.]+)ms p99=([0-9.]+)ms",
                  " ".join(tags.get("[latency]", [])))
    if m:
        out["p50_ms"], out["p99_ms"] = float(m.group(1)), float(m.group(2))
    m = re.search(r"10-recall@10=([0-9.]+) 10-recall@100=([0-9.]+)",
                  " ".join(tags.get("[recall]", [])))
    if m:
        out["recall10"], out["recall100"] = m.group(1), m.group(2)
    if "[launches]" in tags:
        line = tags["[launches]"][-1]
        out["launches"] = json.loads(line[len("[launches] "):
                                          line.index(" (kernel")])
    return out


def launcher_phase(results, launches):
    """Phase 17: ``python -m repro_torch.launch.serve`` on the card as
    child processes: a WAL run and its recovery, recall and HTTP answers
    against direct search of the saved index, and the concurrent,
    sharded and tiered modes.  Adds each run's kernel launches to
    ``launches``."""
    import re
    import signal
    import socket
    import tempfile
    import threading
    import urllib.request

    import torch

    from repro_torch.index import AshIndex, recall_curve
    from repro_torch.index import metrics as MET
    from repro_torch.launch import serve as SV

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ash-serve-"))
    wal_dir, save_dir = tmp / "wal", tmp / "idx"
    runs = {}

    def run(name, args, need):
        rc, text, secs, tags = _serve_run(args)
        check(rc == 0, f"17{name}: exit {rc}: {text[-2000:]}")
        missing = [t for t in need if t not in tags]
        check(not missing, f"17{name}: no {missing} line: {text[-2000:]}")
        nums = _serve_numbers(tags)
        for k, v in nums.pop("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = dict(seconds=secs, **nums)
        log("launcher", run=name, **runs[name])
        return tags

    big = ["--n", SERVE_N, "--dim", DIM, "--bits", 2, "--reduce", 2,
           "--landmarks", 64, "--queries", 1000, "--req-batch", 8]
    try:
        # 17a/b: a WAL run over IVF with mutations, then its recovery
        wal_args = big + ["--engine", "ivf", "--nprobe", NPROBE,
                          "--mutate-fraction", 0.1, "--wal", wal_dir,
                          "--fsync", "always"]
        tags = run("a", wal_args, ("[wal]", "[serve]", "[latency]",
                                   "[mutations]", "[checkpoint]"))
        seq = int(re.search(r"seq=(\d+)", tags["[checkpoint]"][0]).group(1))
        tags = run("b", wal_args, ("[recovery]", "[serve]", "[checkpoint]"))
        m = re.search(r"checkpoint seq=(\d+) replayed=(\d+) adds/(\d+) dels",
                      tags["[recovery]"][0])
        check(m is not None and m.groups() == (str(seq), "0", "0"),
              f"17b: recovery {tags['[recovery]'][0]!r} after a final "
              f"checkpoint at seq={seq}")
        runs["b"]["recovery"] = tags["[recovery]"][0]
        # 17c: flat, recall against direct search of the saved index
        flat_args = big + ["--engine", "flat", "--save-dir", save_dir]
        tags = run("c", flat_args, ("[serve]", "[latency]", "[recall]",
                                    "[save]"))
        X, Q = SV.dataset(SERVE_N, DIM, 1000, 0, SERVE_DEVICE)
        _, gt = MET.exact_topk(Q, X, k=10)
        del X
        saved = AshIndex.load(save_dir, device=SERVE_DEVICE)
        ids = torch.cat([saved.search(Q[i:i + 8], k=100, nprobe=NPROBE)[1]
                         for i in range(0, 1000, 8)])
        rec = recall_curve(ids.cpu(), gt.cpu(), Rs=(10, 100))
        direct = (f"{rec[10]:.4f}", f"{rec[100]:.4f}")
        check((runs["c"]["recall10"], runs["c"]["recall100"]) == direct,
              f"17c: printed recall {runs['c']} != direct search {direct}")
        runs["c"]["direct_recall"] = direct
        # 17d: the HTTP API, then SIGINT
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd, env = _serve_cmd(flat_args + ["--http", port])
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines, ready = [], threading.Event()

        def reader():
            for ln in proc.stdout:
                lines.append(ln)
                if ln.startswith("[http] POST"):
                    ready.set()

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            check(ready.wait(SERVE_TIMEOUT),
                  f"17d: the server did not start: {''.join(lines)[-2000:]}")
            t_ready = time.perf_counter() - t0
            url = f"http://127.0.0.1:{port}"
            body = json.dumps({"queries": Q[:8].cpu().tolist(),
                               "k": 10}).encode()
            t1 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    url + "/search", data=body,
                    headers={"Content-Type": "application/json"}),
                    timeout=60) as r:
                got = json.loads(r.read())
            t_post = time.perf_counter() - t1
            _, want = saved.search(Q[:8], k=10)
            http_equal = got["ids"] == want.cpu().tolist()
            check(http_equal, "17d: POST /search ids differ from a direct "
                              "search of the saved index")
            with urllib.request.urlopen(url + "/stats", timeout=60) as r:
                stats = json.loads(r.read())
            check(stats.get("requests") == 1, f"17d: /stats {stats}")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        th.join(30)
        text = "".join(lines)
        check(rc == 0 and "[engine]" in text,
              f"17d: SIGINT exit {rc}: {text[-2000:]}")
        for k, v in _serve_numbers(_tags(text)).get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
        runs["d"] = dict(seconds=time.perf_counter() - t0, ready_s=t_ready,
                         post_ms=t_post * 1e3, ids_equal=http_equal,
                         exit=rc)
        log("launcher", run="d", **runs["d"])
        del saved, Q, gt
        torch.cuda.empty_cache()
        # 17e: the concurrent, sharded and tiered modes
        small = ["--n", SERVE_SMALL_N]
        run("e_concurrent", small + ["--concurrent", 32, "--auto-compact",
                                     0.2, "--mutate-fraction", 0.1],
            ("[serve]", "[latency]", "[engine]"))
        run("e_sharded", small + ["--engine", "sharded"],
            ("[serve]", "[latency]", "[recall]"))
        run("e_tiered", small + ["--tiered", "--hot-bytes", 64 << 20],
            ("[serve]", "[latency]", "[recall]", "[tier]"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(runs=runs, n=SERVE_N, n_17e=SERVE_SMALL_N,
               phase_seconds=time.perf_counter() - t_phase)
    results["launcher"] = out
    log("launcher", phase_seconds=out["phase_seconds"])


# -- the paper's baselines at iso-bits (phase 18) -----------------------
# phase 3's 10^6 rows, ~256 code bits a vector each, against phase 6's
# exact top-10 of the 1,000 held-out queries; OPQ's and LOPQ's trainings
# (k-means++ seeding syncs with the host once a centroid, 256 centroids a
# segment) run on the first BASE_TRAIN_CUT rows to keep the phase in
# budget, and every row is encoded
BASE_Q_CHUNK = 125  # queries a score call for the recall
BASE_TRAIN_CUT = 100_000
BASE_SCORE_ROWS = 1_000  # rows of the PQ ADC and EDEN norm gates


def baselines_phase(results, index, X, queries, gt, ash_recall, tally):
    """Phase 18.  ``gt``: the exact top-10 of ``queries[:len(gt)]``;
    ``ash_recall``: phase 6's 10-recall@10 of the ASH index (kernel
    route); ``tally`` counts the RaBitQ index's kernel launches."""
    import torch

    from repro_torch.baselines import eden, leanvec, lopq, pq, rabitq
    from repro_torch.core import quantization as Q
    from repro_torch.index import AshIndex, recall_at
    from repro_torch.kernels import ops
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ref

    t_phase = time.perf_counter()
    qf, q8 = queries[:gt.shape[0]], queries[:REQ_M]
    rows = {}

    def topk_ids(score_fn):
        return torch.cat([
            torch.topk(score_fn(qf[i:i + BASE_Q_CHUNK]), 10, dim=1).indices
            for i in range(0, qf.shape[0], BASE_Q_CHUNK)])

    def method(name, mod, train_rows, **cfg):
        gen = torch.Generator().manual_seed(18)
        st, t_train = sync_time(mod.train, gen, X[:train_rows], **cfg,
                                device=X.device)
        enc, t_enc = sync_time(mod.encode, st, X)
        ms = event_ms(lambda: torch.topk(mod.score(st, enc, q8), 10, dim=1),
                      iters=5, warmup=1)
        rows[name] = dict(
            bits=st.bits_per_vector, train_rows=train_rows, train_s=t_train,
            encode_s=t_enc, score_ms_8q=ms,
            recall_10_at_10=recall_at(topk_ids(
                lambda q: mod.score(st, enc, q)), gt))
        if train_rows < X.shape[0]:
            log("baselines_cut", method=name, train_rows=train_rows,
                encoded_rows=X.shape[0])
        return st, enc

    bi = results["build_index"]
    rows["ash"] = dict(
        bits=bi["payload_bits"], train_rows=X.shape[0], train_s=bi["train_s"],
        encode_s=bi["encode_s"],
        score_ms_8q=event_ms(lambda: index.search(q8, k=10), iters=5,
                             warmup=1),
        recall_10_at_10=ash_recall)
    n_all = X.shape[0]
    gates = {}
    # PQ: ADC == <q, decode(codes)> (the reference's test_pq_adc bound)
    st, codes = method("pq", pq, n_all, M=32, b=8)
    c1k = codes[:BASE_SCORE_ROWS]
    adc, want = pq.score(st, c1k, q8), q8 @ pq.decode(st, c1k).T
    adc_err = float((adc - want).abs().max())
    gates["pq_adc_vs_decode_max_abs"] = adc_err
    check(torch.allclose(adc, want, rtol=1e-3, atol=1e-3),
          f"PQ ADC != <q, decode(codes)>: {adc_err}")
    del st, codes, c1k
    method("opq", pq, min(n_all, BASE_TRAIN_CUT), M=32, b=8, opq_iters=2)
    method("lopq", lopq, min(n_all, BASE_TRAIN_CUT), M=32, b=8, C=4,
           local_iters=2, kmeans_iters=10)
    for variant in ("eden", "turboquant"):
        st, enc = method(variant, eden, n_all, b=1, variant=variant)
        if variant == "eden":  # EDEN's scale keeps each row's norm
            sub = (enc[0][:BASE_SCORE_ROWS], enc[1][:BASE_SCORE_ROWS])
            got = torch.linalg.norm(eden.decode(st, sub), dim=1)
            want = torch.linalg.norm(X[:BASE_SCORE_ROWS], dim=1)
            rel = float(((got - want).abs() / want).max())
            gates["eden_norm_max_rel"] = rel
            check(rel <= 1e-3, f"EDEN decode norms: max rel {rel}")
        del st, enc
    method("leanvec", leanvec, n_all, d=64, b=4)
    torch.cuda.empty_cache()

    # RaBitQ: an ASH model, searched through AshIndex on the card at
    # b = 1, d = 256, C = 1: kernel 2 (fused k = 100) and kernel 1
    # (materializing, rerank 256), each against its plain route
    gen = torch.Generator().manual_seed(18)
    model, t_train = sync_time(rabitq.train, gen, X, b=1, device=X.device)
    payload, t_enc = sync_time(rabitq.encode, model, X)
    ridx = AshIndex.from_parts(model, payload, metric="dot",
                               raw=index._state.raw)
    check(model.d == model.D == DIM and model.landmarks.shape[0] == 1
          and payload.b == 1, "RaBitQ shape")
    prep = ridx.prepare(q8)
    args = ops._score_args(prep, payload)
    d_pad = args[1].shape[1]
    want = ref.ash_score_metric_ref(*args, None, None, b=1, metric="dot")
    got = TK.ash_score_cuda(*args, None, None, b=1, metric="dot")
    V_abs = Q.unpack_codes(payload.codes, d_pad, 1).float().abs()
    codes_, qp, scale, offset, cluster, ipq = args
    tol = ref.score_tolerance((qp.abs() @ V_abs.T) * scale.abs()[None, :],
                              ipq[:, cluster.long()], offset, None, None,
                              want, "dot", d_pad)
    del V_abs
    ratio = float(((got - want).abs() / tol).max())
    check(ratio <= 1.0, f"RaBitQ kernel 1 vs plain: max ratio {ratio}")
    row_tol = tol.max(dim=1, keepdim=True).values
    ks, ki = tally.run(ridx.search, q8, k=K)
    ps, pi = ridx.search(q8, k=K, use_kernel=False)
    differ = ki != pi
    gap = (want.gather(1, ki.long()) - want.gather(1, pi.long())).abs()
    check(bool(((ks - ps).abs() <= row_tol).all())
          and bool((gap[differ] <= 2 * row_tol.expand_as(gap)[differ]).all()),
          "RaBitQ fused top-k vs plain route beyond the bound")
    del got, want, tol, gap
    rq = {}
    for route, kw in (("fused_k10", dict(k=10)),
                      ("rerank256", dict(k=10, rerank=RERANK))):
        kid = torch.cat([tally.run(ridx.search, qf[i:i + BASE_Q_CHUNK],
                                   **kw)[1]
                         for i in range(0, qf.shape[0], BASE_Q_CHUNK)])
        pid = torch.cat([ridx.search(qf[i:i + BASE_Q_CHUNK],
                                     use_kernel=False, **kw)[1]
                         for i in range(0, qf.shape[0], BASE_Q_CHUNK)])
        rq[route] = dict(kernel=recall_at(kid, gt), plain=recall_at(pid, gt))
        check(abs(rq[route]["kernel"] - rq[route]["plain"]) <= 0.005,
              f"RaBitQ {route} recall kernel vs plain: {rq[route]}")
    rows["rabitq"] = dict(
        bits=model.config.payload_bits(), train_rows=n_all, train_s=t_train,
        encode_s=t_enc,
        score_ms_8q=event_ms(lambda: ridx.search(q8, k=10), iters=5,
                             warmup=1),
        recall_10_at_10=rq["fused_k10"]["kernel"])
    gates.update(rabitq_kernel1_max_err_over_bound=ratio,
                 rabitq_topk_id_mismatch=int(differ.sum()),
                 rabitq_recall=rq)
    del ridx, payload, model
    torch.cuda.empty_cache()
    results["baselines"] = dict(methods=rows, gates=gates,
                                queries=int(qf.shape[0]),
                                seconds=time.perf_counter() - t_phase)
    print(json.dumps({"baselines": rows}), flush=True)
    log("baselines_gates", seconds=results["baselines"]["seconds"], **gates)
    return ratio


# -- granite-moe-3b decode in the decode_32k_ashkv cell (phase 19) -------
# 32 layers at full width, 40 experts top-8, d_head 64 (G = 3): the
# cell's batch of 128 holds a 73 GB cache beside 6.75 GB of weights; the
# fill encodes a block of GRANITE_FILL_BLOCK positions GRANITE_FILL_CHUNK
# at a time (one layer's fp32 K at batch 128 alone is 8.6 GB) and copies
# it along the context and to every layer
GRANITE_BATCH, GRANITE_CUT_BATCH = 128, 64
# 32 positions a chunk: the exact quantizer's sort of one chunk of
# 32,768 vectors takes ~0.35 GB; 256 positions take ~2.8 GB, more than
# batch 128 leaves free
GRANITE_FILL_CHUNK, GRANITE_FILL_BLOCK = 32, 1024
GRANITE_PLAIN_ROWS = 16  # batch rows a call of kernel 7's plain version
# 19c: a decode step costs ~165 ms of host time at granite's 32 MoE
# layers, so 128 teacher-forced tokens over four routes (the free plain
# route left out) keep phases 18-19 near their 180 s budget
GRANITE_FID_LEN = 128


def granite_phase(results, dev):
    """Phase 19 (run first: see ``main``); returns kernel 7's launches
    and its row at the granite shape for the ``kernels`` line."""
    import torch

    from repro_torch.configs import granite_moe_3b as GC
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    t_phase = time.perf_counter()
    cfg = GC.ashkv_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, t_init = sync_time(TT.init_params, torch.Generator(
        device=dev).manual_seed(19), cfg, device=dev)

    # -- 19a. kernel 7 at one granite layer, before the cache is placed
    gen = torch.Generator(device=dev).manual_seed(191)
    batch = GRANITE_BATCH
    kv = kv_layer_check(cfg, batch, dev, gen, plain_rows=GRANITE_PLAIN_ROWS)
    results["granite_kv_kernel"] = kv
    log("granite_kv_kernel", **kv)

    # -- 19b. the cache at the cell's batch (cut to 64 if it does not fit)
    def place(batch):
        cache, t_cache = sync_time(TT.init_cache, cfg, batch, LM_MAX_LEN,
                                   device=dev)
        fill_s = fill_cache(params, cfg, cache, batch, dev, gen,
                            GRANITE_FILL_CHUNK, GRANITE_FILL_BLOCK)
        # one step at the last position: a batch that fits its cache
        # but not a step's work is cut too
        TT.decode_step(params, cache, torch.zeros(
            batch, dtype=torch.long, device=dev), LM_MAX_LEN - 1, cfg)
        return cache, t_cache, fill_s

    cut = None
    torch.cuda.empty_cache()
    try:
        cache, t_cache, fill_s = place(batch)
    except torch.cuda.OutOfMemoryError:
        cut = dict(batch_from=batch, batch_to=GRANITE_CUT_BATCH,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if cut is not None:
        log("granite_cut", **cut)
        torch.cuda.empty_cache()
        batch = GRANITE_CUT_BATCH
        cache, t_cache, fill_s = place(batch)
    build = lm_build_row(params, cfg, cache, batch, t_init, t_cache)
    build.update(cut=cut, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                 active_params=cfg.active_param_count())
    results["granite_build"] = build
    log("granite_build", **build)
    dec, k7_launches, prof = decode_stream(params, cfg, cache, batch, dev,
                                           gen)
    # the MoE dispatch/combine of a step: every layer's moe_block at the
    # step's token count, profiled alone (its batched products are the
    # experts' GEMMs; the rest is routing, sort, searchsorted, scatter
    # and gather)
    h = torch.randn(batch, cfg.d_model, generator=gen, device=dev).to(
        cfg.dtype)
    moe_prof = profile_step(lambda: [TM.moe_block(lp.moe, h, cfg.moe)
                                     for lp in params.layers])
    prof["moe_block_device_ms"] = moe_prof["device_ms_by_group"]
    prof["moe_dispatch_combine_ms"] = moe_prof["device_ms_by_group"]["other"]
    results["granite_decode"] = dict(dec, fill_s=fill_s)
    results["granite_profile_decode_step"] = prof
    log("granite_decode", **results["granite_decode"])
    log("granite_profile_decode", **prof)
    del cache
    torch.cuda.empty_cache()

    # -- 19c. fidelity at batch 4 ------------------------------------------
    results["granite_fidelity"] = fidelity(params, cfg, dev, gen,
                                           tokens=GRANITE_FID_LEN, free=False)
    log("granite_fidelity", **results["granite_fidelity"])
    del params
    torch.cuda.empty_cache()
    results["granite_seconds"] = time.perf_counter() - t_phase
    log("granite_phase", seconds=results["granite_seconds"])
    return k7_launches, dict(
        batch=batch, launches=k7_launches, **{
            k: kv[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "bound_share")})


# -- LM training (phase 20) --------------------------------------------------
# llama3.2-3B and granite-moe-3b at full width and depth through
# repro_torch.train (the train_4k cell's seq 4096), the card against the
# CPU on the reduced archs, and restart bit for bit.  No kernel of the
# kernels line runs here: training's products are cuBLAS, its attention
# the plain fp32 einsums of models.common.gqa_attention, as the
# reference's jnp.
TRAIN_SEQ = 4096  # the train_4k cell
# (arch id, global batch, steps): the cell's batch of 256 is cut to one
# sequence a microbatch (the state of 3.6 B parameters takes 57.7 GB)
TRAIN_RUNS = (("llama3.2-3b", 2, 8), ("granite-moe-3b-a800m", 4, 4))
TRAIN_DET_STEPS = 3  # 20a: steps again under deterministic algorithms
TRAIN_RANGES = ("train.forward_backward", "train.compression",
                "train.optimizer")  # the trainer's spans (tracing.SPANS)
TRAIN_SAMPLE = 1 << 20  # elements of each leaf kept to see it change
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
# 20c: the reduced archs, card against CPU, 3 steps a variant
TRAIN_VARIANTS = (
    ("adamw", dict(name="adamw"), None),
    ("adafactor", dict(name="adafactor"), None),
    ("adafactor_b1_0_bf16", dict(name="adafactor", b1=0.0,
                                 moment_dtype="bfloat16"), None),
    ("muon", dict(name="muon"), None),
    ("adamw_2bit", dict(name="adamw"), 2),
)
TRAIN_SMALL_BATCH, TRAIN_SMALL_SEQ, TRAIN_SMALL_STEPS = 4, 64, 3
TRAIN_LAUNCH_TIMEOUT = 300
TRAIN_LAUNCH_DEVICE = "cuda"


def train_profile(step, labels):
    """One ``step()`` under torch.profiler: device ms by group (bf16
    cuBLAS, fp32 cuBLAS = the attention einsums, the optimizer's range,
    the rest), busy and wall ms, the idle share, the busiest kernels.
    Spans are on for the step, so the trainer's ranges are in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    torch.cuda.synchronize()
    was = tracing.enabled()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tracing.enable(was)
    dev_us, _, ranges = device_times(prof, labels)
    groups = {"cublas_bf16": 0.0, "cublas_fp32_attention": 0.0,
              "optimizer": ranges.get("train.optimizer", 0.0), "other": 0.0}
    for name, us in dev_us.items():
        low = name.lower()
        if any(w in low for w in ("gemm", "xmma", "cutlass", "gemv",
                                  "splitk", "nvjet")):
            fp32 = any(w in low for w in ("sgemm", "f32f32", "_sss",
                                          "simt", "fp32"))
            groups["cublas_fp32_attention" if fp32 else "cublas_bf16"] += \
                us / 1e3
        else:
            groups["other"] += us / 1e3
    busy_ms = sum(dev_us.values()) / 1e3
    groups["other"] = max(groups["other"] - groups["optimizer"], 0.0)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms
                else None,
                device_ms_by_group=groups, range_device_ms=ranges,
                top_device_ms={k[:90]: v / 1e3 for k, v in top})


def _leaf_samples(tree):
    """A strided sample of at most TRAIN_SAMPLE elements of each leaf."""
    import torch

    from repro_torch.train import optim as TO

    out = []
    for leaf in TO.tree_leaves(tree):
        flat = leaf.detach().reshape(-1)
        out.append(flat[::max(1, flat.numel() // TRAIN_SAMPLE)].clone())
    return out


def train_full(arch_id, batch, steps, dev, det_steps=0):
    """Train ``arch_id`` at full width with its TrainConfig: ``steps``
    steps (the first is warm-up) on the TokenStream, then ``det_steps``
    more under deterministic algorithms; a profiled step.  Running out
    of memory fails the phase."""
    import functools
    import math

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import IteratorState, TokenStream
    from repro_torch.models import transformer as TT
    from repro_torch.train import optim as TO
    from repro_torch.train import trainer as TTR

    arch = registry.get(arch_id)
    cfg, tcfg = arch.cfg, arch.train_cfg
    t_run = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, t_init = sync_time(TT.init_params, torch.Generator(
        device=dev).manual_seed(20), cfg, device=dev)
    state = TTR.init_state(20, params, tcfg)
    state_b = torch.cuda.memory_allocated() - base  # phase 22's
    before = _leaf_samples(params.tree)
    step_fn = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=cfg),
                                  tcfg)
    stream = TokenStream(IteratorState(seed=20), batch, TRAIN_SEQ,
                         cfg.vocab)
    first = stream.next()
    # the router aux of the first step's microbatches (one sequence
    # each), so that step 1's CE can be told from its loss
    aux0 = 0.0
    if cfg.moe:
        with torch.no_grad():
            aux0 = sum(float(TT.forward(params, first["tokens"][r:r + 1]
                                        .to(dev), cfg)[1])
                       for r in range(batch)) / batch
    ms, losses, gnorms = [], [], []
    try:
        for i in range(steps + det_steps):
            if i == steps:
                torch.use_deterministic_algorithms(True)
            b = first if i == 0 else stream.next()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, b)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    finally:
        torch.use_deterministic_algorithms(False)
    t_steps = time.perf_counter() - t_run
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = _leaf_samples(params.tree)
    paths = [p for p, _ in TT.train_leaves(params)]
    unchanged = ["/".join(p) for p, a, b in zip(paths, after, before)
                 if torch.equal(a, b)]
    mu_zero = ["/".join(p) for p, m in zip(paths, TO.tree_leaves(
        state.opt_state.mu)) if not bool(m.abs().amax() > 0)]
    norms = {"/".join(p) for p in paths if p[-1].endswith("norm")}
    check(all(map(math.isfinite, losses + gnorms)),
          f"{arch_id}: a loss or grad norm is not finite")
    # random weights give N(0, 1) logits: a CE of ln V + 1/2; an MoE
    # model's loss adds the router aux of its microbatches
    ln_v = math.log(cfg.vocab) + 0.5
    check(abs(losses[0] - aux0 - ln_v) < 1.0,
          f"{arch_id}: step 1 loss {losses[0]} - aux {aux0} vs ln V + 1/2 "
          f"= {ln_v}")
    check(int(state.step) == steps + det_steps, f"{arch_id}: step")
    # bf16 norm scales of 1.0 move only by updates of half a bf16 ulp
    # (2^-9), far above the warmup's lr (3e-4 * step / 100): those may
    # stay; every other leaf must change, and every leaf's first moment
    # must be non-zero (the optimizer reached it)
    check(not set(unchanged) - norms and not mu_zero,
          f"{arch_id}: unchanged leaves {unchanged}, zero moments {mu_zero}")
    timed = sorted(ms[1:steps])
    p50 = pct(timed, 50)
    tokens = batch * TRAIN_SEQ
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    # the parameters of matrix products: the embedding table is a lookup
    n_matmul = n_active - cfg.vocab * cfg.d_model
    row = dict(
        arch=arch_id, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, seq=TRAIN_SEQ, batch=batch,
        microbatches=tcfg.microbatches, optimizer=tcfg.opt.name,
        moment_dtype=str(tcfg.opt.moment_dtype), remat=cfg.remat,
        params=n_params, active_params=n_active, matmul_params=n_matmul,
        init_s=t_init,
        steps=steps, losses=losses, step1_aux=aux0, grad_norms=gnorms,
        step_ms=ms, state_allocated_b=state_b,
        step_p50_ms=p50, step_p99_ms=pct(timed, 99),
        tokens_per_s=tokens / (p50 / 1e3),
        model_flop_share=6 * n_matmul * tokens / (p50 / 1e3)
        / PEAK_BF16_FLOPS,
        peak_mem_gb=peak_gb, unchanged_leaves=unchanged)
    if det_steps:
        det = sorted(ms[steps + 1:])
        row.update(deterministic_step_p50_ms=pct(det, 50),
                   deterministic_cost=pct(det, 50) / p50 - 1)
    b = stream.next()
    t_prof = time.perf_counter()
    row["profile"] = train_profile(lambda: step_fn(state, b), TRAIN_RANGES)
    row.update(steps_seconds=t_steps,
               profile_seconds=time.perf_counter() - t_prof)
    if cfg.moe:
        with torch.no_grad():
            _, aux = TT.forward(params, b["tokens"][:1].to(dev), cfg)
        row["aux_loss"] = float(aux)
        check(math.isfinite(row["aux_loss"]) and row["aux_loss"] > 0,
              f"{arch_id}: aux loss {row['aux_loss']}")
    del params, state, step_fn
    torch.cuda.empty_cache()
    return row


def train_card_vs_cpu(dev):
    """20c: the reduced llama and granite (fp32) for TRAIN_SMALL_STEPS
    steps of each variant on the card and on the CPU from the same
    weights and batches (compression's signs come from CPU generators:
    the same on both): losses to rtol 1e-4; parameters within twice the
    summed learning rates, and to 1e-6 but for at most 1 % of the
    elements (AdamW's m/sqrt(v) where the clipped |g| is near eps),
    except with compression, where a code that flips at a midpoint
    moves its whole 2048-wide block after the unrotation (the elements
    past 1e-6 are reported; the round trip itself is held by
    :func:`compression_card_vs_cpu`)."""
    import functools

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train as TL
    from repro_torch.models import convert
    from repro_torch.models import transformer as TT
    from repro_torch.train import optim as TO
    from repro_torch.train import trainer as TTR
    from repro_torch.train.compression import CompressionConfig

    out = {}
    for arch_id in ("llama3.2-3b", "granite-moe-3b-a800m"):
        arch = TL.reduced_arch(registry.get(arch_id))
        cfg = arch.cfg
        for name, opt, bits in TRAIN_VARIANTS:
            opt = {k: getattr(torch, v) if k == "moment_dtype" else v
                   for k, v in opt.items()}
            tcfg = dataclasses.replace(
                arch.train_cfg,
                opt=dataclasses.replace(arch.train_cfg.opt, **opt),
                compression=CompressionConfig(bits=bits or 2,
                                              enabled=bits is not None))
            p_cpu = TT.init_params(torch.Generator().manual_seed(21), cfg,
                                   device="cpu")
            p_dev = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                              cfg, device=dev)
            runs = []
            for params in (p_cpu, p_dev):
                state = TTR.init_state(21, params, tcfg)
                step = TTR.make_train_step(
                    functools.partial(TT.loss_fn, cfg=cfg), tcfg)
                stream = TL.make_stream(arch, TRAIN_SMALL_BATCH,
                                        TRAIN_SMALL_SEQ, 21)
                losses = []
                for _ in range(TRAIN_SMALL_STEPS):
                    state, m = step(state, stream.next())
                    losses.append(float(m["loss"]))
                runs.append((losses, [t.detach().cpu() for t in
                                      TO.tree_leaves(params.tree)]))
            (l_cpu, t_cpu), (l_dev, t_dev) = runs
            lr_sum = sum(TO.lr_at(tcfg.opt, s)
                         for s in range(1, TRAIN_SMALL_STEPS + 1))
            diff = [(a - b).abs() for a, b in zip(t_dev, t_cpu)]
            beyond = sum(int((d > 1e-6).sum()) for d in diff)
            total = sum(d.numel() for d in diff)
            worst = max(float(d.max()) for d in diff)
            rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
            row = dict(loss_rel=rel, param_max_abs=worst,
                       beyond_1e6=beyond, elements=total, lr_sum=lr_sum,
                       losses=l_dev)
            out[f"{arch_id}/{name}"] = row
            check(rel <= 1e-4, f"20c {arch_id}/{name}: losses {l_dev} vs "
                  f"{l_cpu}")
            check((bits or beyond <= 0.01 * total)
                  and worst <= 2 * lr_sum + 1e-6,
                  f"20c {arch_id}/{name}: parameters {row}")
    out["compression"] = compression_card_vs_cpu(dev)
    return out


def compression_card_vs_cpu(dev):
    """20c: the EDEN round trip at 1, 2 and 4 bits on the card against
    the CPU, the same 10^6-element vector and signs: codes EQUAL wherever
    the normalized value is more than 1e-6 from a midpoint, outputs
    within 1e-5 of the largest |value| where every code is equal."""
    import numpy as np
    import torch

    from repro_torch.train import compression as TZ

    g = torch.randn(1_000_003, generator=torch.Generator().manual_seed(23))
    signs = TZ.rand_signs(23, 2048)
    out = {}
    for bits in (1, 2, 4):
        cfg = TZ.CompressionConfig(bits=bits, enabled=True)
        codes_c, _, yn = TZ.encode_blocks(g, cfg, signs)
        codes_d = TZ.encode_blocks(g.to(dev), cfg, signs)[0].cpu()
        grid = torch.from_numpy(TZ._grid(bits))
        mids = (grid[1:] + grid[:-1]) / 2
        near = ((yn[..., None] - mids).abs() <= 1e-6).any(-1)
        differ = codes_c != codes_d
        check(not bool((differ & ~near).any()),
              f"20c compression {bits} bits: codes differ off midpoints")
        want = TZ.compress_decompress(g, cfg, signs)
        got = TZ.compress_decompress(g.to(dev), cfg, signs).cpu()
        err = float((got - want).abs().max())
        if not bool(differ.any()):
            check(err <= 1e-5 * float(want.abs().max()),
                  f"20c compression {bits} bits: outputs {err}")
        out[f"bits_{bits}"] = dict(codes_differ=int(differ.sum()),
                                   near_midpoint=int(near.sum()),
                                   max_abs_err=err,
                                   codes=int(np.prod(codes_c.shape)))
    return out


def train_restart(dev):
    """20d: in process, under deterministic algorithms: save at step 3,
    3 more steps, restore, replay: losses EQUAL as fp32 bits; then the
    launcher as a child process dies at step 5 (exit 42), and its
    ``main`` run again in this process resumes from step 4 (returns 0)."""
    import functools
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import IteratorState, TokenStream
    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as TT
    from repro_torch.train import trainer as TTR
    from repro_torch.train.checkpoint import CheckpointManager

    out = {}
    arch = TL.reduced_arch(registry.get("llama3.2-3b"))
    cfg, tcfg = arch.cfg, arch.train_cfg
    (ROOT / "build").mkdir(exist_ok=True)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            params = TT.init_params(torch.Generator(device=dev).manual_seed(
                22), cfg, device=dev)
            state = TTR.init_state(22, params, tcfg)
            step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=cfg),
                                       tcfg)
            stream = TokenStream(IteratorState(seed=22), 8, 256, cfg.vocab)
            mgr = CheckpointManager(tmp, keep_n=2)
            for _ in range(3):
                state, _ = step(state, stream.next())
            mgr.save(3, state, extra=stream.state.to_dict())
            cont = []
            for _ in range(3):
                state, m = step(state, stream.next())
                cont.append(float(m["loss"]))
            mgr.wait()
            state, extra = mgr.restore(state)
            stream = TokenStream(IteratorState.from_dict(extra), 8, 256,
                                 cfg.vocab)
            replay = []
            for _ in range(3):
                state, m = step(state, stream.next())
                replay.append(float(m["loss"]))
            out["in_process"] = dict(cont=cont, replay=replay)
            check(cont == replay, f"20d: replay {replay} != {cont}")
    finally:
        torch.use_deterministic_algorithms(False)

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        argv = ["--arch", "llama3.2-3b", "--reduced", "--device",
                TRAIN_LAUNCH_DEVICE, "--steps", "8", "--batch", "4", "--seq",
                "16", "--ckpt-dir", tmp, "--ckpt-every", "2",
                "--log-every", "1"]
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                           + argv + ["--die-at-step", "5"], cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                           capture_output=True, text=True,
                           timeout=TRAIN_LAUNCH_TIMEOUT)
        runs = [dict(rc=p.returncode, seconds=time.perf_counter() - t0,
                     stdout=p.stdout[-2000:], stderr=p.stderr[-2000:])]
        # the rerun through the same entry point in this process (a second
        # child would spend ~20 s starting)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = TL.main(argv)
        runs.append(dict(rc=rc, seconds=time.perf_counter() - t0,
                         stdout=buf.getvalue()[-2000:], stderr=""))
        out["launcher"] = runs
        died, resumed = runs
        check(died["rc"] == 42 and "[failure-sim] dying at step 5"
              in died["stdout"], f"20d: launcher run 1 {died}")
        check(resumed["rc"] == 0 and "[restore] resumed from step 4"
              in resumed["stdout"] and "[done]" in resumed["stdout"],
              f"20d: launcher run 2 {resumed}")
        step5 = [ln for r in runs for ln in r["stdout"].splitlines()
                 if ln.startswith("step     5 ")]
        check(len(step5) == 2 and step5[0].split("(")[0]
              == step5[1].split("(")[0], f"20d: step 5 lines {step5}")
    return out


def train_phase(results, dev):
    """Phase 20 (run right after phase 19)."""
    import torch

    t_phase = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    results["before_train"] = dict(
        allocated_gb=torch.cuda.memory_allocated() / 1e9,
        free_gb=free / 1e9, total_gb=total / 1e9)
    log("before_train", **results["before_train"])
    for (arch_id, batch, steps), key in zip(TRAIN_RUNS, ("20a", "20b")):
        row = train_full(arch_id, batch, steps, dev,
                         det_steps=TRAIN_DET_STEPS if key == "20a" else 0)
        results[f"train_{key}"] = row
        log(f"train_{key}", **{k: v for k, v in row.items()
                               if k not in ("profile", "step_ms")})
        log(f"train_{key}_profile", **row["profile"])
    t0 = time.perf_counter()
    results["train_20c"] = train_card_vs_cpu(dev)
    results["train_20c"]["seconds"] = time.perf_counter() - t0
    log("train_20c", **results["train_20c"])
    t0 = time.perf_counter()
    results["train_20d"] = train_restart(dev)
    results["train_20d"]["seconds"] = time.perf_counter() - t0
    log("train_20d", in_process=results["train_20d"]["in_process"],
        launcher=[{k: r[k] for k in ("rc", "seconds")}
                  for r in results["train_20d"]["launcher"]],
        seconds=results["train_20d"]["seconds"])
    results["train_seconds"] = time.perf_counter() - t_phase
    log("train_phase", seconds=results["train_seconds"])


# -- the recommender and interatomic families (phase 21) -------------------
# The cells' numbers are read from the port's configs.base: recsys_cells,
# gnn_cells' molecule cell and sasrec's extra retrieval_cand_ash cell
# (b = 4, d = e / 2).  Their products are cuBLAS and autograd, as the
# reference's jnp; SASRec's catalog search runs kernel 2.


def _family_cells():
    """(recsys_cells, the molecule cell, sasrec's retrieval_cand_ash)."""
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import base, registry

    return (base.recsys_cells(), base.gnn_cells()["molecule"],
            registry.get("sasrec").cell("retrieval_cand_ash"))


_RECSYS_CELLS, _MOL_CELL, _SAS_CELL = _family_cells()
FAM_TRAIN_BATCH = _RECSYS_CELLS["train_batch"].shape["batch"]
FAM_SERVE_BATCH = _RECSYS_CELLS["serve_p99"].shape["batch"]  # a request
FAM_N_CAND = _RECSYS_CELLS["retrieval_cand"].shape["n_candidates"]
SAS_BITS = _SAS_CELL.shape["ash_bits"]  # b
SAS_REDUCE = _SAS_CELL.shape["ash_reduce"]  # d = embed_dim // SAS_REDUCE
FAM_CAND_CHUNK = 1 << 18  # candidates a forward (AutoInt's temporaries)
FAM_STEPS = 4  # train steps a model; the first is warm-up
FAM_SERVE_TIMED = 50  # serve_p99 forwards a recsys model
SAS_KS = (10, 100)  # retrieval_cand_ash requests at k = 10 and k = 100
SAS_REQUESTS = 30  # timed requests a k
SAS_LANDMARKS = 16
MOL_GRAPHS = _MOL_CELL.shape["n_graphs"]  # the molecule cell's graphs
MOL_NODES = _MOL_CELL.shape["n_nodes"] // MOL_GRAPHS  # atoms a graph
MOL_EDGES = _MOL_CELL.shape["n_edges"] // MOL_GRAPHS  # edges a graph
FAM_SMALL_STEPS = 3  # 21d: reduced archs, card against CPU
FAM_SMALL_BATCH = 64
FAM_IDS = ("sasrec", "dcn-v2", "fm", "autoint", "nequip")


def _n_params(tree):
    from repro_torch.train import optim as TO

    return sum(t.numel() for t in TO.tree_leaves(tree))


def _timed_steps(step_fn, state, batches):
    """Run the train steps over ``batches``: (state, CUDA-event ms a
    step, losses); every loss must be finite."""
    import torch

    ms, losses = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, b)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    return state, ms, losses


def _profiled_step(step_fn, state, batch):
    """One more train step under the profiler (:func:`train_profile`):
    device time by group, the optimizer's range, the idle share."""
    return train_profile(lambda: step_fn(state, batch), TRAIN_RANGES)


def _train_row(name, params, ms, losses, rows_a_step):
    """Step p50/p99 over the steps after the first, rows a second at the
    p50, the peak memory since the last reset."""
    import torch

    timed = sorted(ms[1:])
    p50 = pct(timed, 50)
    return dict(model=name, params=_n_params(params), batch=rows_a_step,
                steps=len(ms), step_ms=ms, losses=losses,
                step_p50_ms=p50, step_p99_ms=pct(timed, 99),
                rows_per_s=rows_a_step / (p50 / 1e3),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def sasrec_phase(dev):
    """21a: SASRec at full width: 4 train steps at the train_batch cell's
    65,536 sequences, the retrieval_cand_ash index over the trained item
    table, kernel 2 at its shape against its plain version, timed
    requests of 512 user sequences through ``sasrec_retrieve`` (launch
    counts zeroed just before, read just after), engine == direct search,
    10-recall@10 against exact scores over every item.  Returns (kernel
    2's scans and merges in the requests, the phase's row)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import IteratorState, SequenceStream
    from repro_torch.index import exact_topk, recall_at
    from repro_torch.kernels import ash_score as TK
    from repro_torch.models import sasrec as SR
    from repro_torch.serving import retrieval as RET
    from repro_torch.train import trainer as TTR

    arch = registry.get("sasrec")
    cfg = arch.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, t_init = sync_time(SR.init_params, torch.Generator(
        device=dev).manual_seed(21), cfg, device=dev)
    state = TTR.init_state(21, params, arch.train_cfg)
    state_b = torch.cuda.memory_allocated() - base  # phase 22's
    step = TTR.make_train_step(arch.loss_fn(), arch.train_cfg)
    stream = SequenceStream(IteratorState(seed=21), FAM_TRAIN_BATCH,
                            cfg.seq_len, cfg.n_items, cfg.n_neg)
    state, ms, losses = _timed_steps(
        step, state, [stream.next() for _ in range(FAM_STEPS)])
    # a sampled softmax over 1 + 128 items of near-zero logits: ln 129
    check(abs(losses[0] - math.log(1 + cfg.n_neg)) < 0.5,
          f"21a: step 1 loss {losses[0]} vs ln 129")
    train = _train_row("sasrec", params, ms, losses, FAM_TRAIN_BATCH)
    train["state_allocated_b"] = state_b
    train["sequences_per_s"] = train.pop("rows_per_s")
    train["init_s"] = t_init
    train["profile"] = _profiled_step(step, state, stream.next())
    del state, step

    items = params["item_emb"].detach()
    index, t_build = sync_time(
        RET.build_index, torch.Generator().manual_seed(21), items,
        bits=SAS_BITS, reduce=SAS_REDUCE,
        n_landmarks=SAS_LANDMARKS, learned=True, metric="dot", device=dev)
    users = SequenceStream(IteratorState(seed=2101), FAM_SERVE_BATCH,
                           cfg.seq_len, cfg.n_items, cfg.n_neg)
    seqs = [users.next()["seq"] for _ in range(SAS_REQUESTS)]
    with torch.no_grad():
        u0 = SR.user_state(params, seqs[0].to(dev), cfg)
    # kernels 1 and 2 held to their plain versions on a request's 512
    # user states, at its k; kernel 2 timed at phase 7's request shape
    flat, compare = flat_scan_check(index, u0, SAS_KS, "21a")
    del flat
    times = flat_scan_rows(index, u0[:REQ_M])[1]
    times.update(b=index.payload.b, d_pad=compare["d_pad"],
                 n=index.n, m=REQ_M, k=K)
    engine = RET.engine_for(index)
    for k in SAS_KS:  # the engine's buckets, warmed untimed
        RET.sasrec_retrieve(params, seqs[0], index, cfg, k=k)

    # the main path: requests of 512 user sequences through the engine
    TK.reset_launch_counts()
    lat, out = {}, {}
    for k in SAS_KS:
        lat[k] = []
        for r, seq in enumerate(seqs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = RET.sasrec_retrieve(params, seq, index, cfg, k=k)
            torch.cuda.synchronize()
            lat[k].append((time.perf_counter() - t0) * 1e3)
            if r < 2:
                out[k, r] = got
    torch.cuda.synchronize()
    scans = TK.launch_counts["ash_score_topk"]
    merges = TK.merge_launches["ash_score_topk"]
    check(scans > 0 and merges == scans,
          f"21a: kernel 2 scans {scans}, merges {merges}")

    same, recall = [], {}
    with torch.no_grad():
        for (k, r), got in out.items():
            u = SR.user_state(params, seqs[r].to(dev), cfg)
            want = index.search(u, k=k)
            same.append(_eq(got, (want[0].cpu(), want[1].cpu())))
        check(all(same), f"21a: engine != direct search {same}")
        _, gt = exact_topk(u0, items, k=10)
        for k in SAS_KS:
            ids_k = RET.serve_topk(index, u0, k=k)[1]
            ids_p = RET.serve_topk(index, u0, k=k, use_kernel=False)[1]
            recall[k] = dict(kernel=recall_at(ids_k, gt.cpu()),
                             plain=recall_at(ids_p, gt.cpu()))
            check(abs(recall[k]["kernel"] - recall[k]["plain"]) <= 0.005,
                  f"21a: recall at k = {k}: {recall[k]}")
    row = dict(
        train=train, index_build_s=t_build, index_rows=index.n,
        index_config=dict(b=index.config.b, d=index.config.d,
                          n_landmarks=index.config.n_landmarks),
        requests=len(seqs), rows_a_request=FAM_SERVE_BATCH,
        request_ms={k: dict(p50=pct(v, 50), p99=pct(v, 99), all=v)
                    for k, v in lat.items()},
        kernel2_scans=scans, kernel2_merges=merges,
        engine_buckets=list(engine.config.batch_buckets),
        engine_equal_direct=same, recall_10_at_k=recall,
        kernel2_vs_plain=compare, kernel2_times=times)
    del params, index, engine, items
    torch.cuda.empty_cache()
    return scans, merges, row


def recsys_phase(dev):
    """21b: DCN-v2, FM and AutoInt at full width: 4 train steps each at
    the train_batch cell's 65,536 rows (AdamW over the whole folded
    table, dense grads), serve_p99 forwards at 512 rows, and one user
    against 10^6 candidates (retrieval_cand, in chunks of 2^18); every
    logit finite."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import ClickStream, IteratorState
    from repro_torch.models import recsys as RS
    from repro_torch.train import trainer as TTR

    out = {}
    for arch_id in ("dcn-v2", "fm", "autoint"):
        arch = registry.get(arch_id)
        cfg = arch.cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params, t_init = sync_time(RS.init_params, torch.Generator(
            device=dev).manual_seed(22), cfg, device=dev)
        state = TTR.init_state(22, params, arch.train_cfg)
        state_b = torch.cuda.memory_allocated() - base  # phase 22's
        step = TTR.make_train_step(arch.loss_fn(), arch.train_cfg)
        stream = ClickStream(IteratorState(seed=22), FAM_TRAIN_BATCH,
                             cfg.n_dense, cfg.n_sparse, cfg.vocab_per_field)
        state, ms, losses = _timed_steps(
            step, state, [stream.next() for _ in range(FAM_STEPS)])
        row = _train_row(arch_id, params, ms, losses, FAM_TRAIN_BATCH)
        row["examples_per_s"] = row.pop("rows_per_s")
        row["state_allocated_b"] = state_b
        row["train_peak_mem_gb"] = row["peak_mem_gb"]
        row["table_gb"] = params["tables"].numel() * 4 / 1e9
        row["init_s"] = t_init
        row["profile"] = _profiled_step(step, state, stream.next())
        del state, step
        with torch.no_grad():
            req = {k: v.to(dev) for k, v in ClickStream(
                IteratorState(seed=23), FAM_SERVE_BATCH, cfg.n_dense,
                cfg.n_sparse, cfg.vocab_per_field).next().items()}
            logits = RS.forward(params, req, cfg)
            check(logits.shape == (FAM_SERVE_BATCH,)
                  and bool(torch.isfinite(logits).all()),
                  f"21b {arch_id}: serve logits")
            lat = []
            for _ in range(FAM_SERVE_TIMED):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                RS.forward(params, req, cfg)
                end.record()
                end.synchronize()
                lat.append(start.elapsed_time(end))
            user = {k: v[:1] for k, v in req.items()}
            cand = torch.randperm(cfg.vocab_per_field, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(24))
            cand = cand[:FAM_N_CAND]

            def score_all():
                return torch.cat([
                    RS.retrieval_score(params, user,
                                       cand[i:i + FAM_CAND_CHUNK], cfg)
                    for i in range(0, FAM_N_CAND, FAM_CAND_CHUNK)])

            scores = score_all()
            check(scores.shape == (FAM_N_CAND,)
                  and bool(torch.isfinite(scores).all()),
                  f"21b {arch_id}: retrieval scores")
            ret = [sync_time(score_all)[1] * 1e3 for _ in range(3)]
        row.update(serve_ms=dict(p50=pct(lat, 50), p99=pct(lat, 99)),
                   retrieval_ms=dict(p50=pct(ret, 50), all=ret),
                   retrieval_chunk=FAM_CAND_CHUNK,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[arch_id] = row
        del params, scores
        torch.cuda.empty_cache()
    return out


def _moved(b, R, shift):
    return dict(b, positions=b["positions"] @ R.T + shift)


def nequip_phase(dev):
    """21c: NequIP (5 layers, 32 channels, l_max 2) in the molecule cell
    (128 graphs of 30 atoms and 64 edges): ``energy_and_forces`` p50,
    the second-order train step's p50 over 4 steps, and energies
    invariant (1e-5) and forces equivariant (1e-4), relative to their
    largest |value|, under a random rotation plus a translation."""
    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.data import graphs as G
    from repro_torch.models import nequip as NQ
    from repro_torch.train import trainer as TTR

    arch = registry.get("nequip")
    cfg = arch.cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = NQ.init_params(torch.Generator(device=dev).manual_seed(25),
                            cfg, device=dev)
    state_b = torch.cuda.memory_allocated() - base  # phase 22's
    gen = torch.Generator().manual_seed(25)

    def batch(seed):
        b = G.batch_small_graphs(seed, MOL_GRAPHS, MOL_NODES, MOL_EDGES,
                                 n_species=cfg.n_species)
        b.pop("n_graphs")
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        b["energy"] = torch.randn(MOL_GRAPHS, generator=gen)
        b["forces"] = torch.randn(b["positions"].shape, generator=gen) * 0.1
        return b

    b0 = {k: v.to(dev) for k, v in batch(0).items()}
    b0["n_graphs"] = MOL_GRAPHS
    ef = []
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        NQ.energy_and_forces(params, b0, cfg)
        end.record()
        end.synchronize()
        ef.append(start.elapsed_time(end))
    R = torch.from_numpy(np.linalg.qr(np.random.default_rng(25)
                                      .standard_normal((3, 3)))[0]
                         .astype(np.float32)).to(dev)
    shift = torch.tensor([3.7, -1.2, 0.4], device=dev)
    with torch.no_grad():
        e0 = NQ.forward(params, b0, cfg)
        e1 = NQ.forward(params, _moved(b0, R, shift), cfg)
    _, f0 = NQ.energy_and_forces(params, b0, cfg)
    _, f1 = NQ.energy_and_forces(params, _moved(b0, R, shift), cfg)
    e_rel = float((e1 - e0).abs().max() / e0.abs().max())
    f_rel = float((f1 - f0 @ R.T).abs().max() / f0.abs().max())
    check(e_rel <= 1e-5, f"21c: energies moved by {e_rel} under E(3)")
    check(f_rel <= 1e-4, f"21c: forces not equivariant ({f_rel})")
    base = torch.cuda.memory_allocated()
    state = TTR.init_state(25, params, arch.train_cfg)
    state_b += torch.cuda.memory_allocated() - base  # the moments
    step = TTR.make_train_step(arch.loss_fn(n_graphs=MOL_GRAPHS),
                               arch.train_cfg)
    state, ms, losses = _timed_steps(step, state,
                                     [batch(1 + i) for i in range(FAM_STEPS)])
    row = _train_row("nequip", params, ms, losses, MOL_GRAPHS)
    row["graphs_per_s"] = row.pop("rows_per_s")
    row["state_allocated_b"] = state_b
    row["profile"] = _profiled_step(step, state, batch(1 + FAM_STEPS))
    row.update(atoms=MOL_GRAPHS * MOL_NODES, edges=MOL_GRAPHS * MOL_EDGES,
               energy_and_forces_ms=dict(p50=pct(sorted(ef[1:]), 50),
                                         all=ef),
               invariance_rel=e_rel, equivariance_rel=f_rel)
    del params, state, step
    torch.cuda.empty_cache()
    return row


def families_card_vs_cpu(dev):
    """21d: each of the five ids at ``reduced_arch`` for 3 steps on the
    card and on the CPU from the same parameters and batches: losses to
    1e-4 relative; then the launcher's kill and resume for nequip on the
    card (its ``main``, in process, under deterministic algorithms):
    ``--die-at-step 3`` exits 42, the rerun resumes from step 2 and
    prints step 3's line EQUAL."""
    import tempfile

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train as TL
    from repro_torch.models import convert
    from repro_torch.train import trainer as TTR

    out = {}
    for arch_id in FAM_IDS:
        arch = TL.reduced_arch(registry.get(arch_id))
        p_cpu = arch.model.init_params(torch.Generator().manual_seed(26),
                                       arch.cfg, device="cpu")
        p_dev = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                          arch.cfg, device=dev)
        runs = []
        for params in (p_cpu, p_dev):
            stream = TL.make_stream(arch, FAM_SMALL_BATCH, 0, 26)
            state = TTR.init_state(26, params, arch.train_cfg)
            step = TTR.make_train_step(TL.stream_loss(arch, stream),
                                       arch.train_cfg)
            losses = []
            for _ in range(FAM_SMALL_STEPS):
                state, m = step(state, stream.next())
                losses.append(float(m["loss"]))
            runs.append(losses)
        (l_cpu, l_dev) = runs
        rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_cpu))
        out[arch_id] = dict(loss_rel=rel, cpu=l_cpu, card=l_dev)
        check(rel <= 1e-4, f"21d {arch_id}: card {l_dev} vs cpu {l_cpu}")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        argv = ["--arch", "nequip", "--reduced", "--device",
                TRAIN_LAUNCH_DEVICE, "--steps", "6", "--batch", "32",
                "--ckpt-dir", tmp,
                "--ckpt-every", "2", "--log-every", "1"]
        runs = []
        for extra in (["--die-at-step", "3"], []):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                try:
                    rc = TL.main(argv + extra)
                except SystemExit as e:
                    rc = e.code
            runs.append(dict(rc=rc, seconds=time.perf_counter() - t0,
                             stdout=buf.getvalue()[-2000:]))
        died, resumed = runs
        check(died["rc"] == 42 and "[failure-sim] dying at step 3"
              in died["stdout"], f"21d: launcher run 1 {died}")
        check(resumed["rc"] == 0 and "[restore] resumed from step 2"
              in resumed["stdout"] and "[done]" in resumed["stdout"],
              f"21d: launcher run 2 {resumed}")
        step3 = [ln.split("(")[0] for r in runs
                 for ln in r["stdout"].splitlines()
                 if ln.startswith("step     3 ")]
        check(len(step3) == 2 and step3[0] == step3[1],
              f"21d: step 3 lines {step3}")
        out["launcher"] = runs
    check(not torch.are_deterministic_algorithms_enabled(),
          "21d: the launcher left deterministic algorithms on")
    return out


def families_phase(results, dev):
    """Phase 21 (run right after phase 20): 21a-d.  Returns kernel 2's
    ``sasrec`` entry for the kernels line: its time at the catalog's
    shape and the scans and merges of 21a's requests."""
    card = results["device"]["nvidia_smi"]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scans, merges, row = sasrec_phase(dev)
    row["seconds"] = time.perf_counter() - t0
    results["families_21a"] = row
    log("families_21a", card=card,
        **{k: v for k, v in row.items() if k not in ("train", "request_ms")},
        train={k: v for k, v in row["train"].items()
               if k not in ("step_ms", "profile")},
        profile={k: v for k, v in row["train"]["profile"].items()
                 if k != "top_device_ms"},
        request_ms={k: {q: v[q] for q in ("p50", "p99")}
                    for k, v in row["request_ms"].items()})
    for key, fn in (("21b", recsys_phase), ("21c", nequip_phase),
                    ("21d", families_card_vs_cpu)):
        t0 = time.perf_counter()
        results[f"families_{key}"] = fn(dev)
        results[f"families_{key}"]["seconds"] = time.perf_counter() - t0
    log("families_21b", card=card, **results["families_21b"])
    log("families_21c", card=card, **results["families_21c"])
    log("families_21d", card=card,
        **{k: v for k, v in results["families_21d"].items()
           if k != "launcher"},
        launcher=[{k: r[k] for k in ("rc", "seconds")}
                  for r in results["families_21d"]["launcher"]])
    results["families_seconds"] = time.perf_counter() - t_phase
    log("families_phase", card=card, seconds=results["families_seconds"])
    return dict(row["kernel2_times"], launches=scans, merge_launches=merges,
                max_abs_err=max(c["max_abs_err"] for c in
                                row["kernel2_vs_plain"]["topk"].values()))


def ann_phases(results, dev):
    """Phases 3-8 and 13-18 over phase 3's index; returns the rows of
    kernels 1-6 for the ``kernels`` line (every tensor of these phases
    is released when it returns)."""
    import torch

    from repro_torch.core import ash as A
    from repro_torch.core import quantization as Q
    from repro_torch.core import scoring as S
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex, exact_topk, recall_curve
    from repro_torch.index import ivf as IV
    from repro_torch.kernels import ops, probe
    from repro_torch.kernels import ash_score as TK
    from repro_torch.kernels import ref

    # -- 3. train + encode on the card ----------------------------------
    # queries are held-out rows of the same distribution as the index
    n_q = (N_REQ + N_RERANK_REQ) * REQ_M
    data, t_data = sync_time(embedding_dataset, N + n_q, DIM, seed=0,
                             device=dev)
    X, queries = data[:N], data[N:]
    cfg = ASHConfig(**CFG)
    gen = torch.Generator().manual_seed(0)
    (model, history), t_train = sync_time(A.train, gen, X, cfg, device=dev)
    # training is reproducible from its seed: a second run, bit-identical
    model2, _ = A.train(torch.Generator().manual_seed(0), X, cfg, device=dev)
    train_same = bool(torch.equal(model.W, model2.W)
                      and torch.equal(model.landmarks, model2.landmarks))
    check(train_same, "two trainings from one seed differ")
    del model2
    index, t_encode = sync_time(
        AshIndex.build, gen, X, cfg, metric="dot", device=dev,
        model=model, keep_raw=True,
    )
    payload = index.payload
    check(payload.codes.shape == (N, 8) and payload.codes.is_cuda,
          "payload shape/device")
    # one vector encodes alike twice alone and as a row of a 64-row batch
    # (quant_exact's scans over a single row), and so does each of the
    # other 63 (encode's products run over fixed-shape row blocks)
    batch = A.encode(model, X[:64])

    def row_of(p, i):
        return (p.codes[i], p.scale[i], p.offset[i], p.cluster[i])

    def same_row(p, i, q, j):
        return all(torch.equal(a, b) for a, b in zip(row_of(p, i),
                                                     row_of(q, j)))

    alone = [A.encode(model, X[i:i + 1]) for i in range(64)]
    single_same = (same_row(A.encode(model, X[5:6]), 0, alone[5], 0)
                   and same_row(alone[5], 0, batch, 5))
    check(single_same, "one vector encodes differently alone and in a batch")
    rows_alone_equal = sum(same_row(p, 0, batch, i)
                           for i, p in enumerate(alone))
    check(rows_alone_equal == 64, f"{64 - rows_alone_equal} of 64 rows "
                                  "encode differently alone")
    del batch, alone
    results["build_index"] = dict(
        data_s=t_data, train_s=t_train, encode_s=t_encode,
        itq_iters=len(history), payload_bits=cfg.payload_bits(),
        train_twice_bit_identical=train_same,
        single_vector_encode_bit_identical=single_same,
        rows_of_64_alone_equal_batch=rows_alone_equal,
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
    max_err = {"ash_score": 0.0, "ash_score_topk": 0.0}
    compare = {}
    for metric in ("dot", "l2", "cos"):
        idx_m = index if metric == "dot" else AshIndex.from_parts(
            model, payload, metric=metric)
        # kernel 1 within the bound; the fused kernel EQUAL to the stable
        # top-k of kernel 1 and, against its plain version, scores within
        # the bound and ids equal wherever the score gap exceeds it
        flat, c = flat_scan_check(idx_m, q8, (K,), metric, metric=metric)
        args, qterm, rowterm, got = (
            flat[k] for k in ("args", "qterm", "rowterm", "got"))
        del flat
        max_err["ash_score"] = max(max_err["ash_score"], c["max_abs_err"])
        max_err["ash_score_topk"] = max(max_err["ash_score_topk"],
                                        c["topk"][K]["max_abs_err"])
        # fused == stable two-key sort of the materializing kernel
        rv = torch.rand(N, device=dev, generator=torch.Generator(
            device=dev).manual_seed(7)) > 0.1
        exact_eq = [c["topk"][K]["fused_equals_sorted"]]
        for n_valid, row_valid in ((None, rv), (N - 12345, None),
                                   (N - 12345, rv)):
            fs, fi = TK.ash_score_topk_cuda(*args, qterm, rowterm, n_valid,
                                            row_valid, b=payload.b, k=K,
                                            metric=metric)
            ms_, mi = ref.stable_top_k(
                ref.mask_rows_ref(got, n_valid, row_valid), K)
            exact_eq.append(bool(torch.equal(fs, ms_)
                                 and torch.equal(fi, mi.to(torch.int32))))
        check(all(exact_eq), f"{metric}: fused != sorted materialized "
                             f"{exact_eq}")
        # rows in ascending score order (every key passes the threshold)
        order = torch.sort(got[0], stable=True).indices
        a_args, a_qt, a_rt = ascending_operands(args, qterm, rowterm,
                                                (0, 2, 3, 4), (1, 5), order)
        a_full = TK.ash_score_cuda(*a_args, a_qt, a_rt, b=payload.b,
                                   metric=metric)
        check(bool((a_full[0, 1:] >= a_full[0, :-1]).all()),
              f"{metric}: reordered rows not ascending")
        fs, fi = TK.ash_score_topk_cuda(*a_args, a_qt, a_rt, b=payload.b,
                                        k=K, metric=metric)
        ms_, mi = ref.stable_top_k(a_full, K)
        exact_asc = bool(torch.equal(fs, ms_)
                         and torch.equal(fi, mi.to(torch.int32)))
        check(exact_asc, f"{metric}: fused != sorted on ascending rows")
        del a_args, a_full
        # k~ < k: the per-tile semantics of ref.tile_topk_ref
        fs, fi = TK.ash_score_topk_cuda(*args, qterm, rowterm, b=payload.b,
                                        k=10, k_tilde=4, metric=metric)
        ws, wi = ref.tile_topk_ref(got, torch.ones(N, dtype=torch.bool,
                                                   device=dev), 10, 4)
        exact_tiles = bool(torch.equal(fs, ws) and torch.equal(fi, wi))
        check(exact_tiles, f"{metric}: fused k~ < k != per-tile selection")
        compare[metric] = dict(max_abs_err=c["max_abs_err"],
                               max_err_over_bound=c["max_err_over_bound"],
                               max_bound=c["max_bound"],
                               topk_id_mismatch=c["topk"][K]["id_mismatch"],
                               fused_equals_sorted=exact_eq,
                               fused_ascending_equals_sorted=exact_asc,
                               fused_k_tilde_below_k_equals_tiles=exact_tiles)
        log("compare", metric=metric, **compare[metric])
    del got
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
        tol = ref.score_tolerance(Amat, bias, offset, qterm, rowterm,
                                  want_d, metric, d_pad).gather(1, safe)
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
        # kernel 4: a stable top-k over positions of kernel 3, mapped
        # back, with one scan launch and one merge launch
        before = dict(TK.launch_counts)
        ts, tr = TK.ash_score_gather_topk_cuda(
            codes, cand, *args[1:], qterm, rowterm, b=pl.b, k=K,
            metric=metric)
        check(TK.launch_counts["ash_score_gather_topk"]
              == before["ash_score_gather_topk"] + 1
              and TK.launch_counts["ash_topk_merge"]
              == before["ash_topk_merge"] + 1,
              f"{metric}: kernel 4 launches {TK.launch_counts}")
        vs, vp = ref.stable_top_k(g, K)
        exact4 = bool(torch.equal(ts, vs)
                      and torch.equal(tr, cand.gather(1, vp)))
        check(exact4, f"{metric}: fused gather != sorted gather")
        cases4 = gather_topk_cases(codes, cand, args[1:], qterm, rowterm,
                                   pl.b, metric, g)
        check(all(cases4.values()), f"{metric}: kernel 4 cases {cases4}")
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
        order = torch.sort(c[0], stable=True).indices
        a_args, a_qt, a_rt = ascending_operands(
            cargs, qterm, rowterm, (0, 4, 5, 6), (1, 2, 3, 7), order)
        a_full = TK.ash_score_coarse_cuda(*a_args, a_qt, a_rt, b=pl.b,
                                          metric=metric)
        check(bool((a_full[0, 1:] >= a_full[0, :-1]).all()),
              f"{metric}: reordered coarse rows not ascending")
        fs, fi = TK.ash_score_coarse_topk_cuda(*a_args, a_qt, a_rt, b=pl.b,
                                               k=L, metric=metric)
        ms_, mi = ref.stable_top_k(a_full, L)
        exact6_asc = bool(torch.equal(fs, ms_)
                          and torch.equal(fi, mi.to(torch.int32)))
        check(exact6_asc, f"{metric}: fused coarse != sorted, ascending")
        del a_args, a_full
        fs, fi = TK.ash_score_coarse_topk_cuda(*cargs, qterm, rowterm,
                                               b=pl.b, k=10, k_tilde=4,
                                               metric=metric)
        ws, wi = ref.tile_topk_ref(c, torch.ones(N, dtype=torch.bool,
                                                 device=dev), 10, 4)
        exact6_tiles = bool(torch.equal(fs, ws) and torch.equal(fi, wi))
        check(exact6_tiles, f"{metric}: fused coarse k~ < k != per-tile")
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
            gather_fused_cases=cases4,
            coarse_bit_equal_plain=exact5,
            coarse_fused_equals_sorted=exact6,
            coarse_fused_ascending_equals_sorted=exact6_asc,
            coarse_fused_k_tilde_below_k_equals_tiles=exact6_tiles,
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
    merges = dict(TK.merge_launches)
    # one scan and one merge launch per fused request
    check(launches["ash_score_topk"] == N_REQ
          and launches["ash_topk_merge"] == N_REQ
          and merges["ash_score_topk"] == N_REQ,
          f"fused kernel launches {launches}, merges {merges}")
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
        before_m = dict(TK.merge_launches)
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
        delta = {k: TK.launch_counts[k] - before[k]
                 for k in kernels + ("ash_score_topk",
                                     "ash_score_coarse_topk",
                                     "ash_score_gather_topk",
                                     "ash_topk_merge")}
        merged = {k: TK.merge_launches[k] - before_m[k]
                  for k in TK.merge_launches}
        # each fused scan (kernels 2, 6, 4) launches exactly one merge,
        # counted under its own name; a route through kernel 4 launches
        # it exactly once a request
        fused = delta["ash_score_topk"] + delta["ash_score_coarse_topk"]
        check(all(delta[k] >= N_ROUTE_REQ for k in kernels)
              and fused in (0, N_ROUTE_REQ)
              and all(merged[k] == delta[k] for k in merged)
              and delta["ash_topk_merge"] == sum(merged.values())
              and ("ash_score_gather_topk" not in kernels
                   or delta["ash_score_gather_topk"] == N_ROUTE_REQ),
              f"{name}: launches {delta}, merges {merged} over "
              f"{N_ROUTE_REQ} requests")
        route_ids[name] = torch.cat(ids_r)
        stream[name] = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99),
                            mean_ms=sum(lat) / len(lat),
                            qps=N_ROUTE_REQ * REQ_M / wall,
                            launches=delta, merges=merged)
        log("serve_route", route=name, **stream[name])
    launches_b = dict(TK.launch_counts)
    merges_b = dict(TK.merge_launches)
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
                                   merges=merges_b,
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
    rows = flat_scan_rows(index, q8)
    for row in rows:
        row.update(launches=launches[row["name"]],
                   max_abs_err=max_err[row["name"]])
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
            ms=probe.graph_ms(fn), plain_ms=event_ms(plain_fn, iters=10),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=event_ms(lib_fn), library_call=lib_call,
        ))
    results["kernels"] = rows
    results["gather_shape"] = dict(R=R, live_pairs=pairs,
                                   distinct_live_rows=uniq)
    # kernels 2, 6 and 4: the scan alone and the merge alone, on the strip
    # the scan really emits; the merge kernel EQUAL to its plain version
    # there (for kernel 4 with the positions mapped through the table);
    # each row's merge_launches is its own merges on the main path
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fused_cfg = {
        "ash_score_topk": (
            lambda: TK.ash_score_topk_cuda(*args, b=payload.b, k=K), K, None,
            ref.span_geometry(n, K, None, 2 * n_sm),
            merges["ash_score_topk"]),
        "ash_score_coarse_topk": (
            lambda: TK.ash_score_coarse_topk_cuda(*cargs, b=payload.b, k=L),
            L, None, ref.span_geometry(n, L, None, 2 * n_sm),
            merges_b["ash_score_coarse_topk"]),
        "ash_score_gather_topk": (
            lambda: TK.ash_score_gather_topk_cuda(gargs[0], grows,
                                                  *gargs[1:], b=pl.b, k=K),
            K, grows, ref.gather_span_geometry(R, REQ_M, K, None, n_sm),
            merges_b["ash_score_gather_topk"]),
    }
    fused_split = {}
    for row in rows:
        if row["name"] not in fused_cfg:
            continue
        fn, kk, trows, (n_spans, per, _), merges = fused_cfg[row["name"]]
        keys, run = capture_strip(fn)
        got_m = TK.ash_topk_merge_cuda(keys, kk, run, rows=trows)

        def merge_plain(keys=keys, kk=kk, trows=trows):
            s_, i_ = ref.merge_keys_ref(keys, kk)
            return s_, i_ if trows is None else ref.positions_to_rows(
                trows, i_)

        want_m = merge_plain()
        check(torch.equal(got_m[0], want_m[0])
              and torch.equal(got_m[1], want_m[1]),
              f"{row['name']}: merge kernel != its plain version")
        fused_split[row["name"]] = dict(
            spans=n_spans, tiles_per_span=per,
            keys_per_query=int(keys.shape[1]),
            valid_keys=int((keys != -1).sum()),
            scan_ms=scan_only_ms(fn),
            merge_ms=probe.graph_ms(lambda: TK.ash_topk_merge_cuda(
                keys, kk, run, rows=trows)),
            merge_plain_ms=event_ms(merge_plain),
            merge_equals_plain=True)
        row["merge_launches"] = merges
        row.update(scan_ms=fused_split[row["name"]]["scan_ms"],
                   merge_ms=fused_split[row["name"]]["merge_ms"])
    results["fused_strip"] = dict(kernels_2_4_6=fused_split)
    log("fused_strip", **results["fused_strip"])
    # the four scans that share the asymmetric scoring routine, alone
    results["scans"] = {
        "ash_score": rows[0]["ms"],
        "ash_score_topk_scan": fused_split["ash_score_topk"]["scan_ms"],
        "ash_score_gather": rows[2]["ms"],
        "ash_score_gather_topk_scan":
            fused_split["ash_score_gather_topk"]["scan_ms"]}
    log("scans", **results["scans"])
    log("gather_shape", **results["gather_shape"])
    del Vg, V8

    # -- 7b. where a request's time goes (torch.profiler) ---------------
    results["profile_fused_request"] = profile_requests(
        lambda q: index.search(q, k=K), queries)
    log("profile", **results["profile_fused_request"])
    results["profile_ivf_request"] = profile_requests(
        lambda q: ivf.search(q, k=K, nprobe=NPROBE), queries)
    log("profile_ivf", **results["profile_ivf_request"])
    results["profile_coarse_request"] = profile_requests(
        lambda q: index.search(q, k=10, coarse="int8"), queries)
    log("profile_coarse", **results["profile_coarse_request"])

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

    # -- 13. the serving engine --------------------------------------------
    # each kernel's launches: its phase 5/5b count plus 13b's engine
    # stream (launched once per fused engine call, not per request)
    eng_launches, eng_merges = serving_phases(results, index, ivf, queries)
    for row in rows:
        row["engine_launches"] = eng_launches[row["name"]]
        row["launches"] += eng_launches[row["name"]]
        if "merge_launches" in row:
            row["merge_launches"] += eng_merges[row["name"]]

    # -- 14, 15. the sharded and tiered backends ----------------------------
    # counts are zeroed first; each kernel's launches add those of the new
    # backends' own searches (_Tally), not of the flat and IVF searches
    # they are held against
    TK.reset_launch_counts()
    tally = _Tally()
    sharded_phase(results, index, queries, tally)
    tiered_phase(results, ivf, queries, tally)
    for name in ("ash_score", "ash_score_topk", "ash_score_gather",
                 "ash_score_gather_topk", "ash_score_coarse",
                 "ash_score_coarse_topk", "ash_topk_merge"):
        check(tally.launches.get(name, 0) > 0,
              f"phases 14-15 never launched {name}: {tally.launches}")
    for row in rows:
        row["index_launches"] = tally.launches.get(row["name"], 0)
        row["launches"] += row["index_launches"]
        if "merge_launches" in row:
            row["merge_launches"] += tally.merges.get(row["name"], 0)

    # -- 16, 17. durability and the launcher --------------------------------
    # counts are zeroed first; each kernel's launches add phase 16's
    # engine traffic and recovered-index searches (_Tally; the serial
    # replays they are held against are not counted) and the kernel
    # launches that phase 17's launcher processes print
    TK.reset_launch_counts()
    dur_tally = _Tally()
    durability_phase(results, index, queries, dur_tally)
    for name in ("ash_score", "ash_score_topk", "ash_score_gather",
                 "ash_score_gather_topk", "ash_score_coarse",
                 "ash_score_coarse_topk", "ash_topk_merge"):
        check(dur_tally.launches.get(name, 0) > 0,
              f"phase 16 never launched {name}: {dur_tally.launches}")
    serve_launches = {}
    launcher_phase(results, serve_launches)
    check(serve_launches.get("ash_score_topk", 0) > 0
          and serve_launches.get("ash_score_gather_topk", 0) > 0,
          f"phase 17's launchers launched {serve_launches}")
    for row in rows:
        row["durability_launches"] = dur_tally.launches.get(row["name"], 0)
        row["launcher_launches"] = serve_launches.get(row["name"], 0)
        row["launches"] += (row["durability_launches"]
                            + row["launcher_launches"])
        if "merge_launches" in row:
            row["merge_launches"] += dur_tally.merges.get(row["name"], 0)


    # -- 18. the paper's baselines at iso-bits -----------------------------
    # counts are zeroed first; kernels 1 and 2 add the RaBitQ index's
    # searches (_Tally; not the launches it is compared with)
    TK.reset_launch_counts()
    base_tally = _Tally()
    baselines_phase(results, index, X, queries, gt, rec["kernel"][10],
                    base_tally)
    for name in ("ash_score", "ash_score_topk", "ash_topk_merge"):
        check(base_tally.launches.get(name, 0) > 0,
              f"phase 18 never launched {name}: {base_tally.launches}")
    for row in rows:
        row["baselines_launches"] = base_tally.launches.get(row["name"], 0)
        row["launches"] += row["baselines_launches"]
        if "merge_launches" in row:
            row["merge_launches"] += base_tally.merges.get(row["name"], 0)
    return rows



# -- 22. the dry-run's plan against the card ----------------------------------
DRYRUN_JOBS = 3  # worker processes of the single-mesh dry-run child
DRYRUN_SINGLE = ["--multi-pod", "single"]  # its matrix: every cell
DRYRUN_TIMEOUT = 1000  # s from its start; the children run beside 19-12
PLAN_TOL = 0.01  # phase 22: a plan's argument bytes vs the card's


def plan_cells():
    """Phase 22's cells, each at the shape a phase runs on the card:
    (results key, arch, cell, shape overrides, the plan arguments that
    phase holds on the card)."""
    return [
        ("train_20a", "llama3.2-3b", "train_4k",
         {"global_batch": TRAIN_RUNS[0][1], "seq_len": TRAIN_SEQ}, 1),
        ("lm_build", "llama3.2-3b", "decode_32k_ashkv",
         {"global_batch": LM_BATCH, "seq_len": LM_MAX_LEN}, 2),
        ("families_21a", "sasrec", "train_batch",
         {"batch": FAM_TRAIN_BATCH}, 1),
        *[("families_21b", a, "train_batch", {"batch": FAM_TRAIN_BATCH}, 1)
          for a in ("dcn-v2", "fm", "autoint")],
        ("families_21c", "nequip", "molecule", {}, 1),
    ]


def start_dryruns():
    """Start phase 22's two children (CPU only: no card visible, niced,
    one thread each): ``launch.dryrun --multi-pod single`` over every
    non-skipped cell on the 256-card mesh, and the 1 x 1 plans of
    :func:`plan_cells`.  Returns {name: (process, rows file, log)}."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    plans = [[a, c, sh] for _, a, c, sh, _ in plan_cells()]
    extra = {"single": DRYRUN_SINGLE + ["--jobs", str(DRYRUN_JOBS)],
             "plan_1x1": ["--mesh", "1x1", "--cells", json.dumps(plans)]}
    procs = {}
    for name, args in extra.items():
        rows = out / f"dryrun_{name}.jsonl"
        rows.unlink(missing_ok=True)
        logf = out / f"dryrun_{name}.log"
        with open(logf, "w") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--json", str(rows)], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True,
                preexec_fn=lambda: os.nice(10)), rows, logf)
    return procs


def stop_dryruns(procs):
    """Kill whatever of the children (and their workers) still runs."""
    import signal

    for p, _, _ in procs.values():
        if p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _dryrun_rows(name, proc, rows, logf, t_start):
    """Wait for a dry-run child: (its rows, its own seconds); it must
    exit 0 with no failed row."""
    import re

    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                                   - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"22: dry-run child {name} still running "
                             f"after {DRYRUN_TIMEOUT} s")
    text = logf.read_text()
    done = re.search(r"dry-run done: (\d+) ok, (\d+) failed, ([\d.]+) s",
                     text)
    fails = [ln for ln in text.splitlines() if ln.startswith("FAILED")]
    check(rc == 0 and done and int(done.group(2)) == 0,
          f"22: dry-run child {name}: rc {rc}, {fails[:3]}")
    return ([json.loads(ln) for ln in rows.read_text().splitlines()],
            float(done.group(3)))


def plan_phase(results, procs, t_start):
    """22: the dry-run against the card.  The single-mesh dry-run child
    must have no failed row over the non-skipped matrix; the 1 x 1 plans
    of the cells phases 20a, 9-11 and 21a-c ran (no model is run again)
    are set beside what those phases measured: the plan's argument bytes
    (exact from the shapes) against ``memory_allocated()`` after the
    state was built (within PLAN_TOL), its traced peak against
    ``max_memory_allocated()`` (a ratio, no gate), and its counted FLOPs
    a step over the measured step time as a share of the card's dense
    bf16 peak (beside 20a's model-FLOP share)."""
    t0 = time.perf_counter()
    card = results["device"]["nvidia_smi"]
    waited = {}
    single, single_s = _dryrun_rows("single", *procs["single"], t_start)
    waited["single"] = time.perf_counter() - t0
    plans, plans_s = _dryrun_rows("plan_1x1", *procs["plan_1x1"], t_start)
    waited["plan_1x1"] = time.perf_counter() - t0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry

    want = sum(1 for _ in registry.all_cells(False))
    check(len(single) == want, f"22: {len(single)} single-mesh rows of "
          f"{want}")
    results["dryrun_single"] = dict(rows=single, seconds=single_s)
    log("dryrun_single", card=card, rows=len(single), failed=0,
        seconds=single_s, waited_s=waited["single"],
        fit_80g=sum(r["fits_80g_hbm"] for r in single),
        bottlenecks={b: sum(r["bottleneck"] == b for r in single)
                     for b in ("compute", "memory", "collective")})
    by = {(r["arch"], r["cell"]): r for r in plans}
    table = []
    for key, arch, cell, _, n_held in plan_cells():
        plan = by[(arch, cell)]
        row = results[key]
        if key == "families_21a":
            row = row["train"]
        elif key == "families_21b":
            row = row[arch]
        if key == "lm_build":
            step_ms = results["decode"]["p50_ms"]
            peak_gb = results["decode"]["peak_mem_gb"]
        else:
            step_ms = row["step_p50_ms"]
            peak_gb = row.get("train_peak_mem_gb", row["peak_mem_gb"])
        held = sum(plan["argument_bytes_by_arg"][:n_held])
        card_b = row["state_allocated_b"]
        diff = card_b / held - 1
        entry = dict(
            arch=arch, cell=cell, measured_in=key,
            plan_args_b=held, card_allocated_b=card_b, args_diff=diff,
            plan_other_args_b=sum(plan["argument_bytes_by_arg"][n_held:]),
            plan_peak_gb=plan["peak_gib_per_dev"] * 2**30 / 1e9,
            card_peak_gb=peak_gb,
            peak_ratio=plan["peak_gib_per_dev"] * 2**30 / 1e9 / peak_gb,
            plan_flops=plan["flops_per_dev"], step_ms=step_ms,
            hw_flop_share=plan["flops_per_dev"] / (step_ms / 1e3)
            / PEAK_BF16_FLOPS,
            plan_t_bound_ms=1e3 * max(plan["t_compute_s"],
                                      plan["t_memory_s"]),
            plan_bottleneck=plan["bottleneck"])
        if key == "train_20a":
            entry["model_flop_share"] = row["model_flop_share"]
        table.append(entry)
        log("plan_vs_card", card=card, **entry)
        check(abs(diff) <= PLAN_TOL,
              f"22: {arch}/{cell} plan arguments {held} B vs the card's "
              f"{card_b} B ({diff:+.4f})")
    results["plan_vs_card"] = dict(rows=table, plans_seconds=plans_s,
                                   waited_s=waited,
                                   seconds=time.perf_counter() - t0)
    log("plan_phase", card=card, single_seconds=single_s,
        plans_seconds=plans_s, seconds=time.perf_counter() - t0)


def main() -> int:
    # phase 20's deterministic steps need cuBLAS's fixed workspaces, set
    # before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ash_score as TK

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
    # registers and spills of kernels 7, 4, 1, 3, 5 and 6, and of their
    # main-path instances (kernel 7 at b_k = b_v = 4 with 8 PV m-tiles;
    # kernel 4 at b = 2, dot, lists of 128 keys for k = 100; kernels 1, 3
    # and 5 at b = 2, dot; kernel 6 at b = 2, dot, lists of 32 keys for the
    # coarse plans' L = 32)
    results["ptxas"] = {
        "ash_kv_attn_kernel": ptxas_report(
            libs, "ash_kv_attn_kernel", "ash_kv_attn_kernelILi4ELi4ELi8E"),
        "ash_gather_topk_kernel": ptxas_report(
            libs, "ash_gather_topk_kernel",
            "ash_gather_topk_kernelILi2ELi0ELi4E"),
        "ash_score_kernel": ptxas_report(
            libs, "ash_score_kernel", "ash_score_kernelILi2ELi0E"),
        "ash_gather_kernel": ptxas_report(
            libs, "ash_gather_kernel", "ash_gather_kernelILi2ELi0E"),
        "ash_coarse_kernel": ptxas_report(
            libs, "ash_coarse_kernel", "ash_coarse_kernelILi2ELi0ELb0E"),
        "ash_coarse_topk_kernel": ptxas_report(
            libs, "ash_coarse_topk_kernel",
            "ash_coarse_topk_kernelILi2ELi0ELi1E"),
    }
    log("ptxas", **results["ptxas"])

    # -- 22's children: the dry-run on the CPU, beside phases 19-12 ----------
    t_dry = time.perf_counter()
    procs = start_dryruns()
    try:
        return _phases(results, dev, smi, kind, procs, t_dry)
    finally:
        stop_dryruns(procs)


def _phases(results, dev, smi, kind, procs, t_dry) -> int:
    """Phases 19-22 and the last lines."""
    import torch

    # -- 19. granite-moe-3b decode, first, on the card's empty memory ------
    # batch 128 needs 79.8 GB of the card's 85.0; after the other phases
    # the process keeps ~7 GB that the allocator cannot give back (CUDA
    # context, library workspaces, profiler buffers: 78.2 GB free there,
    # measured), so this phase runs before them
    free, total = torch.cuda.mem_get_info()
    results["before_granite"] = dict(
        allocated_gb=torch.cuda.memory_allocated() / 1e9,
        free_gb=free / 1e9, total_gb=total / 1e9)
    log("before_granite", **results["before_granite"])
    k7_granite, granite_row = granite_phase(results, dev)

    # -- 20. LM training, right after phase 19 on the freed memory --------
    train_phase(results, dev)

    # -- 21. the recommender and interatomic families, on what 20 freed ---
    k2_sasrec = families_phase(results, dev)

    rows = ann_phases(results, dev)
    k2 = next(r for r in rows if r["name"] == "ash_score_topk")
    k2["launches"] += k2_sasrec["launches"]
    k2["merge_launches"] += k2_sasrec["merge_launches"]
    k2["sasrec"] = k2_sasrec
    rows.append(lm_phases(results, dev))
    rows[-1]["launches"] += k7_granite
    rows[-1]["granite"] = granite_row
    results["kernels"] = rows

    # -- 22. the dry-run's plan against the card ---------------------------
    plan_phase(results, procs, t_dry)

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
