"""Same-call comparison of scan-kernel variants on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe [--parent DIR]
        [--source NAME]

Builds variants of ``csrc/ash_score.cu`` (kernels 1, 2),
``csrc/ash_gather.cu`` (kernels 3, 4) and ``csrc/ash_coarse.cu``
(kernels 5, 6), listed in ``VARIANTS``: the sources as they are
("shipped"), copies with tuning constants (``constexpr int NAME = V;``)
replaced or with a source edit made (an other unpack, word loads,
kernel 5 scored a row a thread with dp4a), diagnostics with a part of
the work taken out, and, with ``--parent DIR``, the sources of another
checkout's ``csrc`` directory (for example a ``git archive`` of the
parent commit).  ``--source`` limits the run to some of the three
files.  One ``nvcc`` per library, all started together, into
``build/repro_torch/probe/``.  Then, on the operands of
``chip_smoke.py``'s phase 7 (n = 10^6 vectors at D = 256, b = 2,
d = 128, 64 landmarks; 8 queries; the IVF candidate table at nprobe = 8;
the coarse int8 queries of the flat index; and, for kernel 5 alone
("k5_wide"), random rows of b = 8 codes at d_pad = 2048, n = 2^16),
it times each variant's
kernels in two passes over the variants (the second in reverse order),
each time as 30 launches captured in a CUDA graph and replayed, and
holds the output of every variant but the diagnostics EQUAL to the
shipped kernel's: kernels 1, 3 and 5 bit for bit, and the key strips of
the fused scans (kernels 2, 4 and 6) key for key.

``--source requests`` times whole requests instead: direct
``AshIndex.search`` on ``chip_smoke.py``'s phase-3 index (n = 10^6
vectors of ``embedding_dataset(seed=0)`` at D = 256, the model trained
as there, the IVF index over the same payload) on the routes of phases
5 and 5b (8 rows a request), 1-row flat requests, 1,024-row flat
requests at k = 100 and with rerank = 256, and ``AshIndex.prepare`` of
8 and of 1,024 rows.  A request is timed on the host clock from the
call to ``torch.cuda.synchronize()`` after it.  Each checkout runs in a
process of its own with its own package and kernels (each builds its
kernels into its own ``build/``, the builds started together): with
``--parent DIR`` the checkout holding that ``csrc`` (its ``src`` three
levels up), in the order parent, this, this, parent.

Prints one JSON object and writes it to ``chiprun_out/probe.json``.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import ash_score as TK

ROOT = pathlib.Path(__file__).resolve().parents[3]
PROBE_DIR = _build.BUILD_DIR / "probe"
# Source edits of the probe's variants: (file, old text, new text).
# code_float with both constants of its and-or as immediates (the
# compiler then splits the and-or into two LOP3s a code)
IMMEDIATE = ("ash_common.cuh",
             "  const uint32_t expo = expo24 - ((uint32_t)s << 23);",
             "  const uint32_t expo = (uint32_t)(127 + 24 - s) << 23;")
# code_float through a denormal: l * 2^(s - 149) times 2^100, then times
# 2^(50 - s) minus 2^B - 1 in one FFMA (one integer op and two FMA-pipe
# ops a code); the same floats
DENORMAL = ("ash_common.cuh", """\
  const uint32_t expo = expo24 - ((uint32_t)s << 23);  // 2^E, E = 24 - s
  const uint32_t sub = ((uint32_t)(127 + 24 - s) << 23) | (GMAX << (s - 1));
  return __fsub_rn(__uint_as_float((w & (LEVEL_MASK << s)) | expo),
                   __uint_as_float(sub));""", """\
  const float d = __uint_as_float(w & (LEVEL_MASK << s));
  return __fmaf_rn(__fmul_rn(d, __uint_as_float(227u << 23)),
                   __uint_as_float((uint32_t)(127 + 50 - s) << 23),
                   -(float)GMAX);""")
# rows read as 4-byte words (a quarter of the unrolled loop body)
WORD_LOADS = ("ash_common.cuh", "  a.vec4 = wd % 4 == 0 &&",
              "  a.vec4 = false && wd % 4 == 0 &&")
# diagnostics (outputs not compared): a part of the work taken out
NO_UNPACK = ("ash_common.cuh", "  const int g = c / K, s = B * (1 + c % K);",
             "  return __uint_as_float(word >> 9 | 0x3f800000u);\n"
             "  const int g = c / K, s = B * (1 + c % K);")
K1_NO_LDS = ("ash_score.cu",
             "      const float4 lo = q4[QS / 4 * (w * CPW + c)],\n"
             "                   hi = q4[QS / 4 * (w * CPW + c) + 1];",
             "      const float4 lo = make_float4(0.1f * c, 0.2f, 0.3f, 0.4f),"
             " hi = make_float4(0.5f, 0.6f, 0.7f, 0.8f + w);")
# kernel 2 without its selection: a tile's scores summed into a value no
# tile takes, then the next tile
K2_NO_SELECT = ("ash_select.cuh", "    score(j, q0, s);\n",
                "    score(j, q0, s);\n    {\n"
                "      float z = 0.f;\n"
                "      for (int r = 0; r < ROWS; ++r)\n"
                "        for (int i = 0; i < MT; ++i) z += s[r][i];\n"
                "      if (z == 1234.5f) strip[0] = 1;\n"
                "      continue;\n    }\n")
SAME_ROWS = ("ash_common.cuh", "a.codes + (size_t)j[r] * a.wd) + w4);",
             "a.codes + (size_t)(r & 1) * a.wd) + w4);")
K1_NO_MATH = ("ash_score.cu",
              "  auto word = [&](const uint32_t (&wv)[ROWS], int w) {",
              "  auto word = [&](const uint32_t (&wv)[ROWS], int w) {\n"
              "    for (int r = 0; r < ROWS; ++r) acc[r][0] = __fadd_rn("
              "acc[r][0], __uint_as_float(wv[r] >> 9 | 0x3f800000u));\n"
              "    return;")
K3_NO_MATH = ("ash_gather.cu",
              "  auto word = [&](const uint32_t (&wv)[P], int w) {",
              "  auto word = [&](const uint32_t (&wv)[P], int w) {\n"
              "    for (int p = 0; p < P; ++p) acc[p] = __fadd_rn("
              "acc[p], __uint_as_float(wv[p] >> 9 | 0x3f800000u));\n"
              "    return;")
# kernel 5 scored a row a thread, with kernel 6's dp4a byte-plane routine
K5_DP4A_ROWS = (
    ("ash_coarse.cu", "template <int B, int METRIC>\nstruct LaunchCoarse {",
     """template <int B, int METRIC>
__global__ void __launch_bounds__(256)
    coarse_rows_kernel(ScanArgs a, CoarseQ cq, int d_pad,
                       float* __restrict__ out) {
  extern __shared__ int4 smem_i4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem_i4);
  const int m0 = blockIdx.y * MT;
  load_coarse_chunk<B>(a, cq, d_pad, m0, q_s);
  __syncthreads();
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= a.n) return;
  float s[MT];
  coarse_row<B, METRIC>(a, cq, j, m0, q_s, s);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (m0 + i < a.m) out[(size_t)(m0 + i) * a.n + j] = s[i];
}

template <int B, int METRIC>
struct LaunchCoarse {"""),
    ("ash_coarse.cu", """\
  static int run(ScanArgs a, CoarseQ cq, int d_pad, float* out,
                 cudaStream_t stream) {
    const CoarseChunks ck""", """\
  static int run(ScanArgs a, CoarseQ cq, int d_pad, float* out,
                 cudaStream_t stream) {
    {
      const size_t smem = coarse_chunk_bytes(d_pad);
      int rc = set_smem(coarse_rows_kernel<B, METRIC>, smem);
      if (rc) return rc;
      dim3 grid((a.n + 255) / 256, (a.m + MT - 1) / MT);
      coarse_rows_kernel<B, METRIC><<<grid, 256, smem, stream>>>(
          a, cq, d_pad, out);
      return (int)cudaGetLastError();
    }
    const CoarseChunks ck"""),
)
# kernel 5 with one tile a block (a block per 256 rows, not persistent)
K5_TILE_BLOCKS = ("ash_coarse.cu",
                  "  dim3 grid(n_tiles < per_y ? n_tiles : per_y, y);",
                  "  dim3 grid(n_tiles, y);")
# kernel 5's rings 16 bytes past their 128-byte boundary
K5_RING_OFF16 = ("ash_coarse.cu", "  return (bytes + 127) / 128 * 128;",
                 "  return (bytes + 127) / 128 * 128 + 16;")
K5_COPIES4 = ("ash_coarse.cu", "    const int copy16 = (bases & 15u) == 0 &&",
              "    const int copy16 = 0 &&")
# diagnostics of kernel 5: the products as xors (no mma); no store (a
# value no score takes); the accumulator's bits stored as the score (no
# epilogue); the copies alone (each stage waited for and dropped)
K5_NO_MMA = ("ash_coarse.cu", "                                         "
             "uint32_t b1) {\n",
             "                                         uint32_t b1) {\n"
             "  c[0] += a0 ^ b0; c[1] += a1 ^ b1; c[2] += a2; c[3] += a3;\n"
             "  return;\n")
K5_NO_STORES = ("ash_coarse.cu", "      if (whole || j0 + row < a.n) {",
                "      if (__float_as_uint(s0) == 0x7fc01234u) {")
K5_NO_EPILOGUE = ("ash_coarse.cu",
                  "  const float dotc = __fmul_rn((float)acc, qs);",
                  "  return __int_as_float(acc);\n"
                  "  const float dotc = __fmul_rn((float)acc, qs);")
K5_COPIES_ONLY = ("ash_coarse.cu",
                  "      const char* st = ring + (i % S) * SB;\n",
                  "      if (k >= 0) {\n        __syncwarp();\n"
                  "        continue;\n      }\n"
                  "      const char* st = ring + (i % S) * SB;\n")
# (label, source, {constant: value}, edits, compared, fused scan too);
# "shipped" is the source as it is.  Without the fused scan, its C entry
# point is compiled out (a faster build) and only kernel 1 or 3 is timed.
VARIANTS = (
    ("shipped", "ash_score", {}, (), True, True),
    ("k1_immediate_exponents", "ash_score", {}, (IMMEDIATE,), True, True),
    ("k1_denormal", "ash_score", {}, (DENORMAL,), True, False),
    ("k1_word_loads", "ash_score", {}, (WORD_LOADS,), True, False),
    ("k1_rows1", "ash_score", {"SCORE_ROWS": 1}, (), True, False),
    ("k1_rows2", "ash_score", {"SCORE_ROWS": 2}, (), True, False),
    ("k1_rows2_min_blocks3", "ash_score",
     {"SCORE_ROWS": 2, "SCORE_MIN_BLOCKS": 3}, (), True, False),
    ("k1_rows4", "ash_score", {"SCORE_ROWS": 4}, (), True, False),
    ("k1_threads128", "ash_score", {"SCORE_THREADS": 128}, (), True, False),
    ("k1_threads128_min_blocks5", "ash_score",
     {"SCORE_THREADS": 128, "SCORE_MIN_BLOCKS": 5}, (), True, False),
    ("k1_min_blocks3", "ash_score", {"SCORE_MIN_BLOCKS": 3}, (), True,
     False),
    ("k1_diag_no_unpack", "ash_score", {}, (NO_UNPACK,), False, False),
    ("k1_diag_no_shared_loads", "ash_score", {}, (K1_NO_LDS,), False, False),
    ("k1_diag_two_rows_only", "ash_score", {}, (SAME_ROWS,), False,
     False),
    ("k1_diag_loads_only", "ash_score", {}, (K1_NO_MATH,), False, False),
    ("shipped", "ash_gather", {}, (), True, True),
    ("k3_immediate_exponents", "ash_gather", {}, (IMMEDIATE,), True, True),
    ("k3_denormal", "ash_gather", {}, (DENORMAL,), True, False),
    ("k3_word_loads", "ash_gather", {}, (WORD_LOADS,), True, False),
    ("k3_positions1", "ash_gather", {"GATHER_POSITIONS": 1}, (), True, False),
    ("k3_positions4", "ash_gather", {"GATHER_POSITIONS": 4}, (), True,
     False),
    ("k3_threads64", "ash_gather", {"GATHER_THREADS": 64}, (), True, False),
    ("k3_threads256", "ash_gather", {"GATHER_THREADS": 256}, (), True,
     False),
    ("k3_min_blocks12", "ash_gather", {"GATHER_MIN_BLOCKS": 12}, (), True,
     False),
    ("k3_min_blocks16", "ash_gather", {"GATHER_MIN_BLOCKS": 16}, (), True,
     False),
    ("k3_diag_no_unpack", "ash_gather", {}, (NO_UNPACK,), False, False),
    ("k3_diag_two_rows_only", "ash_gather", {}, (SAME_ROWS,), False,
     False),
    ("k3_diag_loads_only", "ash_gather", {}, (K3_NO_MATH,), False, False),
    ("shipped", "ash_coarse", {}, (), True, True),
    ("k5_groups1", "ash_coarse", {"COARSE_GROUPS": 1}, (), True, False),
    ("k5_groups4", "ash_coarse", {"COARSE_GROUPS": 4}, (), True, False),
    ("k5_stages2", "ash_coarse", {"COARSE_STAGES": 2}, (), True, False),
    ("k5_stages3", "ash_coarse", {"COARSE_STAGES": 3}, (), True, False),
    ("k5_stages6", "ash_coarse", {"COARSE_STAGES": 6}, (), True, False),
    ("k5_warps4", "ash_coarse", {"COARSE_WARPS": 4}, (), True, False),
    ("k5_min_blocks2", "ash_coarse", {"COARSE_MIN_BLOCKS": 2}, (), True,
     False),
    ("k5_min_blocks4", "ash_coarse", {"COARSE_MIN_BLOCKS": 4}, (), True,
     False),
    ("k5_ipq_global", "ash_coarse", {"IPQ_SMEM_MAX": 0}, (), True, False),
    ("k5_tile_blocks", "ash_coarse", {}, (K5_TILE_BLOCKS,), True, False),
    ("k5_copies4", "ash_coarse", {}, (K5_COPIES4,), True, False),
    ("k5_ring_off16", "ash_coarse", {}, (K5_RING_OFF16,), True, False),
    ("k5_dp4a_rows", "ash_coarse", {}, K5_DP4A_ROWS, True, False),
    ("k5_diag_no_mma", "ash_coarse", {}, (K5_NO_MMA,), False, False),
    ("k5_diag_no_stores", "ash_coarse", {}, (K5_NO_STORES,), False, False),
    ("k5_diag_no_epilogue", "ash_coarse", {}, (K5_NO_EPILOGUE,), False,
     False),
    ("k5_diag_copies_only", "ash_coarse", {}, (K5_COPIES_ONLY,), False,
     False),
)
# compiling the fused scan's C entry point out (the last one of each file)
SCAN_ONLY = {
    "ash_score": ("ash_score.cu", "int ash_score_topk_launch(",
                  "#if 0\nint ash_score_topk_launch("),
    "ash_gather": ("ash_gather.cu", "int ash_gather_topk_launch(",
                   "#if 0\nint ash_gather_topk_launch("),
    "ash_coarse": ("ash_coarse.cu", "int ash_coarse_topk_launch(",
                   "#if 0\nint ash_coarse_topk_launch("),
}
SOURCES = ("ash_score", "ash_gather", "ash_coarse")
K, NPROBE, REQ_M = 100, 8, 8


def _variant_dir(label: str, csrc: pathlib.Path, source: str, consts: dict,
                 edits) -> pathlib.Path:
    """A copy of ``csrc`` with ``consts`` replaced in ``<source>.cu`` and
    each (file, old, new) of ``edits`` made once."""
    out = PROBE_DIR / label / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cu*"):
        text = f.read_text()
        if f.stem == source and f.suffix == ".cu":
            for name, value in consts.items():
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
                if n != 1:
                    raise ValueError(f"{label}: no constant {name} in "
                                     f"{f.name}")
        for fname, old, new in edits:
            if fname == f.name:
                if text.count(old) != 1:
                    raise ValueError(f"{label}: edit not found once in "
                                     f"{f.name}: {old[:60]!r}")
                text = text.replace(old, new)
                if fname.endswith(".cu") and new.startswith("#if 0"):
                    text = text.replace('}  // extern "C"',
                                        '#endif\n}  // extern "C"')
        (out / f.name).write_text(text)
    return out


def build(variants) -> dict:
    """{(label, source): library path}, one nvcc each, in parallel."""
    procs = []
    for label, csrc, source, consts, edits in variants:
        d = _variant_dir(label, csrc, source, consts, edits)
        lib = d.parent / f"{source}.so"
        log = open(d.parent / f"{source}.log", "w")
        procs.append((label, source, lib, log, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(d / f"{source}.cu")], stdout=log,
            stderr=subprocess.STDOUT)))
    libs, failed = {}, []
    for label, source, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{label}/{source}: nvcc exit {rc}")
        libs[(label, source)] = lib
    if failed:
        raise RuntimeError("probe build failed: " + ", ".join(failed))
    return libs


def _load(path: pathlib.Path, source: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (n_ptr, n_int) in TK._ENTRY_POINTS[source].items():
        if not hasattr(lib, fn):  # compiled out
            continue
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * n_ptr
                                     + [ctypes.c_int] * n_int
                                     + [ctypes.c_void_p])
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def graph_ms(fn, iters=30) -> float:
    """Device ms a call: ``iters`` calls captured in a CUDA graph, its
    replay timed with CUDA events (the host's launch rate plays no part),
    the mean of three replays."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def operands(dev):
    """Phase 7's operands: the flat and IVF indexes' dot-metric scan
    operands for 8 held-out queries, the nprobe = 8 table, and the flat
    index's coarse operands for the same queries."""
    from repro_torch.core import ash as A
    from repro_torch.core import scoring as S
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex
    from repro_torch.index import ivf as IV
    from repro_torch.kernels import ops

    data = embedding_dataset(1_000_000 + REQ_M, 256, seed=0, device=dev)
    X, q8 = data[:-REQ_M], data[-REQ_M:]
    cfg = ASHConfig(b=2, d=128, n_landmarks=64)
    model, _ = A.train(torch.Generator().manual_seed(0), X, cfg, device=dev)
    index = AshIndex.build(torch.Generator().manual_seed(0), X, cfg,
                           metric="dot", device=dev, model=model)
    fprep = index.prepare(q8)
    flat = ops._score_args(fprep, index.payload)
    coarse = ops._coarse_score_args(
        fprep, S.prepare_coarse_queries(fprep, index._state.coarse.mean),
        index.payload)
    ivf = AshIndex.from_parts(model, index.payload, backend="ivf",
                              metric="dot")
    st = ivf._state
    prep = ivf.prepare(q8)
    rows = IV.candidate_rows(st, IV._probe_lists(st, prep, NPROBE))
    return flat, ops._score_args(prep, st.payload), rows.contiguous(), coarse


def wide_coarse(dev, n=1 << 16, wd=512, C=64):
    """Kernel 5's operands at a wide row, from seed 0: n rows of wd
    random words (b = 8 codes, d_pad = 4 * wd), 8 int8 queries and
    random headers."""
    g = torch.Generator().manual_seed(0)
    m = REQ_M
    codes = torch.randint(-2**31, 2**31 - 1, (n, wd), generator=g,
                          dtype=torch.int32)
    q = torch.randint(-127, 128, (m, 4 * wd), generator=g,
                      dtype=torch.int8)
    f = lambda *shape: torch.rand(*shape, generator=g) + 0.5  # noqa: E731
    cl = torch.randint(0, C, (n,), generator=g, dtype=torch.int32)
    t = (codes, q, f(m) * 1e-3, f(m), f(n), f(n), cl, f(m, C))
    return tuple(x.to(dev) for x in t)


def calls(lib, source, fused, flat, gath, rows, coarse, wide, b, n_sm):
    """{kernel: (launch, output)} of one library on the operands: kernel
    1, 3 or 5 (kernel 5 also on ``wide``, at b = 8), and with ``fused``
    the scan of kernel 2, 4 or 6 (kernel 6 with lists of L = 32 keys, as
    the coarse plans)."""
    P = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    S = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {}
    if source == "ash_score":
        codes, q, sc, off, cl, ipq = flat
        n, wd = codes.shape
        m, C = q.shape[0], ipq.shape[1]
        res = torch.empty(m, n, device=codes.device)
        head = [P(codes), P(q), P(sc), P(off), P(cl), P(ipq), None, None]
        out["k1"] = (lambda: lib.ash_score_launch(
            *head, P(res), n, m, wd, C, b, 0, S()), res)
        if not fused:
            return out
        chunk = ref.dense_query_chunk(m, q.shape[1], K)
        n_spans, per, L = ref.dense_span_geometry(n, m, K, None, chunk,
                                                  n_sm)
        strip = torch.empty(m, n_spans * L, dtype=torch.int64,
                            device=codes.device)
        out["k2_scan"] = (lambda: lib.ash_score_topk_launch(
            *head, None, P(strip), n, m, wd, C, b, 0, L, per, n_spans,
            chunk, S()), strip)
    elif source == "ash_coarse":
        codes, q, qs, qc, sc, off, cl, ipq = coarse
        n, wd = codes.shape
        m, C = q.shape[0], ipq.shape[1]
        res = torch.empty(m, n, device=codes.device)
        head = [P(codes), P(q), P(qs), P(qc), P(sc), P(off), P(cl), P(ipq),
                None, None]
        out["k5"] = (lambda: lib.ash_coarse_launch(
            *head, P(res), n, m, wd, C, b, 0, S()), res)
        wn, wwd = wide[0].shape
        wres = torch.empty(m, wn, device=codes.device)
        whead = [P(x) for x in wide] + [None, None]
        out["k5_wide"] = (lambda: lib.ash_coarse_launch(
            *whead, P(wres), wn, m, wwd, wide[7].shape[1], 8, 0, S()), wres)
        if not fused:
            return out
        n_spans, per, L = ref.span_geometry(n, 32, None, 2 * n_sm)
        strip = torch.empty(m, n_spans * L, dtype=torch.int64,
                            device=codes.device)
        out["k6_scan"] = (lambda: lib.ash_coarse_topk_launch(
            *head, None, P(strip), n, m, wd, C, b, 0, L, per, n_spans,
            S()), strip)
    else:
        codes, q, sc, off, cl, ipq = gath
        n, wd = codes.shape
        m, C, R = q.shape[0], ipq.shape[1], rows.shape[1]
        res = torch.empty(m, R, device=codes.device)
        head = [P(codes), P(rows), P(q), P(sc), P(off), P(cl), P(ipq), None,
                None]
        out["k3"] = (lambda: lib.ash_gather_launch(
            *head, P(res), n, m, R, wd, C, b, 0, S()), res)
        if not fused:
            return out
        n_spans, per, L = ref.gather_span_geometry(R, m, K, None, n_sm)
        strip = torch.empty(m, n_spans * L, dtype=torch.int64,
                            device=codes.device)
        out["k4_scan"] = (lambda: lib.ash_gather_topk_launch(
            *head, P(strip), n, m, R, wd, C, b, 0, L, per, n_spans,
            S()), strip)
    return out


# ``--source k2``: kernel 2 with its merge, (name, m, n, b, d_pad, k): at
# the t2i cells' shapes (a 1,024-row call, the engine's buckets), at
# phase 7's and at SASRec's catalog; the wide tile's blocks a call
# (``ref.dense_span_geometry``) as multiples of the SMs; variants of the
# kernel timed beside it
K2_SHAPES = (("cell", 1024, 10_000_000, 2, 128, 100),
             ("bucket128", 128, 10_000_000, 2, 128, 100),
             ("bucket32", 32, 10_000_000, 2, 128, 100),
             ("bucket8", REQ_M, 10_000_000, 2, 128, 100),
             ("table", REQ_M, 1_000_000, 2, 128, 100),
             ("sasrec_k10", REQ_M, 1 << 20, 4, 32, 10),
             ("sasrec_k100", REQ_M, 1 << 20, 4, 32, 100))
K2_WIDE_BLOCKS = (1, 2, 4)  # the wide tile's blocks a call, an SM
# (label, constants, edits); "diag" variants are not compared
K2_VARIANTS = (("diag_no_select", {}, (K2_NO_SELECT,)),)
K2_ITERS = {"cell": 2, "bucket128": 4, "bucket32": 10, "bucket8": 20,
            "table": 30, "sasrec_k10": 30, "sasrec_k100": 30}
FP32_PEAK = 67e12  # FLOP/s, H100 SXM outside the tensor cores


def _k2_takes_chunk(csrc: pathlib.Path) -> bool:
    """Whether a checkout's kernel 2 entry point takes the query chunk
    (the register-tiled kernel) or predates it."""
    text = (csrc / "ash_score.cu").read_text()
    return "int n_spans, int chunk, void* stream" in text


def _dense_operands(dev, m, n, b, d_pad, C=64, seed=0):
    """Random operands of the dense scan (dot): n rows of packed codes,
    m queries, headers; made on the card from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    wd = d_pad * b // 32
    codes = torch.randint(-2**31, 2**31 - 1, (n, wd), generator=g,
                          dtype=torch.int32, device=dev)
    f = lambda *s: torch.rand(*s, generator=g, device=dev) + 0.5  # noqa
    q = torch.randn(m, d_pad, generator=g, device=dev)
    cl = torch.randint(0, C, (n,), generator=g, dtype=torch.int32,
                       device=dev)
    return codes, q, f(n), f(n) - 1.0, cl, torch.randn(m, C, generator=g,
                                                        device=dev)


def k2_run(parent) -> dict:
    """Kernel 2 with its merge at ``K2_SHAPES``: this checkout's narrow
    tile, its wide tile at each block count of ``K2_WIDE_BLOCKS`` and its
    variants, and with ``parent`` the other checkout's kernel, all in
    this process on one card; each merged result EQUAL to the first
    one's; ms a call (CUDA-graph replays) against the fp32 bound."""
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    variants = [("shipped", _build.CSRC, "ash_score", {}, ())]
    variants += [(f"k2_{name}", _build.CSRC, "ash_score", c, e)
                 for name, c, e in K2_VARIANTS]
    if parent is not None:
        variants.append(("parent", parent.resolve(), "ash_score", {}, ()))
    libs = {label: _load(path, "ash_score")
            for (label, _), path in build(variants).items()}
    new_abi = {label: label != "parent" or _k2_takes_chunk(parent)
               for label in libs}
    for label, lib in libs.items():
        if not new_abi[label]:
            lib.ash_score_topk_launch.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])
    out = dict(registers=_registers(variants), shapes={})
    P = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    for name, m, n, b, d_pad, k in K2_SHAPES:
        codes, q, sc, off, cl, ipq = _dense_operands(dev, m, n, b, d_pad)
        head = [P(codes), P(q), P(sc), P(off), P(cl), P(ipq), None, None]
        wd, C = codes.shape[1], ipq.shape[1]
        runs = {}

        def add(key, lib, chunk, geometry):
            n_spans, per, L = geometry
            strip = torch.empty(m, n_spans * L, dtype=torch.int64,
                                device=dev)
            tail = (L, per, n_spans) + (() if chunk is None else (chunk,))

            def call():
                rc = lib.ash_score_topk_launch(
                    *head, None, P(strip), n, m, wd, C, b, 0, *tail,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{key}: cudaError {rc}")
                return TK.ash_topk_merge_cuda(strip, k, L)

            runs[key] = (call, dict(spans=n_spans, tiles_per_span=per))

        if parent is not None:
            if new_abi["parent"]:
                chunk = ref.dense_query_chunk(m, d_pad, k)
                add("parent", libs["parent"], chunk, ref.dense_span_geometry(
                    n, m, k, None, chunk, n_sm))
            else:
                add("parent", libs["parent"], None,
                    ref.span_geometry(n, k, None, 2 * n_sm))
        add(f"shipped/chunk{ref.MT}", libs["shipped"], ref.MT,
            ref.dense_span_geometry(n, m, k, None, ref.MT, n_sm))
        for w in K2_WIDE_BLOCKS:
            add(f"shipped/chunk{ref.WIDE_CHUNK}/blocks{w}x", libs["shipped"],
                ref.WIDE_CHUNK, ref.dense_span_geometry(
                    n, m, k, None, ref.WIDE_CHUNK, n_sm, w * n_sm))
        chunk = ref.dense_query_chunk(m, d_pad, k)
        for label in libs:
            if label.startswith("k2_"):
                add(f"{label}/chunk{chunk}", libs[label], chunk,
                    ref.dense_span_geometry(n, m, k, None, chunk, n_sm))
        first, want, rows = None, None, {}
        for key, (call, info) in runs.items():
            got = call()
            torch.cuda.synchronize()
            if want is None:
                first, want = key, got
            rows[key] = dict(info, equal=bool(
                torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])))
            if "diag" in key:
                rows[key]["equal"] = None
        for order in (list(runs), list(runs)[::-1]):
            for key in order:
                rows[key].setdefault("ms", []).append(
                    graph_ms(runs[key][0], K2_ITERS[name]))
        bound_ms = m * n * (2 * d_pad + 3) / FP32_PEAK * 1e3
        for row in rows.values():
            row["fp32_bound_share"] = bound_ms / min(row["ms"])
        out["shapes"][name] = dict(m=m, n=n, b=b, d_pad=d_pad, k=k,
                                   fp32_bound_ms=bound_ms, compared_to=first,
                                   runs=rows)
        del codes, q, sc, off, cl, ipq, runs
        torch.cuda.empty_cache()
    return out


def _registers(variants) -> dict:
    """Registers and spills of each library's kernel 2 instances at b = 2,
    dot, lists of 128 keys (``-Xptxas -v`` in the build logs)."""
    regs = {}
    for label, _, source, _, _ in variants:
        log = PROBE_DIR / label / f"{source}.log"
        cur = ""
        for ln in log.read_text().splitlines():
            mt = re.search(r"Compiling entry function '(\S+)'", ln)
            if mt:
                cur = mt.group(1)
            mt = re.search(r"ash_score_topk_kernelILi2ELi0ELi4E(Li(\d+)E)?E",
                           cur)
            if mt and ("Used" in ln or "spill" in ln):
                tile = f"chunk{mt.group(2)}" if mt.group(2) else "parent"
                regs.setdefault(f"{label}/{tile}", []).append(ln.strip())
    return regs


# ``--source requests``: (name, backend, rows a request, requests,
# search keywords); the 8-row routes are phases 5 and 5b's
REQUEST_ROUTES = (
    ("flat_k100", "flat", REQ_M, 300, dict(k=K)),
    ("flat_k10_rerank256", "flat", REQ_M, 300, dict(k=10, rerank=256)),
    ("ivf_k100", "ivf", REQ_M, 300, dict(k=K, nprobe=NPROBE)),
    ("ivf_k10_rerank256", "ivf", REQ_M, 300,
     dict(k=10, nprobe=NPROBE, rerank=256)),
    ("flat_coarse_k10", "flat", REQ_M, 300, dict(k=10, coarse="int8")),
    ("flat_coarse_k10_rerank256", "flat", REQ_M, 300,
     dict(k=10, coarse="int8", rerank=256)),
    ("ivf_coarse_k10", "ivf", REQ_M, 300,
     dict(k=10, nprobe=NPROBE, coarse="int8")),
    ("flat_k10_1q", "flat", 1, 300, dict(k=10)),
    ("flat_k100_1024q", "flat", 1024, 30, dict(k=K)),
    ("flat_k10_rerank256_1024q", "flat", 1024, 30, dict(k=10, rerank=256)),
)
REQUEST_WARMUP = 10


def _pct(v, p):
    v = sorted(v)
    return v[min(len(v) - 1, int(round(p / 100 * (len(v) - 1))))]


def request_times() -> dict:
    """One checkout's request latencies (the package imported as
    ``repro_torch`` is the one timed)."""
    from repro_torch.core import ash as A
    from repro_torch.core.types import ASHConfig
    from repro_torch.data.synthetic import embedding_dataset
    from repro_torch.index import AshIndex

    dev = torch.device("cuda")
    n, n_q = 1_000_000, 1128  # chip_smoke.py's N and held-out rows
    data = embedding_dataset(n + n_q, 256, seed=0, device=dev)
    X, queries = data[:n], data[n:]
    cfg = ASHConfig(b=2, d=128, n_landmarks=64)
    gen = torch.Generator().manual_seed(0)
    model, _ = A.train(gen, X, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flat = AshIndex.build(gen, X, cfg, metric="dot", device=dev,
                          model=model, keep_raw=True)
    torch.cuda.synchronize()
    out = {"encode_s": time.perf_counter() - t0}
    ivf = AshIndex.from_parts(model, flat.payload, backend="ivf",
                              metric="dot", raw=flat._state.raw)
    indexes = {"flat": flat, "ivf": ivf}
    del X, data

    def timed(fn, n_req):
        for r in range(REQUEST_WARMUP):
            fn(r)
        torch.cuda.synchronize()
        lat = []
        for r in range(n_req):
            t0 = time.perf_counter()
            fn(r)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        return dict(p50_ms=_pct(lat, 50), p99_ms=_pct(lat, 99),
                    mean_ms=sum(lat) / len(lat), requests=n_req)

    for name, backend, m, n_req, kw in REQUEST_ROUTES:
        idx = indexes[backend]

        def request(r, idx=idx, m=m, kw=kw):
            o = (r * m) % (n_q - m + 1)
            idx.search(queries[o:o + m], **kw)

        out[name] = timed(request, n_req)
    for m, n_req in ((REQ_M, 300), (1024, 30)):
        out[f"prepare_{m}"] = timed(
            lambda r, m=m: flat.prepare(queries[:m]), n_req)
    return out


def compare_requests(parent) -> list:
    """``request_times`` of this checkout and, with ``parent`` (a
    ``csrc`` directory), of the checkout holding it, each in its own
    process: parent, this, this, parent."""
    here = ROOT / "src"
    srcs = [here] if parent is None else [parent.resolve().parents[2],
                                          here, here,
                                          parent.resolve().parents[2]]
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import _build; "
         "_build.build_all()"], env={**os.environ, "PYTHONPATH": str(src)})
        for src in dict.fromkeys(srcs)]
    if any(b.wait() for b in builds):
        raise RuntimeError("a checkout's kernels did not build")
    rows = []
    for src in srcs:
        run = subprocess.run(
            [sys.executable, __file__, "--request-worker"],
            env={**os.environ, "PYTHONPATH": str(src)},
            capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"{src}: {run.stderr[-4000:]}")
        row = json.loads(run.stdout.strip().splitlines()[-1])
        row["src"] = str(src.relative_to(ROOT))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="another checkout's kernels/csrc directory, "
                         "built and timed as the variant 'parent'")
    ap.add_argument("--source", action="append",
                    choices=(*SOURCES, "requests", "k2"),
                    help="only the variants of this file, or request "
                         "times (repeatable; default the three files)")
    ap.add_argument("--request-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sources = args.source or SOURCES
    if not torch.cuda.is_available():
        print("probe: needs a CUDA card", file=sys.stderr)
        return 2
    if args.request_worker:
        print(json.dumps(request_times()), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = dict(device=smi, torch=torch.__version__)
    if "requests" in sources:
        result["requests"] = compare_requests(args.parent)
    if "k2" in sources:
        result["k2"] = k2_run(args.parent)
    sources = [s for s in sources if s not in ("requests", "k2")]
    ok = not sources or variants_run(args.parent, sources, result)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if ok else 1


def variants_run(parent, sources, result) -> bool:
    """The kernel variants of ``sources``: their times, equalities and
    registers into ``result``; True when every compared variant equals
    the shipped kernel."""
    dev = torch.device("cuda")
    variants, spec = [], {}
    for label, source, consts, edits, compared, fused in VARIANTS:
        if source not in sources:
            continue
        if not fused:
            edits = (*edits, SCAN_ONLY[source])
        variants.append((label, _build.CSRC, source, consts, edits))
        spec[(label, source)] = (compared, fused)
    if parent is not None:
        for source in sources:
            # a parent whose kernel 2 predates the chunk argument is timed
            # by ``--source k2``, on merged results, not here
            fused = source != "ash_score" or _k2_takes_chunk(parent)
            variants.append(("parent", parent.resolve(), source, {},
                             () if fused else (SCAN_ONLY[source],)))
            spec[("parent", source)] = (True, fused)
    libs = build(variants)
    flat, gath, rows, coarse = operands(dev)
    wide = wide_coarse(dev) if "ash_coarse" in sources else None
    b = 2
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {}
    for (label, source), path in libs.items():
        compared, fused = spec[(label, source)]
        for kern, (fn, res) in calls(_load(path, source), source, fused,
                                     flat, gath, rows, coarse, wide, b,
                                     n_sm).items():
            runs[(label, kern)] = (fn, res, compared)
    # every compared variant's output equal to the shipped kernel's
    want, equal = {}, {}
    for (label, kern), (fn, res, compared) in runs.items():
        res.fill_(0)
        rc = fn()
        if rc:
            raise RuntimeError(f"{label}/{kern}: cudaError {rc}")
        torch.cuda.synchronize()
        if label == "shipped":
            want[kern] = res.clone()
    for (label, kern), (_, res, compared) in runs.items():
        if compared:
            equal[f"{label}/{kern}"] = bool(torch.equal(res, want[kern]))
    times = {}
    order = list(runs)
    for pass_order in (order, order[::-1]):
        for key in pass_order:
            times.setdefault(f"{key[0]}/{key[1]}", []).append(
                graph_ms(runs[key][0]))
    regs = {}
    for (label, source), path in libs.items():
        for ln in path.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            # the main instances (kernel 5's of one chunk a row)
            if m and re.search(r"(ash_score|ash_gather|coarse_rows)_kernel"
                               r"ILi2ELi0E|ash_coarse_kernelILi2ELi0E"
                               r"(Lb0E)?E", cur):
                regs[f"{label}/{source}"] = int(m.group(1))
            if m and "ash_coarse_topk_kernelILi2ELi0ELi1E" in cur:
                regs[f"{label}/{source}/k6"] = int(m.group(1))
    result.update(ms=times, equal_to_shipped=equal, registers=regs)
    return all(equal.values())


if __name__ == "__main__":
    sys.exit(main())
