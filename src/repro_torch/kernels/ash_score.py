"""Wrappers of the ASH scan kernels (``csrc/ash_{score,gather,coarse}.cu``)
and of the strip merge of the fused scans (``csrc/ash_select.cu``).

Each wrapper replaces one function of ``repro.kernels.ash_score``:

=============================  ===============================  ==========
wrapper                        replaces                         source
=============================  ===============================  ==========
``ash_score_cuda``             ``ash_score_pallas``             ash_score
``ash_score_topk_cuda``        ``ash_score_topk_pallas``        ash_score
``ash_score_gather_cuda``      ``ash_score_gather_pallas``      ash_gather
``ash_score_gather_topk_cuda`` ``ash_score_gather_topk_pallas`` ash_gather
``ash_score_coarse_cuda``      ``ash_score_coarse_pallas``      ash_coarse
``ash_score_coarse_topk_cuda`` ``ash_score_coarse_topk_pallas`` ash_coarse
``ash_topk_merge_cuda``        the merge of kernels 2, 4, 6     ash_select
=============================  ===============================  ==========

For a CUDA tensor a wrapper launches its kernel on the current stream
of the tensor's device, with that device current (:func:`launch_on`),
or raises; for a CPU tensor it runs the kernel's plain PyTorch version
from ``repro_torch.kernels.ref``.  ``launch_counts`` counts launches,
one per kernel launch and nowhere else, so a run can show which
kernels its main path went through.  ``merge_launches`` counts each merge
launch once more, under the fused scan whose strip it reduced.  Both are
updated under one lock (:func:`count_launch`): the serving engine
launches from several threads at once.

Bound and design notes are in the CUDA sources.  The fused dense,
gathered and coarse scans (kernels 2, 4 and 6) emit a strip of 64-bit
selection keys, one sorted list per span of tiles
(``ref.dense_span_geometry`` for the dense scan, whose blocks take 8 or
32 queries, ``ref.dense_query_chunk``; ``ref.span_geometry`` for the
coarse scan; ``ref.gather_span_geometry`` for the gathered scan, whose
keys carry candidate positions), and
``ash_topk_merge_cuda`` reduces it to the top-k with one more launch
(``csrc/ash_select.cu``, counted as ``ash_topk_merge``), mapping the
gathered scan's positions back to payload rows on the card.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

_METRIC_CODE = {"dot": 0, "l2": 1, "cos": 2}  # the kernels' METRIC_* enum

launch_counts = {
    "ash_score": 0, "ash_score_topk": 0,
    "ash_score_gather": 0, "ash_score_gather_topk": 0,
    "ash_score_coarse": 0, "ash_score_coarse_topk": 0,
    "ash_topk_merge": 0,
    # the launches of ash_score_topk that took the wide query chunk
    # (ref.WIDE_CHUNK queries a block), counted in ash_score_topk too
    "ash_score_topk_wide": 0,
}
# the same merge launches, counted again under the fused scan whose strip
# each one reduced
merge_launches = {"ash_score_topk": 0, "ash_score_gather_topk": 0,
                  "ash_score_coarse_topk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points per source: {function: (pointer args, int args)}; every
# function ends with the stream pointer and returns a cudaError code
_ENTRY_POINTS = {
    "ash_score": {"ash_score_launch": (9, 6),
                  "ash_score_topk_launch": (10, 10)},
    "ash_gather": {"ash_gather_launch": (10, 7),
                   "ash_gather_topk_launch": (10, 10)},
    "ash_coarse": {"ash_coarse_launch": (11, 6),
                   "ash_coarse_topk_launch": (12, 9)},
    "ash_select": {"ash_topk_merge_launch": (4, 5)},
}
MERGE_MAX_K = 512  # the selection lists live in shared memory
_libs: dict[str, ctypes.CDLL] = {}


_count_lock = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one to ``counts[name]`` under the counters' lock (an
    unguarded ``+= 1`` from two threads can lose one)."""
    with _count_lock:
        counts[name] += 1


def kernel_launches() -> int:
    """Kernel launches counted so far (``ash_score_topk_wide`` is a part
    of ``ash_score_topk``, not a launch of its own)."""
    with _count_lock:
        return sum(c for name, c in launch_counts.items()
                   if name != "ash_score_topk_wide")


def reset_launch_counts() -> None:
    with _count_lock:
        for counts in (launch_counts, merge_launches):
            for name in counts:
                counts[name] = 0


def _kernels(source: str = "ash_score") -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built at first use."""
    if source not in _libs:
        lib = _build.load(source)
        for fn, (n_ptr, n_int) in _ENTRY_POINTS[source].items():
            getattr(lib, fn).argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
            getattr(lib, fn).restype = _I
        _libs[source] = lib
    return _libs[source]


def load_all() -> None:
    """Build (one nvcc per source, in parallel) and load every library."""
    _build.build_all()
    for source in _ENTRY_POINTS:
        _kernels(source)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(codes, q_proj, scale, offset, cluster, ipq, qterm, rowterm,
           metric, b, extra=(), q_dtype=torch.float32):
    """Refuse what the kernel does not take (it converts nothing).
    ``extra`` adds (name, tensor, dtype, shape) operands to check."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    if b not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bitrate {b}")
    n, wd = codes.shape
    m = q_proj.shape[0]
    want = [
        ("codes", codes, torch.int32, (n, wd)),
        ("q_proj", q_proj, q_dtype, (m, wd * (32 // b))),
        ("scale", scale, torch.float32, (n,)),
        ("offset", offset, torch.float32, (n,)),
        ("cluster", cluster, torch.int32, (n,)),
        ("ip_q_landmarks", ipq, torch.float32, (m, ipq.shape[1])),
    ]
    if metric != "dot":
        want += [("qterm", qterm, torch.float32, (m,)),
                 ("rowterm", rowterm, torch.float32, (n,))]
    want += list(extra)
    for name, t, dtype, shape in want:
        if t.device != codes.device or t.dtype != dtype:
            raise ValueError(
                f"{name}: want {dtype} on {codes.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {shape}, got {tuple(t.shape)}"
            )


def launch_on(device, entry, *args) -> int:
    """Call the C entry point ``entry`` with ``device`` as the CUDA
    current device and that device's current stream as its last
    argument; returns its cudaError code.  Every launch of the port goes
    through here: the kernels' shared-memory attribute and occupancy
    caches are kept per device and read the current one, and a launch
    onto a stream of another device than the current one fails."""
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


_sm_count: dict[int, int] = {}


def _sms(device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _sm_count:
        _sm_count[i] = torch.cuda.get_device_properties(
            i).multi_processor_count
    return _sm_count[i]


def _target_spans(device) -> int:
    """About two 512-thread blocks per SM for each query chunk."""
    return 2 * _sms(device)


_smem_optin: dict[int, int] = {}


def _smem_max(device) -> int:
    """Shared bytes a block may take on ``device`` (opted in)."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _smem_optin:
        _smem_optin[i] = getattr(torch.cuda.get_device_properties(i),
                                 "shared_memory_per_block_optin",
                                 ref.SMEM_BLOCK_MAX)
    return _smem_optin[i]


def ash_topk_merge_cuda(keys: torch.Tensor, k: int, run: int, rows=None,
                        *, scan=None):
    """(m, k) f32 scores and int32 ids of a (m, width) int64 strip of
    selection keys (``ref.make_keys``; valid keys unique per row), each
    row width / run runs of ``run`` keys in ascending unsigned order
    (the fused scans' span lists): the top-k by (score desc, id asc),
    (-inf, -1) past the valid keys.  With ``rows`` ((m, R) int32, the
    gathered scan's candidate table) the ids are candidate positions
    and come back mapped through it, as ``ref.positions_to_rows``.  On
    the card one launch of ``ash_topk_merge_kernel``, which takes a
    first bound from the runs' heads; k is at most ``MERGE_MAX_K``
    there, and ``scan`` (a key of ``merge_launches``) names the fused
    scan whose strip it reduces."""
    if keys.device.type == "cpu":
        vals, ids = ref.merge_keys_ref(keys, k)
        return vals, ids if rows is None else ref.positions_to_rows(rows, ids)
    m, width = keys.shape
    if keys.dtype != torch.int64 or not keys.is_contiguous():
        raise ValueError(f"keys: want contiguous int64, got {keys.dtype}")
    if run < 1 or width % run:
        raise ValueError(f"run={run}: want runs that tile the {width} keys")
    if not 1 <= k <= MERGE_MAX_K:
        raise ValueError(f"k={k}: the strip merge takes 1 <= k <= "
                         f"{MERGE_MAX_K}; use the materializing kernel")
    if rows is not None and (
            rows.dtype != torch.int32 or rows.device != keys.device
            or rows.dim() != 2 or rows.shape[0] != m or rows.shape[1] < 1
            or not rows.is_contiguous()):
        raise ValueError(f"rows: want contiguous int32 (m={m}, R >= 1) on "
                         f"{keys.device}, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    vals = torch.empty(m, k, dtype=torch.float32, device=keys.device)
    ids = torch.empty(m, k, dtype=torch.int32, device=keys.device)
    if m == 0:
        return vals, ids
    _launch("ash_select", "ash_topk_merge_launch", "ash_topk_merge",
            keys.device, _ptr(keys), _ptr(rows), _ptr(vals), _ptr(ids), m,
            width, k, run, 0 if rows is None else rows.shape[1])
    if scan is not None:
        count_launch(merge_launches, scan)
    return vals, ids


def _fused_select(scan, launch, m, k, device, geometry):
    """Run the fused scan ``scan`` into a key strip (``launch(strip, L,
    tiles_per_span, n_spans)``) of ``geometry`` (n_spans, tiles_per_span,
    L), then merge it: (m, k) scores, ids."""
    n_spans, per, L = geometry
    if k > MERGE_MAX_K:
        raise ValueError(f"k={k}: the strip merge takes k <= "
                         f"{MERGE_MAX_K}; use the materializing kernel")
    if m == 0:
        return (torch.empty(0, k, dtype=torch.float32, device=device),
                torch.empty(0, k, dtype=torch.int32, device=device))
    strip = torch.empty(m, n_spans * L, dtype=torch.int64, device=device)
    launch(strip, L, per, n_spans)
    return ash_topk_merge_cuda(strip, k, L, scan=scan)


def ash_score_cuda(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, *, b: int, metric: str = "dot",
) -> torch.Tensor:
    """(m, n) f32 scores, higher-is-better for every metric."""
    if codes.device.type == "cpu":
        return ref.ash_score_metric_ref(
            codes, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, b=b, metric=metric,
        )
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b)
    n, wd = codes.shape
    m = q_proj.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=codes.device)
    if n == 0 or m == 0:
        return out
    _launch("ash_score", "ash_score_launch", "ash_score", codes.device,
            _ptr(codes), _ptr(q_proj), _ptr(scale), _ptr(offset),
            _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm), _ptr(rowterm),
            _ptr(out), n, m, wd, ip_q_landmarks.shape[1], b,
            _METRIC_CODE[metric])
    return out


def ash_score_topk_cuda(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, n_valid=None, row_valid=None, *,
    b: int, k: int, k_tilde=None, metric: str = "dot",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + selection: top-k (scores, int32 ids), each (m, k).

    Equal to a stable top-k of the materializing kernel's masked scores
    (values, ids and tie order) whenever k <= k_tilde (default k).
    ``n_valid`` masks rows at/beyond it, ``row_valid`` ((n,) bool) masks
    tombstones; both fold into one runtime mask operand.  Slots past the
    valid rows come back as (-inf, -1); k above the n_blocks * k_tilde
    strip raises, and on the card so does k above ``MERGE_MAX_K``.  On
    the card: one scan launch into a key strip and one merge launch.
    """
    mask = ref.row_mask(codes.shape[0], n_valid, row_valid, codes.device)
    if mask is not None:
        mask = mask.to(torch.int32)
    if codes.device.type == "cpu":
        return ref.ash_score_topk_ref(
            codes, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, mask, b=b, k=k, k_tilde=k_tilde, metric=metric,
        )
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b)
    n, wd = codes.shape
    m = q_proj.shape[0]
    dev = codes.device
    L = ref.span_geometry(n, k, k_tilde)[2]
    chunk = ref.dense_query_chunk(m, q_proj.shape[1], L, _smem_max(dev))

    def launch(strip, L, per, n_spans):
        _launch("ash_score", "ash_score_topk_launch", "ash_score_topk", dev,
                _ptr(codes), _ptr(q_proj), _ptr(scale), _ptr(offset),
                _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm),
                _ptr(rowterm), _ptr(mask), _ptr(strip), n, m, wd,
                ip_q_landmarks.shape[1], b, _METRIC_CODE[metric], L, per,
                n_spans, chunk)
        if chunk == ref.WIDE_CHUNK:
            count_launch(launch_counts, "ash_score_topk_wide")

    return _fused_select("ash_score_topk", launch, m, k, dev,
                         ref.dense_span_geometry(n, m, k, k_tilde, chunk,
                                                 _sms(dev)))


def _launch(source: str, fn: str, name: str, device, *args) -> None:
    """Call one C entry point on ``device`` (:func:`launch_on`); raise on
    a refused launch, else count it."""
    rc = launch_on(device, getattr(_kernels(source), fn), *args)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    count_launch(launch_counts, name)


def _check_rows(rows, m):
    if rows.dim() != 2 or rows.shape[0] != m:
        raise ValueError(f"rows: want (m={m}, R), got {tuple(rows.shape)}")
    return [("rows", rows, torch.int32, tuple(rows.shape))]


def ash_score_gather_cuda(
    codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, *, b: int, metric: str = "dot",
) -> torch.Tensor:
    """(m, R) f32 scores of query i against its candidate rows
    ``rows[i]`` (int32 payload rows in [0, n), -1 = padding, scored
    -inf).  Each score equals ``ash_score_cuda``'s score of the same
    (query, row) bit for bit."""
    if codes.device.type == "cpu":
        return ref.ash_score_gather_ref(
            codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, b=b, metric=metric,
        )
    m = q_proj.shape[0]
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b, extra=_check_rows(rows, m))
    n, wd = codes.shape
    R = rows.shape[1]
    out = torch.empty(m, R, dtype=torch.float32, device=codes.device)
    if m == 0 or R == 0:
        return out
    _launch("ash_gather", "ash_gather_launch", "ash_score_gather",
            codes.device,
            _ptr(codes), _ptr(rows), _ptr(q_proj), _ptr(scale),
            _ptr(offset), _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm),
            _ptr(rowterm), _ptr(out), n, m, R, wd,
            ip_q_landmarks.shape[1], b, _METRIC_CODE[metric])
    return out


def ash_score_gather_topk_cuda(
    codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, *, b: int, k: int, k_tilde=None,
    metric: str = "dot",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gathered scan + selection: (m, k) f32 scores and int32
    payload rows.

    Equal to a stable top-k over candidate POSITIONS of
    ``ash_score_gather_cuda``'s scores, mapped back through ``rows``
    (values, rows and tie order) whenever k <= k_tilde (default k);
    for k_tilde < k, to the per-512-position-tile selection of
    ``ref.tile_topk_ref`` (the reference's tile is 128: the result is
    the same whenever k <= k_tilde).  Pad ids never surface; slots past
    the live candidates come back (-inf, -1); k above the strip raises,
    and on the card so does k above ``MERGE_MAX_K``.  On the card: one
    scan launch into a key strip (``ref.gather_span_geometry``) and one
    merge launch that also maps positions to rows.
    """
    if codes.device.type == "cpu":
        return ref.ash_score_gather_topk_ref(
            codes, rows, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, b=b, k=k, k_tilde=k_tilde, metric=metric,
        )
    m = q_proj.shape[0]
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b, extra=_check_rows(rows, m))
    n, wd = codes.shape
    R = rows.shape[1]
    n_spans, per, L = ref.gather_span_geometry(R, m, k, k_tilde,
                                               _sms(codes.device))
    if k > MERGE_MAX_K:
        raise ValueError(f"k={k}: the strip merge takes k <= "
                         f"{MERGE_MAX_K}; use the materializing kernel")
    if m == 0:
        return (torch.empty(0, k, dtype=torch.float32, device=codes.device),
                torch.empty(0, k, dtype=torch.int32, device=codes.device))
    strip = torch.empty(m, n_spans * L, dtype=torch.int64,
                        device=codes.device)
    _launch("ash_gather", "ash_gather_topk_launch", "ash_score_gather_topk",
            codes.device,
            _ptr(codes), _ptr(rows), _ptr(q_proj), _ptr(scale),
            _ptr(offset), _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm),
            _ptr(rowterm), _ptr(strip), n, m, R, wd,
            ip_q_landmarks.shape[1], b, _METRIC_CODE[metric], L, per,
            n_spans)
    return ash_topk_merge_cuda(strip, k, L, rows=rows,
                               scan="ash_score_gather_topk")


def _coarse_extra(q_scale, q_corr, m):
    return [("q_scale", q_scale, torch.float32, (m,)),
            ("q_corr", q_corr, torch.float32, (m,))]


def ash_score_coarse_cuda(
    codes, q_int8, q_scale, q_corr, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, *, b: int, metric: str = "dot",
) -> torch.Tensor:
    """(m, n) f32 symmetric int8 coarse scores; ``q_int8`` is (m,
    d_pad) int8, zero beyond the projection width.  Bit-equal to
    ``ref.ash_score_coarse_ref``."""
    if codes.device.type == "cpu":
        return ref.ash_score_coarse_ref(
            codes, q_int8, q_scale, q_corr, scale, offset, cluster,
            ip_q_landmarks, qterm, rowterm, b=b, metric=metric,
        )
    m = q_int8.shape[0]
    _check(codes, q_int8, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b, extra=_coarse_extra(q_scale, q_corr, m),
           q_dtype=torch.int8)
    n, wd = codes.shape
    out = torch.empty(m, n, dtype=torch.float32, device=codes.device)
    if n == 0 or m == 0:
        return out
    _launch("ash_coarse", "ash_coarse_launch", "ash_score_coarse",
            codes.device,
            _ptr(codes), _ptr(q_int8), _ptr(q_scale), _ptr(q_corr),
            _ptr(scale), _ptr(offset), _ptr(cluster), _ptr(ip_q_landmarks),
            _ptr(qterm), _ptr(rowterm), _ptr(out), n, m, wd,
            ip_q_landmarks.shape[1], b, _METRIC_CODE[metric])
    return out


def ash_score_coarse_topk_cuda(
    codes, q_int8, q_scale, q_corr, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, n_valid=None, row_valid=None, *,
    b: int, k: int, k_tilde=None, metric: str = "dot",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused coarse scan + selection: top-k (scores, int32 ids), each
    (m, k), with the masking, tie order and strip of
    ``ash_score_topk_cuda`` over the coarse scores."""
    mask = ref.row_mask(codes.shape[0], n_valid, row_valid, codes.device)
    if mask is not None:
        mask = mask.to(torch.int32)
    if codes.device.type == "cpu":
        return ref.ash_score_coarse_topk_ref(
            codes, q_int8, q_scale, q_corr, scale, offset, cluster,
            ip_q_landmarks, qterm, rowterm, mask, b=b, k=k,
            k_tilde=k_tilde, metric=metric,
        )
    m = q_int8.shape[0]
    _check(codes, q_int8, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b, extra=_coarse_extra(q_scale, q_corr, m),
           q_dtype=torch.int8)
    n, wd = codes.shape
    return _fused_select(
        "ash_score_coarse_topk", lambda strip, L, per, n_spans: _launch(
            "ash_coarse", "ash_coarse_topk_launch", "ash_score_coarse_topk",
            codes.device,
            _ptr(codes), _ptr(q_int8), _ptr(q_scale), _ptr(q_corr),
            _ptr(scale), _ptr(offset), _ptr(cluster), _ptr(ip_q_landmarks),
            _ptr(qterm), _ptr(rowterm), _ptr(mask), _ptr(strip), n, m, wd,
            ip_q_landmarks.shape[1], b, _METRIC_CODE[metric], L, per,
            n_spans),
        m, k, codes.device,
        ref.span_geometry(n, k, k_tilde, _target_spans(codes.device)))
