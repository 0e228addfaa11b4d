"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports nothing of JAX, so it runs where JAX is not
installed; the repository's conftest imports JAX, so on such a machine
run it with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/cuda

Tolerances: kernel scores against the plain version at rtol 1e-5 and
atol 1e-5 times the largest |score| (fp32 sums over d_pad <= 256 terms
in a different order); the fused kernels EQUAL to a stable top-k of
their materializing kernel's scores (values, ids, tie order), since
both compute each element with the same device routine; the gathered
scan EQUAL to the dense scan on the same (query, row) (one arithmetic
order); the coarse kernels EQUAL to their plain versions (exact integer
accumulation, one epilogue order).
"""
import copy
import ctypes
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.data.synthetic import embedding_dataset  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.kernels import ash_score as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

pytestmark = pytest.mark.cuda
METRICS = ("dot", "l2", "cos")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(seed, b, d, n, m, C, metric, device):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 2**b, size=(n, d))
    codes = Q.pack_codes(torch.from_numpy(2 * levels - (2**b - 1)), b)
    d_pad = codes.shape[1] * (32 // b)
    q = np.pad(rng.standard_normal((m, d)), ((0, 0), (0, d_pad - d)))
    t = {
        "codes": codes,
        "q": torch.from_numpy(q).float(),
        "scale": torch.from_numpy(rng.uniform(0.5, 2.0, n)).float(),
        "offset": torch.from_numpy(rng.standard_normal(n)).float(),
        "cluster": torch.from_numpy(rng.integers(0, C, n)).int(),
        "ipq": torch.from_numpy(rng.standard_normal((m, C))).float(),
        "qterm": torch.from_numpy(rng.uniform(0.5, 2.0, m)).float(),
        "rowterm": torch.from_numpy(rng.uniform(0.5, 2.0, n)).float(),
    }
    t = {k: v.to(device).contiguous() for k, v in t.items()}
    extra = metric != "dot"
    return [t["codes"], t["q"], t["scale"], t["offset"], t["cluster"],
            t["ipq"], t["qterm"] if extra else None,
            t["rowterm"] if extra else None]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m", [(1, 100, 3001, 3), (2, 128, 5000, 8),
                                     (4, 72, 1500, 11), (8, 20, 700, 1)])
def test_score_kernel_vs_plain(cuda, metric, b, d, n, m):
    args = _args(b + d, b, d, n, m, 16, metric, cuda)
    before = TK.launch_counts["ash_score"]
    got = TK.ash_score_cuda(*args, b=b, metric=metric)
    want = TR.ash_score_metric_ref(*args, b=b, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m", [8, 13])
def test_fused_equals_sorted_materialized(cuda, metric, m):
    n, k = 6000, 100
    args = _args(7, 2, 100, n, m, 16, metric, cuda)
    for t in (0, 2, 3, 5):  # duplicate rows: exact ties across tiles
        if args[t] is not None and args[t].shape[0] == n:
            args[t][5000:5100] = args[t][0:100]
    if args[7] is not None:
        args[7][5000:5100] = args[7][0:100]
    args[3][[11, 4000]] = float("-inf")  # rows whose score is -inf
    full = TK.ash_score_cuda(*args, b=2, metric=metric)
    row_valid = torch.rand(n, device=cuda) > 0.3
    for n_valid, rv in ((None, None), (None, row_valid), (5050, None),
                        (5050, row_valid)):
        before = TK.launch_counts["ash_score_topk"]
        ts, ti = TK.ash_score_topk_cuda(*args, n_valid, rv, b=2, k=k,
                                        metric=metric)
        assert TK.launch_counts["ash_score_topk"] == before + 1
        vs, vi = TR.stable_top_k(TR.mask_rows_ref(full, n_valid, rv), k)
        assert torch.equal(ts, vs), (n_valid, rv is None)
        assert torch.equal(ti, vi.to(torch.int32)), (n_valid, rv is None)
        ps, pi = TK.ash_score_topk_cuda(*[a if a is None else a.cpu()
                                          for a in args],
                                        n_valid, None if rv is None
                                        else rv.cpu(), b=2, k=k,
                                        metric=metric)
        torch.testing.assert_close(ts.cpu(), ps, rtol=1e-5,
                                   atol=1e-5 * ps[torch.isfinite(ps)]
                                   .abs().max().item())


def test_fused_exhausted_slots(cuda):
    args = _args(3, 2, 64, 900, 4, 8, "dot", cuda)
    row_valid = torch.zeros(900, dtype=torch.bool, device=cuda)
    row_valid[[2, 600, 899]] = True
    ts, ti = TK.ash_score_topk_cuda(*args, None, row_valid, b=2, k=10)
    assert sorted(ti[0, :3].tolist()) == [2, 600, 899]
    assert (ti[:, 3:] == -1).all() and torch.isneginf(ts[:, 3:]).all()
    with pytest.raises(ValueError, match="candidate strip"):
        TK.ash_score_topk_cuda(*args, b=2, k=10, k_tilde=4)


def test_wrapper_refuses_bad_operands(cuda):
    args = _args(5, 2, 64, 300, 2, 4, "dot", cuda)
    args[1] = args[1].double()
    with pytest.raises(ValueError, match="q_proj"):
        TK.ash_score_cuda(*args, b=2)


def test_index_on_card_matches_cpu(cuda):
    """A small index built on the card: the kernel route returns the
    plain route's ids, and the same model and payload on the CPU give
    the same ids."""
    X = embedding_dataset(4000, 64, seed=0, device="cuda")
    Qm = embedding_dataset(16, 64, seed=1, device="cuda")
    index = AshIndex.build(torch.Generator().manual_seed(0), X,
                           ASHConfig(b=2, d=32, n_landmarks=16),
                           keep_raw=True)
    s, ids = index.search(Qm, k=50)
    _, ids_plain = index.search(Qm, k=50, use_kernel=False)
    assert (ids == ids_plain).float().mean() > 0.99
    model, payload = index.model, index.payload
    cpu = AshIndex.from_parts(
        dataclasses.replace(model, **{
            f: getattr(model, f).cpu() for f in model.ARRAY_FIELDS}),
        dataclasses.replace(payload, **{
            f: getattr(payload, f).cpu() for f in payload.ARRAY_FIELDS}),
    )
    _, ids_cpu = cpu.search(Qm.cpu(), k=50)
    assert (ids.cpu() == ids_cpu).float().mean() > 0.99
    _, rr = index.search(Qm, k=10, rerank=256)
    assert rr.shape == (16, 10) and (rr >= 0).all()


def _rows(seed, m, R, n, device, pad=0.3):
    """(m, R) int32 candidate table: ragged runs of ascending rows with
    -1 padding, plus a few repeated rows (exact ties)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=(m, R))
    rows[rng.random((m, R)) < pad] = -1
    rows[:, R // 2:R // 2 + 5] = rows[:, :5]
    return torch.from_numpy(rows.astype(np.int32)).to(device)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m,R", [(1, 100, 3001, 3, 700),
                                       (2, 128, 5000, 8, 1000),
                                       (4, 72, 1500, 11, 333),
                                       (8, 20, 700, 1, 129)])
def test_gather_kernel_vs_plain_and_dense(cuda, metric, b, d, n, m, R):
    args = _args(b + d, b, d, n, m, 16, metric, cuda)
    rows = _rows(R, m, R, n, cuda)
    before = TK.launch_counts["ash_score_gather"]
    got = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=b,
                                   metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_gather"] == before + 1
    want = TR.ash_score_gather_ref(args[0], rows, *args[1:], b=b,
                                   metric=metric)
    pad = rows < 0
    assert torch.isneginf(got[pad]).all()
    fin = want[~pad]
    torch.testing.assert_close(got[~pad], fin, rtol=1e-5,
                               atol=1e-5 * fin.abs().max().item())
    dense = TK.ash_score_cuda(*args, b=b, metric=metric)
    assert torch.equal(got[~pad], dense.gather(1, rows.clamp(min=0).long())
                       [~pad])


# Kernels 1 and 3 at edge shapes: every bitrate and metric; n and R not
# multiples of a block's rows (768: 256 threads x 3) or positions (256:
# 128 threads x 2), nor of a thread's rows or positions; m not a
# multiple of the 8-query chunk; packed widths with wd % 4 != 0 (word
# loads), and 16-byte rows whose base is not 16-byte aligned (word loads
# too); a query whose candidates are all pads.  Each kernel within
# ref.score_tolerance of its plain version, kernel 3 EQUAL to kernel 1.
_EDGES = [(1, 100, 3001, 3, 700), (1, 33, 1025, 9, 513),
          (2, 128, 5000, 8, 1000), (2, 100, 513, 13, 1537),
          (4, 72, 1500, 11, 333), (4, 64, 511, 1, 511),
          (8, 20, 700, 1, 129), (8, 32, 1537, 17, 1025)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m,R", _EDGES)
def test_scan_kernels_edges(cuda, b, d, n, m, R, metric, aligned):
    args = _args(1000 * b + d, b, d, n, m, 16, metric, cuda)
    codes = args[0]
    if not aligned:  # the same words from a base 4 bytes past alignment
        buf = torch.empty(codes.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = codes.reshape(-1)
        args[0] = codes = buf[1:].view(codes.shape)
    rows = _rows(R + m, m, R, n, cuda)
    rows[m // 2] = -1
    dense = TK.ash_score_cuda(*args, b=b, metric=metric)
    got = TK.ash_score_gather_cuda(codes, rows, *args[1:], b=b,
                                   metric=metric)
    torch.cuda.synchronize()
    want = TR.ash_score_metric_ref(*args, b=b, metric=metric)
    want_g = TR.ash_score_gather_ref(codes, rows, *args[1:], b=b,
                                     metric=metric)
    _, q, scale, offset, cluster, ipq, qterm, rowterm = args
    d_pad = codes.shape[1] * (32 // b)
    V = Q.unpack_codes(codes, d_pad, b).float().abs()
    tol = TR.score_tolerance((q.abs() @ V.T) * scale.abs()[None, :],
                             ipq[:, cluster.long()], offset, qterm, rowterm,
                             want, metric, d_pad)
    assert ((dense - want).abs() <= tol).all()
    live, safe = rows >= 0, rows.clamp(min=0).long()
    assert torch.isneginf(got[~live]).all()
    assert ((got - want_g).abs()[live] <= tol.gather(1, safe)[live]).all()
    assert torch.equal(got[live], dense.gather(1, safe)[live])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("R,k", [(1000, 100), (1000, 7), (333, 1),
                                 (40, 32), (600, 128)])
def test_gather_fused_equals_sorted_materialized(cuda, metric, R, k):
    n, m = 4000, 9
    args = _args(R + k, 2, 100, n, m, 16, metric, cuda)
    rows = _rows(k, m, R, n, cuda)
    rows[2] = -1  # a query with no live candidate
    full = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2,
                                    metric=metric)
    before = TK.launch_counts["ash_score_gather_topk"]
    ts, tr = TK.ash_score_gather_topk_cuda(args[0], rows, *args[1:], b=2,
                                           k=k, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_gather_topk"] == before + 1
    vs, vp = TR.stable_top_k(full, k)
    want_rows = torch.where(torch.isneginf(vs) & (rows.gather(1, vp) < 0),
                            -1, rows.gather(1, vp))
    assert torch.equal(ts, vs)
    assert torch.equal(tr, want_rows.to(torch.int32))
    assert (tr[2] == -1).all() and torch.isneginf(ts[2]).all()
    ps, pr = TK.ash_score_gather_topk_cuda(
        *[a if a is None else a.cpu() for a in (args[0], rows, *args[1:])],
        b=2, k=k, metric=metric)
    assert (pr == tr.cpu()).float().mean() > 0.98


def _gather_route(args, rows, k, k_tilde=None, metric="dot"):
    """Kernel 4 on the card: (scores, rows), with exactly one scan launch
    and one merge launch."""
    before = dict(TK.launch_counts)
    got = TK.ash_score_gather_topk_cuda(args[0], rows, *args[1:], b=2, k=k,
                                        k_tilde=k_tilde, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_gather_topk"] == before[
        "ash_score_gather_topk"] + 1
    assert TK.launch_counts["ash_topk_merge"] == before["ash_topk_merge"] + 1
    return got


def _gather_want(args, rows, k, metric="dot"):
    """A stable top-k over positions of kernel 3's scores, mapped through
    rows; pad positions (-inf) come back as -1."""
    full = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2,
                                    metric=metric)
    vs, vp = TR.stable_top_k(full, k)
    r = rows.gather(1, vp)
    return vs, torch.where(torch.isneginf(vs) & (r < 0), -1, r).to(
        torch.int32), full


@pytest.mark.parametrize("R", [40, 300, 511, 512, 513, 1000, 5127])
@pytest.mark.parametrize("m", [1, 8, 13])
def test_gather_fused_ragged_tables(cuda, R, m):
    """R below one tile, at it, just above it and ragged; one query alone
    (one span a tile) and m = 13."""
    k = min(100, R)
    args = _args(R + m, 2, 100, 4000, m, 16, "dot", cuda)
    rows = _rows(R * m, m, R, 4000, cuda)
    ts, tr = _gather_route(args, rows, k)
    vs, vr, _ = _gather_want(args, rows, k)
    assert torch.equal(ts, vs) and torch.equal(tr, vr)


@pytest.mark.parametrize("metric", METRICS)
def test_gather_fused_ascending_positions(cuda, metric):
    """Each query's table ordered so that kernel 3's scores ascend with
    position: every key beats the running bound (the adversarial order)."""
    m, R, k = 8, 6000, 100
    args = _args(11, 2, 100, 8000, m, 16, metric, cuda)
    rows = _rows(12, m, R, 8000, cuda, pad=0.0)
    full = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2,
                                    metric=metric)
    rows = rows.gather(1, torch.sort(full, dim=1, stable=True).indices)
    rows = rows.contiguous()
    _, _, asc = _gather_want(args, rows, k, metric)
    assert bool((asc[:, 1:] >= asc[:, :-1]).all())
    ts, tr = _gather_route(args, rows, k, metric=metric)
    vs, vr, _ = _gather_want(args, rows, k, metric)
    assert torch.equal(ts, vs) and torch.equal(tr, vr)


@pytest.mark.parametrize("R,k,k_tilde", [(6000, 10, 4), (2000, 100, 30),
                                         (1537, 9, 3), (700, 128, 64)])
def test_gather_fused_k_tilde_below_k_is_per_tile(cuda, R, k, k_tilde):
    """k_tilde < k: one-tile spans, equal to ``ref.tile_topk_ref`` over
    positions (512-position tiles), mapped through rows."""
    m = 9
    args = _args(R, 2, 100, 5000, m, 16, "dot", cuda)
    rows = _rows(R + 1, m, R, 5000, cuda)
    ts, tr = _gather_route(args, rows, k, k_tilde)
    full = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2)
    ws, wp = TR.tile_topk_ref(full, rows >= 0, k, k_tilde)
    assert torch.equal(ts, ws)
    assert torch.equal(tr, TR.positions_to_rows(rows, wp))


def test_gather_fused_all_pad_rows(cuda):
    """A table of pads only, and one query of pads only: (-inf, -1)."""
    m, R, k = 4, 900, 50
    args = _args(2, 2, 100, 3000, m, 16, "dot", cuda)
    rows = torch.full((m, R), -1, dtype=torch.int32, device=cuda)
    ts, tr = _gather_route(args, rows, k)
    assert torch.isneginf(ts).all() and (tr == -1).all()
    rows = _rows(3, m, R, 3000, cuda)
    rows[0] = -1
    ts, tr = _gather_route(args, rows, k)
    assert torch.isneginf(ts[0]).all() and (tr[0] == -1).all()
    vs, vr, _ = _gather_want(args, rows, k)
    assert torch.equal(ts, vs) and torch.equal(tr, vr)


def test_merge_kernel_rows_equals_positions_to_rows(cuda):
    """The merge with the candidate table (positions mapped on the card)
    equals ``ref.positions_to_rows`` of the merge without."""
    m, R, k = 6, 3000, 100
    rng = np.random.default_rng(4)
    scores = torch.from_numpy(rng.integers(-30, 30, (m, R)).astype(
        np.float32))
    rows = _rows(5, m, R, 9000, "cpu")
    strip = TR.gather_span_strip_ref(scores, rows, k, None, 3).to(cuda)
    L = TR.span_geometry(R, k, None, 3)[2]
    rows = rows.to(cuda)
    s0, p0 = TK.ash_topk_merge_cuda(strip, k, L)
    s1, r1 = TK.ash_topk_merge_cuda(strip, k, L, rows=rows)
    assert torch.equal(s0, s1)
    assert torch.equal(r1, TR.positions_to_rows(rows, p0))
    want = TK.ash_topk_merge_cuda(strip.cpu(), k, L, rows=rows.cpu())
    assert torch.equal(s1.cpu(), want[0]) and torch.equal(r1.cpu(), want[1])
    with pytest.raises(ValueError, match="rows"):
        TK.ash_topk_merge_cuda(strip, k, L, rows=rows.long())


def _coarse_args(seed, b, d, n, m, C, metric, device):
    rng = np.random.default_rng(seed)
    a = _args(seed, b, d, n, m, C, metric, device)
    d_pad = a[1].shape[1]
    qi = np.zeros((m, d_pad), np.int8)
    qi[:, :d] = rng.integers(-127, 128, size=(m, d))
    qi = torch.from_numpy(qi).to(device)
    qs = torch.from_numpy(rng.uniform(1e-3, 1e-2, m)).float().to(device)
    qc = torch.from_numpy(rng.standard_normal(m)).float().to(device)
    return [a[0], qi, qs, qc, *a[2:]]


# (b, d, n, m, C, view) of kernel 5: every bitrate; d_pad = wd * 32 / b
# not a multiple of 32 (b = 2, d = 48; b = 4, d = 40; b = 8, d = 20 and
# 52) and word counts that leave lanes partial or empty words; m across
# one and three query chunks; n not a multiple of 16 or of a block's 256
# rows; C = 1 and C = 2000 (above the shared-memory staging of ipq, read
# from device memory); rows wider than a stage's 32 words, cut into
# chunks (b = 8, d = 132: two, the last of one word; b = 4, d = 1000 and
# b = 1, d = 4000: wd = 125, not a multiple of 4; b = 8, d = 2048 and
# b = 4, d = 4096: 16); views: "offset" takes the codes from a base 4
# bytes past 8-byte alignment (word loads, 4-byte copies), "zero_query"
# zeroes one query's int8 values
_COARSE_CASES = [
    (1, 100, 3001, 3, 16, None), (2, 128, 5000, 8, 16, None),
    (4, 72, 1500, 11, 16, None), (8, 20, 700, 1, 16, None),
    (8, 128, 2000, 9, 16, None), (1, 33, 1025, 17, 1, "offset"),
    (2, 48, 1001, 17, 16, "offset"), (2, 128, 4097, 9, 2000, "zero_query"),
    (2, 100, 257, 1, 1, None), (4, 40, 513, 3, 2000, None),
    (4, 128, 300, 9, 16, "offset"), (8, 52, 999, 17, 64, "zero_query"),
    (8, 20, 17, 3, 1, "offset"), (1, 256, 4111, 8, 64, "zero_query"),
    (8, 132, 999, 9, 1, None), (4, 1000, 333, 3, 2000, "zero_query"),
    (1, 4000, 513, 8, 16, None), (8, 2048, 1500, 9, 64, None),
    (4, 4096, 700, 17, 16, "offset"),
]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m,C,view", _COARSE_CASES)
def test_coarse_kernel_equals_plain(cuda, metric, b, d, n, m, C, view):
    """Kernel 5 EQUAL to its plain version, one launch a call; and
    kernel 6 on the same operands EQUAL to a stable top-k of it."""
    args = _coarse_args(b * 3 + d + (C if C != 16 else 0), b, d, n, m, C,
                        metric, cuda)
    if view == "offset":
        codes = args[0]
        buf = torch.empty(codes.numel() + 1, dtype=torch.int32, device=cuda)
        buf[1:] = codes.reshape(-1)
        args[0] = buf[1:].view(codes.shape)
        assert args[0].data_ptr() % 8 == 4
    elif view == "zero_query":
        args[1][m // 2] = 0
    before = TK.launch_counts["ash_score_coarse"]
    got = TK.ash_score_coarse_cuda(*args, b=b, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_coarse"] == before + 1
    want = TR.ash_score_coarse_ref(*args, b=b, metric=metric)
    assert torch.equal(got, want)
    cpu = TK.ash_score_coarse_cuda(*[a if a is None else a.cpu()
                                     for a in args], b=b, metric=metric)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=0)
    k = min(n, 50)
    ts, ti = TK.ash_score_coarse_topk_cuda(*args, b=b, k=k, metric=metric)
    vs, vi = TR.stable_top_k(want, k)
    assert torch.equal(ts, vs) and torch.equal(ti, vi.to(torch.int32))


@pytest.mark.parametrize("metric", ["dot", "l2"])
@pytest.mark.parametrize("b,d", [(8, 28000), (4, 29056)])
def test_coarse_kernel_wide_query_split(cuda, metric, b, d):
    """Kernel 5 at d_pad where the B fragments of 8 queries do not fit in
    shared memory beside a warp's ring (a block takes fewer queries):
    EQUAL to its plain version, one launch a call."""
    args = _coarse_args(b + d, b, d, 150, 9, 64, metric, cuda)
    before = TK.launch_counts["ash_score_coarse"]
    got = TK.ash_score_coarse_cuda(*args, b=b, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_coarse"] == before + 1
    assert torch.equal(got, TR.ash_score_coarse_ref(*args, b=b,
                                                    metric=metric))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [2, 8])
def test_coarse_fused_equals_sorted_materialized(cuda, metric, b):
    n, m, k = 6000, 13, 100
    args = _coarse_args(b, b, 64, n, m, 16, metric, cuda)
    for t in (0, 4, 5, 6):  # duplicate rows: exact ties across tiles
        args[t][5000:5100] = args[t][0:100]
    if args[9] is not None:
        args[9][5000:5100] = args[9][0:100]
    full = TK.ash_score_coarse_cuda(*args, b=b, metric=metric)
    row_valid = torch.rand(n, device=cuda) > 0.3
    for n_valid, rv in ((None, None), (None, row_valid), (5050, None),
                        (5050, row_valid)):
        before = TK.launch_counts["ash_score_coarse_topk"]
        ts, ti = TK.ash_score_coarse_topk_cuda(*args, n_valid, rv, b=b, k=k,
                                               metric=metric)
        assert TK.launch_counts["ash_score_coarse_topk"] == before + 1
        vs, vi = TR.stable_top_k(TR.mask_rows_ref(full, n_valid, rv), k)
        assert torch.equal(ts, vs), (n_valid, rv is None)
        assert torch.equal(ti, vi.to(torch.int32)), (n_valid, rv is None)


# -- kernels 2 and 6: the span selection and the strip merge ------------
# Row operands of the dense and coarse argument lists (permuted together)
_DENSE_ROWS, _COARSE_ROWS = (0, 2, 3, 4, 7), (0, 4, 5, 6, 9)


def _mask_cases(n, device, seed=0):
    rv = torch.rand(n, device=device, generator=torch.Generator(
        device=device).manual_seed(seed)) > 0.3
    nv = n - n // 7
    return ((None, None), (None, rv), (nv, None), (nv, rv))


def _assert_fused_exact(fused, full, n, k, k_tilde=None):
    """``fused(n_valid, row_valid)`` EQUALS a stable top-k of the
    materialized ``full`` scores under the four masks; exactly one scan
    and one merge launch each."""
    for n_valid, rv in _mask_cases(n, full.device):
        before = dict(TK.launch_counts)
        ts, ti = fused(n_valid, rv)
        torch.cuda.synchronize()
        scans = sum(TK.launch_counts[x] - before[x] for x in (
            "ash_score_topk", "ash_score_coarse_topk"))
        assert scans == 1
        assert TK.launch_counts["ash_topk_merge"] == \
            before["ash_topk_merge"] + 1
        vs, vi = TR.stable_top_k(TR.mask_rows_ref(full, n_valid, rv), k)
        valid = TR.row_mask(n, n_valid, rv, full.device)
        nv = n if valid is None else int(valid.sum())
        vi = torch.where(torch.arange(vi.shape[1], device=vi.device) < nv,
                         vi, -1)
        assert torch.equal(ts, vs), (n_valid, rv is None)
        assert torch.equal(ti, vi.to(torch.int32)), (n_valid, rv is None)


def _ascending(args, full, rows, q_ops):
    """Rows reordered by query 0's score ascending and every query made
    query 0: each span sees improving keys, so every key passes the
    threshold and the queues fill every tile."""
    order = torch.sort(full[0], stable=True).indices
    out = list(args)
    for t in rows:
        if out[t] is not None:
            out[t] = out[t][order].contiguous()
    for t in q_ops:
        if out[t] is not None:
            out[t] = out[t][:1].expand_as(out[t]).contiguous()
    return out


@pytest.mark.parametrize("metric", METRICS)
def test_fused_ascending_rows(cuda, metric):
    n, m, k = 6000, 8, 100
    args = _args(21, 2, 100, n, m, 16, metric, cuda)
    args = _ascending(args, TK.ash_score_cuda(*args, b=2, metric=metric),
                      _DENSE_ROWS, (1, 5, 6))
    full = TK.ash_score_cuda(*args, b=2, metric=metric)
    assert bool((full[0, 1:] >= full[0, :-1]).all())
    _assert_fused_exact(lambda nv, rv: TK.ash_score_topk_cuda(
        *args, nv, rv, b=2, k=k, metric=metric), full, n, k)


@pytest.mark.parametrize("b", [2, 8])
def test_coarse_fused_ascending_rows(cuda, b):
    n, m, k = 6000, 8, 32
    args = _coarse_args(b + 40, b, 64, n, m, 16, "dot", cuda)
    args = _ascending(args, TK.ash_score_coarse_cuda(*args, b=b),
                      _COARSE_ROWS, (1, 2, 3, 7, 8))
    full = TK.ash_score_coarse_cuda(*args, b=b)
    assert bool((full[0, 1:] >= full[0, :-1]).all())
    _assert_fused_exact(lambda nv, rv: TK.ash_score_coarse_topk_cuda(
        *args, nv, rv, b=b, k=k), full, n, k)


# (n, m, k, k_tilde): the clip k~ = 512, n below a tile, n not a
# multiple of 512, 13 queries (a ragged second chunk)
_SHAPES = [(6000, 13, 512, None), (300, 13, 50, None), (5001, 13, 100, 600),
           (6007, 13, 100, None), (513, 3, 1, None), (20000, 9, 128, 128),
           (4000, 8, 64, None), (4000, 8, 65, None), (6000, 8, 257, None),
           (6000, 8, 200, None), (6000, 8, 33, None)]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("n,m,k,k_tilde", _SHAPES)
def test_fused_shapes(cuda, metric, n, m, k, k_tilde):
    args = _args(n + k, 2, 100, n, m, 16, metric, cuda)
    args[3][[5, n // 2]] = float("-inf")  # rows whose score is -inf
    full = TK.ash_score_cuda(*args, b=2, metric=metric)
    _assert_fused_exact(lambda nv, rv: TK.ash_score_topk_cuda(
        *args, nv, rv, b=2, k=k, k_tilde=k_tilde, metric=metric), full, n, k)


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("n,m,k,k_tilde", _SHAPES)
def test_coarse_fused_shapes(cuda, b, n, m, k, k_tilde):
    args = _coarse_args(n + b, b, 64, n, m, 16, "l2", cuda)
    full = TK.ash_score_coarse_cuda(*args, b=b, metric="l2")
    _assert_fused_exact(lambda nv, rv: TK.ash_score_coarse_topk_cuda(
        *args, nv, rv, b=b, k=k, k_tilde=k_tilde, metric="l2"), full, n, k)


@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("n,k,k_tilde", [(6000, 10, 4), (6000, 100, 30),
                                         (1537, 9, 3)])
def test_fused_k_tilde_below_k_is_per_tile(cuda, coarse, n, k, k_tilde):
    """k~ < k: the per-tile semantics of ``ref.tile_topk_ref`` on the
    kernel's own scores, under the four masks."""
    m = 9
    if coarse:
        args = _coarse_args(n, 2, 64, n, m, 16, "dot", cuda)
        full = TK.ash_score_coarse_cuda(*args, b=2)
        fused = TK.ash_score_coarse_topk_cuda
    else:
        args = _args(n, 2, 100, n, m, 16, "dot", cuda)
        for t in (0, 2, 3, 4):  # duplicate rows: ties across tiles
            args[t][1000:1100] = args[t][0:100]
        full = TK.ash_score_cuda(*args, b=2)
        fused = TK.ash_score_topk_cuda
    for n_valid, rv in _mask_cases(n, cuda, seed=1):
        ts, ti = fused(*args, n_valid, rv, b=2, k=k, k_tilde=k_tilde)
        valid = TR.row_mask(n, n_valid, rv, cuda)
        ws, wi = TR.tile_topk_ref(
            full, torch.ones(n, dtype=torch.bool, device=cuda)
            if valid is None else valid, k, k_tilde)
        assert torch.equal(ts, ws) and torch.equal(ti, wi), n_valid


# -- kernel 2's tiles: 8 queries a block (m <= 8) or 32 -------------------
_TILE_M = (1, 8, 9, 31, 32, 33, 128, 1024)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("m", _TILE_M)
def test_fused_tiles_equal_sorted_materialized(cuda, m, b, metric):
    """Kernel 2 at every query count around its two tiles, every bitrate
    and metric, n not a multiple of 512: EQUAL to a stable top-k of
    kernel 1's scores under the four masks (k <= k~), one scan and one
    merge a call, counted under ``ash_score_topk_wide`` where m > 8."""
    n, k = 3001, 40
    args = _args(m * 10 + b, b, 64, n, m, 16, metric, cuda)
    full = TK.ash_score_cuda(*args, b=b, metric=metric)
    wide = TK.launch_counts["ash_score_topk_wide"]
    _assert_fused_exact(lambda nv, rv: TK.ash_score_topk_cuda(
        *args, nv, rv, b=b, k=k, metric=metric), full, n, k)
    assert TK.launch_counts["ash_score_topk_wide"] - wide == (
        4 if m > TR.MT else 0)


@pytest.mark.parametrize("m", _TILE_M)
def test_fused_tiles_k_tilde_below_k_is_per_tile(cuda, m):
    """k~ < k on both tiles: one span a tile, the per-tile semantics of
    ``ref.tile_topk_ref`` on kernel 1's scores, under the four masks."""
    n, k, k_tilde = 2600, 12, 5
    args = _args(m, 2, 100, n, m, 16, "l2", cuda)
    full = TK.ash_score_cuda(*args, b=2, metric="l2")
    for n_valid, rv in _mask_cases(n, cuda, seed=2):
        ts, ti = TK.ash_score_topk_cuda(*args, n_valid, rv, b=2, k=k,
                                        k_tilde=k_tilde, metric="l2")
        valid = TR.row_mask(n, n_valid, rv, cuda)
        ws, wi = TR.tile_topk_ref(
            full, torch.ones(n, dtype=torch.bool, device=cuda)
            if valid is None else valid, k, k_tilde)
        assert torch.equal(ts, ws) and torch.equal(ti, wi), n_valid


@pytest.mark.parametrize("metric", METRICS)
def test_fused_rows_alone_equal_rows_in_batches(cuda, metric):
    """A query's top-k alone (m = 1, the narrow tile) EQUALS its row in
    batches of 32, 128 and 1,024 queries (the wide tile), scores and
    ids: a row's answer does not depend on the rows beside it."""
    n, k = 20011, 100
    args = _args(99, 2, 128, n, 1024, 64, metric, cuda)
    q_ops = (1, 5, 6)  # q, ipq, qterm: one row a query
    alone = [TK.ash_score_topk_cuda(
        *[a[i:i + 1] if t in q_ops and a is not None else a
          for t, a in enumerate(args)], b=2, k=k, metric=metric)
        for i in range(0, 1024, 37)]
    for m in (32, 128, 1024):
        batch = [a[:m] if t in q_ops and a is not None else a
                 for t, a in enumerate(args)]
        ts, ti = TK.ash_score_topk_cuda(*batch, b=2, k=k, metric=metric)
        for r, i in enumerate(range(0, 1024, 37)):
            if i < m:
                assert torch.equal(ts[i], alone[r][0][0]), (m, i)
                assert torch.equal(ti[i], alone[r][1][0]), (m, i)


@pytest.mark.parametrize("L", [1, 100, 128, 512])
@pytest.mark.parametrize("d_pad", [32, 128, 1024])
def test_fused_shared_bytes_as_the_wrapper_counts(cuda, d_pad, L):
    """``ref.dense_topk_smem`` (which picks the tile) is the block's
    shared memory as the kernel's launch sizes it."""
    lib = TK._kernels("ash_score")
    lib.ash_score_topk_smem.restype = ctypes.c_size_t
    lib.ash_score_topk_smem.argtypes = [ctypes.c_int] * 3
    for chunk in (TR.MT, TR.WIDE_CHUNK):
        assert lib.ash_score_topk_smem(d_pad, L, chunk) == \
            TR.dense_topk_smem(d_pad, L, chunk)


@pytest.mark.parametrize("n_spans,L,k", [
    (400, 1, 1), (4, 100, 100), (50, 100, 100), (245, 100, 100),
    (245, 32, 32), (264, 32, 32), (30, 300, 300), (40, 512, 512),
    (3, 100, 400), (64, 64, 64), (63, 65, 65), (45, 200, 200),
    (40, 10, 100), (3, 200, 150), (300, 50, 50), (7, 64, 64),
    (1954, 4, 10)])
def test_merge_kernel_vs_merge_strip(cuda, n_spans, L, k):
    """The strip merge against ``ref.merge_strip`` on strips of sorted
    span lists (the fused scans' output; the kernel takes a first bound
    from the lists' heads): tied and -inf scores, exhausted (-inf,
    sentinel) tails, a row of ties, a row of -inf and sentinels."""
    m = 5
    rng = np.random.default_rng(n_spans * L + k)
    width = n_spans * L
    vals = rng.integers(-40, 40, (m, width)).astype(np.float32)
    vals[rng.random((m, width)) < 0.03] = -np.inf
    ids = np.stack([rng.permutation(5 * width)[:width] for _ in range(m)])
    dead = rng.random((m, width)) < 0.1
    vals[dead], ids[dead] = -np.inf, TR.ID_SENTINEL
    vals[1] = -np.inf  # a row of -inf and sentinels
    vals[2], ids[2] = 3.0, rng.permutation(width)  # a row of ties
    keys = TR.make_keys(torch.from_numpy(vals),
                        torch.from_numpy(ids.astype(np.int32)))
    keys = np.sort(keys.numpy().view(np.uint64).reshape(m, n_spans, L),
                   axis=2).reshape(m, width).view(np.int64)
    keys = torch.from_numpy(keys).to(cuda)
    before = TK.launch_counts["ash_topk_merge"]
    got = TK.ash_topk_merge_cuda(keys, k, L)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_topk_merge"] == before + 1
    want = TR.merge_keys_ref(keys.cpu(), min(k, width))
    assert torch.equal(got[0][:, :width].cpu(), want[0])
    assert torch.equal(got[1][:, :width].cpu(), want[1])
    if k > width:
        assert (got[1][:, width:] == -1).all()


def test_merge_kernel_refuses_large_k(cuda):
    keys = torch.zeros(2, 100, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="strip merge"):
        TK.ash_topk_merge_cuda(keys, TK.MERGE_MAX_K + 1, 100)
    with pytest.raises(ValueError, match="keys"):
        TK.ash_topk_merge_cuda(keys.int(), 10, 100)
    with pytest.raises(ValueError, match="run"):
        TK.ash_topk_merge_cuda(keys, 10, 30)


def test_ivf_on_card(cuda):
    """A small IVF index on the card: kernel route == plain route ids,
    a single-row search equals its row of the batch search, coarse with
    a covering shortlist equals coarse=None, and save/load round-trips
    bit for bit."""
    X = embedding_dataset(6000, 64, seed=0, device="cuda")
    Qm = embedding_dataset(16, 64, seed=1, device="cuda")
    index = AshIndex.build(torch.Generator().manual_seed(0), X,
                           ASHConfig(b=2, d=32, n_landmarks=16),
                           backend="ivf", keep_raw=True)
    TK.reset_launch_counts()
    for kw in (dict(k=50), dict(k=10, rerank=256), dict(k=10, coarse="int8"),
               dict(k=10, coarse="int8", rerank=256)):
        s, ids = index.search(Qm, nprobe=4, **kw)
        _, ids_plain = index.search(Qm, nprobe=4, use_kernel=False, **kw)
        assert (ids == ids_plain).float().mean() > 0.99, kw
        prep = index.prepare(Qm)
        one = dataclasses.replace(prep, **{
            f.name: getattr(prep, f.name)[5:6]
            for f in dataclasses.fields(prep)})
        s1, i1 = index.search_prepped(one, nprobe=4, **kw)
        assert torch.equal(s1, s[5:6]) and torch.equal(i1, ids[5:6]), kw
    counts = dict(TK.launch_counts)
    assert counts["ash_score_gather_topk"] >= 3 and counts[
        "ash_score_gather"] >= 1, counts
    # one merge per fused scan, counted under the scan that asked for it
    assert all(TK.merge_launches[k] == counts[k] for k in TK.merge_launches)
    assert counts["ash_topk_merge"] == sum(TK.merge_launches.values())
    a = index.search(Qm, k=10, nprobe=4)
    b = index.search(Qm, k=10, nprobe=4, coarse="int8", shortlist=10**7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    flat = AshIndex.from_parts(index.model, index.payload)
    fa = flat.search(Qm, k=10)
    fb = flat.search(Qm, k=10, coarse="int8", shortlist=10**7)
    assert torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])
    fc = flat.search(Qm, k=10, coarse="int8")
    assert TK.launch_counts["ash_score_coarse_topk"] >= 1
    assert (fc[1] == fa[1]).float().mean() > 0.8


# -- kernel 7: decode attention over an ASH-compressed KV cache ----------
# Tolerance: rtol 1e-4 and atol 1e-5 x max(1, largest |plain value|):
# the reference's own kernel test (tests/test_kernels.py) uses rtol 1e-4,
# atol 1e-5 for grid values up to 15 (b <= 4); fp32 sums over S
# positions, split across blocks and combined, in another order than the
# plain version's, err in proportion to the values' size, which reaches
# 255 at b = 8.


def _kv_close(got, want):
    torch.testing.assert_close(
        got, want, rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))


def _kv_inputs(seed, bk, bv, dk, dv, S, lead, G, device, *,
               scale_dtype=torch.float32, bias=True, mask_from=0):
    """Packed K/V codes (*lead, S, W) of quantized Gaussian vectors,
    scales, bias and a mask valid on [mask_from, S - 3)."""
    rng = np.random.default_rng(seed)
    kv = Q.quant(torch.from_numpy(rng.standard_normal(lead + (S, dk))), bk)
    vv = Q.quant(torch.from_numpy(rng.standard_normal(lead + (S, dv))), bv)
    pos = torch.arange(S)
    t = dict(
        q=torch.from_numpy(rng.standard_normal(lead + (G, dk)) * 0.1).float(),
        kc=Q.pack_codes(kv, bk), vc=Q.pack_codes(vv, bv),
        ks=(torch.from_numpy(rng.uniform(0.5, 1.5, lead + (S,))) * 0.05).to(
            scale_dtype),
        kb=(torch.from_numpy(rng.standard_normal(lead + (S,)) * 0.1).float()
            if bias else None),
        vs=torch.from_numpy(rng.uniform(0.5, 1.5, lead + (S,))).to(
            scale_dtype),
        mask=(pos >= mask_from) & (pos < S - 3),
    )
    return {k: None if v is None else v.to(device) for k, v in t.items()}


def _kv_both(t, bk, bv):
    from repro_torch.kernels import ash_kv_attn as KA

    before = KA.launch_counts["ash_kv_attn"]
    got = KA.ash_kv_attn_cuda(t["q"], t["kc"], t["ks"], t["kb"], t["vc"],
                              t["vs"], t["mask"], b_k=bk, b_v=bv)
    torch.cuda.synchronize()
    assert KA.launch_counts["ash_kv_attn"] == before + 1
    want = TR.ash_kv_attn_ref(t["q"], t["kc"], t["ks"], t["kb"], t["vc"],
                              t["vs"], bk, bv, mask=t["mask"])[0]
    return got, want


@pytest.mark.parametrize("bk", [1, 2, 4, 8])
@pytest.mark.parametrize("bv", [1, 2, 4, 8])
def test_kv_attn_kernel_vs_plain_bitrates(cuda, bk, bv):
    t = _kv_inputs(bk * 10 + bv, bk, bv, 128, 128, 1000, (2, 3), 3, cuda)
    got, want = _kv_both(t, bk, bv)
    _kv_close(got, want)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("S,mask_from", [(77, 0), (513, 0), (4099, 700),
                                         (300, 200)])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_kv_attn_kernel_edges(cuda, G, S, mask_from, scale_dtype, bias):
    """Ragged S, a leading fully masked stretch (longer than a tile and a
    split), bf16 or fp32 scales, bias or none, G heads per stream."""
    t = _kv_inputs(S + G, 4, 2, 96, 64, S, (5,), G, cuda,
                   scale_dtype=scale_dtype, bias=bias, mask_from=mask_from)
    got, want = _kv_both(t, 4, 2)
    _kv_close(got, want)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
def test_kv_attn_kernel_every_group_size(cuda, G):
    """G query heads padded to the mma's 8 columns: every G from 1 to 8."""
    t = _kv_inputs(100 + G, 4, 4, 128, 128, 1500, (3, 2), G, cuda,
                   scale_dtype=torch.bfloat16, bias=False)
    got, want = _kv_both(t, 4, 4)
    _kv_close(got, want)


@pytest.mark.parametrize("S,mask_from", [(45, 40), (93, 0), (301, 290),
                                         (1037, 1021), (2063, 5)])
def test_kv_attn_kernel_ragged_fragments(cuda, S, mask_from):
    """S not a multiple of 16 (a chunk's last m16 tile ragged), and the
    valid positions [mask_from, S - 3) ending inside one 16-position
    fragment, or starting inside the last one."""
    t = _kv_inputs(S, 4, 2, 96, 64, S, (2, 3), 3, cuda, mask_from=mask_from)
    got, want = _kv_both(t, 4, 2)
    _kv_close(got, want)


@pytest.mark.parametrize("q_scale", [1e-6, 1e-3, 1.0, 10.0])
def test_kv_attn_kernel_query_magnitudes(cuda, q_scale):
    """q of standard deviation q_scale, through the three-part bf16
    split: tiny q (near-uniform attention) to logits of tens."""
    t = _kv_inputs(int(q_scale * 1e6) % 1009, 4, 4, 128, 128, 800, (2, 2), 3,
                   cuda)
    t["q"] = t["q"] * (q_scale / 0.1)
    got, want = _kv_both(t, 4, 4)
    _kv_close(got, want)


@pytest.mark.parametrize("dk,dv", [(40, 24), (56, 20)])
def test_kv_attn_kernel_unaligned_rows(cuda, dk, dv):
    """Packed rows of 5 or 7 K words and 6 or 5 V words (b = 4 and 8;
    not 16-byte multiples): the kernel's 4-byte copy path."""
    t = _kv_inputs(dk, 4, 8, dk, dv, 900, (3, 2), 3, cuda)
    got, want = _kv_both(t, 4, 8)
    _kv_close(got, want)


def test_kv_attn_kernel_reads_layer_cache_in_place(cuda):
    """The (B, S, KV, W) layer cache permuted to (B, KV, S, W) as a view,
    bf16 scales of the same layout, a broadcast (S,) mask, no bias."""
    B, S, KV, G, b = 3, 700, 2, 3, 4
    rng = np.random.default_rng(3)
    vals = Q.quant(torch.from_numpy(rng.standard_normal((2, B, S, KV, 128))),
                   b)
    codes = Q.pack_codes(vals, b).to(cuda)  # (2, B, S, KV, 16)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (2, B, S, KV))).to(
        cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, 128))).float().to(cuda)
    mask = torch.arange(S, device=cuda) <= 650
    args = (q, codes[0].permute(0, 2, 1, 3), scales[0].permute(0, 2, 1),
            None, codes[1].permute(0, 2, 1, 3), scales[1].permute(0, 2, 1),
            mask)
    from repro_torch.kernels import ops

    got = ops.ash_kv_attention(*args, b_k=b, b_v=b)
    want = ops.ash_kv_attention(*args, b_k=b, b_v=b, use_kernel=False)
    _kv_close(got, want)


def test_kv_attn_wrapper_refuses_bad_operands(cuda):
    from repro_torch.kernels import ash_kv_attn as KA

    t = _kv_inputs(1, 4, 4, 128, 128, 200, (2,), 3, cuda)
    args = [t["q"], t["kc"], t["ks"], t["kb"], t["vc"], t["vs"], t["mask"]]
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="q_k"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    bad = list(args)
    bad[5] = bad[5].to(torch.bfloat16)
    with pytest.raises(ValueError, match="scales"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    bad = list(args)
    bad[0] = torch.zeros(2, 9, 128, device=cuda)
    with pytest.raises(ValueError, match="q_k"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    with pytest.raises(ValueError, match="bitrates"):
        KA.ash_kv_attn_cuda(*args, b_k=3, b_v=4)


@pytest.mark.parametrize("kv_quant_bits", [0, 4])
def test_decode_step_on_card_matches_cpu(cuda, kv_quant_bits):
    """A 2-layer float32 model decoding 10 steps on the card (through
    kernel 7 for the ASH-KV cache) against the same parameters on the
    CPU (plain attention): logits within 1e-3 of the largest |logit|
    (fp32 products and sums in other orders, through two layers), and
    at least 99 % of the packed codes equal (an encode's projection
    near a quantizer breakpoint may round the other way)."""
    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.models import transformer as TT

    cfg = TT.TransformerConfig(
        name="t", n_layers=2, d_model=64, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=96, dtype=torch.float32, param_dtype=torch.float32,
        q_chunk=0, kv_quant_bits=kv_quant_bits)
    p_cpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    p_gpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu").to(cuda)
    c_cpu = TT.init_cache(cfg, 3, 16, device="cpu")
    c_gpu = TT.init_cache(cfg, 3, 16, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (3, 10)))
    KA.reset_launch_counts()
    for t in range(10):
        a, c_cpu = TT.decode_step(p_cpu, c_cpu, toks[:, t], t, cfg)
        b, c_gpu = TT.decode_step(p_gpu, c_gpu, toks[:, t].to(cuda), t, cfg)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3,
                                   atol=1e-3 * a.abs().max().item())
    if kv_quant_bits:
        assert KA.launch_counts["ash_kv_attn"] == 10 * cfg.n_layers
        for name in ("k_codes", "v_codes"):
            same = (c_gpu[name].cpu() == c_cpu[name]).float().mean().item()
            assert same >= 0.99, (name, same)
        # the kernel route against the plain route on the card
        c2 = TT.init_cache(cfg, 3, 16, device=cuda)
        for t in range(10):
            b2, c2 = TT.decode_step(p_gpu, c2, toks[:, t].to(cuda), t, cfg,
                                    use_kernel=False)
        torch.testing.assert_close(b2, b, rtol=1e-3,
                                   atol=1e-3 * b.abs().max().item())


@pytest.mark.parametrize("metric", METRICS)
def test_scan_kernels_at_the_rabitq_shape(cuda, metric):
    """Kernels 1 and 2 at RaBitQ's shape (b = 1, d = 256, C = 1): kernel
    1 against its plain version, kernel 2 (one scan, one merge) EQUAL to
    a stable top-k of kernel 1's scores."""
    args = _args(256, 1, 256, 20000, 8, 1, metric, cuda)
    got = TK.ash_score_cuda(*args, b=1, metric=metric)
    want = TR.ash_score_metric_ref(*args, b=1, metric=metric)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    before = dict(TK.launch_counts)
    ts, ti = TK.ash_score_topk_cuda(*args, b=1, k=100, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_topk"] == before["ash_score_topk"] + 1
    assert TK.launch_counts["ash_topk_merge"] == before["ash_topk_merge"] + 1
    vs, vi = TR.stable_top_k(got, 100)
    assert torch.equal(ts, vs) and torch.equal(ti, vi.to(torch.int32))


@pytest.mark.parametrize("m", [16, 512])
@pytest.mark.parametrize("k", [10, 100])
def test_scan_kernels_at_the_sasrec_catalog_shape(cuda, k, m):
    """Kernels 1 and 2 at SASRec's ASH catalog shape (b = 4, D = 50,
    d = 25, so d_pad = 32 with 7 pad dimensions whose query entries are
    0; C = 16, dot), for m queries (512: one request of user states):
    kernel 1 against its plain version, kernel 2 (one scan, one merge)
    EQUAL to a stable top-k of kernel 1's scores and, on the plain route,
    to a stable top-k of the plain scores' order."""
    args = _args(25, 4, 25, 30011, m, 16, "dot", cuda)
    assert args[1].shape[1] == 32 and not args[1][:, 25:].any()
    got = TK.ash_score_cuda(*args, b=4, metric="dot")
    want = TR.ash_score_metric_ref(*args, b=4, metric="dot")
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    before = dict(TK.launch_counts)
    ts, ti = TK.ash_score_topk_cuda(*args, b=4, k=k, metric="dot")
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_topk"] == before["ash_score_topk"] + 1
    assert TK.launch_counts["ash_topk_merge"] == before["ash_topk_merge"] + 1
    vs, vi = TR.stable_top_k(got, k)
    assert torch.equal(ts, vs) and torch.equal(ti, vi.to(torch.int32))
    ps, _ = TR.stable_top_k(want, k)
    torch.testing.assert_close(ts, ps, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("S,mask_from", [(77, 0), (1037, 1021), (2063, 5),
                                         (4099, 700), (32768, 31000)])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
def test_kv_attn_kernel_granite_shape(cuda, S, mask_from, scale_dtype):
    """Kernel 7 at granite-moe-3b's head shape: d_code = d_head = 64,
    G = 3, b = 4 for K and V, 8 KV heads; ragged S and leading masked
    stretches."""
    t = _kv_inputs(S + 64, 4, 4, 64, 64, S, (2, 8), 3, cuda,
                   scale_dtype=scale_dtype, bias=False, mask_from=mask_from)
    got, want = _kv_both(t, 4, 4)
    _kv_close(got, want)


def _moe_inputs(cfg, D, T, seed):
    """MoE weights drawn on the CPU and tokens whose router top-k is
    unambiguous (every gap down to the (k+1)-th probability above 1e-6,
    far above fp32 products' differences), so both devices route
    alike."""
    from repro_torch.models import moe as TM

    params = TM.init_moe(torch.Generator().manual_seed(seed), cfg, D)
    router = params.router.double().numpy()
    for s in range(seed, seed + 100):
        x = np.random.default_rng(s).standard_normal((T, D)).astype(
            np.float32)
        lg = x.astype(np.float64) @ router
        p = np.exp(lg - lg.max(1, keepdims=True))
        p = -np.sort(-p / p.sum(1, keepdims=True), axis=1)
        if (p[:, :cfg.top_k] - p[:, 1:cfg.top_k + 1]).min() > 1e-6:
            return params, torch.from_numpy(x)
    raise AssertionError("no draw with an unambiguous top-k")


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_block_on_card_matches_cpu(cuda, capacity_factor):
    """``moe_block`` on the card (float32) against the same block on the
    CPU: the same slots, outputs within 1e-5 of the largest |value|."""
    from repro_torch.models import moe as TM

    cfg = TM.MoEConfig(n_experts=40, top_k=8, d_ff=64, group_size=64,
                       capacity_factor=capacity_factor)
    params, x = _moe_inputs(cfg, 96, 128, 5)
    want, aux = TM.moe_block(params, x, cfg)
    p_gpu = copy.deepcopy(params).to(cuda)  # Module.to moves in place
    got, aux_g = TM.moe_block(p_gpu, x.to(cuda), cfg)
    _, _, te = TM.route(params, x, cfg)
    _, _, te_g = TM.route(p_gpu, x.to(cuda), cfg)
    assert torch.equal(te_g.cpu(), te)
    assert torch.equal(TM.slots(te_g, cfg, 64)[0].cpu(),
                       TM.slots(te, cfg, 64)[0])
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(aux_g.cpu(), aux, rtol=1e-5, atol=0)


def test_moe_decode_step_on_card_matches_cpu(cuda):
    """A 2-layer float32 MoE model (G = 3, 8 experts top-2) decoding 10
    steps on the card through kernel 7 against the CPU, as the dense
    model's test."""
    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    cfg = TT.TransformerConfig(
        name="t", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=64, vocab=96, dtype=torch.float32, param_dtype=torch.float32,
        q_chunk=0, kv_quant_bits=4,
        moe=TM.MoEConfig(n_experts=8, top_k=2, d_ff=32))
    p_cpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    p_gpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu").to(cuda)
    c_cpu = TT.init_cache(cfg, 3, 16, device="cpu")
    c_gpu = TT.init_cache(cfg, 3, 16, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (3, 10)))
    KA.reset_launch_counts()
    for t in range(10):
        a, c_cpu = TT.decode_step(p_cpu, c_cpu, toks[:, t], t, cfg)
        b, c_gpu = TT.decode_step(p_gpu, c_gpu, toks[:, t].to(cuda), t, cfg)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3,
                                   atol=1e-3 * a.abs().max().item())
    assert KA.launch_counts["ash_kv_attn"] == 10 * cfg.n_layers


# -- LM training on the card -------------------------------------------------


def _train(arch, params, steps, seed=21):
    """``steps`` train steps of ``arch`` on ``params``' device from the
    launcher's stream; (losses, the final parameter leaves on the CPU)."""
    import functools

    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as TT
    from repro_torch.train import optim as TO
    from repro_torch.train import trainer as TTR

    state = TTR.init_state(seed, params, arch.train_cfg)
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=arch.cfg),
                               arch.train_cfg)
    stream = TL.make_stream(arch, 4, 64, seed)
    losses = []
    for _ in range(steps):
        state, m = step(state, stream.next())
        losses.append(float(m["loss"]))
    return losses, [t.detach().cpu() for t in TO.tree_leaves(params.tree)]


@pytest.mark.parametrize("arch_id", ["llama3.2-3b", "granite-moe-3b-a800m"])
def test_train_steps_on_card_match_cpu(cuda, arch_id):
    """3 AdamW steps of the reduced arch (fp32) on the card against the
    same weights and batches on the CPU: losses to rtol 1e-4; parameters
    to 1e-6 but for at most 1 % of the elements (AdamW's m/sqrt(v) where
    the clipped |g| is near eps), all within twice the summed learning
    rates."""
    from repro_torch.configs import registry
    from repro_torch.launch import train as TL
    from repro_torch.models import convert
    from repro_torch.models import transformer as TT
    from repro_torch.train import optim as TO

    arch = TL.reduced_arch(registry.get(arch_id))
    p_cpu = TT.init_params(torch.Generator().manual_seed(0), arch.cfg,
                           device="cpu")
    p_gpu = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                      arch.cfg, device=cuda)
    l_cpu, t_cpu = _train(arch, p_cpu, 3)
    l_gpu, t_gpu = _train(arch, p_gpu, 3)
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    lr_sum = sum(TO.lr_at(arch.train_cfg.opt, s) for s in (1, 2, 3))
    diff = [(a - b).abs() for a, b in zip(t_gpu, t_cpu)]
    assert sum(int((d > 1e-6).sum()) for d in diff) <= 0.01 * sum(
        d.numel() for d in diff)
    assert max(float(d.max()) for d in diff) <= 2 * lr_sum + 1e-6


def test_train_restart_on_card_is_bitwise(cuda, tmp_path):
    """Under deterministic algorithms: save at step 3, three more steps,
    restore, replay: the losses EQUAL as fp32 bits."""
    import functools

    from repro_torch.configs import registry
    from repro_torch.data.synthetic import IteratorState, TokenStream
    from repro_torch.launch import train as TL
    from repro_torch.models import transformer as TT
    from repro_torch.train import trainer as TTR
    from repro_torch.train.checkpoint import CheckpointManager

    arch = TL.reduced_arch(registry.get("llama3.2-3b"))
    # cuBLAS under deterministic algorithms needs fixed workspaces
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        params = TT.init_params(torch.Generator(device=cuda).manual_seed(1),
                                arch.cfg, device=cuda)
        state = TTR.init_state(1, params, arch.train_cfg)
        step = TTR.make_train_step(
            functools.partial(TT.loss_fn, cfg=arch.cfg), arch.train_cfg)
        stream = TokenStream(IteratorState(seed=3), 8, 256, arch.cfg.vocab)
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        for _ in range(3):
            state, _ = step(state, stream.next())
        mgr.save(3, state, extra=stream.state.to_dict())
        cont = [float(step(state, stream.next())[1]["loss"])
                for _ in range(3)]
        state, extra = mgr.restore(state)
        stream = TokenStream(IteratorState.from_dict(extra), 8, 256,
                             arch.cfg.vocab)
        replay = [float(step(state, stream.next())[1]["loss"])
                  for _ in range(3)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert cont == replay


# -- the serving engine on the card ----------------------------------------
# Engine results EQUAL to direct search: a row's prep and scores do not
# depend on the rows searched with it, on the card as on the CPU.

ENGINE_ROUTES = (
    ("flat", dict(k=10)), ("flat", dict(k=100)),
    ("flat", dict(k=10, rerank=64)), ("flat", dict(k=10, coarse="int8")),
    ("flat", dict(k=10, coarse="int8", rerank=64)),
    ("ivf", dict(k=10, nprobe=8)), ("ivf", dict(k=100, nprobe=8)),
    ("ivf", dict(k=10, nprobe=8, rerank=64)),
    ("ivf", dict(k=10, nprobe=8, coarse="int8")),
)


@pytest.fixture(scope="module")
def wide_indexes():
    """Flat and IVF indexes at D = 256, d = 128, C = 64 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = embedding_dataset(8000 + 128, 256, seed=2, device="cuda")
    flat = AshIndex.build(torch.Generator().manual_seed(0), data[:8000],
                          ASHConfig(b=2, d=128, n_landmarks=64),
                          learned=False, keep_raw=True)
    ivf = AshIndex.from_parts(flat.model, flat.payload, backend="ivf",
                              raw=flat._state.raw)
    return {"flat": flat, "ivf": ivf}, data[8000:]


def test_rows_alone_equal_rows_in_a_batch_on_card(wide_indexes):
    indexes, Q = wide_indexes
    batch = indexes["flat"].prepare(Q)
    for off, m in ((0, 1), (77, 1), (5, 8), (40, 32)):
        alone = indexes["flat"].prepare(Q[off:off + m])
        for f in ("q", "q_proj", "ip_q_landmarks", "q_sq_norm"):
            assert torch.equal(getattr(alone, f),
                               getattr(batch, f)[off:off + m]), (off, m, f)
    for name, kw in ENGINE_ROUTES:
        sb, ib = indexes[name].search(Q, **kw)
        for off, m in ((0, 1), (77, 1), (5, 8), (40, 32)):
            s, i = indexes[name].search(Q[off:off + m], **kw)
            assert torch.equal(s, sb[off:off + m]), (name, kw, off, m)
            assert torch.equal(i, ib[off:off + m]), (name, kw, off, m)


@pytest.mark.parametrize("name,kw", ENGINE_ROUTES)
def test_engine_equals_direct_search_on_card(wide_indexes, name, kw):
    from repro_torch.serving import QueryEngine

    indexes, Q = wide_indexes
    eng = QueryEngine(indexes, batch_buckets=(8, 32), k_buckets=(10, 100),
                      max_wait_s=60.0)
    Qh = Q.cpu().numpy()
    spans = ((0, 1), (1, 3), (4, 8), (12, 2), (14, 20), (34, 1))
    tickets = [eng.submit(Qh[o:o + m], index=name, **kw) for o, m in spans]
    eng.flush()
    for (o, m), t in zip(spans, tickets):
        s, i = t.result()
        ws, wi = indexes[name].search(Q[o:o + m], **kw)
        assert torch.equal(s, ws.cpu()) and torch.equal(i, wi.cpu()), (o, m)
    assert eng.stats.batches < len(spans)


def test_engine_concurrent_submit_on_card(wide_indexes):
    """8 threads submitting to one index through the frontend: every
    ticket EQUAL to direct search, and the fused scan's launches equal
    the engine's fused calls (the counters lose no update)."""
    import threading

    from repro_torch.serving import QueryEngine, ServingFrontend

    indexes, Q = wide_indexes
    flat = indexes["flat"]
    Qh = Q.cpu().numpy()
    eng = QueryEngine(flat, batch_buckets=(8, 32), k_buckets=(10,))
    out, errors = [], []

    def client(c):
        rng = np.random.RandomState(c)
        try:
            for _ in range(30):
                m = int(rng.randint(1, 5))
                o = int(rng.randint(0, Qh.shape[0] - m))
                out.append((o, m, fe.search(Qh[o:o + m], k=10,
                                            timeout=60.0)))
        except Exception as e:
            errors.append(e)

    torch.cuda.synchronize()
    TK.reset_launch_counts()
    with ServingFrontend(eng) as fe:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    assert not errors and len(out) == 240
    calls = eng.stats.batches
    assert TK.launch_counts["ash_score_topk"] == calls
    assert TK.merge_launches["ash_score_topk"] == calls
    assert calls < 240
    for o, m, (s, i) in out:
        ws, wi = flat.search(Q[o:o + m], k=10)
        assert torch.equal(s, ws.cpu()) and torch.equal(i, wi.cpu())


# -- durability on the card -------------------------------------------------
# A crash at ``engine.apply.logged`` mid-traffic, recovered onto the card:
# searches EQUAL to the durable prefix applied one mutation at a time on
# the card; a checkpoint whose save waits while another batch applies
# holds none of it.


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_crash_and_recover_on_card(wide_indexes, tmp_path, backend):
    import threading
    import time

    from repro_torch.serving import DurableIndex, QueryEngine
    from repro_torch.testing import faults

    indexes, Q = wide_indexes
    base = indexes[backend]
    pool = embedding_dataset(64, 256, seed=5, device="cuda").cpu().numpy()
    kw = dict(k=10, nprobe=8) if backend == "ivf" else dict(k=10)

    def fresh():
        return AshIndex.from_parts(base.model, base.payload, backend=backend,
                                   raw=base._state.raw)

    idx = fresh()
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="always")
    eng = QueryEngine(idx)
    eng.attach_durability(dur)
    script = [("add", pool[0:8]), ("del", [3, 9, 8001]), ("add", pool[8:16]),
              ("del", [17, 8010]), ("add", pool[16:24])]
    acked = []
    with pytest.raises(faults.SimulatedCrash):
        with faults.active({"engine.apply.logged": faults.Crash(at=5)}):
            for i, (kind, arg) in enumerate(script):
                if i == 2:
                    dur.checkpoint(barrier=eng.mutation_barrier())
                t = (eng.submit_add(arg) if kind == "add"
                     else eng.submit_delete(arg))
                t.result()
                acked.append(t.wal_seqno)
    dur.wal.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts={"device": "cuda"})
    assert rec.report.last_seqno == 5 and acked == [1, 2, 3, 4]
    twin = fresh()
    for kind, arg in script:
        if kind == "add":
            twin.stage_add(arg)
            twin.apply_pending()
        else:
            twin.delete(arg)
    for extra in ({}, {"rerank": 64}, {"coarse": "int8"}):
        s, i = rec.index.search(Q[:16], **kw, **extra)
        ws, wi = twin.search(Q[:16], **kw, **extra)
        assert torch.equal(s, ws) and torch.equal(i, wi), extra
    # a checkpoint whose save waits while a batch applies holds none of it
    eng = QueryEngine(rec.index)
    eng.attach_durability(rec)
    n, dead = rec.index.n, rec.index.n_dead
    seq = []
    with faults.active({"ckpt.begin": faults.Delay(at=1, seconds=1.0)}):
        th = threading.Thread(target=lambda: seq.append(
            rec.checkpoint(barrier=eng.mutation_barrier())))
        th.start()
        while faults.hits("ckpt.begin") < 1:
            time.sleep(0.002)
        assert eng.submit_delete([0, 1]).result() == 2
        eng.submit_add(pool[32:40]).result()
        assert th.is_alive()
        th.join(60.0)
    ckpt = AshIndex.load(tmp_path / "dur" / f"ckpt-{seq[0]:020d}",
                         device="cuda")
    assert (ckpt.n, ckpt.n_dead) == (n, dead)
    s, i = ckpt.search(Q[:16], **kw)
    ws, wi = twin.search(Q[:16], **kw)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    rec.close()


# -- a second card: launches under the operands' device --------------------


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_kernels_2_and_6_on_a_second_card(two_cards, metric):
    """Kernels 2 and 6 with their operands on cuda:1 while cuda:0 is
    current, at k = 500 (the merge needs shared memory above 48 KB, an
    attribute set once per device): EQUAL to the same launches on
    cuda:0, and each wrapper counts one scan and one merge."""
    d0, d1 = two_cards
    n, m, k = 6000, 9, 500
    a0 = _args(11, 2, 100, n, m, 16, metric, d0)
    c0 = _coarse_args(12, 2, 100, n, m, 16, metric, d0)
    with torch.cuda.device(d0):
        want2 = TK.ash_score_topk_cuda(*a0, b=2, k=k, metric=metric)
        want6 = TK.ash_score_coarse_topk_cuda(*c0, b=2, k=k, metric=metric)
        a1 = [None if a is None else a.to(d1) for a in a0]
        c1 = [None if a is None else a.to(d1) for a in c0]
        assert torch.cuda.current_device() == 0
        before = dict(TK.launch_counts)
        got2 = TK.ash_score_topk_cuda(*a1, b=2, k=k, metric=metric)
        got6 = TK.ash_score_coarse_topk_cuda(*c1, b=2, k=k, metric=metric)
        torch.cuda.synchronize(d1)
        assert torch.cuda.current_device() == 0
    assert got2[0].device == d1 and got6[1].device == d1
    for got, want in ((got2, want2), (got6, want6)):
        assert torch.equal(got[0].cpu(), want[0].cpu())
        assert torch.equal(got[1].cpu(), want[1].cpu())
    for name in ("ash_score_topk", "ash_score_coarse_topk"):
        assert TK.launch_counts[name] == before[name] + 1
    assert TK.launch_counts["ash_topk_merge"] == before["ash_topk_merge"] + 2


def test_sharded_one_shard_per_card_equals_flat(two_cards):
    """A sharded index with one shard on each card: EQUAL to the flat
    index on cuda:0 (fused, materializing and rerank routes)."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    X = embedding_dataset(20008, 64, seed=3, device=devs[0])
    X, Q = X[:20000], X[20000:]
    flat = AshIndex.build(torch.Generator().manual_seed(1), X,
                          ASHConfig(b=2, d=32, n_landmarks=16),
                          learned=False, keep_raw=True, device=devs[0])
    sh = AshIndex.from_parts(flat.model, flat.payload, backend="sharded",
                             raw=flat._state.raw, mesh=devs)
    assert [p.codes.device for p in sh._state.shards.payloads] == devs
    for kw in (dict(k=10), dict(k=100), dict(k=300), dict(k=10, rerank=64)):
        got, want = sh.search(Q, **kw), flat.search(Q, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_one_card_plan_argument_bytes_equal_allocated(cuda):
    """The dry-run's per-card argument bytes of a reduced train cell on a
    1 x 1 mesh (exact from the specs) equal what the card allocates for
    that train state, each leaf rounded up to the caching allocator's
    512-byte blocks; the counters (``step``, ``rng``, the optimizer's
    step) stay on the CPU."""
    from repro_torch.configs import base as CB
    from repro_torch.configs import registry
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.train import reduced_arch
    from repro_torch.train import trainer as TTR

    arch = reduced_arch(registry.get("granite-moe-3b-a800m"))
    with LM.mesh_context((1, 1), ("data", "model")) as mesh:
        _, args = arch.make_cell_program("train_4k", mesh,
                                         SH.ShardingPolicy())
        leaves = [(p, SH.local_nbytes(t))
                  for p, t in CB.state_items(args[0])]
    counters = ("step", "rng", "opt_state/step")
    want = sum(-(-b // 512) * 512 for p, b in leaves if p not in counters)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = arch.model.init_params(
        torch.Generator(device="cuda").manual_seed(0), arch.cfg,
        device="cuda")
    state = TTR.init_state(0, params, arch.train_cfg)
    got = torch.cuda.memory_allocated() - base
    assert not state.step.is_cuda and not state.rng.is_cuda
    assert got == want
