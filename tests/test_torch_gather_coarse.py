"""Port parity: the gathered and int8 coarse scans against the JAX kernels.

The JAX side runs ``ash_score_gather[_topk]_pallas`` and
``ash_score_coarse[_topk]_pallas`` in interpret mode (fp32 compute for
the gathered scan), as the reference's own tests do on the CPU.  The
port side runs the kernel wrappers on CPU tensors, which is their plain
PyTorch version.  Both get the same numpy operands.  Tolerances:

  * exact-arithmetic inputs (small integers, power-of-two scales):
    every score is exact in fp32 in both packages, so scores, rows and
    tie order must be EQUAL, pad ids and duplicate rows included;
  * gathered scan, random fp32 inputs: rtol 1e-5 and atol 1e-5 times
    the largest |score| (fp32 reduction order over d_pad <= 128 terms);
  * coarse scan, random fp32 inputs: the integer accumulation and
    q_int8 are equal bit for bit; the epilogue differs by at most a few
    ulps, because XLA contracts the reference's multiply-adds into FMAs
    (one rounding fewer per contraction) and the port rounds every op:
    rtol 4e-7 and atol 4e-7 times the largest |score| (three roundings
    of 2^-24 each, over operands no larger than the score scale);
  * the coarse corpus mean is a sum over n rows in another order:
    rtol 1e-5; q_scale within one ulp (XLA divides by 127 as a product
    with its reciprocal), q_int8 equal, and q_corr, a cancelling sum,
    within 8 ulps of the magnitudes it sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.core import scoring as JS  # noqa: E402
from repro.core.types import ASHPayload as JPayload  # noqa: E402
from repro.core.types import QueryPrep as JPrep  # noqa: E402
from repro.kernels.ash_score import (  # noqa: E402
    ash_score_coarse_pallas, ash_score_coarse_topk_pallas,
    ash_score_gather_pallas, ash_score_gather_topk_pallas,
)
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.core.types import ASHPayload, QueryPrep  # noqa: E402
from repro_torch.kernels import ash_score as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

METRICS = ("dot", "l2", "cos")


def _inputs(seed, b, d, n, m, C, *, exact, coarse=False):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 2**b, size=(n, d))
    codes = np.array(JQ.pack_codes(
        jnp.asarray(2 * levels - (2**b - 1), jnp.int32), b))
    d_pad = codes.shape[1] * (32 // b)
    if exact:
        q = rng.integers(-3, 4, size=(m, d)).astype(np.float32)
        scale = rng.choice([0.5, 1.0, 2.0], size=n).astype(np.float32)
        offset = rng.integers(-8, 9, size=n).astype(np.float32)
        ipq = rng.integers(-8, 9, size=(m, C)).astype(np.float32)
        qterm = rng.choice([0.25, 0.5, 1.0], size=m).astype(np.float32)
        rowterm = rng.choice([0.5, 1.0, 4.0], size=n).astype(np.float32)
        q_scale = rng.choice([0.125, 0.25], size=m).astype(np.float32)
        q_corr = rng.integers(-4, 5, size=m).astype(np.float32)
    else:
        q = rng.standard_normal((m, d)).astype(np.float32)
        scale = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        offset = rng.standard_normal(n).astype(np.float32)
        ipq = rng.standard_normal((m, C)).astype(np.float32)
        qterm = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
        rowterm = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        q_scale = rng.uniform(1e-3, 1e-2, size=m).astype(np.float32)
        q_corr = rng.standard_normal(m).astype(np.float32)
    if coarse:
        q = rng.integers(-127, 128, size=(m, d)).astype(np.int8)
    q = np.pad(q, ((0, 0), (0, d_pad - d)))
    cluster = rng.integers(0, C, size=n).astype(np.int32)
    return dict(codes=codes, q=q, scale=scale, offset=offset,
                cluster=cluster, ipq=ipq, qterm=qterm, rowterm=rowterm,
                q_scale=q_scale, q_corr=q_corr)


def _rows(seed, m, R, n, pad=0.3):
    """(m, R) candidate table of ascending runs with -1 pads and a few
    repeated rows (exact ties)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=(m, R)).astype(np.int32)
    rows[rng.random((m, R)) < pad] = -1
    rows[:, R // 2:R // 2 + 6] = rows[:, :6]
    return rows


def _names(metric, coarse=False):
    first = ["codes", "q"] + (["q_scale", "q_corr"] if coarse else [])
    tail = ["qterm", "rowterm"] if metric != "dot" else [None, None]
    return first + ["scale", "offset", "cluster", "ipq"] + tail


def _jax_args(a, metric, coarse=False):
    return [None if k is None else jnp.asarray(a[k])
            for k in _names(metric, coarse)]


def _torch_args(a, metric, coarse=False):
    out = []
    for k in _names(metric, coarse):
        if k is None:
            out.append(None)
        elif k == "codes":
            out.append(torch.from_numpy(a[k].view(np.int32)))
        else:
            out.append(torch.from_numpy(np.ascontiguousarray(a[k])))
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(np.asarray(got)), np.isneginf(want))
    np.testing.assert_allclose(np.asarray(got)[fin], want[fin], rtol=rtol,
                               atol=rtol * np.abs(want[fin]).max())


# ---------------------------------------------------------------------------
# Gathered scan (kernels 3-4)
# ---------------------------------------------------------------------------


# Every (metric, b) pairing compiles the interpret-mode kernel anew (a
# few seconds each), so the cases pair metrics with bitrates instead of
# crossing them: each metric and each b in {1, 2, 4, 8} appears.
@pytest.mark.parametrize("b,metric,d,n,m,C,R", [
    (1, "dot", 100, 300, 3, 4, 200),
    (2, "l2", 64, 700, 2, 16, 333),
    (4, "cos", 40, 520, 2, 8, 130),
    (8, "l2", 20, 200, 2, 3, 77),
])
def test_gather_plain_vs_pallas(b, metric, d, n, m, C, R):
    a = _inputs(b * 11 + d, b, d, n, m, C, exact=False)
    rows = _rows(R, m, R, n)
    ja, ta = _jax_args(a, metric), _torch_args(a, metric)
    want = ash_score_gather_pallas(
        ja[0], jnp.asarray(rows), *ja[1:], b=b, metric=metric,
        interpret=True, compute_dtype=jnp.float32)
    got = TK.ash_score_gather_cuda(ta[0], torch.from_numpy(rows), *ta[1:],
                                   b=b, metric=metric)
    assert np.isneginf(got.numpy()[rows < 0]).all()
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("b,metric,R,k", [(2, "dot", 333, 12),
                                          (1, "cos", 200, 1),
                                          (4, "l2", 130, 40),
                                          (8, "dot", 77, 77),
                                          (2, "l2", 150, 100)])
def test_gather_topk_exact_inputs_equal(b, metric, R, k):
    """Exact inputs: selected scores, rows and tie order (ties to the
    lowest candidate position) equal the reference kernel's; pad ids
    never surface, and a query without live candidates gets (-inf, -1)
    in every slot."""
    n, m = 400, 3
    a = _inputs(R + b, b, 48, n, m, 8, exact=True)
    rows = _rows(k, m, R, n)
    rows[1] = -1
    ja, ta = _jax_args(a, metric), _torch_args(a, metric)
    tr = torch.from_numpy(rows)
    js, jrow = ash_score_gather_topk_pallas(
        ja[0], jnp.asarray(rows), *ja[1:], b=b, k=k, metric=metric,
        interpret=True, compute_dtype=jnp.float32)
    ts, trow = TK.ash_score_gather_topk_cuda(ta[0], tr, *ta[1:], b=b, k=k,
                                             metric=metric)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    assert (trow[1] == -1).all() and torch.isneginf(ts[1]).all()
    # and equal to a stable top-k over positions of the gathered scores
    got = TK.ash_score_gather_cuda(ta[0], tr, *ta[1:], b=b, metric=metric)
    vs, vp = TR.stable_top_k(got, k)
    assert torch.equal(vs, ts)
    assert torch.equal(tr.gather(1, vp), trow)


def test_gather_topk_strip_and_random_inputs():
    a = _inputs(41, 2, 64, 900, 6, 5, exact=False)
    rows = _rows(3, 6, 700, 900)
    ja, ta = _jax_args(a, "l2"), _torch_args(a, "l2")
    js, jrow = ash_score_gather_topk_pallas(
        ja[0], jnp.asarray(rows), *ja[1:], b=2, k=30, metric="l2",
        interpret=True, compute_dtype=jnp.float32)
    ts, trow = TK.ash_score_gather_topk_cuda(
        ta[0], torch.from_numpy(rows), *ta[1:], b=2, k=30, metric="l2")
    _close(ts.numpy(), js, 1e-5)
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    short = torch.from_numpy(rows[:, :32].copy())
    with pytest.raises(ValueError, match="candidate strip"):
        TK.ash_score_gather_topk_cuda(ta[0], short, *ta[1:], b=2, k=200,
                                      metric="l2")
    with pytest.raises(ValueError, match="candidate strip"):
        ash_score_gather_topk_pallas(
            ja[0], jnp.asarray(rows[:, :32]), *ja[1:], b=2, k=200,
            metric="l2", interpret=True)


# -- kernel 4 on the card: span geometry and the strip it emits ----------
# The card's fused gathered scan walks spans of 512-position tiles of one
# query's table (``ref.gather_span_geometry``) and writes each span's best
# L keys of (score, POSITION); the merge kernel reduces the strip and maps
# positions to rows.  Its plain model (``ref.gather_span_strip_ref``,
# merged by the merge wrapper's CPU path) must EQUAL the plain version
# and the JAX kernel: exact inputs make every score exact in both.


@pytest.mark.parametrize("R", [1, 77, 511, 512, 513, 4000, 125440])
@pytest.mark.parametrize("m", [1, 8, 13])
@pytest.mark.parametrize("k,k_tilde", [(1, None), (100, None), (32, 64),
                                       (10, 4)])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_gather_span_geometry(R, m, k, k_tilde, n_sm):
    """Whole 512-position tiles covering the table; about two blocks per
    SM over the m queries; one-tile spans when k_tilde < k; the refusal
    of ``ref.topk_geometry``."""
    try:
        _, kt, _ = TR.topk_geometry(R, k, k_tilde)
    except ValueError:
        with pytest.raises(ValueError, match="candidate strip"):
            TR.gather_span_geometry(R, m, k, k_tilde, n_sm)
        return
    n_spans, per, L = TR.gather_span_geometry(R, m, k, k_tilde, n_sm)
    n_tiles = -(-R // TR.TOPK_BLOCK_N)
    assert L == min(k, kt)
    assert (n_spans - 1) * per < n_tiles <= n_spans * per
    if k <= kt:
        target = -(-2 * n_sm // m)
        assert n_spans <= target and per == -(-n_tiles // target)
    else:
        assert per == 1 and n_spans == n_tiles


def _span_merged(scores, rows, k, k_tilde, target):
    """The card's route on the CPU: the plain strip, then the merge
    wrapper's CPU path with the candidate table (positions -> rows)."""
    strip = TR.gather_span_strip_ref(scores, rows, k, k_tilde, target)
    L = TR.span_geometry(rows.shape[1], k, k_tilde, target)[2]
    return TK.ash_topk_merge_cuda(strip, k, L, rows=rows)


@pytest.mark.parametrize("R,k,k_tilde", [(333, 12, None), (77, 77, None),
                                         (4000, 100, None), (4000, 10, 4),
                                         (1537, 30, 64), (600, 128, None)])
@pytest.mark.parametrize("order", ["random", "ascending"])
@pytest.mark.parametrize("target", [1, 3, 33])
def test_gather_span_strip_merge_equals_plain(R, k, k_tilde, order, target):
    """Merged, the plain span strip EQUALS ``ref.ash_score_gather_topk_ref``
    (scores, rows, tie order), also on a table whose scores ascend with
    position (every key passes the card's bound), with a query of pads
    only (-inf, -1) and, for k_tilde < k, the per-tile selection."""
    n, m = 500, 4
    a = _inputs(R + k, 2, 48, n, m, 8, exact=True)
    rows = _rows(k + R, m, R, n)
    rows[1] = -1
    ta = _torch_args(a, "dot")
    tr = torch.from_numpy(rows)
    if order == "ascending":
        sc = TK.ash_score_gather_cuda(ta[0], tr, *ta[1:], b=2)
        sc = torch.where(tr >= 0, sc, float("-inf"))
        tr = tr.gather(1, torch.sort(sc, dim=1, stable=True).indices)
        live = (tr >= 0)
        tr = torch.where(live, tr, -1).contiguous()
    scores = TK.ash_score_gather_cuda(ta[0], tr, *ta[1:], b=2)
    if order == "ascending":
        fin = scores[0][tr[0] >= 0]
        assert bool((fin[1:] >= fin[:-1]).all())
    want = TR.ash_score_gather_topk_ref(ta[0], tr, *ta[1:], b=2, k=k,
                                        k_tilde=k_tilde)
    got = _span_merged(scores, tr, k, k_tilde, target)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][1] == -1).all() and torch.isneginf(got[0][1]).all()
    if k_tilde is None or k <= k_tilde:
        vs, vp = TR.stable_top_k(scores, k)
        keep = torch.isneginf(vs) & (tr.gather(1, vp) < 0)
        assert torch.equal(got[0], vs)
        assert torch.equal(got[1], torch.where(keep, -1, tr.gather(1, vp)))


@pytest.mark.parametrize("b,metric,R,k", [(2, "dot", 700, 100),
                                          (4, "l2", 130, 40),
                                          (1, "cos", 1030, 9)])
def test_gather_span_strip_merge_equals_jax(b, metric, R, k):
    """The card's route modelled on the CPU against the JAX package's
    gathered top-k kernel in interpret mode: EQUAL on exact inputs,
    spans of several tiles (target 1) and of one."""
    n, m = 400, 3
    a = _inputs(R * b, b, 48, n, m, 8, exact=True)
    rows = _rows(R, m, R, n)
    rows[2, R // 3:] = -1
    ja, ta = _jax_args(a, metric), _torch_args(a, metric)
    tr = torch.from_numpy(rows)
    js, jrow = ash_score_gather_topk_pallas(
        ja[0], jnp.asarray(rows), *ja[1:], b=b, k=k, metric=metric,
        interpret=True, compute_dtype=jnp.float32)
    scores = TK.ash_score_gather_cuda(ta[0], tr, *ta[1:], b=b, metric=metric)
    for target in (1, 264):
        got = _span_merged(scores, tr, k, None, target)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(js))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jrow))


def test_merge_wrapper_rows_equals_positions_to_rows():
    """The merge with a candidate table equals ``ref.positions_to_rows`` of
    the merge without (the CPU path of the card's option)."""
    rng = np.random.default_rng(5)
    m, R, k = 3, 900, 50
    scores = torch.from_numpy(rng.integers(-9, 10, (m, R)).astype(
        np.float32))
    rows = torch.from_numpy(_rows(1, m, R, 2000))
    strip = TR.gather_span_strip_ref(scores, rows, k, None, 2)
    L = TR.span_geometry(R, k, None, 2)[2]
    s0, p0 = TK.ash_topk_merge_cuda(strip, k, L)
    s1, r1 = TK.ash_topk_merge_cuda(strip, k, L, rows=rows)
    assert torch.equal(s0, s1)
    assert torch.equal(r1, TR.positions_to_rows(rows, p0))


# ---------------------------------------------------------------------------
# Coarse operands and the coarse scan (kernels 5-6)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_coarse_codes_and_query_quantization(b):
    rng = np.random.default_rng(b)
    a = _inputs(b, b, 40, 333, 5, 4, exact=False)
    jp = JPayload(b=b, d=40, codes=jnp.asarray(a["codes"]),
                  scale=jnp.asarray(a["scale"]),
                  offset=jnp.asarray(a["offset"]),
                  cluster=jnp.asarray(a["cluster"]))
    tp = ASHPayload.from_numpy(b, 40, {k: a[k] for k in (
        "codes", "scale", "offset", "cluster")}, device="cpu")
    jc = JS.coarse_codes(jp)
    tc = TS.coarse_codes(tp)
    d_pad = a["codes"].shape[1] * (32 // b)
    # the port keeps no value matrix; its unpack gives the same integers
    np.testing.assert_array_equal(
        TQ.unpack_codes(tp.codes, d_pad, b).float().numpy(),
        np.asarray(jc.values))
    np.testing.assert_allclose(tc.mean.numpy(), np.asarray(jc.mean),
                               rtol=1e-5, atol=1e-6)
    q = rng.standard_normal((5, 40)).astype(np.float32)
    q[0] = 0.0  # eps-guarded scale
    q[1, :4] = [2.5, -0.5, 1.5, 127.0]  # halves round to even
    mean = np.asarray(jc.mean)
    zero = np.zeros((5, 1), np.float32)
    jq = JS.prepare_coarse_queries(
        JPrep(q=jnp.asarray(q), q_proj=jnp.asarray(q),
              ip_q_landmarks=jnp.asarray(zero), q_sq_norm=jnp.zeros(5)),
        jnp.asarray(mean))
    tq = TS.prepare_coarse_queries(
        QueryPrep(q=torch.from_numpy(q), q_proj=torch.from_numpy(q),
                  ip_q_landmarks=torch.from_numpy(zero),
                  q_sq_norm=torch.zeros(5)),
        torch.from_numpy(mean))
    np.testing.assert_array_equal(tq.q_int8.numpy(), np.asarray(jq.q_int8))
    # XLA turns the reference's division by 127 into a product with its
    # reciprocal: q_scale agrees within one ulp
    np.testing.assert_allclose(tq.q_scale.numpy(), np.asarray(jq.q_scale),
                               rtol=2.0**-23, atol=0)
    # q_corr = <q - s * q_int8, mean> cancels: its error is a few ulps
    # of the terms it sums, sum_k (|q_k| + s |q_int8_k|) |mean_k|
    qi = tq.q_int8.numpy().astype(np.float32)
    terms = (np.abs(q) + tq.q_scale.numpy()[:, None] * np.abs(qi)) \
        @ np.abs(mean[:40])
    assert (np.abs(tq.q_corr.numpy() - np.asarray(jq.q_corr))
            <= 2.0**-21 * terms).all()


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_coarse_integer_accumulation_exact(b):
    """The dot term of both packages equals the int64 product of the
    same integers: exact, whatever the summation order."""
    a = _inputs(b + 50, b, 100, 260, 4, 4, exact=False, coarse=True)
    d_pad = a["q"].shape[1]
    V = np.asarray(JQ.unpack_codes(jnp.asarray(a["codes"]), d_pad, b))
    exact = a["q"].astype(np.int64) @ V.astype(np.int64).T
    ones = dict(a, scale=np.ones_like(a["scale"]),
                offset=np.zeros_like(a["offset"]),
                ipq=np.zeros_like(a["ipq"]),
                q_scale=np.ones_like(a["q_scale"]),
                q_corr=np.zeros_like(a["q_corr"]))
    got = TK.ash_score_coarse_cuda(*_torch_args(ones, "dot", True), b=b)
    want = ash_score_coarse_pallas(*_jax_args(ones, "dot", True), b=b,
                                   interpret=True)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(want), exact.astype(np.float32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m", [(1, 100, 300, 3), (2, 64, 700, 5),
                                     (4, 40, 520, 8), (8, 20, 200, 2)])
def test_coarse_plain_vs_pallas(metric, b, d, n, m):
    for exact in (True, False):
        a = _inputs(b * 13 + d, b, d, n, m, 8, exact=exact, coarse=True)
        want = ash_score_coarse_pallas(*_jax_args(a, metric, True), b=b,
                                       metric=metric, interpret=True)
        got = TK.ash_score_coarse_cuda(*_torch_args(a, metric, True), b=b,
                                       metric=metric)
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got.numpy(), want, 4e-7)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masking", ["none", "row_valid", "n_valid", "both"])
@pytest.mark.parametrize("b", [2, 8])
def test_coarse_topk_plain_vs_pallas(metric, masking, b):
    """Exact inputs with duplicate rows: values, ids and tie order equal
    the reference kernel's under every mask; masked rows never
    surface."""
    n, k = 1100, 16
    a = _inputs(b + 61, b, 48, n, 4, 8, exact=True, coarse=True)
    for name in ("codes", "scale", "offset", "cluster", "rowterm"):
        a[name][1000:1040] = a[name][0:40]
    rng = np.random.default_rng(7)
    row_valid = rng.random(n) > 0.2 if masking in ("row_valid", "both") \
        else None
    n_valid = 1060 if masking in ("n_valid", "both") else None
    js, ji = ash_score_coarse_topk_pallas(
        *_jax_args(a, metric, True),
        None if n_valid is None else jnp.int32(n_valid),
        None if row_valid is None else jnp.asarray(row_valid),
        b=b, k=k, metric=metric, interpret=True)
    rv = None if row_valid is None else torch.from_numpy(row_valid)
    ts, ti = TK.ash_score_coarse_topk_cuda(
        *_torch_args(a, metric, True), n_valid, rv, b=b, k=k, metric=metric)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    full = TR.mask_rows_ref(TK.ash_score_coarse_cuda(
        *_torch_args(a, metric, True), b=b, metric=metric), n_valid, rv)
    vs, vi = TR.stable_top_k(full, k)
    assert torch.equal(vs, ts) and torch.equal(vi.to(torch.int32), ti)


def test_coarse_gather_plain_matches_dense():
    """The gathered coarse scan (plain on every device) equals the dense
    coarse scan on shared rows: exact integers, one epilogue."""
    a = _inputs(71, 2, 64, 500, 5, 8, exact=False, coarse=True)
    ta = _torch_args(a, "cos", True)
    rows = torch.from_numpy(_rows(5, 5, 260, 500))
    dense = TR.ash_score_coarse_ref(*ta, b=2, metric="cos")
    g = TR.ash_score_coarse_gather_ref(ta[0], rows, *ta[1:], b=2,
                                       metric="cos")
    live = rows >= 0
    assert torch.isneginf(g[~live]).all()
    want = dense.gather(1, rows.clamp(min=0).long())
    assert torch.equal(g[live], want[live])
