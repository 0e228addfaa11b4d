"""Kernel 5's tensor-core arithmetic and kernel 6's scan, modelled in numpy.

``csrc/ash_coarse.cu`` runs only on the card.  What its two scans rely
on is checked here, on the CPU, with the same integer operations:

  * byte planes: for b in {1, 2, 4, 8}, ``(word >> b*s) & M_b`` (M_b: b
    ones in each byte) holds the levels of codes c * (8/b) + s in bytes
    c = 0..3, equal to the levels of ``unpack_codes`` of both packages,
    for every plane and whatever the word's other bits;
  * kernel 5's fragments: a row passes through the stages in chunks of
    at most 32 words (one chunk up to wd = 32); in a chunk, lane (g, t)
    owns the word pairs 8c + 2t, 8c + 2t + 1 of rows g and g + 8 of a
    16-row group; its local planes fill k slots in order, and the B
    fragments carry each query's int8 values at the same dimensions (a
    block of MQ < 8 queries keeps the fragments of its MQ columns and
    gives the others zero).  Laid out as the PTX ISA's m16n8k32 tables
    (8-bit A and B, s32 C) say and multiplied as one u8 x s8 product,
    they give 2 * sum q*l - (2^b - 1) * sum q equal to the plain
    version's integer accumulation, bit for bit, at ragged d_pad (not a
    multiple of 32), m in {1, 3, 8, 9, 17}, ragged n, rows of several
    chunks and MQ in {8, 4, 2, 1};
  * kernel 6's per-thread route: byte planes times permuted query
    quadruples with mixed-sign dp4a (u8 x s8), the same identity;
  * the sum-of-q identity at the int8 extremes (q = +-127, b = 8 levels
    0 and 255);
  * the modelled scores (the unfused fp32 epilogue, in the kernels'
    order) EQUAL to ``ref.ash_score_coarse_ref`` and within
    ``tests/test_torch_gather_coarse.py``'s coarse tolerance (rtol 4e-7,
    atol 4e-7 x the largest |score|: XLA contracts the reference's
    multiply-adds into FMAs) of the JAX package's
    ``repro.kernels.ref.ash_score_coarse_ref``.
Inputs are made from a seed with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

U = np.uint32
MT = 8  # queries a block (the mma's n)
BITS = (1, 2, 4, 8)
METRICS = ("dot", "l2", "cos")


def plane(words, b: int, s: int):
    """``plane<b>(word, s)``: (word >> b*s) & M_b on uint32 words."""
    return (words >> U(b * s)) & U(((1 << b) - 1) * 0x01010101)


def byte_lanes(x, signed: bool):
    """uint32 (...) -> (..., 4) int64 bytes, byte c = bits 8c..8c+7."""
    v = (x[..., None].astype(np.int64) >> np.arange(0, 32, 8)) & 0xFF
    return np.where(v > 127, v - 256, v) if signed else v


def query_quad(q_int8, qi: int, w: int, s: int, b: int) -> int:
    """``query_quad<b>``: query qi's values at dims w*(32/b) + c*(8/b) + s
    packed into the bytes of a word (0 past m)."""
    if qi >= q_int8.shape[0]:
        return 0
    dims = w * (32 // b) + np.arange(4) * (8 // b) + s
    return int(sum((int(v) & 0xFF) << (8 * c)
                   for c, v in enumerate(q_int8[qi, dims])))


KC = 32  # COARSE_KC: words of a row a stage, at most


def chunks(wd: int, b: int):
    """``coarse_chunks<b>``: (chunks a row, words a chunk, k-steps a
    chunk)."""
    n = 1 if wd <= KC else -(-wd // KC)
    kw = wd if n == 1 else KC
    return n, kw, (kw + 7) // 8 * (8 // b)


def chunk_word(lw: int, t: int) -> int:
    """The word of a chunk that is lane t's local word lw: pairs 8c + 2t,
    8c + 2t + 1."""
    return 8 * (lw >> 1) + 2 * t + (lw & 1)


def b_fragments(q_int8, m0: int, wd: int, b: int, mq: int = MT):
    """``load_mma_queries``: (ks, 32 lanes, 2) uint32, lane's b0 and b1;
    lanes of columns past mq read the kernel's zero fragment."""
    ppw = 8 // b
    nch, kw, ksc = chunks(wd, b)
    m_end = min(q_int8.shape[0], m0 + mq)
    bq = np.zeros((nch * ksc, 32, 2), np.uint32)
    for kk in range(nch * ksc):
        for lane in range(4 * mq):
            for h in range(2):
                p = 2 * (kk % ksc) + h
                x = chunk_word(p // ppw, lane & 3)
                w = kk // ksc * kw + x
                qi = m0 + (lane >> 2)
                if x < kw and w < wd and qi < m_end:
                    bq[kk, lane, h] = query_quad(q_int8, qi, w, p % ppw, b)
    return bq


def mma_m16n8k32(acc, a, bfrag):
    """One ``mma.sync.m16n8k32.row.col.s32.u8.s8.s32`` per group: a
    (G, 32, 4) and bfrag (32, 2) uint32 registers, acc (G, 32, 4) int64,
    placed by the PTX ISA's fragment tables (g = lane / 4, t = lane % 4):
    a0 row g, k 4t..4t+3; a1 row g + 8, same k; a2 row g, k 16+4t..;
    a3 row g + 8, k 16+4t..; b0 column g, k 4t..; b1 column g, k 16+4t..;
    c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8."""
    G = a.shape[0]
    A = np.zeros((G, 16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        k0, k1 = slice(4 * t, 4 * t + 4), slice(16 + 4 * t, 20 + 4 * t)
        A[:, g, k0] = byte_lanes(a[:, lane, 0], False)
        A[:, g + 8, k0] = byte_lanes(a[:, lane, 1], False)
        A[:, g, k1] = byte_lanes(a[:, lane, 2], False)
        A[:, g + 8, k1] = byte_lanes(a[:, lane, 3], False)
        Bm[k0, g] = byte_lanes(bfrag[lane, 0], True)
        Bm[k1, g] = byte_lanes(bfrag[lane, 1], True)
    D = A @ Bm  # (G, 16, 8)
    out = acc.copy()
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out[:, lane] += np.stack([D[:, g, 2 * t], D[:, g, 2 * t + 1],
                                  D[:, g + 8, 2 * t], D[:, g + 8, 2 * t + 1]],
                                 axis=1)
    return out


def kernel5_acc(words, q_int8, b: int, mq: int = MT):
    """Kernel 5's integer dot terms (m, n): 2 * (sum of the mma products)
    + ncorr, each lane feeding its own byte planes chunk by chunk, blocks
    of mq queries, rows past n zero-filled (and dropped)."""
    n, wd = words.shape
    m = q_int8.shape[0]
    ppw = 8 // b
    nch, kw, ksc = chunks(wd, b)
    n_groups = (n + 15) // 16
    padded = np.zeros((n_groups * 16, wd), np.uint32)
    padded[:n] = words
    out = np.zeros((m, n), np.int64)
    for m0 in range(0, m, mq):
        m_end = min(m, m0 + mq)
        bq = b_fragments(q_int8, m0, wd, b, mq)
        ncorr = [-((1 << b) - 1) * int(q_int8[i].astype(np.int64).sum())
                 if i < m_end else 0 for i in range(m0, m0 + MT)]
        acc = np.zeros((n_groups, 32, 4), np.int64)
        for ch in range(nch):
            for c in range(ksc // ppw):
                # wv[G, lane, row g / g + 8, word of the pair]
                wv = np.zeros((n_groups, 32, 2, 2), np.uint32)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for half in range(2):
                        rows = np.arange(n_groups) * 16 + g + 8 * half
                        for x in range(2):
                            xw = 8 * c + 2 * t + x
                            w = ch * kw + xw
                            if xw < kw and w < wd:
                                wv[:, lane, half, x] = padded[rows, w]
                for u in range(ppw):  # k-step c * ppw + u: planes 2u, 2u + 1
                    w0, s0 = divmod(2 * u, ppw)
                    w1, s1 = divmod(2 * u + 1, ppw)
                    a = np.stack([plane(wv[:, :, 0, w0], b, s0),
                                  plane(wv[:, :, 1, w0], b, s0),
                                  plane(wv[:, :, 0, w1], b, s1),
                                  plane(wv[:, :, 1, w1], b, s1)], axis=2)
                    acc = mma_m16n8k32(acc, a, bq[ch * ksc + c * ppw + u])
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for e in range(4):
                qi = m0 + 2 * t + (e & 1)
                rows = np.arange(n_groups) * 16 + g + 8 * (e >> 1)
                keep = rows < n
                if qi < m_end:
                    out[qi, rows[keep]] = (2 * acc[keep, lane, e]
                                           + ncorr[qi - m0])
    assert (np.abs(out) < 2**31).all()
    return out


def dp4a_us(a, b, c):
    """``dp4a.u32.s32``: c + the byte products, a unsigned, b signed."""
    return c + (byte_lanes(a, False) * byte_lanes(b, True)).sum(-1)


def kernel6_acc(words, q_int8, b: int):
    """Kernel 6's per-thread integer dot terms (m, n): each row's byte
    planes times the query quadruples of ``load_coarse_chunk``'s layout
    (q_s[p * MT + i], p = w * (8/b) + s) with mixed-sign dp4a."""
    n, wd = words.shape
    m = q_int8.shape[0]
    ppw = 8 // b
    out = np.zeros((m, n), np.int64)
    for i in range(m):
        acc = np.zeros(n, np.int64)
        for w in range(wd):
            for s in range(ppw):
                quad = np.uint32(query_quad(q_int8, i, w, s, b))
                acc = dp4a_us(plane(words[:, w], b, s), quad, acc)
        out[i] = 2 * acc - ((1 << b) - 1) * q_int8[i].astype(np.int64).sum()
    return out


def coarse_scores(acc, a, metric: str):
    """The kernels' epilogue in fp32, one rounding an op, in their order:
    dotc = acc * q_scale; biasq = bias + q_corr; dotc * scale + biasq +
    offset; then the metric tail."""
    f = np.float32
    dotc = acc.astype(f) * a["q_scale"][:, None]
    biasq = a["ipq"][:, a["cluster"]] + a["q_corr"][:, None]
    base = (dotc * a["scale"][None, :] + biasq) + a["offset"][None, :]
    qt, rt = a["qterm"][:, None], a["rowterm"][None, :]
    if metric == "l2":
        return (f(2) * base - qt) - rt
    if metric == "cos":
        return (base * qt) * rt
    return base


def _inputs(seed, b, d, n, m, C=16):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 2**b, size=(n, d))
    words = np.array(JQ.pack_codes(
        jnp.asarray(2 * levels - (2**b - 1), jnp.int32), b)).view(np.uint32)
    d_pad = words.shape[1] * (32 // b)
    q = np.zeros((m, d_pad), np.int8)
    q[:, :d] = rng.integers(-127, 128, size=(m, d))
    f32 = np.float32
    return dict(
        words=words, q=q,
        q_scale=rng.uniform(1e-3, 1e-2, m).astype(f32),
        q_corr=rng.standard_normal(m).astype(f32),
        scale=rng.uniform(0.5, 2.0, n).astype(f32),
        offset=rng.standard_normal(n).astype(f32),
        cluster=rng.integers(0, C, n).astype(np.int32),
        ipq=rng.standard_normal((m, C)).astype(f32),
        qterm=rng.uniform(0.5, 2.0, m).astype(f32),
        rowterm=rng.uniform(0.5, 2.0, n).astype(f32))


def _exact(words, q_int8, b):
    """The plain integer accumulation: q_int8 @ grid values, in int64."""
    d_pad = q_int8.shape[1]
    V = TQ.unpack_codes(torch.from_numpy(words.view(np.int32)), d_pad, b)
    return q_int8.astype(np.int64) @ V.numpy().astype(np.int64).T


@pytest.mark.parametrize("b,s", [(b, s) for b in BITS for s in range(8 // b)])
def test_byte_planes_are_levels(b, s):
    rng = np.random.default_rng(10 * b + s)
    words = np.concatenate([rng.integers(0, 2**32, 200, dtype=np.uint32),
                            np.array([0, 0xFFFFFFFF], np.uint32)])
    got = byte_lanes(plane(words, b, s), False)  # (N, 4): byte c
    codes = np.arange(4) * (8 // b) + s
    lv = lambda vals: (vals + (2**b - 1)) // 2  # noqa: E731
    port = TQ.unpack_codes(torch.from_numpy(words.view(np.int32))[:, None],
                           32 // b, b).numpy().astype(np.int64)
    jax_ = np.asarray(JQ.unpack_codes(jnp.asarray(words[:, None]), 32 // b,
                                      b)).astype(np.int64)
    np.testing.assert_array_equal(got, lv(port)[:, codes])
    np.testing.assert_array_equal(got, lv(jax_)[:, codes])
    assert got.max() <= 2**b - 1  # one code a byte, nothing else


# d chosen so that d_pad = wd * 32 / b is not a multiple of 32 where the
# bitrate allows it (b = 1 packs 32 codes a word), and wd is odd or not a
# multiple of 4 (lanes with partial or no words)
_RAGGED = {1: (70, 45), 2: (48, 37), 4: (40, 53), 8: (20, 41)}


@pytest.mark.parametrize("m", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("b", BITS)
def test_mma_fragment_model_equals_plain_accumulation(b, m):
    d, n = _RAGGED[b]
    a = _inputs(100 * b + m, b, d, n, m)
    d_pad = a["q"].shape[1]
    assert n % 16 and (b == 1 or d_pad % 32)
    np.testing.assert_array_equal(kernel5_acc(a["words"], a["q"], b),
                                  _exact(a["words"], a["q"], b))


# rows of several chunks: b = 8, d = 132 (two, the last of one word),
# b = 8, d = 200 (two), b = 4, d = 1000 and b = 1, d = 4000 (wd = 125:
# four, the last of 29 words), b = 2, d = 1024 (wd = 64: two whole ones)
@pytest.mark.parametrize("mq", [8, 4, 2, 1])
@pytest.mark.parametrize("b,d", [(8, 132), (8, 200), (4, 1000), (1, 4000),
                                 (2, 1024)])
def test_mma_fragment_model_chunks_and_query_split(b, d, mq):
    a = _inputs(b * d + mq, b, d, 21, 9)
    assert a["words"].shape[1] > KC
    np.testing.assert_array_equal(kernel5_acc(a["words"], a["q"], b, mq),
                                  _exact(a["words"], a["q"], b))


@pytest.mark.parametrize("b,d", [(1, 100), (2, 128), (2, 48), (4, 72),
                                 (8, 20), (8, 128)])
def test_dp4a_row_model_equals_plain_accumulation(b, d):
    a = _inputs(b + d, b, d, 50, 9)
    np.testing.assert_array_equal(kernel6_acc(a["words"], a["q"], b),
                                  _exact(a["words"], a["q"], b))


@pytest.mark.parametrize("qv", [127, -127])
def test_sum_q_identity_at_int8_extremes(qv):
    """b = 8: levels 0 and 255 (grid values -255, 255) against q = +-127,
    the largest products the u8 x s8 route meets; every route equals the
    plain accumulation and stays inside int32."""
    b, d, n = 8, 128, 20
    levels = np.zeros((n, d), np.int64)
    levels[1::2] = 255
    levels[2, ::3] = 255
    words = np.array(JQ.pack_codes(jnp.asarray(2 * levels - 255, jnp.int32),
                                   b)).view(np.uint32)
    q = np.full((3, d), qv, np.int8)
    q[1, ::2] = -qv
    want = _exact(words, q, b)
    assert np.abs(want).max() == 127 * 255 * d
    np.testing.assert_array_equal(kernel5_acc(words, q, b), want)
    np.testing.assert_array_equal(kernel6_acc(words, q, b), want)
    # the identity itself: sum q (2l - 255) = 2 sum q l - 255 sum q
    ql = q.astype(np.int64) @ levels.T
    np.testing.assert_array_equal(
        2 * ql - 255 * q.astype(np.int64).sum(1)[:, None], want)


def test_plain_version_exact_beyond_2_24():
    """b = 8 rows at d_pad = 1024 against q = +-127: the integer sums
    reach 127 * 255 * 1024 > 2^24, where an fp32 product of the integers
    rounds.  The plain version's dot term is the exact integer rounded
    once to fp32, as kernel 5's int32 accumulation (modelled) gives it."""
    b, d, n = 8, 1024, 20
    rng = np.random.default_rng(24)
    levels = rng.integers(0, 256, size=(n, d))
    levels[0] = 255
    levels[1, ::2] = 0
    words = np.array(JQ.pack_codes(jnp.asarray(2 * levels - 255, jnp.int32),
                                   b)).view(np.uint32)
    q = np.full((3, d), 127, np.int8)
    q[1] = rng.integers(-127, 128, size=d)
    q[2, 1::2] = -127
    exact = _exact(words, q, b)
    assert np.abs(exact).max() > 2**24
    np.testing.assert_array_equal(kernel5_acc(words, q, b), exact)
    a = _inputs(1, b, d, n, 3)
    t = [torch.from_numpy(words.view(np.int32)), torch.from_numpy(q)] + [
        torch.from_numpy(a[k]) for k in ("q_scale", "q_corr", "scale",
                                          "offset", "cluster", "ipq")]
    got = TR.ash_score_coarse_ref(*t, None, None, b=b, metric="dot")
    np.testing.assert_array_equal(got.numpy(),
                                  coarse_scores(exact, a, "dot"))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m", [(1, 100, 70, 3), (2, 48, 37, 9),
                                     (4, 72, 45, 8), (8, 20, 33, 17)])
def test_modelled_scores_equal_plain_and_jax(b, d, n, m, metric):
    a = _inputs(7 * b + d + m, b, d, n, m)
    got = coarse_scores(kernel5_acc(a["words"], a["q"], b), a, metric)
    got6 = coarse_scores(kernel6_acc(a["words"], a["q"], b), a, metric)
    extra = metric != "dot"
    names = ["q_scale", "q_corr", "scale", "offset", "cluster", "ipq"]
    t = [torch.from_numpy(a["words"].view(np.int32)),
         torch.from_numpy(a["q"])] + [torch.from_numpy(a[k]) for k in names]
    tail = ([torch.from_numpy(a["qterm"]), torch.from_numpy(a["rowterm"])]
            if extra else [None, None])
    want = TR.ash_score_coarse_ref(*t, *tail, b=b, metric=metric).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got6, want)
    j = [jnp.asarray(a["words"]), jnp.asarray(a["q"])] + [
        jnp.asarray(a[k]) for k in names]
    jtail = ([jnp.asarray(a["qterm"]), jnp.asarray(a["rowterm"])]
             if extra else [None, None])
    jw = np.asarray(JR.ash_score_coarse_ref(*j, *jtail, b=b, metric=metric))
    np.testing.assert_allclose(got, jw, rtol=4e-7,
                               atol=4e-7 * np.abs(jw).max())
