"""The fused selection of kernels 2 and 6 on the card, modelled on the CPU.

The card's fused scans walk spans of 512-row tiles (``ref.span_geometry``)
and keep a running top-L per query behind a threshold
(``csrc/ash_select.cuh``); one launch merges the span lists
(``csrc/ash_select.cu``).  The CUDA code runs only on the card
(``tests/cuda/test_torch_cuda.py``); here:

  * the span geometry: whole tiles covering every row, one-tile spans
    when k_tilde < k, and the same refusal as ``ref.topk_geometry`` and
    the JAX package's ``ash_score_topk_pallas``;
  * the plain span strip (``ref.span_strip_ref``) merged by
    ``ref.merge_strip`` EQUALS ``ref.tile_topk_ref`` (values, ids, tie
    order) under ties, masks, -inf rows and ascending scores, and for
    k_tilde < k its strip equals the per-tile strip;
  * a step-by-step model of the device routine (warps taking 256 keys
    at a time against one bound, survivors sorted and merged into a
    warp's list by the min-of-reversed-run step, lists merged in a tree)
    at the kernels' list sizes: the result equals the exact top-L in
    random, ascending, descending and tied orders, with invalid rows;
  * the key encoding (``ref.make_keys``/``keys_to_strip``) orders as
    (score desc, id asc) and round-trips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ash_score import ash_score_topk_pallas  # noqa: E402
from repro_torch.kernels import ash_score as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

TILE = TR.TOPK_BLOCK_N
INVALID = np.uint64(2**64 - 1)


# -- span geometry ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 300, 511, 512, 513, 6000, 10**6])
@pytest.mark.parametrize("k,k_tilde", [(1, None), (10, None), (100, None),
                                       (32, 64), (10, 4)])
@pytest.mark.parametrize("target", [1, 7, 264])
def test_span_geometry_covers_rows_in_whole_tiles(n, k, k_tilde, target):
    try:
        n_blocks, kt, _ = TR.topk_geometry(n, k, k_tilde)
    except ValueError:
        with pytest.raises(ValueError, match="candidate strip"):
            TR.span_geometry(n, k, k_tilde, target)
        return
    n_spans, per, L = TR.span_geometry(n, k, k_tilde, target)
    n_tiles = -(-n // TILE)
    assert L == min(k, kt)
    assert per >= 1 and n_spans >= 1
    # every span starts inside the rows and together they cover them
    assert (n_spans - 1) * per < n_tiles <= n_spans * per
    if kt < k:
        assert per == 1 and n_spans == n_tiles == n_blocks
    else:
        assert n_spans <= max(1, target) or per == 1


# -- the fused dense scan's tiles (kernel 2) --------------------------------

@pytest.mark.parametrize("m,chunk", [(1, 8), (2, 8), (8, 8), (9, 32),
                                     (31, 32), (32, 32), (33, 32),
                                     (128, 32), (1024, 32), (5000, 32)])
def test_dense_query_chunk_follows_m(m, chunk):
    """8 queries a block up to m = 8, 32 past it, at the main path's
    d_pad and list lengths; 8 for lists longer than WIDE_MAX_L."""
    for d_pad, L in ((128, 100), (32, 10), (256, 128), (64, 1)):
        assert TR.dense_query_chunk(m, d_pad, L) == chunk
    for L in (129, 256, 512):
        assert TR.dense_query_chunk(m, 128, L) == TR.MT


@pytest.mark.parametrize("d_pad,L,wide", [(1024, 128, True),
                                          (1408, 128, True),
                                          (1536, 128, False),
                                          (1408, 32, True),
                                          (8192, 1, False)])
def test_dense_query_chunk_narrow_where_wide_does_not_fit(d_pad, L, wide):
    """The wide tile only where its block's shared memory fits the
    card's 227 KB."""
    assert (TR.dense_query_chunk(100, d_pad, L) == TR.WIDE_CHUNK) == wide
    assert (TR.dense_topk_smem(d_pad, L, TR.WIDE_CHUNK)
            <= TR.SMEM_BLOCK_MAX) == wide
    assert TR.dense_query_chunk(100, d_pad, L, smem_max=10**9) == \
        TR.WIDE_CHUNK


def test_dense_topk_smem_counts_the_blocks_operands():
    # t2i's shape, wide: 32 queries x 128 dims of f32, a list of 128 keys
    # and a bound a query, 512 keys a group of 8 queries, a lock a query
    assert TR.dense_topk_smem(128, 100, 32) == (
        4 * 128 * 32 + 8 * (32 * 128 + 32 + 4 * 512) + 4 * 32)
    # narrow: 8 queries' values, a tile of 512 keys, a list and a bound
    # a query
    assert TR.dense_topk_smem(128, 100, 8) == (
        4 * 128 * 8 + 8 * (8 * 512 + 8 * 128 + 8))
    assert [TR.list_lanes(L) for L in (1, 32, 33, 64, 100, 128, 129, 512)] \
        == [1, 1, 2, 2, 4, 4, 8, 16]


@pytest.mark.parametrize("n", [1, 511, 513, 6000, 10**6, 10**7])
@pytest.mark.parametrize("m", [1, 8, 9, 32, 33, 128, 1024, 9000])
@pytest.mark.parametrize("k,k_tilde", [(10, None), (100, None), (12, 5)])
def test_dense_span_geometry_covers_rows_in_whole_tiles(n, m, k, k_tilde):
    """Both tiles' spans cover every row in whole 512-row tiles, one
    span a tile when k_tilde < k.  The narrow tile takes two blocks an
    SM for each query chunk; the wide one shares one an SM among its
    chunks, so a chunk's spans shrink as the chunks grow and the grid
    stays within one wave of 132 blocks where spans allow."""
    try:
        TR.topk_geometry(n, k, k_tilde)
    except ValueError:
        return
    n_tiles = -(-n // TILE)
    for chunk in (TR.MT, TR.WIDE_CHUNK):
        n_spans, per, L = TR.dense_span_geometry(n, m, k, k_tilde, chunk,
                                                 132)
        chunks = -(-m // chunk)
        target = 264 if chunk == TR.MT else max(1, 132 // chunks)
        assert TR.dense_target_spans(m, chunk, 132) == target
        assert L == min(k, k if k_tilde is None else k_tilde)
        assert (n_spans - 1) * per < n_tiles <= n_spans * per
        if k_tilde is not None and k_tilde < k:
            assert per == 1 and n_spans == n_tiles
        else:
            assert (n_spans, per, L) == TR.span_geometry(n, k, k_tilde,
                                                          target)
            if chunk == TR.WIDE_CHUNK:
                assert n_spans * chunks <= max(132, chunks) or per == 1
    assert TR.dense_target_spans(m, TR.WIDE_CHUNK, 132, 264) == \
        max(1, 264 // -(-m // TR.WIDE_CHUNK))


def test_wide_launch_counter_resets_with_the_others():
    assert "ash_score_topk_wide" in TK.launch_counts
    with TK._count_lock:
        TK.launch_counts["ash_score_topk_wide"] = 3
        TK.launch_counts["ash_score_topk"] = 3
    assert TK.kernel_launches() >= 3
    TK.reset_launch_counts()
    assert TK.launch_counts["ash_score_topk_wide"] == 0
    assert TK.kernel_launches() == 0


@pytest.mark.parametrize("n,k,k_tilde", [(700, 10, 4), (300, 2, 1),
                                         (1500, 13, 4), (128, 129, None)])
def test_span_geometry_refuses_as_the_jax_package(n, k, k_tilde):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 2**31, size=(n, 2)).astype(np.uint32)
    args = (jnp.asarray(codes), jnp.zeros((2, 32), jnp.float32),
            jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.int32), jnp.zeros((2, 4), jnp.float32))
    with pytest.raises(ValueError, match="candidate strip"):
        ash_score_topk_pallas(*args, b=2, k=k, k_tilde=k_tilde,
                              interpret=True)
    with pytest.raises(ValueError, match="candidate strip"):
        TR.topk_geometry(n, k, k_tilde)
    with pytest.raises(ValueError, match="candidate strip"):
        TR.span_geometry(n, k, k_tilde)


def test_span_geometry_accepts_as_the_jax_package():
    """Where the JAX package accepts k (k_tilde < k inside the strip),
    so does the span geometry, and its merged result equals the JAX
    kernel's on exact inputs."""
    rng = np.random.default_rng(3)
    n, m = 700, 2
    codes = rng.integers(0, 2**31, size=(n, 2)).astype(np.uint32)
    q = rng.integers(-3, 4, size=(m, 32)).astype(np.float32)
    ipq = rng.integers(-4, 5, size=(m, 4)).astype(np.float32)
    cluster = rng.integers(0, 4, size=n).astype(np.int32)
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    js, ji = ash_score_topk_pallas(
        jnp.asarray(codes), jnp.asarray(q), jnp.asarray(ones),
        jnp.asarray(zeros), jnp.asarray(cluster), jnp.asarray(ipq), b=2,
        k=8, k_tilde=4, interpret=True, compute_dtype=jnp.float32)
    assert TR.span_geometry(n, 8, 4) == (2, 1, 4)
    scores = TR.ash_score_ref(
        torch.from_numpy(codes.view(np.int32)), torch.from_numpy(q),
        torch.from_numpy(ones), torch.from_numpy(zeros),
        torch.from_numpy(cluster), torch.from_numpy(ipq), 2)
    vals, ids = TR.span_strip_ref(scores, torch.ones(n, dtype=torch.bool),
                                  8, 4)
    s, i = TR.merge_strip(vals, ids, 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# -- the plain span strip against the per-tile selection -------------------

def _scores(seed, m, n, *, ties=True, ascending=False):
    """Small-integer scores (many exact ties), a few -inf, duplicates."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-20, 21, size=(m, n)).astype(np.float32)
    if not ties:
        s = rng.standard_normal((m, n)).astype(np.float32)
    if ascending:
        s = np.sort(s, axis=1)
    s[:, rng.integers(0, n, size=3)] = -np.inf
    return torch.from_numpy(s)


def _masks(seed, m, n):
    rng = np.random.default_rng(seed)
    yield torch.ones(n, dtype=torch.bool)
    yield torch.from_numpy(rng.random(n) > 0.3)
    yield torch.arange(n) < n - 37
    yield torch.from_numpy(rng.random((m, n)) > 0.9)  # few valid rows
    yield torch.zeros(n, dtype=torch.bool)


def _accepted(n, k, k_tilde):
    try:
        TR.topk_geometry(n, k, k_tilde)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("n,k,k_tilde", [
    (n, k, kt) for n in (300, 512, 2000, 6000)
    for k, kt in ((1, None), (10, None), (100, None), (7, 64), (512, None))
    if _accepted(n, k, kt)])
@pytest.mark.parametrize("order", ["random", "ascending", "distinct"])
@pytest.mark.parametrize("target", [1, 3, 264])
def test_span_strip_merge_equals_tile_selection(n, k, k_tilde, order,
                                                target):
    m = 5
    scores = _scores(n + k, m, n, ties=order != "distinct",
                     ascending=order == "ascending")
    for valid in _masks(n, m, n):
        want = TR.tile_topk_ref(scores, valid, k, k_tilde)
        vals, ids = TR.span_strip_ref(scores, valid, k, k_tilde, target)
        got = TR.merge_strip(vals, ids, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        # and equal to a stable top-k of the valid scores (valid -inf
        # rows ahead of invalid ones)
        v = valid.expand(m, n)
        _, si = TR.stable_top_k(scores, n)
        second = torch.sort((~v.gather(1, si)).to(torch.int8), dim=1,
                            stable=True).indices
        si = si.gather(1, second)[:, :k]
        nv = v.sum(1, keepdim=True)
        slot = torch.arange(si.shape[1])[None, :]
        assert torch.equal(torch.where(slot < nv, si, -1).to(torch.int32),
                           got[1])


@pytest.mark.parametrize("n,k,k_tilde", [(6000, 10, 4), (2000, 100, 30),
                                         (1537, 9, 3)])
def test_span_strip_is_the_tile_strip_when_k_tilde_below_k(n, k, k_tilde):
    m = 4
    scores = _scores(n, m, n)
    valid = torch.from_numpy(np.random.default_rng(n).random(n) > 0.2)
    vals, ids = TR.span_strip_ref(scores, valid, k, k_tilde)
    n_tiles = -(-n // TILE)
    assert vals.shape == (m, n_tiles * k_tilde)
    for t in range(n_tiles):
        cols = torch.arange(t * TILE, min(n, (t + 1) * TILE))
        ok = valid[cols]
        s, i = TR.stable_top_k(
            torch.where(ok, scores[:, cols], float("-inf")), k_tilde)
        nv = int(ok.sum())
        sl = slice(t * k_tilde, (t + 1) * k_tilde)
        want_i = torch.where(torch.arange(s.shape[1]) < nv,
                             (cols[i]).to(torch.int32), TR.ID_SENTINEL)
        want_s = torch.where(torch.arange(s.shape[1]) < nv, s,
                             float("-inf"))
        assert torch.equal(ids[:, sl][:, :s.shape[1]], want_i)
        assert torch.equal(vals[:, sl][:, :s.shape[1]], want_s)
    assert torch.equal(TR.merge_strip(vals, ids, k)[1],
                       TR.tile_topk_ref(scores, valid, k, k_tilde)[1])


# -- the device routine, step by step ---------------------------------------

def _u64(keys: torch.Tensor) -> np.ndarray:
    return keys.numpy().view(np.uint64)


def _half_cleaners(c):
    """The log2(len) stages that sort a bitonic sequence ascending."""
    c = c.copy()
    st = len(c) // 2
    while st:
        idx = np.arange(len(c))
        lo = idx[(idx & st) == 0]
        a, b = c[lo].copy(), c[lo + st].copy()
        c[lo], c[lo + st] = np.minimum(a, b), np.maximum(a, b)
        st //= 2
    return c


def _merge_run(lst, run):
    """``merge_run`` of ``csrc/ash_select.cuh``: list[i] against
    run[LR - 1 - i], then half-cleaners: the LR smallest of both."""
    lr = len(lst)
    rev = np.full(lr, INVALID, np.uint64)
    m = min(lr, len(run))
    rev[lr - m:] = run[:m][::-1]
    out = _half_cleaners(np.minimum(lst, rev))
    want = np.sort(np.concatenate([lst, run]))[:lr]
    assert (out == want).all()
    return out


def _list_lanes(L):
    n = 1
    while 32 * n < L:
        n *= 2
    return n


def _warp_lists_model(chunks, L, n_warps):
    """Warps absorbing 256 keys at a time (``warp_absorb``): chunk c goes
    to warp c % n_warps; one bound, the smallest L-th key of the lists;
    survivors sorted as a run of 32, 64, 128 or 256 and merged.  Returns
    the pairwise tree merge of the lists and the survivor count."""
    lr = 32 * _list_lanes(L)
    lists = [np.full(lr, INVALID, np.uint64) for _ in range(n_warps)]
    bound, survivors = INVALID, 0
    for c, chunk in enumerate(chunks):
        assert len(chunk) <= 256
        run = np.sort(chunk[chunk < bound])
        if run.size == 0:
            continue
        survivors += run.size
        w = c % n_warps
        lists[w] = _merge_run(lists[w], run)
        bound = min(bound, lists[w][L - 1])
    h = 1
    while h < n_warps:
        for w in range(0, n_warps - h, 2 * h):
            lists[w] = _merge_run(lists[w], lists[w + h])
        h *= 2
    return lists[0][:L], survivors


def _keys(order, n, rng, valid_share=1.0):
    s = {"random": rng.standard_normal(n),
         "ascending": np.sort(rng.standard_normal(n)),
         "descending": -np.sort(rng.standard_normal(n)),
         "ties": rng.integers(-3, 4, n).astype(np.float64)}[order]
    ids = np.arange(n, dtype=np.int32)
    ids[rng.random(n) >= valid_share] = TR.ID_SENTINEL  # invalid rows
    return _u64(TR.make_keys(torch.from_numpy(s.astype(np.float32)),
                             torch.from_numpy(ids)))


@pytest.mark.parametrize("order", ["random", "ascending", "descending",
                                   "ties"])
@pytest.mark.parametrize("valid_share", [1.0, 0.05])
@pytest.mark.parametrize("L", [1, 10, 32, 33, 64, 65, 100, 128, 200, 256,
                               257, 512])
def test_device_routine_span_is_exact_top_l(order, valid_share, L):
    """A query of a span of 8 tiles: two warps, each taking one half of
    every tile, then the two lists merged."""
    rng = np.random.default_rng(L)
    keys = _keys(order, 8 * TILE, rng, valid_share)
    chunks = [keys[t:t + 256] for t in range(0, keys.size, 256)]
    got, survivors = _warp_lists_model(chunks, L, 2)
    assert (got == np.sort(keys)[:L]).all()
    if order == "ascending" and valid_share == 1.0:
        assert survivors == keys.size  # every key passed the bound
    if order == "random" and L == 100:
        assert survivors < keys.size // 4  # the bound does its work


@pytest.mark.parametrize("k", [1, 32, 100, 300, 512])
@pytest.mark.parametrize("order", ["random", "ascending"])
def test_device_routine_merge_is_exact_top_k(k, order):
    """The merge's settings: 16 warps, each taking 256 keys of every
    4096, over a strip of sorted span lists with exhausted (INVALID)
    slots."""
    rng = np.random.default_rng(k)
    n_spans, L = 40, min(k, 200)
    s = rng.standard_normal((n_spans, L)).astype(np.float32)
    if order == "ascending":
        s = np.sort(s.reshape(-1)).reshape(n_spans, L)
    ids = rng.permutation(n_spans * L * 3)[:n_spans * L].astype(np.int32)
    ids = ids.reshape(n_spans, L)
    ids[rng.random((n_spans, L)) < 0.1] = TR.ID_SENTINEL
    keys = np.sort(_u64(TR.make_keys(torch.from_numpy(s),
                                     torch.from_numpy(ids))), axis=1)
    strip = keys.reshape(-1)
    chunks = [strip[t:t + 256] for t in range(0, strip.size, 256)]
    got, _ = _warp_lists_model(chunks, k, 16)
    assert (got == np.sort(strip)[:k]).all()
    # and the plain merge of the decoded strip agrees
    vals, out = TR.merge_keys_ref(torch.from_numpy(strip.view(np.int64))[
        None], k)
    want_v, want_i = TR.keys_to_strip(torch.from_numpy(got.view(np.int64)))
    assert torch.equal(out[0], torch.where(want_i == TR.ID_SENTINEL, -1,
                                           want_i))
    assert torch.equal(vals[0], want_v)


# -- keys ------------------------------------------------------------------

def test_keys_order_and_round_trip():
    s = torch.tensor([3.0, -0.0, 0.0, float("-inf"), -2.0, 3.4e38, -1e-30,
                      3.0, 1e-42, float("inf")])
    i = torch.tensor([9, 1, 2, 3, 4, 5, 6, 0, 8, 7], dtype=torch.int32)
    keys = TR.make_keys(s, i)
    order = np.argsort(_u64(keys), kind="stable")
    # score desc (signed zeros equal), then id asc
    want = sorted(range(10), key=lambda j: (-float(s[j]), int(i[j])))
    assert order.tolist() == want
    vals, ids = TR.keys_to_strip(keys)
    assert torch.equal(ids, i)
    assert torch.equal(vals, torch.where(s == 0, 0.0, s))
    sent = TR.make_keys(torch.tensor([float("-inf")]),
                        torch.tensor([TR.ID_SENTINEL], dtype=torch.int32))
    assert int(sent) == -1
    v, d = TR.keys_to_strip(sent)
    assert torch.isneginf(v).all() and int(d) == TR.ID_SENTINEL


def test_merge_wrapper_cpu_path_is_merge_strip():
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.integers(-5, 5, (3, 400)).astype(np.float32))
    ids = torch.from_numpy(
        np.stack([rng.permutation(10**5)[:400] for _ in range(3)])
        .astype(np.int32))
    vals[:, 350:] = float("-inf")
    ids[:, 380:] = TR.ID_SENTINEL
    TK.reset_launch_counts()
    for k in (1, 50, 400):
        got = TK.ash_topk_merge_cuda(TR.make_keys(vals, ids), k, 400)
        want = TR.merge_strip(vals, ids, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert TK.launch_counts["ash_topk_merge"] == 0
