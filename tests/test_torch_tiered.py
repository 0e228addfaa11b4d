"""Port parity: the tiered IVF backend (``backend="tiered_ivf"``).

The tests of ``tests/test_tiered.py``, ported: at equal probe sets the
port's tiered backend returns EQUAL (``torch.equal``) scores and ids to
the port's ``backend="ivf"`` for every option (partial probes, rerank,
``coarse="int8"``, the covering full scan, an over-large nprobe, a
single query, ``use_kernel=False``) and every hot-set budget: zero bytes
(every probe pages), a small one (constant eviction) and a covering one
(everything resident after the first touch); paging counters; explicit
probe sets; save/load with a load-time budget; ``list_sizes``; add,
delete and compact scripts in lockstep with an IVF twin (fixed seeds
in place of the reference's hypothesis draws); the engine's tier
gauges, lifetime counters across mutations and the paging bill.

Added here: the port's tiered backend against the JAX package's at
equal probe sets, from the same model and payload (ids equal, scores
at the tolerance of ``tests/test_torch_ivf.py``: rtol 1e-5, atol 1e-5
times their scale) and saves loading both ways; the packed staging
buffer round-tripping every field and dtype at its alignment; and
``common.plan_paged_probe`` against the reference's, candidate for
candidate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro.index import common as JC  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.index import common as TC  # noqa: E402
from repro_torch.index import tiered as T  # noqa: E402
from repro_torch.index.api import IVFBackend  # noqa: E402
from repro_torch.index.tiered import TieredIVFBackend  # noqa: E402
from repro_torch.serving import EngineConfig, QueryEngine  # noqa: E402

METRICS = ("dot", "l2", "cos")
# zero = page every probe; small = constant eviction; huge = covering
BUDGETS = (0, 1 << 14, 1 << 30)
CHUNK = 16
N0 = 400
POOL = 1200


def _close(got, want):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(np.asarray(got)), np.isneginf(want))
    np.testing.assert_allclose(
        np.asarray(got, np.float64)[fin], want[fin], rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[fin]).max()))


def _assert_same(a, b, msg=None):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), msg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(17)
    D = 24
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.6
    X = (rng.standard_normal((POOL, D)) @ A.T + 0.3).astype(np.float32)
    Qm = (rng.standard_normal((6, D)) @ A.T + 0.3).astype(np.float32)
    cfg = JConfig(b=2, d=12, n_landmarks=8)
    ji = JIndex.build(jax.random.PRNGKey(17), jnp.asarray(X[:N0]), cfg,
                      keep_raw=True)
    path = tmp_path_factory.mktemp("tiered") / "flat"
    ji.save(path)
    model = AshIndex.load(path, device="cpu").model
    return X, torch.from_numpy(Qm), model, ji


def _build(setup, backend, metric, X_rows, **opts):
    X, Qm, model, _ = setup
    return AshIndex.build(
        torch.Generator(), torch.from_numpy(np.asarray(X_rows)), model.config,
        backend=backend, metric=metric, model=model, keep_raw=True,
        device="cpu", **opts)


SEARCH_KW = (
    {"nprobe": 3},
    {"nprobe": 3, "rerank": 20},
    {"nprobe": 4, "coarse": "int8", "shortlist": 64},
    {"nprobe": 4, "coarse": "int8"},
    {"nprobe": 3, "use_kernel": False},
    {"nprobe": 8},  # nprobe == nlist: the dense full-scan route
    {"nprobe": 99},  # over-asking clamps identically
)


@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_ivf_bitwise(setup, metric):
    """Every search option x every budget, batched and single-query."""
    X, Qm, model, _ = setup
    hbm = _build(setup, "ivf", metric, X[:N0])
    for hot in BUDGETS:
        tv = _build(setup, "tiered_ivf", metric, X[:N0], hot_bytes=hot)
        for kw in SEARCH_KW:
            _assert_same(tv.search(Qm, k=10, **kw),
                         hbm.search(Qm, k=10, **kw), f"hot={hot} kw={kw}")
            _assert_same(tv.search(Qm[:1], k=5, **kw),
                         hbm.search(Qm[:1], k=5, **kw),
                         f"m=1 hot={hot} kw={kw}")


def test_zero_budget_pages_every_probe(setup):
    """hot_bytes=0 serves correctly while caching nothing, with one
    transfer per search."""
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "l2", X[:N0], hot_bytes=0)
    hbm = _build(setup, "ivf", "l2", X[:N0])
    for i in range(3):
        _assert_same(tv.search(Qm, k=10, nprobe=3),
                     hbm.search(Qm, k=10, nprobe=3))
        assert tv._state.transfers == i + 1
    ts = TieredIVFBackend.tier_stats(tv._state)
    assert ts["hits"] == 0
    assert ts["resident_lists"] == 0
    assert ts["resident_bytes"] == 0
    assert ts["misses"] == ts["evictions"] > 0
    assert ts["paged_rows"] > 0 and ts["transfers"] == 3


def test_covering_budget_stops_paging(setup):
    """A covering budget pages each list once, then serves from the
    device-resident hot set."""
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "l2", X[:N0], hot_bytes=1 << 30)
    tv.search(Qm, k=10, nprobe=8)  # full scan touches every list
    before = TieredIVFBackend.tier_stats(tv._state)
    assert before["resident_lists"] == before["nlist"]
    assert before["transfers"] == 1
    assert before["paged_bytes"] == before["total_bytes"]
    for _ in range(3):
        tv.search(Qm, k=10, nprobe=3)
    after = TieredIVFBackend.tier_stats(tv._state)
    assert after["paged_rows"] == before["paged_rows"]
    assert after["transfers"] == before["transfers"]
    assert after["hits"] > before["hits"]
    assert after["evictions"] == 0


def test_search_probed_matches_ivf(setup):
    """Explicit probe sets (the budgeted-gather entry point) agree,
    including a single query."""
    X, Qm, model, _ = setup
    hbm = _build(setup, "ivf", "dot", X[:N0])
    tv = _build(setup, "tiered_ivf", "dot", X[:N0], hot_bytes=1 << 14)
    prep = hbm.prepare(Qm)
    probe = TieredIVFBackend.probe_sets(tv._state, prep, nprobe=3)
    np.testing.assert_array_equal(
        probe, IVFBackend.probe_sets(hbm._state, prep, nprobe=3))
    _assert_same(
        TieredIVFBackend.search_probed(tv._state, prep, probe, k=10),
        IVFBackend.search_probed(hbm._state, prep, probe, k=10))
    prep1 = hbm.prepare(Qm[:1])
    _assert_same(
        TieredIVFBackend.search_probed(tv._state, prep1, probe[:1], k=5),
        IVFBackend.search_probed(hbm._state, prep1, probe[:1], k=5))


def test_save_load_roundtrip(setup, tmp_path):
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "cos", X[:N0], hot_bytes=1 << 14)
    tv.add(torch.from_numpy(X[N0:N0 + CHUNK]))
    tv.delete(np.arange(10))
    tv.save(tmp_path / "t")
    back = AshIndex.load(tmp_path / "t", device="cpu")
    assert back.backend == "tiered_ivf"
    assert back._state.hot_bytes == 1 << 14
    _assert_same(back.search(Qm, k=10, nprobe=3, rerank=15),
                 tv.search(Qm, k=10, nprobe=3, rerank=15))
    # the budget is a load-time override, not baked into the arrays
    resized = AshIndex.load(tmp_path / "t", device="cpu", hot_bytes=0)
    assert resized._state.hot_bytes == 0
    _assert_same(resized.search(Qm, k=10, nprobe=3, rerank=15),
                 tv.search(Qm, k=10, nprobe=3, rerank=15))


def test_list_sizes_match_ivf(setup):
    """The engine's cost-model input agrees with the HBM backend's,
    before and after tombstones."""
    X, Qm, model, _ = setup
    hbm = _build(setup, "ivf", "dot", X[:N0])
    tv = _build(setup, "tiered_ivf", "dot", X[:N0])
    np.testing.assert_array_equal(TieredIVFBackend.list_sizes(tv._state),
                                  IVFBackend.list_sizes(hbm._state))
    hbm.delete(np.arange(30))
    tv.delete(np.arange(30))
    np.testing.assert_array_equal(TieredIVFBackend.list_sizes(tv._state),
                                  IVFBackend.list_sizes(hbm._state))


# (metric, hot_bytes, nprobe, rerank, seed): the reference draws these
# with hypothesis; fixed here
SCRIPTS = [
    ("dot", 0, 2, 0, 1), ("l2", 1 << 14, 8, 30, 2), ("cos", 1 << 30, 2, 30, 3),
    ("dot", 1 << 14, 2, 30, 4), ("l2", 0, 8, 0, 5), ("cos", 1 << 14, 2, 0, 6),
]


@pytest.mark.parametrize("metric,hot_bytes,nprobe,rerank,seed", SCRIPTS)
def test_tiered_tracks_ivf_under_mutations(setup, metric, hot_bytes, nprobe,
                                           rerank, seed):
    """Interleaved add/delete/compact scripts applied to a tiered index
    and an HBM IVF twin stay in lockstep at every probe depth and budget
    (compaction re-sorts rows between lists and drops the hot set)."""
    X, Qm, model, _ = setup
    rng = np.random.RandomState(seed)
    tv = _build(setup, "tiered_ivf", metric, X[:N0], hot_bytes=hot_bytes)
    hbm = _build(setup, "ivf", metric, X[:N0])
    kw = {"nprobe": nprobe, "rerank": rerank}
    live_ids = list(range(N0))
    next_id = N0
    for _ in range(6):
        op = rng.rand()
        if op < 0.35:
            rows = torch.from_numpy(X[rng.randint(0, POOL, CHUNK)])
            tv.add(rows)
            hbm.add(rows)
            live_ids.extend(range(next_id, next_id + CHUNK))
            next_id += CHUNK
        elif op < 0.65 and len(live_ids) > CHUNK + 8:
            victims = rng.choice(live_ids, size=CHUNK, replace=False)
            assert tv.delete(victims) == hbm.delete(victims) == CHUNK
            live_ids = [i for i in live_ids if i not in set(victims)]
        elif op < 0.8:
            tv.compact()
            hbm.compact()
        _assert_same(tv.search(Qm, k=10, **kw), hbm.search(Qm, k=10, **kw))
    assert tv.n_live == hbm.n_live == len(live_ids)
    _assert_same(tv.search(Qm, k=10, nprobe=8),
                 hbm.search(Qm, k=10, nprobe=8))


# -- serving engine integration -----------------------------------------


def test_engine_serves_tiered_bitwise_with_gauges(setup):
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "l2", X[:N0], hot_bytes=1 << 14)
    hbm = _build(setup, "ivf", "l2", X[:N0])
    s_d, i_d = hbm.search(Qm, k=10, nprobe=3)
    eng = QueryEngine(tv)
    tix = [eng.submit(Qm[i:i + 1].numpy(), k=10, nprobe=3)
           for i in range(Qm.shape[0])]
    eng.flush()
    for i, t in enumerate(tix):
        s, ids = t.result(timeout=60)
        assert torch.equal(ids[0], i_d[i]) and torch.equal(s[0], s_d[i])
    ts = eng.stats.snapshot()["tier"]["default"]
    for key in ("hits", "misses", "hit_rate", "evictions",
                "resident_lists", "resident_bytes", "hot_bytes",
                "total_bytes", "paged_rows", "paged_bytes", "transfers"):
        assert key in ts
    assert ts["hits"] + ts["misses"] > 0
    assert ts["total_bytes"] > ts["hot_bytes"]


def test_engine_mutations_keep_tier_counters(setup):
    """Mutation re-hosts must not reset the lifetime tier gauges."""
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "dot", X[:N0], hot_bytes=1 << 14)
    eng = QueryEngine(tv)
    t = eng.submit(Qm.numpy(), k=10, nprobe=3)
    eng.flush()
    t.result(timeout=60)
    before = eng.stats.snapshot()["tier"]["default"]
    tk = eng.submit_add(X[:CHUNK])
    eng.flush()
    tk.result(timeout=60)
    after = eng.stats.snapshot()["tier"]["default"]
    assert after["misses"] >= before["misses"]
    assert after["paged_rows"] >= before["paged_rows"]
    assert after["transfers"] >= before["transfers"] > 0


def test_engine_bills_cold_lists_at_page_cost(setup):
    """_billed_list_sizes surcharges non-resident lists so the row
    budget and adaptive nprobe see paging cost."""
    X, Qm, model, _ = setup
    tv = _build(setup, "tiered_ivf", "dot", X[:N0], hot_bytes=1 << 30)
    eng = QueryEngine(tv, row_budget=100_000, page_row_cost=2.0)
    live = eng._live_list_sizes("default", eng._indexes["default"])
    billed = eng._billed_list_sizes("default", eng._indexes["default"])
    np.testing.assert_array_equal(billed,
                                  np.ceil(live * 2.0).astype(np.int64))
    tv.search(Qm, k=10, nprobe=8)  # covering budget: all lists warm
    billed = eng._billed_list_sizes("default", eng._indexes["default"])
    np.testing.assert_array_equal(billed, live)
    hbm = _build(setup, "ivf", "dot", X[:N0])
    eng.register("h", hbm)
    np.testing.assert_array_equal(
        eng._billed_list_sizes("h", eng._indexes["h"]),
        eng._live_list_sizes("h", eng._indexes["h"]))


def test_engine_config_rejects_bad_page_cost():
    with pytest.raises(ValueError, match="page_row_cost"):
        EngineConfig(page_row_cost=0.5)


# -- against the JAX package, and the pieces ----------------------------


@pytest.mark.parametrize("metric", METRICS)
def test_tiered_matches_jax_and_cross_loads(setup, metric, tmp_path):
    X, Qm, model, ji = setup
    jt = JIndex.from_parts(ji.model, ji.payload, backend="tiered_ivf",
                           metric=metric, raw=ji._state.raw,
                           hot_bytes=1 << 14)
    jt.save(tmp_path / "jax")
    tt = AshIndex.load(tmp_path / "jax", device="cpu")
    assert tt.backend == "tiered_ivf" and tt._state.hot_bytes == 1 << 14
    Qj = jnp.asarray(Qm.numpy())
    jprep, tprep = jt.prepare(Qj), tt.prepare(Qm)
    probe = TieredIVFBackend.probe_sets(tt._state, tprep, 3)
    np.testing.assert_array_equal(
        probe, jt._backend.probe_sets(jt._state, jprep, 3))
    for kw in (dict(k=10), dict(k=10, rerank=20),
               dict(k=10, coarse="int8", shortlist=64)):
        js, jids = jt._backend.search_probed(jt._state, jprep, probe, **kw)
        ts, tids = TieredIVFBackend.search_probed(tt._state, tprep, probe,
                                                  **kw)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids), kw)
        _close(ts.numpy(), js)
    js, jids = jt.search(Qj, k=10, nprobe=8)
    ts, tids = tt.search(Qm, k=10, nprobe=8)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(ts.numpy(), js)
    tt.add(torch.from_numpy(X[N0:N0 + CHUNK]))
    tt.delete(np.arange(0, 40, 3))
    tt.save(tmp_path / "port")
    jback = JIndex.load(tmp_path / "port")
    assert jback.backend == "tiered_ivf" and jback.n == N0 + CHUNK
    assert jback.n_dead == tt.n_dead == 14
    js, jids = jback.search(Qj, k=10, nprobe=3, rerank=20)
    ts, tids = tt.search(Qm, k=10, nprobe=3, rerank=20)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(ts.numpy(), js)


def test_staging_buffer_round_trips_every_field():
    g = torch.Generator().manual_seed(0)
    blocks = [
        (torch.randint(-2**31, 2**31 - 1, (n, 3), generator=g,
                       dtype=torch.int32),
         torch.randn(n, generator=g).to(torch.float16),
         torch.randn(n, generator=g),
         torch.randint(0, 9, (n,), generator=g, dtype=torch.int32),
         torch.randn(n, 5, generator=g).to(torch.bfloat16),
         torch.rand(n, generator=g) > 0.5,
         torch.arange(n, dtype=torch.int64))
        for n in (7, 0, 1, 33)]
    buf, layout = T.pack_blocks(blocks, pin=False)
    assert buf.dtype == torch.uint8 and buf.dim() == 1
    assert all(o % T.ALIGN == 0 for entry in layout for o, _, _ in entry)
    ends = [o + int(np.prod(s)) * torch.empty((), dtype=d).element_size()
            for entry in layout for o, d, s in entry]
    starts = [o for entry in layout for o, _, _ in entry]
    assert all(e <= s for e, s in zip(ends, starts[1:]))  # no overlap
    assert buf.numel() >= ends[-1]
    back = T.unpack_blocks(buf, layout)
    for want, got in zip(blocks, back):
        for w, t in zip(want, got):
            assert t.dtype == w.dtype and t.shape == w.shape
            assert torch.equal(t, w)
            assert t.data_ptr() % T.ALIGN == 0 or t.numel() == 0


@pytest.mark.parametrize("with_live", (False, True))
def test_plan_paged_probe_matches_reference(with_live):
    rng = np.random.default_rng(5)
    nlist, max_len = 12, 9
    counts = rng.integers(0, max_len + 1, nlist).astype(np.int64)
    counts[rng.integers(0, nlist)] = max_len
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    n = int(counts.sum())
    live = rng.random(n) > 0.3 if with_live else None
    probe = np.stack([rng.permutation(nlist)[:4] for _ in range(7)])
    probe[3] = probe[2]  # duplicates across queries
    want = JC.plan_paged_probe(probe, counts, starts, live, max_len,
                               metric="dot", k=5)
    got = TC.plan_paged_probe(probe, counts, starts, live, max_len)
    assert got.union_lists == want.union_lists
    assert got.n_union == want.n_union
    np.testing.assert_array_equal(got.candidate_rows(),
                                  np.asarray(want.rows))
    # the union-local rows are the global ones shifted per list: the
    # candidate order of the HBM gathered table
    cand = got.candidate_rows()
    inv = np.where(np.arange(max_len)[None] < counts[:, None],
                   starts[:, None] + np.arange(max_len)[None], -1)
    glob = inv[probe].reshape(probe.shape[0], -1)
    if live is not None:
        glob = np.where(live[np.maximum(glob, 0)] & (glob >= 0), glob, -1)
    owner = np.repeat(probe, max_len, axis=1)
    np.testing.assert_array_equal(
        cand, np.where(glob >= 0, glob + got.delta[owner], -1))
