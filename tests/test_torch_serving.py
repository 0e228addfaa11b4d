"""Port parity: the serving layer (``repro_torch.serving``).

* **Row invariance** — a row's query prep and search results are
  bit-equal whether it is prepared and searched alone or inside an 8-,
  32- or 128-row batch, at D = 256, d = 128 (a width where a plain
  ``q @ W.T`` takes another summation order at m = 1 and m = 8 than
  inside a 128-row product), on every route.
* **Engine == direct search** — the port's engine returns, for every
  ticket, exactly (``torch.equal``) what ``AshIndex.search`` returns for
  its rows and arguments: flat and IVF, dot/l2/cos, rerank, coarse,
  mixed k in one bucket, mixed-k rerank groups, k above n.
* **Decisions equal the reference's** — the port's engine and the JAX
  engine over the same JAX-saved index and the same undriven request
  stream take the same batching decisions (fused calls, padded rows,
  buckets, flush reasons, effective nprobe, billed rows and the
  ``ivf_cost`` snapshot); ids equal, scores at the tolerance of
  ``tests/test_torch_ivf.py`` (rtol 1e-5, atol 1e-5 times their scale).
* The pieces it reads: ``ByteLRU`` against the reference's over one
  operation sequence; ``stage_add``/``apply_pending`` ids and a save
  holding staged rows in both directions; ``list_sizes`` and
  ``probe_sets`` on a saved IVF index with tombstones.

Inputs are drawn from fixed numpy seeds; nothing is a hypothesis draw.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro.serving.cache import ByteLRU as JByteLRU  # noqa: E402
from repro.serving.engine import QueryEngine as JEngine  # noqa: E402
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.device import ROW_BLOCK, row_blocked  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.index.api import IVFBackend  # noqa: E402
from repro_torch.serving import ByteLRU, QueryEngine  # noqa: E402
from repro_torch.models import sasrec as SR  # noqa: E402
from repro_torch.serving import retrieval  # noqa: E402

METRICS = ("dot", "l2", "cos")


def _close(got, want):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(np.asarray(got)), np.isneginf(want))
    np.testing.assert_allclose(
        np.asarray(got, np.float64)[fin], want[fin], rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[fin]).max()))


def _rows(rng, n, D, A):
    return (rng.standard_normal((n, D)) @ A.T + 0.3).astype(np.float32)


def _equal(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Row invariance of prepare and search (D = 256, d = 128)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(7)
    D = 256
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.5
    X = _rows(rng, 4096, D, A)
    Q = _rows(rng, 128, D, A)
    model = AshIndex.build(
        torch.Generator().manual_seed(0), torch.from_numpy(X),
        ASHConfig(b=2, d=128, n_landmarks=64), device="cpu", learned=False,
    ).model
    return X, Q, model


ALONE = ((1, 0), (1, 77), (8, 5), (32, 40))  # (rows, offset in the batch)


@pytest.mark.parametrize("metric", METRICS)
def test_rows_alone_equal_rows_in_a_batch(wide, metric):
    X, Q, model = wide
    flat = AshIndex.build(torch.Generator(), torch.from_numpy(X),
                          model.config, model=model, metric=metric,
                          device="cpu", keep_raw=True)
    ivf = AshIndex.from_parts(model, flat.payload, backend="ivf",
                              metric=metric, raw=flat._state.raw)
    Qt = torch.from_numpy(Q)
    batch = flat.prepare(Qt)
    for m, off in ALONE:
        alone = flat.prepare(Qt[off:off + m])  # a fresh prepare
        for f in ("q", "q_proj", "ip_q_landmarks", "q_sq_norm"):
            assert torch.equal(getattr(alone, f),
                               getattr(batch, f)[off:off + m]), (m, off, f)
    routes = (
        (flat, dict(k=10)), (flat, dict(k=100)),
        (flat, dict(k=10, rerank=64)), (flat, dict(k=10, coarse="int8")),
        (flat, dict(k=10, coarse="int8", rerank=64)),
        (ivf, dict(k=10, nprobe=8)), (ivf, dict(k=100, nprobe=8)),
        (ivf, dict(k=10, nprobe=8, rerank=64)),
        (ivf, dict(k=10, nprobe=8, coarse="int8")),
    )
    for idx, kw in routes:
        sb, ib = idx.search(Qt, **kw)
        for m, off in ALONE:
            s, i = idx.search(Qt[off:off + m], **kw)
            assert torch.equal(s, sb[off:off + m]), (kw, m, off)
            assert torch.equal(i, ib[off:off + m]), (kw, m, off)


SUBMISSIONS = (1, 8, 31, 1, 40)  # rows of each add: 81 staged in all


@pytest.mark.parametrize("backend", ("flat", "ivf"))
def test_staged_batch_encodes_as_rows_added_alone(wide, backend):
    """The engine ingests staged adds in one ``apply_pending``; a direct
    caller adds one submission at a time.  Both give the same payload
    rows, bit for bit, at D = 256, and so the same searches."""
    X, Q, model = wide
    base = torch.from_numpy(X[:1024])

    def index():
        return AshIndex.build(torch.Generator(), base, model.config,
                              model=model, backend=backend, device="cpu",
                              keep_raw=True)

    batched, serial = index(), index()
    o = 0
    for m in SUBMISSIONS:
        rows = Q[o:o + m]
        batched.stage_add(rows)
        serial.add(torch.from_numpy(rows))
        o += m
    assert batched.apply_pending() == o
    got, want = batched._state.payload, serial._state.payload
    for f in ("codes", "scale", "offset", "cluster"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(batched._state.raw, serial._state.raw)
    kw = dict(k=10, nprobe=8) if backend == "ivf" else dict(k=10)
    assert _equal(batched.search(torch.from_numpy(Q), **kw),
                  serial.search(torch.from_numpy(Q), **kw))


@pytest.mark.parametrize("m,block", ((1, ROW_BLOCK), (31, ROW_BLOCK),
                                     (32, ROW_BLOCK), (33, ROW_BLOCK),
                                     (64, ROW_BLOCK), (100, ROW_BLOCK),
                                     (100, 8), (5, 1024)))
def test_row_blocked_pads_only_the_last_block(m, block):
    """Every call sees ``block`` rows; full blocks are slices of the
    operand (no copy), the last partial block alone is zero-padded."""
    x = torch.arange(m * 3, dtype=torch.float32).reshape(m, 3) - 7.0
    seen = []

    def fn(b):
        seen.append((b.shape[0], b.data_ptr(), b[:, 0].clone()))
        return b * 2.0, b.sum(dim=-1)

    y, s = row_blocked(fn, x, block=block)
    assert torch.equal(y, x * 2.0) and torch.equal(s, x.sum(dim=-1))
    assert [r for r, _, _ in seen] == [block] * -(-m // block)
    full = m // block
    for j, (_, ptr, _) in enumerate(seen[:full]):
        assert ptr == x[j * block:].data_ptr()
    if m % block:
        tail = seen[-1][2]
        assert torch.equal(tail[:m % block], x[full * block:, 0])
        assert not tail[m % block:].any()


# ---------------------------------------------------------------------------
# ByteLRU against the reference's
# ---------------------------------------------------------------------------


def test_byte_lru_matches_reference():
    rng = np.random.default_rng(3)
    ours = ByteLRU(4000, max_entries=6)
    ref = JByteLRU(4000, max_entries=6)
    for step in range(300):
        op = rng.integers(0, 5)
        key = int(rng.integers(0, 12))
        if op <= 1:
            value = (np.zeros(int(rng.integers(1, 300)), np.float32),
                     np.zeros(int(rng.integers(0, 40)), np.int64))
            ours.put(key, value)
            ref.put(key, value)
        elif op == 2:
            assert (ours.get(key) is None) == (ref.get(key) is None)
        elif op == 3:
            assert (ours.pop(key) is None) == (ref.pop(key) is None)
        else:
            assert (ours.peek(key) is None) == (ref.peek(key) is None)
        assert list(ours.keys()) == list(ref.keys()), step
        assert ours.stats() == ref.stats(), step
    ours.clear()
    ref.clear()
    assert ours.stats() == ref.stats()
    # a zero-byte budget caches nothing
    empty = ByteLRU(0)
    empty.put("a", torch.zeros(4))
    assert len(empty) == 0 and empty.get("a") is None


# ---------------------------------------------------------------------------
# What the engine reads of an index: staged adds, epochs, IVF cost terms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(33)
    D = 48
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.7
    X = _rows(rng, 2000, D, A)
    X2 = _rows(rng, 300, D, A)
    Qm = _rows(rng, 24, D, A)
    cfg = JConfig(b=2, d=24, n_landmarks=16)
    model = JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg).model
    return X, X2, Qm, cfg, model


def _jax_index(data, backend, metric="dot"):
    X, _, _, cfg, model = data
    return JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg,
                        backend=backend, metric=metric, model=model,
                        keep_raw=True)


@pytest.mark.parametrize("backend", ("flat", "ivf"))
def test_staged_adds_match_reference_and_persist(data, backend, tmp_path):
    X, X2, Qm, _, _ = data
    ji = _jax_index(data, backend)
    ji.save(tmp_path / "base")
    ti = AshIndex.load(tmp_path / "base", device="cpu")
    ji.delete([3, 5])
    ti.delete([3, 5])
    assert ti.mutation_epoch == 1
    for block in (X2[:5], X2[5:8], X2[:0]):
        want = ji.stage_add(jnp.asarray(block))
        got = ti.stage_add(block)
        np.testing.assert_array_equal(got, want)
    assert ti.pending_rows == ji.pending_rows == 8
    assert ti.mutation_epoch == 1  # staging rewrites nothing

    # a port save holding staged rows loads into the reference
    ti.save(tmp_path / "port_pending")
    back_j = JIndex.load(tmp_path / "port_pending")
    assert back_j.pending_rows == 8
    # a reference save holding staged rows loads into the port
    ji.save(tmp_path / "jax_pending")
    back_t = AshIndex.load(tmp_path / "jax_pending", device="cpu")
    assert back_t.pending_rows == 8

    assert ti.apply_pending() == ji.apply_pending() == 8
    assert ti.mutation_epoch == 2 and ti.apply_pending() == 0
    assert back_t.apply_pending() == back_j.apply_pending() == 8
    for j, t in ((ji, ti), (back_j, back_t)):
        assert t.next_id == j.next_id == 2008
        kw = dict(k=10, nprobe=4) if backend == "ivf" else dict(k=10)
        js, jids = j.search(jnp.asarray(Qm), **kw)
        ts, tids = t.search(torch.from_numpy(Qm), **kw)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        _close(ts.numpy(), js)
    # a staged id can be deleted: delete applies the buffer first
    ids = ti.stage_add(X2[8:10])
    assert ti.delete(ids[:1]) == 1 and ti.pending_rows == 0
    ti.compact()
    assert ti.n_dead == 0 and ti.mutation_epoch == 5


def test_list_sizes_and_probe_sets_match_reference(data, tmp_path):
    _, _, Qm, _, _ = data
    ji = _jax_index(data, "ivf")
    ji.delete(np.arange(0, 600, 3))
    ji.save(tmp_path / "ivf")
    ti = AshIndex.load(tmp_path / "ivf", device="cpu")
    want = ji._backend.list_sizes(ji._state)
    got = IVFBackend.list_sizes(ti._state)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.sum() == ti.n_live
    jprep = ji.prepare(jnp.asarray(Qm))
    tprep = ti.prepare(torch.from_numpy(Qm))
    for nprobe in (1, 3, 16, 99):
        np.testing.assert_array_equal(
            IVFBackend.probe_sets(ti._state, tprep, nprobe),
            ji._backend.probe_sets(ji._state, jprep, nprobe))
    # search over an explicit probe set equals the search it came from
    probe = IVFBackend.probe_sets(ti._state, tprep, 4)
    assert _equal(IVFBackend.search_probed(ti._state, tprep, probe, k=10),
                  ti.search_prepped(tprep, k=10, nprobe=4))


# ---------------------------------------------------------------------------
# The port's engine against the port's direct search, every route
# ---------------------------------------------------------------------------


def _to_port(ji, path):
    ji.save(path)
    return AshIndex.load(path, device="cpu")


ROUTES = {
    "flat": (
        dict(k=3), dict(k=8), dict(k=12), dict(k=40),
        dict(k=5, rerank=30), dict(k=20, rerank=50),  # k pads past rerank
        dict(k=4, rerank=2), dict(k=7, rerank=2),  # rerank < k groups
        dict(k=5, coarse="int8"), dict(k=12, coarse="int8"),
        dict(k=40, coarse="int8"),  # refine depth above the default L
        dict(k=6, coarse="int8", shortlist=16),
        dict(k=5, coarse="int8", rerank=30),
    ),
    "ivf": (
        dict(k=3, nprobe=3), dict(k=12, nprobe=3), dict(k=8, nprobe=16),
        dict(k=5, nprobe=3, rerank=30), dict(k=4, nprobe=3, rerank=2),
        dict(k=5, nprobe=3, coarse="int8"),
        dict(k=12, nprobe=3, coarse="int8"),
        dict(k=5, nprobe=3, coarse="int8", rerank=30),
    ),
}


@pytest.mark.parametrize("metric", METRICS)
def test_engine_equals_direct_search(data, metric, tmp_path):
    _, _, Qm, _, _ = data
    flat = _to_port(_jax_index(data, "flat", metric), tmp_path / "flat")
    ivf = AshIndex.from_parts(flat.model, flat.payload, backend="ivf",
                              metric=metric, raw=flat._state.raw)
    indexes = {"flat": flat, "ivf": ivf}
    eng = QueryEngine(indexes, batch_buckets=(4, 16), k_buckets=(8, 32),
                      max_wait_s=60.0)
    Qt = torch.from_numpy(Qm)
    sizes = (1, 3, 2, 5)
    for rnd in range(2):  # round 2: new rows beside cached ones
        tickets = []
        for name, routes in ROUTES.items():
            for j, kw in enumerate(routes * 2):
                m = sizes[j % len(sizes)]
                off = (7 * j + 5 * rnd) % (Qm.shape[0] - m)
                # half the requests are numpy rows, half CPU tensors
                rows = Qm[off:off + m] if j % 2 else Qt[off:off + m]
                tickets.append((name, kw, off, m,
                                eng.submit(rows, index=name, **kw)))
        eng.flush()
        for name, kw, off, m, t in tickets:
            got = t.result()
            want = indexes[name].search(Qt[off:off + m], **kw)
            assert _equal(got, want), (name, kw, m, rnd)
    snap = eng.stats.snapshot()
    assert snap["prep_hits"] > 0 and snap["batches"] < snap["requests"]


def test_engine_k_above_n_pads_with_sentinels(data, tmp_path):
    X, _, Qm, cfg, model = data
    idx = _to_port(JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X[:30]),
                                cfg, model=model), tmp_path / "tiny")
    eng = QueryEngine(idx, batch_buckets=(4,), k_buckets=(8,),
                      max_wait_s=60.0)
    s, ids = eng.search(Qm[:2], k=50)
    assert s.shape == (2, 50) and ids.shape == (2, 50)
    assert (ids[:, 30:] == -1).all() and torch.isneginf(s[:, 30:]).all()
    assert _equal((s[:, :30], ids[:, :30]),
                  idx.search(torch.from_numpy(Qm[:2]), k=30))


def test_retrieval_serve_topk(data):
    X, _, Qm, _, _ = data
    idx = retrieval.build_index(torch.Generator().manual_seed(1),
                                torch.from_numpy(X[:500]), bits=2,
                                n_landmarks=8, learned=False, device="cpu")
    assert retrieval.engine_for(idx) is retrieval.engine_for(idx)
    for use_kernel in (True, False):
        got = retrieval.serve_topk(idx, Qm[:5], k=7, use_kernel=use_kernel)
        want = idx.search(torch.from_numpy(Qm[:5]), k=7,
                          use_kernel=use_kernel)
        assert _equal(got, want)
    # SASRec retrieval: the user states' search through the same engine
    cfg = SR.SASRecConfig(n_items=500, embed_dim=X.shape[1], seq_len=6,
                          n_neg=4)
    params = SR.init_params(torch.Generator().manual_seed(2), cfg,
                            device="cpu")
    seq = torch.randint(0, 500, (5, 6),
                        generator=torch.Generator().manual_seed(3))
    got = retrieval.sasrec_retrieve(params, seq, idx, cfg, k=7)
    with torch.no_grad():
        want = idx.search(SR.user_state(params, seq, cfg), k=7)
    assert _equal(got, want)
    with pytest.raises(ValueError, match="not the index"):
        retrieval.engine_for(idx).attach_durability(
            types.SimpleNamespace(index=None))


# ---------------------------------------------------------------------------
# The port's engine against the JAX engine: the same decisions
# ---------------------------------------------------------------------------


def _stream(Qm, seed):
    rng = np.random.RandomState(seed)
    out, i = [], 0
    while i < Qm.shape[0]:
        m = min(int(rng.choice([1, 1, 2, 4])), Qm.shape[0] - i)
        out.append((i, m, int(rng.choice([3, 10]))))
        i += m
    return out


def _decisions(engine, tickets):
    per_ticket = [(t.stats.batch_rows, t.stats.bucket_rows,
                   t.stats.flush_reason, t.stats.effective_nprobe,
                   t.stats.scanned_rows) for t in tickets]
    snap = engine.stats.snapshot()
    keys = ("requests", "batches", "rows", "bucket_fill", "prep_hits",
            "prep_misses", "flushes", "ivf_cost", "unique_buckets")
    return per_ticket, {k: snap[k] for k in keys}


@pytest.mark.parametrize("seed,budget", ((0, 800), (1, 1200)))
def test_engine_decisions_equal_reference(data, seed, budget, tmp_path):
    _, _, Qm, _, _ = data
    ji = _jax_index(data, "ivf")
    ji.delete(np.arange(0, 300, 2))
    ji.save(tmp_path / "ivf")
    ti = AshIndex.load(tmp_path / "ivf", device="cpu")
    kw = dict(batch_buckets=(4, 8), k_buckets=(10,), max_wait_s=60.0,
              row_budget=budget)
    engines = (JEngine(ji, **kw), QueryEngine(ti, **kw))
    Qs = np.concatenate([Qm, Qm[:6]])  # repeats hit the prep cache
    tickets = ([], [])
    for i, m, nprobe in _stream(Qs, seed):
        for eng, ts in zip(engines, tickets):
            ts.append(eng.submit(Qs[i:i + m], k=10, nprobe=nprobe))
    for eng in engines:
        eng.flush()
    want, got = (_decisions(e, t) for e, t in zip(engines, tickets))
    assert got == want
    assert want[1]["ivf_cost"]["splits"] > 0  # the budget did split
    assert want[1]["flushes"]["budget"] > 0
    for tj, tt in zip(*tickets):
        js, jids = tj.result()
        ts, tids = tt.result()
        np.testing.assert_array_equal(tids.numpy(), jids)
        _close(ts.numpy(), js)

    # the degraded rung: pressure 1.0 lands both on nprobe_min
    engines = tuple(cls(idx, batch_buckets=(4, 8), max_wait_s=60.0,
                        nprobe_min=2)
                    for cls, idx in ((JEngine, ji), (QueryEngine, ti)))
    tickets = tuple([e.submit(Qm[i:i + 1], k=10, nprobe=8)
                     for i in range(4)] for e in engines)
    for eng in engines:
        eng._flush_all("manual", pressure=1.0)
    want, got = (_decisions(e, t) for e, t in zip(engines, tickets))
    assert got == want and want[0][0][3] == 2


# ---------------------------------------------------------------------------
# Counterparts of test_cost_model.py's two identities
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cost_setup(data, tmp_path_factory):
    _, _, Qm, _, _ = data
    index = _to_port(_jax_index(data, "ivf"),
                     tmp_path_factory.mktemp("cost") / "ivf")
    return index, Qm


@pytest.mark.parametrize("nprobe", (2, 3, 4))
@pytest.mark.parametrize("seed", (0, 3, 7))
def test_pressure_off_identity(cost_setup, nprobe, seed):
    """Budget splits and budget-triggered flushes engaged, pressure
    off: every request equals the direct search bit for bit."""
    index, Qm = cost_setup
    engine = QueryEngine(index, batch_buckets=(4, 8), max_wait_s=60.0,
                         row_budget=400 * nprobe)  # about 3 queries' lists
    tickets = [(i, m, engine.submit(Qm[i:i + m], k=10, nprobe=nprobe))
               for i, m, _ in _stream(Qm, seed)]
    engine.flush()
    for i, m, t in tickets:
        assert _equal(t.result(), index.search(
            torch.from_numpy(Qm[i:i + m]), k=10, nprobe=nprobe))
        assert t.stats.effective_nprobe == nprobe  # never degraded
        assert t.stats.scanned_rows > 0  # but always billed
    assert engine.stats.flushes["budget"] > 0


def test_degraded_flush_is_exact_at_the_rung(cost_setup):
    """Pressure 1.0 lands on the nprobe_min rung; the degraded fused
    call equals the direct search at that rung exactly, and its top-10
    overlap with full fidelity stays above 0.3."""
    index, Qm = cost_setup
    engine = QueryEngine(index, batch_buckets=(4, 8), max_wait_s=60.0,
                         nprobe_min=2)
    tickets = [engine.submit(Qm[i:i + 1], k=10, nprobe=4) for i in range(4)]
    engine._flush_all("manual", pressure=1.0)
    overlaps = []
    for j, t in enumerate(tickets):
        q = torch.from_numpy(Qm[j:j + 1])
        got = t.result()
        assert _equal(got, index.search(q, k=10, nprobe=2))
        assert t.stats.effective_nprobe == 2
        full = index.search(q, k=10, nprobe=4)[1]
        overlaps.append(len(set(got[1][0].tolist())
                            & set(full[0].tolist())) / 10)
    assert np.mean(overlaps) >= 0.3
    snap = engine.stats.snapshot()
    assert snap["ivf_cost"]["degraded"] >= 1
    assert snap["ivf_cost"]["effective_nprobe"].get("2", 0) > 0
