"""Port parity: the sharded backend (``backend="sharded"``).

* **Sharded == flat, EQUAL** (``torch.equal`` on scores and ids) for 1-4
  shards on the CPU (``mesh=[cpu] * S``: several logical shards on one
  device, every per-shard code path but the copy between cards), every
  metric, k below and above the shard size (the fused and the
  materializing route), ``use_kernel=False``, a covering
  coarse shortlist, a padded last shard (n = 1000 over 3 shards pads 2
  rows), tombstones, add and compact, and a query alone against its
  row of the batch.
* **Coarse and exact rerank** run per shard, as the reference's: EQUAL
  to a merge computed without the backend, a flat coarse or rerank
  search over ``from_parts`` of each shard's rows alone (its raw rows,
  its tombstones), then a stable top-k of the union.  Rerank reranks a
  superset of flat's shortlist, so its exact score at every rank is at
  least flat's.
* **Against the JAX package's sharded backend** on its 4 virtual CPU
  devices, from the same model and payload: ids equal, scores at the
  tolerance of ``tests/test_torch_index.py`` (rtol 1e-5, atol 1e-5
  times their scale); indexes saved by either package load into the
  other with the same ids, rerank included.  The JAX package's own sharded-vs-flat
  equality fails at the last ulp (ROADMAP "JAX reference failures"), so
  the port's equality is proved here against the port's flat backend.
* The pieces: padding and row shards, the merge's order, rerank without
  raw rows raising, the engine's tickets EQUAL to direct search, and a
  port save/load bit-identical.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro_torch.core.types import ASHPayload  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.index import distributed as DX  # noqa: E402
from repro_torch.index import ivf as IV  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serving import QueryEngine  # noqa: E402

METRICS = ("dot", "l2", "cos")
CPU = torch.device("cpu")
N = 1000  # 3 shards pad 2 rows; 1, 2 and 4 divide


def _close(got, want):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(np.asarray(got)), np.isneginf(want))
    np.testing.assert_allclose(
        np.asarray(got, np.float64)[fin], want[fin], rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[fin]).max()))


def _equal(got, want, msg=""):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), msg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(44)
    D = 40
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.7
    X = (rng.standard_normal((N + 200, D)) @ A.T + 0.4).astype(np.float32)
    Qm = (rng.standard_normal((9, D)) @ A.T + 0.4).astype(np.float32)
    cfg = JConfig(b=2, d=20, n_landmarks=16)
    ji = JIndex.build(jax.random.PRNGKey(3), jnp.asarray(X[:N]), cfg,
                      keep_raw=True)
    path = tmp_path_factory.mktemp("sharded") / "flat"
    ji.save(path)
    return X, Qm, ji, path


def _flat(data, metric):
    X, Qm, ji, path = data
    flat = AshIndex.load(path, device="cpu")
    return AshIndex.from_parts(flat.model, flat.payload, metric=metric,
                               raw=flat._state.raw)


def _sharded(flat, S, **kw):
    return AshIndex.from_parts(flat.model, flat.payload, backend="sharded",
                               metric=flat.metric, raw=flat._state.raw,
                               mesh=[CPU] * S, **kw)


SEARCHES = (
    dict(k=10),
    dict(k=100),  # the fused route on every shard
    dict(k=300),  # above every shard of 4 (n_local 250) and the fused cap
    dict(k=10, use_kernel=False),
    dict(k=10, coarse="int8", shortlist=N),  # covering: equals coarse=None
)
RERANKS = (
    dict(k=10, rerank=64),
    dict(k=100, rerank=256),
    dict(k=10, rerank=64, use_kernel=False),
)


def _shard_merge(flat, S, Q, k, **kw):
    """Flat searches over each shard's rows alone (its raw rows and
    tombstones), merged by a stable top-k of the union: global rows =
    shard offset + local, then the flat index's ids."""
    st = flat._state
    pay = flat.payload
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
        v, i = one.search(Q, k=min(k, r1 - r0), **kw)
        vals.append(v)
        rows.append(torch.where(i < 0, -1, i + r0))
    v, i = torch.cat(vals, 1), torch.cat(rows, 1)
    # a stable sort by row, then by score: (score desc, row asc)
    o = torch.sort(torch.where(i < 0, 2**31 - 1, i), dim=1,
                   stable=True).indices
    v, i = v.gather(1, o), i.gather(1, o)
    o = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    v, i = v.gather(1, o), i.gather(1, o)
    if st.ids is not None:
        i = torch.where(i < 0, -1, st.ids[i.clamp(min=0).long()])
    return v, i


def _rerank_checks(got, flat, S, Q, kw, msg):
    """Sharded rerank: EQUAL to the per-shard merge, and an exact score
    at every rank at least flat's (a superset was reranked)."""
    _equal(got, _shard_merge(flat, S, Q, **kw), msg)
    want = flat.search(Q, **kw)
    assert torch.isfinite(want[0]).all()
    assert (got[0] >= want[0]).all(), msg


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("S", (1, 2, 3, 4))
def test_sharded_equals_flat(data, metric, S):
    X, Qm, _, _ = data
    flat = _flat(data, metric)
    sh = _sharded(flat, S)
    st = sh._state
    assert st.shards.n_local == -(-N // S)
    assert sum(st.shards.n_valid) == N
    Q = torch.from_numpy(Qm)
    for kw in SEARCHES:
        want = flat.search(Q, **kw)
        _equal(sh.search(Q, **kw), want, (S, kw))
        # a query alone equals its row of the batch
        _equal(sh.search(Q[4:5], **kw), tuple(t[4:5] for t in want),
               (S, kw, "alone"))
    for kw in RERANKS:
        got = sh.search(Q, **kw)
        _rerank_checks(got, flat, S, Q, kw, (S, kw))
        _equal(sh.search(Q[4:5], **kw), tuple(t[4:5] for t in got),
               (S, kw, "alone"))
    if S == 1:  # one shard is the flat backend
        for kw in RERANKS:
            _equal(sh.search(Q, **kw), flat.search(Q, **kw), kw)
    prep = sh.prepare(Q)
    _equal(sh.search_prepped(prep, k=10), flat.search_prepped(prep, k=10))


@pytest.mark.parametrize("S", (2, 3, 4))
def test_sharded_mutations_equal_flat(data, S):
    X, Qm, _, _ = data
    flat = _flat(data, "l2")
    sh = _sharded(flat, S)
    Q = torch.from_numpy(Qm)
    kws = (dict(k=10), dict(k=100), dict(k=10, use_kernel=False))
    rr = dict(k=10, rerank=64)
    victims = np.concatenate([np.arange(0, N, 97), [5, 999, 4242]])
    assert sh.delete(victims) == flat.delete(victims) == 13
    assert sh.n_dead == flat.n_dead == 13
    for kw in kws:
        _equal(sh.search(Q, **kw), flat.search(Q, **kw), ("deleted", kw))
    _rerank_checks(sh.search(Q, **rr), flat, S, Q, rr, "deleted")
    new = torch.from_numpy(X[N:N + 37])
    sh.add(new)
    flat.add(new)
    assert sh.next_id == flat.next_id == N + 37
    for kw in kws:
        _equal(sh.search(Q, **kw), flat.search(Q, **kw), ("added", kw))
    _rerank_checks(sh.search(Q, **rr), flat, S, Q, rr, "added")
    sh.compact()
    flat.compact()
    assert sh.n == flat.n == N + 37 - 13 and sh.n_dead == 0
    for kw in kws:
        _equal(sh.search(Q, **kw), flat.search(Q, **kw), ("compacted", kw))
    _rerank_checks(sh.search(Q, **rr), flat, S, Q, rr, "compacted")
    sh.add(new[:3])
    flat.add(new[:3])
    assert sh.next_id == flat.next_id == N + 40
    _equal(sh.search(Q, k=10), flat.search(Q, k=10))


@pytest.mark.parametrize("S", (1, 2, 3, 4))
def test_sharded_coarse_equals_per_shard_merge(data, S):
    _, Qm, _, _ = data
    Q = torch.from_numpy(Qm)
    for metric in ("dot", "l2"):
        flat = _flat(data, metric)
        sh = _sharded(flat, S)
        for kw in (dict(), dict(shortlist=64)):
            _equal(sh.search(Q, k=10, coarse="int8", **kw),
                   _shard_merge(flat, S, Q, 10, coarse="int8", **kw), (metric, S, kw))
        _equal(sh.search(Q, k=10, coarse="int8", use_kernel=False),
               _shard_merge(flat, S, Q, 10, coarse="int8", use_kernel=False))


def test_padding_shards_and_merge(data):
    flat = _flat(data, "dot")
    pay = ASHPayload(b=flat.payload.b, d=flat.payload.d, **{
        f: getattr(flat.payload, f)[:10] for f in ASHPayload.ARRAY_FIELDS})
    padded = DX.pad_to_multiple(pay, 4)
    assert padded.n == 12 and DX.pad_to_multiple(pay, 5) is pay
    assert padded.scale[10:].eq(0).all()
    assert padded.offset[10:].eq(torch.finfo(pay.offset.dtype).min).all()
    assert padded.cluster[10:].eq(DX.PAD_CLUSTER).all()
    with pytest.raises(ValueError, match="pad-sentinel"):
        IV._assemble("dot", flat.model, padded, torch.arange(12), None)
    shards = DX.shard_rows([CPU] * 4, padded)
    assert [s.n for s in shards] == [3] * 4
    assert torch.equal(torch.cat([s.codes for s in shards]), padded.codes)
    shards = DX.ShardSet([CPU] * 4, flat.model, padded)
    assert shards.n_valid == [3, 3, 3, 1] and shards.n_local == 3
    assert [p.n for p in shards.payloads] == [3, 3, 3, 1]
    assert int(shards.payloads[3].cluster.min()) >= 0  # no sentinel scanned
    five = DX.pad_to_multiple(ASHPayload(b=pay.b, d=pay.d, **{
        f: getattr(pay, f)[:5] for f in ASHPayload.ARRAY_FIELDS}), 4)
    assert DX.ShardSet([CPU] * 4, flat.model, five).n_valid == [2, 2, 1, 0]
    with pytest.raises(ValueError, match="equal shards"):
        DX.shard_rows([CPU] * 3, pay)
    # the merge: (score desc, id asc) over runs, -inf slots to -1
    ninf = float("-inf")
    parts = [(torch.tensor([[3.0, 1.0, ninf]]), torch.tensor([[2, 7, -1]])),
             (torch.tensor([[3.0, 2.0, 1.0]]), torch.tensor([[1, 9, 4]])),
             (torch.tensor([[5.0]]), torch.tensor([[12]]))]
    s, i = DX.merge_shards(parts, 5, CPU)
    assert s.tolist() == [[5.0, 3.0, 3.0, 2.0, 1.0]]
    assert i.tolist() == [[12, 1, 2, 9, 4]]
    s, i = DX.merge_shards(parts[:1], 3, CPU)
    assert s.tolist() == [[3.0, 1.0, ninf]] and i.tolist() == [[2, 7, -1]]
    # the card's merge takes the same keys: one sorted run per shard
    vals = torch.tensor([[3.0, 1.0, ninf, 3.0, 2.0, 1.0]])
    ids = torch.tensor([[2, 7, ref.ID_SENTINEL, 1, 9, 4]], dtype=torch.int32)
    for run in ref.make_keys(vals, ids).reshape(2, 3).tolist():
        unsigned = [x % (1 << 64) for x in run]
        assert unsigned == sorted(unsigned)


def test_rerank_without_raw_raises(data):
    flat = _flat(data, "dot")
    sh = AshIndex.from_parts(flat.model, flat.payload, backend="sharded",
                             mesh=[CPU] * 2)
    with pytest.raises(ValueError, match="keep_raw"):
        sh.search(torch.from_numpy(data[1]), k=5, rerank=20)
    assert sh.search(torch.from_numpy(data[1]), k=5)[1].shape == (9, 5)


def _jax_sharded(ji, metric):
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    return JIndex.from_parts(ji.model, ji.payload, backend="sharded",
                             metric=metric, raw=ji._state.raw, mesh=mesh,
                             axes=("data",))


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_matches_jax_and_cross_loads(data, metric, tmp_path):
    if jax.device_count() < 4:
        pytest.skip("needs the 4 virtual CPU devices of tests/conftest.py")
    X, Qm, ji, _ = data
    js = _jax_sharded(ji, metric)
    ts = _sharded(_flat(data, metric), 4)
    for kw in (dict(k=10), dict(k=100), dict(k=300), dict(k=10, rerank=64)):
        jsc, jids = js.search(jnp.asarray(Qm), **kw)
        tsc, tids = ts.search(torch.from_numpy(Qm), **kw)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids), kw)
        _close(tsc.numpy(), jsc)
    js.delete(np.arange(0, N, 50))
    js.save(tmp_path / "jax")
    back = AshIndex.load(tmp_path / "jax", device="cpu", mesh=[CPU] * 4)
    assert back.backend == "sharded" and back._state.axes == ("data",)
    assert back.n_dead == js.n_dead == 20
    jsc, jids = js.search(jnp.asarray(Qm), k=10)
    tsc, tids = back.search(torch.from_numpy(Qm), k=10)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tsc.numpy(), jsc)
    ts.add(torch.from_numpy(X[N:N + 20]))
    ts.delete([3, 7])
    ts.save(tmp_path / "port")
    jback = JIndex.load(tmp_path / "port")
    assert jback.backend == "sharded" and jback.n == N + 20
    jsc, jids = jback.search(jnp.asarray(Qm), k=10)
    tsc, tids = ts.search(torch.from_numpy(Qm), k=10)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(tsc.numpy(), jsc)


def test_port_save_load_bit_identical(data, tmp_path):
    _, Qm, _, _ = data
    flat = _flat(data, "cos")
    sh = _sharded(flat, 3)
    sh.delete([1, 2, 3])
    flat.delete([1, 2, 3])
    sh.save(tmp_path / "s")
    meta = json.loads((tmp_path / "s" / "config.json").read_text())
    assert meta["backend"] == "sharded"
    assert meta["backend_meta"]["axes"] == ["data"]
    for mesh in (None, [CPU] * 3, [CPU] * 2):
        back = AshIndex.load(tmp_path / "s", device="cpu", mesh=mesh)
        assert len(back._state.devices) == (1 if mesh is None else len(mesh))
        Q = torch.from_numpy(Qm)
        _equal(back.search(Q, k=10), sh.search(Q, k=10), mesh)
        # rerank runs per shard: the loaded placement's own merge
        S = len(back._state.devices)
        _equal(back.search(Q, k=10, rerank=50),
               _shard_merge(flat, S, Q, k=10, rerank=50), mesh)


def test_engine_tickets_equal_direct(data):
    _, Qm, _, _ = data
    sh = _sharded(_flat(data, "l2"), 3)
    twin = _sharded(_flat(data, "l2"), 3)  # never mutated
    eng = QueryEngine(sh, batch_buckets=(4, 16), k_buckets=(8, 32),
                      max_wait_s=60.0)
    Q = torch.from_numpy(Qm)
    routes = (dict(k=5), dict(k=12), dict(k=40), dict(k=5, rerank=30),
              dict(k=6, coarse="int8"), dict(k=3, use_kernel=False))
    tickets = []
    for j, kw in enumerate(routes * 3):
        m = (1, 3, 2)[j % 3]
        off = (5 * j) % (Qm.shape[0] - m)
        tickets.append((kw, off, m, eng.submit(Qm[off:off + m], **kw)))
    tk = eng.submit_delete([int(i) for i in range(0, 60, 7)])
    tickets.append((dict(k=10), 0, 4, eng.submit(Qm[:4], k=10)))
    eng.flush()
    tk.result(timeout=60)
    for kw, off, m, t in tickets[:-1]:
        _equal(t.result(), twin.search(Q[off:off + m], **kw), kw)
    _equal(tickets[-1][3].result(), sh.search(Q[:4], k=10))
    snap = eng.stats.snapshot()
    assert snap["batches"] < snap["requests"] and "tier" not in snap
