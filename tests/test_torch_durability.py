"""The port's durability: mutation WAL, atomic checkpoints, crash
recovery at every fault point, and background-thread supervision —
``tests/test_durability.py`` ported, plus the log's bytes and the
durability directory held against the JAX package both ways.

The core property, as in the reference: kill the process state at
EVERY registered fault point during a deterministic mutation script,
recover with ``DurableIndex.open`` (newest valid checkpoint + torn-tail
truncation + idempotent WAL replay), and every search of the recovered
index must EQUAL (scores and ids) a serial replay of the durable
mutation prefix on the same model — one ``stage_add`` +
``apply_pending`` or ``delete`` a mutation — with every *acknowledged*
mutation inside that prefix.  On the flat, IVF, sharded (2 CPU shards)
and tiered IVF (a 1 KiB hot set) backends.

Across packages: the same records give identical bytes; a segment
written by either package reads back in the other into equal records
and is cut at the same byte when torn or bit-flipped; a durability
directory crashed by either package's engine recovers in the other,
with equal ids and scores within rtol 1e-5 / atol 1e-5 times their
scale (fp32 reduction order, as ``test_torch_index.py``'s cross-load
tests).  Inputs come from fixed seeds.
"""
import json
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.data.synthetic import embedding_dataset  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro.serving import DurableIndex as JDurable  # noqa: E402
from repro.serving import QueryEngine as JEngine  # noqa: E402
from repro.serving import wal as JW  # noqa: E402
from repro.testing import faults as jfaults  # noqa: E402
from repro_torch.core.types import ASHConfig, ASHModel  # noqa: E402
from repro_torch.index import AshIndex, CorruptIndexError  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BackgroundCompactor, DurableIndex, QueryEngine, ServingFrontend,
    WriteAheadLog,
)
from repro_torch.serving import wal as W  # noqa: E402
from repro_torch.serving.frontend import FrontendClosed  # noqa: E402
from repro_torch.serving.wal import (  # noqa: E402
    KIND_ADD, KIND_DELETE, KIND_MARKER, read_log,
)
from repro_torch.testing import faults  # noqa: E402

DIM = 16
N0 = 48  # initial build size
POOL = 240  # vector pool adds draw from
CHUNK = 8  # rows per add batch
BACKENDS = ("flat", "ivf", "sharded", "tiered_ivf")
CPU = torch.device("cpu")
HOT_BYTES = 1024  # a few of the 8 lists fit
BUILD_OPTS = {
    "flat": {}, "ivf": {}, "sharded": {"mesh": [CPU, CPU]},
    "tiered_ivf": {"hot_bytes": HOT_BYTES},
}
LOAD_OPTS = {name: {"device": "cpu", **opts}
             for name, opts in BUILD_OPTS.items()}


@pytest.fixture(scope="module")
def setup():
    """The reference's data and model (``test_durability.py``), the
    model converted once for the port."""
    kx, kq, kb = jax.random.split(jax.random.PRNGKey(7), 3)
    X = np.asarray(embedding_dataset(kx, POOL, DIM))
    Qm = np.asarray(embedding_dataset(kq, 4, DIM))
    jcfg = JConfig(b=2, d=8, n_landmarks=8)
    jmodel = JIndex.build(kb, jnp.asarray(X[:N0]), jcfg).model
    model = ASHModel.from_numpy(
        ASHConfig(b=2, d=8, n_landmarks=8),
        {f: np.asarray(getattr(jmodel, f)) for f in ASHModel.ARRAY_FIELDS},
        device="cpu")
    return X, Qm, model, jcfg, jmodel, kb


def _build(setup, backend, rows):
    X, Qm, model = setup[:3]
    return AshIndex.build(
        torch.Generator(), torch.from_numpy(np.array(rows)), model.config,
        model=model, backend=backend, metric="dot", device="cpu",
        keep_raw=True, **BUILD_OPTS[backend])


def _search_kw(backend):
    kw = {"rerank": 0}
    if backend in ("ivf", "tiered_ivf"):
        kw["nprobe"] = 2  # partial probe: the gathered path
    return kw


def _assert_same_search(setup, a, b, backend="flat"):
    Qm = torch.from_numpy(setup[1])
    for extra in ({}, {"rerank": 16}):
        kw = {**_search_kw(backend), **extra}
        sa, ia = a.search(Qm, k=10, **kw)
        sb, ib = b.search(Qm, k=10, **kw)
        assert torch.equal(sa, sb) and torch.equal(ia, ib), kw


def _serial_replay(setup, backend, muts):
    """The durable prefix applied one mutation at a time to a fresh
    build of the first N0 rows."""
    X = setup[0]
    idx = _build(setup, backend, X[:N0])
    for kind, payload in muts:
        if kind == "add":
            idx.stage_add(X[payload])
            idx.apply_pending()
        else:
            idx.delete(payload)
    return idx


def _wait_until(pred, timeout=10.0, interval=0.002):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ---------------------------------------------------------------------
# fault-point registry: the reference's 11 points, each driven by the
# crash matrix below
# ---------------------------------------------------------------------

EXPECTED_POINTS = {
    "wal.append", "wal.fsync", "wal.rotate",
    "engine.apply", "engine.apply.logged", "engine.apply.applied",
    "ckpt.begin", "ckpt.gc",
    "save.replace", "save.between_replace",
    "compactor.swap",
}


def test_every_fault_point_is_registered():
    assert {p.name for p in faults.points()} == EXPECTED_POINTS
    assert {p.name for p in jfaults.points()} == EXPECTED_POINTS
    assert [p.name for p in faults.points() if p.torn] == ["wal.append"]


def _crash_cases():
    cases = []
    for name in sorted(EXPECTED_POINTS):
        cases.append((name, faults.Crash(at=1)))
        if name.startswith(("wal.", "engine.")):
            # later hits land mid-traffic, after acknowledged work
            cases.append((name, faults.Crash(at=3)))
    cases.append(("wal.append", faults.Torn(at=2, fraction=0.3)))
    cases.append(("wal.append", faults.Torn(at=4, fraction=0.8)))
    return cases


def _drive(durable, eng, X, fault_mod, plan, steps=8, seed=1234):
    """Drive a deterministic mutation script through an undriven engine
    with durability attached, under ``plan`` (armed on ``fault_mod``,
    either package's registry).  Returns (muts, acked, crashed): the
    submission-order mutation list, the tickets that RESOLVED before
    the crash, and whether the plan fired."""
    rng = np.random.RandomState(seed)
    muts = []  # ("add", pool_rows) | ("del", ids), submission order
    acked = []  # (mutation position 0-based, ticket)
    crashed = False
    try:
        with fault_mod.active(plan):
            for step in range(steps):
                if step == steps // 2:
                    # a mid-traffic checkpoint exercises the ckpt/save
                    # points while acknowledged records exist on both
                    # sides of it
                    durable.checkpoint(barrier=eng.mutation_barrier())
                total_ids = N0 + CHUNK * sum(
                    1 for k, _ in muts if k == "add")
                if rng.rand() < 0.55:
                    pool_rows = rng.randint(0, POOL, CHUNK)
                    muts.append(("add", pool_rows))
                    t = eng.submit_add(X[pool_rows])
                else:
                    victims = rng.randint(0, total_ids, CHUNK // 2)
                    muts.append(("del", victims))
                    t = eng.submit_delete(victims)
                t.result()  # undriven: applies (and WAL-logs) now
                acked.append((len(muts) - 1, t))
    except fault_mod.SimulatedCrash:
        crashed = True
    # the "process" is dead: abandon every in-memory object (appends
    # flush, so the files already hold what they will ever hold)
    try:
        durable.wal.close()
    except Exception:
        pass
    return muts, acked, crashed


def _run_traffic_until_crash(setup, root, backend, plan, steps=8):
    X = setup[0]
    idx = _build(setup, backend, X[:N0])
    dur = DurableIndex.create(idx, root, fsync="always")
    eng = QueryEngine(idx)
    eng.attach_durability(dur)
    return _drive(dur, eng, X, faults, plan, steps)


def _check_durable_prefix(muts, acked, crashed, report):
    if not crashed:
        # the plan never fired on this script (a compactor-only point,
        # an over-save point): clean shutdown, everything is durable
        assert report.last_seqno == len(muts)
    # no checkpoint/marker traffic in this script consumes seqnos, so
    # mutation i (0-based) was logged under seqno i+1 and the durable
    # set is exactly the first last_seqno mutations
    durable_n = report.last_seqno
    assert 0 <= durable_n <= len(muts)
    for pos, ticket in acked:
        assert ticket.wal_seqno == pos + 1
        assert ticket.wal_seqno <= durable_n, (
            f"acknowledged mutation {pos} (seqno {ticket.wal_seqno}) "
            f"lost: durable prefix ends at {durable_n}")
    return durable_n


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "point,action", _crash_cases(),
    ids=lambda v: v if isinstance(v, str) else
    f"{type(v).__name__}@{v.at}",
)
def test_crash_recovery_at_every_point(setup, tmp_path, backend, point,
                                       action):
    """Kill the process state at ``point``; the recovered index must
    EQUAL the serial replay of the durable prefix, and every
    acknowledged mutation must be inside that prefix."""
    muts, acked, crashed = _run_traffic_until_crash(
        setup, tmp_path / "dur", backend, {point: action})
    rec = DurableIndex.open(tmp_path / "dur", fsync="always",
                            index_opts=LOAD_OPTS[backend])
    assert rec.index.backend == backend
    durable_n = _check_durable_prefix(muts, acked, crashed, rec.report)
    _assert_same_search(setup, rec.index,
                        _serial_replay(setup, backend, muts[:durable_n]),
                        backend)
    rec.close()


@pytest.mark.parametrize("backend", BACKENDS)
def test_recovery_is_idempotent(setup, tmp_path, backend):
    """open() twice (the second time after a checkpoint and a clean
    close with no new traffic) replays nothing new and serves
    identically."""
    muts, acked, crashed = _run_traffic_until_crash(
        setup, tmp_path / "dur", backend,
        {"engine.apply.logged": faults.Crash(at=4)})
    assert crashed
    rec1 = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS[backend])
    rec1.checkpoint()
    rec1.close()
    rec2 = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS[backend])
    assert rec2.report.replayed_adds == 0
    assert rec2.report.replayed_deletes == 0
    _assert_same_search(setup, rec1.index, rec2.index, backend)
    rec2.close()


# ---------------------------------------------------------------------
# a checkpoint is the state at its barrier, whatever applies during its
# save: no mutation writes a state's tensors in place
# ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_excludes_batch_applied_during_its_save(
    setup, tmp_path, backend
):
    X = setup[0]
    idx = _build(setup, backend, X[:N0])
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="off")
    eng = QueryEngine(idx)
    eng.attach_durability(dur)
    eng.submit_delete([0, 1, 2]).result()  # tombstones the ckpt holds
    twin = _serial_replay(setup, backend, [("del", [0, 1, 2])])
    seq = []
    with faults.active({"ckpt.begin": faults.Delay(at=1, seconds=0.5)}):
        th = threading.Thread(target=lambda: seq.append(
            dur.checkpoint(barrier=eng.mutation_barrier())))
        th.start()
        # ckpt.begin fires after the snapshot, before the save
        assert _wait_until(lambda: faults.hits("ckpt.begin") == 1)
        # a delete alone first: it rewrites the snapshot's own bitmap
        # unless deletes build a new one
        assert eng.submit_delete([3, 4]).result() == 2
        eng.submit_add(X[100:100 + CHUNK]).result()
        assert eng.submit_delete([N0 + 1]).result() == 1
        assert th.is_alive(), "the batches must apply while the save waits"
        th.join(30.0)
    assert seq == [1]  # the delete of [0, 1, 2]
    ckpt = AshIndex.load(tmp_path / "dur" / f"ckpt-{seq[0]:020d}",
                         **LOAD_OPTS[backend])
    assert (ckpt.n, ckpt.n_dead, ckpt.pending_rows) == (N0, 3, 0)
    assert ckpt.next_id == N0
    _assert_same_search(setup, ckpt, twin, backend)
    assert (idx.n, idx.n_dead) == (N0 + CHUNK, 6)  # the live index did
    dur.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS[backend])
    assert (rec.report.checkpoint_seqno, rec.report.replayed_adds,
            rec.report.replayed_deletes) == (1, 1, 2)
    _assert_same_search(setup, rec.index, idx, backend)
    rec.close()


# ---------------------------------------------------------------------
# WAL unit behaviour
# ---------------------------------------------------------------------

def test_wal_roundtrip_and_fsync_policies(tmp_path):
    rows = np.arange(12, dtype=np.float32).reshape(3, 4)
    wal = WriteAheadLog(tmp_path / "w", fsync="always")
    assert wal.append_add(rows, [5, 6, 7]) == 1
    assert wal.append_delete([6]) == 2
    assert wal.append_marker("compact") == 3
    assert wal.stats()["fsyncs"] == 3
    wal.close()
    recs, torn = read_log(tmp_path / "w")
    assert torn == 0
    assert [r.seqno for r in recs] == [1, 2, 3]
    assert [r.kind for r in recs] == [KIND_ADD, KIND_DELETE, KIND_MARKER]
    np.testing.assert_array_equal(recs[0].rows, rows)
    np.testing.assert_array_equal(recs[0].ids, [5, 6, 7])
    np.testing.assert_array_equal(recs[1].ids, [6])
    assert recs[2].text == "compact"

    woff = WriteAheadLog(tmp_path / "w2", fsync="off")
    woff.append_delete([1])
    assert woff.stats()["fsyncs"] == 0
    woff.close()

    wint = WriteAheadLog(tmp_path / "w3", fsync="interval",
                         fsync_interval_s=3600.0)
    wint.append_delete([1])
    wint.append_delete([2])
    assert wint.stats()["fsyncs"] == 0  # inside the interval
    wint.fsync_interval_s = 0.0
    wint.append_delete([3])
    assert wint.stats()["fsyncs"] == 1
    wint.close()
    assert [r.seqno for r in read_log(tmp_path / "w3")[0]] == [1, 2, 3]
    with pytest.raises(ValueError, match="fsync"):
        WriteAheadLog(tmp_path / "w4", fsync="sometimes")


def test_wal_torn_tail_detected_and_truncated(tmp_path):
    wal = WriteAheadLog(tmp_path / "w", fsync="off")
    for i in range(3):
        wal.append_delete([i])
    seg = wal.segments()[0]
    wal.sync()
    good_len = seg.stat().st_size
    wal.append_delete([3])
    wal.close()
    full_len = seg.stat().st_size
    # tear the 4th record in half, as a mid-write crash would
    cut = good_len + (full_len - good_len) // 2
    with open(seg, "r+b") as f:
        f.truncate(cut)
    recs, torn = read_log(tmp_path / "w", truncate=True)
    assert [r.seqno for r in recs] == [1, 2, 3]
    assert torn == cut - good_len
    assert seg.stat().st_size == good_len  # tail cut off on disk
    recs2, torn2 = read_log(tmp_path / "w")
    assert torn2 == 0 and len(recs2) == 3


def test_wal_bitflip_ends_durable_prefix(tmp_path):
    wal = WriteAheadLog(tmp_path / "w", fsync="off")
    for i in range(4):
        wal.append_delete([10 + i])
    seg = wal.segments()[0]
    wal.close()
    data = bytearray(seg.read_bytes())
    data[len(data) // 2] ^= 0xFF  # flip a bit mid-log
    seg.write_bytes(bytes(data))
    recs, torn = read_log(tmp_path / "w")
    assert torn > 0
    assert [r.seqno for r in recs] == list(range(1, len(recs) + 1))


def test_wal_rotation_and_segment_gc(tmp_path):
    wal = WriteAheadLog(tmp_path / "w", fsync="off")
    wal.append_delete([1])
    wal.append_delete([2])
    wal.rotate()
    wal.append_delete([3])
    assert len(wal.segments()) == 2
    assert wal.drop_segments_through(2) == 1
    recs, _ = read_log(tmp_path / "w")
    assert [r.seqno for r in recs] == [3]
    wal.close()


def test_wal_delay_fault_is_benign(tmp_path):
    wal = WriteAheadLog(tmp_path / "w", fsync="off")
    with faults.active({"wal.append": faults.Delay(at=1, seconds=0.01)}):
        t0 = time.perf_counter()
        wal.append_delete([1])
        assert time.perf_counter() - t0 >= 0.01
    recs, torn = read_log(tmp_path / "w")
    assert len(recs) == 1 and torn == 0
    wal.close()


def test_wal_error_requeues_batch_and_retries(setup, tmp_path):
    """An ordinary WAL failure (disk full, EIO) must neither resolve
    nor lose the batch: tickets stay pending, the batch requeues, and
    the retry logs exactly once (no duplicate records)."""
    X = setup[0]
    idx = _build(setup, "flat", X[:N0])
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="always")
    eng = QueryEngine(idx)
    eng.attach_durability(dur)
    with faults.active({"wal.append": faults.Error(at=1)}):
        t = eng.submit_add(X[:CHUNK])
        with pytest.raises(TimeoutError):
            t.result(timeout=0.1)
        assert eng.stats.wal_failures == 1
        assert "InjectedError" in eng.stats.wal_last_error
        snap = eng.stats.snapshot()
        assert snap["durability"]["wal_failures"] == 1
    ids = t.result()  # retry path: logs then applies
    np.testing.assert_array_equal(ids, np.arange(N0, N0 + CHUNK))
    assert t.wal_seqno == 1
    recs, _ = read_log(tmp_path / "dur" / "wal")
    assert [r.kind for r in recs] == [KIND_ADD]
    np.testing.assert_array_equal(recs[0].rows, X[:CHUNK])
    dur.close()


def test_failed_apply_after_logging_fails_ticket_but_replays(setup,
                                                             tmp_path):
    """An apply that fails after its records are logged fails the
    tickets, yet the records stay in the log and recovery replays them
    (the reference's order: log, fire ``engine.apply.logged``, apply)."""
    X = setup[0]
    idx = _build(setup, "flat", X[:N0])
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="always")
    eng = QueryEngine(idx)
    eng.attach_durability(dur)
    real_apply = idx.apply_pending

    def failing_apply():
        raise RuntimeError("device lost")

    idx.apply_pending = failing_apply
    t = eng.submit_add(X[:CHUNK])
    with pytest.raises(RuntimeError):
        t.result()
    assert t.wal_seqno == 1 and isinstance(t.error, RuntimeError)
    idx.apply_pending = real_apply
    dur.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS["flat"])
    assert rec.report.replayed_adds == 1 and rec.index.n == N0 + CHUNK
    rec.close()


# ---------------------------------------------------------------------
# atomic save / typed corruption
# ---------------------------------------------------------------------

@pytest.fixture()
def saved(setup, tmp_path):
    idx = _build(setup, "flat", setup[0][:N0])
    idx.save(tmp_path / "idx")
    return idx, tmp_path / "idx"


def _load(p):
    return AshIndex.load(p, device="cpu")


def test_load_truncated_npz_raises_typed(saved):
    idx, p = saved
    data = (p / "arrays.npz").read_bytes()
    (p / "arrays.npz").write_bytes(data[: len(data) // 2])
    with pytest.raises(CorruptIndexError) as e:
        _load(p)
    assert str(p) in str(e.value)


def test_load_bitflipped_npz_raises_typed(saved):
    idx, p = saved
    data = bytearray((p / "arrays.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (p / "arrays.npz").write_bytes(bytes(data))
    with pytest.raises(CorruptIndexError):
        _load(p)


def test_load_missing_files_raise_typed(saved, tmp_path):
    idx, p = saved
    with pytest.raises(CorruptIndexError, match="config.json missing"):
        _load(tmp_path / "nowhere")
    (p / "arrays.npz").unlink()
    with pytest.raises(CorruptIndexError, match="arrays.npz missing"):
        _load(p)


def test_load_bad_manifest_raises_typed(saved):
    idx, p = saved
    (p / "config.json").write_text("{not json")
    with pytest.raises(CorruptIndexError, match="unreadable"):
        _load(p)


def test_load_wrong_format_version_raises_typed(saved):
    idx, p = saved
    meta = json.loads((p / "config.json").read_text())
    meta["format_version"] = 999
    (p / "config.json").write_text(json.dumps(meta))
    with pytest.raises(CorruptIndexError, match="format_version"):
        _load(p)


def test_load_legacy_save_without_checksums(setup, saved):
    """Saves without per-array checksums still load — and still fail
    TYPED when their npz is corrupt."""
    idx, p = saved
    meta = json.loads((p / "config.json").read_text())
    del meta["checksums"]
    (p / "config.json").write_text(json.dumps(meta))
    _assert_same_search(setup, idx, _load(p))
    data = (p / "arrays.npz").read_bytes()
    (p / "arrays.npz").write_bytes(data[: len(data) - 40])
    with pytest.raises(CorruptIndexError):
        _load(p)


def test_save_crash_before_fresh_replace_leaves_nothing(setup, saved,
                                                        tmp_path):
    idx, _ = saved
    target = tmp_path / "fresh"
    with pytest.raises(faults.SimulatedCrash):
        with faults.active({"save.replace": faults.Crash()}):
            idx.save(target)
    assert not target.exists()  # only the dot-tmp dir, never a torn mix
    idx.save(target)  # and the retry lands cleanly
    _assert_same_search(setup, idx, _load(target))


def test_save_crash_between_over_replaces_rolls_forward(setup, saved):
    """Crash between the two renames of an over-save: new arrays under
    the old manifest.  load() must detect the mismatch and finish the
    save from the durable config.new.json."""
    X = setup[0]
    idx, p = saved
    idx.add(torch.from_numpy(X[N0:N0 + CHUNK]))  # the second save differs
    with pytest.raises(faults.SimulatedCrash):
        with faults.active({"save.between_replace": faults.Crash()}):
            idx.save(p)
    assert (p / "config.new.json").exists()
    loaded = _load(p)  # roll-forward
    assert loaded.n == idx.n
    _assert_same_search(setup, idx, loaded)
    assert not (p / "config.new.json").exists()  # save completed
    _assert_same_search(setup, idx, _load(p))


def test_save_garbage_new_files_are_ignored(setup, saved):
    """Leftover partial .new files from a crash mid-write must not
    shadow the intact live pair."""
    idx, p = saved
    (p / "arrays.new.npz").write_bytes(b"partial garbage")
    (p / "config.new.json").write_text("{also garb")
    _assert_same_search(setup, idx, _load(p))


# ---------------------------------------------------------------------
# frontend: drain/abort vs the WAL
# ---------------------------------------------------------------------

def _frontend_fixture(setup, root, max_wait_s=60.0):
    """Engine + durability + driver whose cadence will NOT apply
    mutations on its own (huge max_wait_s, huge mutation backlog
    bound) — staged-but-unapplied is the steady state until stop()."""
    idx = _build(setup, "flat", setup[0][:N0])
    dur = DurableIndex.create(idx, root, fsync="always")
    eng = QueryEngine(idx, max_wait_s=max_wait_s,
                      max_pending_mutations=10_000)
    eng.attach_durability(dur)
    fe = ServingFrontend(eng, poll_interval_s=0.002).start()
    return idx, dur, eng, fe


def test_frontend_drain_applies_and_logs_staged_mutations(setup, tmp_path):
    X = setup[0]
    idx, dur, eng, fe = _frontend_fixture(setup, tmp_path / "dur")
    ta = fe.submit_add(X[:CHUNK])
    td = fe.submit_delete([0, 1, 2])
    assert idx.pending_rows == CHUNK  # staged, not applied
    assert not ta.done and not td.done
    fe.stop(drain=True)
    assert ta.done and td.done  # applied before the driver exited
    assert ta.wal_seqno == 1 and td.wal_seqno == 2  # and WAL-logged
    assert td.result() == 3
    recs, torn = read_log(tmp_path / "dur" / "wal")
    assert torn == 0
    assert [r.kind for r in recs] == [KIND_ADD, KIND_DELETE]
    dur.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS["flat"])
    assert rec.index.n_live == idx.n_live
    _assert_same_search(setup, idx, rec.index)
    rec.close()


def test_frontend_abort_leaves_replayable_wal(setup, tmp_path):
    """stop(drain=False) fails queued QUERY tickets but still applies
    + logs pending mutations — the WAL replays to the exact state."""
    X, Qm = setup[0], setup[1]
    idx, dur, eng, fe = _frontend_fixture(setup, tmp_path / "dur")
    ta = fe.submit_add(X[CHUNK:2 * CHUNK])
    tq = fe.submit(Qm[:1], k=5)  # sub-bucket: parked until stop
    fe.stop(drain=False)
    assert ta.done and ta.wal_seqno == 1
    assert isinstance(tq.error, FrontendClosed)
    dur.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS["flat"])
    assert rec.report.replayed_adds == 1
    _assert_same_search(setup, idx, rec.index)
    rec.close()


# ---------------------------------------------------------------------
# compactor: checkpoint-then-truncate + supervision
# ---------------------------------------------------------------------

def test_compactor_swap_checkpoints_and_truncates_wal(setup, tmp_path):
    X = setup[0]
    idx = _build(setup, "flat", X[:N0])
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="always")
    eng = QueryEngine(idx, auto_compact=0.01)
    eng.attach_durability(dur)
    comp = BackgroundCompactor(eng)  # attached; run synchronously
    eng.submit_add(X[:CHUNK]).result()
    eng.submit_delete(list(range(10))).result()
    assert dur.wal.nbytes > 0
    assert comp.run_once("default")  # swap + checkpoint + truncate
    stats = dur.stats()
    # the marker logged at swap is covered by the checkpoint too
    assert stats["checkpoint_seqno"] == stats["last_seqno"] == 3
    assert dur.wal.nbytes == 0  # covered segments dropped
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS["flat"])
    assert rec.report.checkpoint_seqno == 3
    assert rec.report.replayed_adds == 0  # nothing left to replay
    assert rec.index.n_dead == 0  # the compacted state was persisted
    _assert_same_search(setup, idx, rec.index)
    rec.close()
    dur.close()


def test_synchronous_auto_compact_logs_marker(setup, tmp_path):
    X = setup[0]
    idx = _build(setup, "flat", X[:N0])
    dur = DurableIndex.create(idx, tmp_path / "dur", fsync="off")
    eng = QueryEngine(idx, auto_compact=0.01)
    eng.attach_durability(dur)
    assert eng.submit_delete(list(range(10))).result() == 10
    assert idx.n_dead == 0 and eng.stats.compactions == 1
    recs, _ = read_log(tmp_path / "dur" / "wal")
    assert [(r.kind, r.text) for r in recs] == [
        (KIND_DELETE, ""), (KIND_MARKER, "compact")]
    dur.close()
    rec = DurableIndex.open(tmp_path / "dur", index_opts=LOAD_OPTS["flat"])
    assert rec.index.n_live == idx.n_live == N0 - 10
    rec.close()


def test_compactor_records_failures_and_health(setup, tmp_path):
    idx = _build(setup, "flat", setup[0][:N0])
    eng = QueryEngine(idx)
    comp = BackgroundCompactor(eng, max_dead_fraction=0.0,
                               max_failures=2).start()
    idx.delete(list(range(8)))
    try:
        with faults.active(
            {"compactor.swap": faults.Error(at=1, repeat=True)}
        ):
            for _ in range(2):
                comp.request("default")
                assert comp.wait_idle(10.0)
                assert _wait_until(
                    lambda: eng.stats.compact_failures >= 1)
            assert _wait_until(
                lambda: eng.stats.compact_consecutive_failures >= 2)
            assert not comp.healthy()
            assert "InjectedError" in comp.last_error
            snap = eng.stats.snapshot()["supervision"]
            assert snap["compact_failures"] >= 2
        # fault cleared: the next run succeeds and resets the streak
        comp.request("default")
        assert comp.wait_idle(10.0)
        assert _wait_until(
            lambda: eng.stats.compact_consecutive_failures == 0)
        assert comp.healthy()
        assert idx.n_dead == 0
    finally:
        comp.stop()


def test_driver_failure_streak_fails_queued_tickets(setup, tmp_path):
    """A persistently failing driver tick must not hang callers: after
    max_driver_failures consecutive failures, queued query tickets
    fail with the captured cause, and healthy() flips False — then
    recovers once the fault clears."""
    X, Qm = setup[0], setup[1]
    idx = _build(setup, "flat", X[:N0])
    eng = QueryEngine(idx, max_wait_s=0.005)
    fe = ServingFrontend(
        eng, poll_interval_s=0.002, max_driver_failures=3).start()
    try:
        with faults.active(
            {"engine.apply": faults.Error(at=1, repeat=True)}
        ):
            tm = fe.submit_add(X[:CHUNK])  # every aged apply now fails
            assert _wait_until(
                lambda: eng.stats.driver_consecutive_failures >= 3)
            assert not fe.healthy()
            assert "InjectedError" in fe.last_error
            tq = fe.submit(Qm[:1], k=5)
            assert _wait_until(lambda: tq.done, timeout=5.0)
            assert isinstance(tq.error, faults.InjectedError)
            with pytest.raises(RuntimeError):
                tq.result(timeout=1.0)
            assert not tm.done  # mutations stay queued, never lost
        # fault cleared: the driver applies the backlog and recovers
        ids = tm.result(timeout=10.0)
        np.testing.assert_array_equal(ids, np.arange(N0, N0 + CHUNK))
        assert _wait_until(
            lambda: eng.stats.driver_consecutive_failures == 0)
        assert fe.healthy()
        snap = eng.stats.snapshot()["supervision"]
        assert snap["driver_failures"] >= 3
    finally:
        fe.stop()


def test_attach_durability_checks_the_index(setup, tmp_path):
    X = setup[0]
    idx = _build(setup, "flat", X[:N0])
    other = _build(setup, "flat", X[:N0])
    dur = DurableIndex.create(other, tmp_path / "dur", fsync="off")
    eng = QueryEngine(idx)
    with pytest.raises(ValueError, match="not the index"):
        eng.attach_durability(dur)
    assert eng.durability() is None
    with pytest.raises(FileExistsError):
        DurableIndex.create(other, tmp_path / "dur")
    dur.close()


# ---------------------------------------------------------------------
# against the JAX package, both ways
# ---------------------------------------------------------------------

def _records(X):
    rows = X[:5].astype(np.float32)
    return [("add", rows, np.arange(60, 65)), ("del", np.array([3, 61, 9])),
            ("marker", "compact"), ("add", rows[:1], np.array([65])),
            ("del", np.array([], np.int64))]


def _write(wal_cls, root, recs):
    wal = wal_cls(root, fsync="off")
    for rec in recs:
        if rec[0] == "add":
            wal.append_add(rec[1], rec[2])
        elif rec[0] == "del":
            wal.append_delete(rec[1])
        else:
            wal.append_marker(rec[1])
    wal.close()
    return wal.segments()[0]


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert (ra.seqno, ra.kind, ra.text) == (rb.seqno, rb.kind, rb.text)
        for name in ("rows", "ids"):
            va, vb = getattr(ra, name), getattr(rb, name)
            assert (va is None) == (vb is None)
            if va is not None:
                assert va.dtype == vb.dtype and va.shape == vb.shape
                assert va.tobytes() == vb.tobytes()  # bit-equal


def test_wal_bytes_identical_to_reference(setup, tmp_path):
    X = setup[0]
    for kind, seq, payload in ((KIND_ADD, 7, b"\x01\x02"),
                               (KIND_DELETE, 2**40, b""),
                               (KIND_MARKER, 1, "compact".encode())):
        assert W._encode_record(kind, seq, payload) == \
            JW._encode_record(kind, seq, payload)
    recs = _records(X)
    ours = _write(WriteAheadLog, tmp_path / "port", recs)
    theirs = _write(JW.WriteAheadLog, tmp_path / "jax", recs)
    assert ours.name == theirs.name
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("damage", ["none", "torn", "bitflip"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segments_read_across_packages(setup, tmp_path, writer, damage):
    wal_cls = WriteAheadLog if writer == "port" else JW.WriteAheadLog
    seg = _write(wal_cls, tmp_path / "w", _records(setup[0]))
    data = bytearray(seg.read_bytes())
    if damage == "torn":
        data = data[: len(data) - 7]
    elif damage == "bitflip":
        data[len(data) // 2] ^= 0x10
    seg.write_bytes(bytes(data))
    ours, end_ours = W._scan_segment(bytes(data), seg)
    theirs, end_theirs = JW._scan_segment(bytes(data), seg)
    assert end_ours == end_theirs
    assert (end_ours == len(data)) == (damage == "none")
    _same_records(ours, theirs)
    a, torn_a = read_log(tmp_path / "w")
    b, torn_b = JW.read_log(tmp_path / "w")
    assert torn_a == torn_b == len(data) - end_ours
    _same_records(a, b)


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[np.isfinite(want)]).max()))


def _same_across(setup, ti, ji):
    Qm = setup[1]
    for kw in ({"k": 10}, {"k": 10, "rerank": 16}):
        ts, tids = ti.search(torch.from_numpy(Qm), **kw)
        js, jids = ji.search(jnp.asarray(Qm), **kw)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        _close(ts.numpy(), js)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_durability_directory_recovers_across_packages(setup, tmp_path,
                                                       writer):
    """A directory written by either package's DurableIndex under its
    engine and crashed at ``engine.apply.logged`` (Crash at 3) opens in
    both packages: the same durable prefix, equal ids."""
    X, Qm, model, jcfg, jmodel, kb = setup
    root = tmp_path / "dur"
    if writer == "jax":
        ji = JIndex.build(kb, jnp.asarray(X[:N0]), jcfg, model=jmodel,
                          keep_raw=True)
        dur = JDurable.create(ji, root, fsync="always")
        eng = JEngine(ji)
        eng.attach_durability(dur)
        mod = jfaults
    else:
        ti = _build(setup, "flat", X[:N0])
        dur = DurableIndex.create(ti, root, fsync="always")
        eng = QueryEngine(ti)
        eng.attach_durability(dur)
        mod = faults
    muts, acked, crashed = _drive(
        dur, eng, X, mod, {"engine.apply.logged": mod.Crash(at=3)})
    assert crashed
    shutil.copytree(root, tmp_path / "for_port")
    shutil.copytree(root, tmp_path / "for_jax")
    rec_t = DurableIndex.open(tmp_path / "for_port",
                              index_opts={"device": "cpu"})
    rec_j = JDurable.open(tmp_path / "for_jax")
    for r in (rec_t.report, rec_j.report):
        _check_durable_prefix(muts, acked, crashed, r)
    assert rec_t.report.last_seqno == rec_j.report.last_seqno
    assert rec_t.report.replayed_adds == rec_j.report.replayed_adds
    assert rec_t.index.n == rec_j.index.n
    assert rec_t.index.n_dead == rec_j.index.n_dead
    assert rec_t.index.next_id == rec_j.index.next_id
    _same_across(setup, rec_t.index, rec_j.index)
    rec_t.close()
    rec_j.close()
