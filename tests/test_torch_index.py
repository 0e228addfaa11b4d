"""Port parity: the flat index against the JAX package's, across save/load.

An index built and saved by the JAX package loads into the port and
returns the same ids for every metric, with and without exact rerank;
an index saved by the port loads into the JAX package likewise; and
add/delete/compact sequences give the same results in both.  Scores
are compared at rtol 1e-5 / atol 1e-5 times their scale (fp32 reduction
order); ids must be equal (no near-ties at these sizes).  Also: the
CPU rule for entry points, integrity checks on load, and an import
scan showing that the port never imports JAX or the JAX package.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro.index import metrics as JM  # noqa: E402
from repro_torch.core import ash as TA  # noqa: E402
from repro_torch.core.types import ASHConfig, ASHModel  # noqa: E402
from repro_torch.data.synthetic import embedding_dataset  # noqa: E402
from repro_torch.index import AshIndex, CorruptIndexError  # noqa: E402
from repro_torch.index import common as TC  # noqa: E402
from repro_torch.index import metrics as TM  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
METRICS = ("dot", "l2", "cos")


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[np.isfinite(want)]).max()))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    A = rng.standard_normal((48, 48)) * np.arange(1, 49) ** -0.7
    X = (rng.standard_normal((2000, 48)) @ A.T + 0.5).astype(np.float32)
    X2 = (rng.standard_normal((300, 48)) @ A.T + 0.5).astype(np.float32)
    Qm = (rng.standard_normal((10, 48)) @ A.T + 0.5).astype(np.float32)
    cfg = JConfig(b=2, d=24, n_landmarks=16)
    model = JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg).model
    return X, X2, Qm, cfg, model


def _jax_index(data, metric):
    X, _, _, cfg, model = data
    return JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg,
                        metric=metric, model=model, keep_raw=True)


def _same_search(ji, ti, Qm, **kw):
    js, jids = ji.search(jnp.asarray(Qm), **kw)
    ts, tids = ti.search(torch.from_numpy(Qm), **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _close(ts.numpy(), js)


@pytest.mark.parametrize("metric", METRICS)
def test_jax_saved_index_loads_into_port(data, metric, tmp_path):
    _, _, Qm, _, _ = data
    ji = _jax_index(data, metric)
    ji.save(tmp_path / "idx")
    ti = AshIndex.load(tmp_path / "idx", device="cpu")
    assert (ti.metric, ti.n, ti.config.d) == (metric, ji.n, ji.config.d)
    _same_search(ji, ti, Qm, k=10)
    _same_search(ji, ti, Qm, k=10, rerank=256)
    if metric == "dot":
        _same_search(ji, ti, Qm, k=100)
        _same_search(ji, ti, Qm, k=200)  # materializing route


@pytest.mark.parametrize("metric", METRICS)
def test_port_saved_index_loads_into_jax(data, metric, tmp_path):
    X, _, Qm, cfg, jm = data
    tm = ASHModel.from_numpy(
        ASHConfig(b=cfg.b, d=cfg.d, n_landmarks=cfg.n_landmarks),
        {f: np.asarray(getattr(jm, f)) for f in ASHModel.ARRAY_FIELDS},
        device="cpu")
    Xt = torch.from_numpy(X)
    ti = AshIndex.from_parts(tm, TA.encode(tm, Xt), metric=metric,
                             raw=Xt.to(torch.bfloat16))
    ti.save(tmp_path / "idx")
    ji = JIndex.load(tmp_path / "idx")
    _same_search(ji, ti, Qm, k=10)
    _same_search(ji, ti, Qm, k=10, rerank=256)


def test_mutations_match_and_cross_load(data, tmp_path):
    X, X2, Qm, _, _ = data
    ji = _jax_index(data, "l2")
    ji.save(tmp_path / "base")
    ti = AshIndex.load(tmp_path / "base", device="cpu")
    for idx, X_new in ((ji, jnp.asarray(X2)), (ti, torch.from_numpy(X2))):
        idx.add(X_new)
    _same_search(ji, ti, Qm, k=10)
    victims = np.asarray(ji.search(jnp.asarray(Qm), k=10)[1])[:, :3]
    victims = np.concatenate([victims.reshape(-1), [5, 2100, 99999]])
    assert ji.delete(victims) == ti.delete(victims) > 0
    assert ti.n_dead == ji.n_dead
    _same_search(ji, ti, Qm, k=10)
    _same_search(ji, ti, Qm, k=10, rerank=256)
    ti.save(tmp_path / "dead")  # tombstones cross over
    _same_search(JIndex.load(tmp_path / "dead"), ti, Qm, k=10)
    ji.compact()
    ti.compact()
    assert ti.n_dead == 0 and ti.next_id == ji.next_id == 2300
    _same_search(ji, ti, Qm, k=10)
    _same_search(ji, ti, Qm, k=200)
    ji.save(tmp_path / "compacted")
    back = AshIndex.load(tmp_path / "compacted", device="cpu")
    _same_search(ji, back, Qm, k=10)
    ti.add(torch.from_numpy(X2[:5]))
    assert ti.next_id == 2305


def test_port_round_trip_bit_identical(data, tmp_path):
    X, _, Qm, cfg, _ = data
    ti = AshIndex.build(torch.Generator().manual_seed(0), torch.from_numpy(X),
                        ASHConfig(b=2, d=24, n_landmarks=16), metric="cos",
                        device="cpu", keep_raw=True)
    s, ids = ti.search(torch.from_numpy(Qm), k=10, rerank=64)
    ti.save(tmp_path / "idx")
    ti.save(tmp_path / "idx")  # over an existing save
    back = AshIndex.load(tmp_path / "idx", device="cpu")
    s2, ids2 = back.search(torch.from_numpy(Qm), k=10, rerank=64)
    assert torch.equal(s, s2) and torch.equal(ids, ids2)
    # the plain reference scorers agree with the kernel route
    s3, ids3 = back.search(torch.from_numpy(Qm), k=10, use_kernel=False)
    s4, ids4 = back.search(torch.from_numpy(Qm), k=10)
    assert torch.equal(ids3, ids4)
    _close(s3.numpy(), s4.numpy())


def test_load_integrity_checks(data, tmp_path):
    X, _, _, cfg, model = data
    ji = _jax_index(data, "dot")
    ji.stage_add(jnp.asarray(X[:3]))
    ji.save(tmp_path / "pending")
    # a save holding staged rows loads with them still staged
    assert AshIndex.load(tmp_path / "pending", device="cpu").pending_rows == 3
    ji.apply_pending()
    ji.save(tmp_path / "idx")
    npz = tmp_path / "idx" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(CorruptIndexError):
        AshIndex.load(tmp_path / "idx", device="cpu")
    with pytest.raises(CorruptIndexError, match="missing"):
        AshIndex.load(tmp_path / "nowhere", device="cpu")


def test_unported_plans_raise(data):
    """Gathered and coarse plans run, and so do the sharded and tiered
    backends; what is refused: an unknown backend, ``shortlist=``
    without ``coarse=``, an unknown coarse mode, and row masks on a
    gathered plan."""
    X, _, Qm, _, _ = data
    ti = AshIndex.build(torch.Generator().manual_seed(0),
                        torch.from_numpy(X[:600]),
                        ASHConfig(b=2, d=8, n_landmarks=4), device="cpu")
    prep = ti.prepare(torch.from_numpy(Qm))
    rows = torch.zeros(10, 4, dtype=torch.int32)
    for kw, match in (({"shortlist": 8}, "requires coarse"),
                      ({"coarse": "int4"}, "unknown coarse mode"),
                      ({"rows": rows, "row_valid": torch.ones(600, dtype=bool)},
                       "dense plans only")):
        plan = TC.ScanPlan(metric="dot", k=5, **kw)
        with pytest.raises(ValueError, match=match):
            TC.execute_plan(ti.model, prep, ti.payload, plan)
    for plan in (TC.ScanPlan(metric="dot", k=5, coarse="int8"),
                 TC.ScanPlan(metric="dot", k=3, rows=rows)):
        s, ids = TC.execute_plan(ti.model, prep, ti.payload, plan)
        assert s.shape == ids.shape == (10, plan.k)
    with pytest.raises(ValueError, match="unknown backend"):
        AshIndex.build(torch.Generator(), torch.from_numpy(X[:600]),
                       ASHConfig(b=2, d=8), backend="hnsw", device="cpu")
    for backend in ("sharded", "tiered_ivf"):
        built = AshIndex.build(torch.Generator().manual_seed(0),
                               torch.from_numpy(X[:600]),
                               ASHConfig(b=2, d=8, n_landmarks=4),
                               backend=backend, device="cpu")
        assert built.backend == backend and built.n == 600
        assert built.model.device.type == "cpu"
        s, ids = built.search(torch.from_numpy(Qm), k=5)
        assert s.shape == ids.shape == (10, 5) and bool((ids >= 0).all())


@pytest.mark.parametrize("metric", METRICS)
def test_exact_topk_and_recall(data, metric):
    X, _, Qm, _, _ = data
    js, ji = JM.exact_topk(jnp.asarray(Qm), jnp.asarray(X), k=20,
                           metric=metric)
    ts, ti = TM.exact_topk(torch.from_numpy(Qm), torch.from_numpy(X), k=20,
                           metric=metric)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts.numpy(), js)
    retrieved = np.roll(np.asarray(ji), 3, axis=1)
    assert TM.recall_at(torch.from_numpy(retrieved), ti, 10) == pytest.approx(
        float(JM.recall_at(jnp.asarray(retrieved), ji, 10)))


def test_entry_points_refuse_cpu_fallback(data, tmp_path, monkeypatch):
    """Without a CUDA device, entry points that were not asked for the
    CPU raise instead of quietly running there."""
    X, _, _, cfg, _ = data
    _jax_index(data, "dot").save(tmp_path / "idx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xt = torch.from_numpy(X[:200])
    gen = torch.Generator().manual_seed(0)
    small = ASHConfig(b=2, d=8, n_landmarks=2)
    for call in (
        lambda: AshIndex.build(gen, Xt, small),
        lambda: AshIndex.load(tmp_path / "idx"),
        lambda: TA.train(gen, Xt, small),
        lambda: TA.random_model(gen, 48, small),
        lambda: embedding_dataset(10, 4),
        lambda: ASHModel.from_numpy(small, {}),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_port_never_imports_jax_or_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += sorted((REPO / "tests" / "cuda").glob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].is_file()
    assert REPO / "src" / "repro_torch" / "index" / "ivf.py" in files
    for mod in ("cache", "engine", "frontend", "compactor", "retrieval",
                "wal"):
        assert REPO / "src" / "repro_torch" / "serving" / f"{mod}.py" in files
    assert REPO / "src" / "repro_torch" / "launch" / "serve.py" in files
    assert REPO / "src" / "repro_torch" / "testing" / "faults.py" in files
    for mod in ("pq", "lopq", "eden", "leanvec", "rabitq"):
        assert REPO / "src" / "repro_torch" / "baselines" / f"{mod}.py" in files
    assert REPO / "src" / "repro_torch" / "models" / "moe.py" in files
    for mod in ("optim", "compression", "trainer", "checkpoint"):
        assert REPO / "src" / "repro_torch" / "train" / f"{mod}.py" in files
    assert REPO / "src" / "repro_torch" / "launch" / "train.py" in files
    assert REPO / "src" / "repro_torch" / "configs" / "registry.py" in files
    assert REPO / "src" / "repro_torch" / "configs" / "granite_moe_3b.py" \
        in files
    for mod in ("models/sasrec", "models/recsys", "models/nequip",
                "data/graphs", "configs/sasrec_cfg", "configs/dcn_v2",
                "configs/fm", "configs/autoint", "configs/nequip_cfg"):
        assert REPO / "src" / "repro_torch" / f"{mod}.py" in files
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
