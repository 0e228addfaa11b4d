"""Port parity: the IVF backend and the coarse plans against the JAX package.

An IVF index built and saved by the JAX package loads into the port and
returns the same ids on partial probes (fused and materializing
routes), full probes, exact rerank and ``coarse="int8"`` plans; delete,
add and compact give the same results in both packages; and an index
saved by the port loads into the JAX package with the same ids.

Tolerances: scores at rtol 1e-5 / atol 1e-5 times their scale (fp32
reduction order); ids equal.  On coarse plans the two packages'
integer accumulation and q_int8 agree exactly but the coarse scores
differ by a few ulps (the reference's jit contracts its epilogue into
FMAs, q_corr sums in another order), so a shortlist could differ where
two coarse scores tie within that margin; the data here has no such
near-ties, and ids must be equal.  Within the port, a covering
shortlist equals ``coarse=None`` exactly, and a single-row search
equals its row of the batch search.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ASHConfig as JConfig  # noqa: E402
from repro.index import AshIndex as JIndex  # noqa: E402
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.index import ivf as IV  # noqa: E402

METRICS = ("dot", "l2", "cos")


def _close(got, want):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    assert np.array_equal(np.isneginf(np.asarray(got)), np.isneginf(want))
    np.testing.assert_allclose(
        np.asarray(got, np.float64)[fin], want[fin], rtol=1e-5,
        atol=1e-5 * max(1.0, np.abs(want[fin]).max()))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(33)
    A = rng.standard_normal((48, 48)) * np.arange(1, 49) ** -0.7
    X = (rng.standard_normal((2000, 48)) @ A.T + 0.5).astype(np.float32)
    X2 = (rng.standard_normal((300, 48)) @ A.T + 0.5).astype(np.float32)
    Qm = (rng.standard_normal((10, 48)) @ A.T + 0.5).astype(np.float32)
    cfg = JConfig(b=2, d=24, n_landmarks=16)
    model = JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg).model
    return X, X2, Qm, cfg, model


def _jax_index(data, metric, backend="ivf"):
    X, _, _, cfg, model = data
    return JIndex.build(jax.random.PRNGKey(5), jnp.asarray(X), cfg,
                        backend=backend, metric=metric, model=model,
                        keep_raw=True)


def _to_port(ji, path):
    ji.save(path)
    return AshIndex.load(path, device="cpu")


def _same_search(ji, ti, Qm, **kw):
    js, jids = ji.search(jnp.asarray(Qm), **kw)
    ts, tids = ti.search(torch.from_numpy(Qm), **kw)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids), str(kw))
    _close(ts.numpy(), js)
    return ts, tids


@pytest.mark.parametrize("metric", METRICS)
def test_jax_saved_ivf_loads_into_port(data, metric, tmp_path):
    _, _, Qm, _, _ = data
    ji = _jax_index(data, metric)
    ti = _to_port(ji, tmp_path / "idx")
    st = ti._state
    assert (ti.backend, ti.metric, ti.n) == ("ivf", metric, ji.n)
    assert st.max_list_len == ji._state.max_list_len
    np.testing.assert_array_equal(st.invlists.numpy(),
                                  np.asarray(ji._state.invlists))
    R = 4 * st.max_list_len
    assert R % 128 and R > 200
    _same_search(ji, ti, Qm, k=10, nprobe=4)  # fused gathered route
    _same_search(ji, ti, Qm, k=10, nprobe=16)  # full probe: dense plan
    _same_search(ji, ti, Qm, k=10, nprobe=4, rerank=256)  # materializing
    if metric == "dot":
        _same_search(ji, ti, Qm, k=100, nprobe=4)
        _same_search(ji, ti, Qm, k=200, nprobe=2)  # materializing, k > cap
        _same_search(ji, ti, Qm, k=10, nprobe=64)  # clamped to nlist


@pytest.mark.parametrize("metric", ("dot", "l2"))
def test_ivf_coarse_matches_jax(data, metric, tmp_path):
    _, _, Qm, _, _ = data
    ji = _jax_index(data, metric)
    ti = _to_port(ji, tmp_path / "idx")
    R = 4 * ti._state.max_list_len
    _same_search(ji, ti, Qm, k=10, nprobe=4, coarse="int8")  # L=32 < R
    _same_search(ji, ti, Qm, k=10, nprobe=4, coarse="int8", shortlist=64,
                 rerank=100)
    _same_search(ji, ti, Qm, k=10, nprobe=16, coarse="int8")  # dense
    # L >= R: the coarse stage is skipped, equal to coarse=None
    ts, tids = _same_search(ji, ti, Qm, k=10, nprobe=4, coarse="int8",
                            shortlist=R)
    ps, pids = ti.search(torch.from_numpy(Qm), k=10, nprobe=4)
    assert torch.equal(ts, ps) and torch.equal(tids, pids)


def test_flat_coarse_matches_jax(data, tmp_path):
    X, _, Qm, _, _ = data
    ji = _jax_index(data, "cos", backend="flat")
    ti = _to_port(ji, tmp_path / "flat")
    _same_search(ji, ti, Qm, k=10, coarse="int8")
    _same_search(ji, ti, Qm, k=10, coarse="int8", shortlist=200)  # > cap
    _same_search(ji, ti, Qm, k=5, coarse="int8", rerank=50)
    ts, tids = _same_search(ji, ti, Qm, k=10, coarse="int8",
                            shortlist=len(X))
    ps, pids = ti.search(torch.from_numpy(Qm), k=10)
    assert torch.equal(ts, ps) and torch.equal(tids, pids)
    rv = torch.from_numpy(np.arange(len(X)) % 3 != 0)
    ti._state = dataclasses.replace(ti._state, live=rv)
    _, cids = ti.search(torch.from_numpy(Qm), k=10, coarse="int8")
    assert (cids % 3 != 0).all()  # tombstones never surface


def test_ivf_mutations_match_jax_and_cross_load(data, tmp_path):
    _, X2, Qm, _, _ = data
    ji = _jax_index(data, "l2")
    ti = _to_port(ji, tmp_path / "a")
    dead = list(range(0, 2000, 7))
    assert ji.delete(dead) == ti.delete(dead) == len(dead)
    for kw in (dict(k=10, nprobe=4), dict(k=10, nprobe=16),
               dict(k=10, nprobe=4, coarse="int8")):
        _, ids = _same_search(ji, ti, Qm, **kw)
        assert not np.isin(ids.numpy(), dead).any()
    ji.add(jnp.asarray(X2))
    ti.add(torch.from_numpy(X2))
    assert ji.next_id == ti.next_id == 2300
    _same_search(ji, ti, Qm, k=10, nprobe=4)
    ji.compact()
    ti.compact()
    assert ji.n == ti.n == 2300 - len(dead)
    _same_search(ji, ti, Qm, k=10, nprobe=4, rerank=64)
    _same_search(ji, ti, Qm, k=10, nprobe=4, coarse="int8")
    # port-saved -> JAX-loaded
    ti.delete([1, 2, 3])
    ti.save(tmp_path / "b")
    back = JIndex.load(tmp_path / "b")
    assert back.backend == "ivf" and back.n == ti.n
    _same_search(back, ti, Qm, k=10, nprobe=4)
    _same_search(back, ti, Qm, k=10, nprobe=16, rerank=32)


def test_ivf_single_row_equals_batch_row(data):
    """The port needs no m = 1 pad: each query's gathered scores and
    selection do not depend on the batch."""
    X, _, Qm, cfg, _ = data
    ti = AshIndex.build(torch.Generator().manual_seed(0),
                        torch.from_numpy(X),
                        ASHConfig(b=cfg.b, d=cfg.d,
                                  n_landmarks=cfg.n_landmarks),
                        backend="ivf", metric="cos", device="cpu",
                        keep_raw=True, learned=False)
    prep = ti.prepare(torch.from_numpy(Qm))
    for kw in (dict(k=10, nprobe=4), dict(k=200, nprobe=4),
               dict(k=10, nprobe=4, rerank=64),
               dict(k=10, nprobe=4, coarse="int8"),
               dict(k=10, nprobe=16, coarse="int8")):
        s, ids = ti.search_prepped(prep, **kw)
        for i in (0, 7):
            one = dataclasses.replace(prep, **{
                f.name: getattr(prep, f.name)[i:i + 1]
                for f in dataclasses.fields(prep)})
            s1, i1 = ti.search_prepped(one, **kw)
            assert torch.equal(s1, s[i:i + 1]), kw
            assert torch.equal(i1, ids[i:i + 1]), kw



def test_ivf_search_probed_matches_search(data, tmp_path):
    """An explicit probe set equal to the coarse assignment gives the
    same results as the probing search."""
    _, _, Qm, _, _ = data
    ti = _to_port(_jax_index(data, "dot"), tmp_path / "idx")
    st = ti._state
    prep = ti.prepare(torch.from_numpy(Qm))
    probe = IV._probe_lists(st, prep, 4)
    for kw in (dict(k=10), dict(k=10, coarse="int8")):
        a = ti.search_prepped(prep, nprobe=4, **kw)
        b = IV._search_probed(st, prep, probe, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
