"""Port parity: the paper's baselines (``repro_torch.baselines``), the
scoring functions they and the paper's claims use, and those claims.

The JAX package's states are carried across with each module's
``from_numpy`` (the two packages' random streams differ), then:

* **encode**: integer codes EQUAL to the reference's except at near
  ties.  A code is an argmin or a rounding of fp32 values that XLA and
  PyTorch sum in other orders, so wherever the two differ the margin
  between the best and the second-best choice, computed in float64, must
  be at most 1e-5 of the quantity's scale, and such rows must be under
  0.1 % of the rows;
* **score** on the reference's own encoded data, and fp32 side outputs
  (EDEN's scale, LVQ's min and step, TurboQuant's calibrated grid): rtol
  1e-5 with an atol of 1e-5 times the quantity's scale, except the
  calibrated grid (1e-6, as asked of it);
* ``lloyd_max_grid_np``: bit-equal; ``expected_dot_1bit``: within 4
  fp32 ulps of lgamma(D/2) relative, the cancellation of its two
  fp32 log-gammas (both packages, and against float64);
  ``fit_bias``: rho and beta to rtol 1e-4 (a 10^4-sample fp32 least
  squares), debiased scores as scores.

Then the port's own training passes each threshold of
``tests/test_baselines.py`` on the same data, and the paper's claims of
``tests/test_paper_claims.py`` (Fig. 1 and Fig. 2) hold for the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import eden as JE  # noqa: E402
from repro.baselines import leanvec as JV  # noqa: E402
from repro.baselines import lopq as JLO  # noqa: E402
from repro.baselines import pq as JPQ  # noqa: E402
from repro.baselines import rabitq as JR  # noqa: E402
from repro.core import ash as JA  # noqa: E402
from repro.core import scoring as JS  # noqa: E402
from repro.core.types import ASHConfig as JConfig  # noqa: E402
from repro.data.synthetic import embedding_dataset as j_dataset  # noqa: E402
from repro_torch.baselines import eden, leanvec, lopq, pq, rabitq  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ASHConfig, ASHModel, ASHPayload, encode, prepare_queries, random_model,
    score_dot, train,
)
from repro_torch.core import scoring as S  # noqa: E402
from repro_torch.index import metrics as MET  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small products: with
    several test processes on the machine, torch's default thread count
    makes each tiny op wait on the others (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


def _codes_equal_but_ties(got, want, margin, tol=1e-5):
    """EQUAL codes except where the float64 margin between the best and
    the second-best choice is within ``tol``; such rows under 0.1 %."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = got != want
    assert (margin[diff] <= tol).all(), margin[diff].max()
    rows = diff.reshape(diff.shape[0], -1).any(axis=1)
    assert rows.mean() < 1e-3, rows.mean()


def _seg_margin(cb, X):
    """Relative margin of the two nearest centroids per segment: cb
    (M, K, ds), X (n, D) float64 -> (n, M)."""
    M, K, ds = cb.shape
    seg = X.reshape(X.shape[0], M, ds)
    d2 = ((seg[:, :, None, :] - cb[None]) ** 2).sum(-1)
    part = np.sort(d2, axis=-1)
    scale = (seg ** 2).sum(-1) + (cb ** 2).sum(-1).max(-1)[None]
    return (part[..., 1] - part[..., 0]) / scale


def _level_margin(grid, Y):
    """Distance of each coordinate to its nearest decision boundary, in
    units of its row's rms (float64)."""
    g = np.asarray(grid, np.float64)
    mids = (g[1:] + g[:-1]) / 2
    dist = np.abs(Y[..., None] - mids).min(-1)
    return dist / np.sqrt((Y ** 2).mean(-1, keepdims=True))


def _corr(est, true):
    est, true = np.asarray(est).ravel(), np.asarray(true).ravel()
    return float(np.corrcoef(est, true)[0, 1])


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def data():
    """The reference test's data (``tests/test_baselines.py``)."""
    kx, kq = jax.random.split(jax.random.PRNGKey(21))
    X = np.array(j_dataset(kx, 3000, 64))
    Qm = np.array(j_dataset(kq, 12, 64))
    return X, Qm, torch.from_numpy(X), torch.from_numpy(Qm), Qm @ X.T


# ---------------------------------------------------------------------------
# Against the JAX package: encode and score from carried-over states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", (1, 2, 3, 4))
def test_lloyd_max_grid_bit_equal(b):
    got, want = eden.lloyd_max_grid_np(b), JE.lloyd_max_grid_np(b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("opq_iters", (0, 2))
def test_pq_matches_reference(data, opq_iters):
    X, Qm, Xt, Qt, _ = data
    js = JPQ.train(jax.random.PRNGKey(0), jnp.asarray(X), M=8, b=4,
                   opq_iters=opq_iters, kmeans_iters=10)
    rot = None if js.rotation is None else np.asarray(js.rotation)
    st = pq.from_numpy(M=8, b=4, codebooks=np.asarray(js.codebooks),
                       rotation=rot, device=CPU)
    assert st.bits_per_vector == js.bits_per_vector == 32
    jcodes = np.asarray(JPQ.encode(js, jnp.asarray(X)))
    tcodes = pq.encode(st, Xt)
    assert tcodes.dtype == torch.int32
    Xr = X.astype(np.float64) @ (np.eye(64) if rot is None
                                 else rot.astype(np.float64))
    _codes_equal_but_ties(tcodes.numpy(), jcodes,
                          _seg_margin(np.asarray(js.codebooks, np.float64),
                                      Xr))
    want = np.asarray(JPQ.score(js, jnp.asarray(jcodes), jnp.asarray(Qm)))
    _close(pq.score(st, torch.from_numpy(jcodes), Qt).numpy(), want)
    _close(pq.decode(st, torch.from_numpy(jcodes[:50])).numpy(),
           JPQ.decode(js, jnp.asarray(jcodes[:50])))


def test_pq_score_in_query_blocks(data, monkeypatch):
    """Blocks of queries give the same scores as one block."""
    X, Qm, Xt, Qt, _ = data
    st = pq.train(_gen(0), Xt[:500], M=8, b=4, kmeans_iters=3, device=CPU)
    codes = pq.encode(st, Xt)
    whole = pq.score(st, codes, Qt)
    monkeypatch.setattr(pq, "_SCORE_ELEMS", 2 * 3000)
    assert torch.equal(pq.score(st, codes, Qt), whole)
    monkeypatch.setattr(pq, "_ASSIGN_ELEMS", 7 * 8 * 16)
    assert torch.equal(pq.encode(st, Xt), codes)


def test_lopq_matches_reference(data):
    X, Qm, Xt, Qt, _ = data
    js = JLO.train(jax.random.PRNGKey(0), jnp.asarray(X), M=8, b=4, C=2,
                   local_iters=1, kmeans_iters=10)
    st = lopq.from_numpy(M=8, b=4, C=2, **{
        f: np.asarray(getattr(js, f))
        for f in ("centroids", "rotations", "codebooks")}, device=CPU)
    assert st.bits_per_vector == js.bits_per_vector == 33
    ja, jc = (np.asarray(a) for a in JLO.encode(js, jnp.asarray(X)))
    ta, tc = lopq.encode(st, Xt)
    X64 = X.astype(np.float64)
    cen = np.asarray(js.centroids, np.float64)
    d2 = np.sort(((X64[:, None] - cen[None]) ** 2).sum(-1), axis=-1)
    cmargin = (d2[:, 1] - d2[:, 0]) / ((X64 ** 2).sum(-1)
                                       + (cen ** 2).sum(-1).max())
    _codes_equal_but_ties(ta.numpy(), ja, cmargin)
    same = ta.numpy() == ja
    margin = np.zeros(jc.shape)
    for c in range(2):
        r = same & (ja == c)
        resid = (X64[r] - cen[c]) @ np.asarray(js.rotations[c], np.float64)
        margin[r] = _seg_margin(np.asarray(js.codebooks[c], np.float64),
                                resid)
    _codes_equal_but_ties(tc.numpy()[same], jc[same], margin[same])
    want = np.asarray(JLO.score(js, (jnp.asarray(ja), jnp.asarray(jc)),
                                jnp.asarray(Qm)))
    got = lopq.score(st, (torch.from_numpy(ja), torch.from_numpy(jc)), Qt)
    _close(got.numpy(), want)


@pytest.mark.parametrize("variant", ("eden", "turboquant"))
def test_eden_matches_reference(data, variant):
    X, Qm, Xt, Qt, _ = data
    js = JE.train(jax.random.PRNGKey(0), jnp.asarray(X), b=2,
                  variant=variant)
    st = eden.from_numpy(b=2, variant=variant,
                         rotation=np.asarray(js.rotation),
                         grid=np.asarray(js.grid), device=CPU)
    assert st.bits_per_vector == js.bits_per_vector
    jcodes, js_ = (np.asarray(a) for a in JE.encode(js, jnp.asarray(X)))
    tcodes, ts = eden.encode(st, Xt)
    Y = X.astype(np.float64) @ np.asarray(js.rotation, np.float64)
    if variant == "eden":
        Y = Y / np.linalg.norm(Y, axis=1, keepdims=True) * np.sqrt(64)
    _codes_equal_but_ties(tcodes.numpy(), jcodes,
                          _level_margin(js.grid, Y))
    rows = (tcodes.numpy() == jcodes).all(axis=1)
    _close(ts.numpy()[rows], js_[rows])
    want = np.asarray(JE.score(js, (jnp.asarray(jcodes), jnp.asarray(js_)),
                               jnp.asarray(Qm)))
    got = eden.score(st, (torch.from_numpy(jcodes), torch.from_numpy(js_)),
                     Qt)
    _close(got.numpy(), want)
    _close(eden.decode(st, (torch.from_numpy(jcodes[:50]),
                            torch.from_numpy(js_[:50]))).numpy(),
           JE.decode(js, (jnp.asarray(jcodes[:50]), jnp.asarray(js_[:50]))))


def test_turboquant_calibrated_grid(data):
    X, _, Xt, _, _ = data
    for b in (1, 2, 4):
        js = JE.train(jax.random.PRNGKey(b), jnp.asarray(X), b=b,
                      variant="turboquant")
        got = eden.calibrated_grid(
            torch.from_numpy(eden.lloyd_max_grid_np(b)), Xt,
            torch.from_numpy(np.asarray(js.rotation)))
        _close(got.numpy(), js.grid, rtol=1e-6, atol_rel=1e-6)


def test_leanvec_matches_reference(data):
    X, Qm, Xt, Qt, _ = data
    js = JV.train(jax.random.PRNGKey(0), jnp.asarray(X), d=32, b=4)
    st = leanvec.from_numpy(b=4, d=32, P=np.asarray(js.P),
                            mean=np.asarray(js.mean), device=CPU)
    assert st.bits_per_vector == js.bits_per_vector == 160
    jc, jmin, jdelta = (np.asarray(a) for a in JV.encode(js, jnp.asarray(X)))
    tc, tmin, tdelta = leanvec.encode(st, Xt)
    U = ((X.astype(np.float64) - np.asarray(js.mean, np.float64))
         @ np.asarray(js.P, np.float64).T)
    t = (U - U.min(1, keepdims=True)) / (
        (U.max(1, keepdims=True) - U.min(1, keepdims=True)) / 15)
    margin = np.abs(np.abs(t - np.floor(t) - 0.5)) / 15
    _codes_equal_but_ties(tc.numpy(), jc, margin)
    _close(tmin.numpy(), jmin)
    _close(tdelta.numpy(), jdelta)
    enc = (jnp.asarray(jc), jnp.asarray(jmin), jnp.asarray(jdelta))
    want = np.asarray(JV.score(js, enc, jnp.asarray(Qm)))
    got = leanvec.score(st, tuple(torch.from_numpy(np.asarray(a))
                                  for a in enc), Qt)
    _close(got.numpy(), want)


def _port_model(jm):
    c = jm.config
    return ASHModel.from_numpy(
        ASHConfig(b=c.b, d=c.d, n_landmarks=c.n_landmarks,
                  store_fp16=c.store_fp16),
        {f: np.asarray(getattr(jm, f)) for f in ASHModel.ARRAY_FIELDS},
        device=CPU)


def _port_payload(jp):
    return ASHPayload.from_numpy(jp.b, jp.d, {
        f: np.asarray(getattr(jp, f)) for f in ASHPayload.ARRAY_FIELDS},
        device=CPU)


def test_rabitq_matches_reference(data):
    X, Qm, Xt, Qt, _ = data
    jm = JR.train(jax.random.PRNGKey(2), jnp.asarray(X), b=1)
    tm = rabitq.from_numpy(_port_model(jm).config,
                           {f: np.asarray(getattr(jm, f))
                            for f in ASHModel.ARRAY_FIELDS}, device=CPU)
    assert tm.d == tm.D == 64 and tm.landmarks.shape[0] == 1
    jp = JR.encode(jm, jnp.asarray(X))
    tp = rabitq.encode(tm, Xt)
    np.testing.assert_array_equal(tp.codes.numpy().view(np.uint32),
                                  np.asarray(jp.codes))
    want = np.asarray(JR.score(jm, jp, jnp.asarray(Qm)))
    _close(rabitq.score(tm, _port_payload(jp), Qt).numpy(), want)


@pytest.mark.parametrize("D", (64, 256, 1024))
def test_expected_dot_1bit_matches_reference(D):
    """Both packages take the difference of two fp32 log-gammas as large
    as lgamma(D/2) (2,681 at D = 1,024), so each is exact to a few ulps
    of that magnitude; both are held to it, and to the float64 value."""
    import math

    got = rabitq.expected_dot_1bit(D)
    assert got.dtype == torch.float32
    want = float(JR.expected_dot_1bit(D))
    exact = (2 * math.sqrt(D / math.pi) / (D - 1)
             * math.exp(math.lgamma(D / 2) - math.lgamma((D - 1) / 2)))
    rtol = 4 * float(np.finfo(np.float32).eps) * max(1.0, math.lgamma(D / 2))
    np.testing.assert_allclose(float(got), want, rtol=rtol)
    np.testing.assert_allclose(float(got), exact, rtol=rtol)
    np.testing.assert_allclose(want, exact, rtol=rtol)


# ---------------------------------------------------------------------------
# The scoring functions: 1-bit masked add, symmetric dot, bias correction
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ash_b1(data):
    X, Qm, _, _, _ = data
    jm, _ = JA.train(jax.random.PRNGKey(4), jnp.asarray(X),
                     JConfig(b=1, d=64, n_landmarks=4, store_fp16=False))
    jp = JA.encode(jm, jnp.asarray(X))
    return jm, jp, _port_model(jm), _port_payload(jp)


def test_score_dot_1bit(data, ash_b1):
    _, Qm, _, Qt, _ = data
    jm, jp, tm, tp = ash_b1
    prep = prepare_queries(tm, Qt)
    got = S.score_dot_1bit(tm, prep, tp)
    # the reference's own bound between the two forms
    np.testing.assert_allclose(got.numpy(), score_dot(tm, prep, tp).numpy(),
                               rtol=1e-3, atol=1e-3)
    want = JS.score_dot_1bit(jm, JS.prepare_queries(jm, jnp.asarray(Qm)), jp)
    _close(got.numpy(), want)


def test_score_symmetric_dot(data):
    X, _, _, _, _ = data
    jm, _ = JA.train(jax.random.PRNGKey(6), jnp.asarray(X),
                     JConfig(b=4, d=64, n_landmarks=1, store_fp16=False))
    ja, jb = JA.encode(jm, jnp.asarray(X[:128])), JA.encode(
        jm, jnp.asarray(X[128:256]))
    want = np.asarray(JS.score_symmetric_dot(jm, ja, jb))
    tm = _port_model(jm)
    got = S.score_symmetric_dot(tm, _port_payload(ja), _port_payload(jb))
    _close(got.numpy(), want)
    assert _corr(got, X[:128] @ X[128:256].T) > 0.97


def test_fit_bias_and_debias(data, ash_b1):
    X, Qm, Xt, Qt, _ = data
    jm, jp, tm, tp = ash_b1
    jm2 = JS.fit_bias(jm, jp, jnp.asarray(X), jnp.asarray(Qm), sample=16)
    tm2 = S.fit_bias(tm, tp, Xt, Qt, sample=16)
    assert tm2.W is tm.W and tm2.config == tm.config
    for f in ("bias_rho", "bias_beta"):
        np.testing.assert_allclose(float(getattr(tm2, f)),
                                   float(getattr(jm2, f)), rtol=1e-4,
                                   atol=1e-6)
    assert 0.5 < float(tm2.bias_rho) < 2.0
    prep = prepare_queries(tm2, Qt)
    est = S.debias(tm2, score_dot(tm2, prep, tp))
    want = JS.debias(jm2, JS.score_dot(jm2, JS.prepare_queries(
        jm2, jnp.asarray(Qm)), jp))
    _close(est.numpy(), want, rtol=1e-4, atol_rel=1e-4)
    # debiased slope ~1, the reference's check
    true = (Qm @ X.T).ravel()
    A = np.stack([true, np.ones_like(true)], 1)
    coef = np.linalg.lstsq(A, est.numpy().ravel(), rcond=None)[0]
    assert abs(coef[0] - 1.0) < 0.15


# ---------------------------------------------------------------------------
# The port's own training: the thresholds of tests/test_baselines.py
# ---------------------------------------------------------------------------


def test_pq_adc(data):
    X, Qm, Xt, Qt, true = data
    st = pq.train(_gen(0), Xt, M=8, b=4, device=CPU)
    assert _corr(pq.score(st, pq.encode(st, Xt), Qt), true) > 0.92
    # decode consistency: ADC == <q, decode(codes)>
    codes = pq.encode(st, Xt[:50])
    np.testing.assert_allclose(pq.score(st, codes, Qt).numpy(),
                               (Qt @ pq.decode(st, codes).T).numpy(),
                               rtol=1e-3, atol=1e-3)


def test_opq_beats_pq(data):
    X, Qm, Xt, Qt, true = data
    st0 = pq.train(_gen(0), Xt, M=8, b=4, device=CPU)
    st1 = pq.train(_gen(0), Xt, M=8, b=4, opq_iters=3, device=CPU)
    e0 = _corr(pq.score(st0, pq.encode(st0, Xt), Qt), true)
    e1 = _corr(pq.score(st1, pq.encode(st1, Xt), Qt), true)
    assert e1 >= e0 - 0.005


def test_opq_trains_every_iteration_from_one_state(data):
    """As the reference: each OPQ iteration's k-means starts from the
    generator state the call began with."""
    _, _, Xt, _, _ = data
    X = Xt[:400]
    st = pq.train(_gen(5), X, M=8, b=2, opq_iters=1, kmeans_iters=3,
                  device=CPU)
    g = _gen(5)
    R = torch.eye(64)
    cb = pq._train_codebooks(g, X @ R, 8, 2, iters=3)
    assert torch.equal(st.codebooks, cb)
    st2 = pq.train(_gen(5), X, M=8, b=2, opq_iters=2, kmeans_iters=3,
                   device=CPU)
    cb2 = pq._train_codebooks(_gen(5), X @ st.rotation, 8, 2, iters=3)
    assert torch.equal(st2.codebooks, cb2)


def test_lopq(data):
    X, Qm, Xt, Qt, true = data
    st = lopq.train(_gen(0), Xt, M=8, b=4, C=4, local_iters=2, device=CPU)
    assert _corr(lopq.score(st, lopq.encode(st, Xt), Qt), true) > 0.96


def test_lopq_small_cluster_pads_with_row_zero(monkeypatch):
    """A cluster of fewer than 2M rows trains on its rows and then row 0
    of X, as the reference's ``nonzero(size=n, fill_value=0)``."""
    X = torch.randn(40, 8, generator=_gen(1))
    X[0] = 100.0
    seen = []
    real = pq.train

    def spy(gen, Xc, *a, **kw):
        seen.append(Xc.clone())
        return real(gen, Xc, *a, **kw)

    monkeypatch.setattr(pq, "train", spy)
    st = lopq.train(_gen(2), X, M=4, b=1, C=2, local_iters=1,
                    kmeans_iters=2, device=CPU)
    small = [c for c in range(2) if len(seen[c]) == 8]
    assert small, [len(s) for s in seen]
    c = small[0]
    _, assign = lopq.L.kmeans(lopq.PQ.derive(_gen(2), 2)[0], X, 2, iters=2)
    rows = torch.nonzero(assign == c)[:, 0]
    assert len(rows) < 8
    want = torch.cat([X[rows], X[:1].expand(8 - len(rows), -1)])
    assert torch.equal(seen[c], want - st.centroids[c])


@pytest.mark.parametrize("variant", ["eden", "turboquant"])
def test_eden_tq(data, variant):
    X, Qm, Xt, Qt, true = data
    st = eden.train(_gen(0), Xt, b=2, variant=variant, device=CPU)
    assert _corr(eden.score(st, eden.encode(st, Xt), Qt), true) > 0.9


def test_eden_decode_norm_preserved(data):
    X, _, Xt, _, _ = data
    st = eden.train(_gen(0), Xt, b=2, variant="eden", device=CPU)
    recon = eden.decode(st, eden.encode(st, Xt[:100]))
    np.testing.assert_allclose(torch.linalg.norm(recon, dim=1).numpy(),
                               np.linalg.norm(X[:100], axis=1), rtol=1e-3)


def test_leanvec(data):
    X, Qm, Xt, Qt, true = data
    st = leanvec.train(_gen(0), Xt, d=32, b=4, device=CPU)
    assert _corr(leanvec.score(st, leanvec.encode(st, Xt), Qt), true) > 0.95


def test_lloyd_max_grid_is_sorted_and_symmetric():
    for b in (1, 2, 3, 4):
        g = eden.lloyd_max_grid_np(b)
        assert len(g) == 2**b
        assert np.all(np.diff(g) > 0)
        np.testing.assert_allclose(g, -g[::-1], atol=2e-2)


def test_ash_beats_baselines_at_iso_bits(data):
    """The paper's headline: ASH > PQ and > EDEN at ~128 code bits."""
    X, Qm, Xt, Qt, true = data
    model, _ = train(_gen(1), Xt, ASHConfig(b=2, d=64, n_landmarks=8),
                     device=CPU)
    ash_corr = _corr(score_dot(model, prepare_queries(model, Qt),
                               encode(model, Xt)), true)
    st = pq.train(_gen(1), Xt, M=16, b=8, kmeans_iters=15, device=CPU)
    pq_corr = _corr(pq.score(st, pq.encode(st, Xt), Qt), true)
    se = eden.train(_gen(1), Xt, b=2, device=CPU)
    eden_corr = _corr(eden.score(se, eden.encode(se, Xt), Qt), true)
    assert ash_corr > eden_corr, (ash_corr, eden_corr)
    assert ash_corr > 0.98
    assert ash_corr > pq_corr - 0.005, (ash_corr, pq_corr)


def test_rabitq_is_ash_special_case(data):
    X, Qm, Xt, Qt, true = data
    model = rabitq.train(_gen(2), Xt, b=1, device=CPU)
    assert model.config.b == 1 and model.d == model.D
    assert model.landmarks.shape[0] == 1
    est = rabitq.score(model, rabitq.encode(model, Xt), Qt)
    assert _corr(est, true) > 0.75


def test_entry_points_refuse_the_cpu_unasked(data, monkeypatch):
    _, _, Xt, _, _ = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kw in ((pq.train, dict(M=8)), (lopq.train, dict(M=8)),
                   (eden.train, dict(b=1)), (leanvec.train, dict(d=8)),
                   (rabitq.train, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(_gen(0), Xt[:100], **kw)


# ---------------------------------------------------------------------------
# The paper's claims (tests/test_paper_claims.py), on the port
# ---------------------------------------------------------------------------

D_CLAIM = 64


@pytest.fixture(scope="module")
def claims():
    kx, kq = jax.random.split(jax.random.PRNGKey(77))
    X = torch.from_numpy(np.array(j_dataset(kx, 4000, D_CLAIM)))
    Qm = torch.from_numpy(np.array(j_dataset(kq, 32, D_CLAIM)))
    return X, Qm, MET.exact_topk(Qm, X, k=10)[1]


def _recall(model, X, Qm, gt, R=30):
    sc = score_dot(model, prepare_queries(model, Qm), encode(model, X))
    ids = torch.sort(sc, dim=1, descending=True, stable=True).indices[:, :R]
    return MET.recall_at(ids, gt)


def test_fig1_learned_beats_random_and_gap_widens(claims):
    X, Qm, gt = claims
    gaps = []
    for d in (D_CLAIM, D_CLAIM // 2):
        cfg = ASHConfig(b=2, d=d, n_landmarks=1)
        r_l = _recall(train(_gen(0), X, cfg, device=CPU)[0], X, Qm, gt)
        r_r = _recall(random_model(_gen(0), D_CLAIM, cfg, X_for_landmarks=X,
                                   device=CPU), X, Qm, gt)
        gaps.append(r_l - r_r)
    assert gaps[0] >= -0.02
    assert gaps[1] > 0.02
    assert gaps[1] >= gaps[0] - 0.02


def test_fig1_b2_halfdim_beats_b1_fulldim(claims):
    X, Qm, gt = claims
    r_b1 = _recall(train(_gen(0), X, ASHConfig(b=1, d=D_CLAIM),
                         device=CPU)[0], X, Qm, gt)
    r_b2 = _recall(train(_gen(0), X, ASHConfig(b=2, d=D_CLAIM // 2),
                         device=CPU)[0], X, Qm, gt)
    assert r_b2 >= r_b1 - 0.02, (r_b1, r_b2)


def test_fig2_learned_beats_rabitq_expectation(claims):
    X, _, _ = claims
    _, hist = train(_gen(1), X, ASHConfig(b=1, d=D_CLAIM), device=CPU)
    assert -hist[-1] > float(rabitq.expected_dot_1bit(D_CLAIM))
