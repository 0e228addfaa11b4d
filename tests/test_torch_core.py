"""Port parity: encode, scoring and learning against the JAX package.

A model trained by the JAX package is carried across as numpy arrays
(``ASHModel.from_numpy``); learning steps are compared on shared
inputs.  Tolerances:
  * packed codes and cluster ids: bit for bit;
  * fp16 SCALE/OFFSET headers: within 1 fp16 ulp (the fp32 values
    they round from differ by reduction order), or 2^-20 of the largest
    header where OFFSET cancels to near zero;
  * fp32 results (stats, query terms, scores, Procrustes/ITQ steps, a
    Lloyd step, decode): rtol 1e-5 with an atol of 1e-5 times the
    quantity's scale, the reduction-order drift of fp32 sums over
    D <= 64 terms;
  * PCA: by subspace (eigenvector signs are free), projector within
    1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ash as JA  # noqa: E402
from repro.core import learning as JL  # noqa: E402
from repro.core import scoring as JS  # noqa: E402
from repro.core.types import ASHConfig as JConfig  # noqa: E402
from repro_torch.core import ash as TA  # noqa: E402
from repro_torch.core import learning as TL  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.core.types import ASHConfig, ASHModel, ASHPayload  # noqa: E402
from repro_torch.data.synthetic import embedding_dataset  # noqa: E402


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * scale)


def to_port_model(jm) -> ASHModel:
    c = jm.config
    return ASHModel.from_numpy(
        ASHConfig(b=c.b, d=c.d, n_landmarks=c.n_landmarks,
                  store_fp16=c.store_fp16),
        {f: np.asarray(getattr(jm, f)) for f in ASHModel.ARRAY_FIELDS},
        device="cpu",
    )


@pytest.fixture(scope="module", params=[2, 1])
def trained(request):
    b = request.param
    rng = np.random.default_rng(11)
    A = rng.standard_normal((32, 32)) * np.arange(1, 33) ** -0.7
    X = (rng.standard_normal((1500, 32)) @ A.T + 0.5).astype(np.float32)
    Qm = (rng.standard_normal((6, 32)) @ A.T + 0.5).astype(np.float32)
    jm, _ = JA.train(jax.random.PRNGKey(3), jnp.asarray(X),
                     JConfig(b=b, d=20, n_landmarks=8))
    return X, Qm, jm, to_port_model(jm)


def test_model_round_trip(trained):
    _, _, jm, tm = trained
    arrays = tm.to_numpy()
    for f in ASHModel.ARRAY_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jm, f)))
    assert tm.D == jm.D and tm.d == jm.d
    assert tm.config.payload_bits() == jm.config.payload_bits()


def test_encode_matches_reference(trained):
    X, _, jm, tm = trained
    jp = JA.encode(jm, jnp.asarray(X))
    tp = TA.encode(tm, torch.from_numpy(X))
    np.testing.assert_array_equal(
        tp.codes.numpy().view(np.uint32), np.asarray(jp.codes)
    )
    np.testing.assert_array_equal(tp.cluster.numpy(), np.asarray(jp.cluster))
    assert tp.scale.dtype == torch.float16
    for name in ("scale", "offset"):
        want = np.asarray(getattr(jp, name)).astype(np.float32)
        got = getattr(tp, name).numpy().astype(np.float32)
        ulp = np.spacing(np.abs(want).astype(np.float16)).astype(np.float32)
        # OFFSET is a difference of fp32 terms as large as the largest
        # header: near zero its fp32 cancellation error (a few 2^-24 of
        # those terms) can exceed the fp16 ulp of the small result
        floor = 2.0**-20 * np.abs(want).max()
        assert (np.abs(got - want) <= np.maximum(ulp, floor)).all(), name
    # payload round trip through numpy
    back = ASHPayload.from_numpy(tp.b, tp.d, tp.to_numpy(), device="cpu")
    for f in ASHPayload.ARRAY_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tp, f))


def test_encode_chunking_is_row_independent(trained, monkeypatch):
    X, _, _, tm = trained
    whole = TA.encode(tm, torch.from_numpy(X))
    monkeypatch.setattr(TA, "_ENCODE_CHUNK_ELEMS", 7 * tm.config.d)
    parts = TA.encode(tm, torch.from_numpy(X))
    for f in ASHPayload.ARRAY_FIELDS:
        assert torch.equal(getattr(parts, f), getattr(whole, f))


def test_fp16_header_clip():
    """Rows far from every landmark clip SCALE/OFFSET into the fp16
    range instead of overflowing to inf (as the reference does)."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((40, 8)).astype(np.float32)
    X[:3] *= 1e6
    cfg = ASHConfig(b=2, d=8, n_landmarks=1)
    tm = TA.random_model(torch.Generator().manual_seed(0), 8, cfg,
                         device="cpu")
    p = TA.encode(tm, torch.from_numpy(X))
    assert torch.isfinite(p.scale.float()).all()
    assert torch.isfinite(p.offset.float()).all()


@pytest.fixture(scope="module")
def payloads(trained):
    X, Qm, jm, tm = trained
    jp = JA.encode(jm, jnp.asarray(X))
    tp = ASHPayload.from_numpy(
        jp.b, jp.d, {f: np.asarray(getattr(jp, f))
                     for f in ASHPayload.ARRAY_FIELDS}, device="cpu")
    return X, Qm, jm, tm, jp, tp


def test_prepare_queries_and_stats(payloads):
    _, Qm, jm, tm, jp, tp = payloads
    jprep = JS.prepare_queries(jm, jnp.asarray(Qm))
    tprep = TS.prepare_queries(tm, torch.from_numpy(Qm))
    for f in ("q", "q_proj", "ip_q_landmarks", "q_sq_norm"):
        _close(getattr(tprep, f).numpy(), getattr(jprep, f))
    js = JS.payload_stats(jm, jp)
    ts = TS.payload_stats(tm, tp)
    for f in ("res_norm", "ip_x_mu", "x_sq"):
        _close(getattr(ts, f).numpy(), getattr(js, f))
    jr = JS.recovered_terms(jm, jp)
    tr = TS.recovered_terms(tm, tp)
    for got, want in zip(tr, jr):
        _close(got.numpy(), want)


@pytest.mark.parametrize("rowwise", [False, True])
@pytest.mark.parametrize("name", ["score_dot", "score_l2", "score_cosine"])
def test_scores_match_reference(payloads, name, rowwise):
    _, Qm, jm, tm, jp, tp = payloads
    jprep = JS.prepare_queries(jm, jnp.asarray(Qm))
    tprep = TS.prepare_queries(tm, torch.from_numpy(Qm))
    want = getattr(JS, name)(jm, jprep, jp, rowwise=rowwise)
    got = getattr(TS, name)(tm, tprep, tp, rowwise=rowwise)
    assert got.shape == (Qm.shape[0], tp.n)
    _close(got.numpy(), want)


def test_decode_and_reconstruction(payloads):
    X, _, jm, tm, jp, tp = payloads
    _close(TA.decode(tm, tp).numpy(), JA.decode(jm, jp))
    _close(float(TA.reconstruction_error(tm, torch.from_numpy(X))),
           float(JA.reconstruction_error(jm, jnp.asarray(X))), rtol=1e-4)


# ---------------------------------------------------------------------------
# Learning, step by step on shared inputs
# ---------------------------------------------------------------------------


def _shared_rz(seed=0, n=600, d=12, b=2):
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, d)).astype(np.float32)
    Z /= np.linalg.norm(Z, axis=1, keepdims=True)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return q.astype(np.float32), Z


@pytest.mark.parametrize("b", [1, 2, 4])
def test_procrustes_and_itq_step(b):
    R, Z = _shared_rz(b)
    M = (Z.T @ Z[:, ::-1]).astype(np.float32)
    _close(TL.procrustes_svd(torch.from_numpy(M)).numpy(),
           JL.procrustes_svd(jnp.asarray(M)), atol_rel=1e-4)
    _close(TL.newton_schulz(torch.from_numpy(M)).numpy(),
           JL.newton_schulz(jnp.asarray(M)), atol_rel=1e-4)
    js = JL.itq_step(jnp.asarray(R), jnp.asarray(Z), b=b)
    ts = TL.itq_step(torch.from_numpy(R), torch.from_numpy(Z), b=b)
    _close(ts.R.numpy(), js.R, atol_rel=1e-4)
    _close(float(ts.loss), float(js.loss))


def test_lloyd_step_and_assign():
    rng = np.random.default_rng(4)
    X = rng.standard_normal((800, 16)).astype(np.float32)
    cent = X[rng.choice(800, 10, replace=False)] + 0.01
    got_a = TL.assign_clusters(torch.from_numpy(X), torch.from_numpy(cent))
    want_a = JL.assign_clusters(jnp.asarray(X), jnp.asarray(cent))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    # the reference's Lloyd body (inside kmeans' fori_loop) on shared input
    sums = jax.ops.segment_sum(jnp.asarray(X), want_a, num_segments=10)
    counts = jax.ops.segment_sum(jnp.ones(800), want_a, num_segments=10)
    want = jnp.where(counts[:, None] > 0,
                     sums / jnp.maximum(counts[:, None], 1.0),
                     jnp.asarray(cent))
    got = TL.lloyd_step(torch.from_numpy(X), torch.from_numpy(cent))
    _close(got.numpy(), want)
    xt, norms, a = TL.normalized_residuals(torch.from_numpy(X),
                                           torch.from_numpy(cent))
    jxt, jn, ja = JL.normalized_residuals(jnp.asarray(X), jnp.asarray(cent))
    _close(xt.numpy(), jxt)
    _close(norms.numpy(), jn)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


def test_pca_subspace():
    rng = np.random.default_rng(9)
    X = (rng.standard_normal((500, 24)) * np.linspace(3, 0.1, 24)).astype(
        np.float32)
    P_t = TL.pca_topd(torch.from_numpy(X), 8).numpy().astype(np.float64)
    P_j = np.asarray(JL.pca_topd(jnp.asarray(X), 8)).astype(np.float64)
    np.testing.assert_allclose(P_t.T @ P_t, P_j.T @ P_j, atol=1e-4)
    np.testing.assert_allclose(P_t @ P_t.T, np.eye(8), atol=1e-5)


def test_train_port_model():
    """Training runs end to end in the port: W row-orthonormal, the
    alternation's loss never ends worse than it started, early stop
    bounds the iterations, and encoding reconstructs about as well as
    the reference's own training on the same data."""
    X = embedding_dataset(1200, 32, seed=2, device="cpu")
    cfg = ASHConfig(b=2, d=16, n_landmarks=8)
    tm, hist = TA.train(torch.Generator().manual_seed(0), X, cfg,
                        device="cpu")
    W = tm.W.double()
    torch.testing.assert_close(W @ W.T, torch.eye(16, dtype=torch.float64),
                               atol=1e-5, rtol=0)
    assert 1 <= len(hist) <= 25 and hist[-1] <= hist[0]
    jm, _ = JA.train(jax.random.PRNGKey(0), jnp.asarray(X.numpy()),
                     JConfig(b=2, d=16, n_landmarks=8))
    err_t = float(TA.reconstruction_error(tm, X))
    err_j = float(JA.reconstruction_error(jm, jnp.asarray(X.numpy())))
    assert err_t <= 1.1 * err_j


def test_random_model_rows_orthonormal():
    tm = TA.random_model(torch.Generator().manual_seed(1), 24,
                         ASHConfig(b=2, d=10, n_landmarks=1), device="cpu")
    torch.testing.assert_close(tm.W @ tm.W.T, torch.eye(10), atol=1e-5,
                               rtol=0)
    assert tm.landmarks.shape == (1, 24)
