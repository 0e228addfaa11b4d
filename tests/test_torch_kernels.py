"""Port parity: the scan kernels' plain versions against the JAX kernels.

The JAX side runs ``ash_score_pallas`` / ``ash_score_topk_pallas`` in
interpret mode with fp32 compute, as the reference's own tests do on the
CPU.  The port side runs the kernel wrappers on CPU tensors, which is
their plain PyTorch version.  Tolerances:
  * exact-arithmetic inputs (small integers, power-of-two scales): every
    score is exact in fp32 in both packages, so scores, ids and tie
    order must be EQUAL, including duplicate rows and -inf rows;
  * random fp32 inputs: rtol 1e-5 and atol 1e-5 times the largest
    |score| (fp32 reduction order over d_pad <= 128 terms), with top-k
    ids equal (no near-ties at these sizes).
The CUDA kernels themselves are tested on the card by
``tests/cuda/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels.ash_score import (  # noqa: E402
    ash_score_pallas, ash_score_topk_pallas,
)
from repro_torch.kernels import ash_score as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

METRICS = ("dot", "l2", "cos")


def _inputs(seed, b, d, n, m, C, *, exact):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 2**b, size=(n, d))
    codes = np.array(JQ.pack_codes(
        jnp.asarray(2 * levels - (2**b - 1), jnp.int32), b))
    d_pad = codes.shape[1] * (32 // b)
    if exact:
        q = rng.integers(-3, 4, size=(m, d)).astype(np.float32)
        scale = rng.choice([0.5, 1.0, 2.0], size=n).astype(np.float32)
        offset = rng.integers(-8, 9, size=n).astype(np.float32)
        ipq = rng.integers(-8, 9, size=(m, C)).astype(np.float32)
        qterm = rng.choice([0.25, 0.5, 1.0], size=m).astype(np.float32)
        rowterm = rng.choice([0.5, 1.0, 4.0], size=n).astype(np.float32)
    else:
        q = rng.standard_normal((m, d)).astype(np.float32)
        scale = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
        offset = rng.standard_normal(n).astype(np.float32)
        ipq = rng.standard_normal((m, C)).astype(np.float32)
        qterm = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
        rowterm = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    q = np.pad(q, ((0, 0), (0, d_pad - d)))
    cluster = rng.integers(0, C, size=n).astype(np.int32)
    return dict(codes=codes, q=q, scale=scale, offset=offset,
                cluster=cluster, ipq=ipq, qterm=qterm, rowterm=rowterm)


def _duplicate_rows(a, src, dst):
    for name in ("codes", "scale", "offset", "cluster", "rowterm"):
        a[name][dst] = a[name][src]


def _jax_args(a, metric):
    qt = jnp.asarray(a["qterm"]) if metric != "dot" else None
    rt = jnp.asarray(a["rowterm"]) if metric != "dot" else None
    return (jnp.asarray(a["codes"]), jnp.asarray(a["q"]),
            jnp.asarray(a["scale"]), jnp.asarray(a["offset"]),
            jnp.asarray(a["cluster"]), jnp.asarray(a["ipq"]), qt, rt)


def _torch_args(a, metric):
    qt = torch.from_numpy(a["qterm"]) if metric != "dot" else None
    rt = torch.from_numpy(a["rowterm"]) if metric != "dot" else None
    return (torch.from_numpy(a["codes"].view(np.int32)),
            torch.from_numpy(a["q"]), torch.from_numpy(a["scale"]),
            torch.from_numpy(a["offset"]), torch.from_numpy(a["cluster"]),
            torch.from_numpy(a["ipq"]), qt, rt)


def _jax_scores(a, b, metric):
    return np.asarray(ash_score_pallas(
        *_jax_args(a, metric), b=b, metric=metric, interpret=True,
        compute_dtype=jnp.float32))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m,C", [(2, 100, 700, 5, 16), (1, 100, 300, 3, 4),
                                       (4, 40, 520, 8, 8), (8, 20, 200, 2, 3)])
def test_score_plain_vs_pallas(metric, b, d, n, m, C):
    a = _inputs(b * 7 + d, b, d, n, m, C, exact=False)
    want = _jax_scores(a, b, metric)
    got = TK.ash_score_cuda(*_torch_args(a, metric), b=b, metric=metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("metric", METRICS)
def test_score_exact_inputs_equal(metric):
    """b=1, d=100 pads q to d_pad=128: the pad lanes add nothing."""
    a = _inputs(5, 1, 100, 300, 4, 6, exact=True)
    want = _jax_scores(a, 1, metric)
    got = TK.ash_score_cuda(*_torch_args(a, metric), b=1, metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("masking", ["none", "row_valid", "n_valid", "both"])
def test_topk_plain_vs_pallas_ties(metric, masking):
    """Duplicate rows tie exactly; ties come out lowest id first across
    tiles, masked rows never surface, and ids/values/tie order equal
    the reference kernel's."""
    b, n, k = 2, 1100, 12
    a = _inputs(17, b, 64, n, 4, 8, exact=True)
    _duplicate_rows(a, np.arange(0, 40), np.arange(1000, 1040))
    _duplicate_rows(a, np.arange(0, 40), np.arange(530, 570))
    rng = np.random.default_rng(3)
    row_valid = rng.random(n) > 0.2 if masking in ("row_valid", "both") \
        else None
    n_valid = 1060 if masking in ("n_valid", "both") else None
    js, ji = ash_score_topk_pallas(
        *_jax_args(a, metric),
        None if n_valid is None else jnp.int32(n_valid),
        None if row_valid is None else jnp.asarray(row_valid),
        b=b, k=k, metric=metric, interpret=True, compute_dtype=jnp.float32)
    ts, ti = TK.ash_score_topk_cuda(
        *_torch_args(a, metric), n_valid,
        None if row_valid is None else torch.from_numpy(row_valid),
        b=b, k=k, metric=metric)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # and equal to a stable top-k of the masked materialized scores
    full = TR.mask_rows_ref(
        TK.ash_score_cuda(*_torch_args(a, metric), b=b, metric=metric),
        n_valid, None if row_valid is None else torch.from_numpy(row_valid))
    vs, vi = TR.stable_top_k(full, k)
    assert torch.equal(vs, ts) and torch.equal(vi.to(torch.int32), ti)


def test_topk_random_inputs():
    a = _inputs(23, 4, 48, 900, 6, 5, exact=False)
    js, ji = ash_score_topk_pallas(
        *_jax_args(a, "l2"), b=4, k=20, metric="l2", interpret=True,
        compute_dtype=jnp.float32)
    ts, ti = TK.ash_score_topk_cuda(*_torch_args(a, "l2"), b=4, k=20,
                                    metric="l2")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(js)).max())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_exhausted_slots_and_neg_inf_rows():
    """Fewer valid rows than k: the tail comes back (-inf, -1).  Rows
    whose score is really -inf are still emitted, in id order."""
    b, n, k = 2, 300, 10
    a = _inputs(29, b, 32, n, 3, 4, exact=True)
    a["offset"][[7, 9]] = -np.inf
    row_valid = np.zeros(n, bool)
    row_valid[[3, 7, 9, 250]] = True
    js, ji = ash_score_topk_pallas(
        *_jax_args(a, "dot"), None, jnp.asarray(row_valid), b=b, k=k,
        interpret=True, compute_dtype=jnp.float32)
    ts, ti = TK.ash_score_topk_cuda(
        *_torch_args(a, "dot"), None, torch.from_numpy(row_valid), b=b, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ti[:, 4:] == -1).all() and torch.isneginf(ts[:, 2:]).all()
    assert ti[0, 2:4].tolist() == [7, 9]


def test_topk_strip_too_small_raises():
    """k above n_blocks * k_tilde raises in both packages."""
    a = _inputs(31, 2, 32, 700, 2, 4, exact=True)
    with pytest.raises(ValueError, match="candidate strip"):
        ash_score_topk_pallas(*_jax_args(a, "dot"), b=2, k=10, k_tilde=4,
                              interpret=True)
    with pytest.raises(ValueError, match="candidate strip"):
        TK.ash_score_topk_cuda(*_torch_args(a, "dot"), b=2, k=10,
                               k_tilde=4)
    # k_tilde < k inside the strip is allowed (recall-style selection)
    ts, ti = TK.ash_score_topk_cuda(*_torch_args(a, "dot"), b=2, k=8,
                                    k_tilde=4)
    js, ji = ash_score_topk_pallas(*_jax_args(a, "dot"), b=2, k=8,
                                   k_tilde=4, interpret=True,
                                   compute_dtype=jnp.float32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_stable_top_k_matches_lax_ties():
    s = np.array([[1, 2, 2, 2, 0], [0, 0, 0, 0, 0]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), 3)
    got_v, got_i = TR.stable_top_k(torch.from_numpy(s), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_cpu_path_counts_no_launch_and_check_refuses():
    TK.reset_launch_counts()
    a = _inputs(37, 2, 32, 64, 2, 4, exact=True)
    args = _torch_args(a, "dot")
    rows = torch.tensor([[0, 5, -1], [63, 1, 2]], dtype=torch.int32)
    qi = torch.zeros(2, args[1].shape[1], dtype=torch.int8)
    ones = torch.ones(2)
    TK.ash_score_cuda(*args, b=2)
    TK.ash_score_topk_cuda(*args, b=2, k=3)
    TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2)
    TK.ash_score_gather_topk_cuda(args[0], rows, *args[1:], b=2, k=2)
    TK.ash_score_coarse_cuda(args[0], qi, ones, ones, *args[2:], b=2)
    TK.ash_score_coarse_topk_cuda(args[0], qi, ones, ones, *args[2:], b=2,
                                  k=3)
    TK.ash_topk_merge_cuda(TR.make_keys(torch.zeros(2, 4), torch.zeros(
        2, 4, dtype=torch.int32)), 2, 4)
    # seven kernels and the wide tile's share of kernel 2's launches
    assert len(TK.launch_counts) == 8
    assert "ash_score_topk_wide" in TK.launch_counts
    assert set(TK.launch_counts.values()) == {0}
    assert set(TK.merge_launches.values()) == {0}
    args = list(_torch_args(a, "dot"))
    args[1] = args[1].to(torch.float64)
    with pytest.raises(ValueError, match="q_proj"):
        TK._check(*args, "dot", 2)
    args = list(_torch_args(a, "l2"))
    args[1] = torch.cat([args[1], args[1]], 1)[:, ::2]
    with pytest.raises(ValueError, match="q_proj"):
        TK._check(*args, "l2", 2)
