"""Port parity: SASRec (``repro_torch.models.sasrec``), its ASH catalog
retrieval (``serving.retrieval.sasrec_retrieve``), its data
(``data.synthetic.SequenceStream``) and ``models.common``'s
``layer_norm`` and ``embedding_bag``, against the JAX package.

Parameters come from the reference's ``init_params`` and cross with
``convert.params_from_numpy`` (bit for bit); batches from numpy.
Tolerances:

* hidden states, user states, scores and the loss to rtol 1e-5 (with an
  atol of 1e-5 x the largest |value|); every gradient leaf to 1e-4 x
  its largest |g| (fp32 sums in another order);
* one AdamW train step through ``Arch.loss_fn`` and ``make_train_step``
  (the reduced config of both launchers) against the reference's jitted
  step: parameters to 1e-6 absolute, except AdamW's m/sqrt(v) cases
  (an element whose clipped gradient is under 1e-6 may move by up to
  twice the learning rate; under 1 % of the elements, as in
  ``test_torch_train.py``);
* ``SequenceStream`` on the reference's own draws, and retrieval over an
  index saved by the JAX package: EQUAL.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.launch import train as JL  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import sasrec as JS  # noqa: E402
from repro.serving import retrieval as JRET  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import sasrec as TS  # noqa: E402
from repro_torch.serving import retrieval as TRET  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(n_items=300, embed_dim=16, n_blocks=2, n_heads=2, seq_len=12,
             n_neg=24)
CJ = JS.SASRecConfig(**SMALL)
CT = TS.SASRecConfig(**SMALL)


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float64))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30))


def _close_tree(got, want, atol_rel):
    for (name, a), (name_w, b) in zip(_flat(got), _flat(want), strict=True):
        assert name == name_w
        np.testing.assert_allclose(
            a, b, rtol=0, atol=atol_rel * max(np.abs(b).max(), 1e-30),
            err_msg=name)


def params_close(got, want, grads, lr_sum, atol=1e-6):
    """Parameters to ``atol``, except AdamW's m/sqrt(v) cases (module
    docstring; ``grads`` before clipping to norm 1)."""
    cases = 0
    gn = np.sqrt(sum(float((g ** 2).sum()) for _, g in _flat(grads)))
    for (name, a), (_, b), (_, g) in zip(_flat(got), _flat(want),
                                         _flat(grads), strict=True):
        bad = np.abs(a - b) > atol
        tiny = np.abs(g) * min(1.0, 1.0 / gn) < 1e-6
        assert not (bad & ~tiny).any(), (name, np.abs(a - b).max())
        assert (np.abs(a - b) <= 2 * lr_sum + atol).all(), name
        cases += int(bad.sum())
    assert cases <= 0.01 * sum(x.size for _, x in _flat(want)), cases


def _batch(seed, B=6, cfg=SMALL):
    """Left-padded histories (row 0 all padding, row 1 one item),
    next-item labels and shared negatives: (JAX, port) dicts."""
    rng = np.random.default_rng(seed)
    S, V = cfg["seq_len"], cfg["n_items"]
    seq = rng.integers(1, V, (B, S)).astype(np.int32)
    lengths = rng.integers(1, S + 1, B)
    lengths[:2] = (0, 1)
    for b, n in enumerate(lengths):
        seq[b, :S - n] = 0
    labels = np.roll(seq, -1, axis=1)
    labels[:, -1] = 0
    negs = rng.integers(1, V, cfg["n_neg"]).astype(np.int32)
    b = {"seq": seq, "labels": labels, "negatives": negs}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.fixture(scope="module")
def model():
    pj = JS.init_params(jax.random.PRNGKey(0), CJ)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, tree, convert.params_from_numpy(tree, CT, device="cpu")


@pytest.fixture(scope="module")
def jax_loss_grad():
    return jax.jit(jax.value_and_grad(functools.partial(JS.loss_fn, cfg=CJ)))


# -- models.common ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((5, 7, 24)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal((2, 24)).astype(np.float32)
    want = JC.layer_norm(jnp.asarray(x, getattr(jnp, dtype)),
                         jnp.asarray(s), jnp.asarray(b))
    got = TC.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(s), torch.from_numpy(b))
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    if dtype == "float32":
        _close(got.numpy(), want)
    else:  # one bf16 rounding apart at most
        _close(got.float().numpy(), np.asarray(want, np.float32),
               rtol=2 ** -7, atol_rel=2 ** -8)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(combiner, weighted):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    idx = rng.integers(0, 40, 30).astype(np.int32)
    seg = np.sort(rng.integers(0, 9, 30)).astype(np.int32)  # bag 9 empty
    w = rng.random(30).astype(np.float32) if weighted else None
    want = JC.embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                            jnp.asarray(seg), 10,
                            None if w is None else jnp.asarray(w), combiner)
    got = TC.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           torch.from_numpy(seg), 10,
                           None if w is None else torch.from_numpy(w),
                           combiner)
    _close(got.numpy(), want)
    assert not got[9].any()


# -- the model ----------------------------------------------------------------


def test_params_cross_bit_for_bit(model):
    _, tree, pt = model
    back = convert.params_to_numpy(pt)
    assert [n for n, _ in _flat(back)] == [n for n, _ in _flat(tree)]
    for (n, a), (_, b) in zip(_flat(back), _flat(tree)):
        np.testing.assert_array_equal(a, b, err_msg=n)
    assert isinstance(pt["blocks"], list) and len(pt["blocks"]) == 2


@pytest.mark.parametrize("seed", [3, 4])
def test_encode_user_state_and_scores_match_reference(model, seed):
    pj, _, pt = model
    bj, bt = _batch(seed)
    want = JS.encode_sequence(pj, bj["seq"], CJ)
    got = TS.encode_sequence(pt, bt["seq"], CT)
    _close(got.detach().numpy(), want)
    _close(TS.user_state(pt, bt["seq"], CT).detach().numpy(),
           JS.user_state(pj, bj["seq"], CJ))
    cand = np.arange(0, CT.n_items, 3, dtype=np.int32)
    _close(TS.retrieval_score(pt, bt["seq"], torch.from_numpy(cand),
                              CT).detach().numpy(),
           JS.retrieval_score(pj, bj["seq"], jnp.asarray(cand), CJ))


def test_all_padding_row_takes_the_uniform_softmax(model):
    """A history of pads only: every key masked with -1e30, so each
    query's softmax is uniform (the reference's), finite, not NaN."""
    pj, _, pt = model
    seq = np.zeros((2, CT.seq_len), np.int32)
    seq[1, -3:] = (5, 6, 7)
    got = TS.encode_sequence(pt, torch.from_numpy(seq), CT).detach()
    assert torch.isfinite(got).all()
    _close(got.numpy(), JS.encode_sequence(pj, jnp.asarray(seq), CJ))


@pytest.mark.parametrize("seed", [5, 6])
def test_loss_and_grads_match_reference(model, jax_loss_grad, seed):
    pj, tree, _ = model
    bj, bt = _batch(seed)
    lj, gj = jax_loss_grad(pj, bj)
    pt = convert.params_from_numpy(tree, CT, device="cpu")
    leaves = [t for _, t in TC.tree_items(TS.make_trainable(pt))]
    loss = TS.loss_fn(pt, bt, CT)
    gs = iter(torch.autograd.grad(loss, leaves))
    gt = jax.tree_util.tree_map(lambda _: next(gs).numpy(),
                                jax.tree_util.tree_map(np.asarray, gj))
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    _close_tree(gt, jax.tree_util.tree_map(np.asarray, gj), atol_rel=1e-4)


def test_train_step_matches_reference_jitted_step():
    """One AdamW step of the reduced sasrec through the registry's
    ``loss_fn`` and ``make_train_step`` in both packages."""
    aj = JL.reduced_arch(JR.get("sasrec"))
    at = TL.reduced_arch(TR.get("sasrec"))
    assert at.cfg.embed_dim == aj.cfg.embed_dim == 16
    key = jax.random.PRNGKey(0)
    pj = JS.init_params(key, aj.cfg)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    bt = TL.make_stream(at, 8, 0, seed=3).next()
    bj = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    loss_j = aj.loss_fn(lambda a, k: a)
    step_j = JTR.make_train_step(loss_j, aj.train_cfg)
    (sj, mj), g = jax.jit(lambda p, b: (
        step_j(JTR.init_state(key, p, aj.train_cfg), b),
        jax.grad(loss_j)(p, b)))(pj, bj)
    pt = convert.params_from_numpy(tree, at.cfg, device="cpu")
    step_t = TTR.make_train_step(at.loss_fn(), at.train_cfg)
    st, mt = step_t(TTR.init_state(0, pt, at.train_cfg), bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    params_close(convert.params_to_numpy(st.params),
                 jax.tree_util.tree_map(np.asarray, sj.params),
                 jax.tree_util.tree_map(np.asarray, g),
                 lr_sum=TO.lr_at(at.train_cfg.opt, 1))


# -- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(2, 0), (7, 5)])
def test_sequence_stream_on_reference_draws_equals_reference(seed, step):
    B, S, V, n_neg = 8, 12, 500, 16
    ref = JD.SequenceStream(JD.IteratorState(seed=seed, step=step), B, S, V,
                            n_neg=n_neg).next()
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, k3 = jax.random.split(key, 3)
    got = TD.sequence_batch(
        torch.from_numpy(np.array(jax.random.randint(k1, (B,), 1, V))),
        torch.from_numpy(np.array(jax.random.randint(k2, (B, S), 1, 17))),
        torch.from_numpy(np.array(jax.random.randint(k3, (n_neg,), 1, V))),
        V)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_sequence_stream_is_a_function_of_seed_and_step():
    a = TD.SequenceStream(TD.IteratorState(seed=2, step=3), 8, 12, 500, 16)
    b = TD.SequenceStream(TD.IteratorState(seed=2, step=3), 8, 12, 500, 16)
    ba, bb = a.next(), b.next()
    assert all(torch.equal(ba[k], bb[k]) for k in ba)
    assert not torch.equal(a.next()["seq"], ba["seq"])
    assert ba["seq"].shape == (8, 12) and ba["negatives"].shape == (16,)
    assert int(ba["seq"].min()) >= 1 and (ba["labels"][:, -1] == 0).all()
    assert torch.equal(ba["labels"][:, :-1], ba["seq"][:, 1:])


# -- retrieval ----------------------------------------------------------------


def test_sasrec_retrieve_over_a_jax_saved_index(tmp_path):
    """The counterpart of the reference's end-to-end retrieval test: its
    index saved, loaded into the port; the port's ``sasrec_retrieve``
    returns the reference's ids, and the recall against exact scores
    clears the reference's bar."""
    cfg_j = JS.SASRecConfig(n_items=2000, embed_dim=16, seq_len=10,
                            n_neg=32)
    cfg_t = TS.SASRecConfig(n_items=2000, embed_dim=16, seq_len=10,
                            n_neg=32)
    pj = JS.init_params(jax.random.PRNGKey(0), cfg_j)
    seq = jax.random.randint(jax.random.PRNGKey(1), (4, 10), 1, 2000)
    index = JRET.build_index(jax.random.PRNGKey(2), pj["item_emb"], bits=8,
                             reduce=1, n_landmarks=8)
    index.save(tmp_path / "catalog")
    want_s, want_ids = JRET.sasrec_retrieve(pj, seq, index, cfg_j, k=50)

    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   cfg_t, device="cpu")
    ti = AshIndex.load(tmp_path / "catalog", device="cpu")
    seq_t = torch.from_numpy(np.array(seq))
    got_s, got_ids = TRET.sasrec_retrieve(pt, seq_t, ti, cfg_t, k=50)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    _close(got_s.numpy(), want_s)
    assert TRET.engine_for(ti).stats.requests >= 1
    exact = TS.retrieval_score(pt, seq_t, torch.arange(2000), cfg_t)
    gt = torch.topk(exact, 10).indices
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(got_ids, gt))
    assert hits / gt.numel() > 0.85
