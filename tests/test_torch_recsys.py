"""Port parity: the CTR models DCN-v2 (full rank and ``cross_rank``),
FM and AutoInt (``repro_torch.models.recsys``) and their data
(``data.synthetic.ClickStream``), against the JAX package.

Parameters come from the reference's ``init_params`` and cross with
``convert.params_from_numpy`` (bit for bit); batches from numpy.
Tolerances: the folded-table lookup EQUAL (a gather); logits, retrieval
scores and the loss to rtol 1e-5 (atol 1e-5 x the largest |value|);
every gradient leaf to 1e-4 x its largest |g|; one AdamW train step of
each reduced recsys id through ``Arch.loss_fn`` and ``make_train_step``
against the reference's jitted step to 1e-6, but for AdamW's
m/sqrt(v) cases (``test_torch_sasrec.params_close``); ``ClickStream``
on the reference's own draws EQUAL to its batches.
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
from repro.models import recsys as JM  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import recsys as TM  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402
from test_torch_sasrec import _close, _close_tree, _flat, params_close  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (kind, extra fields): small configs of every branch of the reference
CASES = {
    "fm": dict(kind="fm", n_dense=0, n_sparse=5, embed_dim=4),
    "fm_dense": dict(kind="fm", n_dense=3, n_sparse=5, embed_dim=4),
    "dcn_v2": dict(kind="dcn_v2", n_dense=3, n_sparse=4, embed_dim=4,
                   n_cross_layers=2, mlp_dims=(16, 8)),
    "dcn_v2_lowrank": dict(kind="dcn_v2", n_dense=3, n_sparse=4,
                           embed_dim=4, n_cross_layers=3, mlp_dims=(16, 8),
                           cross_rank=5),
    "dcn_v2_sparse_only": dict(kind="dcn_v2", n_dense=0, n_sparse=4,
                               embed_dim=4, n_cross_layers=1,
                               mlp_dims=(8,)),
    "autoint": dict(kind="autoint", n_dense=0, n_sparse=6, embed_dim=8,
                    n_attn_layers=2, n_attn_heads=2, d_attn=4),
    "autoint_dense": dict(kind="autoint", n_dense=2, n_sparse=6,
                          embed_dim=8, n_attn_layers=1, n_attn_heads=3,
                          d_attn=4),
}
VOCAB = 50


def _cfgs(case):
    kw = dict(CASES[case], name=case, vocab_per_field=VOCAB)
    return JM.RecSysConfig(**kw), TM.RecSysConfig(**kw)


def _batch(cfg, seed, B=7):
    rng = np.random.default_rng(seed)
    b = {"sparse": rng.integers(0, VOCAB, (B, cfg.n_sparse)).astype(np.int32),
         "labels": rng.integers(0, 2, B).astype(np.float32)}
    if cfg.n_dense:
        b["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _model(case):
    cj, ct = _cfgs(case)
    pj = JM.init_params(jax.random.PRNGKey(1), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return cj, ct, pj, tree


def _port(case):
    _, ct, _, tree = _model(case)
    return convert.params_from_numpy(tree, ct, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_tree_and_lookup_match_reference(case):
    cj, ct, pj, tree = _model(case)
    pt = _port(case)
    mine = convert.params_to_numpy(TM.init_params(
        torch.Generator().manual_seed(0), ct, device="cpu"))
    assert [(n, x.shape) for n, x in _flat(mine)] == \
        [(n, x.shape) for n, x in _flat(tree)]
    bj, bt = _batch(cj, 2)
    np.testing.assert_array_equal(TM.lookup(pt, bt["sparse"], ct).numpy(),
                                  np.asarray(JM.lookup(pj, bj["sparse"], cj)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_grads_match_reference(case):
    cj, ct, pj, tree = _model(case)
    bj, bt = _batch(cj, 3)
    pt = _port(case)
    _close(TM.forward(pt, bt, ct).numpy(), JM.forward(pj, bj, cj))
    lj, gj = jax.value_and_grad(functools.partial(JM.loss_fn, cfg=cj))(pj, bj)
    leaves = [t for _, t in TC.tree_items(TM.make_trainable(pt))]
    loss = TM.loss_fn(pt, bt, ct)
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True))  # dense_proj
    gn = jax.tree_util.tree_map(np.asarray, gj)
    gt = jax.tree_util.tree_map(lambda _: next(gs).numpy(), gn)
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    _close_tree(gt, gn, atol_rel=1e-4)


@pytest.mark.parametrize("case", ["fm_dense", "dcn_v2", "autoint"])
def test_retrieval_score_matches_reference(case):
    cj, ct, pj, _ = _model(case)
    bj, bt = _batch(cj, 4, B=1)
    cand = np.arange(VOCAB, dtype=np.int32)[::-1].copy()
    got = TM.retrieval_score(_port(case), bt, torch.from_numpy(cand), ct)
    _close(got.numpy(), JM.retrieval_score(pj, bj, jnp.asarray(cand), cj))
    assert got.shape == (VOCAB,)


def test_fm_sum_square_trick():
    """The reference's check on the port: FM's pairwise term equals the
    explicit O(n^2) pairwise sum."""
    _, ct, _, _ = _model("fm")
    pt = _port("fm")
    sparse = torch.from_numpy(np.random.default_rng(5).integers(
        0, VOCAB, (3, 5)))
    got = TM._fm_forward(pt, {"sparse": sparse}, ct)
    emb = TM.lookup(pt, sparse, ct)
    pair = sum((emb[:, i] * emb[:, j]).sum(-1)
               for i in range(5) for j in range(i + 1, 5))
    lin = pt["linear_sparse"][(sparse + torch.arange(5) * VOCAB).reshape(
        -1)].reshape(3, 5).sum(-1)
    torch.testing.assert_close(got, pair + lin + pt["bias"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch_id", ["dcn-v2", "fm", "autoint"])
def test_train_step_matches_reference_jitted_step(arch_id):
    aj = JL.reduced_arch(JR.get(arch_id))
    at = TL.reduced_arch(TR.get(arch_id))
    key = jax.random.PRNGKey(0)
    pj = JM.init_params(key, aj.cfg)
    bt = TL.make_stream(at, 16, 0, seed=4).next()
    bj = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    loss_j = aj.loss_fn(lambda a, k: a)
    step_j = JTR.make_train_step(loss_j, aj.train_cfg)
    (sj, mj), g = jax.jit(lambda p, b: (
        step_j(JTR.init_state(key, p, aj.train_cfg), b),
        jax.grad(loss_j)(p, b)))(pj, bj)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   at.cfg, device="cpu")
    st, mt = TTR.make_train_step(at.loss_fn(), at.train_cfg)(
        TTR.init_state(0, pt, at.train_cfg), bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    params_close(convert.params_to_numpy(st.params),
                 jax.tree_util.tree_map(np.asarray, sj.params),
                 jax.tree_util.tree_map(np.asarray, g),
                 lr_sum=TO.lr_at(at.train_cfg.opt, 1))


@pytest.mark.parametrize("seed,step,n_dense", [(1, 0, 4), (3, 7, 0)])
def test_click_stream_on_reference_draws_equals_reference(seed, step,
                                                          n_dense):
    B, F, V = 256, 6, 1000
    ref = JD.ClickStream(JD.IteratorState(seed=seed, step=step), B, n_dense,
                         F, V).next()
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    k1, k2, k3 = jax.random.split(key, 3)
    got = TD.click_batch(
        torch.from_numpy(np.array(jax.random.randint(k1, (B, F), 0, V))),
        torch.from_numpy(np.array(jax.random.normal(k2, (B, n_dense)))),
        torch.from_numpy(np.array(jax.random.uniform(k3, (B,)))))
    assert set(got) == set(ref)
    for k in ref:
        assert str(got[k].dtype).split(".")[-1] == ref[k].dtype.name
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_click_stream_learnable_signal_and_determinism():
    """The reference's check on the port (ids divisible by 5 raise the
    click rate), and batch t a function of (seed, t)."""
    s = TD.ClickStream(TD.IteratorState(seed=1), 4096, 4, 6, 1000)
    b = s.next()
    assert b["sparse"].shape == (4096, 6) and b["dense"].shape == (4096, 4)
    feat = (b["sparse"] % 5 == 0).sum(-1)
    assert float(b["labels"][feat >= 3].mean()) > float(
        b["labels"][feat <= 1].mean())
    again = TD.ClickStream(TD.IteratorState(seed=1), 4096, 4, 6, 1000).next()
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(s.next()["sparse"], b["sparse"])
