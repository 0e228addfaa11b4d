"""Port parity: LM training (``repro_torch.train``, ``transformer.loss_fn``,
the losses of ``models.common``, ``data.synthetic.TokenStream``).

The config is the reference's ``tiny`` (``tests/test_train.py``: 2
layers, d_model 32, fp32), with ``remat`` off and on; parameters come
from the reference's ``init_params`` and cross with
``convert.params_from_numpy``; batches from numpy or the reference's
stream.  Tolerances:

* losses to rtol 1e-5; every gradient leaf to 1e-5 x its largest |g|
  (fp32 sums in another order);
* one or two optimizer steps on the SAME gradients: parameters to 1e-6
  absolute, fp32 state leaves to rtol 1e-5 with an atol of 1e-5 x the
  leaf's largest |value|, bf16 moments within one bf16 rounding
  (rtol 2^-7);
* a train step on each package's OWN gradients: loss to rtol 1e-5,
  parameters to 1e-6 absolute, except AdamW's m/sqrt(v) cases: an
  element whose clipped gradient is under 100 eps = 1e-6 (where
  g / (|g| + eps) turns with the last bits of g, which the two packages
  sum in other orders) may differ by up to twice the learning rate
  (they are counted and must be under 1 % of the elements);
* a 10-step AdamW loss trajectory to rtol 1e-4;
* bf16: the port's error against the reference's fp32 run at most
  twice the reference's own bf16 error (relative error of all
  gradients together; the loss also within one bf16 rounding, 2^-8
  relative, where the reference's own error is smaller);
* compression with the reference's Rademacher signs: codes EQUAL
  wherever the normalized value is more than 1e-6 from a midpoint,
  outputs and residuals to 1e-5 x their largest |value|;
* token streams and checkpoints both ways: EQUAL.

Then the reference's own ``tests/test_train.py`` cases run on the port.
"""
import dataclasses
import functools
import json
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic as JD  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JCK  # noqa: E402
from repro.train import compression as JZ  # noqa: E402
from repro.train import optim as JO  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import checkpoint as TCK  # noqa: E402
from repro_torch.train import compression as TZ  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small products (with
    several test processes at once, torch's default thread count makes
    each tiny op wait on the others; restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- helpers ----------------------------------------------------------------

TINY = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_ff=64, vocab=128, q_chunk=0)
MOE = dict(n_experts=8, top_k=2, d_ff=32, group_size=4096)


def _cfgs(remat=False, moe=False, dtype="float32", **kw):
    """The reference's tiny config in both packages: (JAX, port)."""
    base = dict(TINY, remat=remat, **kw)
    cj = JT.TransformerConfig(
        **base, moe=JM.MoEConfig(**MOE) if moe else None,
        dtype=getattr(jnp, dtype), param_dtype=getattr(jnp, dtype))
    ct = TT.TransformerConfig(
        **base, moe=TM.MoEConfig(**MOE) if moe else None,
        dtype=getattr(torch, dtype), param_dtype=getattr(torch, dtype))
    return cj, ct


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(pj, ct):
    """The reference's parameters carried into a port model."""
    return convert.params_from_numpy(_np(pj), ct, device="cpu")


def _flat(tree):
    """[(name, float64 array)] of a parameter-like tree, reference order."""
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float64))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tensors(tree):
    """A nested numpy dict as tensors (fp32 leaves stay fp32)."""
    return jax.tree_util.tree_map(
        lambda x: convert.tensor_from_numpy(np.asarray(x)), tree)


def _tokens(seed, shape, vocab=TINY["vocab"]):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _batches(toks):
    """The same batch for the reference and for the port."""
    t = torch.from_numpy(toks)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": t, "labels": t})


def _close_tree(got, want, rtol=1e-5, atol_rel=1e-5, atol=0.0):
    for (name, a), (name_w, b) in zip(_flat(got), _flat(want), strict=True):
        assert name == name_w
        assert a.shape == b.shape, name
        tol = atol + atol_rel * max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=name)


def _port_loss_and_grads(pt, ct, batch):
    """(loss, the reference-layout gradient tree as numpy)."""
    TT.make_trainable(pt)
    leaves = TT.train_leaves(pt)
    flat = [t for _, ts in leaves for t in ts]
    loss = TT.loss_fn(pt, batch, ct)
    gs = iter(torch.autograd.grad(loss, flat))
    out = {}
    for path, ts in leaves:
        g = [next(gs).float() for _ in ts]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (torch.stack(g) if path[0] == "layers"
                          else g[0]).numpy()
    return float(loss), out


def _params_close(got, want, grads, lr_sum, atol=1e-6):
    """Parameters to ``atol``, except AdamW's m/sqrt(v) cases (see the
    module docstring; ``grads`` before clipping to norm 1); returns how
    many such elements there were."""
    cases = 0
    gn = math.sqrt(sum(float((g ** 2).sum()) for _, g in _flat(grads)))
    for (name, a), (_, b), (_, g) in zip(_flat(got), _flat(want),
                                         _flat(grads), strict=True):
        bad = np.abs(a - b) > atol
        tiny = np.abs(g) * min(1.0, 1.0 / gn) < 1e-6
        assert not (bad & ~tiny).any(), (name, np.abs(a - b).max())
        assert (np.abs(a - b) <= 2 * lr_sum + atol).all(), name
        cases += int(bad.sum())
    total = sum(x.size for _, x in _flat(want))
    assert cases <= 0.01 * total, cases
    return cases


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cj):
    return jax.jit(jax.value_and_grad(functools.partial(JT.loss_fn, cfg=cj)))


@functools.lru_cache(maxsize=None)
def _jax_step(cj, tcfg):
    return jax.jit(JTR.make_train_step(functools.partial(JT.loss_fn, cfg=cj),
                                       tcfg))


def _tcfgs(name="adamw", k=1, lr=1e-3, warmup=1, **opt):
    """The same TrainConfig in both packages: (JAX, port)."""
    jopt = {k_: (getattr(jnp, v) if k_ == "moment_dtype" else v)
            for k_, v in opt.items()}
    topt = {k_: (getattr(torch, v) if k_ == "moment_dtype" else v)
            for k_, v in opt.items()}
    tj = JTR.TrainConfig(opt=JO.OptConfig(name=name, lr=lr,
                                          warmup_steps=warmup,
                                          total_steps=200, **jopt),
                         microbatches=k)
    tt = TTR.TrainConfig(opt=TO.OptConfig(name=name, lr=lr,
                                          warmup_steps=warmup,
                                          total_steps=200, **topt),
                         microbatches=k)
    return tj, tt


# -- losses, loss_fn and its gradients ---------------------------------------


@pytest.mark.parametrize("case", ["ce", "ce_mask", "bce"])
def test_cross_entropies_match_reference(case):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (4, 7)).astype(np.int32)
    if case == "bce":
        y = rng.integers(0, 2, (4, 7)).astype(np.float32)
        want = JC.binary_cross_entropy(jnp.asarray(logits[..., 0]),
                                       jnp.asarray(y))
        got = TC.binary_cross_entropy(torch.from_numpy(logits[..., 0]),
                                      torch.from_numpy(y))
    else:
        mask = (rng.random((4, 7)) < 0.6).astype(np.float32) \
            if case == "ce_mask" else None
        want = JC.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask))
        got = TC.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_loss_and_grads_match_reference(moe, remat):
    """loss_fn and every gradient leaf; the MoE model (8 experts top-2)
    on a draw whose every router top-3 gap exceeds 1e-4 (checked on the
    reference's hidden states: routing is unambiguous)."""
    cj, ct = _cfgs(remat=remat, moe=moe)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    toks = _tokens(1, (4, 16))
    pt = _port(pj, ct)
    if moe:
        _assert_unambiguous_routing(pt, ct, toks)
    bj, bt = _batches(toks)
    lj, gj = _jax_value_and_grad(cj)(pj, bj)
    lt, gt = _port_loss_and_grads(pt, ct, bt)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    _close_tree(gt, _np(gj), rtol=0.0, atol_rel=1e-5)


def _assert_unambiguous_routing(pt, ct, toks):
    """Every layer's router top-(k+1) probabilities of these tokens are
    more than 1e-4 apart, in float64 on the port's hidden states (the
    reference's to 1e-5: both packages route alike)."""
    seen = []
    orig = TT.moe_block

    def spy(params, x, cfg, **kw):
        p = torch.softmax(x.double() @ params.router.double(), dim=-1)
        seen.append(-np.sort(-p.detach().numpy(), axis=-1))
        return orig(params, x, cfg, **kw)

    TT.moe_block = spy
    try:
        TT.forward(pt, torch.from_numpy(toks), ct)
    finally:
        TT.moe_block = orig
    k = ct.moe.top_k
    assert len(seen) == ct.n_layers
    for p in seen:
        assert (p[:, :k] - p[:, 1:k + 1]).min() > 1e-4


# -- the token stream --------------------------------------------------------


def test_token_stream_recurrence_equals_reference():
    """markov_tokens on the reference's own draws gives its tokens."""
    seed, B, S, V = 5, 8, 16, 128
    js = JD.TokenStream(JD.IteratorState(seed=seed), B, S, V)
    for step in range(3):
        want = np.asarray(js.next()["tokens"])
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        k1, k2 = jax.random.split(key)
        start = np.asarray(jax.random.randint(k1, (B, 1), 0, V))
        steps = np.asarray(jax.random.randint(k2, (B, S - 1), 0, 7))
        got = TD.markov_tokens(torch.from_numpy(start[:, 0]),
                               torch.from_numpy(steps), V)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_token_stream_is_a_function_of_seed_and_step():
    a = TD.TokenStream(TD.IteratorState(seed=7), 4, 32, 1000)
    first = [a.next() for _ in range(3)]
    b = TD.TokenStream(TD.IteratorState.from_dict(
        {"seed": 7, "step": 1}), 4, 32, 1000)
    assert torch.equal(b.next()["tokens"], first[1]["tokens"])
    assert a.state.to_dict() == {"seed": 7, "step": 3}
    t = first[0]["tokens"]
    assert t.shape == (4, 32) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    assert torch.equal(first[0]["labels"], t)
    nxt = (t[:, :-1].long() * 31 + torch.arange(7)[:, None, None]) % 1000
    assert (nxt == t[:, 1:].long()).any(0).all()  # a step in [0, 7)
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])


# -- optimizers --------------------------------------------------------------

OPTS = {
    "adamw": dict(name="adamw"),
    "adamw_bf16_moments": dict(name="adamw", moment_dtype="bfloat16"),
    "adafactor": dict(name="adafactor"),
    "adafactor_b1_0_bf16": dict(name="adafactor", b1=0.0,
                                moment_dtype="bfloat16"),
    "muon": dict(name="muon"),
}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_optimizer_steps_match_reference(opt):
    """Two updates on the same gradients (the tiny model's, then half of
    them), with QKV biases: every parameter and state leaf, including
    the (L, D) norm scales that Adafactor factors over layers and that
    Muon orthogonalizes as L x D matrices."""
    kw = dict(OPTS[opt])
    name = kw.pop("name")
    cj, ct = _cfgs(qkv_bias=True)
    pj = JT.init_params(jax.random.PRNGKey(2), cj)
    bj, _ = _batches(_tokens(4, (4, 16)))
    _, gj = _jax_value_and_grad(cj)(pj, bj)
    tj, tt = _tcfgs(name=name, lr=1e-2, **kw)
    j_init, j_update = JO.make_optimizer(tj.opt)
    j_update = jax.jit(j_update)
    t_init, t_update = TO.make_optimizer(tt.opt)
    pt = _port(pj, ct)
    tree = TT.make_trainable(pt)
    sj, st = j_init(pj), t_init(tree)
    for scale in (1.0, 0.5):
        g = jax.tree_util.tree_map(lambda x: x * scale, gj)
        uj, sj = j_update(g, sj, pj)
        pj = JO.apply_updates(pj, uj)
        ut, st = t_update(_tensors(_np(g)), st, tree)
        TO.apply_updates(tree, ut)
    _close_tree(convert.params_to_numpy(pt), _np(pj), rtol=0.0,
                atol_rel=0.0, atol=1e-6)
    got, want = TCK.state_to_numpy(st), _np(sj)
    assert type(got).__name__ == type(want).__name__
    assert int(got.step) == int(want.step) == 2
    bf16 = kw.get("moment_dtype") == "bfloat16"
    for field in want._fields[1:]:
        rtol = 2.0 ** -7 if bf16 and field == "mu" else 1e-5
        _close_tree(getattr(got, field), getattr(want, field), rtol=rtol)
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(
                getattr(got, field)), jax.tree_util.tree_leaves_with_path(
                getattr(want, field))):
            assert np.asarray(a).dtype == np.asarray(b).dtype


def test_adafactor_momentum_free_state_matches_reference():
    cj, ct = _cfgs(qkv_bias=True)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    tj, tt = _tcfgs(name="adafactor", b1=0.0)
    want = _np(JO.adafactor_init(tj.opt, pj))
    got = TCK.state_to_numpy(TO.adafactor_init(
        tt.opt, TT.make_trainable(_port(pj, ct))))
    for field in want._fields[1:]:
        wl = jax.tree_util.tree_leaves(getattr(want, field))
        gl = jax.tree_util.tree_leaves(getattr(got, field))
        assert [x.shape for x in gl] == [x.shape for x in wl], field
    assert all(x.shape == (1,) for x in jax.tree_util.tree_leaves(got.mu))


def test_lr_global_norm_and_clip_match_reference():
    cfg_j = JO.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    cfg_t = TO.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    for s in (0, 1, 7, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        np.testing.assert_allclose(TO.lr_at(cfg_t, s),
                                   float(JO.lr_at(cfg_j, jnp.int32(s))),
                                   rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32) * 3}}
    np.testing.assert_allclose(float(TO.global_norm(_tensors(tree))),
                               float(JO.global_norm(tree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        want, gn_j = JO.clip_by_global_norm(tree, max_norm)
        got, gn_t = TO.clip_by_global_norm(_tensors(tree), max_norm)
        np.testing.assert_allclose(float(gn_t), float(gn_j), rtol=1e-6)
        _close_tree(jax.tree_util.tree_map(lambda t: t.numpy(), got),
                    _np(want), rtol=1e-6, atol_rel=0.0)


# -- the train step ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_train_step_microbatches_match_reference(k):
    """One train step at k microbatches (interleaved rows) in both
    packages, each on its own gradients."""
    cj, ct = _cfgs()
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    toks = _tokens(9, (8, 16))
    bj, bt = _batches(toks)
    tj, tt = _tcfgs(k=k)
    sj, mj = _jax_step(cj, tj)(JTR.init_state(jax.random.PRNGKey(0), pj, tj),
                               bj)
    pt = _port(pj, ct)
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tt)
    st, mt = step(TTR.init_state(0, pt, tt), bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    assert int(mt["step"]) == int(mj["step"]) == 1
    _, g = _jax_value_and_grad(cj)(pj, bj)
    _params_close(convert.params_to_numpy(pt), _np(sj.params), _np(g),
                  lr_sum=TO.lr_at(tt.opt, 1))


def test_microbatch_split_is_interleaved():
    """Microbatch m holds rows m, m + k, ...: the loss of k = 2 is the
    mean of the two interleaved halves' losses."""
    _, ct = _cfgs()
    cj, _ = _cfgs()
    pt = _port(JT.init_params(jax.random.PRNGKey(0), cj), ct)
    toks = torch.from_numpy(_tokens(2, (4, 16)))
    halves = [float(TT.loss_fn(pt, {"tokens": toks[m::2],
                                    "labels": toks[m::2]}, ct))
              for m in range(2)]
    _, tt = _tcfgs(k=2)
    _, m = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tt)(
        TTR.init_state(0, pt, tt), {"tokens": toks, "labels": toks})
    assert float(m["loss"]) == np.float32(
        np.float32(halves[0] / 2) + np.float32(halves[1] / 2))


def test_adamw_trajectory_matches_reference():
    """10 AdamW steps on the reference's stream: every loss to 1e-4."""
    cj, ct = _cfgs()
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    tj, tt = _tcfgs(warmup=2)
    sj = JTR.init_state(jax.random.PRNGKey(0), pj, tj)
    st = TTR.init_state(0, _port(pj, ct), tt)
    step_t = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tt)
    stream = JD.TokenStream(JD.IteratorState(seed=5), 8, 16, 128)
    lj, lt = [], []
    for _ in range(10):
        toks = np.asarray(stream.next()["tokens"])
        bj, bt = _batches(toks)
        sj, mj = _jax_step(cj, tj)(sj, bj)
        st, mt = step_t(st, bt)
        lj.append(float(mj["loss"]))
        lt.append(float(mt["loss"]))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert int(st.step) == 10


def test_bf16_within_twice_the_reference_bf16_error():
    """bf16 loss and gradients: the port's distance to the reference's
    fp32 run at most twice the reference's own bf16 distance."""
    cj32, _ = _cfgs()
    cj16, ct16 = _cfgs(dtype="bfloat16")
    toks = _tokens(6, (4, 16))
    bj, bt = _batches(toks)
    p32 = JT.init_params(jax.random.PRNGKey(0), cj32)
    p16 = JT.init_params(jax.random.PRNGKey(0), cj16)
    l32, g32 = _jax_value_and_grad(cj32)(p32, bj)
    lj16, gj16 = _jax_value_and_grad(cj16)(p16, bj)
    lt16, gt16 = _port_loss_and_grads(_port(p16, ct16), ct16, bt)

    def rel(got):
        a = np.concatenate([x.ravel() for _, x in _flat(got)])
        b = np.concatenate([x.ravel() for _, x in _flat(_np(g32))])
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(gt16) <= 2 * rel(_np(gj16)), (rel(gt16), rel(_np(gj16)))
    ref_err = abs(float(lj16) - float(l32))
    assert abs(lt16 - float(l32)) <= max(2 * ref_err,
                                         2.0 ** -8 * abs(float(l32)))


# -- compression -------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=2)
def _jax_codes(key, g, cfg):
    """The reference's codes and normalized values (its own steps)."""
    B = cfg.block
    n_pad = -(-g.shape[0] // B) * B
    x = jnp.pad(g.astype(jnp.float32), (0, n_pad - g.shape[0])).reshape(-1, B)
    y = JZ._hadamard(x * JZ._rand_signs(key, B)[None, :])
    grid = jnp.asarray(JZ.lloyd_max_grid_np(cfg.bits))
    norm = jnp.linalg.norm(y, axis=-1, keepdims=True)
    yn = y / jnp.maximum(norm, 1e-12) * jnp.sqrt(jnp.float32(B))
    mids = (grid[1:] + grid[:-1]) / 2.0
    return jnp.searchsorted(mids, yn), yn, mids


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_compress_decompress_matches_reference(bits):
    g = np.random.default_rng(bits).standard_normal(5000).astype(np.float32)
    key = jax.random.PRNGKey(77)
    cfg_j = JZ.CompressionConfig(bits=bits, enabled=True)
    cfg_t = TZ.CompressionConfig(bits=bits, enabled=True)
    signs = torch.from_numpy(np.asarray(JZ._rand_signs(key, 2048)))
    want_codes, yn, mids = map(np.asarray,
                               _jax_codes(key, jnp.asarray(g), cfg_j))
    codes, _, yn_t = TZ.encode_blocks(torch.from_numpy(g), cfg_t, signs)
    np.testing.assert_allclose(yn_t.numpy(), yn, rtol=0, atol=1e-5)
    near = (np.abs(yn[..., None] - mids) <= 1e-6).any(-1)
    assert (codes.numpy() == want_codes)[~near].all()
    want = np.asarray(jax.jit(JZ.compress_decompress, static_argnums=2)(
        key, jnp.asarray(g), cfg_j))
    got = TZ.compress_decompress(torch.from_numpy(g), cfg_t, signs)
    assert got.dtype == torch.float32 and got.shape == (5000,)
    if not near.any():
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_compress_tree_matches_reference():
    """Two rounds of compress_tree with error feedback over the tiny
    model's gradient tree, leaf i with fold_in(key, i)'s signs."""
    cj, _ = _cfgs()
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    bj, _ = _batches(_tokens(1, (4, 16)))
    _, gj = _jax_value_and_grad(cj)(pj, bj)
    cfg_j = JZ.CompressionConfig(bits=2, enabled=True)
    cfg_t = TZ.CompressionConfig(bits=2, enabled=True)
    ef_j = JZ.ef_init(pj)
    ef_t = TZ.ef_init(_tensors(_np(pj)))
    j_compress = jax.jit(JZ.compress_tree, static_argnums=3)
    for rnd in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(3), rnd)
        n = len(jax.tree_util.tree_leaves(gj))
        signs = [torch.from_numpy(np.asarray(JZ._rand_signs(
            jax.random.fold_in(key, i), 2048))) for i in range(n)]
        want, ef_j = j_compress(key, gj, ef_j, cfg_j)
        got, ef_t = TZ.compress_tree(0, _tensors(_np(gj)), ef_t, cfg_t,
                                     signs=signs)
        to_np = functools.partial(jax.tree_util.tree_map,
                                  lambda t: t.numpy())
        _close_tree(to_np(got), _np(want), rtol=0.0)
        _close_tree(to_np(ef_t.residual), _np(ef_j.residual), rtol=0.0)


def test_compression_in_the_train_step_uses_the_step_key():
    """With compression on, a step equals, bit for bit: the gradients,
    compress_tree at fold_seed(seed, step) (leaf i then at
    fold_seed(that, i)), then the optimizer."""
    cj, ct = _cfgs()
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    toks = torch.from_numpy(_tokens(3, (4, 16)))
    batch = {"tokens": toks, "labels": toks}
    tcfg = TTR.TrainConfig(opt=TO.OptConfig(lr=1e-3, warmup_steps=1),
                           compression=TZ.CompressionConfig(enabled=True))
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tcfg)
    s = TTR.init_state(11, _port(pj, ct), tcfg)
    s, _ = step(s, batch)  # step 0 -> 1
    ref = TTR.init_state(11, _port(pj, ct), tcfg)
    _, g = _port_loss_and_grads(ref.params, ct, batch)
    g, ef = TZ.compress_tree(TD.fold_seed(11, 0), _tensors(g), ref.ef_state,
                             tcfg.compression)
    updates, _ = TO.make_optimizer(tcfg.opt)[1](g, ref.opt_state,
                                                ref.params.tree)
    TO.apply_updates(ref.params.tree, updates)
    for (_, a), (_, b) in zip(_flat(convert.params_to_numpy(s.params)),
                              _flat(convert.params_to_numpy(ref.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TO.tree_leaves(s.ef_state.residual),
                    TO.tree_leaves(ef.residual)):
        assert torch.equal(a, b)
    assert any(float(r.abs().max()) > 0 for r in TO.tree_leaves(ef.residual))
    assert TTR.key_seed(s.rng) == 11 and int(s.step) == 1


# -- checkpoints -------------------------------------------------------------


def _ckpt_setup():
    cj, ct = _cfgs()
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    tj, tt = _tcfgs(warmup=2)
    return cj, ct, pj, tj, tt


def _batch_np(i):
    return _tokens(100 + i, (8, 16))


def test_reference_checkpoint_restores_into_port(tmp_path):
    """The reference trains 2 steps and saves; the port restores into a
    fresh state (every leaf EQUAL) and one more step agrees."""
    cj, ct, pj, tj, tt = _ckpt_setup()
    sj = JTR.init_state(jax.random.PRNGKey(0), pj, tj)
    for i in range(2):
        sj, _ = _jax_step(cj, tj)(sj, _batches(_batch_np(i))[0])
    JCK.CheckpointManager(str(tmp_path), async_save=False).save(
        2, sj, extra={"seed": 0, "step": 2})
    st = TTR.init_state(0, _port(JT.init_params(jax.random.PRNGKey(1), cj),
                                 ct), tt)
    st, extra = TCK.CheckpointManager(str(tmp_path)).restore(st)
    assert extra == {"seed": 0, "step": 2}
    names = TCK._flatten_with_paths(st)
    want = JCK._flatten_with_paths(_np(sj))
    assert list(names) == list(want)
    for name, t in names.items():
        a = convert._numpy(t)
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(a, want[name], err_msg=name)
    bj, bt = _batches(_batch_np(2))
    _, g = _jax_value_and_grad(cj)(sj.params, bj)
    sj, mj = _jax_step(cj, tj)(sj, bj)
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tt)
    st, mt = step(st, bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    assert int(st.step) == int(sj.step) == 3
    _params_close(convert.params_to_numpy(st.params), _np(sj.params),
                  _np(g), lr_sum=TO.lr_at(tt.opt, 3))


def test_port_checkpoint_restores_into_reference(tmp_path):
    """The port trains 2 steps and saves (async); the reference restores
    it into its own template (every leaf EQUAL) and one more step
    agrees."""
    cj, ct, pj, tj, tt = _ckpt_setup()
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tt)
    st = TTR.init_state(0, _port(pj, ct), tt)
    for i in range(2):
        st, _ = step(st, _batches(_batch_np(i))[1])
    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save(2, st, extra={"seed": 0})
    mgr.wait()
    manifest = json.loads((tmp_path / "step_0000000002" /
                           "manifest.json").read_text())
    assert manifest["arrays"][".rng"]["dtype"] == "uint32"
    assert manifest["arrays"][".step"]["dtype"] == "int32"
    template = JTR.init_state(jax.random.PRNGKey(0),
                              JT.init_params(jax.random.PRNGKey(1), cj), tj)
    sj, extra = JCK.CheckpointManager(str(tmp_path)).restore(template)
    assert extra == {"seed": 0}
    want = TCK._flatten_with_paths(st)
    for name, a in JCK._flatten_with_paths(_np(sj)).items():
        np.testing.assert_array_equal(a, convert._numpy(want[name]),
                                      err_msg=name)
    bj, bt = _batches(_batch_np(2))
    _, g = _jax_value_and_grad(cj)(sj.params, bj)
    sj, mj = _jax_step(cj, tj)(sj, bj)
    st, mt = step(st, bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    _params_close(convert.params_to_numpy(st.params), _np(sj.params),
                  _np(g), lr_sum=TO.lr_at(tt.opt, 3))


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "muon"])
def test_state_from_numpy_carries_the_reference_state(opt):
    """The reference's optimizer state after a step, carried across with
    ``state_from_numpy``, gives the reference's next update."""
    cj, ct = _cfgs(qkv_bias=True)
    pj = JT.init_params(jax.random.PRNGKey(0), cj)
    _, gj = _jax_value_and_grad(cj)(pj, _batches(_tokens(8, (4, 16)))[0])
    tj, tt = _tcfgs(name=opt, lr=1e-2)
    j_init, j_update = JO.make_optimizer(tj.opt)
    j_update = jax.jit(j_update)
    uj, sj = j_update(gj, j_init(pj), pj)
    pj = JO.apply_updates(pj, uj)
    st = TCK.state_from_numpy(_np(sj), device="cpu")
    assert type(st) is getattr(TO, type(sj).__name__)
    pt = _port(pj, ct)
    tree = TT.make_trainable(pt)
    ut, st = TO.make_optimizer(tt.opt)[1](_tensors(_np(gj)), st, tree)
    TO.apply_updates(tree, ut)
    uj, sj = j_update(gj, sj, pj)
    _close_tree(convert.params_to_numpy(pt), _np(JO.apply_updates(pj, uj)),
                rtol=0.0, atol_rel=0.0, atol=1e-6)
    assert int(st.step) == 2


# -- the reference's tests/test_train.py on the port -------------------------


@pytest.fixture(scope="module")
def tiny():
    cj, ct = _cfgs()
    return ct, _port(JT.init_params(jax.random.PRNGKey(0), cj), ct)


def _fresh(tiny):
    ct, pt = tiny
    return ct, convert.params_from_numpy(convert.params_to_numpy(pt), ct,
                                         device="cpu")


def _stream(seed):
    return TD.TokenStream(TD.IteratorState(seed=seed), 8, 16, 128)


@pytest.mark.parametrize("opt,lr", [("adamw", 1e-3), ("adafactor", 1e-2),
                                    ("muon", 2e-3)])
def test_optimizers_decrease_loss(tiny, opt, lr):
    ct, params = _fresh(tiny)
    tcfg = TTR.TrainConfig(opt=TO.OptConfig(name=opt, lr=lr, warmup_steps=2,
                                            total_steps=200))
    state = TTR.init_state(0, params, tcfg)
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tcfg)
    stream = _stream(5)
    losses = []
    for _ in range(30):
        state, m = step(state, stream.next())
        losses.append(float(m["loss"]))
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first, (opt, first, last)


def test_adafactor_momentum_free_state(tiny):
    ct, params = _fresh(tiny)
    tcfg = TTR.TrainConfig(opt=TO.OptConfig(name="adafactor", b1=0.0))
    state = TTR.init_state(0, params, tcfg)
    # b1=0: mu buffers are dummy (1,)-shaped -- the 1T memory saving
    for leaf in TO.tree_leaves(state.opt_state.mu):
        assert leaf.shape == (1,)


def test_microbatch_grad_equivalence(tiny):
    """k=1 vs k=4 gradient accumulation: same update (fp32)."""
    ct, _ = tiny
    batch = _stream(9).next()

    def grads_with(k):
        _, params = _fresh(tiny)
        tcfg = TTR.TrainConfig(opt=TO.OptConfig(lr=1e-3), microbatches=k)
        state = TTR.init_state(0, params, tcfg)
        step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct),
                                   tcfg)
        new_state, m = step(state, batch)
        return convert.params_to_numpy(new_state.params), float(m["loss"])

    p1, l1 = grads_with(1)
    p4, l4 = grads_with(4)
    assert abs(l1 - l4) < 1e-4
    for (_, a), (_, b) in zip(_flat(p1), _flat(p4)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)


def test_checkpoint_restart_bitwise(tiny, tmp_path):
    ct, params = _fresh(tiny)
    tcfg = TTR.TrainConfig(opt=TO.OptConfig(lr=1e-3))
    state = TTR.init_state(0, params, tcfg)
    step = TTR.make_train_step(functools.partial(TT.loss_fn, cfg=ct), tcfg)
    stream = _stream(3)
    mgr = TCK.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for _ in range(3):
        state, _ = step(state, stream.next())
    mgr.save(3, state, extra=stream.state.to_dict())

    cont = []
    s2 = state
    for _ in range(3):
        s2, m = step(s2, stream.next())
        cont.append(float(m["loss"]))

    restored, extra = mgr.restore(state)
    stream2 = TD.TokenStream(TD.IteratorState.from_dict(extra), 8, 16, 128)
    replay = []
    for _ in range(3):
        restored, m = step(restored, stream2.next())
        replay.append(float(m["loss"]))
    assert cont == replay  # bitwise-deterministic restart


def test_checkpoint_atomic_commit_and_gc(tiny, tmp_path):
    _, params = _fresh(tiny)
    state = TTR.init_state(0, params, TTR.TrainConfig())
    mgr = TCK.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]  # GC kept last 2
    # a dir without COMMIT marker is invisible
    src = tmp_path / "step_0000000004"
    dst = tmp_path / "step_0000000009"
    shutil.copytree(src, dst)
    os.remove(dst / "COMMIT")
    assert mgr.latest_step() == 4
    assert not any(p.name.startswith(".tmp_step_") for p in tmp_path.iterdir())


def test_checkpoint_bfloat16_roundtrip(tmp_path):
    """Saved bf16 bits come back EQUAL into a zeroed template of the same
    structure, and the reference reads them as bfloat16."""
    tree = {"a": torch.arange(7, dtype=torch.bfloat16) / 3,
            "b": {"c": torch.tensor(2.5)}}
    mgr = TCK.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree)
    template = {"a": torch.zeros(7, dtype=torch.bfloat16),
                "b": {"c": torch.tensor(0.0)}}
    restored, _ = mgr.restore(template)
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], tree["a"])
    assert float(restored["b"]["c"]) == 2.5
    jt, _ = JCK.CheckpointManager(str(tmp_path)).restore(
        {"a": jnp.zeros(7, jnp.bfloat16), "b": {"c": jnp.float32(0)}})
    assert jt["a"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jt["a"]),
                                  convert._numpy(tree["a"]))


def test_restore_refuses_a_mismatched_template(tiny, tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="template"):
        mgr.restore({"a": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(FileNotFoundError):
        TCK.CheckpointManager(str(tmp_path / "empty")).restore({})


def test_hadamard_orthogonal():
    x = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (4, 256))))
    y = TZ._hadamard(x)
    np.testing.assert_allclose(torch.linalg.norm(y, dim=-1).numpy(),
                               torch.linalg.norm(x, dim=-1).numpy(),
                               rtol=1e-5)
    # involution: H(H(x)) = x
    np.testing.assert_allclose(TZ._hadamard(y).numpy(), x.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.jit(JZ._hadamard)(
        jnp.asarray(x.numpy()))), atol=1e-5)


@pytest.mark.parametrize("bits,max_rel", [(1, 0.75), (2, 0.45), (4, 0.15)])
def test_compression_error_bounds(bits, max_rel):
    g = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(1), (8192,))))
    ghat = TZ.compress_decompress(
        g, TZ.CompressionConfig(bits=bits, enabled=True),
        TZ.rand_signs(77, 2048))
    rel = float(torch.linalg.norm(ghat - g) / torch.linalg.norm(g))
    assert rel < max_rel, rel


def test_compression_with_error_feedback_converges():
    """EF: repeated compression of a CONSTANT gradient converges to it."""
    g = {"w": torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.PRNGKey(2), (2048,))))}
    cfg = TZ.CompressionConfig(bits=1, enabled=True, error_feedback=True)
    ef = TZ.ef_init(g)
    acc = torch.zeros_like(g["w"])
    n = 30
    for i in range(n):
        out, ef = TZ.compress_tree(i, g, ef, cfg)
        acc = acc + out["w"]
    mean = acc / n
    rel = float(torch.linalg.norm(mean - g["w"]) / torch.linalg.norm(g["w"]))
    assert rel < 0.15, rel  # EF kills the bias


def test_lr_schedule_shape():
    cfg = TO.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [TO.lr_at(cfg, s) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]  # warmup
    assert lrs[2] >= lrs[3] >= lrs[4]  # cosine decay
    assert lrs[4] >= 0.1 * 0.9  # floor


def test_grad_clip():
    tree = {"a": torch.full((10,), 100.0)}
    clipped, gn = TO.clip_by_global_norm(tree, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(gn) > 100.0
    assert clipped["a"] is tree["a"]  # in place


def test_make_trainable_views_share_the_stacked_tree(tiny):
    ct, pt = _fresh(tiny)
    tree = TT.make_trainable(pt)
    assert TT.make_trainable(pt) is tree
    assert tree["layers"]["wq"].shape == (2, 32, 32)
    with torch.no_grad():
        tree["layers"]["wq"][1].add_(1.0)
    assert torch.equal(pt.layers[1].wq, tree["layers"]["wq"][1])
    assert all(p.requires_grad for p in pt.parameters())
    assert sum(p.numel() for p in pt.parameters()) == ct.param_count()
    assert [p for p, _ in TT.train_leaves(pt)] == TT.leaf_paths(ct)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(convert.params_to_numpy(
                 pt))[0]]
    assert names == [jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(JT.init_params(
                         jax.random.PRNGKey(0), _cfgs()[0]))[0]]


def test_serving_forward_stays_without_grad(tiny):
    """forward/prefill keep no graph on a trainable model, and remat
    gives the same loss and gradients as no remat."""
    ct, pt = _fresh(tiny)
    TT.make_trainable(pt)
    toks = torch.from_numpy(_tokens(0, (2, 8)))
    logits, _ = TT.forward(pt, toks, ct)
    assert not logits.requires_grad
    batch = {"tokens": toks, "labels": toks}
    l0, g0 = _port_loss_and_grads(pt, ct, batch)
    l1, g1 = _port_loss_and_grads(
        pt, dataclasses.replace(ct, remat=True), batch)
    assert l0 == l1
    for (_, a), (_, b) in zip(_flat(g0), _flat(g1)):
        np.testing.assert_array_equal(a, b)
    assert math.isfinite(l0)
