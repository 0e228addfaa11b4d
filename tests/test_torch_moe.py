"""Port parity: the MoE block, the MoE transformer and the LM configs.

The reference's ``init_moe``/``init_params`` draw the parameters; their
numpy trees go into the port (``MoEParams``, ``params_from_numpy``).
Inputs come from numpy.

* ``moe_block`` on inputs whose router top-k is unambiguous (the gap
  between every pair of adjacent probabilities down to the (k+1)-th is
  above 1e-4, asserted): the choices EQUAL ``jax.lax.top_k``'s, the
  integer slots and drops EQUAL an independent numpy model of GShard
  slotting (a running count per expert and group), the output to rtol
  1e-5 with an atol of 1e-5 x its largest |value| (fp32 sums in another
  order), the aux loss to rtol 1e-6; also with drops forced by
  ``capacity_factor = 0.5``, over several groups, and in bfloat16 (the
  port's error against the reference's fp32 run at most 2x the
  reference's own bf16 error).
* The reference's ``test_moe_routing_mass_and_dropping`` and
  ``test_moe_capacity_drops_reduce_output`` on the port.
* A 2-layer reduced granite (G = 3, 8 experts top-2): ``forward`` (aux
  included), ``prefill`` and 10 ``decode_step``s with the exact cache
  and the ASH-KV cache (b = 4, d_code = d_head), as
  ``tests/test_torch_models.py`` holds the dense model: fp32 logits to
  1e-5 (exact cache) and 1e-4 (ASH-KV; codes EQUAL).
* Every ported config's fields (``remat`` included), ``param_count``
  and ``active_param_count`` EQUAL the reference's, and its
  ``TRAIN_CFG`` the reference arch's ``train_cfg`` field by field
  (dtype fields by name).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402


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
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _cfgs(**kw):
    return JM.MoEConfig(**kw), TM.MoEConfig(**kw)


def _port_params(p, dtype=torch.float32):
    return TM.MoEParams({
        k: torch.from_numpy(np.array(v, np.float32)).to(
            torch.float32 if k == "router" else dtype)
        for k, v in p.items()})


def _unambiguous_x(params, T, D, k, seed):
    """The first draw (seed, seed + 1, ...) whose router top-(k+1) gaps
    all exceed 1e-4, in float64."""
    router = np.asarray(params["router"], np.float64)
    for s in range(seed, seed + 100):
        x = np.random.default_rng(s).standard_normal((T, D)).astype(
            np.float32)
        lg = x.astype(np.float64) @ router
        p = np.exp(lg - lg.max(1, keepdims=True))
        p = -np.sort(-p / p.sum(1, keepdims=True), axis=1)
        if (p[:, :k] - p[:, 1:k + 1]).min() > 1e-4:
            return x
    raise AssertionError("no draw with an unambiguous top-k")


def _slot_model(top_e, E, cap, G):
    """GShard slots by a running count per (group, expert), pairs in
    (token, choice) order: slot e*cap + count, or E*cap past cap."""
    flat = np.asarray(top_e).reshape(-1, G * top_e.shape[1])
    slot = np.empty(flat.shape, np.int64)
    for g, pairs in enumerate(flat):
        count = np.zeros(E, np.int64)
        for j, e in enumerate(pairs):
            slot[g, j] = e * cap + count[e] if count[e] < cap else E * cap
            count[e] += 1
    return slot


@pytest.mark.parametrize("capacity_factor,group_size", [
    (1.25, 64), (0.5, 64), (1.25, 16), (0.5, 16)])
def test_moe_block_matches_reference(capacity_factor, group_size):
    E, k, T, D = 8, 3, 64, 24
    cj, ct = _cfgs(n_experts=E, top_k=k, d_ff=32,
                   capacity_factor=capacity_factor, group_size=group_size)
    p = JM.init_moe(jax.random.PRNGKey(0), cj, D)
    pt = _port_params(p)
    x = _unambiguous_x(p, T, D, k, seed=1)
    xt = torch.from_numpy(x)
    # the router's choices
    logits = jnp.asarray(x) @ p["router"]
    jp, je = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, tp, te = TM.route(pt, xt, ct)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    _close(tp, jp / jnp.sum(jp, axis=-1, keepdims=True))
    # slots and drops
    G = min(group_size, T)
    cap = TM.capacity(ct, G)
    assert cap == int((G * k * capacity_factor) / E) + 1
    slot, keep = TM.slots(te, ct, G)
    want = _slot_model(te.numpy(), E, cap, G)
    np.testing.assert_array_equal(slot.numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), want < E * cap)
    if capacity_factor < 1:
        assert (~keep).any()  # drops forced
    # output and aux
    oj, aj = JM.moe_block(p, jnp.asarray(x), cj)
    ot, at = TM.moe_block(pt, xt, ct)
    assert ot.dtype == torch.float32 and ot.shape == (T, D)
    _close(ot, oj)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


def test_moe_block_bf16_matches_reference():
    E, k, T, D = 8, 3, 64, 24
    cj, ct = _cfgs(n_experts=E, top_k=k, d_ff=32, group_size=32)
    p32 = JM.init_moe(jax.random.PRNGKey(4), cj, D)
    p16 = {n: (a if n == "router" else a.astype(jnp.bfloat16))
           for n, a in p32.items()}
    x = _unambiguous_x(p32, T, D, k, seed=7)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    want32, _ = JM.moe_block(
        {n: a.astype(jnp.float32) for n, a in p16.items()},
        x16.astype(jnp.float32), cj)
    want16, _ = JM.moe_block(p16, x16, cj)
    got, _ = TM.moe_block(_port_params(p16, torch.bfloat16),
                          torch.from_numpy(x).to(torch.bfloat16), ct)
    assert got.dtype == torch.bfloat16
    err_ref = np.abs(np.asarray(want16, np.float32)
                     - np.asarray(want32)).max()
    err = np.abs(got.float().numpy() - np.asarray(want32)).max()
    assert err <= 2.0 * err_ref, (err, err_ref)


def test_topk_ties_take_the_lower_expert():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_ff=4)
    pt = TM.MoEParams({"router": torch.zeros(3, 4),
                       "w_gate": torch.zeros(4, 3, 4),
                       "w_up": torch.zeros(4, 3, 4),
                       "w_down": torch.zeros(4, 4, 3)})
    _, _, te = TM.route(pt, torch.ones(5, 3), cfg)
    assert te.tolist() == [[0, 1]] * 5  # jax.lax.top_k's order


def test_moe_routing_mass_and_dropping():
    cj, ct = _cfgs(n_experts=4, top_k=2, d_ff=16, capacity_factor=10.0,
                   group_size=32)
    pt = _port_params(JM.init_moe(jax.random.PRNGKey(0), cj, 8))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (32, 8)).astype(np.float32))
    out, aux = TM.moe_block(pt, x, ct)
    assert out.shape == x.shape and float(aux) >= 0
    # generous capacity: no drops -> output invariant to token order
    perm = torch.from_numpy(np.random.default_rng(2).permutation(32))
    out_p, _ = TM.moe_block(pt, x[perm], ct)
    np.testing.assert_allclose(out_p.numpy(), out[perm].numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_capacity_drops_reduce_output():
    cj, hi_cfg = _cfgs(n_experts=2, top_k=2, d_ff=8, capacity_factor=10.0,
                       group_size=16)
    lo_cfg = dataclasses.replace(hi_cfg, capacity_factor=0.25)
    pt = _port_params(JM.init_moe(jax.random.PRNGKey(0), cj, 4))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (16, 4)).astype(np.float32))
    hi, _ = TM.moe_block(pt, x, hi_cfg)
    lo, _ = TM.moe_block(pt, x, lo_cfg)
    assert float(torch.linalg.norm(lo)) < float(torch.linalg.norm(hi))


def test_group_size_must_divide_tokens():
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_ff=8, group_size=8)
    pt = TM.init_moe(torch.Generator().manual_seed(0), cfg, 4)
    assert TM.moe_block(pt, torch.randn(16, 4), cfg)[0].shape == (16, 4)
    with pytest.raises(ValueError, match="groups of 8"):
        TM.moe_block(pt, torch.randn(12, 4), cfg)


# -- a reduced granite ------------------------------------------------------

BASE = dict(name="granite-tiny", n_layers=2, d_model=96, n_heads=6,
            n_kv_heads=2, d_ff=32, vocab=96)
MOE = dict(n_experts=8, top_k=2, d_ff=32, group_size=4096)
N_STEPS, BATCH, MAX_LEN = 10, 2, 12


def _model_cfgs(**kv):
    cj = JT.TransformerConfig(**BASE, moe=JM.MoEConfig(**MOE),
                              dtype=jnp.float32, param_dtype=jnp.float32,
                              remat=False, q_chunk=0, **kv)
    ct = TT.TransformerConfig(**BASE, moe=TM.MoEConfig(**MOE),
                              dtype=torch.float32,
                              param_dtype=torch.float32, q_chunk=0, **kv)
    return cj, ct


def _model_params(cj, ct, seed=0):
    pj = JT.init_params(jax.random.PRNGKey(seed), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, convert.params_from_numpy(tree, ct, device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], shape)


def test_reduced_granite_forward_and_prefill():
    cj, ct = _model_cfgs()
    pj, pt = _model_params(cj, ct)
    assert ct.head_dim == 16 and ct.n_heads // ct.n_kv_heads == 3
    assert isinstance(pt.layers[0].moe, TM.MoEParams)
    assert not hasattr(pt.layers[0], "w_gate")
    assert pt.layers[1].moe.router.dtype == torch.float32
    assert sum(p.numel() for p in pt.parameters()) == ct.param_count() \
        == cj.param_count()
    toks = _tokens(2, (2, 16))
    want, aux_j = JT.forward(pj, jnp.asarray(toks), cj)
    got, aux_t = TT.forward(pt, torch.from_numpy(toks), ct)
    _close(got, want)
    assert float(aux_t) > 0
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    _close(TT.prefill(pt, torch.from_numpy(toks), ct),
           JT.prefill(pj, jnp.asarray(toks), cj))


@pytest.mark.parametrize("kv", [{}, dict(kv_quant_bits=4)])
def test_reduced_granite_decode(kv):
    cj, ct = _model_cfgs(**kv)
    pj, pt = _model_params(cj, ct, seed=1)
    toks = _tokens(3, (BATCH, N_STEPS))
    cache_j = JT.init_cache(cj, BATCH, MAX_LEN)
    cache_t = TT.init_cache(ct, BATCH, MAX_LEN, device="cpu")
    lj, lt = [], []
    for t in range(N_STEPS):
        a, cache_j = JT.decode_step(pj, cache_j, jnp.asarray(toks[:, t]),
                                    jnp.int32(t), cj)
        b, cache_t = TT.decode_step(pt, cache_t, torch.from_numpy(toks[:, t]),
                                    t, ct)
        lj.append(np.asarray(a))
        lt.append(b.numpy())
    tol = 1e-4 if kv else 1e-5
    _close(np.stack(lt), np.stack(lj), rtol=tol, atol_rel=tol)
    if kv:
        back = convert.cache_to_numpy(cache_t)
        for name in ("k_codes", "v_codes"):
            np.testing.assert_array_equal(back[name],
                                          np.asarray(cache_j[name]))


def test_init_params_builds_moe_layers():
    _, ct = _model_cfgs(kv_quant_bits=4)
    pt = TT.init_params(torch.Generator().manual_seed(0), ct, device="cpu")
    lay = pt.layers[0].moe
    assert lay.router.shape == (96, 8) and lay.router.dtype == torch.float32
    assert lay.w_gate.shape == lay.w_up.shape == (8, 96, 32)
    assert lay.w_down.shape == (8, 32, 96)
    assert sum(p.numel() for p in pt.parameters()) - pt.kv_Wk.numel() \
        - pt.kv_Wv.numel() == ct.param_count()
    cache = TT.init_cache(ct, 2, 8, device="cpu")
    logits, _ = TT.decode_step(pt, cache, torch.tensor([1, 2]), 0, ct)
    assert logits.shape == (2, 96) and torch.isfinite(logits).all()


# -- configs ----------------------------------------------------------------

CONFIGS = ("granite_moe_3b", "deepseek_7b", "kimi_k2_1t", "qwen2_72b",
           "llama32_3b")
FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
          "vocab", "d_head", "qkv_bias", "rope_theta", "norm_eps",
          "remat", "q_chunk", "kv_quant_bits", "kv_quant_dim")


@pytest.mark.parametrize("mod", CONFIGS)
def test_config_equals_reference(mod):
    jc = importlib.import_module(f"repro.configs.{mod}").CFG
    port = importlib.import_module(f"repro_torch.configs.{mod}")
    tc = port.CFG
    for f in FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
    assert str(tc.param_dtype).split(".")[-1] == \
        jnp.dtype(jc.param_dtype).name
    if jc.moe is None:
        assert tc.moe is None
    else:
        assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tc.head_dim == jc.head_dim
    _same_fields(port.TRAIN_CFG, importlib.import_module(
        f"repro.configs.{mod}").ARCH.train_cfg)
    cell = port.ashkv_config()
    assert (cell.kv_quant_bits, cell.kv_quant_dim) == (4, 0)
    assert port.DECODE_32K_ASHKV == {"seq_len": 32768, "global_batch": 128,
                                     "kv_quant_bits": 4, "kv_quant_dim": 0}


def _same_fields(got, want):
    """Dataclass ``got`` equals ``want`` field by field, nested
    dataclasses recursively and dtype fields by name."""
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            _same_fields(a, b)
        elif isinstance(a, torch.dtype):
            assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        else:
            assert a == b, f.name
