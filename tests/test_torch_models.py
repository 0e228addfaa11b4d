"""Port parity: the dense transformer's serving path against JAX.

A 2-layer model (d_model 64, 4 heads, 2 KV heads, d_head 16) is drawn
by the reference's ``init_params``; its numpy tree goes through
``convert.params_from_numpy`` into the port.  Tokens come from numpy.
Both packages then run the building blocks, ``forward``/``prefill`` and
10 ``decode_step``s from an empty cache, with the exact cache and with
the ASH-KV cache (b = 4, d_code = d_head and d_head / 2).  The port's
ASH-KV attention runs the plain version of kernel 7 here (CPU tensors).

Tolerances:
  * float32 blocks, forward and exact-cache decode: rtol 1e-5 and
    atol 1e-5 x the largest |value| (fp32 sums in another order);
  * float32 ASH-KV decode: logits to rtol 1e-4, atol 1e-4 x the
    largest |logit|, the scales to rtol 1e-5, and the packed codes
    EQUAL; the encode's projection u = (k / |k|) W^T is summed in another
    order than the reference's, which could move a code across a
    quantizer breakpoint, but no code moved at these sizes (the test
    would show it);
  * bfloat16 (weights and activations): the port's error against the
    reference's float32 run of the same parameters at most 2x the
    reference's own bf16 error.  Both round at the same points; the
    port's ASH-KV attention keeps p * v_scale in fp32 where the
    reference rounds it to bf16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=96, rope_theta=10000.0)
N_STEPS, BATCH, MAX_LEN = 10, 2, 12


def _cfgs(dtype="float32", q_chunk=0, **kv):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    cj = JT.TransformerConfig(**BASE, dtype=jd, param_dtype=jd, remat=False,
                              q_chunk=q_chunk, **kv)
    ct = TT.TransformerConfig(**BASE, dtype=td, param_dtype=td,
                              q_chunk=q_chunk, **kv)
    return cj, ct


def _params(cj, ct, seed=0):
    pj = JT.init_params(jax.random.PRNGKey(seed), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return pj, convert.params_from_numpy(tree, ct, device="cpu")


def _close(got, want, rtol=1e-5, atol_rel=1e-5):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max())


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], shape)


# -- building blocks ------------------------------------------------------


def test_blocks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    _close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           JC.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))
    pos = rng.integers(0, 1000, (2, 5))
    _close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
           JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5))
    g, u = x[0], x[1]
    _close(TC.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           JC.swiglu(jnp.asarray(g), jnp.asarray(u)))
    _close(TC.rope_freqs(16, 5e5), JC.rope_freqs(16, 5e5))


@pytest.mark.parametrize("causal,q_chunk,kv_len", [
    (True, 0, None), (True, 8, None), (False, 0, (20, 9)), (True, 8, (32, 17)),
])
def test_gqa_attention_matches_reference(causal, q_chunk, kv_len):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    kl = None if kv_len is None else np.asarray(kv_len)
    want = JC.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_chunk=q_chunk,
                            kv_len=None if kl is None else jnp.asarray(kl))
    got = TC.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           q_chunk=q_chunk,
                           kv_len=None if kl is None else torch.from_numpy(kl))
    _close(got, want)


# -- whole model, float32 --------------------------------------------------


def test_forward_and_prefill_match_reference():
    cj, ct = _cfgs(q_chunk=8)
    pj, pt = _params(cj, ct)
    toks = _tokens(2, (2, 16))
    want, _ = JT.forward(pj, jnp.asarray(toks), cj)
    got, aux = TT.forward(pt, torch.from_numpy(toks), ct)
    _close(got, want)
    assert float(aux) == 0.0
    _close(TT.prefill(pt, torch.from_numpy(toks), ct),
           JT.prefill(pj, jnp.asarray(toks), cj))
    _close(pt(torch.from_numpy(toks)), want)


def _decode_both(cj, ct, pj, pt, toks):
    cache_j = JT.init_cache(cj, BATCH, MAX_LEN)
    cache_t = TT.init_cache(ct, BATCH, MAX_LEN, device="cpu")
    lj, lt = [], []
    for t in range(N_STEPS):
        a, cache_j = JT.decode_step(pj, cache_j, jnp.asarray(toks[:, t]),
                                    jnp.int32(t), cj)
        b, cache_t = TT.decode_step(pt, cache_t, torch.from_numpy(toks[:, t]),
                                    t, ct)
        lj.append(np.asarray(a, np.float32))
        lt.append(b.numpy())
    return np.stack(lt), np.stack(lj), cache_t, cache_j


def test_decode_exact_cache_matches_reference():
    cj, ct = _cfgs()
    pj, pt = _params(cj, ct)
    toks = _tokens(3, (BATCH, N_STEPS))
    lt, lj, cache_t, cache_j = _decode_both(cj, ct, pj, pt, toks)
    _close(lt, lj)
    for name in ("k", "v"):
        _close(cache_t[name].numpy(), cache_j[name])
    # decode over the full prefix == forward's logits at each position
    full, _ = TT.forward(pt, torch.from_numpy(toks), ct)
    _close(lt.transpose(1, 0, 2), full.numpy(), atol_rel=1e-4)


@pytest.mark.parametrize("dc", [16, 8])
def test_decode_ashkv_matches_reference(dc):
    cj, ct = _cfgs(kv_quant_bits=4, kv_quant_dim=dc)
    pj, pt = _params(cj, ct, seed=dc)
    toks = _tokens(4, (BATCH, N_STEPS))
    lt, lj, cache_t, cache_j = _decode_both(cj, ct, pj, pt, toks)
    _close(lt, lj, rtol=1e-4, atol_rel=1e-4)
    want = convert.cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, cache_j), device="cpu")
    for name in ("k_codes", "v_codes"):
        assert torch.equal(cache_t[name], want[name]), name
    for name in ("k_scale", "v_scale"):
        _close(cache_t[name].numpy(), want[name].numpy())
    back = convert.cache_to_numpy(cache_t)
    assert back["k_codes"].dtype == np.uint32
    np.testing.assert_array_equal(back["k_codes"],
                                  np.asarray(cache_j["k_codes"]))


@pytest.mark.parametrize("kv", [{}, dict(kv_quant_bits=4, kv_quant_dim=16)])
def test_init_cache_matches_reference(kv):
    for dtype in ("float32", "bfloat16"):
        cj, ct = _cfgs(dtype, **kv)
        want = JT.init_cache(cj, 3, 7)
        got = TT.init_cache(ct, 3, 7, device="cpu")
        assert set(got) == set(want)
        for name, arr in want.items():
            assert tuple(got[name].shape) == arr.shape, name
            jd = np.dtype(arr.dtype)
            td = convert.tensor_from_numpy(np.zeros(1, jd)).dtype
            assert got[name].dtype == td, (name, got[name].dtype, jd)
            assert not got[name].any()


# -- bfloat16 -----------------------------------------------------------------


@pytest.mark.parametrize("kv", [{}, dict(kv_quant_bits=4, kv_quant_dim=0)])
def test_bf16_decode_error_within_reference_error(kv):
    """bf16 weights and activations: the port's logits stay within 2x
    the reference's own bf16 error, both against the reference's float32
    run of the same (bf16-valued) parameters."""
    cj16, ct16 = _cfgs("bfloat16", **kv)
    cj32 = dataclasses.replace(cj16, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    pj16, pt16 = _params(cj16, ct16, seed=5)
    pj32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32)
                                  if a.dtype == jnp.bfloat16 else a, pj16)
    toks = _tokens(6, (BATCH, N_STEPS))
    lt, lj16, _, _ = _decode_both(cj16, ct16, pj16, pt16, toks)
    cache = JT.init_cache(cj32, BATCH, MAX_LEN)
    l32 = []
    for t in range(N_STEPS):
        a, cache = JT.decode_step(pj32, cache, jnp.asarray(toks[:, t]),
                                  jnp.int32(t), cj32)
        l32.append(np.asarray(a))
    l32 = np.stack(l32)
    err_ref = np.abs(lj16 - l32).max()
    err_port = np.abs(lt - l32).max()
    assert err_port <= 2.0 * err_ref, (err_port, err_ref)
    toks2 = _tokens(7, (BATCH, 8))
    f16, _ = TT.forward(pt16, torch.from_numpy(toks2), ct16)
    fj16, _ = JT.forward(pj16, jnp.asarray(toks2), cj16)
    fj32, _ = JT.forward(pj32, jnp.asarray(toks2), cj32)
    assert (np.abs(f16.numpy() - np.asarray(fj32)).max()
            <= 2.0 * np.abs(np.asarray(fj16) - np.asarray(fj32)).max())


def test_moe_config_refused():
    with pytest.raises(NotImplementedError):
        TT.TransformerConfig(**BASE, moe=object())
