"""Port parity: ASH-KV decode attention (kernel 7's function) against JAX.

Inputs are made with numpy from a seed, quantized and packed by the
reference, and handed to both packages (uint32 words as int32 bit
patterns).  The port side runs the plain version: ``ref.ash_kv_attn_ref``
directly, and ``ops.ash_kv_attention`` / the kernel wrapper on CPU
tensors, which is the plain version after the operand checks.  The JAX
side runs ``ash_kv_attn_pallas`` in interpret mode, as the reference's
own tests do on the CPU, its ``ref.ash_kv_attn_ref`` and its batched
``ops.ash_kv_attention``.

Tolerance: rtol 1e-4, atol 1e-5, as the reference's kernel test
(``tests/test_kernels.py``): fp32 sums over S positions in different
orders.  The CUDA kernel is held to the plain version on the card by
``tests/cuda/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.kernels.ash_kv_attn import ash_kv_attn_pallas  # noqa: E402
from repro_torch.kernels import ash_kv_attn as KA  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
# (b_k, b_v, dk, dv, S): the reference's KV_CASES (tests/test_kernels.py)
KV_CASES = [
    (1, 1, 128, 128, 300),
    (2, 2, 128, 128, 1000),
    (1, 4, 256, 64, 513),
    (4, 1, 64, 256, 1024),
    (4, 4, 96, 96, 77),
]


def _inputs(seed, bk, bv, dk, dv, S, lead=(), G=None, mask_from=0):
    """numpy operands: packed codes (*lead, S, W) uint32 of quantized
    Gaussian vectors, q_k (*lead[, G], dk), scales, bias, mask."""
    rng = np.random.default_rng(seed)
    kv = JQ.quant(jnp.asarray(rng.standard_normal(lead + (S, dk)),
                              jnp.float32), bk)
    vv = JQ.quant(jnp.asarray(rng.standard_normal(lead + (S, dv)),
                              jnp.float32), bv)
    qshape = lead + ((G,) if G else ()) + (dk,)
    pos = np.arange(S)
    return dict(
        q=(rng.standard_normal(qshape) * 0.1).astype(np.float32),
        kc=np.asarray(JQ.pack_codes(kv, bk)),
        ks=(rng.uniform(0.5, 1.5, lead + (S,)) * 0.05).astype(np.float32),
        kb=(rng.standard_normal(lead + (S,)) * 0.1).astype(np.float32),
        vc=np.asarray(JQ.pack_codes(vv, bv)),
        vs=rng.uniform(0.5, 1.5, lead + (S,)).astype(np.float32),
        mask=np.broadcast_to((pos >= mask_from) & (pos < S - 3),
                             lead + (S,)).copy(),
    )


def _torch(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _order(d):
    return [d["q"], d["kc"], d["ks"], d["kb"], d["vc"], d["vs"], d["mask"]]


@pytest.mark.parametrize("bk,bv,dk,dv,S", KV_CASES)
def test_plain_version_matches_reference(bk, bv, dk, dv, S):
    d = _inputs(bk * 100 + bv, bk, bv, dk, dv, S)
    want, want_p = JR.ash_kv_attn_ref(
        jnp.asarray(d["q"]), jnp.asarray(d["kc"]), jnp.asarray(d["ks"]),
        jnp.asarray(d["kb"]), jnp.asarray(d["vc"]), jnp.asarray(d["vs"]),
        bk, bv, mask=jnp.asarray(d["mask"]))
    t = {k: _torch(v) for k, v in d.items()}
    got, got_p = TR.ash_kv_attn_ref(t["q"][None], t["kc"], t["ks"], t["kb"],
                                    t["vc"], t["vs"], bk, bv, mask=t["mask"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_p[0].numpy(), np.asarray(want_p),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bk,bv,dk,dv,S", KV_CASES)
def test_op_matches_pallas_kernel(bk, bv, dk, dv, S):
    """The port's batched op (the wrapper's plain version on the CPU)
    against the TPU kernel in interpret mode, one query per stream."""
    d = _inputs(bk * 10 + bv + 7, bk, bv, dk, dv, S, lead=(2,))
    want = np.stack([np.asarray(ash_kv_attn_pallas(
        *[jnp.asarray(a[i]) for a in _order(d)], b_k=bk, b_v=bv,
        interpret=True)) for i in range(2)])
    t = [_torch(a) for a in _order(d)]
    t[0] = t[0][:, None]  # (2, G=1, dk)
    got = TO.ash_kv_attention(*t, b_k=bk, b_v=bv)
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=RTOL, atol=ATOL)


def test_op_batched_matches_reference_op():
    """Two lead dims, against the reference's vmapped op (kernel in
    interpret mode and its plain form)."""
    bk = bv = 2
    d = _inputs(5, bk, bv, 128, 128, 200, lead=(2, 3))
    j = [jnp.asarray(a) for a in _order(d)]
    want_k = JO.ash_kv_attention(*j, b_k=bk, b_v=bv, interpret=True)
    want_p = JO.ash_kv_attention(*j, b_k=bk, b_v=bv, use_pallas=False)
    t = [_torch(a) for a in _order(d)]
    t[0] = t[0][..., None, :]
    got = TO.ash_kv_attention(*t, b_k=bk, b_v=bv)[..., 0, :].numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(want_p), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("G", [3, 8])
def test_grouped_queries_match_reference_op(G):
    """G query heads sharing one KV stream == the reference op with each
    stream's codes repeated per head; bf16 scales, no bias, a leading
    masked stretch."""
    bk, bv, S = 4, 4, 300
    d = _inputs(G, bk, bv, 128, 128, S, lead=(2,), G=G, mask_from=150)
    ks = d["ks"].astype(jnp.bfloat16)
    vs = d["vs"].astype(jnp.bfloat16)

    def rep(a):
        return jnp.repeat(jnp.asarray(a)[:, None], G, axis=1)

    want = JO.ash_kv_attention(
        jnp.asarray(d["q"]), rep(d["kc"]), rep(ks), jnp.zeros((2, G, S)),
        rep(d["vc"]), rep(vs), rep(d["mask"]), b_k=bk, b_v=bv,
        use_pallas=False)
    t = {k: _torch(v) for k, v in d.items()}
    bf = {k: _torch(np.asarray(v).view(np.int16)).view(torch.bfloat16)
          for k, v in (("ks", ks), ("vs", vs))}
    mask = t["mask"][0]  # (S,), broadcast over the lead dim
    got = KA.ash_kv_attn_cuda(t["q"], t["kc"], bf["ks"], None, t["vc"],
                              bf["vs"], mask, b_k=bk, b_v=bv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_wrapper_refuses_bad_operands():
    d = _inputs(1, 4, 4, 128, 128, 100, lead=(2,), G=3)
    t = [_torch(a) for a in _order(d)]

    def call(i, x, match, **kw):
        bad = list(t)
        bad[i] = x
        with pytest.raises(ValueError, match=match):
            KA.ash_kv_attn_cuda(*bad, **{"b_k": 4, "b_v": 4, **kw})

    call(0, t[0].double(), "q_k")
    call(0, torch.zeros(2, 9, 128), "q_k")  # G above 8
    call(0, torch.zeros(2, 3, 64), "q_k")  # width != Wk * 32/b
    call(0, torch.zeros(1, 1, 2, 3, 128), "lead")
    call(2, t[2].to(torch.bfloat16), "scales")
    call(1, t[1].to(torch.int64), "k_codes")
    call(6, t[6].int(), "mask")
    call(4, t[4][:, :50], "codes")
    call(1, t[1].transpose(-1, -2).contiguous().transpose(-1, -2),
         "unit stride")
    call(0, t[0], "bitrates", b_k=3)
