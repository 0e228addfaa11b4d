"""Kernel 7's tensor-core arithmetic, modelled in plain PyTorch and numpy.

``csrc/ash_kv_attn.cu`` computes both products of decode attention with
``mma.sync.m16n8k16`` (bf16 in, fp32 accumulate) and runs only on the
card.  What it relies on is checked here, on the CPU:

  * the code unpack into bf16 pairs (``grid_pair``: bits of a packed
    word OR-ed into the mantissa of bf16 128, then 128 + 2^b - 1
    subtracted; for b = 8 the fp32 mantissa of 2^23) gives exactly the
    grid values of ``quantization.unpack_codes``, for every bitrate and
    pair index;
  * every grid value is exact in bf16, and the three-part bf16 split of
    an fp32 operand reconstructs it to 2^-26 relative;
  * the fragments a lane builds (the permuted reduction order of the
    logit product, the byte-permuted position pairs and the permuted
    output columns of the PV product), laid out as PTX's m16n8k16
    fragment tables say, multiply to the plain products;
  * a model of the kernel's arithmetic (split operands times exact
    codes summed in fp32, online softmax per warp over 32-position
    chunks, warps then splits combined) agrees with
    ``ref.ash_kv_attn_ref`` and with the JAX package's
    ``ash_kv_attn_pallas`` (interpret mode) within the tolerance
    ``chip_smoke.py`` holds the kernel to (``kv_close``: rtol 1e-4,
    atol 1e-5 x max(1, largest |plain value|)).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro.kernels.ash_kv_attn import ash_kv_attn_pallas  # noqa: E402
from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

NEG = -1e30
BITS = (1, 2, 4, 8)


def kv_close(got, want):
    """``chip_smoke.kv_close``: rtol 1e-4, atol 1e-5 x max(1, max|want|)."""
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    return bool((err <= atol + 1e-4 * want.abs()).all()), float(err.max())


def _bf16_bits_to_float(bits):
    """uint16 bf16 bit patterns -> float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def grid_pair(x, i, b):
    """numpy copy of the kernel's ``grid_pair<b>(x, i)``: (low, high)
    float values of the bf16 pair it builds from uint32 words x."""
    x = np.asarray(x, np.uint32)
    if b == 8:
        lo = (x >> np.uint32(8 * i)) & np.uint32(0xFF)
        hi = (x >> np.uint32(16 + 8 * i)) & np.uint32(0xFF)
        f = lambda L: ((np.uint32(0x4B000000) | (L << np.uint32(1)))  # noqa
                       .view(np.float32) - np.float32(8388863.0))
        vals = [f(lo), f(hi)]
        # packed by cvt.rn.bf16x2.f32: exact for these integers
        for v in vals:
            assert np.all(torch.from_numpy(v).to(torch.bfloat16).float()
                          .numpy() == v)
        return vals
    m2 = ((1 << b) - 1) << 1
    mask = np.uint32(m2 | (m2 << 16))
    t = (x << np.uint32(1)) if i == 0 else (x >> np.uint32(i * b - 1))
    v = (t & mask) | np.uint32(0x43004300)
    c = float(128 + (1 << b) - 1)
    return [_bf16_bits_to_float(v & np.uint32(0xFFFF)) - np.float32(c),
            _bf16_bits_to_float(v >> np.uint32(16)) - np.float32(c)]


def byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) for the selectors used (0x5410,
    0x7632)."""
    src = np.stack([(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
                   + [(y >> np.uint32(8 * k)) & np.uint32(0xFF)
                      for k in range(4)])
    out = np.zeros_like(x)
    for k in range(4):
        out |= src[(sel >> (4 * k)) & 0xF] << np.uint32(8 * k)
    return out


def _words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _grid(words, b):
    """(.., W) uint32 -> (.., W * 32/b) grid values, as the plain path."""
    cpw = 32 // b
    t = torch.from_numpy(words.view(np.int32))
    return Q.unpack_codes(t, words.shape[-1] * cpw, b).to(
        torch.float32).numpy()


@pytest.mark.parametrize("b", BITS)
def test_grid_pair_equals_unpack(b):
    """Pair i of a word is (code i, code i + 16/b), as unpack_codes."""
    rng = np.random.default_rng(b)
    w = _words(rng, (257,))
    want = _grid(w[:, None], b)  # (257, 32/b)
    for i in range(16 // b):
        lo, hi = grid_pair(w, i, b)
        np.testing.assert_array_equal(lo, want[:, i])
        np.testing.assert_array_equal(hi, want[:, i + 16 // b])


@pytest.mark.parametrize("b", BITS)
def test_grid_values_exact_in_bf16(b):
    g = np.arange(-(2**b - 1), 2**b, 2, dtype=np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(g).to(torch.bfloat16).float().numpy(), g)


def split3(x):
    """Three bf16-valued fp32 parts of x, largest first (the kernel's
    ``split3``: each part rounds to nearest)."""
    parts = []
    for _ in range(3):
        p = x.to(torch.bfloat16).to(torch.float32)
        parts.append(p)
        x = x - p
    return parts


@pytest.mark.parametrize("scale", [1e-20, 1e-6, 1.0, 3e4, 1e30])
def test_split3_reconstructs_fp32(scale):
    """To 2^-26 relative wherever the third part stays a normal number
    (|x| above about 2^-100)."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32))
    p = split3(x)
    rec = (p[0].double() + p[1].double() + p[2].double())
    err = (rec - x.double()).abs()
    assert bool((err <= 2.0**-26 * x.double().abs()).all())
    # each part is exactly a bf16 value
    for q in p:
        assert torch.equal(q.to(torch.bfloat16).float(), q)


# -- fragment layouts (PTX m16n8k16, .bf16): lane = 4 g + t ---------------
# A (16 x 16): reg0 = (row g, cols 2t, 2t+1), reg1 = (row g+8, cols 2t,
# 2t+1), reg2 = (row g, cols 2t+8, 2t+9), reg3 = (row g+8, cols 2t+8,
# 2t+9); B (16 x 8): reg0 = (rows 2t, 2t+1, col g), reg1 = (rows 2t+8,
# 2t+9, col g); D (16 x 8): (row g, cols 2t, 2t+1), (row g+8, cols 2t,
# 2t+1).  Low half = the first of each pair.

def _place_a(regs):
    """regs[lane][reg] = (lo, hi) -> the 16 x 16 A matrix."""
    A = np.zeros((16, 16), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (r0, c0) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                        (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r0, c0], A[r0, c0 + 1] = regs[lane][reg]
    return A


def _place_b(regs):
    """regs[lane][reg] = (lo, hi) -> the 16 x 8 B matrix."""
    B = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, k0 in enumerate((2 * t, 2 * t + 8)):
            B[k0, g], B[k0 + 1, g] = regs[lane][reg]
    return B


@pytest.mark.parametrize("bk,Wk", [(1, 4), (2, 8), (4, 16), (8, 32), (4, 5),
                                   (2, 3), (8, 10)])
def test_logit_fragments_multiply_to_plain_product(bk, Wk):
    """The kernel's logit tile: lane (g, t) takes word 4r + t of rows g
    and g + 8, pairs 2j and 2j + 1 of it for k-step (r, j); q's fragment
    holds the same codes of the same word.  Summed over the k-steps,
    the fragments' products equal the 16 positions' plain logits."""
    rng = np.random.default_rng(bk * 100 + Wk)
    ck, spw = 32 // bk, 32 // bk // 4
    dk = Wk * ck
    words = _words(rng, (16, Wk))
    q = rng.standard_normal((3, dk)).astype(np.float32)  # G = 3 heads
    wk4 = -(-Wk // 4)
    D = np.zeros((16, 8), np.float64)
    for r in range(wk4):
        for j in range(spw):
            a_regs, b_regs = [], []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                word = 4 * r + t
                # pad words past Wk: any bits (the kernel's stale shared
                # memory), their q is zero
                w0 = words[g, word] if word < Wk else np.uint32(0xDEADBEEF)
                w1 = words[g + 8, word] if word < Wk else np.uint32(7)
                pr = [grid_pair(np.array([w], np.uint32), 2 * j + h, bk)
                      for w in (w0, w1) for h in (0, 1)]
                pr = [(float(lo[0]), float(hi[0])) for lo, hi in pr]
                a_regs.append([pr[0], pr[2], pr[1], pr[3]])
                codes = (2 * j, 2 * j + ck // 2, 2 * j + 1, 2 * j + 1 + ck // 2)
                qv = [q[g, word * ck + c] if g < 3 and word < Wk else 0.0
                      for c in codes]
                b_regs.append([(qv[0], qv[1]), (qv[2], qv[3])])
            D += _place_a(a_regs).astype(np.float64) @ _place_b(
                b_regs).astype(np.float64)
    want = _grid(words, bk).astype(np.float64) @ q.T.astype(np.float64)
    np.testing.assert_allclose(D[:, :3], want, rtol=1e-12, atol=1e-9)
    assert np.all(D[:, 3:] == 0)


@pytest.mark.parametrize("bv,Wv", [(1, 4), (2, 8), (4, 16), (8, 32), (4, 6),
                                   (8, 5), (2, 4), (4, 32), (8, 64)])
def test_pv_fragments_multiply_to_plain_product(bv, Wv):
    """The kernel's PV k-step: lane (g, t) takes V words 8r + g of
    positions 2t, 2t+1, 2t+8, 2t+9, pairs the same code of two positions
    with byte_perm, and m-tile r * 16/b + c holds columns (8r + g) 32/b
    + c (row g) and + 16/b (row g + 8).  Un-permuted, the products
    equal the plain V^T P over the 16 positions."""
    rng = np.random.default_rng(bv * 1000 + Wv)
    cv, mpw = 32 // bv, 16 // bv
    dv = Wv * cv
    tiles = -(-Wv // 8) * mpw
    nmv = 8 if tiles <= 8 else 16
    wv8 = nmv // mpw
    words = _words(rng, (16, Wv))
    P = rng.standard_normal((8, 16)).astype(np.float32)  # [head][position]
    b_regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        b_regs.append([(P[g, 2 * t], P[g, 2 * t + 1]),
                       (P[g, 2 * t + 8], P[g, 2 * t + 9])])
    B = _place_b(b_regs).astype(np.float64)
    out = np.full((dv, 8), np.nan)
    for r in range(wv8):
        for c in range(mpw):
            a_regs = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                word = 8 * r + g

                def wd(p):
                    return words[p, word] if word < Wv else np.uint32(
                        0x12345678)

                a0, a1, a8, a9 = (np.array([wd(p)], np.uint32) for p in
                                  (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9))
                regs = []
                for x, y in ((a0, a1), (a0, a1), (a8, a9), (a8, a9)):
                    sel = 0x5410 if len(regs) % 2 == 0 else 0x7632
                    lo, hi = grid_pair(byte_perm(x, y, sel), c, bv)
                    regs.append((float(lo[0]), float(hi[0])))
                a_regs.append(regs)
            D = _place_a(a_regs).astype(np.float64) @ B  # (16 cols, 8 heads)
            for g in range(8):
                col0 = (8 * r + g) * cv + c
                for row, col in ((g, col0), (g + 8, col0 + cv // 2)):
                    if col < dv:
                        assert np.isnan(out[col, 0]), "column written twice"
                        out[col] = D[row]
    want = _grid(words, bv).astype(np.float64).T @ P.T.astype(np.float64)
    assert not np.isnan(out).any(), "column never written"
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-9)


# -- the kernel's arithmetic, end to end ------------------------------------

def mma_model(q, kc, ks, kb, vc, vs, mask, bk, bv, rows_per_split,
              n_warps=8, chunk=32):
    """Kernel 7's arithmetic over (N, S) streams: q (N, G, dk) f32,
    codes (N, S, W) int32, scales/bias/mask (N, S) (bias may be None).
    Logits and PV are fp32 sums of exact products of codes and three
    bf16 parts (smallest part first); each warp keeps an online softmax
    over its 32-position chunks (chunks w, w + n_warps, ... of a split);
    warps, then splits, combine by their maxima."""
    N, G, dk = q.shape
    S = kc.shape[1]
    dv = vc.shape[-1] * (32 // bv)
    K = Q.unpack_codes(kc, dk, bk).to(torch.float32)  # (N, S, dk)
    V = Q.unpack_codes(vc, dv, bv).to(torch.float32)
    dot = torch.zeros(N, S, G)
    for p in reversed(split3(q)):
        dot = dot + torch.matmul(K, p.transpose(1, 2))
    ksf, vsf = ks.to(torch.float32), vs.to(torch.float32)
    kbf = torch.zeros(N, S) if kb is None else kb.to(torch.float32)
    logits = torch.where(mask[..., None], dot * ksf[..., None]
                         + kbf[..., None], NEG)
    parts = []  # per split: (m (N, G), d (N, G), acc (N, G, dv))
    for s0 in range(0, S, rows_per_split):
        s1 = min(S, s0 + rows_per_split)
        chunks = list(range(s0, s1, chunk))
        warps = []
        for w in range(n_warps):
            m = torch.full((N, G), NEG)
            d = torch.zeros(N, G)
            acc = torch.zeros(N, G, dv)
            for c0 in chunks[w::n_warps]:
                c1 = min(s1, c0 + chunk)
                lg = logits[:, c0:c1]  # (N, c, G)
                m_new = torch.maximum(m, lg.max(dim=1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(lg - m_new[:, None])
                d = d * corr + p.sum(dim=1)
                acc = acc * corr[..., None]
                pv = p * vsf[:, c0:c1, None]
                for part in reversed(split3(pv)):
                    acc = acc + torch.matmul(part.transpose(1, 2),
                                             V[:, c0:c1])
                m = m_new
            warps.append((m, d, acc))
        M = torch.stack([w[0] for w in warps]).max(dim=0).values
        f = [torch.exp(w[0] - M) for w in warps]
        parts.append((M, sum(w[1] * fi for w, fi in zip(warps, f)),
                      sum(w[2] * fi[..., None] for w, fi in zip(warps, f))))
    M = torch.stack([p[0] for p in parts]).max(dim=0).values
    f = [torch.exp(p[0] - M) for p in parts]
    den = sum(p[1] * fi for p, fi in zip(parts, f))
    acc = sum(p[2] * fi[..., None] for p, fi in zip(parts, f))
    return acc / torch.clamp(den, min=1e-30)[..., None]


def _operands(seed, bk, bv, dk, dv, S, N, G, *, bias=True, mask_from=0,
              bf16_scales=False, q_scale=0.1):
    """Quantized Gaussian K/V packed by the JAX package (numpy in
    between), q of the given scale, scales, bias, a mask valid on
    [mask_from, S - 3)."""
    rng = np.random.default_rng(seed)
    kv = JQ.quant(jnp.asarray(rng.standard_normal((N, S, dk)), jnp.float32),
                  bk)
    vv = JQ.quant(jnp.asarray(rng.standard_normal((N, S, dv)), jnp.float32),
                  bv)
    pos = np.arange(S)
    d = dict(
        q=(rng.standard_normal((N, G, dk)) * q_scale).astype(np.float32),
        kc=np.asarray(JQ.pack_codes(kv, bk)).view(np.int32),
        ks=(rng.uniform(0.5, 1.5, (N, S)) * 0.05).astype(np.float32),
        kb=((rng.standard_normal((N, S)) * 0.1).astype(np.float32)
            if bias else None),
        vc=np.asarray(JQ.pack_codes(vv, bv)).view(np.int32),
        vs=rng.uniform(0.5, 1.5, (N, S)).astype(np.float32),
        mask=np.broadcast_to((pos >= mask_from) & (pos < S - 3),
                             (N, S)).copy(),
    )
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in d.items()}
    if bf16_scales:
        t["ks"], t["vs"] = t["ks"].to(torch.bfloat16), t["vs"].to(
            torch.bfloat16)
        d["ks"] = t["ks"].float().numpy()
        d["vs"] = t["vs"].float().numpy()
    return d, t


def _plain(t, bk, bv):
    return TR.ash_kv_attn_ref(t["q"], t["kc"], t["ks"], t["kb"], t["vc"],
                              t["vs"], bk, bv, mask=t["mask"])[0]


def _model(t, bk, bv, rows_per_split):
    return mma_model(t["q"], t["kc"], t["ks"], t["kb"], t["vc"], t["vs"],
                     t["mask"], bk, bv, rows_per_split)


@pytest.mark.parametrize("bk", BITS)
@pytest.mark.parametrize("bv", BITS)
def test_model_matches_plain_bitrates(bk, bv):
    _, t = _operands(bk * 10 + bv, bk, bv, 128, 128, 600, 2, 3)
    ok, err = kv_close(_model(t, bk, bv, 256), _plain(t, bk, bv))
    assert ok, err


@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8])
def test_model_matches_plain_every_group_size(G):
    _, t = _operands(G, 4, 4, 128, 128, 700, 2, G, bf16_scales=True,
                     bias=False)
    ok, err = kv_close(_model(t, 4, 4, 256), _plain(t, 4, 4))
    assert ok, err


@pytest.mark.parametrize("S,mask_from", [(77, 0), (513, 0), (1000, 700),
                                         (301, 290), (45, 40)])
def test_model_matches_plain_ragged_and_masked(S, mask_from):
    """S not a multiple of 16 or 32, a leading masked stretch longer than
    a split, a masked tail inside one 16-position fragment."""
    _, t = _operands(S, 4, 2, 96, 64, S, 3, 3, mask_from=mask_from)
    ok, err = kv_close(_model(t, 4, 2, 256), _plain(t, 4, 2))
    assert ok, err


@pytest.mark.parametrize("q_scale", [1e-4, 1e-2, 1.0, 10.0])
def test_model_matches_plain_query_magnitudes(q_scale):
    """q far from unit scale: the three-part split keeps fp32 precision
    (at 10, logits of hundreds make p nearly one-hot)."""
    _, t = _operands(int(q_scale * 1e4) % 997, 4, 4, 128, 128, 400, 2, 3,
                     q_scale=q_scale)
    ok, err = kv_close(_model(t, 4, 4, 256), _plain(t, 4, 4))
    assert ok, err


@pytest.mark.parametrize("bk,bv,dk,dv,S", [(2, 2, 128, 128, 300),
                                           (4, 1, 64, 256, 260),
                                           (8, 4, 40, 96, 77)])
def test_model_matches_pallas_kernel(bk, bv, dk, dv, S):
    """The model against the TPU kernel in interpret mode, one query per
    stream (G = 1)."""
    d, t = _operands(bk + bv + S, bk, bv, dk, dv, S, 2, 1)
    want = np.stack([np.asarray(ash_kv_attn_pallas(
        jnp.asarray(d["q"][i, 0]), jnp.asarray(d["kc"][i].view(np.uint32)),
        jnp.asarray(d["ks"][i]), jnp.asarray(d["kb"][i]),
        jnp.asarray(d["vc"][i].view(np.uint32)), jnp.asarray(d["vs"][i]),
        jnp.asarray(d["mask"][i]), b_k=bk, b_v=bv, interpret=True))
        for i in range(2)])
    ok, err = kv_close(_model(t, bk, bv, 128)[:, 0], torch.from_numpy(want))
    assert ok, err
