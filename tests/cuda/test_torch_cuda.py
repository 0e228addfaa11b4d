"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports nothing of JAX, so it runs where JAX is not
installed; the repository's conftest imports JAX, so on such a machine
run it with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/cuda

Tolerances: kernel scores against the plain version at rtol 1e-5 and
atol 1e-5 times the largest |score| (fp32 sums over d_pad <= 256 terms
in a different order); the fused kernels EQUAL to a stable top-k of
their materializing kernel's scores (values, ids, tie order), since
both compute each element with the same device routine; the gathered
scan EQUAL to the dense scan on the same (query, row) (one arithmetic
order); the coarse kernels EQUAL to their plain versions (exact integer
accumulation, one epilogue order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import quantization as Q  # noqa: E402
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.data.synthetic import embedding_dataset  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.kernels import ash_score as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

pytestmark = pytest.mark.cuda
METRICS = ("dot", "l2", "cos")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(seed, b, d, n, m, C, metric, device):
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 2**b, size=(n, d))
    codes = Q.pack_codes(torch.from_numpy(2 * levels - (2**b - 1)), b)
    d_pad = codes.shape[1] * (32 // b)
    q = np.pad(rng.standard_normal((m, d)), ((0, 0), (0, d_pad - d)))
    t = {
        "codes": codes,
        "q": torch.from_numpy(q).float(),
        "scale": torch.from_numpy(rng.uniform(0.5, 2.0, n)).float(),
        "offset": torch.from_numpy(rng.standard_normal(n)).float(),
        "cluster": torch.from_numpy(rng.integers(0, C, n)).int(),
        "ipq": torch.from_numpy(rng.standard_normal((m, C))).float(),
        "qterm": torch.from_numpy(rng.uniform(0.5, 2.0, m)).float(),
        "rowterm": torch.from_numpy(rng.uniform(0.5, 2.0, n)).float(),
    }
    t = {k: v.to(device).contiguous() for k, v in t.items()}
    extra = metric != "dot"
    return [t["codes"], t["q"], t["scale"], t["offset"], t["cluster"],
            t["ipq"], t["qterm"] if extra else None,
            t["rowterm"] if extra else None]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m", [(1, 100, 3001, 3), (2, 128, 5000, 8),
                                     (4, 72, 1500, 11), (8, 20, 700, 1)])
def test_score_kernel_vs_plain(cuda, metric, b, d, n, m):
    args = _args(b + d, b, d, n, m, 16, metric, cuda)
    before = TK.launch_counts["ash_score"]
    got = TK.ash_score_cuda(*args, b=b, metric=metric)
    want = TR.ash_score_metric_ref(*args, b=b, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score"] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("m", [8, 13])
def test_fused_equals_sorted_materialized(cuda, metric, m):
    n, k = 6000, 100
    args = _args(7, 2, 100, n, m, 16, metric, cuda)
    for t in (0, 2, 3, 5):  # duplicate rows: exact ties across tiles
        if args[t] is not None and args[t].shape[0] == n:
            args[t][5000:5100] = args[t][0:100]
    if args[7] is not None:
        args[7][5000:5100] = args[7][0:100]
    args[3][[11, 4000]] = float("-inf")  # rows whose score is -inf
    full = TK.ash_score_cuda(*args, b=2, metric=metric)
    row_valid = torch.rand(n, device=cuda) > 0.3
    for n_valid, rv in ((None, None), (None, row_valid), (5050, None),
                        (5050, row_valid)):
        before = TK.launch_counts["ash_score_topk"]
        ts, ti = TK.ash_score_topk_cuda(*args, n_valid, rv, b=2, k=k,
                                        metric=metric)
        assert TK.launch_counts["ash_score_topk"] == before + 1
        vs, vi = TR.stable_top_k(TR.mask_rows_ref(full, n_valid, rv), k)
        assert torch.equal(ts, vs), (n_valid, rv is None)
        assert torch.equal(ti, vi.to(torch.int32)), (n_valid, rv is None)
        ps, pi = TK.ash_score_topk_cuda(*[a if a is None else a.cpu()
                                          for a in args],
                                        n_valid, None if rv is None
                                        else rv.cpu(), b=2, k=k,
                                        metric=metric)
        torch.testing.assert_close(ts.cpu(), ps, rtol=1e-5,
                                   atol=1e-5 * ps[torch.isfinite(ps)]
                                   .abs().max().item())


def test_fused_exhausted_slots(cuda):
    args = _args(3, 2, 64, 900, 4, 8, "dot", cuda)
    row_valid = torch.zeros(900, dtype=torch.bool, device=cuda)
    row_valid[[2, 600, 899]] = True
    ts, ti = TK.ash_score_topk_cuda(*args, None, row_valid, b=2, k=10)
    assert sorted(ti[0, :3].tolist()) == [2, 600, 899]
    assert (ti[:, 3:] == -1).all() and torch.isneginf(ts[:, 3:]).all()
    with pytest.raises(ValueError, match="candidate strip"):
        TK.ash_score_topk_cuda(*args, b=2, k=10, k_tilde=4)


def test_wrapper_refuses_bad_operands(cuda):
    args = _args(5, 2, 64, 300, 2, 4, "dot", cuda)
    args[1] = args[1].double()
    with pytest.raises(ValueError, match="q_proj"):
        TK.ash_score_cuda(*args, b=2)


def test_index_on_card_matches_cpu(cuda):
    """A small index built on the card: the kernel route returns the
    plain route's ids, and the same model and payload on the CPU give
    the same ids."""
    X = embedding_dataset(4000, 64, seed=0, device="cuda")
    Qm = embedding_dataset(16, 64, seed=1, device="cuda")
    index = AshIndex.build(torch.Generator().manual_seed(0), X,
                           ASHConfig(b=2, d=32, n_landmarks=16),
                           keep_raw=True)
    s, ids = index.search(Qm, k=50)
    _, ids_plain = index.search(Qm, k=50, use_kernel=False)
    assert (ids == ids_plain).float().mean() > 0.99
    model, payload = index.model, index.payload
    cpu = AshIndex.from_parts(
        dataclasses.replace(model, **{
            f: getattr(model, f).cpu() for f in model.ARRAY_FIELDS}),
        dataclasses.replace(payload, **{
            f: getattr(payload, f).cpu() for f in payload.ARRAY_FIELDS}),
    )
    _, ids_cpu = cpu.search(Qm.cpu(), k=50)
    assert (ids.cpu() == ids_cpu).float().mean() > 0.99
    _, rr = index.search(Qm, k=10, rerank=256)
    assert rr.shape == (16, 10) and (rr >= 0).all()


def _rows(seed, m, R, n, device, pad=0.3):
    """(m, R) int32 candidate table: ragged runs of ascending rows with
    -1 padding, plus a few repeated rows (exact ties)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=(m, R))
    rows[rng.random((m, R)) < pad] = -1
    rows[:, R // 2:R // 2 + 5] = rows[:, :5]
    return torch.from_numpy(rows.astype(np.int32)).to(device)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m,R", [(1, 100, 3001, 3, 700),
                                       (2, 128, 5000, 8, 1000),
                                       (4, 72, 1500, 11, 333),
                                       (8, 20, 700, 1, 129)])
def test_gather_kernel_vs_plain_and_dense(cuda, metric, b, d, n, m, R):
    args = _args(b + d, b, d, n, m, 16, metric, cuda)
    rows = _rows(R, m, R, n, cuda)
    before = TK.launch_counts["ash_score_gather"]
    got = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=b,
                                   metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_gather"] == before + 1
    want = TR.ash_score_gather_ref(args[0], rows, *args[1:], b=b,
                                   metric=metric)
    pad = rows < 0
    assert torch.isneginf(got[pad]).all()
    fin = want[~pad]
    torch.testing.assert_close(got[~pad], fin, rtol=1e-5,
                               atol=1e-5 * fin.abs().max().item())
    dense = TK.ash_score_cuda(*args, b=b, metric=metric)
    assert torch.equal(got[~pad], dense.gather(1, rows.clamp(min=0).long())
                       [~pad])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("R,k", [(1000, 100), (1000, 7), (333, 1),
                                 (40, 32), (600, 128)])
def test_gather_fused_equals_sorted_materialized(cuda, metric, R, k):
    n, m = 4000, 9
    args = _args(R + k, 2, 100, n, m, 16, metric, cuda)
    rows = _rows(k, m, R, n, cuda)
    rows[2] = -1  # a query with no live candidate
    full = TK.ash_score_gather_cuda(args[0], rows, *args[1:], b=2,
                                    metric=metric)
    before = TK.launch_counts["ash_score_gather_topk"]
    ts, tr = TK.ash_score_gather_topk_cuda(args[0], rows, *args[1:], b=2,
                                           k=k, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_gather_topk"] == before + 1
    vs, vp = TR.stable_top_k(full, k)
    want_rows = torch.where(torch.isneginf(vs) & (rows.gather(1, vp) < 0),
                            -1, rows.gather(1, vp))
    assert torch.equal(ts, vs)
    assert torch.equal(tr, want_rows.to(torch.int32))
    assert (tr[2] == -1).all() and torch.isneginf(ts[2]).all()
    ps, pr = TK.ash_score_gather_topk_cuda(
        *[a if a is None else a.cpu() for a in (args[0], rows, *args[1:])],
        b=2, k=k, metric=metric)
    assert (pr == tr.cpu()).float().mean() > 0.98


def _coarse_args(seed, b, d, n, m, C, metric, device):
    rng = np.random.default_rng(seed)
    a = _args(seed, b, d, n, m, C, metric, device)
    d_pad = a[1].shape[1]
    qi = np.zeros((m, d_pad), np.int8)
    qi[:, :d] = rng.integers(-127, 128, size=(m, d))
    qi = torch.from_numpy(qi).to(device)
    qs = torch.from_numpy(rng.uniform(1e-3, 1e-2, m)).float().to(device)
    qc = torch.from_numpy(rng.standard_normal(m)).float().to(device)
    return [a[0], qi, qs, qc, *a[2:]]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b,d,n,m", [(1, 100, 3001, 3), (2, 128, 5000, 8),
                                     (4, 72, 1500, 11), (8, 20, 700, 1),
                                     (8, 128, 2000, 9)])
def test_coarse_kernel_equals_plain(cuda, metric, b, d, n, m):
    args = _coarse_args(b * 3 + d, b, d, n, m, 16, metric, cuda)
    before = TK.launch_counts["ash_score_coarse"]
    got = TK.ash_score_coarse_cuda(*args, b=b, metric=metric)
    torch.cuda.synchronize()
    assert TK.launch_counts["ash_score_coarse"] == before + 1
    want = TR.ash_score_coarse_ref(*args, b=b, metric=metric)
    assert torch.equal(got, want)
    cpu = TK.ash_score_coarse_cuda(*[a if a is None else a.cpu()
                                     for a in args], b=b, metric=metric)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [2, 8])
def test_coarse_fused_equals_sorted_materialized(cuda, metric, b):
    n, m, k = 6000, 13, 100
    args = _coarse_args(b, b, 64, n, m, 16, metric, cuda)
    for t in (0, 4, 5, 6):  # duplicate rows: exact ties across tiles
        args[t][5000:5100] = args[t][0:100]
    if args[9] is not None:
        args[9][5000:5100] = args[9][0:100]
    full = TK.ash_score_coarse_cuda(*args, b=b, metric=metric)
    row_valid = torch.rand(n, device=cuda) > 0.3
    for n_valid, rv in ((None, None), (None, row_valid), (5050, None),
                        (5050, row_valid)):
        before = TK.launch_counts["ash_score_coarse_topk"]
        ts, ti = TK.ash_score_coarse_topk_cuda(*args, n_valid, rv, b=b, k=k,
                                               metric=metric)
        assert TK.launch_counts["ash_score_coarse_topk"] == before + 1
        vs, vi = TR.stable_top_k(TR.mask_rows_ref(full, n_valid, rv), k)
        assert torch.equal(ts, vs), (n_valid, rv is None)
        assert torch.equal(ti, vi.to(torch.int32)), (n_valid, rv is None)


def test_ivf_on_card(cuda):
    """A small IVF index on the card: kernel route == plain route ids,
    a single-row search equals its row of the batch search, coarse with
    a covering shortlist equals coarse=None, and save/load round-trips
    bit for bit."""
    X = embedding_dataset(6000, 64, seed=0, device="cuda")
    Qm = embedding_dataset(16, 64, seed=1, device="cuda")
    index = AshIndex.build(torch.Generator().manual_seed(0), X,
                           ASHConfig(b=2, d=32, n_landmarks=16),
                           backend="ivf", keep_raw=True)
    TK.reset_launch_counts()
    for kw in (dict(k=50), dict(k=10, rerank=256), dict(k=10, coarse="int8"),
               dict(k=10, coarse="int8", rerank=256)):
        s, ids = index.search(Qm, nprobe=4, **kw)
        _, ids_plain = index.search(Qm, nprobe=4, use_kernel=False, **kw)
        assert (ids == ids_plain).float().mean() > 0.99, kw
        prep = index.prepare(Qm)
        one = dataclasses.replace(prep, **{
            f.name: getattr(prep, f.name)[5:6]
            for f in dataclasses.fields(prep)})
        s1, i1 = index.search_prepped(one, nprobe=4, **kw)
        assert torch.equal(s1, s[5:6]) and torch.equal(i1, ids[5:6]), kw
    counts = dict(TK.launch_counts)
    assert counts["ash_score_gather_topk"] >= 3 and counts[
        "ash_score_gather"] >= 1, counts
    a = index.search(Qm, k=10, nprobe=4)
    b = index.search(Qm, k=10, nprobe=4, coarse="int8", shortlist=10**7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    flat = AshIndex.from_parts(index.model, index.payload)
    fa = flat.search(Qm, k=10)
    fb = flat.search(Qm, k=10, coarse="int8", shortlist=10**7)
    assert torch.equal(fa[0], fb[0]) and torch.equal(fa[1], fb[1])
    fc = flat.search(Qm, k=10, coarse="int8")
    assert TK.launch_counts["ash_score_coarse_topk"] >= 1
    assert (fc[1] == fa[1]).float().mean() > 0.8


# -- kernel 7: decode attention over an ASH-compressed KV cache ----------
# Tolerance: rtol 1e-4 and atol 1e-5 x max(1, largest |plain value|):
# the reference's own kernel test (tests/test_kernels.py) uses rtol 1e-4,
# atol 1e-5 for grid values up to 15 (b <= 4); fp32 sums over S
# positions, split across blocks and combined, in another order than the
# plain version's, err in proportion to the values' size, which reaches
# 255 at b = 8.


def _kv_close(got, want):
    torch.testing.assert_close(
        got, want, rtol=1e-4, atol=1e-5 * max(1.0, want.abs().max().item()))


def _kv_inputs(seed, bk, bv, dk, dv, S, lead, G, device, *,
               scale_dtype=torch.float32, bias=True, mask_from=0):
    """Packed K/V codes (*lead, S, W) of quantized Gaussian vectors,
    scales, bias and a mask valid on [mask_from, S - 3)."""
    rng = np.random.default_rng(seed)
    kv = Q.quant(torch.from_numpy(rng.standard_normal(lead + (S, dk))), bk)
    vv = Q.quant(torch.from_numpy(rng.standard_normal(lead + (S, dv))), bv)
    pos = torch.arange(S)
    t = dict(
        q=torch.from_numpy(rng.standard_normal(lead + (G, dk)) * 0.1).float(),
        kc=Q.pack_codes(kv, bk), vc=Q.pack_codes(vv, bv),
        ks=(torch.from_numpy(rng.uniform(0.5, 1.5, lead + (S,))) * 0.05).to(
            scale_dtype),
        kb=(torch.from_numpy(rng.standard_normal(lead + (S,)) * 0.1).float()
            if bias else None),
        vs=torch.from_numpy(rng.uniform(0.5, 1.5, lead + (S,))).to(
            scale_dtype),
        mask=(pos >= mask_from) & (pos < S - 3),
    )
    return {k: None if v is None else v.to(device) for k, v in t.items()}


def _kv_both(t, bk, bv):
    from repro_torch.kernels import ash_kv_attn as KA

    before = KA.launch_counts["ash_kv_attn"]
    got = KA.ash_kv_attn_cuda(t["q"], t["kc"], t["ks"], t["kb"], t["vc"],
                              t["vs"], t["mask"], b_k=bk, b_v=bv)
    torch.cuda.synchronize()
    assert KA.launch_counts["ash_kv_attn"] == before + 1
    want = TR.ash_kv_attn_ref(t["q"], t["kc"], t["ks"], t["kb"], t["vc"],
                              t["vs"], bk, bv, mask=t["mask"])[0]
    return got, want


@pytest.mark.parametrize("bk", [1, 2, 4, 8])
@pytest.mark.parametrize("bv", [1, 2, 4, 8])
def test_kv_attn_kernel_vs_plain_bitrates(cuda, bk, bv):
    t = _kv_inputs(bk * 10 + bv, bk, bv, 128, 128, 1000, (2, 3), 3, cuda)
    got, want = _kv_both(t, bk, bv)
    _kv_close(got, want)


@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("S,mask_from", [(77, 0), (513, 0), (4099, 700),
                                         (300, 200)])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_kv_attn_kernel_edges(cuda, G, S, mask_from, scale_dtype, bias):
    """Ragged S, a leading fully masked stretch (longer than a tile and a
    split), bf16 or fp32 scales, bias or none, G heads per stream."""
    t = _kv_inputs(S + G, 4, 2, 96, 64, S, (5,), G, cuda,
                   scale_dtype=scale_dtype, bias=bias, mask_from=mask_from)
    got, want = _kv_both(t, 4, 2)
    _kv_close(got, want)


@pytest.mark.parametrize("dk,dv", [(40, 24), (56, 20)])
def test_kv_attn_kernel_unaligned_rows(cuda, dk, dv):
    """Packed rows of 5 or 7 K words and 6 or 5 V words (b = 4 and 8;
    not 16-byte multiples): the kernel's 4-byte copy path."""
    t = _kv_inputs(dk, 4, 8, dk, dv, 900, (3, 2), 3, cuda)
    got, want = _kv_both(t, 4, 8)
    _kv_close(got, want)


def test_kv_attn_kernel_reads_layer_cache_in_place(cuda):
    """The (B, S, KV, W) layer cache permuted to (B, KV, S, W) as a view,
    bf16 scales of the same layout, a broadcast (S,) mask, no bias."""
    B, S, KV, G, b = 3, 700, 2, 3, 4
    rng = np.random.default_rng(3)
    vals = Q.quant(torch.from_numpy(rng.standard_normal((2, B, S, KV, 128))),
                   b)
    codes = Q.pack_codes(vals, b).to(cuda)  # (2, B, S, KV, 16)
    scales = torch.from_numpy(rng.uniform(0.01, 0.1, (2, B, S, KV))).to(
        cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, KV, G, 128))).float().to(cuda)
    mask = torch.arange(S, device=cuda) <= 650
    args = (q, codes[0].permute(0, 2, 1, 3), scales[0].permute(0, 2, 1),
            None, codes[1].permute(0, 2, 1, 3), scales[1].permute(0, 2, 1),
            mask)
    from repro_torch.kernels import ops

    got = ops.ash_kv_attention(*args, b_k=b, b_v=b)
    want = ops.ash_kv_attention(*args, b_k=b, b_v=b, use_kernel=False)
    _kv_close(got, want)


def test_kv_attn_wrapper_refuses_bad_operands(cuda):
    from repro_torch.kernels import ash_kv_attn as KA

    t = _kv_inputs(1, 4, 4, 128, 128, 200, (2,), 3, cuda)
    args = [t["q"], t["kc"], t["ks"], t["kb"], t["vc"], t["vs"], t["mask"]]
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError, match="q_k"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    bad = list(args)
    bad[5] = bad[5].to(torch.bfloat16)
    with pytest.raises(ValueError, match="scales"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    bad = list(args)
    bad[0] = torch.zeros(2, 9, 128, device=cuda)
    with pytest.raises(ValueError, match="q_k"):
        KA.ash_kv_attn_cuda(*bad, b_k=4, b_v=4)
    with pytest.raises(ValueError, match="bitrates"):
        KA.ash_kv_attn_cuda(*args, b_k=3, b_v=4)


@pytest.mark.parametrize("kv_quant_bits", [0, 4])
def test_decode_step_on_card_matches_cpu(cuda, kv_quant_bits):
    """A 2-layer float32 model decoding 10 steps on the card (through
    kernel 7 for the ASH-KV cache) against the same parameters on the
    CPU (plain attention): logits within 1e-3 of the largest |logit|
    (fp32 products and sums in other orders, through two layers), and
    at least 99 % of the packed codes equal (an encode's projection
    near a quantizer breakpoint may round the other way)."""
    from repro_torch.kernels import ash_kv_attn as KA
    from repro_torch.models import transformer as TT

    cfg = TT.TransformerConfig(
        name="t", n_layers=2, d_model=64, n_heads=6, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=96, dtype=torch.float32, param_dtype=torch.float32,
        q_chunk=0, kv_quant_bits=kv_quant_bits)
    p_cpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    p_gpu = TT.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu").to(cuda)
    c_cpu = TT.init_cache(cfg, 3, 16, device="cpu")
    c_gpu = TT.init_cache(cfg, 3, 16, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 96, (3, 10)))
    KA.reset_launch_counts()
    for t in range(10):
        a, c_cpu = TT.decode_step(p_cpu, c_cpu, toks[:, t], t, cfg)
        b, c_gpu = TT.decode_step(p_gpu, c_gpu, toks[:, t].to(cuda), t, cfg)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-3,
                                   atol=1e-3 * a.abs().max().item())
    if kv_quant_bits:
        assert KA.launch_counts["ash_kv_attn"] == 10 * cfg.n_layers
        for name in ("k_codes", "v_codes"):
            same = (c_gpu[name].cpu() == c_cpu[name]).float().mean().item()
            assert same >= 0.99, (name, same)
        # the kernel route against the plain route on the card
        c2 = TT.init_cache(cfg, 3, 16, device=cuda)
        for t in range(10):
            b2, c2 = TT.decode_step(p_gpu, c2, toks[:, t].to(cuda), t, cfg,
                                    use_kernel=False)
        torch.testing.assert_close(b2, b, rtol=1e-3,
                                   atol=1e-3 * b.abs().max().item())
