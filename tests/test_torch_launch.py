"""The port's launch tools (``repro_torch.launch.{mesh,sharding,roofline,
analysis}`` and ``configs.base``'s cells) held against the reference's
``repro.launch`` and ``repro.configs``: every spec, cell and useful-FLOP
count EQUAL, on the reference's TPU meshes and on the H100 meshes; the
roofline algebra at the H100 constants; the probe identity of the
traced FLOP count.  Rule checks need no devices (duck-typed meshes);
traces run on a fake process group made and destroyed per test."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as JB
from repro.configs import registry as JR
from repro.launch import roofline as JRL
from repro.launch import sharding as JSH
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.launch import analysis as AN
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch.train import reduced_arch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()  # every fake world destroyed


class FakeMesh:
    """Duck-typed mesh: shape mapping only (rule logic needs no devices)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "tpu1": FakeMesh(data=16, model=16),
    "tpu2": FakeMesh(pod=2, data=16, model=16),
    "h100": FakeMesh(data=32, model=8),
    "h100x2": FakeMesh(pod=2, data=32, model=8),
}
ARCH_IDS = sorted(TR.ARCHS)


def _t(spec):
    return tuple(spec)


# -- pick / fit_spec ----------------------------------------------------------


def test_pick_divisibility():
    for mod in (SH, JSH):
        m1, m2 = MESHES["tpu1"], MESHES["tpu2"]
        assert mod.pick(m1, 64, "model") == "model"
        assert mod.pick(m1, 40, "model", "pod") is None  # no pod axis
        assert mod.pick(m2, 40, "model", "pod") == "pod"
        assert mod.pick(m2, 1_000_000, ("pod", "data", "model"),
                        ("pod", "data")) == ("pod", "data")
        assert mod.pick(m1, 7, "data", "model") is None
    h = MESHES["h100x2"]
    assert SH.pick(h, 40, "model", "pod") == "model"  # 40 % 8 == 0


@pytest.mark.parametrize("spec,ndim", [
    ((None, "model", "pod", None), 3), (("data", "model"), 2),
    (("data", "model"), 1), ((None, None, None), 1), ((), 0),
])
def test_fit_spec(spec, ndim):
    got = SH.fit_spec(SH.P(*spec), ndim)
    assert _t(got) == _t(JSH.fit_spec(JSH.P(*spec), ndim))


# -- parameter and train-state specs -------------------------------------------


def _ref_state_specs(arch_id, mesh):
    arch = JR.get(arch_id)
    pol = JSH.ShardingPolicy(**arch.policy_overrides)
    prules = arch.param_rules(mesh, pol)
    state = arch.abstract_state()
    out = {}

    def spec_for(path, leaf):
        p = JB._strip_state_prefix(JSH._path_str(path))
        if p is None or not leaf.shape:
            spec = JSH.P()
        else:
            try:
                spec = JSH.fit_spec(prules(p, tuple(leaf.shape)),
                                    len(leaf.shape))
            except Exception:
                spec = JSH.P()
        out[JSH._path_str(path)] = (tuple(leaf.shape), _t(spec))

    jax.tree_util.tree_map_with_path(spec_for, state)
    return out


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_state_and_param_specs_equal_reference(arch_id, mesh_id):
    """Every leaf of the full-size train state (params, moments, counters)
    has the reference's path, shape and spec, on all four meshes."""
    mesh = MESHES[mesh_id]
    arch = TR.get(arch_id)
    pol = arch.policy(SH.ShardingPolicy())
    want = _ref_state_specs(arch_id, mesh)
    with TB.fake_mode():
        state = arch.abstract_state()
        shapes = {p: tuple(t.shape) for p, t in TB.state_items(state)}
    specs = TB.state_specs(arch, mesh, pol)
    got = {p: (shapes[p], _t(specs[p])) for p in shapes}
    assert got == want
    # the parameters alone, through specs_by_rules as the serve cells do
    with TB.fake_mode():
        tree = TB.param_tree(arch.abstract_params())
    got_p = {SH.path_str(p): _t(s) for p, s in SH.tree_items(
        SH.specs_by_rules(tree, arch.param_rules(mesh, pol)))}
    jarch = JR.get(arch_id)
    jspecs = JSH.specs_by_rules(jarch.abstract_params(),
                                jarch.param_rules(mesh, JSH.ShardingPolicy(
                                    **jarch.policy_overrides)))
    want_p = {}
    jax.tree_util.tree_map_with_path(
        lambda path, s: want_p.__setitem__(JSH._path_str(path), _t(s)),
        jspecs, is_leaf=lambda x: isinstance(x, JSH.P))
    assert got_p == want_p


SHAPES = [(), (7,), (64, 3), (128, 50), (256, 4096), (2, 128, 32768, 8, 128),
          (4, 96, 4096, 8, 16), (61, 512, 32768, 8, 128), (1, 1, 1, 1)]


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_batch_and_kv_cache_rules_equal_reference(mesh_id):
    mesh = MESHES[mesh_id]
    for fsdp in (True, False):
        pt, pj = SH.ShardingPolicy(fsdp=fsdp), JSH.ShardingPolicy(fsdp=fsdp)
        for rt, rj in ((SH.batch_rules_leading_dp, JSH.batch_rules_leading_dp),
                       (SH.kv_cache_rules, JSH.kv_cache_rules)):
            t, j = rt(mesh, pt), rj(mesh, pj)
            for shape in SHAPES:
                assert _t(t("x", shape)) == _t(j("x", shape)), shape


KINDS = ["resid", "qkv", "kv", "ffn_hidden", "attn_out", "v", "logits",
         "moe_buffer", "node_feats", "edge_feats", "edge_chunked", "other"]
KIND_SHAPES = {
    "resid": [(256, 4096, 3072), (32, 32768, 8192), (3, 5, 7)],
    "qkv": [(256, 4096, 24, 128), (32, 1, 64, 128)],
    "kv": [(256, 4096, 8, 128), (8, 16, 2, 16)],
    "ffn_hidden": [(256, 4096, 8192), (32, 16, 29568)],
    "attn_out": [(256, 4096, 24, 128)], "v": [(128, 4096, 8, 128)],
    "logits": [(256, 4096, 128256), (32, 1, 49155)],
    "moe_buffer": [(256, 40, 820, 1536), (64, 384, 81, 7168), (2, 8, 3, 4)],
    "node_feats": [(3840, 32, 5), (2449408, 32, 1)],
    "edge_feats": [(8192, 32, 5), (61859328, 32)],
    "edge_chunked": [(16, 3866208, 32), (8, 399360)],
    "other": [(4, 4)],
}


@pytest.mark.parametrize("mesh_id", sorted(MESHES))
def test_activation_specs_equal_reference(mesh_id, monkeypatch):
    """``make_constrain``'s spec for every kind, policy switch and mesh is
    the one the reference's hook hands ``with_sharding_constraint``."""
    mesh = MESHES[mesh_id]
    seen = []
    monkeypatch.setattr(JSH, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda a, s: seen.append(s) or a)
    for flags in ({}, {"seq_parallel": True}, {"pin_ffn_hidden": False},
                  {"pin_attn_boundary": False}, {"shard_moe_buffer": False}):
        pt, pj = SH.ShardingPolicy(**flags), JSH.ShardingPolicy(**flags)
        hook = JSH.make_constrain(mesh, pj)
        for kind in KINDS:
            for shape in KIND_SHAPES[kind]:
                seen.clear()
                hook(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
                want = _t(seen[0]) if seen else None
                got = SH.activation_spec(mesh, pt, kind, shape)
                assert (None if got is None else _t(got)) == want, (
                    kind, shape, flags)


# -- cells and useful FLOPs ---------------------------------------------------


def _cells(archs):
    return [(a.arch_id, c.name, c.kind, c.shape, c.skip)
            for a in archs for c in a.cells.values()]


def test_cells_equal_reference():
    for inc in (True, False):
        got = [(a.arch_id, c.name, c.kind, c.shape, c.skip)
               for a, c in TR.all_cells(inc)]
        want = [(a.arch_id, c.name, c.kind, c.shape, c.skip)
                for a, c in JR.all_cells(inc)]
        assert got == want
    assert _cells(TR.ARCHS.values()) == _cells(JR.ARCHS.values())
    assert len(list(TR.all_cells(False))) == 35
    for arch_id in ARCH_IDS:
        t, j = TR.get(arch_id), JR.get(arch_id)
        assert t.policy_overrides == j.policy_overrides
        # the reference's notes, its TPU named generically in qwen's
        assert t.notes == j.notes.replace("v5e HBM", "the TPU's HBM")
        assert t.cell("train_batch" if t.family in ("recsys", "sasrec")
                      else "molecule" if t.family == "nequip"
                      else "train_4k").kind == "train"
    from repro_torch import configs
    assert configs.DECODE_32K_ASHKV == JB.lm_cells()["decode_32k_ashkv"].shape
    assert [TB.pad_to(n, 512) for n in (0, 1, 512, 513)] == [
        JB.pad_to(n, 512) for n in (0, 1, 512, 513)]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_model_flops_equal_reference(arch_id):
    t, j = TR.get(arch_id), JR.get(arch_id)
    for name, cell in j.cells.items():
        want = JRL.model_flops_for(j, cell)
        got = RL.model_flops_for(t, t.cell(name))
        assert got == pytest.approx(want, rel=1e-12), name


# -- roofline and cost algebra --------------------------------------------------


def test_h100_constants():
    assert RL.PEAK_FLOPS == 989.4e12 and RL.HBM_BW == 3.35e12
    assert RL.HBM_BYTES == 80e9
    assert RL.link_bw("model") == 450e9
    assert RL.link_bw("data") == RL.link_bw("pod") == 50e9


def test_roofline_terms_and_bottleneck():
    r = RL.Roofline(flops=RL.PEAK_FLOPS, hbm_bytes=2 * RL.HBM_BW,
                    collective_bytes=0.0, n_chips=256,
                    model_flops=RL.PEAK_FLOPS / 2,
                    axis_bytes={"model": 450e9, "data": 50e9})
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(2.0)  # 1 s NVLink + 1 s IB
    assert r.bottleneck == "memory"  # ties go to the first maximum
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert r.roofline_frac == pytest.approx(0.25)
    r2 = dataclasses.replace(r, axis_bytes={"data": 150e9})
    assert r2.t_collective == pytest.approx(3.0)
    assert r2.bottleneck == "collective"
    r3 = dataclasses.replace(r, axis_bytes=None, collective_bytes=100e9)
    assert r3.t_collective == pytest.approx(2.0)  # all over InfiniBand
    row = r.row()
    assert row["bottleneck"] == "memory" and row["t_compute_s"] == 1.0
    z = RL.Roofline(0.0, 0.0, 0.0, 1)
    assert z.roofline_frac == 0.0 and z.useful_flops_frac is None


def test_costvec_algebra():
    a, b = AN.CostVec(1.0, 2.0, 3.0), AN.CostVec(0.5, 0.5, 0.5)
    assert (a + b) == AN.CostVec(1.5, 2.5, 3.5)
    assert (a - b) == AN.CostVec(0.5, 1.5, 2.5)
    assert 2 * a == a * 2 == AN.CostVec(2.0, 4.0, 6.0)
    f1, f2 = AN.CostVec(10.0, 20.0, 1.0), AN.CostVec(13.0, 27.0, 2.0)
    layer = f2 - f1
    assert (f1 - layer) + 5 * layer == AN.CostVec(22.0, 48.0, 5.0)


# -- meshes ---------------------------------------------------------------------


def test_mesh_builders():
    for multi, n in ((False, 256), (True, 512)):
        with TM.production_mesh(multi_pod=multi) as mesh:
            assert dist.get_world_size() == n
            assert TM.mesh_size(mesh) == n
            assert mesh.name == ("2x32x8" if multi else "32x8")
            assert TM.dp_axes(mesh) == (("pod", "data") if multi
                                        else ("data",))
            assert mesh.device_mesh.shape == tuple(mesh.shape.values())
        assert not dist.is_initialized()
    with TM.fake_world(4):
        with pytest.raises(RuntimeError):
            with TM.fake_world(4):
                pass
    tm = TM.make_test_mesh()
    assert tm.devices == (torch.device("cpu"),) and TM.mesh_size(tm) == 1
    assert TM.make_test_mesh(axes=("pod", "data", "model")).shape == {
        "pod": 1, "data": 1, "model": 1}


def test_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = MESHES["h100x2"]
    assert SH.placements(SH.P(None, ("pod", "data"), "model"), m) == [
        Shard(1), Shard(1), Shard(2)]
    assert SH.placements(SH.P(), m) == [Replicate()] * 3


# -- traces ---------------------------------------------------------------------


def _tiny(arch_id, n_layers):
    arch = reduced_arch(TR.get(arch_id))
    return dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=n_layers))


@pytest.mark.parametrize("arch_id,cell", [
    ("llama3.2-3b", TB.Cell("t", "train", {"seq_len": 32,
                                            "global_batch": 8})),
    ("granite-moe-3b-a800m", TB.Cell("p", "prefill", {"seq_len": 32,
                                                       "global_batch": 4})),
    ("deepseek-7b", TB.Cell("d", "decode", {"seq_len": 64,
                                             "global_batch": 4})),
])
def test_probe_identity_of_traced_flops(arch_id, cell):
    """F(L) = e + L·l: the full-depth trace of a 4-layer model equals the
    algebra of its 1- and 2-layer traces, on a 2 x 2 mesh."""
    arch = dataclasses.replace(_tiny(arch_id, 4), cells={cell.name: cell})
    with TM.mesh_context((2, 2), ("data", "model")) as mesh:
        got = AN.probe_check(arch, cell, mesh, SH.ShardingPolicy())
    assert got["flops"] > 0
    assert got["probe_flops"] == got["flops"]


def test_trace_counts_local_work():
    """On a 1 x 1 mesh the trace's FLOPs are ``FlopCounterMode``'s of the
    plain step; on 2 x 2 each card does a quarter of the matrix products
    or more, and the collectives go to named mesh axes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train import trainer as TTR

    arch = dataclasses.replace(_tiny("llama3.2-3b", 2))
    cell = TB.Cell("t", "train", {"seq_len": 32, "global_batch": 8})
    arch = dataclasses.replace(arch, cells={"t": cell})
    with TM.mesh_context((1, 1), ("data", "model")) as mesh:
        one = AN.trace_cell(arch, cell, mesh, SH.ShardingPolicy())
    with TM.mesh_context((2, 2), ("data", "model")) as mesh:
        four = AN.trace_cell(arch, cell, mesh, SH.ShardingPolicy())
    params = arch.model.init_params(torch.Generator().manual_seed(0),
                                    arch.cfg, device="cpu")
    state = TTR.init_state(0, params, arch.train_cfg)
    step = TTR.make_train_step(arch.loss_fn(), arch.train_cfg)
    batch = {k: torch.zeros(8, 32, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    assert one.cost.flops == fc.get_total_flops()
    assert one.coll.count_by_kind == {}
    assert fc.get_total_flops() / 4 <= four.cost.flops < one.cost.flops
    assert set(four.coll.bytes_by_axis) <= {"data", "model"}
    assert four.argument_bytes < one.argument_bytes
    assert 0 < one.argument_bytes <= one.peak_bytes
