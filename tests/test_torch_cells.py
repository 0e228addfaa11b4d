"""The cell programs of ``repro_torch.configs.base`` against the
reference's ``repro.configs.base``.

* Arguments: on a (data=2, model=2) mesh the port's per-card argument
  bytes (``launch.analysis.argument_bytes``, exact from the specs)
  EQUAL XLA's ``memory_analysis().argument_size_in_bytes`` of a
  compiled program of the reference's cell arguments, on the
  conftest's 4 CPU devices.
* Programs: each of the ten cell builders at a reduced arch and a
  shrunken cell on a 1 x 1 mesh; the port's ``fn`` on real CPU tensors
  equals the reference's on the same numpy inputs and converted
  parameters (fp32 reduced models: losses, norms and outputs to
  rtol 1e-5; parameters after a step as ``test_torch_sasrec``'s
  ``params_close``).  The same program on real DTensors of a 1 x 1 mesh
  (its sharded branches: attention and losses on local shards, the MoE
  per group) gives the plain result.
* The hook: left at its default it is the identity; ``layer_params``
  gives each layer weight its parameter spec.
* Host reads: ``expert_counts`` (the static-shape bincount) and the
  optimizer's scalars under a fake mode give the same values.
* Every fake process group is destroyed after the test that made it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as JR
from repro.configs.base import Cell as JCell
from repro.launch import sharding as JSH
from repro.launch import train as JL
from repro.train import trainer as JTR
from repro_torch.configs import base as TB
from repro_torch.configs import registry as TR
from repro_torch.launch import analysis as AN
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as TL
from repro_torch.models import convert
from repro_torch.models import moe as TMOE
from repro_torch.train import optim as TO
from repro_torch.train import trainer as TTR

from test_torch_sasrec import _close, params_close


@pytest.fixture(autouse=True)
def _no_world_left():
    yield
    assert not dist.is_initialized()


# -- argument bytes vs XLA -------------------------------------------------------


@pytest.mark.parametrize("arch_id,cell", [
    ("llama3.2-3b", "train_4k"), ("llama3.2-3b", "decode_32k_ashkv"),
    ("sasrec", "retrieval_cand_ash"), ("dcn-v2", "serve_p99"),
    ("nequip", "molecule"),
])
def test_argument_bytes_equal_xla(arch_id, cell):
    jarch = JL.reduced_arch(JR.get(arch_id))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    _, args = jarch.make_cell_program(cell, mesh, JSH.ShardingPolicy())
    # XLA compiles a program of the cell's arguments (all kept): the
    # reference's own train step does not lower on this mesh under this
    # JAX, its embedding gather being given P('data', None, 'data')
    want = jax.jit(lambda *a: 0, keep_unused=True).lower(
        *args).compile().memory_analysis().argument_size_in_bytes
    arch = TL.reduced_arch(TR.get(arch_id))
    with TM.mesh_context((2, 2), ("data", "model")) as tmesh:
        _, targs = arch.make_cell_program(cell, tmesh, SH.ShardingPolicy())
        got = AN.argument_bytes(targs)
    assert got == want


# -- programs on real tensors -------------------------------------------------------


CELLS = {
    "transformer": [JCell("train", "train", {"seq_len": 16,
                                              "global_batch": 4}),
                    JCell("prefill", "prefill", {"seq_len": 16,
                                                  "global_batch": 2}),
                    JCell("decode", "decode", {"seq_len": 16,
                                                "global_batch": 2}),
                    JCell("ashkv", "decode", {"seq_len": 16,
                                               "global_batch": 2,
                                               "kv_quant_bits": 4,
                                               "kv_quant_dim": 0})],
    "nequip": [JCell("mol", "train", {"n_nodes": 30, "n_edges": 64,
                                       "n_graphs": 2}),
               JCell("feat", "train", {"n_nodes": 40, "n_edges": 100,
                                        "d_feat": 6, "edge_chunks": 4})],
    "recsys": [JCell("train", "train", {"batch": 8}),
               JCell("serve", "serve", {"batch": 4}),
               JCell("retr", "retrieval", {"batch": 1,
                                            "n_candidates": 16})],
    "sasrec": [JCell("train", "train", {"batch": 4}),
               JCell("serve", "serve", {"batch": 3}),
               JCell("retr", "retrieval", {"batch": 2, "n_candidates": 32}),
               JCell("ash", "retrieval", {"batch": 2, "n_candidates": 32,
                                           "ash_bits": 4, "ash_reduce": 2})],
}
CASES = [(a, c.name) for a, fam in (
    ("llama3.2-3b", "transformer"), ("granite-moe-3b-a800m", "transformer"),
    ("nequip", "nequip"), ("dcn-v2", "recsys"), ("autoint", "recsys"),
    ("sasrec", "sasrec")) for c in CELLS[fam]
    if not (a == "granite-moe-3b-a800m" and c.name == "ashkv")]


def _archs(arch_id, cell_name):
    jarch = JL.reduced_arch(JR.get(arch_id))
    cell = {c.name: c for c in CELLS[jarch.family]}[cell_name]
    jarch = dataclasses.replace(jarch, cells={cell_name: cell})
    tcell = TB.Cell(cell.name, cell.kind, cell.shape, cell.skip)
    arch = dataclasses.replace(TL.reduced_arch(TR.get(arch_id)),
                               cells={cell_name: tcell})
    return jarch, arch, tcell


def _cell_cfg(arch, cell):
    """The config the cell's program runs (its builder's overrides)."""
    s, kw = cell.shape, {}
    if s.get("kv_quant_bits"):
        kw = dict(kv_quant_bits=s["kv_quant_bits"],
                  kv_quant_dim=s.get("kv_quant_dim", 0))
    if s.get("d_feat"):
        kw["d_feat_in"] = s["d_feat"]
    if s.get("edge_chunks"):
        kw["edge_chunks"] = s["edge_chunks"]
    return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, **kw))


def _values(name, shape, dtype, cfg, rng):
    """Numpy inputs for a program argument named ``name``."""
    n = int(np.prod(shape)) if shape else 1
    if name in ("tokens", "labels") and dtype == torch.int32 \
            and hasattr(cfg, "vocab"):
        return rng.integers(0, cfg.vocab, shape).astype(np.int32)
    if name in ("seq", "labels") and hasattr(cfg, "n_items"):
        seq = rng.integers(0, cfg.n_items, shape).astype(np.int32)
        seq[..., : shape[-1] // 3] = 0  # left padding
        return seq
    if name in ("negatives", "cand_ids") and hasattr(cfg, "n_items"):
        return rng.integers(1, cfg.n_items, shape).astype(np.int32)
    if name == "sparse":
        return rng.integers(0, cfg.vocab_per_field, shape).astype(np.int32)
    if name == "cand_ids":
        return rng.integers(0, cfg.vocab_per_field, shape).astype(np.int32)
    if name == "labels":  # recsys clicks
        return rng.integers(0, 2, shape).astype(np.float32)
    if name in ("edge_src", "edge_dst"):
        return rng.integers(0, shape[0] // 8, shape).astype(np.int32)
    if name in ("edge_mask", "node_mask"):
        return rng.random(shape) < 0.9
    if name == "species":
        return rng.integers(0, cfg.n_species, shape).astype(np.int32)
    if name == "graph_ids":
        return np.sort(rng.integers(0, 2, shape)).astype(np.int32)
    if name == "codes":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(
            np.int32)
    if name == "positions":
        return (2.0 * rng.standard_normal(shape)).astype(np.float32)
    if dtype == torch.bfloat16:
        return rng.standard_normal(n).reshape(shape).astype(np.float32)
    if dtype == torch.int32:
        return np.full(shape, 5, np.int32)  # the decode position
    return rng.standard_normal(shape).astype(np.float32)


def _pair(v, dtype):
    """(JAX, port) arrays of numpy ``v`` in ``dtype``."""
    t = torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
    if dtype == torch.bfloat16:
        return jnp.asarray(v, jnp.bfloat16), t
    if dtype == torch.int32 and v.dtype == np.int32 and v.min() < 0:
        return jnp.asarray(v.view(np.uint32)), t  # packed code words
    return jnp.asarray(v), t


def _inputs(arch, fn_args, rng):
    """Real inputs shaped as the port's fake ``fn_args``: (JAX, port) per
    argument; the parameters / state (the first argument) from the
    reference's init."""
    key = jax.random.PRNGKey(0)
    jfam = {"transformer": "transformer", "nequip": "nequip",
            "recsys": "recsys", "sasrec": "sasrec"}[arch.family]
    from repro import models as JM
    jcfg = _jcfg(arch)
    jparams = getattr(JM, jfam).init_params(key, jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    out_j, out_t = [], []
    for i, a in enumerate(fn_args):
        if i == 0 and not isinstance(a, TTR.TrainState):  # parameters
            kvq = getattr(arch.cfg, "kv_quant_bits", 0)
            out_j.append(jparams)
            out_t.append(convert.params_from_numpy(
                tree, arch.cfg, device="cpu") if not kvq else None)
        elif isinstance(a, TTR.TrainState):
            pt = convert.params_from_numpy(tree, arch.cfg, device="cpu")
            out_j.append(JTR.init_state(key, jparams, _jtrain(arch)))
            out_t.append(TTR.init_state(0, pt, arch.train_cfg))
        elif isinstance(a, dict) and "k_codes" in a or (
                isinstance(a, dict) and "k" in a and "v" in a):
            cj, ct = {}, {}
            for k, t in a.items():
                v = _values(k, tuple(t.shape), t.dtype, arch.cfg, rng)
                if "codes" in k:
                    v = rng.integers(-2**31, 2**31, t.shape,
                                     dtype=np.int64).astype(np.int32)
                else:
                    v = np.abs(v)
                cj[k], ct[k] = _pair(v, t.dtype)
            out_j.append(cj)
            out_t.append(ct)
        elif isinstance(a, dict):
            bj, bt = {}, {}
            for k, t in a.items():
                v = _values(k, tuple(t.shape), t.dtype, arch.cfg, rng)
                bj[k], bt[k] = _pair(v, t.dtype)
            out_j.append(bj)
            out_t.append(bt)
        elif isinstance(a, torch.Tensor) and a.dim() == 0:
            out_j.append(jnp.int32(5))
            out_t.append(torch.tensor(5, dtype=torch.int32))
        else:
            name = ("tokens" if arch.family == "transformer"
                    else "cand_ids" if a.dim() == 1 else "seq")
            v = _values(name, tuple(a.shape), a.dtype, arch.cfg, rng)
            j, t = _pair(v, a.dtype)
            out_j.append(j)
            out_t.append(t)
    return out_j, out_t


def _jcfg(arch):
    """The reference's config equal to the port's ``arch.cfg``."""
    jarch = JL.reduced_arch(JR.get(arch.arch_id))
    kw = {f.name: getattr(arch.cfg, f.name)
          for f in dataclasses.fields(arch.cfg)
          if f.name in ("kv_quant_bits", "kv_quant_dim", "d_feat_in",
                        "edge_chunks")}
    return dataclasses.replace(jarch.cfg, **kw)


def _jtrain(arch):
    return JL.reduced_arch(JR.get(arch.arch_id)).train_cfg


def _np_out(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("arch_id,cell_name", CASES)
def test_program_equals_reference(arch_id, cell_name):
    jarch, arch, cell = _archs(arch_id, cell_name)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jfn, _ = jarch.make_cell_program(cell_name, jmesh, JSH.ShardingPolicy())
    with TM.mesh_context((1, 1), ("data", "model")) as mesh:
        fn, fake_args = arch.make_cell_program(cell_name, mesh,
                                               SH.ShardingPolicy())
    arch = _cell_cfg(arch, cell)
    rng = np.random.default_rng(7)
    ja, ta = _inputs(arch, fake_args, rng)
    if ta[0] is None:  # ASH-KV projections: the reference's, converted
        ta[0] = convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, ja[0]), arch.cfg,
            device="cpu")
    jout = jax.jit(jfn)(*ja)
    tout = fn(*ta)
    if cell.kind == "train":
        (sj, mj), (st, mt) = jout, tout
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[m]), float(mj[m]),
                                       rtol=1e-5)
        assert int(st.step) == int(sj.step) == 1
        loss = jarch.loss_fn(lambda a, k: a)
        if jarch.family == "nequip" and cell.shape.get("n_graphs", 1) > 1:
            base_loss = loss
            loss = lambda p, b: base_loss(p, dict(b, n_graphs=2))  # noqa
        g = jax.grad(loss)(ja[0].params, ja[1])
        params_close(convert.params_to_numpy(st.params),
                     jax.tree_util.tree_map(np.asarray, sj.params),
                     jax.tree_util.tree_map(np.asarray, g),
                     lr_sum=TO.lr_at(arch.train_cfg.opt, 1))
    elif cell.kind == "decode":
        (lj, cj), (lt, ct) = jout, tout
        _close(_np_out(lt), _np_out(lj))
        for k in cj:
            got = convert.cache_to_numpy(ct)[k]
            np.testing.assert_array_equal(
                np.asarray(got).view(np.uint8),
                np.asarray(cj[k]).view(np.uint8)) if "codes" in k else \
                _close(np.asarray(got, np.float64),
                       np.asarray(cj[k], np.float64))
    else:
        _close(_np_out(tout), _np_out(jout))


@pytest.mark.parametrize("arch_id,cell_name", [
    ("llama3.2-3b", "train"), ("granite-moe-3b-a800m", "prefill"),
    ("llama3.2-3b", "decode"), ("nequip", "feat"), ("sasrec", "serve"),
])
def test_program_on_one_card_dtensors_equals_plain(arch_id, cell_name):
    """The sharded branches (``common.on_local_shards``, the MoE per
    group, the cache attention on its slice, the interleaved edge
    chunks) on real DTensors of a 1 x 1 mesh give the plain result."""
    from torch.distributed.tensor import DTensor

    _, arch, cell = _archs(arch_id, cell_name)
    if cell.kind == "prefill":  # 2 MoE groups: DTensor cannot merge a
        # sharded group dim of size 1 (a 1 x 1 mesh's), other meshes can
        cell = dataclasses.replace(cell, shape={"seq_len": 16,
                                                "global_batch": 8})
        arch = dataclasses.replace(arch, cells={cell_name: cell})
    rng = np.random.default_rng(3)
    with TM.mesh_context((1, 1), ("data", "model")) as mesh:
        fn, fake_args = arch.make_cell_program(cell_name, mesh,
                                               SH.ShardingPolicy())
        arch = _cell_cfg(arch, cell)
        plain = _inputs(arch, fake_args, rng)[1]
        rng = np.random.default_rng(3)
        again = _inputs(arch, fake_args, rng)[1]
        # the same values as DTensors, sharded (trivially) by the specs
        shard = TB._sharded_state if cell.kind == "train" else None
        dargs = []
        for a, f in zip(again, fake_args):
            dargs.append(_like(a, f, mesh, arch, shard))
        want = fn(*plain)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            got = fn(*dargs)

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    if cell.kind == "train":
        for m in ("loss", "grad_norm"):
            assert float(local(got[1][m])) == pytest.approx(
                float(want[1][m]), rel=1e-6)
    elif cell.kind == "decode":
        _close(_np_out(local(got[0])), _np_out(want[0]), rtol=1e-6)
    else:
        _close(_np_out(local(got)), _np_out(want), rtol=1e-6)


def _like(a, fake, mesh, arch, shard):
    """Real ``a`` distributed as the fake argument ``fake`` is."""
    from torch.distributed.tensor import distribute_tensor

    def d(t, f):
        if not isinstance(f, torch.Tensor) or not hasattr(f, "placements"):
            return t
        return distribute_tensor(t, f.device_mesh, f.placements,
                                 src_data_rank=None)

    if isinstance(a, TTR.TrainState):
        prules = arch.param_rules(mesh, arch.policy(SH.ShardingPolicy()))
        params = TB.shard_params(arch, a.params, mesh, lambda p, t:
                                 TB.state_spec(prules, "params/" + p,
                                               tuple(t.shape)), True)
        opt = type(a.opt_state)(**{
            k: v if isinstance(v, torch.Tensor) else SH.map_with_path(
                lambda p, t: SH.distribute(t, mesh, SH.P()), v)
            for k, v in a.opt_state._asdict().items()})
        return TTR.TrainState(params, opt, a.ef_state, a.step, a.rng)
    if isinstance(a, dict):
        return {k: d(v, fake[k]) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return d(a, fake)
    prules = arch.param_rules(mesh, SH.ShardingPolicy())
    return TB.shard_params(arch, a, mesh,
                           lambda p, t: prules(p, tuple(t.shape)), False)


# -- the hook -------------------------------------------------------------------


def test_default_hook_is_identity_and_layer_params_take_their_specs():
    from repro_torch.models import common as TC
    from repro_torch.models import transformer as TT

    t = torch.ones(2, 3)
    assert TC.keep(t, "resid") is t
    arch = TL.reduced_arch(TR.get("llama3.2-3b"))
    with TM.mesh_context((2, 2), ("data", "model")) as mesh:
        pol = SH.ShardingPolicy()
        hook = SH.make_constrain(mesh, pol, arch.param_rules(mesh, pol))
        assert hook(t, "resid") is t  # plain tensors pass through
        with TB.fake_mode():
            params = TB._sharded_params(arch, mesh, pol)
            lp = hook(params.layers[0], "layer_params")
        rules = arch.param_rules(mesh, pol)
        for name in TT.Layer.NAMES + TT.Layer.FFN_NAMES:
            w = getattr(lp, name)
            spec = rules("layers/" + name, (None,) + tuple(w.shape))
            assert list(w.placements) == SH.placements(
                SH.P(*spec[1:w.ndim + 1]), mesh), name


# -- host reads -----------------------------------------------------------------


def test_static_shape_paths_give_the_same_values():
    e = torch.tensor([3, 0, 3, 7, 1, 3])
    assert torch.equal(TMOE.expert_counts(e, 9), torch.bincount(e,
                                                                minlength=9))
    cfg = TO.OptConfig(warmup_steps=3, total_steps=10)
    want = [TO.lr_at(cfg, s) for s in range(12)]
    with TB.fake_mode():
        step = TO._step0()
        got = []
        for _ in range(12):
            got.append(TO.lr_at(cfg, step))
            step = TO.next_step(step)
        assert type(step) is torch.Tensor
        corr = TO._pow_correction(0.9, step)
    assert int(step) == 12
    assert corr == pytest.approx(1 - 0.9 ** 12, rel=1e-6)
    assert got == want
