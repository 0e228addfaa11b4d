"""Port parity: NequIP (``repro_torch.models.nequip``) and the graph data
(``repro_torch.data.graphs``), against the JAX package.

* The Gaunt tensors, ``tp_paths`` and the numpy spherical harmonics
  EQUAL to the reference's; the torch harmonics, Bessel basis and
  cutoff envelope to rtol 1e-5.
* Parameters come from the reference's ``init_params`` (bit for bit
  through ``convert``): per-graph energies, per-node outputs and the
  losses to rtol 1e-5, forces to 1e-4 x the largest |force|, every
  gradient leaf of the second-order molecule loss (and the first-order
  node loss) to 1e-4 x its largest |g|, with remat on and off and the
  edges in one chunk or two.
* One AdamW step of the reduced nequip through ``Arch.loss_fn`` (which
  closes over the batch's graph count) and ``make_train_step`` against
  the reference's jitted step, as in ``test_torch_sasrec.py``.
* The reference's symmetry, locality and padding tests
  (``tests/test_nequip.py``) repeated on the port.
* ``batch_small_graphs``, ``random_graph``, ``neighbor_sample`` and the
  launcher's graph batches EQUAL to the reference's.
"""
import functools
import math

import numpy as np
import pytest
import scipy.spatial.transform as sst

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.data import graphs as JG  # noqa: E402
from repro.launch import train as JL  # noqa: E402
from repro.models import nequip as JN  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.data import graphs as TG  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import nequip as TN  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402
from test_torch_sasrec import _close, _close_tree, params_close  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(n_layers=2, channels=8, n_species=4)


def _cfgs(**kw):
    return (JN.NequIPConfig(**SMALL, **kw), TN.NequIPConfig(**SMALL, **kw))


@pytest.fixture(scope="module")
def model():
    cj, ct = _cfgs()
    pj = JN.init_params(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    return cj, ct, pj, tree, convert.params_from_numpy(tree, ct,
                                                         device="cpu")


def _molecules(seed, n_graphs=3, nodes=10, edges=24):
    """A batch of small molecules with energy and force targets, in the
    reference's layout: (JAX batch, port batch)."""
    b = JG.batch_small_graphs(seed, n_graphs, nodes, edges, n_species=4)
    rng = np.random.default_rng(seed)
    b["energy"] = rng.standard_normal(n_graphs).astype(np.float32)
    b["forces"] = (rng.standard_normal(b["positions"].shape) * 0.1).astype(
        np.float32)
    return _both(b)


def _both(b):
    return ({k: v if isinstance(v, int) else jnp.asarray(v)
             for k, v in b.items()},
            {k: v if isinstance(v, int) else torch.from_numpy(np.array(v))
             for k, v in b.items()})


def _port_grads(tree, ct, loss_of):
    """(loss, gradient tree) of the port from the reference's params."""
    pt = convert.params_from_numpy(tree, ct, device="cpu")
    leaves = [t for _, t in TC.tree_items(TN.make_trainable(pt))]
    loss = loss_of(pt)
    gs = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                  materialize_grads=True))
    return float(loss.detach()), jax.tree_util.tree_map(
        lambda _: next(gs).numpy(), tree)


def _static(fn, b):
    """``fn(params, batch)`` jitted with the batch's int ``n_graphs``
    closed over (the reference's static graph count)."""
    arrays = {k: v for k, v in b.items() if not isinstance(v, int)}
    static = {k: v for k, v in b.items() if isinstance(v, int)}
    return jax.jit(lambda p, a: fn(p, dict(a, **static))), arrays


# -- harmonics, couplings, radial basis ---------------------------------------


def test_gaunt_tensors_and_paths_equal_reference():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_array_equal(TN.gaunt_tensor(l1, l2, l3),
                                              JN.gaunt_tensor(l1, l2, l3))
    for l_max in (0, 1, 2):
        assert list(TN.tp_paths(l_max)) == JN.tp_paths(l_max)
    assert len(TN.tp_paths(2)) == 11


def test_gaunt_known_values():
    """The reference's closed forms on the port's tensors."""
    np.testing.assert_allclose(TN.gaunt_tensor(1, 1, 0)[:, :, 0],
                               np.eye(3) * 0.5 / math.sqrt(math.pi),
                               atol=1e-6)
    for l in (1, 2):
        np.testing.assert_allclose(TN.gaunt_tensor(0, l, l)[0],
                                   np.eye(2 * l + 1) * 0.5
                                   / math.sqrt(math.pi), atol=1e-6)
    assert np.abs(TN.gaunt_tensor(1, 1, 1)).max() < 1e-10


def test_sph_harm_bessel_and_cutoff_match_reference():
    xyz = np.random.RandomState(0).randn(50, 3)
    xyz /= np.linalg.norm(xyz, axis=1, keepdims=True)
    r = np.linspace(0.0, 6.0, 64).astype(np.float32)
    for l in range(3):
        np.testing.assert_array_equal(TN.sph_harm_np(l, xyz),
                                      JN.sph_harm_np(l, xyz))
        _close(TN.sph_harm(l, torch.from_numpy(xyz).float()).numpy(),
               JN.sph_harm(l, jnp.asarray(xyz, jnp.float32)))
    _close(TN.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy(),
           JN.bessel_basis(jnp.asarray(r), 8, 5.0))
    _close(TN.poly_cutoff(torch.from_numpy(r), 5.0).numpy(),
           JN.poly_cutoff(jnp.asarray(r), 5.0))
    env = TN.poly_cutoff(torch.linspace(0.01, 6.0, 50), 5.0)
    assert float(env[0]) > 0.99 and float(env[-1]) == 0.0


def test_init_tree_matches_reference(model):
    _, ct, _, tree, pt = model
    mine = convert.params_to_numpy(TN.init_params(
        torch.Generator().manual_seed(0), ct, device="cpu"))
    flat = jax.tree_util.tree_flatten_with_path
    assert [(jax.tree_util.keystr(p), x.shape) for p, x in flat(mine)[0]] \
        == [(jax.tree_util.keystr(p), x.shape) for p, x in flat(tree)[0]]
    back = convert.params_to_numpy(pt)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree), strict=True):
        np.testing.assert_array_equal(a, b)


# -- forward, forces, losses ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_energies_and_forces_match_reference(model, seed):
    cj, ct, pj, _, pt = model
    bj, bt = _molecules(seed)
    ref, arrays = _static(lambda p, b: (
        JN.forward(p, b, cj), JN.energy_and_forces(p, b, cj),
        JN.node_output(p, b, cj)), bj)
    e_graphs, (ej, fj), nodes = ref(pj, arrays)
    _close(TN.forward(pt, bt, ct).detach().numpy(), e_graphs)
    et, ft = TN.energy_and_forces(pt, bt, ct)
    _close(float(et), float(ej))
    _close(ft.numpy(), fj, rtol=1e-4, atol_rel=1e-4)
    _close(TN.node_output(pt, bt, ct).detach().numpy(), nodes)


@pytest.mark.parametrize("remat,chunks", [(True, 1), (True, 2), (False, 1),
                                          (False, 2)])
def test_molecule_loss_and_second_order_grads_match_reference(remat, chunks):
    """Energy + force matching: forces = -dE/dx, differentiated again
    (through the remat'd edge chunks on both sides)."""
    cj, ct = _cfgs(remat=remat, edge_chunks=chunks)
    pj = JN.init_params(jax.random.PRNGKey(0), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    bj, bt = _molecules(2)  # 72 edges: two chunks of 36
    ref, arrays = _static(jax.value_and_grad(
        functools.partial(JN.loss_fn, cfg=cj)), bj)
    lj, gj = ref(pj, arrays)
    lt, gt = _port_grads(tree, ct, lambda p: TN.loss_fn(p, bt, ct))
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    _close_tree(gt, jax.tree_util.tree_map(np.asarray, gj), atol_rel=1e-4)


def test_node_loss_matches_reference(model):
    """The node-property regime (first order, masked), with raw node
    features instead of species."""
    cj, ct = _cfgs(d_feat_in=5)
    pj = JN.init_params(jax.random.PRNGKey(1), cj)
    tree = jax.tree_util.tree_map(np.asarray, pj)
    rng = np.random.default_rng(3)
    b = JG.batch_small_graphs(4, 2, 9, 20, n_species=4)
    del b["species"], b["graph_ids"], b["n_graphs"]
    b["node_feats"] = rng.standard_normal((18, 5)).astype(np.float32)
    b["node_targets"] = rng.standard_normal(18).astype(np.float32)
    b["node_mask"] = np.arange(18) < 15
    bj, bt = _both(b)
    lj, gj = jax.jit(jax.value_and_grad(functools.partial(
        JN.loss_fn, cfg=cj)))(pj, bj)
    lt, gt = _port_grads(tree, ct, lambda p: TN.loss_fn(p, bt, ct))
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    _close_tree(gt, jax.tree_util.tree_map(np.asarray, gj), atol_rel=1e-4)


def test_train_step_matches_reference_jitted_step():
    aj = JL.reduced_arch(JR.get("nequip"))
    at = TL.reduced_arch(TR.get("nequip"))
    stream = TL.make_stream(at, 24, 0, seed=5)
    assert stream.n_graphs == JL.make_stream(aj, 24, 0, 5).n_graphs == 3
    bt = stream.next()
    bj = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    key = jax.random.PRNGKey(0)
    pj = JN.init_params(key, aj.cfg)
    base = aj.loss_fn(lambda a, k: a)

    def loss_j(p, b):
        return base(p, dict(b, n_graphs=3))

    step_j = JTR.make_train_step(loss_j, aj.train_cfg)
    (sj, mj), g = jax.jit(lambda p, b: (
        step_j(JTR.init_state(key, p, aj.train_cfg), b),
        jax.grad(loss_j)(p, b)))(pj, bj)
    pt = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   at.cfg, device="cpu")
    step_t = TTR.make_train_step(at.loss_fn(n_graphs=stream.n_graphs),
                                 at.train_cfg)
    st, mt = step_t(TTR.init_state(0, pt, at.train_cfg), bt)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-5)
    params_close(convert.params_to_numpy(st.params),
                 jax.tree_util.tree_map(np.asarray, sj.params),
                 jax.tree_util.tree_map(np.asarray, g),
                 lr_sum=TO.lr_at(at.train_cfg.opt, 1))


# -- the reference's tests/test_nequip.py on the port ---------------------------


def _random_graph(seed, N=10, E=30, species=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    return {"positions": torch.from_numpy(
                (rng.standard_normal((N, 3)) * 2.0).astype(np.float32)),
            "species": torch.from_numpy(rng.integers(0, species, N)),
            "edge_src": torch.from_numpy(src),
            "edge_dst": torch.from_numpy(
                (src + 1 + rng.integers(0, N - 1, E)) % N)}


def _rotation(seed):
    return torch.from_numpy(sst.Rotation.random(
        random_state=seed).as_matrix().astype(np.float32))


@pytest.mark.parametrize("seed", [0, 17, 404])
def test_energy_rotation_translation_invariance(model, seed):
    _, ct, _, _, pt = model
    batch = _random_graph(seed)
    R = _rotation(seed)
    e0 = TN.forward(pt, batch, ct)
    e1 = TN.forward(pt, dict(batch, positions=batch["positions"] @ R.T
                             + 3.7), ct)
    torch.testing.assert_close(e1, e0, rtol=2e-4, atol=2e-4)


def test_force_equivariance(model):
    _, ct, _, _, pt = model
    batch = _random_graph(7)
    R = _rotation(1)
    _, f0 = TN.energy_and_forces(pt, batch, ct)
    _, f1 = TN.energy_and_forces(
        pt, dict(batch, positions=batch["positions"] @ R.T), ct)
    torch.testing.assert_close(f1, f0 @ R.T, rtol=0, atol=1e-5)


def test_permutation_invariance(model):
    _, ct, _, _, pt = model
    batch = _random_graph(9, N=8, E=20)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(8))
    inv = torch.argsort(perm)
    b2 = {"positions": batch["positions"][perm],
          "species": batch["species"][perm],
          "edge_src": inv[batch["edge_src"]],
          "edge_dst": inv[batch["edge_dst"]]}
    torch.testing.assert_close(TN.forward(pt, b2, ct),
                               TN.forward(pt, batch, ct), rtol=1e-4,
                               atol=0)


def test_cutoff_locality(model):
    """Atoms beyond the cutoff radius contribute nothing."""
    _, ct, _, _, pt = model
    batch = _random_graph(3, N=6, E=10)
    far = dict(batch)
    far["positions"] = batch["positions"].clone()
    far["positions"][0] = 100.0
    mask = (batch["edge_src"] != 0) & (batch["edge_dst"] != 0)
    torch.testing.assert_close(
        TN.forward(pt, dict(far, edge_mask=mask), ct),
        TN.forward(pt, far, ct), rtol=1e-4, atol=0)


def test_padding_masks_are_neutral(model):
    _, ct, _, _, pt = model
    batch = _random_graph(5, N=8, E=16)
    pad = torch.nn.functional.pad
    padded = {
        "positions": pad(batch["positions"], (0, 0, 0, 4)),
        "species": pad(batch["species"], (0, 4)),
        "edge_src": pad(batch["edge_src"], (0, 6)),
        "edge_dst": pad(batch["edge_dst"], (0, 6)),
        "edge_mask": pad(torch.ones(16, dtype=torch.bool), (0, 6)),
        "node_mask": pad(torch.ones(8, dtype=torch.bool), (0, 4)),
    }
    e1 = TN.forward(pt, padded, ct)
    torch.testing.assert_close(e1, TN.forward(pt, batch, ct), rtol=1e-3,
                               atol=1e-3)
    _, f = TN.energy_and_forces(pt, padded, ct)
    assert torch.isfinite(f).all()  # zero-length pad edges: no NaN


# -- graphs ---------------------------------------------------------------------


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("seed", [0, 100003 * 5 + 2])
def test_batch_small_graphs_equals_reference(seed):
    _same(TG.batch_small_graphs(seed, 4, 12, 32, n_species=16),
          JG.batch_small_graphs(seed, 4, 12, 32, n_species=16))


@pytest.mark.parametrize("d_feat,spatial", [(0, True), (6, False)])
def test_random_graph_and_neighbor_sample_equal_reference(d_feat, spatial):
    got = TG.random_graph(3, 300, 5, d_feat=d_feat, spatial=spatial)
    want = JG.random_graph(3, 300, 5, d_feat=d_feat, spatial=spatial)
    for f in ("indptr", "indices", "feats", "positions"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    seeds = np.arange(0, 300, 37)
    _same(TG.neighbor_sample(got, seeds, (4, 3), np.random.RandomState(1)),
          JG.neighbor_sample(want, seeds, (4, 3), np.random.RandomState(1)))


def test_launcher_graph_batches_follow_the_reference_seeds():
    """The launcher's molecules are the reference launcher's (its
    ``batch_small_graphs(seed * 100003 + step, batch // 8, 12, 32)``);
    the targets are the port's own seeded draws, a function of
    (seed, step)."""
    at = TL.reduced_arch(TR.get("nequip"))
    s = TL.make_stream(at, 32, 0, seed=2, step=5)
    b, again = s.next(), TL.make_stream(at, 32, 0, seed=2, step=5).next()
    want = JG.batch_small_graphs(2 * 100003 + 5, 4, 12, 32, n_species=16)
    for k in ("positions", "species", "edge_src", "edge_dst", "graph_ids"):
        np.testing.assert_array_equal(b[k].numpy(), want[k])
    assert b["energy"].shape == (4,) and b["forces"].shape == (48, 3)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(s.next()["energy"], b["energy"])
