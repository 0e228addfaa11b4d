"""NequIP [Batzner et al., arXiv:2101.03164]: E(3)-equivariant GNN
(counterpart of ``repro.models.nequip``, no e3nn).

* node features are irrep blocks {l: (n_nodes, channels, 2l+1)}, l <= l_max;
* edge attributes: real spherical harmonics Y_l(r_hat) (explicit
  formulas for l = 0, 1, 2) and a radial Bessel basis under a
  polynomial cutoff envelope;
* interaction = tensor-product message passing: neighbour irrep l1 x
  edge irrep l2 -> irrep l3 through the Gaunt coupling tensor
  C[l1 l2 l3]_{m1 m2 m3} = ∫ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3} dΩ,
  computed by the reference's Gauss-Legendre x trapezoid quadrature
  (exact for these degrees; numpy, cached);
* messages are weighted by a radial MLP (per path x channel) and summed
  into their destination nodes with ``index_add`` (``common.segment_sum``),
  then self-interaction linears and gated nonlinearities;
* output: a scalar head -> per-atom energies -> per-graph energies;
  forces are -dE/dx through ``torch.autograd.grad``, and the molecule
  loss differentiates them again (``create_graph=True``): it is second
  order in the parameters.

``remat`` recomputes each edge chunk's messages in the backward pass
(non-reentrant ``torch.utils.checkpoint``, which supports the second
derivative), as the reference's ``jax.checkpoint`` of ``_messages``;
``edge_chunks`` > 1 streams the edges in that many chunks when it
divides E.  Parameters are the reference's tree: ``layers`` a list of
dicts, each layer's ``self`` a dict keyed by the int l.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
from torch.nn import functional as Fn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import host_scalars, resolve_device
from repro_torch.models import common as cm

make_trainable = cm.make_trainable

# ---------------------------------------------------------------------------
# Real spherical harmonics (explicit, l <= 2) and Gaunt coupling tensors
# ---------------------------------------------------------------------------

_C1 = math.sqrt(3.0 / (4.0 * math.pi))
_C2 = (0.5 * math.sqrt(15.0 / math.pi), 0.25 * math.sqrt(5.0 / math.pi),
       0.25 * math.sqrt(15.0 / math.pi))  # xy/yz/xz, 3z^2-1, x^2-y^2


def sph_harm_np(l: int, xyz: np.ndarray) -> np.ndarray:
    """Real SH on unit vectors, numpy; xyz (..., 3) -> (..., 2l+1)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return np.full(xyz.shape[:-1] + (1,), 0.5 / math.sqrt(math.pi))
    if l == 1:
        return np.stack([_C1 * y, _C1 * z, _C1 * x], axis=-1)
    if l == 2:
        c0, c2, c4 = _C2
        return np.stack([c0 * x * y, c0 * y * z, c2 * (3.0 * z * z - 1.0),
                         c0 * x * z, c4 * (x * x - y * y)], axis=-1)
    raise NotImplementedError(l)


def sph_harm(l: int, xyz: torch.Tensor) -> torch.Tensor:
    """Real SH in torch (the same formulas)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if l == 0:
        return torch.full(xyz.shape[:-1] + (1,), 0.5 / math.sqrt(math.pi),
                          dtype=xyz.dtype, device=xyz.device)
    if l == 1:
        return torch.stack([_C1 * y, _C1 * z, _C1 * x], dim=-1)
    if l == 2:
        c0, c2, c4 = _C2
        return torch.stack([c0 * x * y, c0 * y * z,
                            c2 * (3.0 * z * z - 1.0), c0 * x * z,
                            c4 * (x * x - y * y)], dim=-1)
    raise NotImplementedError(l)


@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """C[m1, m2, m3] = ∫ Y_{l1 m1} Y_{l2 m2} Y_{l3 m3} dΩ (exact quadrature)."""
    n_theta, n_phi = 16, 32
    t_nodes, t_weights = np.polynomial.legendre.leggauss(n_theta)
    phi = (np.arange(n_phi) + 0.5) * (2 * np.pi / n_phi)
    w_phi = 2 * np.pi / n_phi
    ct = t_nodes  # cos(theta) in [-1, 1]
    st = np.sqrt(1 - ct**2)
    xyz = np.stack(
        [
            st[:, None] * np.cos(phi)[None, :],
            st[:, None] * np.sin(phi)[None, :],
            np.broadcast_to(ct[:, None], (n_theta, n_phi)),
        ],
        axis=-1,
    )  # (n_theta, n_phi, 3)
    Y1 = sph_harm_np(l1, xyz)
    Y2 = sph_harm_np(l2, xyz)
    Y3 = sph_harm_np(l3, xyz)
    w = t_weights[:, None] * w_phi
    C = np.einsum("tpa,tpb,tpc,tp->abc", Y1, Y2, Y3,
                  np.broadcast_to(w, (n_theta, n_phi)))
    C[np.abs(C) < 1e-12] = 0.0
    return C.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _gaunt_on(l1: int, l2: int, l3: int, device: torch.device):
    with host_scalars():  # a real constant, also when a trace asks first
        return torch.from_numpy(gaunt_tensor(l1, l2, l3)).to(device)


@functools.lru_cache(maxsize=None)
def tp_paths(l_max: int) -> tuple:
    """All (l_in, l_edge, l_out) with non-vanishing Gaunt coupling."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(l_max + 1):
                if abs(l1 - l2) <= l3 <= l1 + l2 and (l1 + l2 + l3) % 2 == 0:
                    if np.abs(gaunt_tensor(l1, l2, l3)).max() > 1e-10:
                        paths.append((l1, l2, l3))
    return tuple(paths)


# ---------------------------------------------------------------------------
# Radial basis
# ---------------------------------------------------------------------------


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(n pi r / rc) / r basis [Klicpera 2020], (E,) -> (E, n_rbf)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    return (math.sqrt(2.0 / cutoff)
            * torch.sin(n[None, :] * math.pi * r[:, None] / cutoff)
            / r[:, None])


def poly_cutoff(r: torch.Tensor, cutoff: float, p: int = 6) -> torch.Tensor:
    """Smooth polynomial envelope, 1 at r=0, 0 at r>=cutoff."""
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    return (1.0 - ((p + 1) * (p + 2) / 2) * x**p + p * (p + 2) * x ** (p + 1)
            - (p * (p + 1) / 2) * x ** (p + 2))


# ---------------------------------------------------------------------------
# Config / init
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat_in: int = 0  # raw node-feature dim (0 -> species one-hot)
    n_species: int = 16
    radial_hidden: int = 64
    dtype: Any = torch.float32
    # memory controls for large graphs: recompute each edge chunk's
    # messages in the backward pass, and stream the edges in chunks
    remat: bool = True
    edge_chunks: int = 1


def init_params(gen: torch.Generator, cfg: NequIPConfig, *,
                device="cuda") -> dict:
    """Seeded parameters on ``device`` (N(0, 1/fan_in) weights, zero
    biases) in the reference's tree."""
    dev = resolve_device(device)
    C = cfg.channels
    n_paths = len(tp_paths(cfg.l_max))

    def dense(shape):
        return cm.dense_init(gen, shape, device=dev)

    params = {
        "embed": dense((cfg.d_feat_in or cfg.n_species, C)),
        "layers": [],
        "out_w1": dense((C, C)),
        "out_w2": dense((C, 1)),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            # radial MLP: n_rbf -> hidden -> (n_paths * C) weights
            "rad_w1": dense((cfg.n_rbf, cfg.radial_hidden)),
            "rad_b1": torch.zeros((cfg.radial_hidden,), device=dev),
            "rad_w2": dense((cfg.radial_hidden, n_paths * C)),
            # self-interaction per l: (C, C)
            "self": {l: dense((C, C)) for l in range(cfg.l_max + 1)},
            # per-l gate scalars produced from the l=0 channels
            "gate_w": dense((C, C * cfg.l_max)),
        })
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _messages(cfg, lp, feats, edge_src, edge_dst, sh, radial, n_nodes,
              constrain=cm.keep):
    """Edge-wise tensor products + scatter: {l3: (N, C, 2l3+1)} sums."""
    C = cfg.channels
    paths = tp_paths(cfg.l_max)
    h = Fn.silu(radial @ lp["rad_w1"] + lp["rad_b1"])
    w = (h @ lp["rad_w2"]).reshape(-1, len(paths), C)  # (E, P, C)
    out = {l: feats[0].new_zeros((n_nodes, C, 2 * l + 1))
           for l in range(cfg.l_max + 1)}
    for pi, (l1, l2, l3) in enumerate(paths):
        Cg = _gaunt_on(l1, l2, l3, radial.device)  # (m1, m2, m3)
        src_feat = constrain(cm.gather(feats[l1], edge_src), "edge_feats")
        msg = torch.einsum("eca,eb,abm->ecm", src_feat, sh[l2],
                           Cg)  # (E, C, 2l3+1)
        msg = constrain(msg * w[:, pi, :, None], "edge_feats")
        out[l3] = out[l3] + cm.segment_sum(msg, edge_dst, n_nodes)
    return out


_RADIAL = ("rad_w1", "rad_b1", "rad_w2")  # the weights _messages reads


def _edge_sums(cfg: NequIPConfig, lp, feats, edge_src, edge_dst, sh, radial,
               n_nodes: int, constrain=cm.keep):
    """The node sums of the messages over these edges: {l3: (N, C,
    2l3+1)}, chunk by chunk with ``cfg.edge_chunks``."""
    E = edge_src.shape[0]
    k = cfg.edge_chunks
    msg_fn = _messages
    if cfg.remat:
        # recompute each chunk's edge-wise work in the backward pass:
        # live edge-tensor memory is one chunk whatever the depth
        msg_fn = functools.partial(checkpoint, _messages,
                                   use_reentrant=False)
    if not (k > 1 and E % k == 0):
        return msg_fn(cfg, lp, feats, edge_src, edge_dst, sh, radial,
                      n_nodes, constrain)

    # stream edges: accumulate node sums chunk by chunk, the edge
    # tensors viewed as (k, E/k, ...)
    def chunked(a):
        return constrain(a.reshape((k, E // k) + a.shape[1:]), "edge_chunked")

    es, ed, rad = chunked(edge_src), chunked(edge_dst), chunked(radial)
    shc = {l: chunked(s) for l, s in sh.items()}
    out = {l: feats[0].new_zeros((n_nodes, cfg.channels, 2 * l + 1))
           for l in range(cfg.l_max + 1)}
    for c in range(k):
        got = msg_fn(cfg, lp, feats, es[c], ed[c],
                     {l: s[c] for l, s in shc.items()}, rad[c], n_nodes,
                     constrain)
        out = {l: out[l] + got[l] for l in out}
    return out


def _interaction(cfg: NequIPConfig, lp, feats, edge_src, edge_dst, sh,
                 radial, n_nodes: int, constrain=cm.keep):
    L = cfg.l_max + 1
    if not cm.is_dtensor(edge_src):
        out = _edge_sums(cfg, lp, feats, edge_src, edge_dst, sh, radial,
                         n_nodes, constrain)
    else:
        # edges sharded over cards (a dry-run's DTensors): each card sums
        # its own edges' messages (in chunks of its edges) into the
        # whole node range, from the node features gathered whole, and
        # the cards' sums add up
        def local(es, ed, rad, *rest):
            out = _edge_sums(cfg, dict(zip(_RADIAL, rest[2 * L:])),
                             dict(enumerate(rest[L:2 * L])), es, ed,
                             dict(enumerate(rest[:L])), rad, n_nodes)
            return tuple(out[l] for l in range(L))

        out = dict(enumerate(cm.per_row(
            local, edge_src, edge_dst, radial, *(sh[l] for l in range(L)),
            shared=(*(feats[l] for l in range(L)),
                    *(lp[n] for n in _RADIAL)),
            n_out=L, reduce_out=True)))

    # self-interaction + residual
    new = {l: feats[l] + torch.einsum("ncm,cd->ndm", out[l], lp["self"][l])
           for l in range(cfg.l_max + 1)}
    # gated nonlinearity: scalars via silu; l>0 scaled by sigmoid(gates)
    scalars = new[0][..., 0]  # (N, C)
    gates = torch.sigmoid(scalars @ lp["gate_w"]).reshape(
        n_nodes, cfg.l_max, cfg.channels)
    act = {0: Fn.silu(scalars)[..., None]}
    for l in range(1, cfg.l_max + 1):
        act[l] = new[l] * gates[:, l - 1, :, None]
    return act


def _edge_geometry(cfg: NequIPConfig, src, dst, *rest):
    """(radial basis under the cutoff envelope (E, n_rbf), then Y_l(r_hat)
    (E, 2l+1) for l = 0..l_max) of edges src -> dst; ``rest`` is
    (edge_mask, positions) or (positions,)."""
    *emask, pos = rest
    rel = cm.gather(pos, dst) - cm.gather(pos, src)  # (E, 3)
    # grad-safe norm (zero-length padding/self edges must not NaN forces)
    r2 = (rel * rel).sum(-1)
    r = torch.sqrt(torch.clamp(r2, min=1e-12))
    rhat = rel / torch.clamp(r, min=1e-6)[:, None]
    env = poly_cutoff(r, cfg.cutoff)
    if emask:
        env = env * emask[0].to(env.dtype)
    radial = bessel_basis(r, cfg.n_rbf, cfg.cutoff) * env[:, None]
    return (radial, *(sph_harm(l, rhat) for l in range(cfg.l_max + 1)))


def forward(params, batch: dict, cfg: NequIPConfig,
            constrain=cm.keep) -> torch.Tensor:
    """batch: positions (N,3), node_feats (N,F) or species (N,),
    edge_src/edge_dst (E,), optional edge_mask (E,), node_mask (N,),
    graph_ids (N,) with a Python int ``n_graphs`` for batched small
    graphs.  Returns per-graph energies (n_graphs,), or (1,) without
    graph ids."""
    pos = batch["positions"].to(torch.float32)
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    n_nodes = pos.shape[0]
    emask = batch.get("edge_mask")
    nmask = batch.get("node_mask")

    # edge geometry; edges sharded over cards (a dry-run's DTensors) are
    # measured on their own cards from the positions gathered whole
    edges = (src, dst) if emask is None else (src, dst, emask)
    radial, *sh = cm.per_row(functools.partial(_edge_geometry, cfg),
                             *edges, shared=(pos,), n_out=cfg.l_max + 2)
    sh = dict(enumerate(sh))

    if "node_feats" in batch:
        x0 = batch["node_feats"].to(torch.float32) @ params["embed"]
    else:
        x0 = cm.gather(params["embed"], batch["species"].long())
    feats = {0: x0[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = x0.new_zeros((n_nodes, cfg.channels, 2 * l + 1))

    for lp in params["layers"]:
        feats = _interaction(cfg, lp, feats, src, dst, sh, radial, n_nodes,
                             constrain)
        feats = {l: constrain(f, "node_feats") for l, f in feats.items()}

    scalars = feats[0][..., 0]  # (N, C)
    atom_e = (Fn.silu(scalars @ params["out_w1"]) @ params["out_w2"])[..., 0]
    if nmask is not None:
        atom_e = atom_e * nmask.to(atom_e.dtype)
    gid = batch.get("graph_ids")
    if gid is None:
        return atom_e.sum(dim=0, keepdim=True)
    return cm.segment_sum(atom_e, gid, int(batch.get("n_graphs", 1)))


def _energies_and_grad(params, batch, cfg, create_graph: bool,
                       constrain=cm.keep):
    """(per-graph energies, dE_total/dx) with autograd on a leaf copy
    of the positions."""
    pos = batch["positions"].detach().to(torch.float32).requires_grad_(True)
    with torch.enable_grad():
        e = forward(params, dict(batch, positions=pos), cfg, constrain)
        (grad,) = torch.autograd.grad(e.sum(), pos, create_graph=create_graph)
    return e, grad


def energy_and_forces(params, batch, cfg: NequIPConfig):
    """(total energy (), forces (N, 3) = -dE/dx)."""
    e, grad = _energies_and_grad(params, batch, cfg, create_graph=False)
    return e.sum().detach(), -grad


def node_output(params, batch, cfg: NequIPConfig,
                constrain=cm.keep) -> torch.Tensor:
    """Per-node scalar prediction (node-property cells): (N,), the trunk
    read out per atom without graph pooling."""
    n = batch["positions"].shape[0]
    return forward(params, dict(batch, graph_ids=torch.arange(
        n, device=batch["positions"].device), n_graphs=n), cfg, constrain)


def loss_fn(params, batch, cfg: NequIPConfig, n_graphs=None,
            constrain=cm.keep) -> torch.Tensor:
    """Two regimes (``n_graphs``, a Python int, replaces the batch's
    static graph count when given, as the reference's launcher closes
    over it):

    * node-property batches (``node_targets`` present): masked per-node
      regression, first order;
    * molecular batches (``energy``/``forces``): energy + force
      matching; forces = -dE/dx make the loss SECOND order in the
      parameters.
    """
    if n_graphs is not None:
        batch = dict(batch, n_graphs=n_graphs)
    if "node_targets" in batch:
        err = (node_output(params, batch, cfg, constrain)
               - batch["node_targets"]) ** 2
        mask = batch.get("node_mask")
        if mask is not None:
            mask = mask.to(err.dtype)
            return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return err.mean()
    e, neg_f = _energies_and_grad(params, batch, cfg, create_graph=True,
                                  constrain=constrain)
    loss_e = ((e - batch["energy"]) ** 2).mean()
    f = -neg_f
    tgt = batch["forces"]
    fm = batch.get("node_mask")
    if fm is not None:
        fm = fm.to(f.dtype)[:, None]
        f, tgt = f * fm, tgt * fm
    return loss_e + ((f - tgt) ** 2).sum(-1).mean()
