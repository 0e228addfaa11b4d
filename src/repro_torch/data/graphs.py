"""Graph generation + the neighbor sampler (counterpart of
``repro.data.graphs``; numpy ``RandomState`` draws, so the same seed gives
the reference's arrays EQUAL).

The sampler is the real thing: fanout-limited k-hop uniform neighbor
sampling over a CSR adjacency, host-side numpy (the standard production
split: sampling on CPU workers, model on accelerator), emitting
static-shape padded subgraphs, so every training batch has the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # (N+1,)
    indices: np.ndarray  # (E,)
    feats: Optional[np.ndarray] = None  # (N, F)
    positions: Optional[np.ndarray] = None  # (N, 3)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)


def random_graph(
    seed: int, n_nodes: int, avg_degree: int, d_feat: int = 0,
    spatial: bool = True,
) -> CSRGraph:
    """Random sparse graph; positions drawn in a box sized for ~avg_degree
    neighbors within the NequIP cutoff."""
    rng = np.random.RandomState(seed)
    n_edges = n_nodes * avg_degree
    src = rng.randint(0, n_nodes, n_edges)
    dst = (src + 1 + rng.randint(0, n_nodes - 1, n_edges)) % n_nodes
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    feats = (
        rng.randn(n_nodes, d_feat).astype(np.float32) if d_feat else None
    )
    positions = None
    if spatial:
        box = (n_nodes / max(avg_degree, 1)) ** (1 / 3) * 4.0
        positions = (rng.rand(n_nodes, 3) * box).astype(np.float32)
    return CSRGraph(
        indptr=indptr, indices=dst.astype(np.int64), feats=feats,
        positions=positions,
    )


def neighbor_sample(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    rng: np.random.RandomState,
):
    """k-hop fanout sampling. Returns a padded subgraph dict:
       nodes (pad_n,), edge_src/edge_dst (pad_e,) LOCAL indices,
       node_mask, edge_mask, n_seeds.
    Static pad sizes derive from seeds*prod(fanouts)."""
    layers = [seeds]
    edges_src, edges_dst = [], []
    frontier = seeds
    for f in fanouts:
        new_src, new_dst = [], []
        for u in frontier:
            lo, hi = graph.indptr[u], graph.indptr[u + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(f, deg)
            picks = graph.indices[
                lo + rng.choice(deg, size=take, replace=False)
            ]
            new_src.extend(picks.tolist())
            new_dst.extend([u] * take)
        frontier = np.unique(np.asarray(new_src, np.int64))
        layers.append(frontier)
        edges_src.extend(new_src)
        edges_dst.extend(new_dst)

    nodes = np.unique(np.concatenate(layers))
    remap = {int(g): i for i, g in enumerate(nodes)}
    e_src = np.asarray([remap[int(s)] for s in edges_src], np.int32)
    e_dst = np.asarray([remap[int(d)] for d in edges_dst], np.int32)

    # static pads
    pad_n = int(len(seeds) * np.prod([f + 1 for f in fanouts]))
    pad_e = int(len(seeds) * np.prod(fanouts) * (1 + sum(fanouts)))
    pad_n = max(pad_n, len(nodes))
    pad_e = max(pad_e, len(e_src))
    node_mask = np.zeros(pad_n, bool)
    node_mask[: len(nodes)] = True
    edge_mask = np.zeros(pad_e, bool)
    edge_mask[: len(e_src)] = True
    nodes_p = np.zeros(pad_n, np.int64)
    nodes_p[: len(nodes)] = nodes
    es = np.zeros(pad_e, np.int32)
    es[: len(e_src)] = e_src
    ed = np.zeros(pad_e, np.int32)
    ed[: len(e_dst)] = e_dst
    return {
        "nodes": nodes_p,
        "edge_src": es,
        "edge_dst": ed,
        "node_mask": node_mask,
        "edge_mask": edge_mask,
        "n_real_nodes": len(nodes),
        "n_seeds": len(seeds),
    }


def batch_small_graphs(
    seed: int, n_graphs: int, nodes_per: int, edges_per: int,
    n_species: int = 16,
):
    """Disjoint-union batching of small molecules -> one big graph dict."""
    rng = np.random.RandomState(seed)
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    positions = rng.randn(N, 3).astype(np.float32) * 1.5
    species = rng.randint(0, n_species, N).astype(np.int32)
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    gid = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    for g in range(n_graphs):
        s = rng.randint(0, nodes_per, edges_per)
        d = (s + 1 + rng.randint(0, nodes_per - 1, edges_per)) % nodes_per
        src[g * edges_per:(g + 1) * edges_per] = s + g * nodes_per
        dst[g * edges_per:(g + 1) * edges_per] = d + g * nodes_per
    return {
        "positions": positions,
        "species": species,
        "edge_src": src,
        "edge_dst": dst,
        "graph_ids": gid,
        "n_graphs": n_graphs,
    }
