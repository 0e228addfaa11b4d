"""Roofline terms of a traced cell on H100 clusters (counterpart of
``repro.launch.roofline``).

Three times per (arch x cell x mesh), all per card:

  compute    = FLOPs / PEAK_FLOPS
  memory     = HBM bytes / HBM_BW
  collective = sum over mesh axes of that axis's collective bytes over
               that axis's link (NVLink within a node for ``model``,
               InfiniBand across nodes for ``data`` and ``pod``)

The counts come from ``launch.analysis``'s trace of the cell's program
on fake DTensors: FLOPs and HBM bytes of the ops each card runs on its
own shards, and the collectives DTensor issues, by kind and by mesh
axis (:class:`CollectiveStats`; the kinds and counts are those
``torch.distributed.tensor.debug.CommDebugMode`` reports, the bytes
each collective's output on one card).  The constants are datasheet
figures of one H100 SXM5 card; a row built from them is a plan, not a
measurement.

The reference's ``parse_collectives`` and ``_shape_bytes`` read XLA's
optimized HLO text, and ``cpu_float_norm_ghost_bytes`` corrects for f32
copies XLA's CPU backend adds to bf16 loop buffers; a trace of DTensor
ops has neither, so neither has a counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s dense BF16 tensor-core peak
# (1,979 with sparsity); the SXM5 part is the 700 W one.
PEAK_FLOPS = 989.4e12
# NVIDIA H100 SXM5 datasheet: 3.35 TB/s HBM3 bandwidth.
HBM_BW = 3.35e12
# NVIDIA H100 SXM5 datasheet: 80 GB HBM3.
HBM_BYTES = 80e9
# NVIDIA H100 SXM5 datasheet: NVLink 4 at 900 GB/s per card, 450 GB/s
# each way; the model (tensor-parallel) axis stays inside one 8-card node.
NVLINK_BW = 450e9
# NVIDIA DGX H100 datasheet: one 400 Gb/s NDR InfiniBand port per card
# (ConnectX-7), 50 GB/s each way; the data and pod axes cross nodes.
IB_BW = 50e9

LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict
    bytes_by_axis: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def link_bw(axis: str) -> float:
    """Bytes/s each way per card on ``axis``'s link (InfiniBand for an
    axis other than ``model``)."""
    return LINK_BW.get(axis, IB_BW)


@dataclasses.dataclass
class Roofline:
    """All quantities PER CARD.  model_flops = useful (6ND-convention)
    flops for the whole step divided by the card count; ``axis_bytes``
    the collective bytes by mesh axis (without it, all of
    ``collective_bytes`` is taken to cross InfiniBand)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    model_flops: Optional[float] = None
    axis_bytes: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.axis_bytes is None:
            return self.collective_bytes / IB_BW
        return sum(b / link_bw(a) for a, b in self.axis_bytes.items())

    @property
    def bottleneck(self) -> str:
        ts = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(ts, key=ts.get)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_frac(self) -> float:
        """Fraction of peak implied by the dominant term for USEFUL model
        flops: (useful-flops time at peak) / (dominant bound time), the
        MFU the roofline allows."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        if bound == 0:
            return 0.0
        useful = (self.model_flops if self.model_flops is not None
                  else self.flops) / PEAK_FLOPS
        return useful / bound

    def row(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops_for(arch, cell) -> Optional[float]:
    """MODEL_FLOPS: 6*N*D for dense LM train, 6*N_active*D for MoE;
    2*N*D for LM forward-only; analytic estimates for others."""
    if arch.family == "transformer":
        tokens = cell.shape["global_batch"] * (
            cell.shape["seq_len"] if cell.kind != "decode" else 1
        )
        n_params = (
            arch.cfg.active_param_count()
            if arch.cfg.moe else arch.cfg.param_count()
        )
        if cell.kind == "train":
            return 6.0 * n_params * tokens
        if cell.kind == "prefill":
            return 2.0 * n_params * tokens
        # decode: fwd flops + attention over the cache
        L, KV, dh = arch.cfg.n_layers, arch.cfg.n_kv_heads, arch.cfg.head_dim
        H = arch.cfg.n_heads
        attn = (
            2.0 * 2.0 * cell.shape["global_batch"] * H * dh
            * cell.shape["seq_len"] * L
        )
        return 2.0 * n_params * tokens + attn
    if arch.family == "sasrec":
        e = arch.cfg.embed_dim
        if cell.kind == "retrieval":
            return 2.0 * cell.shape["n_candidates"] * e
        if cell.kind == "serve":
            # user encoder + full-catalog MIPS
            S = arch.cfg.seq_len
            enc = 2.0 * arch.cfg.n_blocks * (4 * e * e * S + 2 * S * S * e)
            return cell.shape["batch"] * (
                enc + 2.0 * arch.cfg.n_items * e
            )
        S = arch.cfg.seq_len
        enc = 2.0 * arch.cfg.n_blocks * (4 * e * e * S + 2 * S * S * e)
        return 3.0 * cell.shape["batch"] * (
            enc + 2.0 * S * arch.cfg.n_neg * e
        )
    if arch.family == "recsys":
        cfg = arch.cfg
        B = cell.shape.get("n_candidates", cell.shape.get("batch", 1))
        d0 = cfg.interaction_dim
        if cfg.kind == "dcn_v2":
            per = 2.0 * cfg.n_cross_layers * d0 * d0
            dims = (d0,) + cfg.mlp_dims
            for i in range(len(dims) - 1):
                per += 2.0 * dims[i] * dims[i + 1]
        elif cfg.kind == "fm":
            per = 4.0 * cfg.n_sparse * cfg.embed_dim
        else:  # autoint
            F, H, da = cfg.n_sparse, cfg.n_attn_heads, cfg.d_attn
            e = cfg.embed_dim
            per = 0.0
            d_in = e
            for _ in range(cfg.n_attn_layers):
                per += 2.0 * F * (4 * d_in * H * da) + 4.0 * F * F * H * da
                d_in = H * da
        mult = 3.0 if cell.kind == "train" else 1.0
        return mult * B * per
    if arch.family == "nequip":
        E = cell.shape["n_edges"]
        C = arch.cfg.channels
        # per edge: radial MLP + tensor-product paths (~9 paths, m<=5)
        per_edge = 2.0 * (arch.cfg.n_rbf * 64 + 64 * 9 * C) + 9 * 2.0 * C * 15
        return 3.0 * arch.cfg.n_layers * E * per_edge
    return None
