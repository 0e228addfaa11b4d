"""Models of the port.

common      — initializers, norms, SwiGLU, RoPE, GQA attention, losses,
              segment sums and EmbeddingBag
transformer — dense and MoE decoder: ``init_params``, ``forward``/
              ``prefill``, ``init_cache``, ``decode_step``, ``loss_fn``
sasrec      — SASRec sequential recommender (next-item retrieval)
recsys      — DCN-v2, FM, AutoInt CTR models over folded tables
nequip      — NequIP E(3)-equivariant interatomic potential
convert     — the reference's numpy parameter and cache trees <-> the port
"""
from repro_torch.models import (common, convert, nequip, recsys, sasrec,
                                transformer)

__all__ = ["common", "convert", "nequip", "recsys", "sasrec",
           "transformer"]
