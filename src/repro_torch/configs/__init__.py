"""Model configurations of the port (its own copies of ``repro.configs``).

Each module holds the reference's ``CFG``, its ``train_cfg`` as
``TRAIN_CFG`` (the port's ``TrainConfig``/``OptConfig``), its shape
cells as ``CELLS`` (``base``: ``lm_cells``, ``recsys_cells``,
``gnn_cells``), ``NOTES`` and, where the reference has them,
``POLICY_OVERRIDES``.  Each LM module also holds ``ashkv_config()``, CFG
in the ``decode_32k_ashkv`` cell (:data:`DECODE_32K_ASHKV`, that cell's
shape): decode at a 32k context with the ASH-compressed KV cache,
b = 4, d_code = d_head.  ``registry.get`` finds any of the ten by the
reference's arch id.
"""
import dataclasses

from repro_torch.configs.base import lm_cells

DECODE_32K_ASHKV = lm_cells()["decode_32k_ashkv"].shape


def ashkv(cfg):
    """``cfg`` with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return dataclasses.replace(
        cfg, kv_quant_bits=DECODE_32K_ASHKV["kv_quant_bits"],
        kv_quant_dim=DECODE_32K_ASHKV["kv_quant_dim"])
