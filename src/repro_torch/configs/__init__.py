"""Model configurations of the port (its own copies of ``repro.configs``).

Each LM module holds the reference's ``CFG``, its ``train_cfg`` as
``TRAIN_CFG`` (the port's ``TrainConfig``/``OptConfig``) and
``ashkv_config()``, CFG in the ``decode_32k_ashkv`` cell of
``repro.configs.base.lm_cells`` (:data:`DECODE_32K_ASHKV`): decode at a
32k context with the ASH-compressed KV cache, b = 4, d_code = d_head.
``sasrec_cfg``, ``dcn_v2``, ``fm``, ``autoint`` and ``nequip_cfg`` hold
the other families' ``CFG`` and ``TRAIN_CFG``.  ``registry.get`` finds
any of the ten by the reference's arch id.
"""
import dataclasses

DECODE_32K_ASHKV = {"seq_len": 32768, "global_batch": 128,
                    "kv_quant_bits": 4, "kv_quant_dim": 0}


def ashkv(cfg):
    """``cfg`` with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return dataclasses.replace(
        cfg, kv_quant_bits=DECODE_32K_ASHKV["kv_quant_bits"],
        kv_quant_dim=DECODE_32K_ASHKV["kv_quant_dim"])
