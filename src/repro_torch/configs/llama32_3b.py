"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B]: small llama3, GQA kv=8.

The port's copy of ``repro.configs.llama32_3b.CFG`` (serving fields
only) and of the ``decode_32k_ashkv`` cell shape of
``repro.configs.base.lm_cells``: decode at a 32k context with the
ASH-compressed KV cache, b = 4, d_code = d_head = 128.
"""
import dataclasses

import torch

from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=8192, vocab=128256, qkv_bias=False,
    rope_theta=500000.0, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    q_chunk=2048,
)

DECODE_32K_ASHKV = {"seq_len": 32768, "global_batch": 128,
                    "kv_quant_bits": 4, "kv_quant_dim": 0}


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return dataclasses.replace(
        CFG, kv_quant_bits=DECODE_32K_ASHKV["kv_quant_bits"],
        kv_quant_dim=DECODE_32K_ASHKV["kv_quant_dim"])
