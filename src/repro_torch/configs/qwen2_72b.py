"""qwen2-72b [arXiv:2407.10671]: dense, GQA kv=8, QKV bias.

The port's copy of ``repro.configs.qwen2_72b.CFG`` (serving fields
only).  Its 72 B parameters do not fit one 80 GB card: a config only.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="qwen2-72b", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, q_chunk=2048,
)


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
