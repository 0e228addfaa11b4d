"""deepseek-7b [arXiv:2401.02954]: dense llama-arch, MHA (GQA kv=32).

The port's copy of ``repro.configs.deepseek_7b.CFG`` (serving fields
only); d_head = 128, G = 1.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab=102400, qkv_bias=False,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, q_chunk=2048,
)


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
