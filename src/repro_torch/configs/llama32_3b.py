"""llama3.2-3b [hf:meta-llama/Llama-3.2-3B]: small llama3, GQA kv=8.

The port's copy of ``repro.configs.llama32_3b.CFG`` (its fields,
``remat`` included) and of its ``train_cfg`` as ``TRAIN_CFG``;
d_head = 128.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.configs.base import lm_cells
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = TransformerConfig(
    name="llama3.2-3b", n_layers=28, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=8192, vocab=128256, qkv_bias=False,
    rope_theta=500000.0, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    remat=True, q_chunk=2048,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=3e-4), microbatches=2)

CELLS = lm_cells(full_attention=True)

POLICY_OVERRIDES = {
    # <10B models: replicating FFN/attention weights is cheaper than
    # gathering activations (the reference's measurement on its TPU mesh)
    "pin_ffn_hidden": False, "pin_attn_boundary": False,
}

NOTES = "small llama3; d_head=128."


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
