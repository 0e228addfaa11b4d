"""deepseek-7b [arXiv:2401.02954]: dense llama-arch, MHA (GQA kv=32).

The port's copy of ``repro.configs.deepseek_7b.CFG`` (its fields,
``remat`` included) and of its ``train_cfg`` as ``TRAIN_CFG``;
d_head = 128, G = 1.
"""
import torch

from repro_torch.configs import DECODE_32K_ASHKV, ashkv  # noqa: F401
from repro_torch.configs.base import lm_cells
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.trainer import TrainConfig

CFG = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab=102400, qkv_bias=False,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True,
    q_chunk=2048,
)

TRAIN_CFG = TrainConfig(opt=OptConfig(name="adamw", lr=3e-4), microbatches=4)

CELLS = lm_cells(full_attention=True)

NOTES = "llama-arch dense 7B; MHA (kv == heads)."


def ashkv_config() -> TransformerConfig:
    """CFG with the ``decode_32k_ashkv`` cell's KV-cache compression."""
    return ashkv(CFG)
