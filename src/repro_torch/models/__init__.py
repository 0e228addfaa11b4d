"""Models served by the port.

common      — initializers, RMSNorm, SwiGLU, RoPE, GQA attention
transformer — dense decoder: ``init_params``, ``forward``/``prefill``,
              ``init_cache``, ``decode_step`` (bf16 or ASH-KV cache)
convert     — the reference's numpy parameter and cache trees <-> the port
"""
from repro_torch.models import common, convert, transformer

__all__ = ["common", "convert", "transformer"]
