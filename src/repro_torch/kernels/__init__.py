"""Hand-written CUDA kernels for the ASH scoring hot path.

ash_score  — wrappers of ``csrc/ash_score.cu``: the dense Eq. (20) scan
             and the scan with fused top-k selection, with launch counts
ash_kv_attn — wrapper of ``csrc/ash_kv_attn.cu``: decode attention
             over an ASH-compressed KV cache, with its launch count
ref        — their plain PyTorch versions
ops        — model-level entry points (kernel on CUDA, plain on CPU)
_build     — ``nvcc`` build of ``csrc/`` at first use, cached by hash

The package does not re-export ``ops.ash_score``: the name would shadow
the ``ash_score`` wrapper module.
"""
from repro_torch.kernels import ash_kv_attn, ash_score, ops, ref

__all__ = ["ash_kv_attn", "ash_score", "ops", "ref"]
