"""Wrapper of the ASH-KV decode attention kernel (``csrc/ash_kv_attn.cu``).

``ash_kv_attn_cuda`` replaces ``repro.kernels.ash_kv_attn.
ash_kv_attn_pallas``, batched and with G query heads per KV stream: for
a CUDA tensor it launches the kernel on the current stream or raises;
for a CPU tensor it runs the plain version, ``ref.ash_kv_attn_ref``.
Each launch adds one to ``launch_counts["ash_kv_attn"]`` and nowhere
else, so a run can show that its decode steps went through the kernel.

Operands are read in place through their strides: up to two lead
dimensions (for decode: batch and KV head of the ``(B, S, KV, W)``
layer cache, permuted as a view), packed words with a unit last stride,
scales in bf16 or fp32, a broadcast mask.  Nothing is copied or
converted except the small query block.  Both products run on the
tensor cores (bf16 ``mma.sync`` on exact codes, fp32 operands split
into three bf16 parts); the design note is in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import _build, ref
from repro_torch.kernels.ash_score import (
    _count_lock, _ptr, count_launch, launch_on,
)

G_MAX = 8  # query heads per KV stream the kernel takes
D_MAX = 256  # packed code width (words * codes per word) it takes
TILE = 256  # positions a block's 8 warps take in one round (32 each)
TARGET_BLOCKS = 2048  # blocks to aim for when splitting S (132 SMs)

launch_counts = {"ash_kv_attn": 0}
_lib = None


def reset_launch_counts() -> None:
    with _count_lock:
        launch_counts["ash_kv_attn"] = 0


def _kernels() -> ctypes.CDLL:
    """The loaded library of ``csrc/ash_kv_attn.cu``, built at first use."""
    global _lib
    if _lib is None:
        lib = _build.load("ash_kv_attn")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ash_kv_attn_launch.argtypes = (
            [P] * 11 + [ctypes.POINTER(ctypes.c_longlong)] + [I] * 11 + [P])
        lib.ash_kv_attn_launch.restype = I
        _lib = lib
    return _lib


def split_geometry(n_streams: int, S: int) -> tuple[int, int]:
    """(splits, rows per split) of S over the blocks of one stream: about
    TARGET_BLOCKS blocks in all, whole rounds of TILE positions per
    split."""
    tiles = -(-S // TILE)
    splits = max(1, min(tiles, -(-TARGET_BLOCKS // n_streams)))
    rows = -(-tiles // splits) * TILE
    return -(-S // rows), rows


def _lead2(t: torch.Tensor, lead: tuple, tail: tuple) -> torch.Tensor:
    """``t`` broadcast to ``lead + tail`` as a view, with exactly two lead
    dimensions (size-1 ones added in front)."""
    t = torch.broadcast_to(t, lead + tail)
    while t.dim() < 2 + len(tail):
        t = t.unsqueeze(0)
    return t


def ash_kv_attn_cuda(
    q_k, k_codes, k_scale, k_bias, v_codes, v_scale, mask, *,
    b_k: int, b_v: int,
) -> torch.Tensor:
    """Reduced-space decode attention: (*lead, G, dv) f32.

    ``q_k`` (*lead, G, dk) queries in K-code space, dk = Wk * 32/b_k
    (zero past the model's code dimension); ``k_codes``/``v_codes``
    (*lead, S, Wk/Wv) int32 words; ``k_scale``/``v_scale`` (*lead, S),
    both bf16 or both fp32; ``k_bias`` (*lead, S) fp32 or None (zero);
    ``mask`` (*lead, S) bool or None.  Scales, bias and mask may be
    broadcast views.  At most two lead dimensions, G <= 8, dk and
    dv <= 256.  The operands are checked on every device; a CPU tensor
    then goes to the plain version.
    """
    if b_k not in (1, 2, 4, 8) or b_v not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bitrates b_k={b_k}, b_v={b_v}")
    lead, (G, dk) = tuple(q_k.shape[:-2]), tuple(q_k.shape[-2:])
    S, Wk = k_codes.shape[-2:]
    Wv = v_codes.shape[-1]
    dv = Wv * Q.codes_per_word(b_v)
    if len(lead) > 2:
        raise ValueError(f"at most two lead dims, got q_k {tuple(q_k.shape)}")
    if not 1 <= G <= G_MAX or dk != Wk * Q.codes_per_word(b_k):
        raise ValueError(f"q_k {tuple(q_k.shape)}: want (*lead, G <= "
                         f"{G_MAX}, {Wk * Q.codes_per_word(b_k)})")
    if dk > D_MAX or dv > D_MAX:
        raise ValueError(f"code widths {dk}, {dv} above {D_MAX}")
    if q_k.dtype != torch.float32:
        raise ValueError(f"q_k: want float32, got {q_k.dtype}")
    if k_scale.dtype not in (torch.float32, torch.bfloat16) or (
            v_scale.dtype != k_scale.dtype):
        raise ValueError(f"scales: want both bf16 or both f32, got "
                         f"{k_scale.dtype}, {v_scale.dtype}")
    for name, t, dtype in (("k_codes", k_codes, torch.int32),
                           ("v_codes", v_codes, torch.int32),
                           ("k_bias", k_bias, torch.float32),
                           ("mask", mask, torch.bool)):
        if t is not None and t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
    ops = (q_k, k_codes, k_scale, k_bias, v_codes, v_scale, mask)
    if any(t is not None and t.device != q_k.device for t in ops):
        raise ValueError("operands on different devices")
    if tuple(v_codes.shape[:-1]) != lead + (S,) or (
            tuple(k_codes.shape[:-2]) != lead):
        raise ValueError(f"codes {tuple(k_codes.shape)}, "
                         f"{tuple(v_codes.shape)} do not match q_k lead "
                         f"{lead} and S={S}")
    if k_codes.stride(-1) != 1 or v_codes.stride(-1) != 1:
        raise ValueError("codes: want a unit stride along the words")
    if q_k.device.type == "cpu":
        return ref.ash_kv_attn_ref(q_k, k_codes, k_scale, k_bias, v_codes,
                                   v_scale, b_k, b_v, mask=mask)[0]
    kc = _lead2(k_codes, lead, (S, Wk))
    vc = _lead2(v_codes, lead, (S, Wv))
    ks = _lead2(k_scale, lead, (S,))
    vs = _lead2(v_scale, lead, (S,))
    kb = None if k_bias is None else _lead2(k_bias, lead, (S,))
    mk = None if mask is None else _lead2(mask, lead, (S,))
    N1, N2 = kc.shape[:2]
    N = N1 * N2
    strides = []
    for t in (kc, vc, ks, kb, vs, mk):
        strides += [0, 0, 0] if t is None else list(t.stride()[:3])
    dev = q_k.device
    out = torch.empty(lead + (G, dv), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    q = q_k.reshape(N, G, dk).contiguous()
    splits, rows = split_geometry(N, S)
    part_m = torch.empty(N, splits, G, dtype=torch.float32, device=dev)
    part_d = torch.empty_like(part_m)
    part_acc = torch.empty(N, splits, G, dv, dtype=torch.float32, device=dev)
    rc = launch_on(
        dev, _kernels().ash_kv_attn_launch, _ptr(q), _ptr(kc), _ptr(ks),
        _ptr(kb), _ptr(vc), _ptr(vs), _ptr(mk), _ptr(part_m), _ptr(part_d), _ptr(part_acc), _ptr(out),
        (ctypes.c_longlong * 18)(*strides), N, N2, S, G, Wk, Wv, b_k, b_v,
        int(k_scale.dtype == torch.bfloat16), splits, rows,
    )
    if rc:
        raise RuntimeError(f"ash_kv_attn kernel launch failed: cudaError {rc}")
    count_launch(launch_counts, "ash_kv_attn")
    return out
