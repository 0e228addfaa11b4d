"""Core datatypes of the ASH library over torch tensors.

Frozen dataclasses, field for field the ``repro.core.types`` ones.
Tensors carry their own device; ``from_numpy``/``to_numpy`` convert
to and from the numpy arrays the JAX package stores, so a model or
payload trained or encoded there can be scored here and back.

Packed codes are held as ``torch.int32`` tensors carrying the uint32
bit patterns (torch has no right shift for uint32): the bits are the
reference's words, and ``to_numpy`` views them back as ``uint32``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class ASHConfig:
    """Static configuration of an ASH quantizer.

    Attributes:
      b: bitrate per dimension (1, 2, 4, 8).
      d: target (reduced) dimensionality, d <= D (0 = same as D,
        resolved at train time).
      n_landmarks: number of landmark (coarse-quantizer) vectors C.
      store_fp16: keep the per-vector SCALE/OFFSET headers in IEEE
        fp16, the paper's 16-bit header payload (Table 1).
    """

    b: int = 2
    d: int = 0
    n_landmarks: int = 1
    store_fp16: bool = True

    @property
    def grid_max(self) -> int:
        return 2**self.b - 1

    def payload_bits(self, with_log2c: bool = True) -> int:
        """Total bits per encoded vector, per Table 1 of the paper."""
        header = 2 * 16
        if with_log2c and self.n_landmarks > 1:
            header += math.ceil(math.log2(self.n_landmarks))
        return header + self.b * self.d


@dataclasses.dataclass(frozen=True)
class ASHModel:
    """Learned global parameters: W = R @ P (d, D) row-orthonormal, the
    landmarks (C, D), and their projections/norms."""

    config: ASHConfig
    W: torch.Tensor  # (d, D) f32
    landmarks: torch.Tensor  # (C, D) f32
    W_landmarks: torch.Tensor  # (C, d) f32
    landmark_sq_norms: torch.Tensor  # (C,) f32
    bias_rho: torch.Tensor  # () f32, Eq. (34) correction (identity)
    bias_beta: torch.Tensor  # () f32

    @property
    def D(self) -> int:
        return self.W.shape[1]

    @property
    def d(self) -> int:
        return self.W.shape[0]

    @property
    def device(self) -> torch.device:
        return self.W.device

    ARRAY_FIELDS = (
        "W", "landmarks", "W_landmarks", "landmark_sq_norms",
        "bias_rho", "bias_beta",
    )

    @classmethod
    def from_numpy(cls, config: ASHConfig, arrays: dict,
                   device="cuda") -> "ASHModel":
        """Build from numpy arrays keyed by field name (the JAX
        model's fields, e.g. ``np.asarray(jax_model.W)``)."""
        dev = resolve_device(device)
        return cls(config=config, **{
            f: _tensor(arrays[f], dev, torch.float32)
            for f in cls.ARRAY_FIELDS
        })

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy()
                for f in self.ARRAY_FIELDS}


@dataclasses.dataclass(frozen=True)
class ASHPayload:
    """Encoded database vectors (the per-vector payload of Table 1).

    codes: (n, Wd) int32 holding uint32 words, ``32 // b`` codes per
    word, little-endian within a word; scale/offset: the SCALE/OFFSET
    headers of Eq. (20) (fp16 or fp32); cluster: c*_i as int32.
    """

    b: int
    d: int
    codes: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    cluster: torch.Tensor

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    ARRAY_FIELDS = ("codes", "scale", "offset", "cluster")

    @classmethod
    def from_numpy(cls, b: int, d: int, arrays: dict,
                   device="cuda") -> "ASHPayload":
        """Build from numpy arrays keyed by field name; ``codes`` may be
        uint32 (the JAX layout) or int32 bit patterns."""
        dev = resolve_device(device)
        codes = np.ascontiguousarray(arrays["codes"])
        if codes.dtype == np.uint32:
            codes = codes.view(np.int32)
        return cls(
            b=b, d=d,
            codes=_tensor(codes, dev, torch.int32),
            scale=_tensor(arrays["scale"], dev),
            offset=_tensor(arrays["offset"], dev),
            cluster=_tensor(arrays["cluster"], dev, torch.int32),
        )

    def to_numpy(self) -> dict:
        out = {f: getattr(self, f).cpu().numpy()
               for f in self.ARRAY_FIELDS}
        out["codes"] = out["codes"].view(np.uint32)
        return out


@dataclasses.dataclass(frozen=True)
class ASHStats:
    """Query-independent per-row statistics recovered once at build
    time (Table 1): res_norm = ||x - mu*||, ip_x_mu = <x, mu*>, and the
    Eq. (A.5) ||x||^2 estimate x_sq; each (n,) f32."""

    res_norm: torch.Tensor
    ip_x_mu: torch.Tensor
    x_sq: torch.Tensor

    @property
    def n(self) -> int:
        return self.res_norm.shape[0]


@dataclasses.dataclass(frozen=True)
class QueryPrep:
    """Per-query terms of Eq. (20): q, q_breve = W q, <q, mu_c>, ||q||^2."""

    q: torch.Tensor  # (m, D) f32
    q_proj: torch.Tensor  # (m, d)
    ip_q_landmarks: torch.Tensor  # (m, C)
    q_sq_norm: torch.Tensor  # (m,)


@dataclasses.dataclass(frozen=True)
class CoarseCodes:
    """What the symmetric int8 coarse scan needs of a payload beyond its
    packed codes: ``mean``, the scale-weighted corpus mean of the
    dequantized rows, ``mean_j(SCALE_j * v_j)`` (d_pad,) f32, the
    operand of the query correction ``q_corr`` that makes coarse scores
    corpus-mean-unbiased estimates of the asymmetric score.

    The reference also caches the (n, d_pad) fp32 grid values here; the
    port does not (512 MB at n = 10^6): the coarse kernels unpack the
    packed words, and the plain versions unpack the rows they read,
    which gives the same integers.  Derived from the payload, never
    persisted.
    """

    mean: torch.Tensor  # (d_pad,) f32


@dataclasses.dataclass(frozen=True)
class CoarseQueryPrep:
    """Per-query int8 symmetric quantization of ``QueryPrep.q_proj``:
    q_int8 = round(q_proj / q_scale) with q_scale = max|q_proj| / 127,
    and the residual correction q_corr = <q_proj - q_scale * q_int8,
    mean> folded into the Eq. (20) base score."""

    q_int8: torch.Tensor  # (m, d) int8
    q_scale: torch.Tensor  # (m,) f32
    q_corr: torch.Tensor  # (m,) f32
