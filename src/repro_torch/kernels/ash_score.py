"""Wrappers of the dense ASH scan kernels (``csrc/ash_score.cu``).

``ash_score_cuda`` replaces ``repro.kernels.ash_score.ash_score_pallas``
and ``ash_score_topk_cuda`` replaces ``ash_score_topk_pallas``.  For a
CUDA tensor a wrapper launches its kernel on the current stream or
raises; for a CPU tensor it runs the kernel's plain PyTorch version
from ``repro_torch.kernels.ref``.  ``launch_counts`` counts launches,
one per kernel launch and nowhere else, so a run can show which
kernels its main path went through.

Bound and design notes are in the CUDA source.  The fused kernel's
per-tile candidates are merged here by two stable sorts (by id, then by
score), which reproduces the reference's two-key ``lax.sort``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_METRIC_CODE = {"dot": 0, "l2": 1, "cos": 2}  # the kernels' METRIC_* enum

launch_counts = {"ash_score": 0, "ash_score_topk": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ash_score")
        lib.ash_score_launch.argtypes = [_P] * 9 + [_I] * 6 + [_P]
        lib.ash_score_launch.restype = _I
        lib.ash_score_topk_launch.argtypes = (
            [_P] * 11 + [_I] * 8 + [_P]
        )
        lib.ash_score_topk_launch.restype = _I
        _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(codes, q_proj, scale, offset, cluster, ipq, qterm, rowterm,
           metric, b):
    """Refuse what the kernel does not take (it converts nothing)."""
    if metric not in _METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    if b not in (1, 2, 4, 8):
        raise ValueError(f"unsupported bitrate {b}")
    n, wd = codes.shape
    m, d_pad = q_proj.shape
    want = [
        ("codes", codes, torch.int32, (n, wd)),
        ("q_proj", q_proj, torch.float32, (m, wd * (32 // b))),
        ("scale", scale, torch.float32, (n,)),
        ("offset", offset, torch.float32, (n,)),
        ("cluster", cluster, torch.int32, (n,)),
        ("ip_q_landmarks", ipq, torch.float32, (m, ipq.shape[1])),
    ]
    if metric != "dot":
        want += [("qterm", qterm, torch.float32, (m,)),
                 ("rowterm", rowterm, torch.float32, (n,))]
    for name, t, dtype, shape in want:
        if t.device != codes.device or t.dtype != dtype:
            raise ValueError(
                f"{name}: want {dtype} on {codes.device}, got {t.dtype} "
                f"on {t.device}"
            )
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {shape}, got {tuple(t.shape)}"
            )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ash_score_cuda(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, *, b: int, metric: str = "dot",
) -> torch.Tensor:
    """(m, n) f32 scores, higher-is-better for every metric."""
    if codes.device.type == "cpu":
        return ref.ash_score_metric_ref(
            codes, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, b=b, metric=metric,
        )
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b)
    n, wd = codes.shape
    m = q_proj.shape[0]
    out = torch.empty(m, n, dtype=torch.float32, device=codes.device)
    if n == 0 or m == 0:
        return out
    rc = _kernels().ash_score_launch(
        _ptr(codes), _ptr(q_proj), _ptr(scale), _ptr(offset),
        _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm), _ptr(rowterm),
        _ptr(out), n, m, wd, ip_q_landmarks.shape[1], b,
        _METRIC_CODE[metric], _stream(codes.device),
    )
    if rc:
        raise RuntimeError(f"ash_score kernel launch failed: cudaError {rc}")
    launch_counts["ash_score"] += 1
    return out


def ash_score_topk_cuda(
    codes, q_proj, scale, offset, cluster, ip_q_landmarks,
    qterm=None, rowterm=None, n_valid=None, row_valid=None, *,
    b: int, k: int, k_tilde=None, metric: str = "dot",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + selection: top-k (scores, int32 ids), each (m, k).

    Equal to a stable top-k of the materializing kernel's masked scores
    (values, ids and tie order) whenever k <= k_tilde (default k).
    ``n_valid`` masks rows at/beyond it, ``row_valid`` ((n,) bool) masks
    tombstones; both fold into one runtime mask operand.  Slots past the
    valid rows come back as (-inf, -1); k above the n_blocks * k_tilde
    strip raises.
    """
    mask = ref.row_mask(codes.shape[0], n_valid, row_valid, codes.device)
    if mask is not None:
        mask = mask.to(torch.int32)
    if codes.device.type == "cpu":
        return ref.ash_score_topk_ref(
            codes, q_proj, scale, offset, cluster, ip_q_landmarks,
            qterm, rowterm, mask, b=b, k=k, k_tilde=k_tilde, metric=metric,
        )
    _check(codes, q_proj, scale, offset, cluster, ip_q_landmarks, qterm,
           rowterm, metric, b)
    n, wd = codes.shape
    m = q_proj.shape[0]
    # the CUDA tile is always 512 rows: for n < 512 the reference's
    # narrower tile is the same single block
    n_blocks, k_tilde, _ = ref.topk_geometry(n, k, k_tilde)
    strip = n_blocks * k_tilde
    vals = torch.empty(m, strip, dtype=torch.float32, device=codes.device)
    ids = torch.empty(m, strip, dtype=torch.int32, device=codes.device)
    if m == 0:
        return vals[:, :k], ids[:, :k]
    rc = _kernels().ash_score_topk_launch(
        _ptr(codes), _ptr(q_proj), _ptr(scale), _ptr(offset),
        _ptr(cluster), _ptr(ip_q_landmarks), _ptr(qterm), _ptr(rowterm),
        _ptr(mask), _ptr(vals), _ptr(ids), n, m, wd,
        ip_q_landmarks.shape[1], b, _METRIC_CODE[metric], k_tilde,
        n_blocks, _stream(codes.device),
    )
    if rc:
        raise RuntimeError(
            f"ash_score_topk kernel launch failed: cudaError {rc}"
        )
    launch_counts["ash_score_topk"] += 1
    return ref.merge_strip(vals, ids, k)
