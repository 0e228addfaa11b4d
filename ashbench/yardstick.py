"""Peaks of the card and the work a search needs, counted from shapes.

The counts follow the bounds of the kernel table of ``PERF.md``: each
input byte read once and each output byte written once, whatever a
kernel reads again, and the operations of the arithmetic itself.  They
count the work, not an implementation: the payload as stored (packed
codes, fp16 SCALE and OFFSET, an int32 landmark id a row), only the
live candidates of an IVF probe (never the padding of a candidate
table), and no per-call conversion.  A roofline share is the bound
time of the counted work over the device's busy time, so it cannot
pass 100 % unless a count is too high.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12  # int8 tensor cores
PEAK_BYTES = 3.35e12  # HBM3
HEADER_BYTES = 2 + 2 + 4  # fp16 SCALE, fp16 OFFSET, int32 landmark id


@dataclasses.dataclass
class Work:
    flops: float = 0.0  # float32 operations
    int8_ops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o: "Work") -> "Work":
        return Work(self.flops + o.flops, self.int8_ops + o.int8_ops,
                    self.bytes + o.bytes)

    def __mul__(self, c: float) -> "Work":
        return Work(self.flops * c, self.int8_ops * c, self.bytes * c)

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the
        operations at their peak rates and the bytes at the HBM rate."""
        ops = self.flops / PEAK_FP32_FLOPS + self.int8_ops / PEAK_INT8_OPS
        return max(ops, self.bytes / PEAK_BYTES)


def row_bytes(words: int) -> int:
    """Bytes of one stored payload row: packed words and headers."""
    return 4 * words + HEADER_BYTES


def prep(m: int, D: int, d: int, C: int) -> Work:
    """Query preparation: W q, <q, mu_c> for C landmarks, ||q||^2."""
    return Work(flops=2.0 * m * D * (d + C + 1),
                bytes=4.0 * (m * D + d * D + C * D + m * (d + C + 1)))


def score_ops(pairs: float, d_pad: int, metric: str) -> float:
    """Operations of Eq. (20) over ``pairs`` (query, row) pairs: the
    d_pad-long inner product and its scale, offset and landmark terms,
    two more for the L2 epilogue."""
    return pairs * (2.0 * d_pad + (3 if metric == "dot" else 5))


def dense_scan(m: int, n: int, d_pad: int, words: int, C: int, k: int,
               metric: str) -> Work:
    """Kernel 2 and its merge (kernel 1 with an (m, n) output instead of
    the (m, k) selection): every row scored for every query."""
    return Work(flops=score_ops(float(m) * n, d_pad, metric),
                bytes=n * row_bytes(words) + 4.0 * m * (d_pad + C)
                + 8.0 * m * k)


def gather_scan(m: int, pairs: float, distinct: float, d_pad: int,
                words: int, C: int, k: int, metric: str) -> Work:
    """Kernel 4 and its merge over the live candidates of the probed
    lists: ``pairs`` (query, live row) pairs, ``distinct`` rows among
    them read once."""
    return Work(flops=score_ops(pairs, d_pad, metric),
                bytes=distinct * row_bytes(words) + 4.0 * m * (d_pad + C)
                + 8.0 * m * k)


def coarse_scan(m: int, n: int, d_pad: int, words: int, C: int, k: int
                ) -> Work:
    """Kernels 5 and 6: the int8 inner products and five float32
    operations a pair."""
    return Work(flops=5.0 * m * n, int8_ops=2.0 * m * n * d_pad,
                bytes=n * row_bytes(words) + m * (d_pad + 8 + 4 * C)
                + 8.0 * m * k)


def rerank(m: int, r: int, D: int, k: int, metric: str) -> Work:
    """Exact scores of a shortlist of ``r`` raw bf16 rows a query, and
    the top-k out."""
    ip = 2.0 * m * r * D
    return Work(flops=ip if metric == "dot" else 2 * ip,
                bytes=2.0 * m * r * D + 8.0 * m * (r + k))


def shapes(cfg: dict) -> dict:
    """n, D, C, the packed words and the padded width d_pad of a
    configuration's payload."""
    b, d = cfg["ash"]["b"], cfg["ash"]["d"]
    words = -(-d // (32 // b))
    return dict(n=cfg["n"], D=cfg["dim"], C=cfg["ash"]["n_landmarks"],
                words=words, d_pad=words * (32 // b))
