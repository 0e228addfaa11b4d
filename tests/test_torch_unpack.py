"""The scan kernels' conversion-free unpack, modelled bit for bit in numpy.

``code_float<B>`` (``repro_torch/kernels/csrc/ash_common.cuh``) turns code
c of a packed word into the float of its grid value 2l - (2^b - 1)
without an int-to-float conversion: the codes of a word fall into
segments of K = 23 // b - 1; segment g is read from one copy of the word
shifted left by b (g = 0) or right by b (gK - 1), which puts code c's b
bits at mantissa position s = b (1 + c % K); or-ing in the exponent of
2^E, E = 24 - s, makes the float 2^E + 2l, and one fp32 subtraction of
2^E + 2^b - 1 leaves the grid value.  The model below performs the same
uint32 shifts, masks and ors and the same float32 subtraction.
Tolerance: none.  Every modelled value must EQUAL float(2l - (2^b - 1)),
the port's ``unpack_codes`` and the JAX package's, for every bitrate,
code slot and level, whatever the word's other bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402

U = np.uint32


def code_float(words: np.ndarray, b: int, c: int) -> np.ndarray:
    """``code_float<b>(word, c)`` on uint32 words, as the kernel does it."""
    K = 23 // b - 1
    g, s = c // K, b * (1 + c % K)
    w = words << U(b) if g == 0 else words >> U(b * (g * K - 1))
    expo = U((127 + 24 - s) << 23)
    x = ((w & U(((1 << b) - 1) << s)) | expo).view(np.float32)
    const = np.array([expo | U(((1 << b) - 1) << (s - 1))],
                     dtype=np.uint32).view(np.float32)[0]
    assert x.dtype == np.float32 and const == 2.0 ** (24 - s) + 2**b - 1
    return x - const  # float32 subtraction, rounded to nearest


def _words(b: int, c: int) -> tuple[np.ndarray, np.ndarray]:
    """Words whose code c takes every level, the other bits all 0, all 1
    and random; and those levels."""
    rng = np.random.default_rng(100 * b + c)
    levels = np.tile(np.arange(2**b, dtype=np.uint32), 3)
    other = np.concatenate([np.zeros(2**b, np.uint32),
                            np.full(2**b, 0xFFFFFFFF, np.uint32),
                            rng.integers(0, 2**32, 2**b, dtype=np.uint32)])
    mask = U(((1 << b) - 1) << (c * b))
    return (other & ~mask) | (levels << U(c * b)), levels


@pytest.mark.parametrize("b,c", [(b, c) for b in (1, 2, 4, 8)
                                 for c in range(32 // b)])
def test_code_float_is_the_grid_value(b, c):
    words, levels = _words(b, c)
    got = code_float(words, b, c)
    want = (2 * levels.astype(np.int64) - (2**b - 1)).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    # the whole word through the port's unpack: column c of each word
    unpacked = TQ.unpack_codes(torch.from_numpy(words.view(np.int32))[:, None],
                               32 // b, b)
    np.testing.assert_array_equal(got, unpacked[:, c].numpy()
                                  .astype(np.float32))


@pytest.mark.parametrize("b,d", [(1, 100), (2, 128), (4, 72), (8, 20)])
def test_code_float_unpacks_rows_as_the_reference(b, d):
    """Every code of packed rows (d not a multiple of 32 // b), modelled
    word by word, equals the JAX package's unpack_codes."""
    rng = np.random.default_rng(b + d)
    vals = 2 * rng.integers(0, 2**b, size=(40, d)) - (2**b - 1)
    packed = np.asarray(JQ.pack_codes(jnp.asarray(vals, jnp.int32), b))
    cpw = 32 // b
    got = np.stack([code_float(packed[:, w], b, c)
                    for w in range(packed.shape[1]) for c in range(cpw)],
                   axis=1)[:, :d]
    np.testing.assert_array_equal(
        got, np.asarray(JQ.unpack_codes(jnp.asarray(packed), d, b))
        .astype(np.float32))
