"""Port parity: quantization and bit packing against the JAX package.

Inputs are made with numpy from fixed seeds and given to both
packages.  Tolerances: integer work (levels, packed words, exact
quantizer codes) is compared bit for bit; the grid quantizer (b = 8) is
held to its cosine objective within 1e-5, since its log-spaced scale
grid is rounded differently by the two frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantization as JQ  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402


def _values(rng, n, d, b):
    levels = rng.integers(0, 2**b, size=(n, d))
    return (2 * levels - (2**b - 1)).astype(np.int32)


@pytest.mark.parametrize("b,d", [(1, 37), (2, 37), (4, 13), (8, 7), (2, 64)])
def test_pack_unpack_bit_exact(b, d):
    """Packed words equal the reference's uint32 words bit for bit, and
    unpack inverts them, with d not a multiple of 32/b."""
    vals = _values(np.random.default_rng(b * 100 + d), 50, d, b)
    want = np.asarray(JQ.pack_codes(jnp.asarray(vals), b))
    got = TQ.pack_codes(torch.from_numpy(vals), b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back = TQ.unpack_codes(got, d, b)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(JQ.unpack_codes(jnp.asarray(want), d, b)),
    )
    assert TQ.packed_width(d, b) == JQ.packed_width(d, b) == want.shape[1]


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_grid_and_level_maps(b):
    np.testing.assert_array_equal(
        TQ.grid_values(b).numpy(), np.asarray(JQ.grid_values(b))
    )
    vals = TQ.grid_values(b)
    levels = TQ.values_to_levels(vals, b)
    np.testing.assert_array_equal(
        levels.numpy(), np.asarray(JQ.values_to_levels(jnp.asarray(vals), b))
    )
    np.testing.assert_array_equal(
        TQ.levels_to_values(levels, b).numpy(), vals.numpy()
    )


def _with_ties(rng, n, d):
    u = rng.standard_normal((n, d)).astype(np.float32)
    # equal |u_j| within a row (and across sign) make tied breakpoints
    u[:, 1] = -u[:, 0]
    u[:, 2] = u[:, 0]
    u[::2, 5:9] = 0.25
    u[1::3, 10] = 0.0
    return u


@pytest.mark.parametrize("b", [1, 2, 4])
def test_quant_exact_bit_exact(b):
    u = _with_ties(np.random.default_rng(b), 200, 24)
    want = np.asarray(JQ.quant_exact(jnp.asarray(u), b))
    got = TQ.quant_exact(torch.from_numpy(u), b)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TQ.quant(torch.from_numpy(u), b).numpy(), want)


def test_quant_exact_batch_shape():
    u = np.random.default_rng(7).standard_normal((3, 5, 16)).astype(np.float32)
    got = TQ.quant_exact(torch.from_numpy(u), 2)
    assert got.shape == (3, 5, 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JQ.quant_exact(jnp.asarray(u), 2))
    )


def test_quant_grid_b8_objective():
    u = np.random.default_rng(8).standard_normal((64, 32)).astype(np.float32)
    got = TQ.quant(torch.from_numpy(u), 8).numpy().astype(np.float64)
    want = np.asarray(JQ.quant(jnp.asarray(u), 8)).astype(np.float64)

    def cos(v):
        return (v * u).sum(-1) / (np.linalg.norm(v, axis=-1)
                                  * np.linalg.norm(u, axis=-1))

    assert np.abs(got).max() <= 255 and (np.abs(got) % 2 == 1).all()
    np.testing.assert_allclose(cos(got), cos(want), atol=1e-5)


def test_code_norms():
    vals = _values(np.random.default_rng(3), 20, 9, 4)
    np.testing.assert_allclose(
        TQ.code_norms(torch.from_numpy(vals)).numpy(),
        np.asarray(JQ.code_norms(jnp.asarray(vals))), rtol=1e-6,
    )
