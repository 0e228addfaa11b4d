"""Device selection and float32 precision policy shared by the port."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; refuse CUDA without a card.

    Entry points default to ``"cuda"`` and never fall back to the CPU
    on their own: a caller that wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def full_fp32() -> None:
    """Run float32 matrix products and convolutions in full float32.

    TF32 keeps ~10 mantissa bits, which would move Eq. (20) scores,
    encoded headers and learned rotations away from the reference; both
    switches are set explicitly by every function that multiplies
    float32 matrices on the card.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def host_scalars():
    """Compute a host-side scalar on real CPU tensors.

    The train step's counters (``TrainState.step``, the optimizer's
    step, the RNG words) live on the CPU, and the learning rate, bias
    corrections and decay are Python floats read from them.  Under a
    fake-tensor mode (the dry-run's trace, ``launch.analysis``) those
    reads would fail: inside this context the mode is set aside, so the
    same code computes the same values on real tensors.  With no fake
    mode active it changes nothing.  Also a decorator.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        yield


ROW_BLOCK = 32  # rows per product of :func:`row_blocked`


def row_blocked(fn, *rows: torch.Tensor, block: int = ROW_BLOCK):
    """``fn(*rows)`` computed ``block`` rows at a time, so that each
    row's result does not depend on how many rows come with it.

    A matrix product or row reduction over m rows may take another
    kernel, and another summation order, for each m (a GEMV at m = 1,
    other blockings at m = 8 and 128, on the CPU and in cuBLAS alike).
    Here every call of ``fn`` sees the same row count: full blocks are
    contiguous slices of the operands, the last partial block alone is
    zero-padded to ``block`` rows, ``fn`` runs once per block (one call
    each, never one batched call: the kernel choice may follow the
    batch count too), and the pad rows are sliced off.  A caller keeps
    one block size for one computation.  ``fn`` returns a tensor or a
    tuple of tensors, each with a leading row dimension.
    """
    m = rows[0].shape[0]
    if m == 0:
        return fn(*rows)
    full = m - m % block
    blocks = [fn(*(r[i:i + block].contiguous() for r in rows))
              for i in range(0, full, block)]
    if full < m:
        pad = block - (m - full)
        blocks.append(fn(*(
            torch.nn.functional.pad(r[full:], (0, 0) * (r.dim() - 1)
                                    + (0, pad)) for r in rows)))

    def join(parts):
        return (parts[0] if len(parts) == 1 else torch.cat(parts))[:m]

    if isinstance(blocks[0], tuple):
        return tuple(join(parts) for parts in zip(*blocks))
    return join(blocks)
