"""Device selection and float32 precision policy shared by the port."""
from __future__ import annotations

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
