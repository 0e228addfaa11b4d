"""Training substrate of the port: optimizers, compression, trainer,
checkpointing (counterpart of ``repro.train``)."""
from repro_torch.train import checkpoint, compression, optim, trainer

__all__ = ["optim", "compression", "trainer", "checkpoint"]
