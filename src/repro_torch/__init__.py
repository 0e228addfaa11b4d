"""ASH on PyTorch and CUDA: the port of the ``repro`` package.

Same layout and names as ``repro`` (``core``, ``kernels``, ``index``,
``data``) over torch tensors.  The scoring hot path runs through
hand-written CUDA kernels (``repro_torch.kernels``) built with ``nvcc``
at first use; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.

Entry points (``AshIndex.build``/``load``, ``core.ash.train``,
``data.synthetic.embedding_dataset``) run on ``device="cuda"`` unless
the caller passes ``device="cpu"``; without a CUDA device they raise.
"""
