"""PyTorch / CUDA port of :mod:`repro` (the JAX package stays the
reference).

It carries the serving path: the symmetric BLAS (``repro_torch.blas``)
on hand-written Hopper kernels (``repro_torch/csrc``), the packed Gram /
Newton–Schulz whitening (``repro_torch.optim.gram``), the GQA/SwiGLU
decoder and the xLSTM decoder, whose sLSTM recurrence runs on its own
kernel (``repro_torch.models``), and the continuous-batching server
with its multi-tenant whitening cache (``repro_torch.launch``).

Importing the package imports no submodule, builds nothing and touches
no device: the CUDA kernels are compiled at their first launch.
"""
