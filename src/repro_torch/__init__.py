"""PyTorch / CUDA port of :mod:`repro` (the JAX package stays the
reference).

It carries the serving and the single-device training paths: the numpy
cores (``repro_torch.core``), the symmetric BLAS (``repro_torch.blas``,
batched and differentiable) on hand-written Hopper kernels
(``repro_torch/csrc``), the packed Gram / Newton–Schulz whitening, AdamW
and Muon (``repro_torch.optim``), the GQA/SwiGLU decoder and the xLSTM
decoder, whose sLSTM recurrence runs on its own kernel
(``repro_torch.models``), the data pipeline (``repro_torch.data``), and
the continuous-batching server with its multi-tenant whitening cache
and the trainer (``repro_torch.launch``).

Importing the package imports no submodule, builds nothing and touches
no device: the CUDA kernels are compiled at their first launch.
"""
