"""Hand-written Hopper kernels and their plain PyTorch versions:
``trigrid.rank_update`` (SYRK / SYR2K bodies) and ``trigrid.sym_stream``
(SYMM) for the symmetric BLAS, with the per-op entry points in
``syrk`` / ``syr2k`` / ``symm``, the padded dense wrappers in ``ops``
and the dense oracles in ``ref``, and
``slstm.slstm_scan`` (the sLSTM recurrence); ``counts`` holds every
wrapper's launch count.  The CUDA sources live in
``repro_torch/csrc`` and are built by ``native.load`` at the first
launch on a CUDA tensor."""
