"""Hand-written Hopper kernels for the symmetric BLAS and their plain
PyTorch versions: ``trigrid.rank_update`` (SYRK / SYR2K bodies) and
``trigrid.sym_stream`` (SYMM), with the per-op entry points in
``syrk`` / ``syr2k`` / ``symm`` and the dense oracles in ``ref``.
The CUDA sources live in ``repro_torch/csrc`` and are built by
``native.load`` at the first launch on a CUDA tensor."""
