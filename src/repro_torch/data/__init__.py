"""Deterministic synthetic data pipeline with sharded host loading
(port of :mod:`repro.data`)."""
from .pipeline import (DataConfig, SyntheticLM, make_train_iterator,
                       pack_documents)

__all__ = ["DataConfig", "SyntheticLM", "make_train_iterator",
           "pack_documents"]
