"""Deterministic synthetic batches (the reference's ``repro.data``)."""

from .pipeline import DataConfig, batch_specs, data_stream, make_batch

__all__ = ["DataConfig", "make_batch", "batch_specs", "data_stream"]
