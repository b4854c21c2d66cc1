from .pipeline import batches_for_run, length_bucketed_order, synthetic_batch  # noqa: F401
