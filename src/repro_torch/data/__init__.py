"""The seeded Zipf token stream (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, batch_specs, make_batch,
                                       synthetic_stream)

__all__ = ["DataConfig", "batch_specs", "make_batch", "synthetic_stream"]
