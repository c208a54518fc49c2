"""Training data: the synthetic token stream and the prefetching pipeline."""
from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import (SyntheticEmbeds,  # noqa: F401
                                        SyntheticLM, synthetic_source)
