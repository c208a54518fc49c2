"""Training data: the synthetic token stream and the prefetching pipeline."""
from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import SyntheticLM  # noqa: F401
