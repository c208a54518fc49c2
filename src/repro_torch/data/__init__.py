"""Training data: the synthetic token stream, the resumable token-shard
reader and the prefetching pipeline."""
from repro_torch.data.pipeline import DataPipeline  # noqa: F401
from repro_torch.data.synthetic import (SyntheticEmbeds,  # noqa: F401
                                        SyntheticLM, synthetic_source)
from repro_torch.data.tokenshards import (ShardWriter,  # noqa: F401
                                          TokenShardDataset,
                                          write_synthetic_shards)
