from repro_torch.data.pipeline import (DataConfig, MemmapDataset,
                                       ShardedLoader, SyntheticLM)
