from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, PackedDataset, synthetic_corpus)
