from lighthand_tpu_torch.data.pipeline import (
    DevicePreprocessor,
    Loader,
    preprocess_u8,
)
from lighthand_tpu_torch.data.records import (
    ConcatSource,
    Sample,
    Source,
    SubsetSource,
    random_split_90_10,
    source_heatmap_styles,
)
from lighthand_tpu_torch.data.registry import build_dataset
from lighthand_tpu_torch.data.synthetic import SyntheticHands

__all__ = [
    "ConcatSource",
    "DevicePreprocessor",
    "Loader",
    "Sample",
    "Source",
    "SubsetSource",
    "SyntheticHands",
    "build_dataset",
    "preprocess_u8",
    "random_split_90_10",
    "source_heatmap_styles",
]
