from .batching import MolBatch, MolFeatures, attach_flat_layouts, bucket_size, collate
from .binning import BinningError, bin_pack_batch
from .preprocessing import PreprocessingConfig, PreprocessingPipeline, StandardScaler

__all__ = [
    "MolBatch",
    "MolFeatures",
    "attach_flat_layouts",
    "bucket_size",
    "collate",
    "BinningError",
    "bin_pack_batch",
    "PreprocessingConfig",
    "PreprocessingPipeline",
    "StandardScaler",
]
