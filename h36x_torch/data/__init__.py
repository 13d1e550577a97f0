"""Data subsystem: ingestion, clip windowing, shard store, samplers."""

from h36x_torch.data.shards import ShardReader, ShardWriter, load_index, write_index  # noqa: F401
from h36x_torch.data.features import FeatureClipDataset  # noqa: F401
from h36x_torch.data.sampler import MixedShardBatchSampler  # noqa: F401
