"""ray_tpu_torch.data: distributed data pipelines, counterpart of
`ray_tpu.data` (reference: ray.data).

Blocks of numpy columns in the shared-memory object store (the card's
machine has no Arrow: see `data/block.py`), lazy plans with map-stage
fusion, a byte-budgeted streaming executor (`data/streaming`:
backpressure windows, the bundle shuffle, elastic splits), and the device
feed: `Dataset.iter_device_batches` stages batches in pinned memory and
copies them to the card on a side stream (`data/feed.py::torch_feed`), so
the copy of batch k+1 overlaps compute on batch k.
"""
from ray_tpu_torch.data.dataset import Dataset, GroupedData, from_block_list
from ray_tpu_torch.data.feed import (
    DevicePrefetcher,
    TorchFeed,
    device_prefetching,
    torch_feed,
)
from ray_tpu_torch.data.read_api import (
    from_arrow, from_huggingface, from_items, from_numpy, from_pandas,
    from_torch, range, range_tensor, read_bigquery, read_binary_files,
    read_csv, read_images, read_json, read_mongo, read_numpy,
    read_parquet, read_sql, read_text, read_tfrecords, read_webdataset)
from ray_tpu_torch.data.streaming.split import StreamingIngest

__all__ = [
    "Dataset", "GroupedData", "StreamingIngest", "from_block_list",
    "range", "range_tensor", "from_items", "from_numpy", "from_arrow",
    "from_pandas", "from_huggingface", "from_torch",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files", "read_images", "read_numpy", "read_tfrecords",
    "read_webdataset", "read_sql", "read_mongo", "read_bigquery",
    "DevicePrefetcher", "TorchFeed", "device_prefetching", "torch_feed",
]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("data")
del _rlu
