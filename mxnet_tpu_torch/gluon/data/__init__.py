"""The input pipeline (counterpart of mxnet_tpu/gluon/data)."""
from . import batchify, vision  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from .dataset import (  # noqa: F401
    ArrayDataset,
    Dataset,
    RecordFileDataset,
    SimpleDataset,
)
from .sampler import (  # noqa: F401
    BatchSampler,
    FilterSampler,
    IntervalSampler,
    RandomSampler,
    Sampler,
    SequentialSampler,
)
