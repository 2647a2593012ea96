"""``mx.io.io``: the iterator classes under the inner module's name, as
the JAX package re-exports them."""
from . import (  # noqa: F401
    CSVIter,
    DataBatch,
    DataDesc,
    DataIter,
    LibSVMIter,
    MNISTIter,
    NDArrayIter,
    PrefetchingIter,
    ResizeIter,
)

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "LibSVMIter", "MNISTIter", "ResizeIter", "PrefetchingIter"]
