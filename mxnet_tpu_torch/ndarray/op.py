"""``mx.nd.op``: every op of ``mx.nd`` under one flat namespace
(counterpart of mxnet_tpu/ndarray/op.py)."""


def __getattr__(name):
    from .. import ndarray as nd

    try:
        return getattr(nd, name)
    except AttributeError:
        raise AttributeError(f"mx.nd.op has no op {name!r}") from None


def __dir__():
    from .. import ndarray as nd

    return dir(nd)
