"""``mx.nd.random``: the legacy spellings over ``mx.np.random`` (counterpart
of mxnet_tpu/ndarray/random.py): ``shape=`` for numpy's ``size=``, and
``out=`` takes the sample in place."""
from __future__ import annotations

__all__ = ["uniform", "normal", "randint"]


def _legacy(name, **renames):
    def sample(*args, shape=None, ctx=None, dtype=None, out=None, **kwargs):
        from ..numpy import random as _npr   # mx.np imports this package

        for old, new in renames.items():
            if old in kwargs:
                kwargs[new] = kwargs.pop(old)
        res = getattr(_npr, name)(*args, size=shape, dtype=dtype, ctx=ctx,
                                  **kwargs)
        if out is not None:
            out._assign(res._data)
            return out
        return res
    sample.__name__ = name
    return sample


uniform = _legacy("uniform")
normal = _legacy("normal", mu="loc", sigma="scale")
randint = _legacy("randint")
