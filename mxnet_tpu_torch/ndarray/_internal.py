"""``mx.nd._internal``: the registry's ops by name, ``_``-prefixed
spellings and the pure forms of the ops ``mx.nd`` hand-writes included
(counterpart of mxnet_tpu/ndarray/_internal.py): ``name``, else
``_name``, else ``_npi_name``, as an NDArray function."""
from ..ops.registry import _OPS
from .register import make_eager

_CACHE = {}


def __getattr__(name):
    if name in _CACHE:
        return _CACHE[name]
    for cand in (name, f"_{name}", f"_npi_{name}"):
        fn = _OPS.get(cand)
        if fn is not None:
            eager = _CACHE[name] = make_eager(cand, fn)
            return eager
    raise AttributeError(f"no registered internal op {name!r}")


def __dir__():
    return sorted(n for n in _OPS if n.startswith("_"))
