"""Diagnostics of the port (counterpart of mxnet_tpu/diagnostics): the
span tracer. The watchdog, postmortem and compile introspection of the JAX
package are not ported yet."""
from . import spans  # noqa: F401
from .spans import span  # noqa: F401

__all__ = ["spans", "span"]
