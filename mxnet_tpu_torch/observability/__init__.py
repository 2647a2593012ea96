"""Observability of the port (counterpart of mxnet_tpu/observability):
request traces and the SLO plane of the serving tier (reqtrace.py). The
flight recorder, postmortem bundles and the ops server are not ported
yet."""
from . import reqtrace  # noqa: F401


def reset():
    """Test hygiene: drop the request traces, batch links and SLO state
    (reqtrace.reset)."""
    reqtrace.reset()


__all__ = ["reqtrace", "reset"]
