"""Serving tier of the port (counterpart of mxnet_tpu/serving).

    engine.py     InferenceEngine — assembler/completer pipeline with a
                  bounded in-flight window, bucket padding, one CUDA graph
                  per bucket rung on the card (warmup captures them),
                  deadline-aware bounded drain; mode="sync" keeps the
                  serialized loop as the A/B baseline
    scheduler.py  RequestScheduler — priority classes, strict-priority
                  dequeue, per-class token-bucket admission
    frontdoor.py  FrontDoor — N replicas behind one submit(),
                  least-loaded routing, health checks, failover on shed
    buckets.py    the batch-bucket ladder (the shape vocabulary)
    registry.py   ModelRegistry — multi-model process, replica sets,
                  REGISTRY default
    sim.py        SimulatedBlock — deterministic slow device for
                  pipeline and trace tests
    errors.py     Overloaded / RateLimited / RequestTimeout /
                  EngineStopped
"""
from .buckets import assemble_batch, bucket_ladder, pad_rows, pick_bucket
from .engine import InferenceEngine, ServeRequest, warm_and_seal
from .errors import (EngineStopped, Overloaded, RateLimited, RequestTimeout,
                     ServingError)
from .frontdoor import FrontDoor, OpsPlaneHealth
from .registry import REGISTRY, ModelRegistry
from .scheduler import (DEFAULT_CLASSES, RequestScheduler, ServeClass,
                        TokenBucket)
from .sim import SimulatedBlock

__all__ = ["InferenceEngine", "ServeRequest", "warm_and_seal",
           "RequestScheduler", "ServeClass", "TokenBucket",
           "DEFAULT_CLASSES", "FrontDoor", "OpsPlaneHealth",
           "ModelRegistry", "REGISTRY", "SimulatedBlock",
           "ServingError", "Overloaded", "RateLimited", "RequestTimeout",
           "EngineStopped", "bucket_ladder", "pick_bucket", "pad_rows",
           "assemble_batch"]
