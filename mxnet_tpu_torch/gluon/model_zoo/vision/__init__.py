"""Vision model zoo of the port (counterpart of
mxnet_tpu/gluon/model_zoo/vision): LeNet and the ResNet family so far.
Pretrained weights are not bundled; ``pretrained=True`` raises."""
from .lenet import LeNet, lenet
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "LeNet", "lenet", "ResNetV1", "ResNetV2", "SpaceToDepthStem",
           "get_model", "get_resnet", "resnet18_v1", "resnet18_v2", "resnet34_v1",
           "resnet34_v2", "resnet50_v1", "resnet50_v2", "resnet101_v1",
           "resnet101_v2", "resnet152_v1", "resnet152_v2"]

_MODELS = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for n in (18, 34, 50, 101, 152) for v in (1, 2)}
_MODELS["lenet"] = lenet


def get_model(name, **kwargs):
    """A model by name (model_zoo/vision/__init__.py:get_model): ``lenet``
    and ``resnet{18,34,50,101,152}_v{1,2}`` in the port."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(f"unknown model '{name}'; available in the port: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
