"""Vision model zoo of the port (counterpart of
mxnet_tpu/gluon/model_zoo/vision): AlexNet, DenseNet, Inception v3,
LeNet, MobileNet v1/v2, ResNet v1/v2, SqueezeNet and VGG, with the JAX
package's ``collect_params()`` names and shapes. Pretrained weights are
not bundled; ``pretrained=True`` raises."""
from .alexnet import AlexNet, alexnet
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .lenet import LeNet, lenet
from .mobilenet import (LinearBottleneck, MobileNet, MobileNetV2,
                        get_mobilenet, get_mobilenet_v2, mobilenet0_25,
                        mobilenet0_5, mobilenet0_75, mobilenet1_0,
                        mobilenet_v2_0_25, mobilenet_v2_0_5,
                        mobilenet_v2_0_75, mobilenet_v2_1_0)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import (VGG, get_vgg, vgg11, vgg11_bn, vgg13, vgg13_bn, vgg16,
                  vgg16_bn, vgg19, vgg19_bn)

#: every constructor by name (model_zoo/vision/__init__.py:83)
_MODELS = {name: globals()[name] for name in [
    "alexnet", "densenet121", "densenet161", "densenet169", "densenet201",
    "inception_v3", "lenet", "mobilenet0_25", "mobilenet0_5",
    "mobilenet0_75", "mobilenet1_0", "mobilenet_v2_0_25", "mobilenet_v2_0_5",
    "mobilenet_v2_0_75", "mobilenet_v2_1_0", "resnet18_v1", "resnet34_v1",
    "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
    "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
    "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg11_bn", "vgg13",
    "vgg13_bn", "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]}

__all__ = ["AlexNet", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
           "BottleneckV2", "DenseNet", "Inception3", "LeNet",
           "LinearBottleneck", "MobileNet", "MobileNetV2", "ResNetV1",
           "ResNetV2", "SpaceToDepthStem", "SqueezeNet", "VGG", "get_model",
           "get_mobilenet", "get_mobilenet_v2", "get_resnet", "get_vgg",
           *_MODELS]


def get_model(name, **kwargs):
    """A model by name (model_zoo/vision/__init__.py:get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            f"unknown model '{name}'; available: {sorted(_MODELS)}")
    return _MODELS[name](**kwargs)
