"""Vision models of the port (``paddle_tpu.vision.models``' names):
ResNet, VGG, MobileNet v1 / v2 and LeNet."""
from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = [
    "ResNet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "VGG", "vgg11", "vgg13", "vgg16", "vgg19",
    "MobileNetV1", "mobilenet_v1", "MobileNetV2", "mobilenet_v2",
    "LeNet", "BasicBlock", "BottleneckBlock",
]
