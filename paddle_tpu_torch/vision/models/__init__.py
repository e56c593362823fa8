"""Vision models of the port: the ResNet family."""
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]
