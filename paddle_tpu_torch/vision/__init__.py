"""``paddle.vision`` of the port (counterpart of
``paddle_tpu/vision/__init__.py``): datasets, transforms and models.
``vision/ops.py`` (nms, roi_align, deformable conv, yolo_box) is not
ported yet (ROADMAP Queue 1 item 12)."""
from . import datasets, models, transforms
from .models import LeNet, ResNet, resnet18, resnet34, resnet50

__all__ = ["datasets", "models", "transforms", "LeNet", "ResNet",
           "resnet18", "resnet34", "resnet50"]
