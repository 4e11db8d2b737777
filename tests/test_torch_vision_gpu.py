"""The port's vision path on the card, held against the same path on the
CPU. Every test here needs a CUDA device and skips itself without one.
The file imports neither ``jax`` nor ``paddle_tpu``:

    python -m pytest --noconftest -q tests/test_torch_vision_gpu.py

One float32 ``TrainStep`` (TF32 off) of LeNet, ResNet-18 and ResNet-50
from the same weights and batch on the card and on the CPU, anchored on
a float64 run of the step on the CPU (``chip_smoke.vision_card_vs_cpu``):
the loss, the gradients of the stem conv, the head and a batch norm's
weight, and the running statistics; the card's float32 error against
float64 is at most ``chip_smoke.VISION_CARD_CPU['factor']`` times the
CPU's plus its ``floor`` (cuDNN's and the CPU's convolutions sum in
other orders; ResNet-50's stem gradients carry ~2e-2 of float32 error on
the CPU itself). Under AMP O1 the convolutions run in bfloat16 and the
batch norms in float32, their running statistics staying float32.
"""
import pytest
import torch

from chip_smoke import vision_card_vs_cpu, vision_held
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn import BatchNorm2D, Conv2D
from paddle_tpu_torch.vision import models


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card against the CPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,classes", [
    ("lenet", (8, 1, 28, 28), 10),
    ("resnet18", (4, 3, 64, 64), 10),
    ("resnet50", (4, 3, 64, 64), 1000),
])
def test_train_step_on_the_card_matches_the_cpu(cuda, name, shape, classes):
    r = vision_card_vs_cpu(torch, name, shape, classes, seed=5)
    assert not vision_held(r), r


@pytest.mark.gpu
def test_o1_runs_convolutions_in_bf16_and_batch_norm_in_float32(cuda):
    model = models.resnet18(num_classes=10, device="cuda")
    seen = {Conv2D: set(), BatchNorm2D: set()}
    for m in model.modules():
        if type(m) in seen:
            m.register_forward_hook(
                lambda m, i, o: seen[type(m)].add((i[0].dtype, o.dtype)))
    x = torch.randn(2, 3, 64, 64, device="cuda")
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = model(x)
    out.float().sum().backward()
    assert {o for _, o in seen[Conv2D]} == {torch.bfloat16}
    assert seen[BatchNorm2D] == {(torch.bfloat16, torch.float32)}
    assert model.conv1.weight.grad.dtype == torch.float32
    assert all(b.dtype == torch.float32 for b in model.buffers())
