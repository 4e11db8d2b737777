"""Activation recompute of the PyTorch port
(``paddle_tpu_torch.distributed.recompute``) on the CPU.

The models' recompute is held to the reference elsewhere, beside each
family's reference gradients: Llama at ``recompute_interval`` 1 and 2 in
``tests/test_torch_llama_training.py``, the MoE families in
``tests/test_torch_moe_models.py`` (loss and every gradient against the
reference's, the port's plain run's bit for bit).

Here, dropout under recompute: a segment that draws from the device's
default stream and from a ``Dropout``'s own generator gives, recomputed,
the plain run's output and gradients bit for bit, and leaves both
generators where the plain run left them; ``recompute_sequential`` does
the same by segments; the reference's keywords are taken.
"""
import pytest
import torch

from paddle_tpu_torch.distributed.recompute import (recompute,
                                                    recompute_sequential)
from paddle_tpu_torch.framework import random as prandom
from paddle_tpu_torch.nn import Dropout, Linear


class _Segment(torch.nn.Module):
    """Linear -> dropout on the default stream -> Linear -> a dropout
    with its own generator."""

    def __init__(self, gen):
        super().__init__()
        self.a = Linear(16, 32, device="cpu")
        self.drop = Dropout(0.3)
        self.b = Linear(32, 16, bias_attr=False, device="cpu")
        self.drop2 = Dropout(0.5, generator=gen)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape) * 0.3)

    def forward(self, x):
        return self.drop2(self.b(torch.relu(self.drop(self.a(x)))))


def _dropout_run(wrap, seed=11):
    prandom.seed(seed)
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(5)
    seg = _Segment(gen)
    x = torch.randn(4, 16, requires_grad=True)
    h = seg(x)                               # a draw before the segment
    y = wrap(seg, h)
    (y.square().sum() + seg(h).sum()).backward()  # and one after it
    stream = prandom.default_generator("cpu").get_state()
    return ([x.grad] + [p.grad for p in seg.parameters()], y.detach(),
            stream, gen.get_state())


@pytest.mark.parametrize("wrap", ["recompute", "recompute_sequential"])
def test_dropout_segment_recomputes_bitwise(wrap):
    fn = {"recompute": lambda seg, h: recompute(seg, h),
          "recompute_sequential": lambda seg, h: recompute_sequential(
              {"segments": 2}, [seg.a, seg.drop, torch.nn.ReLU(), seg.b,
                                seg.drop2], h)}[wrap]
    plain = _dropout_run(lambda seg, h: seg(h))
    got = _dropout_run(fn)
    assert torch.equal(got[1], plain[1])
    for a, b in zip(got[0], plain[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[2], plain[2]) and torch.equal(got[3], plain[3])


def test_recompute_takes_the_reference_keywords():
    lin = Linear(8, 8, bias_attr=False, device="cpu")
    x = torch.randn(2, 8, requires_grad=True)
    y = recompute(lin, x, preserve_rng_state=False, use_reentrant=True)
    y.sum().backward()
    assert lin.weight.grad is not None and x.grad is not None
