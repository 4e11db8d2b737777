"""The port's flash attention (``paddle_tpu_torch.ops.kernels.
flash_attention`` / ``ops.flash_attention``) against the JAX package on
the CPU.

On a CPU tensor the port runs the plain versions of K1f, K1dq and K1dkv;
here they face the reference's Pallas kernels run interpreted (as
``tests/test_flash_attention.py`` runs them), the forward directly and
the gradients through ``jax.vjp`` with the same seeded cotangent.
Float32 throughout. Tolerances: forward 1e-5 absolute, gradients 1e-4
absolute (the same sums taken in another order; the gradients add up
to a few hundred terms of order one).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops.pallas.flash_attention_kernel as fak
from paddle_tpu.models.llama import _apply_rope, _rope_tables
from paddle_tpu.ops.pallas.flash_attention import \
    flash_attention_core as jax_core
from paddle_tpu_torch.incubate.nn.functional import apply_rope
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.kernels import flash_attention as fa


@pytest.fixture
def interpret():
    prev = fak._FORCE_INTERPRET
    fak._FORCE_INTERPRET = True
    yield
    fak._FORCE_INTERPRET = prev


def _inputs(seed, b, l, h, hkv, d):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return mk(b, l, h, d), mk(b, l, hkv, d), mk(b, l, hkv, d), \
        mk(b, l, h, d)


def _port(q, k, v, do, causal, scale):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = fa.flash_attention(*leaves, scale, causal=causal)
    o.backward(torch.from_numpy(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("seq", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_kernels_match_interpreted_pallas(interpret, seq, rep,
                                                causal):
    h, d = 4, 64
    q, k, v, do = _inputs(seq + rep, 1, seq, h, h // rep, d)
    scale = 1.0 / np.sqrt(d)
    o, vjp = jax.vjp(lambda a, b, c: fak.pallas_flash_attention(
        a, b, c, causal=causal, sm_scale=scale), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port(q, k, v, do, causal, scale)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=name)


def test_lse_and_each_backward_pass_match_the_reference_split(interpret):
    """The plain forward's lse and the dq / dk-dv passes one by one
    against the reference's ``_fwd`` / ``_bwd`` (interpreted) at rep 2,
    causal, with lengths off the 64-row tile."""
    b, l, h, hkv, d = 2, 96, 4, 2, 64
    q, k, v, do = _inputs(3, b, l, h, hkv, d)
    scale = 0.11
    fold = lambda x: np.ascontiguousarray(  # noqa: E731
        x.transpose(0, 2, 1, 3).reshape(-1, l, d))
    o_r, lse_r = fak._fwd(jnp.asarray(fold(q)), jnp.asarray(fold(k)),
                          jnp.asarray(fold(v)), scale, True, l, l, h, hkv)
    dq_r, dk_r, dv_r = fak._bwd(
        scale, True, l, l, h, hkv,
        (jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)),
         o_r, lse_r), jnp.asarray(fold(do)))
    t = torch.from_numpy
    o, lse = fa.plain_flash_attention_fwd(t(q), t(k), t(v), scale, True)
    np.testing.assert_allclose(fold(o.numpy()), np.asarray(o_r), atol=1e-5)
    np.testing.assert_allclose(lse.numpy().reshape(-1, l),
                               np.asarray(lse_r)[:, 0], atol=1e-5)
    delta = (t(do) * o).sum(-1).transpose(1, 2).contiguous()
    args = (t(q), t(k), t(v), t(do), lse, delta, scale, True)
    np.testing.assert_allclose(fold(fa.flash_attention_dq(*args).numpy()),
                               np.asarray(dq_r), atol=1e-4)
    dk, dv = fa.flash_attention_dkv(*args)
    np.testing.assert_allclose(fold(dk.numpy()), np.asarray(dk_r),
                               atol=1e-4)
    np.testing.assert_allclose(fold(dv.numpy()), np.asarray(dv_r),
                               atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_core_matches_reference(causal):
    """``ops.flash_attention.flash_attention_core`` (GQA, explicit scale)
    against the reference's entry point (its XLA path off the TPU)."""
    q, k, v, _ = _inputs(9, 2, 40, 8, 2, 32)
    want = np.asarray(jax_core(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), is_causal=causal, scale=0.2))
    got = tfa.flash_attention_core(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), is_causal=causal,
                                   scale=0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    out, soft = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    assert soft is None and out.shape == q.shape


def test_bias_mask_and_dropout_raise():
    """Bias, mask and dropout are ported (``tests/test_torch_flashmask.py``
    holds them to the reference); what raises now is a bias whose head
    count does not divide H (the reference repeats a bias by H // heads,
    so a head count that divides H is taken, as a bias per kv head or per
    group of query heads). ``mask_to_bias`` turns a bool mask into
    0 / -1e9 in the asked dtype and passes a float mask through, and
    ``dropout_p`` does nothing under ``training=False``."""
    x = torch.randn(1, 4, 2, 64, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="3 heads"):
        tfa.flash_attention_core(x, x, x, bias=torch.zeros(1, 3, 4, 4))
    y = torch.randn(1, 4, 4, 64, generator=torch.Generator().manual_seed(1))
    bias = torch.randn(1, 2, 4, 4, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(
        tfa.flash_attention_core(y, y, y, bias=bias),
        tfa.flash_attention_core(y, y, y,
                                 bias=bias.repeat_interleave(2, dim=1)),
        rtol=0, atol=0)
    out = tfa.scaled_dot_product_attention(x, x, x, dropout_p=0.1,
                                           training=False)
    assert torch.equal(out, tfa.scaled_dot_product_attention(x, x, x))
    bias = tfa.mask_to_bias(torch.tensor([True, False]), torch.bfloat16)
    assert bias.dtype == torch.bfloat16
    assert bias.tolist() == [0.0, torch.tensor(-1e9).bfloat16().item()]
    f = torch.tensor([0.5, -2.0])
    assert tfa.mask_to_bias(f, torch.bfloat16) is f
    assert tfa.mask_to_bias(None, torch.float32) is None


def test_apply_rope_matches_reference():
    l, d = 24, 64
    cos, sin = _rope_tables(64, d, 500000.0)
    x = np.random.RandomState(2).randn(2, l, 3, d).astype(np.float32)
    want = np.asarray(_apply_rope(jnp.asarray(x), jnp.asarray(cos[:l]),
                                  jnp.asarray(sin[:l])))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(cos[:l]),
                     torch.from_numpy(sin[:l]))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
