"""Loss functions (counterpart of ``paddle_tpu/nn/functional/loss.py``):
every loss of the reference but ``ctc_loss``, ``rnnt_loss``,
``hsigmoid_loss`` and ``margin_cross_entropy``, each under the
reference's op name for AMP O1 (:func:`paddle_tpu_torch.amp.cast_inputs`;
``cross_entropy`` is black, so its logits come back to float32).

``cross_entropy`` keeps the reference's rules: integer labels with
``ignore_index`` (those rows count 0 and leave the mean's denominator),
soft labels (``soft_label``, or float labels of the logits' shape),
``weight`` per class (the mean is then over the weights of the counted
rows), ``axis``, ``use_softmax=False`` (the input is probabilities) and
``label_smoothing``; ``reduction="none"`` gives one loss a row."""
from __future__ import annotations

import math

import torch

from ... import amp as _amp
from .common import pairwise_distance

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss",
    "smooth_l1_loss", "nll_loss", "kl_div", "margin_ranking_loss",
    "cosine_similarity", "cosine_embedding_loss", "label_smooth",
    "sigmoid_focal_loss", "hinge_embedding_loss", "triplet_margin_loss",
    "soft_margin_loss", "square_error_cost", "log_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "dice_loss",
    "triplet_margin_with_distance_loss", "gaussian_nll_loss",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _one_hot(lab, n, ax, dtype):
    """One-hot of ``lab`` along axis ``ax`` of the result (out-of-range
    ids give zeros)."""
    shape = [1] * (lab.dim() + 1)
    shape[ax] = n
    classes = torch.arange(n, device=lab.device).reshape(shape)
    return (lab.unsqueeze(ax) == classes).to(dtype)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    input, label = _amp.cast_inputs("cross_entropy", input, label)
    ax = int(axis) % input.dim()
    logp = torch.log_softmax(input, dim=ax) if use_softmax \
        else torch.log(torch.clamp(input, min=1e-30))
    if soft_label or (label.dim() == input.dim()
                      and label.shape[ax] == input.shape[ax]
                      and label.is_floating_point()):
        tgt = label
        if label_smoothing:
            n = input.shape[ax]
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n
        loss = -(tgt * logp).sum(dim=ax)
        if weight is not None:
            w = weight.reshape([-1 if i == ax else 1
                                for i in range(input.dim())])
            loss = loss * (tgt * w).sum(dim=ax)
        return _reduce(loss, reduction)
    lab = label.long()
    if lab.dim() == input.dim():
        lab = lab.squeeze(ax)
    valid = lab != ignore_index
    if label_smoothing:
        n = input.shape[ax]
        tgt = _one_hot(lab, n, ax, logp.dtype) * (1 - label_smoothing) \
            + label_smoothing / n
        loss = -(tgt * logp).sum(dim=ax)
    else:
        safe = torch.where(valid, lab, 0)
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        sample_w = weight[torch.where(valid, lab, 0)] * valid.to(loss.dtype)
        if reduction == "mean":
            return (loss * sample_w).sum() / torch.clamp(sample_w.sum(),
                                                         min=1e-12)
        return _reduce(loss * sample_w, reduction)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)[..., None]
    if return_softmax:
        from .activation import softmax
        return loss, softmax(logits, axis=axis)
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = _amp.cast_inputs("bce", input, label, weight)
    out = -(label * torch.log(torch.clamp(input, min=1e-12))
            + (1 - label) * torch.log(torch.clamp(1 - input, min=1e-12)))
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``max(z, 0) - z y + log(1 + exp(-|z|))``, times ``(pos_weight - 1)
    y + 1`` and ``weight`` where given."""
    logit, label, weight = _amp.cast_inputs("bce_logits", logit, label,
                                            weight)
    base = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    if pos_weight is not None:
        base = base * ((pos_weight - 1) * label + 1)
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = _amp.cast_inputs("mse_loss", input, label)
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = _amp.cast_inputs("l1_loss", input, label)
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = _amp.cast_inputs("smooth_l1", input, label)
    d = (input - label).abs()
    out = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(out, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``[N, C, ...]`` (the
    class axis 1) at integer labels, ``ignore_index`` as
    :func:`cross_entropy`'s."""
    input, label = _amp.cast_inputs("nll_loss", input, label)
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    loss = torch.where(valid, loss, 0.0)
    if weight is not None:
        sw = weight[safe] * valid.to(loss.dtype)
        if reduction == "mean":
            return (loss * sw).sum() / torch.clamp(sw.sum(), min=1e-12)
        loss = loss * sw
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    input, label = _amp.cast_inputs("kl_div", input, label)
    if log_target:
        out = torch.exp(label) * (label - input)
    else:
        out = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = _amp.cast_inputs("margin_ranking", input, other,
                                           label)
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    x1, x2 = _amp.cast_inputs("cosine_similarity", x1, x2)
    ax = int(axis)
    num = (x1 * x2).sum(dim=ax)
    den = torch.sqrt((x1 * x1).sum(dim=ax)) * torch.sqrt((x2 * x2).sum(dim=ax))
    return num / torch.clamp(den, min=eps)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    input1, input2, label = _amp.cast_inputs("cosine_embedding", input1,
                                             input2, label)
    sim = (input1 * input2).sum(-1) / torch.clamp(
        input1.norm(dim=-1) * input2.norm(dim=-1), min=1e-12)
    out = torch.where(label == 1, 1 - sim, torch.clamp(sim - margin,
                                                       min=0.0))
    return _reduce(out, reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    label, = _amp.cast_inputs("label_smooth", label)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label, normalizer = _amp.cast_inputs("focal", logit, label,
                                                normalizer)
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = _amp.cast_inputs("hinge_embedding", input, label)
    out = torch.where(label == 1, input, torch.clamp(margin - input,
                                                     min=0.0))
    return _reduce(out, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    input, positive, negative = _amp.cast_inputs("triplet", input, positive,
                                                 negative)

    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(-1) ** (1.0 / p)
    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    return _reduce(torch.clamp(d_ap - d_an + margin, min=0.0), reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    input, label = _amp.cast_inputs("soft_margin", input, label)
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def square_error_cost(input, label):
    input, label = _amp.cast_inputs("square_error_cost", input, label)
    return (input - label) ** 2


def log_loss(input, label, epsilon=1e-4, name=None):
    input, label = _amp.cast_inputs("log_loss", input, label)
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    input, label = _amp.cast_inputs("poisson_nll", input, label)
    if log_input:
        out = torch.exp(input) - label * input
    else:
        out = input - label * torch.log(input + epsilon)
    if full:
        y1 = torch.clamp(label, min=1.0)
        stirling = label * torch.log(y1) - label \
            + 0.5 * torch.log(2 * math.pi * y1)
        out = out + torch.where(label > 1, stirling, 0.0)
    return _reduce(out, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    input, label, weight = _amp.cast_inputs("ml_soft_margin", input, label,
                                            weight)
    out = -(label * torch.nn.functional.logsigmoid(input)
            + (1 - label) * torch.nn.functional.logsigmoid(-input))
    out = out.mean(dim=-1)
    if weight is not None:
        out = out * weight
    return _reduce(out, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - (2 |p . y| + eps) / (|p| + |y| + eps)`` a sample, meaned;
    ``label [..., 1]`` holds class ids."""
    input, label = _amp.cast_inputs("dice", input, label)
    yoh = _one_hot(label.squeeze(-1).long(), input.shape[-1], -1,
                   input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * yoh).sum(dim=dims)
    union = input.sum(dim=dims) + yoh.sum(dim=dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """The triplet loss under a distance callable (pairwise L2 by
    default)."""
    dist = distance_function or pairwise_distance
    d_ap, d_an = dist(input, positive), dist(input, negative)
    if swap:
        d_an = torch.minimum(d_an, dist(positive, negative))
    d_ap, d_an = _amp.cast_inputs("triplet_with_distance", d_ap, d_an)
    return _reduce(torch.clamp(d_ap - d_an + margin, min=0.0), reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    """``0.5 (log var + (x - mu)^2 / var)`` (var at least ``epsilon``),
    plus ``0.5 log 2 pi`` when ``full``."""
    input, label, variance = _amp.cast_inputs("gaussian_nll", input, label,
                                              variance)
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce(loss, reduction)
