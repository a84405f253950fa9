"""Naive Bayes classifiers — closed-form, one pass of segment sums.

Counterpart of ``predictionio_tpu/ops/naive_bayes.py`` (reference analogues:
MLlib ``NaiveBayes``, the Classification template's option, and e2's
``CategoricalNaiveBayes``).  Both fits are count aggregations: per-class sums
by one ``index_add_`` over the class id on the device, no iterations.  The
fitted models are host arrays (the JAX package's dataclasses, field for
field); the ``*_scores`` functions take tensors on the model's serving
device and the ``*_predict`` functions stage their inputs to ``device``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclass
class GaussianNBModel:
    class_log_prior: np.ndarray  # [C]
    mean: np.ndarray             # [C, d]
    var: np.ndarray              # [C, d]


def _segment_sum(x: torch.Tensor, y: torch.Tensor, n_classes: int) -> torch.Tensor:
    out = torch.zeros((n_classes,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, y, x)


def _class_log_prior(counts: torch.Tensor) -> torch.Tensor:
    return torch.log(counts.clamp_min(1.0) / counts.sum().clamp_min(1.0))


def _stage(x, dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def gaussian_nb_train(x: np.ndarray, y: np.ndarray, n_classes: int, eps: float = 1e-6,
                      device=None) -> GaussianNBModel:
    """Per-class feature means and variances (+ ``eps``) and log priors,
    fitted on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    xt = _stage(x, torch.float32, dev)
    yt = _stage(y, torch.int64, dev)
    counts = _segment_sum(torch.ones(len(yt), dtype=torch.float32, device=dev), yt, n_classes)
    sums = _segment_sum(xt, yt, n_classes)
    sq = _segment_sum(xt * xt, yt, n_classes)
    denom = counts.clamp_min(1.0)[:, None]
    mean = sums / denom
    var = sq / denom - mean * mean + np.float32(eps)
    return GaussianNBModel(_class_log_prior(counts).cpu().numpy(), mean.cpu().numpy(),
                           var.cpu().numpy())


def gaussian_nb_scores(prior: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """[n, C] class log-likelihoods: the log prior plus log N(x | mean, var)
    summed over the features."""
    xb = x[:, None, :]   # [n, 1, d]
    ll = -0.5 * (torch.log(np.float32(2 * math.pi) * var) + (xb - mean) ** 2 / var)
    return prior + ll.sum(-1)


def gaussian_nb_predict(model: GaussianNBModel, x: np.ndarray, device=None) -> np.ndarray:
    dev = resolve_device(device)
    scores = gaussian_nb_scores(_stage(model.class_log_prior, torch.float32, dev),
                                _stage(model.mean, torch.float32, dev),
                                _stage(model.var, torch.float32, dev),
                                _stage(x, torch.float32, dev))
    return torch.argmax(scores, dim=-1).cpu().numpy()


@dataclass
class MultinomialNBModel:
    class_log_prior: np.ndarray   # [C]
    feature_log_prob: np.ndarray  # [C, d]


def multinomial_nb_train(x: np.ndarray, y: np.ndarray, n_classes: int, alpha: float = 1.0,
                         device=None) -> MultinomialNBModel:
    """x holds non-negative counts (e.g. token counts / tf-idf); Laplace
    smoothing ``alpha``; fitted on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    xt = _stage(x, torch.float32, dev)
    yt = _stage(y, torch.int64, dev)
    counts = _segment_sum(torch.ones(len(yt), dtype=torch.float32, device=dev), yt, n_classes)
    feat = _segment_sum(xt, yt, n_classes) + np.float32(alpha)
    log_prob = torch.log(feat) - torch.log(feat.sum(-1, keepdim=True))
    return MultinomialNBModel(_class_log_prior(counts).cpu().numpy(), log_prob.cpu().numpy())


def multinomial_nb_scores(prior: torch.Tensor, log_prob: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """[n, C] class scores: log prior + counts · log P(feature | class)."""
    return prior + x @ log_prob.T


def multinomial_nb_predict(model: MultinomialNBModel, x: np.ndarray, device=None) -> np.ndarray:
    dev = resolve_device(device)
    scores = multinomial_nb_scores(_stage(model.class_log_prior, torch.float32, dev),
                                   _stage(model.feature_log_prob, torch.float32, dev),
                                   _stage(x, torch.float32, dev))
    return torch.argmax(scores, dim=-1).cpu().numpy()
