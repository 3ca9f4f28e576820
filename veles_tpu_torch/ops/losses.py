"""Evaluator math: the masked softmax cross-entropy and the confusion
matrix.

The port of ``veles_tpu/ops/losses.py`` as far as the softmax training
path needs it. ``mask`` zeroes the padded rows of a short final minibatch
(minibatches keep a static shape); ``valid`` is passed in, so the loss is
divided by the count of real rows.
"""

import torch


def masked_softmax_xent(logits, labels, mask, valid):
    """Fused masked softmax cross-entropy.

    Returns ``(err, loss_sum, n_err, pred)`` where ``err`` is
    d(sum xent / valid)/d(logits) = (softmax - onehot)·mask/valid and
    ``loss_sum`` is the *unnormalized* masked xent sum."""
    n_classes = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).to(
        logits.dtype)
    logp = logits - logits.amax(dim=-1, keepdim=True)
    logp = logp - torch.log(torch.exp(logp).sum(dim=-1, keepdim=True))
    loss_sum = -((onehot * logp).sum(dim=-1) * mask).sum()
    err = (torch.exp(logp) - onehot) * (mask / valid)[:, None]
    pred = logits.argmax(dim=-1)
    n_err = ((pred != labels) & (mask > 0)).sum(dtype=torch.int32)
    return err, loss_sum, n_err, pred


def confusion_matrix(logits, labels, n_classes, mask=None):
    """Dense confusion-matrix increment, rows = label, cols = prediction
    (Znicz evaluator option)."""
    pred = logits.argmax(dim=-1)
    idx = labels.long() * n_classes + pred
    weights = (torch.ones_like(idx, dtype=torch.int32) if mask is None
               else mask.to(torch.int32))
    flat = torch.zeros(n_classes * n_classes, dtype=torch.int32,
                       device=logits.device)
    flat.index_add_(0, idx, weights)
    return flat.reshape(n_classes, n_classes)
