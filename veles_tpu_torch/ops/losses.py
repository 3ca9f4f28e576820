"""Evaluator math: the masked softmax cross-entropy, the confusion
matrix and the masked MSE.

The port of ``veles_tpu/ops/losses.py``. ``mask`` zeroes the padded rows
of a short final minibatch (minibatches keep a static shape); ``valid``
is passed in, so the loss is divided by the count of real rows.
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


def masked_mse(output, target, mask, valid):
    """Masked MSE: returns (err_output, loss_sum, max_err); ``loss_sum`` is
    unnormalized, as in :func:`masked_softmax_xent`."""
    diff = (output - target) * mask.reshape(
        (-1,) + (1,) * (output.ndim - 1))
    loss_sum = (diff.reshape(diff.shape[0], -1) ** 2).sum()
    err = diff * (2.0 / valid)
    return err, loss_sum, diff.abs().max()


def mse(output, target):
    """Returns (err_output, loss, max_err): the Znicz EvaluatorMSE
    contract."""
    batch = output.shape[0]
    mask = torch.ones(batch, dtype=output.dtype, device=output.device)
    err, loss_sum, max_err = masked_mse(output, target, mask, float(batch))
    return err, loss_sum / batch, max_err
