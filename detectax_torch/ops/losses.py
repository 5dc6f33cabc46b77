"""Detection loss library — one numerically stable copy of each loss.

Port of `detectax/ops/losses.py`, plain tensor ops: every loss accumulates
in float32 whatever the input type and is differentiable by autograd.

The focal formulation is the parity-sensitive one: the stable binary
cross-entropy is decomposed as ``-log σ(x) = log(1+e^{-|x|}) - min(x,0)``
and ``-log(1-σ(x)) = log(1+e^{-|x|}) + max(x,0)`` before the focal
weighting, with `log1p` for the log term.

``alpha``, ``gamma`` and ``weights`` are keyword-only in the port: the JAX
package's two focal functions disagree on their third positional argument.
On a CUDA tensor the training path uses the hand-written kernel
(`detectax_torch.kernels.focal.focal_loss`) for the focal loss; the
`focal_loss` here is its plain version.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _stable_bce_terms(logits: torch.Tensor):
    """Return (-log σ(x), -log(1-σ(x))) computed stably."""
    log1p_term = torch.log1p(torch.exp(-torch.abs(logits)))
    # torch.minimum / maximum against a zero tensor, NOT clamp: at x == 0
    # they split the derivative (0.5, as jnp.minimum does, and as the true
    # derivative of softplus is), where clamp passes all of it (1.0)
    zero = logits.new_zeros(())
    pos_ce = log1p_term - torch.minimum(logits, zero)  # -log sigmoid(x)
    neg_ce = log1p_term + torch.maximum(logits, zero)  # -log(1-sigmoid(x))
    return pos_ce, neg_ce


def focal_loss(
    labels: torch.Tensor,
    logits: torch.Tensor,
    *,
    alpha: float = 0.25,
    gamma: float = 2.0,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum-reduced sigmoid focal loss, stable formulation (α=0.25, γ=2 by
    default, sum over all elements). `weights` (broadcastable to
    `logits.shape`) masks cells."""
    labels = labels.to(torch.float32)
    logits = logits.to(torch.float32)
    pos_ce, neg_ce = _stable_bce_terms(logits)
    # torch.sigmoid, NOT 1/(1+exp(-x)): the naive form's derivative is
    # 0*inf = NaN once a background logit drifts below ~-88 (exp
    # overflow), which from-scratch training reliably reaches.
    p = torch.sigmoid(logits)
    loss = (
        labels * alpha * torch.pow(1.0 - p, gamma) * pos_ce
        + (1.0 - labels) * (1.0 - alpha) * torch.pow(p, gamma) * neg_ce
    )
    if weights is not None:
        loss = loss * weights
    return loss.sum()


def sigmoid_bce_loss(
    labels: torch.Tensor,
    logits: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum-reduced stable sigmoid cross-entropy."""
    labels = labels.to(torch.float32)
    logits = logits.to(torch.float32)
    pos_ce, neg_ce = _stable_bce_terms(logits)
    loss = labels * pos_ce + (1.0 - labels) * neg_ce
    if weights is not None:
        loss = loss * weights
    return loss.sum()


def smooth_l1_loss(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    mask: torch.Tensor | float = 1.0,
    delta: float = 1.0,
) -> torch.Tensor:
    """Sum-reduced smooth-L1 (Huber-like) with a per-cell mask: the mask
    broadcasts over the last (coordinate) axis; elementwise ``0.5 d^2``
    below `delta`, ``|d|`` above."""
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32)
    diff = torch.abs(y_true - y_pred)
    loss = torch.where(diff < delta, 0.5 * diff * diff, diff)
    if isinstance(mask, torch.Tensor):
        mask = mask.to(torch.float32)
        if mask.ndim > 0:
            mask = mask[..., None]
    return (loss * mask).sum()


def iou_loss(
    ltrb_true: torch.Tensor,
    ltrb_pred: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Sum-reduced -log(IoU) over per-cell (t,b,l,r) stride-unit grids.

    Both boxes are reconstructed around a shared cell centre, so the
    intersection extents are the minima of the distances on each side;
    intersection / union with 1e-12 epsilons, masked sum of -log IoU.
    Channel layout: (t, b, l, r) = distances to (y_low, y_upp, x_low,
    x_upp)."""
    ltrb_true = ltrb_true.to(torch.float32)
    ltrb_pred = ltrb_pred.to(torch.float32)
    t_t, t_b, t_l, t_r = ltrb_true[..., :4].unbind(-1)
    p_t, p_b, p_l, p_r = ltrb_pred[..., :4].unbind(-1)

    true_h = t_t + t_b
    true_w = t_l + t_r
    pred_h = p_t + p_b
    pred_w = p_l + p_r

    zero = ltrb_pred.new_zeros(())  # maximum, not clamp: see above
    inter_h = torch.maximum(
        torch.minimum(t_t, p_t) + torch.minimum(t_b, p_b), zero)
    inter_w = torch.maximum(
        torch.minimum(t_l, p_l) + torch.minimum(t_r, p_r), zero)

    inter = inter_h * inter_w
    union = true_h * true_w + pred_h * pred_w - inter
    iou = inter / (union + EPS)
    return (-torch.log(iou + EPS) * mask).sum()


def centerness_from_ltrb(ltrb: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """FCOS centerness: sqrt of the min/max side-ratio product — the ratio
    over channels (0,1) times the ratio over channels (2,3),
    epsilon-regularized."""
    a = torch.minimum(ltrb[..., 0], ltrb[..., 1]) + eps
    b = torch.maximum(ltrb[..., 0], ltrb[..., 1]) + eps
    c = torch.minimum(ltrb[..., 2], ltrb[..., 3]) + eps
    d = torch.maximum(ltrb[..., 2], ltrb[..., 3]) + eps
    return torch.sqrt((a / b) * (c / d))
