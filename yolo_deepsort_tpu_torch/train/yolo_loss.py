"""YOLO training loss in torch, fixed-shape masked targets (port of
yolo_deepsort_tpu/train/yolo_loss.py; oracle: specs/yolo_loss_np.py).

Targets are (MAX_TARGETS, 6) rows [batch_idx, class, cx, cy, w, h]
(normalized boxes) with a validity mask: the reference's variable-length
target list becomes scatters of a fixed shape. The reference drops padded
rows by writing them out of bounds (``mode="drop"``); torch's
``index_put_`` raises there, so every scatter here writes into a buffer one
cell longer than the (B, A, G, G) grid and sends what the reference drops
-- padded rows, rows whose batch index or class lies outside the grid --
to that last cell, which is cut off afterwards. No boolean-mask indexing:
nothing here waits for the device.

Two targets in one (batch, anchor, cell) write the same cell twice. XLA
does not say which write wins; the oracle's numpy assignment keeps the
last. The rule here is the oracle's: the LAST valid target in row order
sets the cell's box targets (tx, ty, tw, th and CIoU's tgw, tgh); the
object mask and the class targets take every target (the class vector gets
a 1 at each target's class).

Over a training mesh (``parallel/mesh.py``) each rank holds its dp shard
of the batch, and every masked mean takes the GLOBAL count of its cells
(all-reduced over the dp group, no gradient) under this rank's own
numerator: the ranks' terms sum to the reference's global masked means,
and each rank backpropagates its share.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..parallel.collectives import all_reduce_sum

OBJ_SCALE = 1.0
NOOBJ_SCALE = 100.0


def _bce(pred, tgt, eps=1e-12):
    pred = pred.clamp(eps, 1 - eps)
    return -(tgt * torch.log(pred) + (1 - tgt) * torch.log(1 - pred))


def _masked_mean(values, mask, n=None):
    """sum(values * mask) / n, 0 where n is 0; ``n`` None: mask.sum()."""
    s = (values * mask).sum()
    if n is None:
        n = mask.sum()
    return torch.where(n > 0, s / n.clamp(min=1), torch.zeros_like(s))


def _scatter(n_cells: int, index, values, fill=0.0):
    """(n_cells,) ``fill`` with ``values`` written at ``index``; index
    ``n_cells`` is the dump cell, cut off."""
    buf = torch.full((n_cells + 1,), fill, dtype=values.dtype,
                     device=values.device)
    return buf.index_put_((index,), values)[:n_cells]


def yolo_head_loss(raw_nhwc: torch.Tensor, targets: torch.Tensor,
                   target_mask: torch.Tensor,
                   anchors_px: Sequence[Tuple[float, float]],
                   num_classes: int, img_dim: int,
                   ignore_thres: float = 0.5, box_loss: str = "mse",
                   mesh=None):
    """Loss of one head: ``raw_nhwc`` (B, G, G, A*(5+C)) raw map, targets
    (T, 6), target_mask (T,) bool. Returns (total, {term: value}). With a
    training ``mesh``, this rank's share: its numerators over the dp
    group's global counts."""
    nB, g, _, _ = raw_nhwc.shape
    nA, nC = len(anchors_px), num_classes
    dev = raw_nhwc.device
    stride = img_dim / g
    pred = raw_nhwc.reshape(nB, g, g, nA, 5 + nC).permute(0, 3, 1, 2, 4)

    x = torch.sigmoid(pred[..., 0])
    y = torch.sigmoid(pred[..., 1])
    w = pred[..., 2]
    h = pred[..., 3]
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])

    anchors_g = torch.tensor(anchors_px, dtype=torch.float32,
                             device=dev) / stride  # (A, 2)

    # ---- build_targets, fixed shape
    targets = targets.float()
    tb = targets[:, 0].long()
    tlab = targets[:, 1].long()
    gxy = targets[:, 2:4] * g
    gwh = targets[:, 4:6] * g
    gi = gxy[:, 0].long().clamp(0, g - 1)
    gj = gxy[:, 1].long().clamp(0, g - 1)

    # anchor-wh IoU: (A, T)
    inter = (torch.minimum(anchors_g[:, 0:1], gwh[None, :, 0])
             * torch.minimum(anchors_g[:, 1:2], gwh[None, :, 1]))
    union = (anchors_g[:, 0:1] * anchors_g[:, 1:2]
             + gwh[None, :, 0] * gwh[None, :, 1] - inter)
    ious = inter / (union + 1e-16)
    best_n = torch.argmax(ious, dim=0)  # (T,), the first of equal IoUs

    n_cells = nB * nA * g * g
    shape4 = (nB, nA, g, g)
    valid = target_mask & (tb >= 0) & (tb < nB)
    cell_of = ((tb.clamp(0, nB - 1) * nA + best_n) * g + gj) * g + gi
    cell = torch.where(valid, cell_of, n_cells)
    # the oracle's rule for a cell two targets share: the later one wins
    t = cell.shape[0]
    order = torch.arange(t, device=dev)
    later = ((cell[None, :] == cell[:, None]) & valid[None, :]
             & (order[None, :] > order[:, None])).any(1)
    box_cell = torch.where(valid & ~later, cell, n_cells)

    obj_mask = _scatter(n_cells, cell, torch.ones_like(valid),
                        False).reshape(shape4)
    # ignore non-best anchors with IoU > thres for the noobj loss
    over = (ious > ignore_thres) & valid[None, :]  # (A, T)
    a_idx = torch.arange(nA, device=dev)[:, None]
    over_cell = torch.where(
        over, ((tb.clamp(0, nB - 1)[None, :] * nA + a_idx) * g
               + gj[None, :]) * g + gi[None, :], n_cells)
    noobj_mask = _scatter(
        n_cells, torch.cat([cell, over_cell.reshape(-1)]),
        torch.zeros(cell.shape[0] + over_cell.numel(), dtype=torch.bool,
                    device=dev), True).reshape(shape4)

    def scatter(vals):
        return _scatter(n_cells, box_cell, vals.float()).reshape(shape4)

    tx = scatter(gxy[:, 0] - torch.floor(gxy[:, 0]))
    ty = scatter(gxy[:, 1] - torch.floor(gxy[:, 1]))
    tw = scatter(torch.log(gwh[:, 0] / anchors_g[best_n, 0] + 1e-16))
    th = scatter(torch.log(gwh[:, 1] / anchors_g[best_n, 1] + 1e-16))
    lab_ok = (tlab >= 0) & (tlab < nC)
    cls_cell = torch.where(lab_ok, cell, n_cells)
    tcls = torch.zeros((n_cells + 1, nC), dtype=torch.float32, device=dev)
    tcls = tcls.index_put_((cls_cell, torch.where(lab_ok, tlab, 0)),
                           torch.ones_like(gxy[:, 0]))[:n_cells]
    tcls = tcls.reshape(shape4 + (nC,))
    tconf = obj_mask.float()

    obj_f = obj_mask.float()
    noobj_f = noobj_mask.float()
    n_obj = n_noobj = None
    if mesh is not None:
        n_obj, n_noobj = all_reduce_sum(
            torch.stack([obj_f.sum(), noobj_f.sum()]), mesh.dp_group)
    if box_loss == "ciou":
        # YOLOv4's Complete-IoU box regression (Zheng et al. 2020): IoU
        # term + normalized centre distance + aspect-consistency penalty
        tgw = scatter(gwh[:, 0])
        tgh = scatter(gwh[:, 1])
        # clip raw wh logits: non-obj cells still flow through the masked
        # mean multiplied by 0, and exp overflow there would give inf*0=nan
        pw = anchors_g[None, :, None, None, 0] * torch.exp(w.clamp(-20, 20))
        ph = anchors_g[None, :, None, None, 1] * torch.exp(h.clamp(-20, 20))
        eps = 1e-9
        # same-cell origin: centre offsets compare directly (grid units)
        inter_w = (torch.minimum(x + pw / 2, tx + tgw / 2)
                   - torch.maximum(x - pw / 2, tx - tgw / 2)).clamp(min=0.0)
        inter_h = (torch.minimum(y + ph / 2, ty + tgh / 2)
                   - torch.maximum(y - ph / 2, ty - tgh / 2)).clamp(min=0.0)
        inter = inter_w * inter_h
        union = pw * ph + tgw * tgh - inter + eps
        iou_b = inter / union
        rho2 = (x - tx) ** 2 + (y - ty) ** 2
        cw = (torch.maximum(x + pw / 2, tx + tgw / 2)
              - torch.minimum(x - pw / 2, tx - tgw / 2))
        chh = (torch.maximum(y + ph / 2, ty + tgh / 2)
               - torch.minimum(y - ph / 2, ty - tgh / 2))
        c2 = cw ** 2 + chh ** 2 + eps
        vv = (4.0 / math.pi ** 2) * (
            torch.atan(tgw / (tgh + eps)) - torch.atan(pw / (ph + eps))) ** 2
        alpha = (vv / (1.0 - iou_b + vv + eps)).detach()  # stop_gradient
        ciou = iou_b - rho2 / c2 - alpha * vv
        loss_box = _masked_mean(1.0 - ciou, obj_f, n_obj)
        loss_x = loss_y = loss_w = loss_h = loss_box / 4.0  # metric split
    elif box_loss == "mse":
        loss_x = _masked_mean((x - tx) ** 2, obj_f, n_obj)
        loss_y = _masked_mean((y - ty) ** 2, obj_f, n_obj)
        loss_w = _masked_mean((w - tw) ** 2, obj_f, n_obj)
        loss_h = _masked_mean((h - th) ** 2, obj_f, n_obj)
    else:
        raise ValueError(f"unknown box loss {box_loss!r}")
    bce_conf = _bce(conf, tconf)
    loss_conf_obj = _masked_mean(bce_conf, obj_f, n_obj)
    loss_conf_noobj = _masked_mean(bce_conf, noobj_f, n_noobj)
    # reference: BCE over the class vector averaged over obj cells and classes
    loss_cls = _masked_mean(_bce(cls, tcls).mean(-1), obj_f, n_obj)
    loss_conf = OBJ_SCALE * loss_conf_obj + NOOBJ_SCALE * loss_conf_noobj
    total = loss_x + loss_y + loss_w + loss_h + loss_conf + loss_cls
    metrics = {"loss_x": loss_x, "loss_y": loss_y, "loss_w": loss_w,
               "loss_h": loss_h, "loss_conf": loss_conf, "loss_cls": loss_cls}
    return total, metrics


def yolo_loss(plan, raw_maps, targets, target_mask, ignore_thres: float = 0.5,
              box_loss: str = "mse", mesh=None):
    """Total loss over the heads of a network plan (the sum of the heads'
    losses). ``raw_maps``: the NHWC head maps of ``make_forward_train``.
    ``box_loss``: "mse" (the reference lineage) or "ciou" (the yolov4
    paper's box regression). ``mesh``: a training mesh, whose dp ranks'
    counts every masked mean takes (``yolo_head_loss``)."""
    total = 0.0
    metrics = {}
    for spec, raw in zip(plan.heads, raw_maps):
        t, m = yolo_head_loss(raw, targets, target_mask, spec.anchors,
                              spec.num_classes, plan.img_size, ignore_thres,
                              box_loss=box_loss, mesh=mesh)
        total = total + t
        for k, v in m.items():
            metrics[k] = metrics.get(k, 0.0) + v
    return total, metrics
