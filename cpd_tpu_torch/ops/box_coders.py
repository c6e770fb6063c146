"""Box encode/decode coders (port of cpd_tpu/ops/box_coders.py).

Targets are (dx/diag, dy/diag, dz/dza, log ratios, heading residual or its
[cos, sin] component deltas, extra columns as plain deltas)."""
from __future__ import annotations

import torch


def _clamped_dims(boxes):
    return (torch.clamp(boxes[..., 3], min=1e-5), torch.clamp(boxes[..., 4], min=1e-5),
            torch.clamp(boxes[..., 5], min=1e-5))


class ResidualCoder:
    """Anchor-residual coder for (x, y, z, dx, dy, dz, heading[, extra])
    boxes: code size 7, one more with ``encode_angle_by_sincos``."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7 + C) -> (..., code_size) residual targets."""
        dxa, dya, dza = _clamped_dims(anchors)
        dxg, dyg, dzg = _clamped_dims(boxes)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        if self.encode_angle_by_sincos:
            # component residuals [cos, sin], not a rotation delta
            rt = [torch.cos(boxes[..., 6]) - torch.cos(anchors[..., 6]),
                  torch.sin(boxes[..., 6]) - torch.sin(anchors[..., 6])]
        else:
            rt = [boxes[..., 6] - anchors[..., 6]]
        rest = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.stack([(boxes[..., 0] - anchors[..., 0]) / diag,
                            (boxes[..., 1] - anchors[..., 1]) / diag,
                            (boxes[..., 2] - anchors[..., 2]) / dza,
                            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                            *rt, *rest], dim=-1)

    def decode(self, encodings, anchors):
        """encodings: (..., code_size), anchors: (..., 7 + C) -> (..., 7 + C)."""
        dxa, dya, dza = _clamped_dims(anchors)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = encodings[..., 0] * diag + anchors[..., 0]
        yg = encodings[..., 1] * diag + anchors[..., 1]
        zg = encodings[..., 2] * dza + anchors[..., 2]
        # clamped before exp so garbage residuals of masked rows stay finite
        dxg = torch.exp(torch.clamp(encodings[..., 3], -20.0, 20.0)) * dxa
        dyg = torch.exp(torch.clamp(encodings[..., 4], -20.0, 20.0)) * dya
        dzg = torch.exp(torch.clamp(encodings[..., 5], -20.0, 20.0)) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(encodings[..., 7] + torch.sin(anchors[..., 6]),
                             encodings[..., 6] + torch.cos(anchors[..., 6]))
            rest_start = 8
        else:
            rg = encodings[..., 6] + anchors[..., 6]
            rest_start = 7
        rest = [encodings[..., rest_start + i] + anchors[..., 7 + i]
                for i in range(anchors.shape[-1] - 7)]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *rest], dim=-1)


class ResidualCoderV2(ResidualCoder):
    """Unnormalised residuals: plain centre deltas, absolute log-dims,
    absolute [cos, sin] (or the heading residual), and z taken at the bottom
    face of both box and anchor."""

    def encode(self, boxes, anchors):
        dxg, dyg, dzg = _clamped_dims(boxes)
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        za = anchors[..., 2] - dza / 2
        zg = boxes[..., 2] - dzg / 2
        if self.encode_angle_by_sincos:
            rt = [torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])]
        else:
            rt = [boxes[..., 6] - anchors[..., 6]]
        rest = [boxes[..., 7 + i] - anchors[..., 7 + i] for i in range(boxes.shape[-1] - 7)]
        return torch.stack([boxes[..., 0] - anchors[..., 0], boxes[..., 1] - anchors[..., 1],
                            zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg),
                            *rt, *rest], dim=-1)

    def decode(self, encodings, anchors):
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        za = anchors[..., 2] - dza / 2
        dzg = torch.exp(encodings[..., 5])
        if self.encode_angle_by_sincos:
            rg = torch.atan2(encodings[..., 7], encodings[..., 6])
            rest_start = 8
        else:
            rg = encodings[..., 6] + anchors[..., 6]
            rest_start = 7
        rest = [encodings[..., rest_start + i] + anchors[..., 7 + i]
                for i in range(anchors.shape[-1] - 7)]
        return torch.stack([encodings[..., 0] + anchors[..., 0],
                            encodings[..., 1] + anchors[..., 1],
                            encodings[..., 2] + za + dzg / 2,
                            torch.exp(encodings[..., 3]), torch.exp(encodings[..., 4]), dzg,
                            rg, *rest], dim=-1)


class PointResidualCoder:
    """Point-based coder with class-mean sizes; code size 8 (heading as
    cos, sin)."""

    def __init__(self, code_size: int = 8, use_mean_size: bool = True, mean_size=None,
                 **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            self.mean_size = torch.as_tensor(mean_size, dtype=torch.float32)

    def _sizes(self, classes):
        size = self.mean_size.to(classes.device)[classes.long() - 1]
        return size[..., 0], size[..., 1], size[..., 2]

    def encode(self, gt_boxes, points, gt_classes=None):
        xg, yg, zg = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
        dxg, dyg, dzg = _clamped_dims(gt_boxes)
        rg = gt_boxes[..., 6]
        if self.use_mean_size:
            dxa, dya, dza = self._sizes(gt_classes)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            xt = (xg - points[..., 0]) / diag
            yt = (yg - points[..., 1]) / diag
            zt = (zg - points[..., 2]) / dza
            dxt, dyt, dzt = torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)
        else:
            xt, yt, zt = xg - points[..., 0], yg - points[..., 1], zg - points[..., 2]
            dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
        dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]
        if self.use_mean_size:
            dxa, dya, dza = self._sizes(pred_classes)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            xg = xt * diag + points[..., 0]
            yg = yt * diag + points[..., 1]
            zg = zt * dza + points[..., 2]
            dxg, dyg, dzg = torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza
        else:
            xg, yg, zg = xt + points[..., 0], yt + points[..., 1], zt + points[..., 2]
            dxg, dyg, dzg = torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)
        rg = torch.atan2(encodings[..., 7], encodings[..., 6])
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)


class PreviousResidualDecoder:
    """Decode residuals relative to previous-frame boxes: predictions are
    offsets from the prior box."""

    def __init__(self, code_size: int = 7, **kwargs):
        self.code_size = code_size

    @staticmethod
    def decode(encodings, prev_boxes):
        diag = torch.sqrt(torch.clamp(prev_boxes[..., 3], min=1e-5) ** 2
                          + torch.clamp(prev_boxes[..., 4], min=1e-5) ** 2)
        xg = encodings[..., 0] * diag + prev_boxes[..., 0]
        yg = encodings[..., 1] * diag + prev_boxes[..., 1]
        zg = encodings[..., 2] * torch.clamp(prev_boxes[..., 5], min=1e-5) + prev_boxes[..., 2]
        dxg = torch.exp(encodings[..., 3]) * prev_boxes[..., 3]
        dyg = torch.exp(encodings[..., 4]) * prev_boxes[..., 4]
        dzg = torch.exp(encodings[..., 5]) * prev_boxes[..., 5]
        rg = encodings[..., 6] + prev_boxes[..., 6]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)


class PreviousResidualRoIDecoder(PreviousResidualDecoder):
    """The RoI variant: the same decode applied to RoIs."""
