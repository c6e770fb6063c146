"""Anchor-residual box coder (port of cpd_tpu/ops/box_coders.py::ResidualCoder)."""
from __future__ import annotations

import torch


class ResidualCoder:
    """Anchor-residual coder for (x, y, z, dx, dy, dz, heading) boxes, code
    size 7 (the RoI head's setting)."""

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7) -> (..., 7) residual targets."""
        dxa = torch.clamp(anchors[..., 3], min=1e-5)
        dya = torch.clamp(anchors[..., 4], min=1e-5)
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        dxg = torch.clamp(boxes[..., 3], min=1e-5)
        dyg = torch.clamp(boxes[..., 4], min=1e-5)
        dzg = torch.clamp(boxes[..., 5], min=1e-5)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([(boxes[..., 0] - anchors[..., 0]) / diag,
                            (boxes[..., 1] - anchors[..., 1]) / diag,
                            (boxes[..., 2] - anchors[..., 2]) / dza,
                            torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza),
                            boxes[..., 6] - anchors[..., 6]], dim=-1)

    def decode(self, encodings, anchors):
        """encodings: (..., 7), anchors: (..., 7) -> (..., 7) boxes."""
        dxa = torch.clamp(anchors[..., 3], min=1e-5)
        dya = torch.clamp(anchors[..., 4], min=1e-5)
        dza = torch.clamp(anchors[..., 5], min=1e-5)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = encodings[..., 0] * diag + anchors[..., 0]
        yg = encodings[..., 1] * diag + anchors[..., 1]
        zg = encodings[..., 2] * dza + anchors[..., 2]
        # clamped before exp so garbage residuals of masked rows stay finite
        dxg = torch.exp(torch.clamp(encodings[..., 3], -20.0, 20.0)) * dxa
        dyg = torch.exp(torch.clamp(encodings[..., 4], -20.0, 20.0)) * dya
        dzg = torch.exp(torch.clamp(encodings[..., 5], -20.0, 20.0)) * dza
        rg = encodings[..., 6] + anchors[..., 6]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg], dim=-1)
