"""Scene plots on headless matplotlib (port of tools/visual_utils.py): a BEV
PNG and a 3-D render of points, gt boxes and predictions. matplotlib is
imported inside the functions: nothing else of the port needs it."""
from __future__ import annotations

import numpy as np
import torch


def draw_scenes(points, gt_boxes=None, ref_boxes=None, out_path="scene.png",
                point_size: float = 0.2, bound: float = 80.0):
    """Save a BEV PNG: points gray, gt boxes green, predictions red."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 12))
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=point_size, c=pts[:, 2], cmap="viridis",
               alpha=0.5, linewidths=0)

    def draw_boxes(boxes, color):
        from ..datasets.augmentor import boxes_bev_corners

        boxes = np.asarray(boxes).reshape(-1, boxes.shape[-1])
        if not len(boxes):
            return
        corners = boxes_bev_corners(boxes[:, :7])
        for c, b in zip(corners, boxes):
            poly = np.vstack([c, c[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.0)
            # heading tick
            cx, cy, yaw = b[0], b[1], b[6]
            ax.plot([cx, cx + np.cos(yaw) * b[3] / 2], [cy, cy + np.sin(yaw) * b[3] / 2],
                    color=color, linewidth=1.0)

    if gt_boxes is not None:
        draw_boxes(gt_boxes, "lime")
    if ref_boxes is not None:
        draw_boxes(ref_boxes, "red")
    ax.set_xlim(-bound, bound)
    ax.set_ylim(-bound, bound)
    ax.set_aspect("equal")
    ax.set_facecolor("black")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_scenes_3d(points, gt_boxes=None, ref_boxes=None, ref_scores=None,
                   ref_labels=None, out_path="scene_3d.png",
                   point_size: float = 0.15, bound: float = 80.0,
                   elev: float = 35.0, azim: float = -120.0):
    """3-D scene render: functional equivalent of the reference's mayavi
    ``draw_scenes`` (cpd/tools/visual_utils/visualize_utils.py:142-171 --
    point cloud + green gt wireframes + red prediction wireframes with
    score/label tags), on headless matplotlib 3-D instead of mayavi; saves
    a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..ops.geometry import boxes_to_corners_3d

    pts = np.asarray(points)
    fig = plt.figure(figsize=(14, 12))
    ax = fig.add_subplot(projection="3d")
    keep = (np.abs(pts[:, 0]) < bound) & (np.abs(pts[:, 1]) < bound)
    p = pts[keep]
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=point_size, c=p[:, 2],
               cmap="viridis", alpha=0.5, linewidths=0)

    # the 12 wireframe edges in corner order (geometry.boxes_to_corners_3d:
    # 4 bottom, 4 top, 4 vertical -- mirrors draw_corners3d :173-207)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]

    def draw_boxes(boxes, color, scores=None, labels=None):
        boxes = np.asarray(boxes)
        boxes = boxes.reshape(-1, boxes.shape[-1])
        if not len(boxes):
            return
        corners = boxes_to_corners_3d(torch.as_tensor(boxes[:, :7], dtype=torch.float32)).numpy()
        for bi, c in enumerate(corners):
            for a, b in edges:
                ax.plot([c[a, 0], c[b, 0]], [c[a, 1], c[b, 1]],
                        [c[a, 2], c[b, 2]], color=color, linewidth=0.8)
            tag = []
            if labels is not None:
                tag.append(str(np.asarray(labels).reshape(-1)[bi]))
            if scores is not None:
                tag.append(f"{float(np.asarray(scores).reshape(-1)[bi]):.2f}")
            if tag:
                top = c[4:8].mean(axis=0)
                ax.text(top[0], top[1], top[2] + 0.3, " ".join(tag),
                        color=color, fontsize=6)

    if gt_boxes is not None:
        draw_boxes(gt_boxes, "lime")
    if ref_boxes is not None:
        draw_boxes(ref_boxes, "red", ref_scores, ref_labels)
    ax.set_xlim(-bound, bound)
    ax.set_ylim(-bound, bound)
    ax.set_zlim(-3, 8)
    # isotropic meters (matplotlib 3-D default stretches z)
    ax.set_box_aspect((2 * bound, 2 * bound, 11))
    ax.view_init(elev=elev, azim=azim)
    ax.set_facecolor("black")
    fig.patch.set_facecolor("black")
    ax.set_axis_off()
    fig.savefig(out_path, dpi=120, bbox_inches="tight",
                facecolor=fig.get_facecolor())
    plt.close(fig)
    return out_path
