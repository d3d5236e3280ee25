"""Skeleton rendering helpers.

The port's copy of the drawing part of ``improved_body_parts_tpu/utils/
common.py``: ``draw_humans``, ``draw_humans_ellipse``, ``show_color_vector``
and their palettes (reference utils/common.py:240-299 and demo_image.py),
on numpy keypoint arrays. cv2 (and matplotlib for ``show_color_vector``) is
imported only inside the functions that draw.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from improved_body_parts_tpu_torch.configs import DRAW_LIST, LIMBS_CONN, NUM_PARTS


# per-part drawing colors (BGR). reference: utils/common.py:240-263
COCO_COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]

# the demo's 25-color limb palette + the board that walks it, one color per
# drawn limb type. reference: demo_image.py:31-34, :218
LIMB_COLORS = [
    [128, 114, 250], [130, 238, 238], [48, 167, 238], [180, 105, 255],
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85], [193, 193, 255],
    [106, 106, 255], [20, 147, 255],
]
COLOR_BOARD = [0, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21]


def draw_humans(img: np.ndarray, kps: np.ndarray,
                draw_limbs: Tuple[int, ...] = DRAW_LIST,
                radius: int = 4, thickness: int = 3) -> np.ndarray:
    """Draw skeletons on a BGR image. reference: utils/common.py:291-299,
    demo_image.py:174-192 (circle/line rendering of the refactor path)."""
    import cv2
    canvas = img.copy()
    for person in kps:
        for j in range(NUM_PARTS):
            x, y, v = person[j]
            if v > 0:
                cv2.circle(canvas, (int(round(x)), int(round(y))), radius,
                           COCO_COLORS[j % len(COCO_COLORS)], -1)
        for li in draw_limbs:
            fr, to = LIMBS_CONN[li]
            if person[fr, 2] > 0 and person[to, 2] > 0:
                p1 = (int(round(person[fr, 0])), int(round(person[fr, 1])))
                p2 = (int(round(person[to, 0])), int(round(person[to, 1])))
                cv2.line(canvas, p1, p2, COCO_COLORS[li % len(COCO_COLORS)],
                         thickness)
    return canvas


def draw_humans_ellipse(img: np.ndarray, kps: np.ndarray,
                        draw_limbs: Tuple[int, ...] = DRAW_LIST) -> np.ndarray:
    """The reference demo's limb rendering: each limb is a filled ellipse
    polygon alpha-blended onto the canvas (0.4 canvas + 0.6 overlay), with
    black endpoint circles, one palette color per drawn limb type
    (demo_image.py:217-240)."""
    import math

    import cv2
    canvas = img.copy()
    for color_idx, li in enumerate(draw_limbs):
        fr, to = LIMBS_CONN[li]
        color = LIMB_COLORS[COLOR_BOARD[color_idx % len(COLOR_BOARD)]]
        for person in kps:
            if person[fr, 2] <= 0 or person[to, 2] <= 0:
                continue
            cur = canvas.copy()
            xs = (float(person[fr, 0]), float(person[to, 0]))
            ys = (float(person[fr, 1]), float(person[to, 1]))
            m_x, m_y = np.mean(xs), np.mean(ys)
            length = math.hypot(ys[0] - ys[1], xs[0] - xs[1])
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            polygon = cv2.ellipse2Poly((int(m_x), int(m_y)),
                                       (int(length / 2), 3), int(angle),
                                       0, 360, 1)
            cv2.circle(cur, (int(xs[0]), int(ys[0])), 4, color=[0, 0, 0],
                       thickness=2)
            cv2.circle(cur, (int(xs[1]), int(ys[1])), 4, color=[0, 0, 0],
                       thickness=2)
            cv2.fillConvexPoly(cur, polygon, color)
            canvas = cv2.addWeighted(canvas, 0.4, cur, 0.6, 0)
    return canvas


def show_color_vector(img: np.ndarray, paf: np.ndarray, heat: np.ndarray,
                      out_prefix: str = "maps") -> List[str]:
    """Heatmap/PAF diagnostic overlays (reference demo_image.py:246-283
    ``show_color_vector``): the PAF channel-16 flow field as an HSV
    angle/magnitude image, a raw PAF channel, the background channel, the
    reverse-mask channel and one keypoint channel, each blended over the
    input. Saves figures to ``{out_prefix}_*.png`` (headless substitute for
    the reference's plt.show) and returns the paths."""
    import cv2
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hsv = np.zeros_like(img)
    hsv[..., 1] = 255
    mag, ang = cv2.cartToPolar(paf[:, :, 16].astype(np.float32),
                               1.5 * paf[:, :, 16].astype(np.float32))
    hsv[..., 0] = ang * 180 / np.pi / 2
    hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    limb_flow = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

    panels = [
        ("flow", lambda ax: (ax.imshow(img[:, :, ::-1]),
                             ax.imshow(limb_flow, alpha=0.5))),
        ("paf11", lambda ax: (ax.imshow(img[:, :, ::-1]),
                              ax.imshow(paf[:, :, 11], alpha=0.6))),
        ("background", lambda ax: (ax.imshow(heat[:, :, -1]),
                                   ax.imshow(img[:, :, ::-1], alpha=0.25))),
        ("mask", lambda ax: (ax.imshow(heat[:, :, -2]),
                             ax.imshow(img[:, :, ::-1], alpha=0.5))),
        ("keypoint4", lambda ax: (ax.imshow(img[:, :, ::-1]),
                                  ax.imshow(heat[:, :, 4], alpha=0.5))),
    ]
    paths = []
    for name, render in panels:
        fig, ax = plt.subplots(figsize=(8, 8))
        render(ax)
        ax.set_axis_off()
        path = f"{out_prefix}_{name}.png"
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths
