"""SAM-style debug and visualization helpers (the port's copy of
``dgtd_tpu/utils/vis_debug.py``; the reference defines them on its ``cod``
model and calls none of them in a train or val path).

``activation_filter`` is the per-channel max-activation threshold,
``find_bbox`` the largest blob's bounding box, ``show_box`` and
``show_mask`` matplotlib overlays (imported when called). Host-side numpy.

``find_bbox`` takes scipy's 8-connected components where the reference
traces cv2 contours, and ranks blobs by pixel count where cv2 ranks them by
``contourArea``: for well-separated solid blobs the boxes agree; a hollow
or a one-pixel-wide blob can rank otherwise.
"""

from __future__ import annotations

import numpy as np


def activation_filter(x: np.ndarray, filter_ratio: float) -> np.ndarray:
    """Reference ``_filter`` (cod.py:53-57): per-(batch, channel) spatial max
    scaled by ``filter_ratio``, shaped (B, C, 1, 1) for broadcasting against
    NCHW maps (the reference's layout for this debug path)."""
    b, c = x.shape[:2]
    thresh = x.reshape(b, c, -1).max(axis=2)
    return (filter_ratio * thresh).reshape(b, c, 1, 1)


def find_bbox(feat_map: np.ndarray, binary_thresh: float = 0.5) -> np.ndarray:
    """Reference ``find_bbox`` (cod.py:59-69): zero out activations below
    ``binary_thresh``, take the largest blob, return ``[x0, y0, x1, y1]``
    with cv2 ``boundingRect`` conventions (x1 = xmax + 1, y1 = ymax + 1).

    Input: any array squeezable to (H, W), values in [0, 1]."""
    from scipy import ndimage

    fm = np.asarray(feat_map, dtype=np.float32).squeeze()
    if fm.ndim != 2:
        raise ValueError(f"expected a single-channel map, got {np.shape(feat_map)}")
    fm = np.where(fm < binary_thresh, 0.0, fm)
    mask = (fm * 255).astype(np.uint8) > 0
    # cv2.findContours walks 8-connected borders; match its component notion
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), dtype=bool))
    if n == 0:
        raise ValueError("no blob above binary_thresh")  # reference raises too (max() of [])
    areas = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n + 1))
    best = 1 + int(np.argmax(areas))
    ys, xs = np.nonzero(labels == best)
    x0, y0 = int(xs.min()), int(ys.min())
    x1, y1 = int(xs.max()) + 1, int(ys.max()) + 1
    return np.array([x0, y0, x1, y1])


def show_box(box, ax, color: str = "green", lw: float = 2.0):
    """Reference ``show_box`` (cod.py:71-74): draw an [x0,y0,x1,y1] box."""
    import matplotlib.pyplot as plt

    x0, y0 = box[0], box[1]
    w, h = box[2] - box[0], box[3] - box[1]
    ax.add_patch(plt.Rectangle((x0, y0), w, h, edgecolor=color, facecolor=(0, 0, 0, 0), lw=lw))


def show_mask(mask: np.ndarray, ax, random_color: bool = False):
    """Reference ``show_mask`` (cod.py:87-94): translucent mask overlay."""
    if random_color:
        color = np.concatenate([np.random.random(3), np.array([0.6])], axis=0)
    else:
        color = np.array([30 / 255, 144 / 255, 255 / 255, 0.6])
    h, w = mask.shape[-2:]
    ax.imshow(mask.reshape(h, w, 1) * color.reshape(1, 1, -1))
