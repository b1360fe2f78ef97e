"""Landmark drawing: counterpart of ``lighthand_tpu/utils/landmarks.py``.

The MediaPipe-style drawing of the reference (src/utils/drewing_utils.py:
41-319: ``DrawingSpec``, ``_normalized_to_pixel_coordinates``,
``draw_landmarks``, ``draw_axis``, ``plot_landmarks``) over plain ``(N,
2..4)`` float arrays: columns x, y[, z[, visibility]] in normalized [0, 1]
image coordinates. A landmark below the visibility threshold is dropped,
out-of-[0, 1] coordinates are dropped, and a connection is drawn only when
both ends survive.

The JAX package draws with OpenCV; the port draws the same pixels in numpy
on the host (``utils/visualize.py``: ``draw_line`` with its thickness,
``draw_circle`` as an outline, ``draw_arrowed_line``). ``plot_landmarks``
returns a Matplotlib figure and imports matplotlib only when called, as the
JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from lighthand_tpu_torch.utils.visualize import (
    draw_arrowed_line,
    draw_circle,
    draw_line,
)

__all__ = [
    "DrawingSpec",
    "HAND_CONNECTIONS",
    "normalized_to_pixel_coordinates",
    "draw_landmarks",
    "draw_axis",
    "plot_landmarks",
]

_VISIBILITY_THRESHOLD = 0.5

WHITE_COLOR = (224, 224, 224)
BLACK_COLOR = (0, 0, 0)
RED_COLOR = (0, 0, 255)
GREEN_COLOR = (0, 128, 0)
BLUE_COLOR = (255, 0, 0)

# 20 bones of the 21-joint hand, derived from utils/visualize.py:PARENTS
# (same topology as mediapipe.solutions.hands.HAND_CONNECTIONS).
HAND_CONNECTIONS: Tuple[Tuple[int, int], ...] = tuple(
    (parent, child)
    for child, parent in enumerate(
        [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17,
         18, 19]
    )
    if parent >= 0
)


@dataclasses.dataclass
class DrawingSpec:
    color: Tuple[int, int, int] = WHITE_COLOR
    thickness: int = 2
    circle_radius: int = 2


def normalized_to_pixel_coordinates(
    normalized_x: float, normalized_y: float, image_width: int,
    image_height: int,
) -> Optional[Tuple[int, int]]:
    """floor(x*w) clamped to the last pixel; None when either coordinate
    leaves [0, 1] (drewing_utils.py:50-66, isclose-tolerant bounds)."""

    def valid(v: float) -> bool:
        return (v > 0 or math.isclose(0, v)) and (v < 1 or math.isclose(1, v))

    if not (valid(normalized_x) and valid(normalized_y)):
        return None
    return (
        min(math.floor(normalized_x * image_width), image_width - 1),
        min(math.floor(normalized_y * image_height), image_height - 1),
    )


def _spec_for(spec, key) -> DrawingSpec:
    return spec[key] if isinstance(spec, Mapping) else spec


def draw_landmarks(
    image: np.ndarray,
    landmarks: np.ndarray,
    connections: Optional[Sequence[Tuple[int, int]]] = None,
    landmark_drawing_spec: Union[DrawingSpec, Mapping[int, DrawingSpec],
                                 None] = DrawingSpec(color=RED_COLOR),
    connection_drawing_spec: Union[DrawingSpec,
                                   Mapping[Tuple[int, int], DrawingSpec],
                                   None] = DrawingSpec(),
    visibility_threshold: float = _VISIBILITY_THRESHOLD,
) -> dict:
    """Draw normalized landmarks + their connections onto a 3-channel
    image in place (drewing_utils.py:120-199). `landmarks` is (N, >=2);
    an optional 4th column is visibility. Returns {index: (x_px, y_px)}
    for the landmarks that were drawable."""
    landmarks = np.asarray(landmarks, dtype=np.float64)
    if landmarks.size == 0:
        return {}
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("Input image must contain three channel data.")
    rows, cols = image.shape[:2]

    idx_to_coordinates = {}
    for idx, lm in enumerate(landmarks):
        if landmarks.shape[1] >= 4 and lm[3] < visibility_threshold:
            continue
        px = normalized_to_pixel_coordinates(lm[0], lm[1], cols, rows)
        if px:
            idx_to_coordinates[idx] = px

    if connections:
        n = len(landmarks)
        for connection in connections:
            start_idx, end_idx = connection[0], connection[1]
            if not (0 <= start_idx < n and 0 <= end_idx < n):
                raise ValueError(
                    f"Landmark index is out of range. Invalid connection "
                    f"from landmark #{start_idx} to landmark #{end_idx}."
                )
            if (connection_drawing_spec is not None
                    and start_idx in idx_to_coordinates
                    and end_idx in idx_to_coordinates):
                spec = _spec_for(connection_drawing_spec, tuple(connection))
                draw_line(image, idx_to_coordinates[start_idx],
                          idx_to_coordinates[end_idx], spec.color,
                          spec.thickness)

    if landmark_drawing_spec is not None:
        for idx, px in idx_to_coordinates.items():
            spec = _spec_for(landmark_drawing_spec, idx)
            border = max(spec.circle_radius + 1,
                         int(spec.circle_radius * 1.2))
            draw_circle(image, px, border, WHITE_COLOR, spec.thickness)
            draw_circle(image, px, spec.circle_radius, spec.color,
                        spec.thickness)
    return idx_to_coordinates


def draw_axis(
    image: np.ndarray,
    rotation: np.ndarray,
    translation: np.ndarray,
    focal_length: Tuple[float, float] = (1.0, 1.0),
    principal_point: Tuple[float, float] = (0.0, 0.0),
    axis_length: float = 0.1,
    axis_drawing_spec: DrawingSpec = DrawingSpec(),
) -> None:
    """Project an object-frame xyz triad through the NDC camera and draw
    RGB arrows (drewing_utils.py:201-251: -f*x/z NDC convention, clip to
    [-1,1], y flipped into image space)."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("Input image must contain three channel data.")
    rows, cols = image.shape[:2]
    axis_world = np.float64([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    axis_cam = (np.asarray(rotation, dtype=np.float64)
                @ (axis_length * axis_world.T)).T + np.asarray(
                    translation, dtype=np.float64)
    x, y, z = axis_cam[:, 0], axis_cam[:, 1], axis_cam[:, 2]
    fx, fy = focal_length
    px, py = principal_point
    x_ndc = np.clip(-fx * x / (z + 1e-5) + px, -1.0, 1.0)
    y_ndc = np.clip(-fy * y / (z + 1e-5) + py, -1.0, 1.0)
    x_im = ((1 + x_ndc) * 0.5 * cols).astype(np.int32)
    y_im = ((1 - y_ndc) * 0.5 * rows).astype(np.int32)
    origin = (int(x_im[0]), int(y_im[0]))
    for end, color in zip(range(1, 4), (RED_COLOR, GREEN_COLOR,
                                        BLUE_COLOR)):
        draw_arrowed_line(image, origin, (int(x_im[end]), int(y_im[end])),
                          color, axis_drawing_spec.thickness)


def plot_landmarks(
    landmarks: np.ndarray,
    connections: Optional[Sequence[Tuple[int, int]]] = None,
    landmark_drawing_spec: DrawingSpec = DrawingSpec(color=RED_COLOR,
                                                     thickness=5),
    connection_drawing_spec: DrawingSpec = DrawingSpec(color=BLACK_COLOR,
                                                       thickness=5),
    elevation: int = 10,
    azimuth: int = 10,
    visibility_threshold: float = _VISIBILITY_THRESHOLD,
):
    """Headless 3D scatter+bone plot in MediaPipe's world convention
    (drewing_utils.py:258-319: plotted as (-z, x, -y), BGR colors
    normalized to [0,1] RGB). Returns the figure."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    landmarks = np.asarray(landmarks, dtype=np.float64)
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elevation, azim=azimuth)

    plotted = {}
    for idx, lm in enumerate(landmarks):
        if landmarks.shape[1] >= 4 and lm[3] < visibility_threshold:
            continue
        z = lm[2] if landmarks.shape[1] >= 3 else 0.0
        ax.scatter3D(
            xs=[-z], ys=[lm[0]], zs=[-lm[1]],
            color=np.array(landmark_drawing_spec.color[::-1]) / 255.0,
            linewidth=landmark_drawing_spec.thickness)
        plotted[idx] = (-z, lm[0], -lm[1])

    if connections:
        n = len(landmarks)
        for connection in connections:
            start_idx, end_idx = connection[0], connection[1]
            if not (0 <= start_idx < n and 0 <= end_idx < n):
                raise ValueError(
                    f"Landmark index is out of range. Invalid connection "
                    f"from landmark #{start_idx} to landmark #{end_idx}."
                )
            if start_idx in plotted and end_idx in plotted:
                a, b = plotted[start_idx], plotted[end_idx]
                ax.plot3D(
                    xs=[a[0], b[0]], ys=[a[1], b[1]], zs=[a[2], b[2]],
                    color=np.array(
                        connection_drawing_spec.color[::-1]) / 255.0,
                    linewidth=connection_drawing_spec.thickness)
    return fig
