"""Rotation (camera-move) pair selection from MVImgNet-style capture data
(a copy of `anyedit_tpu/edits/rotation.py`).

Port of rotation_change_tool.py:11-164 + read_write_camera_model.py (COLMAP
binary model IO): pick two frames of one object capture, compute the
relative camera rotation quaternion → axis/angle → a left/right turn
instruction. Pure numpy, no diffusion.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from anyedit_tpu_torch.edits.types import EditOutcome


# ---- quaternion math -----------------------------------------------------

def quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def relative_rotation(q1: np.ndarray, q2: np.ndarray) -> tuple[np.ndarray, float]:
    """Axis and angle (deg) of the rotation taking camera 1 to camera 2."""
    q = quat_mul(q2, quat_conj(q1))
    q = q / np.linalg.norm(q)
    w = np.clip(q[0], -1.0, 1.0)
    angle = 2.0 * np.degrees(np.arccos(abs(w)))
    axis = q[1:]
    n = np.linalg.norm(axis)
    axis = axis / n if n > 1e-9 else np.array([0.0, 1.0, 0.0])
    if w < 0:
        axis = -axis
    return axis, float(angle)


def determine_rotation(q1: np.ndarray, q2: np.ndarray,
                       min_deg: float = 10.0, max_deg: float = 120.0
                       ) -> str | None:
    """'left'/'right' if the dominant rotation is about the vertical axis
    within [min, max] degrees, else None (determine_rotation, :11-28)."""
    axis, angle = relative_rotation(q1, q2)
    if not (min_deg <= angle <= max_deg):
        return None
    if abs(axis[1]) < 0.7:   # not a yaw-dominant rotation
        return None
    return "left" if axis[1] > 0 else "right"


def rotation_instruction(direction: str, rng: np.random.Generator) -> str:
    verbs = ("Turn", "Rotate", "Spin")
    return f"{rng.choice(verbs)} the object to the {direction}"


# ---- COLMAP binary images.bin reader ------------------------------------

@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray   # (4,) w x y z
    tvec: np.ndarray   # (3,)
    camera_id: int
    name: str


def read_images_binary(path: str | Path) -> dict[int, ColmapImage]:
    """COLMAP images.bin reader (read_write_camera_model.py:22-534 surface)."""
    images: dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        num = struct.unpack("<Q", f.read(8))[0]
        for _ in range(num):
            head = struct.unpack("<idddddddi", f.read(64))
            image_id = head[0]
            qvec = np.array(head[1:5])
            tvec = np.array(head[5:8])
            camera_id = head[8]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)  # skip 2D points
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode())
    return images


def write_images_binary(path: str | Path, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.image_id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def rotation_change(tb, rec, image, rng):
    """Record-level pipeline (rotation_change_tool.py:31-164, its main loop): pick a
    capture frame pair via `tb.extra['load_rotation_pair']`, accept it when
    the relative camera rotation is a 10-120° yaw, and synthesize the
    left/right instruction. No diffusion — the capture IS the edit pair."""
    loader = tb.extra.get("load_rotation_pair")
    if loader is None:
        return EditOutcome(False, reason="rotation frame loader unavailable")
    pair = loader(rec)
    if pair is None:
        return EditOutcome(False, reason="no capture frames for record")
    frame_a, frame_b, q1, q2 = pair
    direction = determine_rotation(np.asarray(q1, np.float64),
                                   np.asarray(q2, np.float64))
    if direction is None:
        return EditOutcome(False, reason="rotation not a 10-120 degree yaw")
    rec.edit = rotation_instruction(direction, rng)
    return EditOutcome(True, edited=np.asarray(frame_b),
                       input_image=np.asarray(frame_a))
