"""AOV framebuffer — rewrite of ``RayImage``.

The reference keeps 11 RGBA-float channels with per-pixel writes
(src/modules/graphics/ray_image.h:36-161); here each channel is a dense
(H*W, 4) float32 device array produced by one vectorized shade pass, and
``to_u8`` is the FORMAT_RGBA8 conversion (ray_image.cpp to_image()).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Channel ids (ray_image.h:43-56)
COLOR = "color"
NORMAL = "normal"
DEPTH = "depth"
BARYCENTRIC = "barycentric"
POSITION = "position"
PRIM_ID = "prim_id"
HIT_MASK = "hit_mask"
ALBEDO = "albedo"
WIREFRAME = "wireframe"
UV = "uv"
FRESNEL = "fresnel"

ALL_CHANNELS = (
    COLOR, NORMAL, DEPTH, BARYCENTRIC, POSITION, PRIM_ID, HIT_MASK,
    ALBEDO, WIREFRAME, UV, FRESNEL,
)


class RayImage:
    """Dict of AOV channels, each (H*W, 4) float32 (device arrays)."""

    def __init__(self, width: int, height: int):
        assert width > 0 and height > 0
        self.width = width
        self.height = height
        self.channels: dict[str, jnp.ndarray] = {}

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    def write(self, channel: str, rgba: jnp.ndarray) -> None:
        assert channel in ALL_CHANNELS, channel
        assert rgba.shape == (self.pixel_count, 4), rgba.shape
        self.channels[channel] = rgba

    def get(self, channel: str) -> jnp.ndarray:
        return self.channels[channel]

    def to_u8(self, channel: str = COLOR) -> np.ndarray:
        """(H, W, 4) uint8 image (clamped), like to_image() FORMAT_RGBA8."""
        arr = np.asarray(self.channels[channel])
        img = np.clip(arr, 0.0, 1.0).reshape(self.height, self.width, 4)
        return (img * 255.0 + 0.5).astype(np.uint8)

    def to_f32(self, channel: str = COLOR) -> np.ndarray:
        return np.asarray(self.channels[channel]).reshape(
            self.height, self.width, 4
        )
