"""Texture sampling — rewrite of ``TextureSampler``.

The reference samples Godot Images per pixel with nearest/bilinear +
repeat wrap (src/modules/graphics/texture_sampler.h:45-88).  Here textures
live in a fixed-shape device atlas (K, H, W, C) so a whole frame's worth
of samples is one vectorized gather: per-pixel (texture id, uv) pairs in,
(N, C) texels out.  Textures of other sizes are resampled into the atlas
at registration (nearest) — a trade of registration-time work for a
static-shape hot path.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.struct import pytree_dataclass


@pytree_dataclass
class TextureAtlas:
    """(K, H, W, 3) float32 texture stack; id 0 is reserved white."""

    data: jnp.ndarray

    @property
    def count(self) -> int:
        return self.data.shape[0]


class TextureRegistry:
    """Host-side builder for a TextureAtlas."""

    def __init__(self, size: int = 256):
        self.size = size
        self._textures = [np.ones((size, size, 3), np.float32)]  # id 0: white

    def add(self, image: np.ndarray) -> int:
        """Register an (H, W, 3[+]) float image; returns its texture id."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        img = img[..., :3]
        h, w = img.shape[:2]
        if (h, w) != (self.size, self.size):
            yi = (np.arange(self.size) * h // self.size).clip(0, h - 1)
            xi = (np.arange(self.size) * w // self.size).clip(0, w - 1)
            img = img[yi][:, xi]
        self._textures.append(img.astype(np.float32))
        return len(self._textures) - 1

    def build(self) -> TextureAtlas:
        return TextureAtlas(data=jnp.asarray(np.stack(self._textures)))


def sample_nearest(atlas: TextureAtlas, tex_id, u, v) -> jnp.ndarray:
    """(N,3) nearest-neighbor samples with repeat wrap
    (texture_sampler.h:25-43)."""
    k, h, w = atlas.data.shape[0], atlas.data.shape[1], atlas.data.shape[2]
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = jnp.clip((uu * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((vv * h).astype(jnp.int32), 0, h - 1)
    return atlas.data[tex_id, y, x]


def sample_bilinear(atlas: TextureAtlas, tex_id, u, v) -> jnp.ndarray:
    """(N,3) bilinear samples with repeat wrap (texture_sampler.h:45-88)."""
    h, w = atlas.data.shape[1], atlas.data.shape[2]
    uu = u - jnp.floor(u)
    vv = v - jnp.floor(v)
    x = uu * w - 0.5
    y = vv * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0w = jnp.mod(x0, w)
    x1w = jnp.mod(x0 + 1, w)
    y0w = jnp.mod(y0, h)
    y1w = jnp.mod(y0 + 1, h)
    c00 = atlas.data[tex_id, y0w, x0w]
    c10 = atlas.data[tex_id, y0w, x1w]
    c01 = atlas.data[tex_id, y1w, x0w]
    c11 = atlas.data[tex_id, y1w, x1w]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
