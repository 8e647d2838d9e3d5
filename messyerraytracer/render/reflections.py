"""Hybrid ray-traced reflections — rewrite of RTReflectionEffect.

The reference runs 4 compute passes per frame on Godot's shared
RenderingDevice (src/modules/graphics/rt_reflection_effect.{h,cpp} +
src/gpu/shaders/rt_*.comp.glsl):

  1. trace   — reconstruct world position from the G-buffer depth, decode
               the normal, reflect the view ray, BVH-trace it
               (rt_reflections.comp.glsl:73-92,161-)
  2. denoise — 5x5 cross-bilateral filter guided by depth + normal
               (rt_denoise_spatial.comp.glsl)
  3. temporal — EMA history accumulation, blend 0.1, depth-reject
               (rt_denoise_temporal.comp.glsl)
  4. composite — Fresnel-weighted, roughness-faded blend into the color
               buffer (rt_composite.comp.glsl)

Here the "G-buffer" is our own AOV framebuffer (SURVEY.md descope note):
positions/normals come from the primary-hit arrays, each pass is a fused
jnp image op, and the reflection trace is one batched cast.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.types import Rays
from .shade import EnvironmentData, fresnel_schlick, sky_color


@dataclasses.dataclass
class ReflectionSettings:
    """Inspector-style knobs (rt_reflection_effect.h:42-53)."""

    intensity: float = 1.0
    max_roughness: float = 0.6    # fade out above this roughness
    temporal_blend: float = 0.1   # EMA alpha (rt_denoise_temporal)
    depth_sigma: float = 0.5      # spatial bilateral guides
    normal_sigma: float = 16.0
    spatial_radius: int = 2       # 5x5 kernel
    ray_bias: float = 1e-3


class RTReflections:
    """Stateful reflections pass (temporal history across frames)."""

    def __init__(self, scene, env: EnvironmentData,
                 settings: ReflectionSettings | None = None):
        self.scene = scene
        self.env = env
        self.settings = settings or ReflectionSettings()
        self._history: jnp.ndarray | None = None   # (H, W, 3)
        self._history_depth: jnp.ndarray | None = None

    def reset(self):
        self._history = None
        self._history_depth = None

    # -- pass 1: trace --------------------------------------------------
    def trace(self, hits, view_dirs, width, height,
              shade_fn=None) -> jnp.ndarray:
        """Reflect primary rays at hit points and trace them.

        ``shade_fn(hits2, dirs) -> (N,3)`` colors the reflection hits
        (defaults to sky + flat normal shading).  Returns (H, W, 3).
        """
        st = self.settings
        n = hits.t.shape[0]
        nrm = hits.normal
        refl = view_dirs - 2.0 * jnp.sum(view_dirs * nrm, axis=-1,
                                         keepdims=True) * nrm
        origin = hits.position + nrm * st.ray_bias
        alive = hits.hit
        rays = Rays(
            origin=origin,
            direction=refl,
            t_min=jnp.full((n,), 1e-3, jnp.float32),
            t_max=jnp.where(alive, 3.0e38, -1.0),
        )
        hits2, _ = self.scene.cast_rays(rays)
        if shade_fn is None:
            sky = sky_color(refl, self.env)
            lit = 0.5 + 0.5 * jnp.clip(hits2.normal[:, 1:2], -1, 1)
            base = jnp.where(hits2.hit[:, None], lit * 0.8, sky)
        else:
            base = shade_fn(hits2, refl)
        out = jnp.where(alive[:, None], base, 0.0)
        return out.reshape(height, width, 3)

    # -- pass 2: spatial cross-bilateral denoise ------------------------
    def denoise_spatial(self, color, depth, normal) -> jnp.ndarray:
        """5x5 bilateral filter guided by depth + normal similarity
        (rt_denoise_spatial.comp.glsl).  All (H, W, C) arrays."""
        st = self.settings
        r = st.spatial_radius
        acc = jnp.zeros_like(color)
        wsum = jnp.zeros(color.shape[:2] + (1,), jnp.float32)
        inv_2ds = 1.0 / (2.0 * st.depth_sigma * st.depth_sigma)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                c = jnp.roll(jnp.roll(color, dy, 0), dx, 1)
                d = jnp.roll(jnp.roll(depth, dy, 0), dx, 1)
                nn = jnp.roll(jnp.roll(normal, dy, 0), dx, 1)
                wd = jnp.exp(-(d - depth) ** 2 * inv_2ds)
                ndot = jnp.clip(jnp.sum(nn * normal, axis=-1, keepdims=True),
                                0.0, 1.0)
                wn = ndot ** st.normal_sigma
                w = wd * wn
                acc = acc + c * w
                wsum = wsum + w
        return acc / jnp.maximum(wsum, 1e-6)

    # -- pass 3: temporal EMA -------------------------------------------
    def temporal(self, color, depth) -> jnp.ndarray:
        """History EMA (blend alpha) with depth rejection
        (rt_denoise_temporal.comp.glsl)."""
        st = self.settings
        if self._history is None:
            self._history = color
            self._history_depth = depth
            return color
        reject = jnp.abs(depth - self._history_depth) > 4.0 * st.depth_sigma
        blended = self._history * (1.0 - st.temporal_blend) + color * \
            st.temporal_blend
        out = jnp.where(reject, color, blended)
        self._history = out
        self._history_depth = depth
        return out

    # -- pass 4: composite ----------------------------------------------
    def composite(self, base_color, reflection, n_dot_v, roughness,
                  hit_mask) -> jnp.ndarray:
        """Fresnel-weighted, roughness-faded additive blend
        (rt_composite.comp.glsl)."""
        st = self.settings
        f = fresnel_schlick(jnp.clip(n_dot_v, 0.0, 1.0), jnp.float32(0.04))
        fade = jnp.clip(1.0 - roughness / st.max_roughness, 0.0, 1.0)
        w = (f * fade * st.intensity * hit_mask)[..., None]
        return base_color * (1.0 - w) + reflection * w

    # -- full frame ------------------------------------------------------
    def render(self, hits, view_dirs, base_color, roughness, width, height,
               shade_fn=None) -> jnp.ndarray:
        """Run all 4 passes.  ``base_color``: (H, W, 3); ``roughness``:
        (H, W); returns composited (H, W, 3)."""
        depth = hits.t.reshape(height, width, 1)
        depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
        normal = hits.normal.reshape(height, width, 3)
        refl = self.trace(hits, view_dirs, width, height, shade_fn)
        refl = self.denoise_spatial(refl, depth, normal)
        refl = self.temporal(refl, depth)
        ndv = jnp.clip(
            -jnp.sum(view_dirs * hits.normal, axis=-1), 0.0, 1.0
        ).reshape(height, width)
        hm = hits.hit.reshape(height, width).astype(jnp.float32)
        return self.composite(base_color, refl, ndv, roughness, hm)
