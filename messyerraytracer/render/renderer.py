"""RayRenderer — full-frame orchestration (trace -> shadow -> shade -> AOVs).

Rewrite of ``RayRenderer::render_frame``
(src/modules/graphics/ray_renderer.cpp:115-281): per frame,

  1. jittered camera raygen — Halton(2,3) subpixel offsets, camera-motion
     detection resets the accumulation (:441-518)
  2. closest-hit trace through the scene (the batch-cast primitive)
  3. one batched any-hit submit per light for shadow masks, laid out
     [light][pixel] (:546-628)
  4. vectorized shade of the selected AOV channel(s) — Cook-Torrance with
     NEE + ambient + emission for COLOR, plus 10 debug channels
     (shade_pass.h:890-931)
  5. temporal accumulation as an incremental mean over frames (:787-869)

All per-pixel loops become dense jnp passes; the per-frame device work is a
handful of dispatches (trace, shadows, fused shade).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Rays, make_rays
from . import framebuffer as fbch
from .camera import CameraParams, generate_rays
from .framebuffer import RayImage
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    Surface,
    ambient_color_at,
    cook_torrance_multi_light,
    default_materials,
    extract_surface,
    fresnel_schlick,
    light_sample,
    make_environment,
    sky_color,
    to_srgb,
    tonemap,
)

SHADOW_EPS = 1e-3  # shadow-ray origin offset along the normal


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence (ray_renderer.cpp:474-518 jitter)."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


@dataclasses.dataclass
class RenderSettings:
    width: int = 320
    height: int = 240
    channels: tuple = (fbch.COLOR,)
    accumulate: bool = True     # temporal AA accumulation
    depth_range: float = 20.0   # DEPTH channel normalization
    position_range: float = 4.0  # POSITION channel wrap cell size
    shadows: bool = True


class RayRenderer:
    """Frame renderer over a scene object exposing cast_rays/any_hit_rays.

    ``scene`` may be a RayScene, SceneTLAS (flattened), or RayDispatcher.
    """

    def __init__(self, scene, camera: CameraParams,
                 lights: Lights | None = None,
                 env: EnvironmentData | None = None,
                 materials: Materials | None = None,
                 mat_id_of_prim: jnp.ndarray | None = None,
                 attributes=None, atlas=None,
                 settings: RenderSettings | None = None):
        self.scene = scene
        self.camera = camera
        self.lights = lights
        self.env = env if env is not None else make_environment()
        self.materials = materials if materials is not None else default_materials()
        self.mat_id_of_prim = mat_id_of_prim
        # vertex attributes + texture atlas feed extract_surface (the
        # reference's SceneShadeData plumbing, api/scene_shade_data.h:21-43)
        self.attributes = attributes
        self.atlas = atlas
        self.settings = settings if settings is not None else RenderSettings()
        # temporal accumulation state (ray_renderer.cpp:441-466)
        self._accum: jnp.ndarray | None = None
        self._accum_frames = 0
        self._last_cam = camera
        self.timings: dict[str, float] = {}

    # -- public API -----------------------------------------------------
    def reset_accumulation(self) -> None:
        self._accum = None
        self._accum_frames = 0

    def render_frame(self) -> RayImage:
        """Render one frame; returns the AOV framebuffer.

        Accumulation advances by one sample when ``settings.accumulate``;
        a camera change resets it (motion detection,
        ray_renderer.cpp:441-466).
        """
        st = self.settings
        if self.camera != self._last_cam:
            self.reset_accumulation()
            self._last_cam = self.camera

        t0 = time.perf_counter()
        frame = self._accum_frames
        jitter = (
            (halton(frame + 1, 2), halton(frame + 1, 3))
            if st.accumulate else (0.5, 0.5)
        )
        rays = generate_rays(self.camera, st.width, st.height, jitter=jitter)
        t1 = time.perf_counter()

        hits, stats = self.scene.cast_rays(rays)
        t2 = time.perf_counter()

        lit_mask = None
        if st.shadows and self.lights is not None and fbch.COLOR in st.channels:
            lit_mask = self._trace_shadows(hits)
        t3 = time.perf_counter()

        fb = self._shade(rays, hits, lit_mask)
        t4 = time.perf_counter()

        if st.accumulate and fbch.COLOR in st.channels:
            color = fb.get(fbch.COLOR)
            if self._accum is None:
                self._accum = color
            else:
                # incremental mean (ray_renderer.cpp:799-835)
                k = self._accum_frames
                self._accum = self._accum + (color - self._accum) / (k + 1)
            self._accum_frames += 1
            fb.write(fbch.COLOR, self._accum)

        self.timings = {
            "raygen_ms": (t1 - t0) * 1e3,
            "trace_ms": (t2 - t1) * 1e3,
            "shadow_ms": (t3 - t2) * 1e3,
            "shade_ms": (t4 - t3) * 1e3,
        }
        return fb

    # -- internals ------------------------------------------------------
    def _trace_shadows(self, hits) -> jnp.ndarray:
        """(L, N) lit mask via ONE batched any-hit submit for all lights
        (cpu_path_tracer.h:250-328 batching shape)."""
        lights = self.lights
        n = hits.t.shape[0]
        origins, dirs, tmins, tmaxs = [], [], [], []
        for li in range(lights.count):
            ldir, _, valid, dist = light_sample(hits.position, lights, li)
            o = hits.position + hits.normal * SHADOW_EPS
            is_dir = lights.type[li] == 0
            tmax = jnp.where(is_dir, 1e30, dist - 2.0 * SHADOW_EPS)
            # rays for non-hit pixels or invalid lights are degenerate
            # (t_max < t_min => instant miss), the reference's inactive-ray
            # trick (cpu_path_tracer.h:20-22)
            alive = hits.hit & valid
            tmax = jnp.where(alive, tmax, -1.0)
            origins.append(o)
            dirs.append(ldir)
            tmins.append(jnp.full((n,), SHADOW_EPS, jnp.float32))
            tmaxs.append(tmax)
        shadow_rays = Rays(
            origin=jnp.concatenate(origins),
            direction=jnp.concatenate(dirs),
            t_min=jnp.concatenate(tmins),
            t_max=jnp.concatenate(tmaxs),
        )
        occluded = self.scene.any_hit_rays(shadow_rays)
        return ~occluded.reshape(lights.count, n)

    def _mat_ids(self, hits) -> jnp.ndarray:
        pid = jnp.maximum(hits.prim_id, 0)
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return jnp.zeros_like(pid)

    def _shade(self, rays, hits, lit_mask) -> RayImage:
        st = self.settings
        fb = RayImage(st.width, st.height)
        n = hits.t.shape[0]
        hit = hits.hit
        ones = jnp.ones((n, 1), jnp.float32)

        def rgba(rgb):
            return jnp.concatenate([rgb, ones], axis=1)

        surf = None
        needs_surf = (
            fbch.COLOR, fbch.FRESNEL, fbch.ALBEDO, fbch.UV, fbch.NORMAL,
        )
        if any(ch in st.channels for ch in needs_surf):
            surf = extract_surface(
                hits, rays.direction, self.materials, self._mat_ids(hits),
                attrs=self.attributes, atlas=self.atlas,
            )

        for ch in st.channels:
            if ch == fbch.COLOR:
                out = jnp.zeros((n, 3), jnp.float32)
                if self.lights is not None:
                    out = cook_torrance_multi_light(surf, self.lights, lit_mask)
                amb = ambient_color_at(surf.normal, self.env)
                out = out + surf.diff * amb * self.env.ambient_color * \
                    self.env.ambient_energy
                out = out + surf.emission
                out = tonemap(out, self.env.tonemap_mode)
                out = to_srgb(out)
                sky = to_srgb(tonemap(sky_color(rays.direction, self.env),
                                      self.env.tonemap_mode))
                rgb = jnp.where(hit[:, None], out, sky)
                fb.write(ch, rgba(rgb))
            elif ch == fbch.NORMAL:
                # shading normal: smooth/normal-mapped when attributes are
                # wired (shade_pass.h shade_normal), else geometric
                nrm = surf.normal if self.attributes is not None else hits.normal
                rgb = jnp.where(hit[:, None], nrm * 0.5 + 0.5, 0.0)
                fb.write(ch, rgba(rgb))
            elif ch == fbch.DEPTH:
                d = jnp.clip(1.0 - hits.t / st.depth_range, 0.0, 1.0)
                d = jnp.where(hit, d, 0.0)[:, None]
                fb.write(ch, rgba(jnp.repeat(d, 3, axis=1)))
            elif ch == fbch.BARYCENTRIC:
                w = 1.0 - hits.u - hits.v
                rgb = jnp.where(
                    hit[:, None], jnp.stack([hits.u, hits.v, w], axis=1), 0.0
                )
                fb.write(ch, rgba(rgb))
            elif ch == fbch.POSITION:
                f = hits.position / st.position_range
                rgb = jnp.where(hit[:, None], f - jnp.floor(f), 0.0)
                fb.write(ch, rgba(rgb))
            elif ch == fbch.PRIM_ID:
                # hash prim id to a stable color (shade_pass.h:788-805)
                h = hits.prim_id.astype(jnp.uint32)
                h = ((h >> 16) ^ h) * jnp.uint32(0x45D9F3B)
                h = ((h >> 16) ^ h) * jnp.uint32(0x45D9F3B)
                h = (h >> 16) ^ h
                rgb = jnp.stack(
                    [
                        ((h >> 0) & 0xFF).astype(jnp.float32) / 255.0,
                        ((h >> 8) & 0xFF).astype(jnp.float32) / 255.0,
                        ((h >> 16) & 0xFF).astype(jnp.float32) / 255.0,
                    ],
                    axis=1,
                )
                fb.write(ch, rgba(jnp.where(hit[:, None], rgb, 0.0)))
            elif ch == fbch.HIT_MASK:
                v = hit.astype(jnp.float32)[:, None]
                fb.write(ch, rgba(jnp.repeat(v, 3, axis=1)))
            elif ch == fbch.ALBEDO:
                # textured albedo when an atlas is wired (shade_albedo)
                rgb = jnp.where(hit[:, None], surf.albedo, 0.0)
                fb.write(ch, rgba(rgb))
            elif ch == fbch.WIREFRAME:
                w0 = 1.0 - hits.u - hits.v
                d = jnp.minimum(jnp.minimum(w0, hits.u), hits.v)
                t = jnp.clip((d - 0.01) / 0.02, 0.0, 1.0)
                edge = 1.0 - t * t * (3.0 - 2.0 * t)
                v = jnp.where(hit, 0.08 + edge * 0.92, 0.0)[:, None]
                fb.write(ch, rgba(jnp.repeat(v, 3, axis=1)))
            elif ch == fbch.UV:
                # interpolated texture UVs when attributes are wired
                # (triangle_uv.h:23-27); barycentric u/v otherwise
                if self.attributes is not None:
                    uvz = jnp.concatenate(
                        [surf.uv, jnp.zeros_like(surf.uv[:, :1])], axis=1
                    )
                else:
                    uvz = jnp.stack(
                        [hits.u, hits.v, jnp.zeros_like(hits.u)], axis=1
                    )
                fb.write(ch, rgba(jnp.where(hit[:, None], uvz, 0.0)))
            elif ch == fbch.FRESNEL:
                # shade_pass.h:868-884: r = g = n_dot_v, b = 0.3+0.7*n_dot_v
                ndv = jnp.clip(surf.n_dot_v, 0.0, 1.0)
                base = jnp.stack([ndv, ndv, 0.3 + 0.7 * ndv], axis=1)
                fb.write(ch, rgba(jnp.where(hit[:, None], base, 0.0)))
            else:
                raise ValueError(f"unknown channel {ch}")
        return fb
