"""Multi-bounce path tracer — rewrite of CPUPathTracer + path_trace.h.

The reference's per-pixel bounce loop with a thread pool
(src/modules/graphics/cpu_path_tracer.h:56-223) becomes a *wavefront*: all
pixels advance through each bounce together as dense arrays — trace the
whole batch, one batched NEE shadow cast per light, one fused shade pass,
sample all bounce directions at once.  Inactive pixels carry degenerate
rays (t_max < t_min -> instant miss), exactly the reference's trick for
keeping batch shapes static (cpu_path_tracer.h:20-22,128).

Math ported semantically (path_trace.h):
  * branchless ONB (Duff et al. 2017, :80-90)
  * cosine-weighted hemisphere sampling (Malley, :101-120)
  * GGX half-vector sampling, D cancelled in the weight (:132-155)
  * probabilistic lobe select spec_prob = m + (1-m)(1-r)*0.5 in
    [0.05, 0.95] (:185-251)
  * Russian roulette from bounce 2, survival = min(max(throughput), 0.95)
    (cpu_path_tracer.h:176-186)
  * PCG32 RNG (O'Neill; path_state.h:40-67) with the reference's
    pixel*1009 + frame*6529 + 7 seeding — vectorized: one 4-byte state per
    pixel, advanced in lockstep
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..core.types import Rays
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    ambient_color_at,
    cook_torrance_multi_light,
    extract_surface,
    fresnel_schlick,
    geometry_smith_ggx,
    light_sample,
    sky_color,
    to_srgb,
    tonemap,
)

PI = 3.14159265358979
SHADOW_EPS = 1e-3


# ============================================================================
# PCG32, vectorized (path_state.h:40-67)
# ============================================================================

def pcg32_seed(seed: jnp.ndarray) -> jnp.ndarray:
    """Vectorized ``PCG32::seed``: state=0; next(); state+=seed; next()."""
    state = jnp.zeros_like(seed, dtype=jnp.uint32)
    state, _ = pcg32_next(state)
    state = state + seed.astype(jnp.uint32)
    state, _ = pcg32_next(state)
    return state


def pcg32_next(state: jnp.ndarray):
    """Advance state; returns (new_state, uint32 output)."""
    old = state
    new = old * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((old >> ((old >> 28) + jnp.uint32(4))) ^ old) * jnp.uint32(277803737)
    return new, (word >> 22) ^ word


def pcg32_float(state: jnp.ndarray):
    """Returns (new_state, float32 in [0,1))."""
    state, word = pcg32_next(state)
    return state, word.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


# ============================================================================
# Sampling (path_trace.h:80-155)
# ============================================================================

def construct_onb(n: jnp.ndarray):
    """Branchless ONB (Duff 2017, path_trace.h:80-90). n: (N,3)."""
    sign = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    tangent = jnp.stack(
        [1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]], axis=1
    )
    bitangent = jnp.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=1)
    return tangent, bitangent


def _normalize(v):
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def cosine_hemisphere_sample(normal, u1, u2):
    """Malley's method (path_trace.h:101-120)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    t, b = construct_onb(normal)
    return _normalize(t * x[:, None] + b * y[:, None] + normal * z[:, None])


def ggx_sample_half(normal, roughness, u1, u2):
    """GGX NDF inverse-CDF half-vector sample (path_trace.h:132-155)."""
    a = roughness * roughness
    a2 = a * a
    cos_t = jnp.sqrt((1.0 - u1) / (1.0 + (a2 - 1.0) * u1 + 1e-8))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * PI * u2
    lx = sin_t * jnp.cos(phi)
    ly = sin_t * jnp.sin(phi)
    t, b = construct_onb(normal)
    return _normalize(
        t * lx[:, None] + b * ly[:, None] + normal * cos_t[:, None]
    )


def sample_bounce(surf, rng_state):
    """Batched lobe select + importance sample (path_trace.h:185-251).

    Returns (rng_state, direction (N,3), weight (N,3), valid (N,)).
    """
    rng_state, u_sel = pcg32_float(rng_state)
    rng_state, u1 = pcg32_float(rng_state)
    rng_state, u2 = pcg32_float(rng_state)

    spec_prob = jnp.clip(
        surf.metallic + (1.0 - surf.metallic) * (1.0 - surf.roughness) * 0.5,
        0.05, 0.95,
    )
    do_spec = u_sel < spec_prob

    # --- specular branch (computed for all, selected by mask) ----------
    h = ggx_sample_half(surf.normal, surf.roughness, u1, u2)
    v_dot_h = jnp.maximum(jnp.sum(surf.view_dir * h, axis=-1), 0.0)
    spec_dir = _normalize(h * (2.0 * v_dot_h)[:, None] - surf.view_dir)
    spec_ndl = jnp.sum(surf.normal * spec_dir, axis=-1)
    n_dot_h = jnp.maximum(jnp.sum(surf.normal * h, axis=-1), 0.0)
    g = geometry_smith_ggx(surf.n_dot_v, spec_ndl, surf.roughness)
    f = fresnel_schlick(v_dot_h[:, None], surf.f0)
    common = g * v_dot_h / (surf.n_dot_v * n_dot_h * spec_prob + 1e-8)
    spec_w = f * common[:, None]
    spec_valid = spec_ndl > 0.0

    # --- diffuse branch -------------------------------------------------
    diff_dir = cosine_hemisphere_sample(surf.normal, u1, u2)
    diff_ndl = jnp.sum(surf.normal * diff_dir, axis=-1)
    diff_w = surf.diff / (1.0 - spec_prob)[:, None]
    diff_valid = diff_ndl > 0.0

    direction = jnp.where(do_spec[:, None], spec_dir, diff_dir)
    weight = jnp.where(do_spec[:, None], spec_w, diff_w)
    valid = jnp.where(do_spec, spec_valid, diff_valid)
    return rng_state, direction, weight, valid


# ============================================================================
# Path tracer
# ============================================================================

@dataclasses.dataclass
class PathTraceParams:
    """Mirrors api/path_tracer.h:36-68."""

    width: int
    height: int
    max_bounces: int = 3
    sample_index: int = 0  # frame number for RNG decorrelation


class PathTracer:
    """Iterative wavefront path tracer (IPathTracer analogue,
    api/path_tracer.h:69-88).

    ``trace_frame(params, rays) -> (N,3) linear radiance`` then the caller
    tonemaps, or use ``trace_frame_srgb`` for the display-ready image
    (cpu_path_tracer.h:202-222 finalize).
    """

    def __init__(self, scene, lights: Lights | None, env: EnvironmentData,
                 materials: Materials, mat_id_of_prim=None,
                 attributes=None, atlas=None,
                 sort_secondary: bool = False):
        self.scene = scene
        self.lights = lights
        self.env = env
        self.materials = materials
        self.mat_id_of_prim = mat_id_of_prim
        self.attributes = attributes
        self.atlas = atlas
        # Morton-sort bounce rays for traversal coherence (the
        # dispatcher's incoherent-batch treatment, ray_dispatcher.h:130-150).
        # Off by default: the argsort + gathers cost a frame pass each
        # bounce, and no measurement yet shows the coherence repaying it.
        self.sort_secondary = sort_secondary

    def _mat_ids(self, hits):
        pid = jnp.maximum(hits.prim_id, 0)
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return jnp.zeros_like(pid)

    def trace_frame(self, params: PathTraceParams, rays: Rays,
                    pixel_offset=0) -> jnp.ndarray:
        """One sample per pixel of full path-traced radiance, linear RGB.

        Bounce loop (cpu_path_tracer.h:56-223): trace -> NEE shadows ->
        shade/emit -> sample bounce -> Russian roulette, with inactive
        lanes masked (not compacted — static shapes).  ``pixel_offset``
        is the global index of ``rays[0]``, so a frame traced in shards
        seeds every pixel as the whole frame would.
        """
        n = rays.count
        pixel = (jnp.arange(n, dtype=jnp.uint32)
                 + jnp.asarray(pixel_offset, jnp.uint32))
        rng = pcg32_seed(
            pixel * jnp.uint32(1009)
            + jnp.uint32(params.sample_index) * jnp.uint32(6529)
            + jnp.uint32(7)
        )

        throughput = jnp.ones((n, 3), jnp.float32)
        accum = jnp.zeros((n, 3), jnp.float32)
        active = jnp.ones((n,), bool)
        cur = rays

        for bounce in range(params.max_bounces + 1):
            # degenerate rays for inactive lanes (cpu_path_tracer.h:20-22)
            cast = Rays(
                origin=cur.origin,
                direction=cur.direction,
                t_min=cur.t_min,
                t_max=jnp.where(active, cur.t_max, -1.0),
            )
            if bounce >= 1 and self.sort_secondary:
                from ..dispatch.morton import (
                    sort_rays_by_direction,
                    unshuffle_hits,
                )

                sorted_rays, perm = sort_rays_by_direction(cast)
                hits_s, _ = self.scene.cast_rays(sorted_rays)
                hits = unshuffle_hits(hits_s, perm)
            else:
                hits, _ = self.scene.cast_rays(cast)
            hit = hits.hit & active

            # --- miss -> sky, path ends --------------------------------
            sky = sky_color(cur.direction, self.env)
            accum = accum + jnp.where(
                (active & ~hits.hit)[:, None], throughput * sky, 0.0
            )

            surf = extract_surface(
                hits, cur.direction, self.materials, self._mat_ids(hits),
                attrs=self.attributes, atlas=self.atlas,
            )

            # --- emission ----------------------------------------------
            accum = accum + jnp.where(
                hit[:, None], throughput * surf.emission, 0.0
            )

            # --- NEE direct lighting with shadow rays ------------------
            if self.lights is not None:
                lit = self._shadow_masks(hits, hit)
                direct = cook_torrance_multi_light(surf, self.lights, lit)
                accum = accum + jnp.where(
                    hit[:, None], throughput * direct, 0.0
                )

            # --- ambient only on primary hits (cpu_path_tracer.h:110-150)
            if bounce == 0:
                amb = ambient_color_at(surf.normal, self.env)
                accum = accum + jnp.where(
                    hit[:, None],
                    throughput * surf.diff * amb * self.env.ambient_color
                    * self.env.ambient_energy,
                    0.0,
                )

            if bounce == params.max_bounces:
                break

            # --- sample bounce -----------------------------------------
            rng, bdir, bweight, bvalid = sample_bounce(surf, rng)
            active = hit & bvalid
            throughput = jnp.where(active[:, None], throughput * bweight,
                                   throughput)

            # --- Russian roulette from bounce 2 ------------------------
            if bounce >= 1:
                survival = jnp.minimum(jnp.max(throughput, axis=-1), 0.95)
                rng, u = pcg32_float(rng)
                survive = u < survival
                throughput = jnp.where(
                    (active & survive)[:, None],
                    throughput / jnp.maximum(survival, 1e-6)[:, None],
                    throughput,
                )
                active = active & survive

            cur = Rays(
                origin=hits.position + surf.normal * SHADOW_EPS,
                direction=bdir,
                t_min=jnp.full((n,), 1e-3, jnp.float32),
                t_max=jnp.full((n,), 3.0e38, jnp.float32),
            )

        return accum

    def trace_frame_srgb(self, params: PathTraceParams, rays: Rays):
        """trace + tonemap + gamma (cpu_path_tracer.h:202-222)."""
        linear = self.trace_frame(params, rays)
        return to_srgb(tonemap(linear, self.env.tonemap_mode))

    def _shadow_masks(self, hits, alive) -> jnp.ndarray:
        lights = self.lights
        n = hits.t.shape[0]
        origins, dirs, tmins, tmaxs = [], [], [], []
        for li in range(lights.count):
            ldir, _, valid, dist = light_sample(hits.position, lights, li)
            o = hits.position + hits.normal * SHADOW_EPS
            is_dir = lights.type[li] == 0
            tmax = jnp.where(is_dir, 1e30, dist - 2.0 * SHADOW_EPS)
            tmax = jnp.where(alive & valid, tmax, -1.0)
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
