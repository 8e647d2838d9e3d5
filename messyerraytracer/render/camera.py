"""Batch ray generation — rewrite of ``RayCamera``.

The reference generates rays in a serial per-pixel loop
(src/modules/graphics/ray_camera.h:37-273); here the whole width x height
grid is one fused jnp expression (broadcasted iota -> normalize), which XLA
compiles to a few fused passes.  Semantics match exactly:

  * pixel center at +0.5, NDC u = 2*(x+jx)/w - 1, v = 1 - 2*(y+jy)/h
  * perspective: view dir (u*half_w, v*half_h, -1) with
    half_h = tan(fov/2), half_w = half_h * aspect (vertical FOV,
    ray_camera.h:209-218), transformed by the camera basis, normalized
  * orthographic: uniform forward direction, origin offset in the camera
    XY plane by (u*ortho_half_w, v*ortho_half_h) (ray_camera.h:225-233)
  * debug grid: ``RayTracerDebug::cast_debug_rays`` basis construction
    (src/godot/raytracer_debug.cpp:572-596) — half_w = tan(fov/2),
    half_h = half_w * (h/w), v NOT flipped (positive v = camera up)

Rays come out in row-major raster order, matching ``generate_rays``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.types import Rays, make_rays


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Plain-float camera description (mirrors api/path_tracer.h CameraParams).

    basis: (3,3) columns are camera-space right / up / back (-forward), i.e.
    Godot convention: camera looks along -Z.
    """

    origin: tuple
    basis: tuple  # 3x3 nested tuple, column-major meaning: basis[:, i] = axis i
    fov_degrees: float = 75.0
    ortho: bool = False
    ortho_size: float = 4.0  # full vertical extent in world units

    @staticmethod
    def look_at(origin, target, up=(0.0, 1.0, 0.0), fov_degrees=75.0,
                ortho=False, ortho_size=4.0) -> "CameraParams":
        """Construct a camera basis looking from origin toward target."""
        o = np.asarray(origin, np.float32)
        fwd = np.asarray(target, np.float32) - o
        fwd = fwd / np.linalg.norm(fwd)
        upv = np.asarray(up, np.float32)
        if abs(float(np.dot(fwd, upv) / np.linalg.norm(upv))) > 0.999:
            upv = np.array([1.0, 0.0, 0.0], np.float32)
        right = np.cross(fwd, upv)
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        basis = np.stack([right, true_up, -fwd], axis=1)  # columns; -Z = forward
        return CameraParams(
            origin=tuple(float(x) for x in o),
            basis=tuple(tuple(float(x) for x in row) for row in basis),
            fov_degrees=fov_degrees,
            ortho=ortho,
            ortho_size=ortho_size,
        )


def generate_rays(cam: CameraParams, width: int, height: int,
                  jitter=(0.5, 0.5)) -> Rays:
    """Generate width*height rays in raster order (row-major, top-left first).

    ``jitter`` is the sub-pixel offset in [0,1) — (0.5, 0.5) is the pixel
    center (ray_camera.h:106-124); pass per-frame Halton offsets for AA.
    Jitter may be a pair of scalars or of (H, W) arrays for per-pixel jitter.
    """
    origin = jnp.asarray(cam.origin, jnp.float32)
    basis = jnp.asarray(cam.basis, jnp.float32)
    jx, jy = jitter

    x = jnp.arange(width, dtype=jnp.float32)[None, :]
    y = jnp.arange(height, dtype=jnp.float32)[:, None]
    u = (2.0 * (x + jx) / width) - 1.0          # (H, W) after broadcast
    v = 1.0 - (2.0 * (y + jy) / height)
    u, v = jnp.broadcast_arrays(u, v)

    if not cam.ortho:
        tan_half = float(np.tan(np.deg2rad(cam.fov_degrees) * 0.5))
        aspect = width / height
        half_w = tan_half * aspect
        half_h = tan_half
        view_dir = jnp.stack(
            [u * half_w, v * half_h, -jnp.ones_like(u)], axis=-1
        )  # (H, W, 3)
        # explicit f32 mul-adds: `view_dir @ basis.T` is a matrix product
        # the GPU may run in TF32 (~1e-3 error in every direction)
        world_dir = _normalize(
            view_dir[..., 0:1] * basis[:, 0]
            + view_dir[..., 1:2] * basis[:, 1]
            + view_dir[..., 2:3] * basis[:, 2]
        )
        o = jnp.broadcast_to(origin, world_dir.shape)
        return make_rays(o.reshape(-1, 3), world_dir.reshape(-1, 3))
    else:
        half_h = cam.ortho_size * 0.5
        half_w = half_h * (width / height)
        right = basis[:, 0]
        up = basis[:, 1]
        forward = -basis[:, 2]
        o = (
            origin[None, None, :]
            + right[None, None, :] * (u * half_w)[..., None]
            + up[None, None, :] * (v * half_h)[..., None]
        )
        d = jnp.broadcast_to(forward, o.shape)
        return make_rays(o.reshape(-1, 3), d.reshape(-1, 3))


def debug_grid_rays(origin, forward, grid_w: int = 16, grid_h: int = 12,
                    fov_degrees: float = 60.0) -> Rays:
    """The BASELINE config #1 ray grid.

    Matches ``RayTracerDebug::cast_debug_rays`` exactly
    (raytracer_debug.cpp:572-596): camera basis from forward + world-up hint
    (fallback +X when |dot| > 0.99), half_w = tan(fov/2),
    half_h = half_w * h/w, pixel centers, v *not* flipped, row-major with
    y=0 row first.
    """
    o = np.asarray(origin, np.float32)
    fwd = np.asarray(forward, np.float32)
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(fwd, up_hint))) > 0.99:
        up_hint = np.array([1.0, 0.0, 0.0], np.float32)
    right = np.cross(fwd, up_hint)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    up = up / np.linalg.norm(up)

    half_w = float(np.tan(np.deg2rad(fov_degrees) * 0.5))
    half_h = half_w * (grid_h / grid_w)

    x = jnp.arange(grid_w, dtype=jnp.float32)[None, :]
    y = jnp.arange(grid_h, dtype=jnp.float32)[:, None]
    u = (2.0 * (x + 0.5) / grid_w - 1.0) * half_w
    v = (2.0 * (y + 0.5) / grid_h - 1.0) * half_h
    u, v = jnp.broadcast_arrays(u, v)
    d = (
        jnp.asarray(fwd)[None, None, :]
        + jnp.asarray(right)[None, None, :] * u[..., None]
        + jnp.asarray(up)[None, None, :] * v[..., None]
    )
    d = _normalize(d)
    o_arr = jnp.broadcast_to(jnp.asarray(o), d.shape)
    return make_rays(o_arr.reshape(-1, 3), d.reshape(-1, 3))
