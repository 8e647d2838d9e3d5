"""Per-triangle vertex attributes: UVs, smooth normals, tangents.

Rewrite of the reference's parallel attribute arrays
(src/core/triangle_uv.h, triangle_normals.h, triangle_tangents.h): one SoA
pytree indexed by prim_id, with batched barycentric interpolation —
``result = (1-u-v)*a0 + u*a1 + v*a2`` (the Moller-Trumbore weights for
v1/v2) — as fused jnp passes over whole hit batches.

Also the normal-map perturbation via the TBN basis
(shade_pass.h extract_surface / perturb_normal):
``bitangent = cross(normal, tangent) * sign`` with Godot's 4-float
tangent convention (xyz + bitangent sign).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.struct import pytree_dataclass


@pytree_dataclass
class TriangleAttributes:
    """Parallel per-triangle vertex attributes, indexed by prim_id.

    uv:      (T, 3, 2) float32 — UVs at the 3 vertices (Godot convention:
             (0,0) top-left)
    normal:  (T, 3, 3) float32 — vertex normals; when absent, filled with
             the face normal (graceful flat-shading degradation,
             triangle_normals.h:8-11)
    tangent: (T, 3, 4) float32 — xyz + bitangent sign; all-zero = absent
             (triangle_tangents.h:13-14)
    """

    uv: jnp.ndarray
    normal: jnp.ndarray
    tangent: jnp.ndarray

    @property
    def count(self) -> int:
        return self.uv.shape[0]


def make_attributes(num_tris: int, uv=None, normals=None, tangents=None,
                    face_normals=None) -> TriangleAttributes:
    """Build the attribute table; missing channels get safe defaults."""
    if uv is None:
        uv = np.zeros((num_tris, 3, 2), np.float32)
        uv[:, 1, 0] = 1.0
        uv[:, 2, 1] = 1.0  # degenerate-but-usable (0,0)/(1,0)/(0,1) chart
    if normals is None:
        if face_normals is not None:
            normals = np.repeat(
                np.asarray(face_normals, np.float32)[:, None, :], 3, axis=1
            )
        else:
            normals = np.zeros((num_tris, 3, 3), np.float32)
            normals[:, :, 1] = 1.0
    if tangents is None:
        tangents = np.zeros((num_tris, 3, 4), np.float32)
    return TriangleAttributes(
        uv=jnp.asarray(uv, jnp.float32),
        normal=jnp.asarray(normals, jnp.float32),
        tangent=jnp.asarray(tangents, jnp.float32),
    )


def _bary(a, u, v):
    """Batched barycentric blend of (N,3,K) vertex attrs by (N,) u/v."""
    w = (1.0 - u - v)[:, None]
    return a[:, 0] * w + a[:, 1] * u[:, None] + a[:, 2] * v[:, None]


def interpolate_uv(attrs: TriangleAttributes, prim_id, u, v) -> jnp.ndarray:
    """(N,2) interpolated texture UVs (triangle_uv.h:23-27)."""
    a = attrs.uv[jnp.maximum(prim_id, 0)]
    return _bary(a, u, v)


def interpolate_normal(attrs: TriangleAttributes, prim_id, u, v) -> jnp.ndarray:
    """(N,3) smooth shading normals, normalized (triangle_normals.h:23-28)."""
    a = attrs.normal[jnp.maximum(prim_id, 0)]
    n = _bary(a, u, v)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(ln > 0.0, ln, 1.0)


def interpolate_tangent(attrs: TriangleAttributes, prim_id, u, v):
    """((N,3) tangent, (N,) sign, (N,) has_tangent)
    (triangle_tangents.h:30-56)."""
    a = attrs.tangent[jnp.maximum(prim_id, 0)]
    t = _bary(a[..., :3], u, v)
    len_sq = jnp.sum(t * t, axis=-1)
    has = len_sq >= 1e-8
    t = jnp.where(
        has[:, None],
        t / jnp.sqrt(jnp.maximum(len_sq, 1e-8))[:, None],
        jnp.asarray([1.0, 0.0, 0.0]),
    )
    s = _bary(a[..., 3:4], u, v)[:, 0]
    sign = jnp.where(s >= 0.0, 1.0, -1.0)
    return t, sign, has


def perturb_normal(normal, tangent, sign, normal_sample, normal_scale=1.0):
    """Apply a tangent-space normal-map sample via the TBN basis.

    ``normal_sample`` is the decoded (N,3) map value in [-1,1];
    bitangent = cross(n, t) * sign (Godot convention).
    """
    bitangent = jnp.cross(normal, tangent) * sign[:, None]
    # normal_scale: python scalar or (N,1) per-pixel strength
    ns = jnp.concatenate(
        [normal_sample[:, :2] * normal_scale, normal_sample[:, 2:3]], axis=1
    )
    out = (
        tangent * ns[:, 0:1]
        + bitangent * ns[:, 1:2]
        + normal * ns[:, 2:3]
    )
    ln = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return out / jnp.where(ln > 0.0, ln, 1.0)
