"""Core SoA types: rays, hits, triangles, stats.

Redesign of the reference's scalar POD types
(``src/core/ray.h:25-98``, ``src/core/intersection.h:16-61``,
``src/core/triangle.h:22-136``, ``src/core/stats.h:20-55``): one struct per
*batch* (structure-of-arrays) instead of one struct per ray, so every field is
a dense ``(N, ...)`` array that a kernel reads one lane per ray.

Numerical semantics preserved from the reference:
  * ``t_min`` default 0.001 (shadow-acne offset, ``src/core/ray.h:44,55``)
  * safe inverse direction with eps 1e-9 -> +/-1e9 clamp (``src/core/ray.h:81-92``)
  * Moller-Trumbore determinant epsilon 1e-8 (``src/core/triangle.h:67``)
  * NO_HIT sentinel = max uint32 (``src/core/intersection.h:42``); we store
    prim_id as int32 so the sentinel is -1 (same bit pattern)
  * strictly-closer hit update ``t < best_t`` => first triangle (lowest index)
    wins exact ties (``src/core/triangle.h:93``)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.struct import pytree_dataclass

# --- constants (reference parity) -------------------------------------------
T_MIN_DEFAULT = 1e-3      # src/core/ray.h:55
T_MAX_DEFAULT = 3.402823466e38  # FLT_MAX
INV_DIR_EPS = 1e-9        # src/core/ray.h:81
MT_DET_EPS = 1e-8         # src/core/triangle.h:67
# Barycentric crack tolerance of the traversal kernel (kernels/walk.py).
# The card contracts multiply-adds into FMAs, so it rounds a shared-edge
# function differently from the oracle's Moller-Trumbore and an exactly
# edge-on hit could fall in neither neighbor (an edge-on v of -1.9e-7 is
# the size seen at 2M triangles).  Accepting barycentrics down to
# -MT_BARY_EPS closes interior-edge cracks; the silhouette band it widens
# is ~4e-6 barycentric units thick (subpixel at any practical
# resolution).  The jnp paths (core/geometry.py) keep the reference's
# exact >= 0 test (triangle.h:73-84).
MT_BARY_EPS = 4e-6
NO_HIT = -1               # int32 bit pattern of UINT32_MAX (intersection.h:42)
ALL_LAYERS = -1           # int32 bit pattern of 0xFFFFFFFF


@pytree_dataclass
class Rays:
    """A batch of N rays in SoA layout.

    origin:    (N, 3) float32
    direction: (N, 3) float32 — should be normalized so t equals distance
    t_min:     (N,)   float32
    t_max:     (N,)   float32
    """

    origin: jnp.ndarray
    direction: jnp.ndarray
    t_min: jnp.ndarray
    t_max: jnp.ndarray

    @property
    def count(self) -> int:
        return self.origin.shape[0]


def make_rays(origin, direction, t_min=None, t_max=None) -> Rays:
    """Build a ``Rays`` batch with reference-default t bounds."""
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    if origin.ndim == 1:
        origin = origin[None, :]
    if direction.ndim == 1:
        direction = direction[None, :]
    origin, direction = jnp.broadcast_arrays(origin, direction)
    n = origin.shape[0]
    if t_min is None:
        t_min = jnp.full((n,), T_MIN_DEFAULT, jnp.float32)
    else:
        t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    if t_max is None:
        t_max = jnp.full((n,), T_MAX_DEFAULT, jnp.float32)
    else:
        t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    return Rays(origin=origin, direction=direction, t_min=t_min, t_max=t_max)


def safe_inv_direction(direction: jnp.ndarray) -> jnp.ndarray:
    """Safe 1/direction: near-zero components -> signed 1/eps = ±1e9.

    Mirrors ``Ray::_precompute`` (src/core/ray.h:81-92).  Computed on the fly
    in kernels rather than stored — a reciprocal is cheaper than the
    memory traffic of an extra (N,3) array.
    """
    small = jnp.abs(direction) < INV_DIR_EPS
    sign = jnp.where(direction < 0.0, -1.0, 1.0)
    return jnp.where(small, sign / INV_DIR_EPS, 1.0 / jnp.where(small, 1.0, direction))


@pytree_dataclass
class Hits:
    """A batch of N intersection results in SoA layout.

    Mirrors ``Intersection`` (src/core/intersection.h:16-61):
      t:          (N,)  float32, FLT_MAX when miss
      position:   (N,3) float32, origin + direction*t
      normal:     (N,3) float32, geometric (face) normal
      u, v:       (N,)  float32 barycentric weights for v1 / v2
      prim_id:    (N,)  int32, NO_HIT (-1) when miss
      hit_layers: (N,)  int32 layer bitmask of the hit triangle (0 on miss)
    """

    t: jnp.ndarray
    position: jnp.ndarray
    normal: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    prim_id: jnp.ndarray
    hit_layers: jnp.ndarray

    @property
    def hit(self) -> jnp.ndarray:
        """(N,) bool — did the ray hit anything? (intersection.h:58-60)"""
        return self.prim_id != NO_HIT

    @property
    def count(self) -> int:
        return self.t.shape[0]


def make_miss(n: int) -> Hits:
    """All-miss hit batch (``Intersection::set_miss``, intersection.h:49-55)."""
    f3 = jnp.zeros((n, 3), jnp.float32)
    return Hits(
        t=jnp.full((n,), T_MAX_DEFAULT, jnp.float32),
        position=f3,
        normal=f3,
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
        prim_id=jnp.full((n,), NO_HIT, jnp.int32),
        hit_layers=jnp.zeros((n,), jnp.int32),
    )


@pytree_dataclass
class Triangles:
    """A batch of T triangles in SoA layout with precomputed edges/normals.

    Mirrors ``Triangle`` (src/core/triangle.h:22-52): edge1/edge2/normal are
    precomputed once at build; ``prim_id`` survives BVH reordering; ``layers``
    is the visibility bitmask (0xFFFFFFFF = all layers).

    v0:      (T, 3) float32
    edge1:   (T, 3) float32  v1 - v0
    edge2:   (T, 3) float32  v2 - v0
    normal:  (T, 3) float32  normalize(edge1 x edge2)
    prim_id: (T,)   int32
    layers:  (T,)   int32
    """

    v0: jnp.ndarray
    edge1: jnp.ndarray
    edge2: jnp.ndarray
    normal: jnp.ndarray
    prim_id: jnp.ndarray
    layers: jnp.ndarray

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @property
    def v1(self) -> jnp.ndarray:
        return self.v0 + self.edge1

    @property
    def v2(self) -> jnp.ndarray:
        return self.v0 + self.edge2


def make_triangles(v0, v1, v2, prim_id=None, layers=None) -> Triangles:
    """Build a ``Triangles`` batch, precomputing edges and face normals.

    Matches the Triangle constructor (src/core/triangle.h:41-51).
    """
    if isinstance(v0, np.ndarray) and isinstance(v1, np.ndarray) \
            and isinstance(v2, np.ndarray):
        # Host inputs: derive in numpy and put the finished arrays —
        # eager device ops would compile once per new shape.
        v0 = v0.astype(np.float32)
        v1 = v1.astype(np.float32)
        v2 = v2.astype(np.float32)
        e1h = v1 - v0
        e2h = v2 - v0
        nh = np.cross(e1h, e2h)
        nl = np.linalg.norm(nh, axis=-1, keepdims=True)
        nh = nh / np.where(nl > 0.0, nl, 1.0)
        v0, e1, e2, n = (jnp.asarray(v0), jnp.asarray(e1h),
                         jnp.asarray(e2h), jnp.asarray(nh.astype(np.float32)))
        t = v0.shape[0]
    else:
        v0 = jnp.asarray(v0, jnp.float32)
        v1 = jnp.asarray(v1, jnp.float32)
        v2 = jnp.asarray(v2, jnp.float32)
        t = v0.shape[0]
        e1 = v1 - v0
        e2 = v2 - v0
        n = jnp.cross(e1, e2)
        norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
        n = n / jnp.where(norm > 0.0, norm, 1.0)
    if prim_id is None:
        prim_id = jnp.arange(t, dtype=jnp.int32)
    else:
        prim_id = jnp.asarray(prim_id, jnp.int32)
    if layers is None:
        layers = jnp.full((t,), ALL_LAYERS, jnp.int32)
    else:
        layers = jnp.asarray(layers, jnp.int32)
    return Triangles(v0=v0, edge1=e1, edge2=e2, normal=n, prim_id=prim_id, layers=layers)


@pytree_dataclass
class RayStats:
    """Per-cast counters (src/core/stats.h:20-55), each a scalar int32 array.

    rays_cast / tri_tests / bvh_nodes_visited / hits; addition merges two
    stats (the reference's per-thread merge ``operator+=``, stats.h:34-39 —
    here it is a lax reduction over kernel-accumulated outputs).

    stack_drops counts traversal-stack pushes the traversal kernel had to
    drop (stack full).  The stack is sized from the built tree's depth so
    this is 0 by construction; a nonzero value means the cast may have
    missed hits and MUST fail any parity gate (silent drops can never
    pass a bench).
    """

    rays_cast: jnp.ndarray
    tri_tests: jnp.ndarray
    bvh_nodes_visited: jnp.ndarray
    hits: jnp.ndarray
    stack_drops: jnp.ndarray = 0

    def __add__(self, other: "RayStats") -> "RayStats":
        return RayStats(
            rays_cast=self.rays_cast + other.rays_cast,
            tri_tests=self.tri_tests + other.tri_tests,
            bvh_nodes_visited=self.bvh_nodes_visited + other.bvh_nodes_visited,
            hits=self.hits + other.hits,
            stack_drops=self.stack_drops + other.stack_drops,
        )

    # Derived metrics (stats.h:41-54).
    def avg_tri_tests_per_ray(self):
        return jnp.where(self.rays_cast > 0, self.tri_tests / jnp.maximum(self.rays_cast, 1), 0.0)

    def avg_nodes_per_ray(self):
        return jnp.where(
            self.rays_cast > 0, self.bvh_nodes_visited / jnp.maximum(self.rays_cast, 1), 0.0
        )

    def hit_rate(self):
        return jnp.where(self.rays_cast > 0, self.hits / jnp.maximum(self.rays_cast, 1), 0.0)


def zero_stats() -> RayStats:
    z = jnp.zeros((), jnp.int32)
    return RayStats(rays_cast=z, tri_tests=z, bvh_nodes_visited=z, hits=z)
