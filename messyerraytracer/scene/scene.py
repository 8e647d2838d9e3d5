"""Flat scene container — build triangles + BVH, cast rays.

Rewrite of ``RayScene`` (src/accel/ray_scene.h:34-210): owns the SoA
triangle arrays (in BVH slot order) and the BVH node arrays, exposes
closest-hit / any-hit casts, and keeps the reference's ``use_bvh=false``
brute-force validation mode (ray_scene.h:59,120-131) as the parity oracle.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.bvh import BVH, build_bvh, refit_bvh
from ..accel.frontier import (
    FrontierScene,
    build_frontier_scene,
    cast_rays_frontier,
)
from ..accel.traverse import cast_rays_bvh
from ..kernels.walk import cast_rays_walk
from ..core.brute import any_hit_brute, cast_rays_brute
from ..core.types import (
    ALL_LAYERS,
    Hits,
    Rays,
    RayStats,
    Triangles,
    make_triangles,
)
from ..core.geometry import aabb_of_triangles

# "kernel" (per-ray traversal kernel, kernels/walk.py — the default) |
# "frontier" | "frontier_q" (quantized CWBVH-style boxes) | "jnp" | "brute"
BACKENDS = ("kernel", "frontier", "frontier_q", "jnp", "brute")


@dataclasses.dataclass
class RayScene:
    """Flat (single-level) scene: reordered triangles + BVH.

    ``tris`` is in BVH slot order; ``tris.prim_id`` carries the original
    triangle ids so hits report stable ids across rebuilds.
    """

    tris: Triangles
    bvh: BVH
    use_bvh: bool = True       # validation switch (ray_scene.h:59)
    backend: str = "kernel"    # one of BACKENDS
    _frontier: FrontierScene | None = None
    _frontier_q: FrontierScene | None = None

    @property
    def num_tris(self) -> int:
        return self.tris.count

    @property
    def frontier(self) -> FrontierScene:
        """Frontier-backend tables, built lazily on first use."""
        if self._frontier is None:
            self._frontier = build_frontier_scene(self.bvh, self.tris)
        return self._frontier

    @property
    def frontier_q(self) -> FrontierScene:
        """Quantized (CWBVH-equivalent) frontier tables, built lazily."""
        if self._frontier_q is None:
            self._frontier_q = build_frontier_scene(
                self.bvh, self.tris, quantize=True
            )
        return self._frontier_q

    def _frontier_for_backend(self) -> FrontierScene:
        return self.frontier_q if self.backend == "frontier_q" else self.frontier

    def cast_rays(self, rays: Rays,
                  query_mask=ALL_LAYERS) -> tuple[Hits, RayStats]:
        """Batched closest-hit cast (ray_scene.h:96-131 semantics).

        Routes to the per-ray traversal kernel, the frontier (dense BFS)
        backend, the jnp reference traversal, or the brute-force oracle
        (the analogue of the reference's CPU/GPU/AUTO dispatcher,
        src/dispatch/ray_dispatcher.h:124-181).
        """
        hits, stats, _ = self._cast(rays, query_mask, any_hit=False)
        return hits, stats

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS) -> jnp.ndarray:
        """Batched occlusion query (ray_scene.h:135-160 semantics)."""
        if not self.use_bvh or self.backend == "brute":
            return any_hit_brute(rays, self.tris, query_mask)
        return self._cast(rays, query_mask, any_hit=True)[2]

    def _cast(self, rays, query_mask, any_hit):
        if not self.use_bvh or self.backend == "brute":
            hits, stats = cast_rays_brute(rays, self.tris, query_mask)
            return hits, stats, hits.hit
        if self.backend in ("frontier", "frontier_q"):
            return cast_rays_frontier(
                rays, self._frontier_for_backend(), self.tris,
                int(query_mask), any_hit=any_hit,
            )
        if self.backend == "kernel":
            return cast_rays_walk(rays, self.bvh, self.tris, int(query_mask),
                                  any_hit=any_hit)
        if self.backend == "jnp":
            return cast_rays_bvh(rays, self.tris, self.bvh, query_mask,
                                 any_hit=any_hit)
        raise ValueError(f"unknown cast backend {self.backend!r}; "
                         f"expected one of {BACKENDS}")

    def refit(self, v0, v1, v2) -> "RayScene":
        """Refit the BVH to moved vertices (same topology/order).

        ``v0/v1/v2`` are (T,3) arrays in *original* triangle order; they are
        re-sorted into slot order with the build permutation, triangles are
        re-derived, and node AABBs are refit bottom-up — all in ONE jitted
        device computation (no host round trip; scene_tlas.h:180-196 is the
        reference's O(N) refit this replaces).
        """
        tris, bvh = _refit_jit(
            self.bvh, self.tris,
            jnp.asarray(v0, jnp.float32), jnp.asarray(v1, jnp.float32),
            jnp.asarray(v2, jnp.float32),
        )
        # Drop lazily-built frontier caches: they embed copies of the
        # pre-refit boxes/triangles and would silently serve stale
        # geometry (same bug class as the TLAS _two_level cache).
        return dataclasses.replace(
            self, tris=tris, bvh=bvh, _frontier=None, _frontier_q=None,
        )


@jax.jit
def _refit_jit(bvh, old_tris, v0, v1, v2):
    perm = bvh.tri_order
    tris = make_triangles(
        v0[perm], v1[perm], v2[perm],
        prim_id=old_tris.prim_id, layers=old_tris.layers,
    )
    tmin, tmax = aabb_of_triangles(tris.v0, tris.v1, tris.v2)
    return tris, refit_bvh(bvh, tmin, tmax)


def build_scene(v0, v1, v2, layers=None, prim_id=None, use_bvh=True,
                backend="kernel") -> RayScene:
    """Build a flat scene from (T,3) vertex arrays.

    The BVH build runs on host; the returned SoA arrays are device-resident.
    Mirrors ``RayScene::build`` (ray_scene.h:62-86).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown cast backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    from .. import _tune_malloc

    _tune_malloc()  # lazy, once: large-buffer heap reuse for this build
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    bvh = build_bvh(v0, v1, v2)
    host = getattr(bvh, "host", None)
    perm = host["tri_order"] if host else np.asarray(bvh.tri_order)
    if prim_id is None:
        prim_id = np.arange(t, dtype=np.int32)
    else:
        prim_id = np.asarray(prim_id, np.int32)
    if layers is None:
        layers = np.full((t,), ALL_LAYERS, np.int32)
    else:
        layers = np.asarray(layers, np.int32)
    # Derive edges/normals in numpy: host math plus one device put per
    # array instead of ~10 small eager device ops per build.
    pv0, pv1, pv2 = v0[perm], v1[perm], v2[perm]
    e1 = pv1 - pv0
    e2 = pv2 - pv0
    nrm = np.cross(e1, e2)
    nlen = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.where(nlen > 0.0, nlen, 1.0)
    tris = Triangles(
        v0=jnp.asarray(pv0), edge1=jnp.asarray(e1), edge2=jnp.asarray(e2),
        normal=jnp.asarray(nrm.astype(np.float32)),
        prim_id=jnp.asarray(prim_id[perm]), layers=jnp.asarray(layers[perm]),
    )
    return RayScene(tris=tris, bvh=bvh, use_bvh=use_bvh, backend=backend)


def build_scene_from_tri_array(tri_array, **kw) -> RayScene:
    """Convenience: build from a (T, 3, 3) vertex array (mesh loader output)."""
    tri_array = np.asarray(tri_array, np.float32)
    return build_scene(tri_array[:, 0], tri_array[:, 1], tri_array[:, 2], **kw)
