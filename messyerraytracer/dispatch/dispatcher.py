"""RayDispatcher — the batched cast pipeline with coherence scheduling.

Rewrite of ``src/dispatch/ray_dispatcher.h:38-464``.  The reference
routes between CPU thread-pool and Vulkan backends; here the scene's
backend does the cast and the dispatcher's job is *coherence scheduling*
and stats:

  * incoherent batches >= MIN_BATCH_FOR_SORTING are Morton-sorted by
    direction, cast, and unshuffled (ray_dispatcher.h:130-150)
  * the ``coherent`` hint skips the sort (ray_query.h:72-76)
  * fully incoherent batches can additionally be cast through ascending
    DISTANCE WINDOWS (``windows``): pass k casts the live rays with
    t_max capped at radius R_k, so a spatially-sorted tile's traversal
    footprint is bounded by the window ball instead of the whole scene;
    rays that found a hit (provably the global closest — earlier windows
    covered [t_min, R_{k-1}] and found nothing) retire, survivors are
    compacted and re-cast with [R_k, R_{k+1}].  Exact-parity window
    composition (off by default).
  * everything is one jitted dispatch per cast — the analogue of the
    reference reusing persistent buffers to avoid per-frame allocation
    (ray_dispatcher.h:406-411) is letting XLA own the buffers
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import ALL_LAYERS, Hits, Rays, RayStats
from ..scene.scene import RayScene
from .morton import (
    ray_position_morton,
    sort_rays_6d,
    sort_rays_by_direction,
    unshuffle_flags,
    unshuffle_hits,
)

MIN_BATCH_FOR_SORTING = 256  # ray_dispatcher.h:423-427
PROXY_MIN_BATCH = 65536      # two-pass cast only pays off at frame scale
PROXY_DECIM = 8              # 1/8 triangle subset for the proxy pass
PROXY_SLACK = 1.001          # cap = proxy t x slack (>> kernel t rtol 1e-5)


# Jitted glue: the sort/cap/unshuffle pipelines run as single dispatches
# instead of one dispatch per eager primitive.
@partial(jax.jit, static_argnames=("octant_major",))
def _sort6d_jit(rays, lo, hi, octant_major=True):
    return sort_rays_6d(rays, lo, hi, octant_major=octant_major)


_unshuffle_hits_jit = jax.jit(unshuffle_hits)


@jax.jit
def _twopass_mid(sorted_rays, ph_t, ph_hit, lo, hi, diag):
    """Caps + destination keys + second sort (pass-1 -> pass-2 glue)."""
    cap = jnp.where(ph_hit, ph_t * PROXY_SLACK, sorted_rays.t_max)
    dest_t = jnp.where(ph_hit, ph_t,
                       jnp.minimum(sorted_rays.t_max, diag))
    dest = (sorted_rays.origin
            + sorted_rays.direction * dest_t[:, None])
    okey = ray_position_morton(dest, lo, hi).astype(jnp.uint32)
    d = sorted_rays.direction
    octant = ((d[:, 0] < 0).astype(jnp.uint32) * 4
              + (d[:, 1] < 0).astype(jnp.uint32) * 2
              + (d[:, 2] < 0).astype(jnp.uint32))
    p2 = jnp.argsort((okey << 3) | octant).astype(jnp.int32)
    from .morton import apply_permutation

    rays2 = apply_permutation(
        Rays(origin=sorted_rays.origin, direction=sorted_rays.direction,
             t_min=sorted_rays.t_min, t_max=cap), p2)
    return rays2, p2


@jax.jit
def _twopass_post(hits, hit_p, p2, perm):
    """Lost-hit detection + composed unshuffle permutation."""
    lost = hit_p[p2] & ~hits.hit
    return lost, jnp.count_nonzero(lost), perm[p2]


@partial(jax.jit, static_argnames=("bucket",))
def _rescue_select(rays2, lost, tmax_orig_p2, bucket):
    order = jnp.argsort(~lost, stable=True).astype(jnp.int32)
    sel = order[:bucket]
    ok = lost[sel]
    sub = Rays(
        origin=rays2.origin[sel],
        direction=rays2.direction[sel],
        t_min=rays2.t_min[sel],
        t_max=jnp.where(ok, tmax_orig_p2[sel], -1.0),
    )
    return sub, sel, ok


@jax.jit
def _rescue_merge(hits, hr, sel, ok, n):
    pos = jnp.where(ok, sel, jnp.int32(n))

    def sc(a, v):
        return a.at[pos].set(v, mode="drop")

    return Hits(
        t=sc(hits.t, hr.t),
        position=sc(hits.position, hr.position),
        normal=sc(hits.normal, hr.normal),
        u=sc(hits.u, hr.u), v=sc(hits.v, hr.v),
        prim_id=sc(hits.prim_id, hr.prim_id),
        hit_layers=sc(hits.hit_layers, hr.hit_layers),
    )


@dataclasses.dataclass
class RayDispatcher:
    """Owns a scene and routes batched casts through the coherence pipeline.

    ``backend`` mirrors the reference enum {CPU,GPU,AUTO}
    (ray_dispatcher.h:40-44) as the scene backends plus "auto", which
    casts through the scene's own backend.

    ``sort`` picks the incoherent-batch coherence key: "6d" (default)
    sorts octant-major with origin Morton minor; "6d-origin" keys
    origin-major (pairs with ``windows``); "direction" keeps the
    reference's key (ray_sort.h:64-76).

    ``windows`` — ascending scene-diagonal fractions for the distance-
    windowed multi-pass cast (empty = single full-range cast).  Applied
    only to sorted (incoherent) batches.
    """

    scene: RayScene
    backend: str = "auto"
    sort: str = "6d"
    windows: tuple = ()
    # Two-pass incoherent casts (_cast_two_pass): exact-parity; off by
    # default (no measurement on the card shows it paying off yet).
    proxy: bool = False

    def _scene_for(self) -> RayScene:
        if self.backend == "auto":
            return self.scene
        return dataclasses.replace(self.scene, backend=self.backend)

    def _scene_diag(self, scene) -> float:
        """Scene-AABB diagonal, cached per BVH (constant per scene; avoids
        a per-cast device readback)."""
        cache = getattr(self, "_diag_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_diag_cache", cache)
        key = id(scene.bvh)
        if key not in cache:
            host = getattr(scene.bvh, "host", None)
            if host is not None:
                lo, hi = host["aabb_min"][0], host["aabb_max"][0]
                cache[key] = float(np.linalg.norm(hi - lo))
            else:
                lo = scene.bvh.aabb_min[0]
                hi = scene.bvh.aabb_max[0]
                cache[key] = float(jnp.linalg.norm(hi - lo))
        return cache[key]

    def _scene_bounds(self, scene):
        """(lo, hi) device arrays without a per-cast device readback."""
        cache = getattr(self, "_bounds_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_bounds_cache", cache)
        key = id(scene.bvh)
        if key not in cache:
            host = getattr(scene.bvh, "host", None)
            if host is not None:
                cache[key] = (jnp.asarray(host["aabb_min"][0]),
                              jnp.asarray(host["aabb_max"][0]))
            else:
                cache[key] = (scene.bvh.aabb_min[0], scene.bvh.aabb_max[0])
        return cache[key]

    def _sorted(self, rays: Rays):
        if self.sort in ("6d", "6d-origin"):
            bvh = getattr(self.scene, "bvh", None)
            if bvh is not None:
                lo, hi = self._scene_bounds(self.scene)
                return _sort6d_jit(rays, lo, hi,
                                   octant_major=self.sort == "6d")
        return sort_rays_by_direction(rays)

    def cast_rays(
        self,
        rays: Rays,
        query_mask=ALL_LAYERS,
        coherent: bool = False,
    ) -> tuple[Hits, RayStats]:
        """Closest-hit batch cast (ray_dispatcher.h:124-181 semantics)."""
        scene = self._scene_for()
        if (not coherent) and rays.count >= MIN_BATCH_FOR_SORTING:
            sorted_rays, perm = self._sorted(rays)
            if self.windows and getattr(scene, "bvh", None) is not None:
                hits, stats = self._cast_windowed(scene, sorted_rays,
                                                  query_mask)
            elif (self.proxy and not self.windows
                    and rays.count >= PROXY_MIN_BATCH
                    and self._proxy_scene(scene) is not None):
                hits, stats, perm = self._cast_two_pass(
                    scene, sorted_rays, perm, query_mask)
            else:
                hits, stats = scene.cast_rays(sorted_rays, query_mask)
            return _unshuffle_hits_jit(hits, perm), stats
        return scene.cast_rays(rays, query_mask)

    # ---- two-pass incoherent cast (proxy caps + destination sort) -----
    def _proxy_scene(self, scene):
        """1/PROXY_DECIM triangle-subset scene for the cap pass, built
        lazily and cached per BVH.  The subset keeps REAL scene
        triangles (with their layers), so any proxy hit t is a valid
        upper bound on the ray's true closest t — caps are conservative
        and the two-pass composition is exact, never approximate."""
        if getattr(scene, "bvh", None) is None or \
                getattr(scene, "tris", None) is None:
            return None
        cache = getattr(self, "_proxy_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_proxy_cache", cache)
        key = id(scene.bvh)
        if key not in cache:
            from ..scene.scene import build_scene

            # one-time host copy of the slot-ordered triangle SoA
            # (3 transfers, cached; slot order is BVH-sorted so a
            # stride-K subset is spatially stratified)
            v0 = np.asarray(scene.tris.v0)[::PROXY_DECIM]
            e1 = np.asarray(scene.tris.edge1)[::PROXY_DECIM]
            e2 = np.asarray(scene.tris.edge2)[::PROXY_DECIM]
            lay = np.asarray(scene.tris.layers)[::PROXY_DECIM]
            if v0.shape[0] < 64:
                cache[key] = None   # tiny scene: proxy pass is pure loss
            else:
                cache[key] = build_scene(v0, v0 + e1, v0 + e2, layers=lay,
                                         backend=scene.backend)
        return cache[key]

    def _cast_two_pass(self, scene, sorted_rays, perm, query_mask):
        """Two-pass incoherent cast.

        Pass 1 casts the 6D-sorted rays against the triangle-SUBSET
        proxy scene: every proxy hit yields (a) a conservative t_max cap
        (the true closest t cannot exceed a real triangle hit) and (b)
        a destination estimate.  Pass 2 re-sorts by destination-Morton-
        major + direction-octant (rays that LAND together traverse the
        same lower tree, whatever their origins) and casts the full
        scene with the caps — the slab test ``tn <= cap`` prunes
        everything behind the proxy hit.  Exact parity: caps only shrink [t_min, t_max] to a range still
        containing the true closest hit; sorting is a permutation."""
        proxy = self._proxy_scene(scene)
        ph, pstats = proxy.cast_rays(sorted_rays, query_mask)
        lo, hi = self._scene_bounds(scene)
        diag = self._scene_diag(scene)
        rays2, p2 = _twopass_mid(sorted_rays, ph.t, ph.hit, lo, hi, diag)
        hits, stats = scene.cast_rays(rays2, query_mask)

        # Rescue pass: the proxy's BVH visits a triangle in another
        # order and can accept an edge-on hit the main pass rounds the
        # other way (the MT_BARY_EPS band, core/types.py) — then the cap
        # cut off the ray's real, farther hit.  Any ray the proxy hit
        # but the capped pass missed is re-cast UNCAPPED, restoring
        # parity with the single-pass cast by construction.
        lost, nlost_a, perm2 = _twopass_post(hits, ph.hit, p2, perm)
        nlost = int(nlost_a)
        if nlost:
            B = 8192
            if nlost > B:       # pathological: caps were useless anyway
                full = Rays(origin=rays2.origin, direction=rays2.direction,
                            t_min=rays2.t_min,
                            t_max=sorted_rays.t_max[p2])
                hits, stats2 = scene.cast_rays(full, query_mask)
                stats = stats + stats2
            else:
                sub, sel, ok = _rescue_select(
                    rays2, lost, sorted_rays.t_max[p2], B)
                hr, stats2 = scene.cast_rays(sub, query_mask)
                stats = stats + stats2
                hits = _rescue_merge(hits, hr, sel, ok, rays2.count)
        stats = RayStats(
            rays_cast=jnp.asarray(sorted_rays.count,
                                  stats.rays_cast.dtype),  # N once
            tri_tests=stats.tri_tests + pstats.tri_tests,
            bvh_nodes_visited=(stats.bvh_nodes_visited
                               + pstats.bvh_nodes_visited),
            hits=stats.hits,
            stack_drops=stats.stack_drops + pstats.stack_drops,
        )
        return hits, stats, perm2

    def _cast_windowed(self, scene, rays: Rays, query_mask):
        """Ascending-window multi-pass cast over PRE-SORTED rays.

        Window k covers per-ray t in [max(t_min, R_{k-1}), min(t_max,
        R_k)]; a closest hit found inside a window is the global closest
        (every earlier window was exhaustively searched and empty), so
        composition is exact, not approximate.  Survivors are compacted
        to the front (stable, preserving the coherence sort) and padded
        to the next power of two so recompiles stay O(log N) per scene.
        """
        n = rays.count
        diag = self._scene_diag(scene)
        # normalize: ascending, deduped, positive — mis-ordered or
        # duplicate fractions would re-search ranges proven empty
        # (full extra casts for nothing)
        fracs = sorted({float(f) for f in self.windows})
        assert all(f > 0.0 for f in fracs), \
            f"window fractions must be > 0, got {self.windows}"
        radii = [diag * f for f in fracs] + [float("inf")]
        o, d = rays.origin, rays.direction
        tmin0, tmax0 = rays.t_min, rays.t_max

        merged = None
        stats = None
        live = None
        r_prev = 0.0
        for r in radii:
            if merged is None:  # pass 1: all rays, no compaction
                sub = Rays(o, d, tmin0, jnp.minimum(tmax0, r))
                h, st = scene.cast_rays(sub, query_mask)
                newly = h.prim_id >= 0
                merged, stats = h, st
                live = ~newly & (tmax0 > r)
            else:
                nlive = int(jnp.count_nonzero(live))
                if nlive == 0:
                    break
                # stable live-first order keeps the coherence sort
                order = jnp.argsort(~live, stable=True).astype(jnp.int32)
                m = min(n, max(2048, 1 << (nlive - 1).bit_length()))
                sel = order[:m]
                t_lo = jnp.maximum(tmin0[sel], r_prev)
                t_hi = jnp.minimum(tmax0[sel], r)
                ok = live[sel] & (t_lo <= t_hi)
                sub = Rays(o[sel], d[sel], t_lo,
                           jnp.where(ok, t_hi, -1.0))
                h, st = scene.cast_rays(sub, query_mask)
                stats = stats + st
                newly = h.prim_id >= 0
                pos = jnp.where(newly, sel, n)  # n = dropped

                def sc(a, v, pos=pos):
                    return a.at[pos].set(v, mode="drop")

                merged = Hits(
                    t=sc(merged.t, h.t),
                    position=sc(merged.position, h.position),
                    normal=sc(merged.normal, h.normal),
                    u=sc(merged.u, h.u), v=sc(merged.v, h.v),
                    prim_id=sc(merged.prim_id, h.prim_id),
                    hit_layers=sc(merged.hit_layers, h.hit_layers),
                )
                retired = newly | (tmax0[sel] <= r)
                live = live.at[sel].set(live[sel] & ~retired,
                                        mode="drop")
            r_prev = r
        # rays_cast would multi-count re-cast survivors; report N once
        stats = RayStats(
            rays_cast=jnp.asarray(n, stats.rays_cast.dtype),
            tri_tests=stats.tri_tests,
            bvh_nodes_visited=stats.bvh_nodes_visited,
            hits=stats.hits,
        )
        return merged, stats

    def any_hit_rays(
        self,
        rays: Rays,
        query_mask=ALL_LAYERS,
        coherent: bool = False,
    ) -> jnp.ndarray:
        """Occlusion batch cast (ray_dispatcher.h:191-241 semantics)."""
        scene = self._scene_for()
        if (not coherent) and rays.count >= MIN_BATCH_FOR_SORTING:
            sorted_rays, perm = self._sorted(rays)
            occ = scene.any_hit_rays(sorted_rays, query_mask)
            return unshuffle_flags(occ, perm)
        return scene.any_hit_rays(rays, query_mask)
