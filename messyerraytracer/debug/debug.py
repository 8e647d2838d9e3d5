"""Debug visualization + stats — rewrite of ``RayTracerDebug``.

The reference draws per-ray lines and BVH wireframes into an ImmediateMesh
with 7 draw modes (src/godot/raytracer_debug.h:55-63); headless output
is *images and arrays* instead (SURVEY.md descope note): each draw mode
becomes a per-ray color array over the debug grid, and the BVH wireframe
becomes an exported line-segment array.

Draw modes (raytracer_debug.h:55-63): RAYS, NORMALS, DISTANCE, HEATMAP,
OVERHEAT, BVH, LAYERS.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.types import Rays
from ..render.camera import debug_grid_rays

DRAW_RAYS = 0
DRAW_NORMALS = 1
DRAW_DISTANCE = 2
DRAW_HEATMAP = 3
DRAW_OVERHEAT = 4
DRAW_BVH = 5
DRAW_LAYERS = 6


@dataclasses.dataclass
class DebugCastResult:
    """Everything cast_debug_rays produces: hits, per-ray colors for the
    selected mode, and the perf summary the reference prints
    (raytracer_debug.cpp:647-668)."""

    rays: Rays
    hits: object
    colors: np.ndarray          # (N, 3) float in [0,1] per draw mode
    tri_tests_per_ray: float
    nodes_per_ray: float
    hit_rate: float
    elapsed_ms: float
    grid: tuple                 # (w, h)


def _heat_color(t: np.ndarray) -> np.ndarray:
    """Blue -> green -> red heat ramp for cost visualization."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(2.0 * t - 1.0, 0.0, 1.0)
    g = 1.0 - np.abs(2.0 * t - 1.0)
    b = np.clip(1.0 - 2.0 * t, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def cast_debug_rays(
    scene,
    origin,
    forward,
    grid_w: int = 16,
    grid_h: int = 12,
    fov_degrees: float = 60.0,
    draw_mode: int = DRAW_RAYS,
    heatmap_max: float = 64.0,
    overheat_threshold: float = 32.0,
) -> DebugCastResult:
    """The BASELINE config #1/#5 entry point
    (RayTracerDebug::cast_debug_rays, raytracer_debug.cpp:539-669).

    Generates the camera-basis ray grid, casts it with stats, and maps the
    results to per-ray colors for the chosen draw mode.
    """
    import time

    rays = debug_grid_rays(origin, forward, grid_w, grid_h, fov_degrees)
    t0 = time.perf_counter()
    hits, stats = scene.cast_rays(rays)
    jnp.asarray(hits.t).block_until_ready()
    elapsed = (time.perf_counter() - t0) * 1e3

    n = rays.count
    hit = np.asarray(hits.hit)
    t = np.asarray(hits.t)
    nrm = np.asarray(hits.normal)
    tri_per_ray = float(stats.avg_tri_tests_per_ray())
    nodes_per_ray = float(stats.avg_nodes_per_ray())

    if draw_mode == DRAW_RAYS:
        colors = np.where(hit[:, None], [0.2, 1.0, 0.2], [0.4, 0.4, 0.4])
    elif draw_mode == DRAW_NORMALS:
        colors = np.where(hit[:, None], nrm * 0.5 + 0.5, 0.0)
    elif draw_mode == DRAW_DISTANCE:
        tmax = t[hit].max() if hit.any() else 1.0
        d = np.where(hit, 1.0 - np.clip(t / max(tmax, 1e-6), 0, 1), 0.0)
        colors = np.repeat(d[:, None], 3, axis=1)
    elif draw_mode in (DRAW_HEATMAP, DRAW_OVERHEAT):
        # per-RAY exact cost (what OVERHEAT/HEATMAP mean in the reference,
        # raytracer_debug.cpp:607-618).  Kernel-backend scenes read the
        # counters straight out of the traversal kernel; others use the
        # frontier per-ray counters.
        tt = _per_ray_tri_tests(scene, rays)
        if tt is None:  # no frontier tables (e.g. brute-only scene)
            tt = np.full(n, tri_per_ray, np.float32)
        if draw_mode == DRAW_HEATMAP:
            colors = _heat_color(tt / heatmap_max)
        else:
            over = tt > overheat_threshold
            colors = np.where(
                over[:, None], [1.0, 0.1, 0.1], [0.2, 0.8, 0.2]
            )
    elif draw_mode == DRAW_LAYERS:
        lay = np.asarray(hits.hit_layers).astype(np.uint32)
        h = (lay * np.uint32(2654435761)) & np.uint32(0xFFFFFF)
        colors = np.stack(
            [
                (h & 0xFF) / 255.0,
                ((h >> 8) & 0xFF) / 255.0,
                ((h >> 16) & 0xFF) / 255.0,
            ],
            axis=-1,
        ) * hit[:, None]
    else:  # DRAW_BVH falls back to ray colors; wireframe via bvh_wireframe()
        colors = np.where(hit[:, None], [0.2, 1.0, 0.2], [0.4, 0.4, 0.4])

    return DebugCastResult(
        rays=rays,
        hits=hits,
        colors=np.asarray(colors, np.float32),
        tri_tests_per_ray=tri_per_ray,
        nodes_per_ray=nodes_per_ray,
        hit_rate=float(stats.hit_rate()),
        elapsed_ms=elapsed,
        grid=(grid_w, grid_h),
    )


def _per_ray_tri_tests(scene, rays: Rays):
    """Per-ray exact triangle-test counts.

    Kernel-backend scenes: the counts come out of the traversal kernel
    itself (the tests it performed for each ray, at no extra cost).
    Other backends use the frontier dense-BFS counters (per-ray
    traversal-exact, small batches).  Returns None when the scene has no
    tables for either."""
    if getattr(scene, "backend", None) == "kernel":
        return per_ray_cost_heatmap(scene, rays)[1]
    try:
        fs = scene.frontier
    except (AttributeError, AssertionError):
        return None
    from ..accel.frontier import cast_rays_frontier

    _, _, _, per_ray = cast_rays_frontier(
        rays, fs, scene.tris, return_per_ray_stats=True
    )
    return np.asarray(per_ray["tri_tests"], np.float32)


def per_ray_cost_heatmap(scene, rays: Rays, heatmap_max: float = 64.0,
                         backend: str | None = None):
    """Exact per-ray cost colors (the reference's per-ray stats path,
    raytracer_debug.cpp:607-618).

    backend=None reads the traversal kernel's own counters when the
    scene casts through it and the frontier backend otherwise; pass
    "kernel" or "frontier" to force one.

    Returns (colors (N,3), tri_tests (N,), nodes (N,)); both counters
    are per-ray EXACT on both paths.
    """
    if backend is None:
        backend = ("kernel" if getattr(scene, "backend", None) == "kernel"
                   else "frontier")
    if backend == "kernel":
        from ..kernels.walk import cast_rays_walk

        _, _, _, per_ray = cast_rays_walk(rays, scene.bvh, scene.tris,
                                          return_per_ray=True)
        tt_np = np.asarray(per_ray["tri_tests"], np.float32)
        nodes = np.asarray(per_ray["node_visits"], np.float32)
    else:
        from ..accel.frontier import cast_rays_frontier

        _, _, _, per_ray = cast_rays_frontier(
            rays, scene.frontier, scene.tris, return_per_ray_stats=True
        )
        tt_np = np.asarray(per_ray["tri_tests"], np.float32)
        nodes = np.asarray(per_ray["nodes_visited"], np.float32)
    colors = _heat_color(tt_np / heatmap_max)
    return colors, tt_np, nodes


def bvh_wireframe(bvh, max_depth: int | None = None, leaves_only=False):
    """Export BVH node boxes as line segments for inspection
    (``_draw_bvh_wireframe``, raytracer_debug.cpp:457-533).

    Returns (segments (S, 2, 3) float32, depth (S,) int32) — 12 edges per
    selected node, tagged with tree depth for depth-hue coloring.
    """
    amin = np.asarray(bvh.aabb_min)
    amax = np.asarray(bvh.aabb_max)
    cnt = np.asarray(bvh.count)
    depth = np.zeros(amin.shape[0], np.int32)
    # recompute depth from levels
    for d, li in enumerate(bvh.levels):
        depth[np.asarray(li)] = d

    if leaves_only:
        sel = np.nonzero(cnt > 0)[0]
    elif max_depth is not None:
        sel = np.nonzero(depth <= max_depth)[0]
    else:
        sel = np.arange(amin.shape[0])

    mn, mx = amin[sel], amax[sel]
    # 8 corners per box
    c = np.empty((len(sel), 8, 3), np.float32)
    k = 0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                c[:, k, 0] = mx[:, 0] if cx else mn[:, 0]
                c[:, k, 1] = mx[:, 1] if cy else mn[:, 1]
                c[:, k, 2] = mx[:, 2] if cz else mn[:, 2]
                k += 1
    edges = [
        (0, 1), (0, 2), (1, 3), (2, 3),  # z = min face (cz varies last idx)
        (4, 5), (4, 6), (5, 7), (6, 7),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    segs = np.stack(
        [np.stack([c[:, a], c[:, b]], axis=1) for a, b in edges], axis=1
    ).reshape(-1, 2, 3)
    seg_depth = np.repeat(depth[sel], len(edges))
    return segs.astype(np.float32), seg_depth.astype(np.int32)


def stats_summary(stats) -> dict:
    """GDScript-facing stats dict (RayTracerServer::get_last_stats,
    raytracer_server.cpp:376-391)."""
    return {
        "rays_cast": int(stats.rays_cast),
        "tri_tests": int(stats.tri_tests),
        "bvh_nodes_visited": int(stats.bvh_nodes_visited),
        "hits": int(stats.hits),
        "avg_tri_tests_per_ray": float(stats.avg_tri_tests_per_ray()),
        "avg_nodes_per_ray": float(stats.avg_nodes_per_ray()),
        "hit_rate": float(stats.hit_rate()),
    }
