"""Debug layer: draw modes, per-ray exact heatmaps, BVH wireframe."""

import numpy as np

from messyerraytracer.debug.debug import (
    DRAW_DISTANCE,
    DRAW_HEATMAP,
    DRAW_LAYERS,
    DRAW_NORMALS,
    DRAW_OVERHEAT,
    DRAW_RAYS,
    bvh_wireframe,
    cast_debug_rays,
    per_ray_cost_heatmap,
)
from messyerraytracer.render.camera import debug_grid_rays
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def small_scene(backend="jnp"):
    tris = np.concatenate([
        meshes.uv_sphere(1.0, 8, 16),
        meshes.plane(8.0, y=-1.5, subdiv=4),
    ])
    return build_scene_from_tri_array(tris, backend=backend)


class TestDrawModes:
    def test_all_modes_produce_colors(self):
        scene = small_scene()
        for mode in (DRAW_RAYS, DRAW_NORMALS, DRAW_DISTANCE, DRAW_HEATMAP,
                     DRAW_OVERHEAT, DRAW_LAYERS):
            d = cast_debug_rays(scene, (0, 0, 4), (0, 0, -1), 16, 12, 60.0,
                                draw_mode=mode)
            assert d.colors.shape == (192, 3)
            assert np.isfinite(d.colors).all()
            assert (d.colors >= 0).all() and (d.colors <= 1).all()
        assert d.hit_rate > 0.2

    def test_heatmap_is_per_ray(self):
        # rays that miss everything must be cooler than rays through the
        # sphere center: per-ray exact stats, not a batch-average fill
        scene = small_scene()
        d = cast_debug_rays(scene, (0, 0, 4), (0, 0, -1), 16, 12, 60.0,
                            draw_mode=DRAW_HEATMAP)
        colors = d.colors.reshape(12, 16, 3)
        # corner ray (sky) vs center ray (sphere): different colors
        assert not np.allclose(colors[0, 0], colors[6, 8])


class TestPerRayCost:
    def test_counts_match_stats_totals(self):
        scene = small_scene()
        rays = debug_grid_rays((0, 0, 4), (0, 0, -1), 16, 12, 60.0)
        colors, tt, nv = per_ray_cost_heatmap(scene, rays)
        assert tt.shape == (192,) and nv.shape == (192,)
        from messyerraytracer.accel.frontier import cast_rays_frontier

        _, stats, _ = cast_rays_frontier(rays, scene.frontier, scene.tris)
        assert abs(tt.sum() - float(stats.tri_tests)) < 1e-3
        assert abs(nv.sum() - float(stats.bvh_nodes_visited)) < 1e-3

    def test_sphere_costs_more_than_sky(self):
        scene = small_scene()
        rays = debug_grid_rays((0, 0, 4), (0, 0, -1), 16, 12, 60.0)
        _, tt, _ = per_ray_cost_heatmap(scene, rays)
        grid = tt.reshape(12, 16)
        assert grid[6, 8] > grid[0, 0]  # center (sphere) vs corner (sky)


class TestWireframe:
    def test_wireframe_segments(self):
        scene = small_scene()
        segs, depth = bvh_wireframe(scene.bvh, max_depth=3)
        assert segs.ndim == 3 and segs.shape[1:] == (2, 3)
        assert segs.shape[0] == depth.shape[0]  # depth tag per segment
        assert segs.shape[0] % 12 == 0          # 12 edges per box
        assert (depth <= 3).all()

    def test_leaves_only(self):
        scene = small_scene()
        segs, depth = bvh_wireframe(scene.bvh, leaves_only=True)
        n_leaves = int((np.asarray(scene.bvh.count) > 0).sum())
        assert depth.shape[0] == 12 * n_leaves
