"""Texture + vertex-attribute shading pipeline tests.

Covers the wiring of TriangleAttributes (triangle_uv.h / triangle_normals.h /
triangle_tangents.h) and the TextureAtlas (texture_sampler.h:45-88) into
extract_surface (shade_pass.h:482-560): UV interpolation, albedo texture
modulation, smooth normals, and TBN normal-map perturbation.
"""

import numpy as np
import jax.numpy as jnp

from messyerraytracer.core.attributes import (
    interpolate_normal,
    interpolate_tangent,
    interpolate_uv,
    make_attributes,
    perturb_normal,
)
from messyerraytracer.core.types import make_rays
from messyerraytracer.render import framebuffer as fbch
from messyerraytracer.render.camera import CameraParams
from messyerraytracer.render.renderer import RayRenderer, RenderSettings
from messyerraytracer.render.shade import (
    LIGHT_DIRECTIONAL,
    extract_surface,
    light_sample,
    light_sample_picked,
    make_environment,
    make_lights,
    make_materials,
)
from messyerraytracer.render.textures import (
    TextureRegistry,
    sample_bilinear,
)
from messyerraytracer.render.wavefront import WavefrontPathTracer
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def _floor_scene():
    """2-triangle unit floor plane with planar UVs and +X tangents."""
    tri = meshes.plane(2.0, y=0.0, subdiv=1)
    t = tri.shape[0]
    uv = (tri[:, :, [0, 2]] / 2.0 + 0.5).astype(np.float32)
    normals = np.broadcast_to(np.float32([0, 1, 0]), (t, 3, 3)).copy()
    tangents = np.broadcast_to(np.float32([1, 0, 0, 1]), (t, 3, 4)).copy()
    scene = build_scene_from_tri_array(tri, backend="brute")
    attrs = make_attributes(t, uv=uv, normals=normals, tangents=tangents)
    return scene, attrs, tri


def _down_rays(xs, zs, y=2.0):
    n = len(xs)
    o = np.stack([xs, np.full(n, y), zs], axis=1).astype(np.float32)
    d = np.broadcast_to(np.float32([0, -1, 0]), (n, 3))
    return make_rays(o, d)


class TestTexturedSurface:
    def test_albedo_texture_modulates(self):
        scene, attrs, _ = _floor_scene()
        # 2x2 checker texture: (0,0) quadrant dark, (1,1) bright
        tex = np.zeros((2, 2, 3), np.float32)
        tex[0, 0] = 0.25
        tex[1, 1] = 1.0
        reg = TextureRegistry(size=2)
        tid = reg.add(tex)
        atlas = reg.build()
        mats = make_materials([[1.0, 1.0, 1.0]], albedo_tex=[tid])

        rays = _down_rays(np.float32([-0.5, 0.5]), np.float32([-0.5, 0.5]))
        hits, _ = scene.cast_rays(rays)
        surf = extract_surface(
            hits, rays.direction, mats,
            jnp.zeros((2,), jnp.int32), attrs=attrs, atlas=atlas,
        )
        # manual expectation: sample the atlas at the interpolated UVs
        uv = interpolate_uv(attrs, jnp.maximum(hits.prim_id, 0),
                            hits.u, hits.v)
        want = sample_bilinear(atlas, jnp.full((2,), tid, jnp.int32),
                               uv[:, 0], uv[:, 1])
        np.testing.assert_allclose(np.asarray(surf.albedo), np.asarray(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(surf.uv), np.asarray(uv),
                                   rtol=1e-6)
        # the two sample points land in different checker cells
        assert not np.allclose(np.asarray(surf.albedo[0]),
                               np.asarray(surf.albedo[1]))

    def test_normal_map_perturbs_via_tbn(self):
        scene, attrs, _ = _floor_scene()
        # constant normal map tilted toward +x in tangent space
        ns = np.float32([0.4, 0.0, np.sqrt(1 - 0.16)])
        reg = TextureRegistry(size=2)
        nid = reg.add(np.broadcast_to(ns * 0.5 + 0.5, (2, 2, 3)).copy())
        atlas = reg.build()
        mats = make_materials([[0.8, 0.8, 0.8]], normal_tex=[nid])

        rays = _down_rays(np.float32([0.1]), np.float32([0.2]))
        hits, _ = scene.cast_rays(rays)
        surf = extract_surface(
            hits, rays.direction, mats,
            jnp.zeros((1,), jnp.int32), attrs=attrs, atlas=atlas,
        )
        pid = jnp.maximum(hits.prim_id, 0)
        sm = interpolate_normal(attrs, pid, hits.u, hits.v)
        tang, sign, _ = interpolate_tangent(attrs, pid, hits.u, hits.v)
        want = perturb_normal(sm, tang, sign, jnp.asarray(ns)[None, :], 1.0)
        np.testing.assert_allclose(np.asarray(surf.normal),
                                   np.asarray(want), atol=1e-5)
        # sanity: tilted away from straight up, toward +x (tangent axis)
        assert float(surf.normal[0, 0]) > 0.3
        assert float(surf.normal[0, 1]) < 1.0

    def test_no_tangent_skips_normal_map(self):
        scene, _, tri = _floor_scene()
        t = tri.shape[0]
        attrs = make_attributes(t)  # no tangents registered
        reg = TextureRegistry(size=2)
        nid = reg.add(np.full((2, 2, 3), 0.9, np.float32))
        mats = make_materials([[0.8, 0.8, 0.8]], normal_tex=[nid])
        rays = _down_rays(np.float32([0.1]), np.float32([0.2]))
        hits, _ = scene.cast_rays(rays)
        surf = extract_surface(
            hits, rays.direction, mats,
            jnp.zeros((1,), jnp.int32), attrs=attrs, atlas=reg.build(),
        )
        # default vertex normals are +Y; without tangents the map is skipped
        np.testing.assert_allclose(np.asarray(surf.normal[0]), [0, 1, 0],
                                   atol=1e-6)

    def test_untextured_material_unchanged_by_atlas(self):
        scene, attrs, _ = _floor_scene()
        reg = TextureRegistry(size=2)
        reg.add(np.zeros((2, 2, 3), np.float32))  # unrelated texture
        mats = make_materials([[0.3, 0.5, 0.7]])  # albedo_tex=0 -> white
        rays = _down_rays(np.float32([0.1]), np.float32([0.2]))
        hits, _ = scene.cast_rays(rays)
        surf = extract_surface(
            hits, rays.direction, mats,
            jnp.zeros((1,), jnp.int32), attrs=attrs, atlas=reg.build(),
        )
        np.testing.assert_allclose(np.asarray(surf.albedo[0]),
                                   [0.3, 0.5, 0.7], rtol=1e-6)


class TestRendererTexturedPipeline:
    def test_uv_and_albedo_channels(self):
        scene, attrs, _ = _floor_scene()
        checker = np.zeros((4, 4, 3), np.float32)
        checker[::2, ::2] = 1.0
        reg = TextureRegistry(size=4)
        tid = reg.add(checker)
        mats = make_materials([[1, 1, 1]], albedo_tex=[tid])
        cam = CameraParams.look_at((0, 3, 0.01), (0, 0, 0), fov_degrees=50)
        r = RayRenderer(
            scene, cam, lights=make_lights(
                [{"type": LIGHT_DIRECTIONAL, "direction": (0, 1, 0)}]
            ),
            materials=mats, attributes=attrs, atlas=reg.build(),
            settings=RenderSettings(
                width=16, height=12,
                channels=(fbch.COLOR, fbch.UV, fbch.ALBEDO),
            ),
        )
        fb = r.render_frame()
        uv = np.asarray(fb.get(fbch.UV))
        alb = np.asarray(fb.get(fbch.ALBEDO))
        assert np.isfinite(uv).all() and np.isfinite(alb).all()
        # hit pixels carry interpolated UVs in [0,1]
        hit = uv[:, :2].sum(axis=1) > 0
        assert hit.any()
        assert (uv[hit, :2] >= 0).all() and (uv[hit, :2] <= 1).all()
        # the checkerboard shows: both texel colors appear in ALBEDO
        vals = np.unique(alb[hit, 0].round(2))
        assert len(vals) >= 2

    def test_wavefront_textured_runs(self):
        scene, attrs, _ = _floor_scene()
        reg = TextureRegistry(size=2)
        tid = reg.add(np.full((2, 2, 3), 0.5, np.float32))
        mats = make_materials([[1, 1, 1]], albedo_tex=[tid])
        wf = WavefrontPathTracer(
            scene, make_lights(
                [{"type": LIGHT_DIRECTIONAL, "direction": (0, 1, 0)}]
            ),
            make_environment(), mats, attributes=attrs, atlas=reg.build(),
        )
        rays = _down_rays(np.float32([0.0, 0.3]), np.float32([0.0, -0.2]))
        img = np.asarray(wf.trace_frame(rays, max_bounces=1))
        assert np.isfinite(img).all()
        assert (img >= 0).all()


class TestPickedLightSampling:
    def test_matches_per_light_sampler(self):
        lights = make_lights(
            [
                {"type": 0, "direction": (0.2, 1.0, 0.1), "energy": 2.0},
                {"type": 1, "position": (1, 2, 0), "energy": 5.0,
                 "range": 8.0},
                {"type": 2, "position": (-1, 2, 1),
                 "direction": (0.2, -1, 0), "energy": 3.0, "range": 6.0,
                 "spot_angle": 0.7},
            ]
        )
        pos = jnp.asarray(
            np.random.default_rng(3).uniform(-1, 1, (16, 3)), jnp.float32
        )
        for li in range(lights.count):
            ldir, atten, valid, dist = light_sample(pos, lights, li)
            pick = jnp.full((16,), li, jnp.int32)
            g_ldir, g_atten, g_valid, g_dist, g_color, g_isdir = (
                light_sample_picked(pos, lights, pick)
            )
            np.testing.assert_allclose(np.asarray(g_ldir), np.asarray(ldir),
                                       atol=1e-6)
            np.testing.assert_allclose(np.asarray(g_atten),
                                       np.asarray(atten), atol=1e-6)
            np.testing.assert_array_equal(np.asarray(g_valid),
                                          np.asarray(valid))
            np.testing.assert_allclose(np.asarray(g_color),
                                       np.asarray(lights.color[li]
                                                  * jnp.ones((16, 3))),
                                       atol=1e-6)
