"""Renderer / shading / path tracer tests (fast brute backend)."""

import numpy as np
import jax.numpy as jnp
import pytest

from messyerraytracer.render import framebuffer as fbch
from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.render.renderer import RayRenderer, RenderSettings, halton
from messyerraytracer.render.pathtrace import (
    PathTracer,
    PathTraceParams,
    construct_onb,
    cosine_hemisphere_sample,
    pcg32_float,
    pcg32_seed,
)
from messyerraytracer.render.shade import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    distance_attenuation,
    fresnel_schlick,
    make_environment,
    make_lights,
    make_materials,
    sky_color,
    tonemap,
)
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def room_scene():
    room = meshes.cornell_room(4.0)
    sphere = meshes.uv_sphere(0.8, 8, 16, center=(0, -1.2, 0))
    scene_tris = np.concatenate([room, sphere])
    return build_scene_from_tri_array(scene_tris, backend="brute")


def sun():
    return make_lights(
        [{"type": LIGHT_DIRECTIONAL, "direction": (0.3, 1.0, 0.5),
          "color": (1, 1, 1), "energy": 1.2}]
    )


class TestShadeLib:
    def test_sky_gradient(self):
        env = make_environment(
            sky_zenith=(0, 0, 1), sky_horizon=(1, 1, 1), sky_ground=(0.2, 0.1, 0)
        )
        d = jnp.asarray([[0, 1, 0], [0, -1, 0], [1, 0, 0]], jnp.float32)
        c = np.asarray(sky_color(d, env))
        np.testing.assert_allclose(c[0], [0, 0, 1], atol=1e-6)   # zenith
        np.testing.assert_allclose(c[1], [0.2, 0.1, 0], atol=1e-6)  # ground
        np.testing.assert_allclose(c[2], [1, 1, 1], atol=1e-6)   # horizon

    def test_panorama_sky(self):
        pan = np.zeros((2, 4, 3), np.float32)
        pan[:, :, 0] = 1.0  # red everywhere
        env = make_environment(panorama=pan, panorama_energy=2.0)
        d = jnp.asarray([[0, 0, -1]], jnp.float32)
        c = np.asarray(sky_color(d, env))
        np.testing.assert_allclose(c[0], [2, 0, 0], atol=1e-5)

    def test_fresnel_bounds(self):
        assert float(fresnel_schlick(jnp.float32(1.0), jnp.float32(0.04))) == \
            pytest.approx(0.04)
        assert float(fresnel_schlick(jnp.float32(0.0), jnp.float32(0.04))) == \
            pytest.approx(1.0)

    def test_attenuation(self):
        # at range -> 0; at 0 -> 1
        assert float(distance_attenuation(jnp.float32(10.0), 10.0, 1.0)) == 0.0
        assert float(distance_attenuation(jnp.float32(0.0), 10.0, 1.0)) == 1.0

    def test_tonemap_modes(self):
        c = jnp.asarray([[0.5, 1.0, 4.0]], jnp.float32)
        for mode in range(5):
            out = np.asarray(tonemap(c, mode))
            assert np.isfinite(out).all()
            if mode > 0:
                assert (out <= 1.0 + 1e-5).all()
        # linear is identity
        np.testing.assert_allclose(np.asarray(tonemap(c, 0)), np.asarray(c))


class TestRenderer:
    def test_color_frame_structure(self):
        scene = room_scene()
        cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60)
        r = RayRenderer(
            scene, cam, lights=sun(),
            settings=RenderSettings(width=32, height=24),
        )
        fb = r.render_frame()
        img = fb.to_f32(fbch.COLOR)
        assert img.shape == (24, 32, 4)
        assert np.isfinite(img).all()
        assert (img >= 0).all()
        # room walls cover everything -> no pure-black pixels in center
        assert img[12, 16, :3].sum() > 0.01

    def test_aov_channels(self):
        scene = room_scene()
        cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60)
        chans = (
            fbch.NORMAL, fbch.DEPTH, fbch.BARYCENTRIC, fbch.POSITION,
            fbch.PRIM_ID, fbch.HIT_MASK, fbch.ALBEDO, fbch.WIREFRAME,
            fbch.UV, fbch.FRESNEL,
        )
        r = RayRenderer(
            scene, cam,
            settings=RenderSettings(width=16, height=12, channels=chans,
                                    accumulate=False),
        )
        fb = r.render_frame()
        for ch in chans:
            img = fb.to_f32(ch)
            assert img.shape == (12, 16, 4)
            assert np.isfinite(img).all(), ch
        # hit mask is 1 where the sphere/room is
        hm = fb.to_f32(fbch.HIT_MASK)
        assert hm[6, 8, 0] == 1.0

    def test_shadowing_darkens(self):
        # floor point under the sphere is shadowed from a top light
        scene = room_scene()
        lights = make_lights(
            [{"type": LIGHT_DIRECTIONAL, "direction": (0, 1, 0),
              "energy": 2.0}]
        )
        cam = CameraParams.look_at((0, 1.5, 4.5), (0, -1.6, 0), fov_degrees=50)
        s_on = RenderSettings(width=24, height=24, shadows=True,
                              accumulate=False)
        s_off = RenderSettings(width=24, height=24, shadows=False,
                               accumulate=False)
        img_on = RayRenderer(scene, cam, lights=lights,
                             settings=s_on).render_frame().to_f32()
        img_off = RayRenderer(scene, cam, lights=lights,
                              settings=s_off).render_frame().to_f32()
        # with shadows the frame must be strictly darker somewhere
        assert (img_off[..., :3] - img_on[..., :3]).max() > 0.05
        assert (img_on[..., :3] <= img_off[..., :3] + 1e-5).all()

    def test_accumulation_converges(self):
        scene = room_scene()
        cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60)
        r = RayRenderer(
            scene, cam, lights=sun(),
            settings=RenderSettings(width=16, height=12),
        )
        f1 = np.asarray(r.render_frame().get(fbch.COLOR))
        f2 = np.asarray(r.render_frame().get(fbch.COLOR))
        f3 = np.asarray(r.render_frame().get(fbch.COLOR))
        assert r._accum_frames == 3
        # accumulated frames stay bounded and finite
        for f in (f2, f3):
            assert np.isfinite(f).all()

    def test_halton(self):
        seq2 = [halton(i, 2) for i in range(1, 5)]
        np.testing.assert_allclose(seq2, [0.5, 0.25, 0.75, 0.125])


class TestPCG32:
    def test_matches_reference_scalar(self):
        # independent scalar implementation of pcg32 (path_state.h:52-61)
        def ref_next(state):
            old = state
            new = (old * 747796405 + 2891336453) & 0xFFFFFFFF
            word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & 0xFFFFFFFF
            return new, ((word >> 22) ^ word) & 0xFFFFFFFF

        def ref_seed(s):
            st = 0
            st, _ = ref_next(st)
            st = (st + s) & 0xFFFFFFFF
            st, _ = ref_next(st)
            return st

        seeds = np.asarray([7, 1009 + 7, 123456], np.uint32)
        state = pcg32_seed(jnp.asarray(seeds))
        for _ in range(3):
            state, out = pcg32_float(state)
        got = np.asarray(out)

        for i, s in enumerate(seeds):
            st = ref_seed(int(s))
            for _ in range(3):
                st, w = ref_next(st)
            expect = w / 4294967296.0
            assert got[i] == pytest.approx(expect, abs=1e-7)

    def test_uniformity(self):
        state = pcg32_seed(jnp.arange(4096, dtype=jnp.uint32))
        state, u = pcg32_float(state)
        u = np.asarray(u)
        assert 0.45 < u.mean() < 0.55
        assert u.min() >= 0.0 and u.max() < 1.0


class TestPathTracer:
    def test_onb_orthonormal(self):
        rng = np.random.default_rng(0)
        n = rng.normal(size=(64, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        t, b = construct_onb(jnp.asarray(n))
        t, b = np.asarray(t), np.asarray(b)
        for v, w in [(t, b), (t, n), (b, n)]:
            dots = np.abs(np.sum(v * w, axis=1))
            assert dots.max() < 1e-5
        assert np.abs(np.linalg.norm(t, axis=1) - 1).max() < 1e-5

    def test_cosine_sampling_distribution(self):
        n = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0]), (8192, 3)
        )
        state = pcg32_seed(jnp.arange(8192, dtype=jnp.uint32))
        state, u1 = pcg32_float(state)
        state, u2 = pcg32_float(state)
        d = np.asarray(cosine_hemisphere_sample(n, u1, u2))
        assert (d[:, 2] > 0).all()          # hemisphere
        # E[cos theta] = 2/3 for cosine-weighted
        assert abs(d[:, 2].mean() - 2 / 3) < 0.02

    def test_pt_frame_energy(self):
        scene = room_scene()
        cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60)
        rays = generate_rays(cam, 16, 12)
        pt = PathTracer(
            scene, sun(), make_environment(),
            make_materials([[0.7, 0.7, 0.7]]),
        )
        img = pt.trace_frame(PathTraceParams(16, 12, max_bounces=2), rays)
        arr = np.asarray(img)
        assert arr.shape == (192, 3)
        assert np.isfinite(arr).all()
        assert arr.min() >= 0.0
        assert arr.mean() > 0.005  # some light got through

    def test_pt_emissive_illuminates(self):
        # an emissive sphere must contribute light to the room with no
        # analytic lights at all (bounce lighting)
        room = meshes.cornell_room(4.0)
        sphere = meshes.uv_sphere(0.6, 8, 16, center=(0, 0.8, 0))
        tris = np.concatenate([room, sphere])
        scene = build_scene_from_tri_array(tris, backend="brute")
        # material 0 = walls, material 1 = emissive sphere
        mat_of_prim = np.zeros(tris.shape[0], np.int32)
        mat_of_prim[room.shape[0]:] = 1
        mats = make_materials(
            [[0.7, 0.7, 0.7], [1, 1, 1]],
            emission=[[0, 0, 0], [4, 4, 4]],
        )
        env = make_environment(
            sky_zenith=(0, 0, 0), sky_horizon=(0, 0, 0), sky_ground=(0, 0, 0),
            ambient_energy=0.0,
        )
        cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60)
        rays = generate_rays(cam, 16, 12)
        pt = PathTracer(scene, None, env, mats,
                        mat_id_of_prim=jnp.asarray(mat_of_prim))
        img = np.asarray(
            pt.trace_frame(PathTraceParams(16, 12, max_bounces=3), rays)
        )
        assert img.max() > 0.5    # emissive visible
        # indirect: pixels NOT on the sphere still receive energy
        direct_hit, _ = scene.cast_rays(rays)
        on_sphere = np.asarray(direct_hit.prim_id) >= room.shape[0]
        off = img[~on_sphere & np.asarray(direct_hit.hit)]
        assert off.sum() > 0.0
