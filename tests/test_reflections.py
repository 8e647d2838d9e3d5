"""RT reflections pipeline tests."""

import numpy as np
import jax.numpy as jnp

from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.render.reflections import (
    ReflectionSettings,
    RTReflections,
)
from messyerraytracer.render.shade import make_environment
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def mirror_floor_scene():
    # a floor plane and a sphere above it: floor pixels should reflect the
    # sphere
    tris = np.concatenate(
        [meshes.plane(20.0, y=0.0, subdiv=2),
         meshes.uv_sphere(1.0, 10, 20, center=(0, 1.5, 0))]
    )
    return build_scene_from_tri_array(tris, backend="brute")


class TestReflections:
    def setup_method(self):
        self.scene = mirror_floor_scene()
        self.env = make_environment(
            sky_zenith=(1, 0, 0), sky_horizon=(1, 0, 0), sky_ground=(1, 0, 0)
        )  # red sky so reflections are identifiable
        self.w, self.h = 48, 36
        cam = CameraParams.look_at((0, 2.5, 7), (0, 0.5, 0), fov_degrees=55)
        self.rays = generate_rays(cam, self.w, self.h)
        self.hits, _ = self.scene.cast_rays(self.rays)

    def test_trace_produces_reflection_colors(self):
        rt = RTReflections(self.scene, self.env)
        refl = rt.trace(self.hits, self.rays.direction, self.w, self.h)
        arr = np.asarray(refl)
        assert arr.shape == (self.h, self.w, 3)
        assert np.isfinite(arr).all()
        # floor reflects red sky somewhere
        assert arr[..., 0].max() > 0.5

    def test_spatial_denoise_smooths(self):
        rt = RTReflections(self.scene, self.env)
        rng = np.random.default_rng(0)
        noisy = jnp.asarray(
            rng.uniform(0, 1, (self.h, self.w, 3)).astype(np.float32)
        )
        depth = jnp.ones((self.h, self.w, 1), jnp.float32)
        normal = jnp.broadcast_to(
            jnp.asarray([0.0, 1.0, 0.0]), (self.h, self.w, 3)
        )
        out = np.asarray(rt.denoise_spatial(noisy, depth, normal))
        # uniform guides -> plain 5x5 box blur: variance drops a lot
        assert out.var() < np.asarray(noisy).var() * 0.3

    def test_temporal_accumulation_and_reject(self):
        rt = RTReflections(self.scene, self.env,
                           ReflectionSettings(temporal_blend=0.5))
        a = jnp.zeros((4, 4, 3), jnp.float32)
        b = jnp.ones((4, 4, 3), jnp.float32)
        d = jnp.ones((4, 4, 1), jnp.float32)
        first = rt.temporal(a, d)
        np.testing.assert_allclose(np.asarray(first), 0.0)
        second = np.asarray(rt.temporal(b, d))
        np.testing.assert_allclose(second, 0.5)  # EMA blend
        # big depth change -> reject history, take current frame
        d2 = jnp.full((4, 4, 1), 100.0, jnp.float32)
        third = np.asarray(rt.temporal(b, d2))
        np.testing.assert_allclose(third, 1.0)

    def test_composite_fresnel_weighting(self):
        rt = RTReflections(self.scene, self.env)
        base = jnp.zeros((2, 2, 3), jnp.float32)
        refl = jnp.ones((2, 2, 3), jnp.float32)
        rough = jnp.zeros((2, 2), jnp.float32)
        hm = jnp.ones((2, 2), jnp.float32)
        grazing = rt.composite(base, refl, jnp.zeros((2, 2)), rough, hm)
        head_on = rt.composite(base, refl, jnp.ones((2, 2)), rough, hm)
        # grazing angles reflect much more than head-on (Schlick)
        assert float(grazing.mean()) > float(head_on.mean()) * 5

    def test_full_pipeline(self):
        rt = RTReflections(self.scene, self.env)
        base = jnp.full((self.h, self.w, 3), 0.2, jnp.float32)
        rough = jnp.full((self.h, self.w), 0.1, jnp.float32)
        out1 = rt.render(self.hits, self.rays.direction, base, rough,
                         self.w, self.h)
        out2 = rt.render(self.hits, self.rays.direction, base, rough,
                         self.w, self.h)
        for out in (out1, out2):
            arr = np.asarray(out)
            assert arr.shape == (self.h, self.w, 3)
            assert np.isfinite(arr).all()
        # reflections added energy over the base color somewhere
        assert np.asarray(out2).max() > 0.25
