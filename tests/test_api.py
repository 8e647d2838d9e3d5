"""Service API / RayBatch / attributes / textures tests."""

import numpy as np
import jax.numpy as jnp
import pytest

from messyerraytracer.api.service import (
    MODE_ANY_HIT,
    RayBatch,
    RayQuery,
    RayTracerService,
    probe_cast,
)
from messyerraytracer.core.attributes import (
    interpolate_normal,
    interpolate_tangent,
    interpolate_uv,
    make_attributes,
    perturb_normal,
)
from messyerraytracer.core.types import make_rays
from messyerraytracer.render.textures import (
    TextureRegistry,
    sample_bilinear,
    sample_nearest,
)
from messyerraytracer.utils import meshes


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


@pytest.fixture(scope="module")
def service():
    svc = RayTracerService()
    sphere = meshes.uv_sphere(1.0, 8, 16)
    svc.register_mesh(sphere, translate((0, 0, 0)))
    svc.register_mesh(meshes.plane(20.0, y=-2.0), None)
    svc.build()
    return svc


class TestService:
    def test_cast_ray_dict(self, service):
        r = service.cast_ray((0.11, 0.07, 4), (0, 0, -1))
        assert r["hit"]
        assert r["distance"] == pytest.approx(3.0, abs=0.1)
        assert r["prim_id"] >= 0
        miss = service.cast_ray((0.11, 10, 4), (0, 0, -1))
        assert not miss["hit"] and miss["distance"] == float("inf")

    def test_submit_batch_with_stats(self, service):
        rng = np.random.default_rng(0)
        o = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
        d = rng.normal(size=(300, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        res = service.submit(RayQuery(rays=make_rays(o, d)))
        assert res.hits is not None and res.stats is not None
        assert res.elapsed_ms > 0
        s = service.get_last_stats()
        assert s["rays_cast"] == 300
        assert s["backend"] == "kernel"

    def test_any_hit_mode(self, service):
        rays = make_rays(
            np.float32([[0.11, 0.07, 4], [0.11, 10, 4]]),
            np.float32([[0, 0, -1], [0, 0, -1]]),
        )
        res = service.submit(RayQuery(rays=rays, mode=MODE_ANY_HIT))
        assert bool(res.hit_flags[0]) and not bool(res.hit_flags[1])

    def test_async_submit_collect(self, service):
        rays = make_rays((0.11, 0.07, 4), (0, 0, -1))
        ticket = service.submit_async(RayQuery(rays=rays))
        res = service.collect_async(ticket)
        assert bool(res.hits.hit[0])

    def test_backend_switch_and_fallback(self, service):
        service.set_backend("jnp")
        r = service.cast_ray((0.11, 0.07, 4), (0, 0, -1))
        assert r["hit"]
        service.set_backend("auto")
        assert service.get_backend() == "kernel"

    def test_frontier_backends_reachable(self, service):
        # the documented 5-backend switch must accept the frontier modes
        for b in ("frontier", "frontier_q"):
            service.set_backend(b)
            r = service.cast_ray((0.11, 0.07, 4), (0, 0, -1))
            assert r["hit"]
        service.set_backend("auto")

    def test_refit_after_transform(self):
        svc = RayTracerService()
        iid = svc.register_mesh(meshes.uv_sphere(1.0, 8, 16))
        svc.build()
        assert svc.cast_ray((0.11, 0.07, 4), (0, 0, -1))["hit"]
        svc.set_transform(iid, translate((5, 0, 0)))
        svc.refit()
        assert not svc.cast_ray((0.11, 0.07, 4), (0, 0, -1))["hit"]
        assert svc.cast_ray((5.11, 0.07, 4), (0, 0, -1))["hit"]

    def test_ray_batch(self, service):
        b = RayBatch(service)
        b.add_ray((0.11, 0.07, 4), (0, 0, -1))
        b.add_ray((0.11, 10, 4), (0, 0, -1))
        b.add_ray_ex((0.11, 0.07, 4), (0, 0, -1), 1e-3, 1.0)  # t_max clips
        assert b.size == 3
        b.cast()
        assert b.is_hit(0) and not b.is_hit(1) and not b.is_hit(2)
        assert b.get_distance(0) == pytest.approx(3.0, abs=0.1)
        assert np.linalg.norm(b.get_normal(0)) == pytest.approx(1.0, abs=1e-4)

    def test_probe_cast(self, service):
        m = translate((0.11, 0.07, 4))  # probe looking along -Z
        r = probe_cast(service, m)
        assert r["hit"] and r["distance"] == pytest.approx(3.0, abs=0.1)


class TestAttributes:
    def test_uv_interpolation(self):
        uv = np.zeros((1, 3, 2), np.float32)
        uv[0] = [[0, 0], [1, 0], [0, 1]]
        attrs = make_attributes(1, uv=uv)
        pid = jnp.asarray([0], jnp.int32)
        out = interpolate_uv(
            attrs, pid, jnp.asarray([0.25]), jnp.asarray([0.5])
        )
        np.testing.assert_allclose(np.asarray(out[0]), [0.25, 0.5], atol=1e-6)

    def test_normal_interpolation_normalized(self):
        nrm = np.zeros((1, 3, 3), np.float32)
        nrm[0] = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]
        attrs = make_attributes(1, normals=nrm)
        out = interpolate_normal(
            attrs, jnp.asarray([0]), jnp.asarray([0.3]), jnp.asarray([0.3])
        )
        assert np.linalg.norm(np.asarray(out[0])) == pytest.approx(1.0, abs=1e-5)

    def test_tangent_fallback(self):
        attrs = make_attributes(2)  # zero tangents
        t, sign, has = interpolate_tangent(
            attrs, jnp.asarray([0, 1]), jnp.asarray([0.2, 0.3]),
            jnp.asarray([0.1, 0.2]),
        )
        assert not bool(has[0])
        np.testing.assert_allclose(np.asarray(t[0]), [1, 0, 0], atol=1e-6)

    def test_perturb_normal_identity(self):
        # flat normal-map sample (0,0,1) leaves the normal unchanged
        n = jnp.asarray([[0.0, 1.0, 0.0]])
        t = jnp.asarray([[1.0, 0.0, 0.0]])
        out = perturb_normal(n, t, jnp.asarray([1.0]),
                             jnp.asarray([[0.0, 0.0, 1.0]]))
        np.testing.assert_allclose(np.asarray(out[0]), [0, 1, 0], atol=1e-6)


class TestTextures:
    def test_atlas_and_sampling(self):
        reg = TextureRegistry(size=8)
        checker = np.zeros((8, 8, 3), np.float32)
        checker[::2, ::2] = 1.0
        checker[1::2, 1::2] = 1.0
        tid = reg.add(checker)
        atlas = reg.build()
        assert atlas.count == 2 and tid == 1
        ids = jnp.asarray([1, 1, 0], jnp.int32)
        u = jnp.asarray([0.0625, 0.1875, 0.5])  # texel centers 0 and 1
        v = jnp.asarray([0.0625, 0.0625, 0.5])
        out = np.asarray(sample_nearest(atlas, ids, u, v))
        np.testing.assert_allclose(out[0], [1, 1, 1], atol=1e-6)
        np.testing.assert_allclose(out[1], [0, 0, 0], atol=1e-6)
        np.testing.assert_allclose(out[2], [1, 1, 1], atol=1e-6)  # white tex

    def test_bilinear_interpolates(self):
        reg = TextureRegistry(size=4)
        grad = np.zeros((4, 4, 3), np.float32)
        grad[:, :, 0] = np.linspace(0, 1, 4)[None, :]
        tid = reg.add(grad)
        atlas = reg.build()
        ids = jnp.asarray([tid], jnp.int32)
        # halfway between texel 1 (x=0.333) and texel 2 (x=0.667)
        out = np.asarray(
            sample_bilinear(atlas, ids, jnp.asarray([0.5]), jnp.asarray([0.5]))
        )
        assert 0.3 < out[0, 0] < 0.7

    def test_resample_on_register(self):
        reg = TextureRegistry(size=16)
        tid = reg.add(np.ones((33, 7, 3), np.float32) * 0.5)
        atlas = reg.build()
        assert atlas.data.shape == (2, 16, 16, 3)
        assert float(atlas.data[tid].mean()) == pytest.approx(0.5)


class TestSerialization:
    def test_save_load_roundtrip(self, tmp_path):
        from messyerraytracer.scene.serialize import load_scene, save_scene
        from messyerraytracer.scene.scene import build_scene_from_tri_array
        from messyerraytracer.core.brute import cast_rays_brute

        scene = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16))
        p = str(tmp_path / "scene.npz")
        save_scene(p, scene)
        loaded = load_scene(p)
        assert loaded.backend == scene.backend
        assert loaded.num_tris == scene.num_tris
        rng = np.random.default_rng(5)
        o = rng.uniform(-3, 3, (128, 3)).astype(np.float32)
        d = rng.normal(size=(128, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays = make_rays(o, d)
        h1, _ = scene.cast_rays(rays)
        h2, _ = loaded.cast_rays(rays)
        np.testing.assert_array_equal(
            np.asarray(h1.prim_id), np.asarray(h2.prim_id)
        )
        np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t))
