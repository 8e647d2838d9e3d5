"""Morton sort + dispatcher pipeline tests."""

import numpy as np
import jax.numpy as jnp

from messyerraytracer.core.brute import cast_rays_brute
from messyerraytracer.core.types import make_rays
from messyerraytracer.dispatch.morton import (
    apply_permutation,
    morton_encode_3d,
    morton_spread_10,
    raster_block_permutation,
    ray_direction_morton,
    sort_rays_by_direction,
    unshuffle_flags,
    unshuffle_hits,
)
from messyerraytracer.dispatch.dispatcher import RayDispatcher
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def random_rays(n, seed=0, extent=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


class TestMorton:
    def test_spread_matches_reference_bit_pattern(self):
        # morton_spread_10: 0b1101 -> 0b1001000001001 (ray_sort.h:41-50)
        v = jnp.asarray([0b1101], jnp.int32)
        out = int(morton_spread_10(v)[0])
        expect = 0
        for bit in range(10):
            if (0b1101 >> bit) & 1:
                expect |= 1 << (3 * bit)
        assert out == expect
        # 30-bit output for max input
        assert int(morton_spread_10(jnp.asarray([1023], jnp.int32))[0]) == 0x09249249

    def test_encode_interleaving(self):
        # x gets bits 2,5,8..., y bits 1,4,7..., z bits 0,3,6...
        x = jnp.asarray([1], jnp.int32)
        y = jnp.asarray([0], jnp.int32)
        z = jnp.asarray([0], jnp.int32)
        assert int(morton_encode_3d(x, y, z)[0]) == 0b100
        assert int(morton_encode_3d(y, x, z)[0]) == 0b010
        assert int(morton_encode_3d(y, z, x)[0]) == 0b001

    def test_direction_morton_locality(self):
        # Nearby directions share high Morton bits more than opposite ones.
        d = jnp.asarray(
            [[1, 0, 0], [0.99, 0.1, 0], [-1, 0, 0]], jnp.float32
        )
        keys = np.asarray(ray_direction_morton(d))
        assert abs(keys[0] - keys[1]) < abs(keys[0] - keys[2])

    def test_sort_unshuffle_roundtrip(self):
        rays = random_rays(777, seed=3)
        sorted_rays, perm = sort_rays_by_direction(rays)
        # permutation is a bijection
        assert sorted(np.asarray(perm).tolist()) == list(range(777))
        keys = np.asarray(ray_direction_morton(sorted_rays.direction))
        assert (np.diff(keys) >= 0).all()
        # flags roundtrip
        flags = jnp.asarray(np.arange(777) % 2 == 0)
        sorted_flags = flags[perm]
        back = unshuffle_flags(sorted_flags, perm)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(flags))

    def test_block_permutation(self):
        perm = raster_block_permutation(8, 4, block=2)
        assert sorted(perm.tolist()) == list(range(32))
        # first block is the 2x2 top-left pixels in raster coords 0,1,8,9
        assert sorted(perm[:4].tolist()) == [0, 1, 8, 9]


class TestDispatcher:
    def test_sorted_cast_matches_unsorted(self):
        scene = build_scene_from_tri_array(
            meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        )
        disp = RayDispatcher(scene)
        rays = random_rays(512, seed=5)
        # incoherent path (Morton sort + unshuffle)
        hits, _ = disp.cast_rays(rays, coherent=False)
        # reference: direct brute cast in original order
        ref, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(
            np.asarray(hits.prim_id), np.asarray(ref.prim_id)
        )
        # 1e-5: the kernel's per-component MT and the oracle's broadcast
        # MT round differently in the last ulps
        np.testing.assert_allclose(np.asarray(hits.t), np.asarray(ref.t), rtol=1e-5)
        # coherent hint path
        hits2, _ = disp.cast_rays(rays, coherent=True)
        np.testing.assert_array_equal(
            np.asarray(hits2.prim_id), np.asarray(ref.prim_id)
        )

    def test_small_batch_skips_sort(self):
        # < MIN_BATCH_FOR_SORTING: output order must be input order
        scene = build_scene_from_tri_array(
            meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        )
        disp = RayDispatcher(scene)
        rays = random_rays(64, seed=7)
        hits, _ = disp.cast_rays(rays)
        ref, _ = cast_rays_brute(rays, scene.tris)
        np.testing.assert_array_equal(
            np.asarray(hits.prim_id), np.asarray(ref.prim_id)
        )

    def test_windowed_cast_exact_parity(self):
        # Distance-windowed multi-pass cast (dispatcher.py::
        # _cast_windowed): window composition must be EXACT — same hits,
        # bit-identical t, vs the single full-range sorted cast — for
        # both coherence keys, including rays with finite t ranges that
        # straddle window boundaries.
        scene = build_scene_from_tri_array(
            np.concatenate([
                meshes.uv_sphere(radius=1.0, rings=8, segments=16),
                meshes.plane(8.0, y=-1.5, subdiv=6),
            ])
        )
        rays = random_rays(640, seed=11, extent=4.0)
        # finite, staggered per-ray ranges exercise the per-pass
        # [max(t_min,R_k-1), min(t_max,R_k)] clipping
        rng = np.random.default_rng(12)
        rays = type(rays)(
            origin=rays.origin, direction=rays.direction,
            t_min=jnp.asarray(rng.uniform(0, 0.5, 640).astype(np.float32)),
            t_max=jnp.asarray(
                np.where(rng.random(640) < 0.3,
                         rng.uniform(1, 6, 640), 3e38).astype(np.float32)
            ),
        )
        ref, ref_stats = RayDispatcher(scene).cast_rays(rays)
        for key in ("6d", "6d-origin"):
            disp = RayDispatcher(scene, sort=key,
                                 windows=(0.05, 0.2, 0.5))
            hits, stats = disp.cast_rays(rays)
            # tie-aware gate: the kernel breaks exact-t ties by drain
            # order, which depends on tile composition — different sort
            # orders may legally swap prims at bit-equal t
            got_t = np.asarray(hits.t)
            ref_t = np.asarray(ref.t)
            np.testing.assert_array_equal(got_t, ref_t)
            prim_ok = np.asarray(hits.prim_id) == np.asarray(ref.prim_id)
            tie_swap = ~prim_ok & (got_t == ref_t)
            assert (prim_ok | tie_swap).all()
            np.testing.assert_array_equal(
                np.asarray(hits.hit_layers)[prim_ok],
                np.asarray(ref.hit_layers)[prim_ok],
            )
            np.testing.assert_allclose(
                np.asarray(hits.position), np.asarray(ref.position),
                rtol=1e-5, atol=1e-6,
            )
            # stats contract: rays counted once, hits match
            assert int(stats.rays_cast) == 640
            assert int(stats.hits) == int(ref_stats.hits)

    def test_any_hit_dispatch(self):
        from messyerraytracer.core.brute import any_hit_brute

        scene = build_scene_from_tri_array(
            meshes.uv_sphere(radius=1.0, rings=8, segments=16)
        )
        disp = RayDispatcher(scene)
        rays = random_rays(512, seed=9)
        occ = disp.any_hit_rays(rays)
        ref = any_hit_brute(rays, scene.tris)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))

    def test_two_pass_proxy_parity(self, monkeypatch):
        """Two-pass incoherent cast (proxy caps + destination re-sort +
        rescue): results must EXACTLY match the single-pass dispatcher
        path — caps are conservative by construction and any proxy-vs-
        main formulation crack is rescued with an uncapped re-cast
        (dispatch/dispatcher.py::_cast_two_pass)."""
        from messyerraytracer.dispatch import dispatcher as dm

        monkeypatch.setattr(dm, "PROXY_MIN_BATCH", 256)
        scene = build_scene_from_tri_array(
            np.concatenate([
                meshes.uv_sphere(radius=1.2, rings=8, segments=14,
                                 center=(0, 1.2, 0)),
                meshes.plane(6.0, y=0.0, subdiv=10),
            ]),
        )
        rays = random_rays(768, seed=4)
        h0, s0 = RayDispatcher(scene, proxy=False).cast_rays(rays)
        h1, s1 = RayDispatcher(scene, proxy=True).cast_rays(rays)
        t0, t1 = np.asarray(h0.t), np.asarray(h1.t)
        np.testing.assert_allclose(t1, t0, rtol=1e-5)
        prim_ok = np.asarray(h0.prim_id) == np.asarray(h1.prim_id)
        tie = np.abs(t0 - t1) <= 4e-6 * np.maximum(np.abs(t0), 1.0)
        assert (prim_ok | tie).all()
        assert int(s1.rays_cast) == rays.count
        # proxy pass work is accounted for
        assert float(s1.tri_tests) >= float(s0.tri_tests) * 0.2
