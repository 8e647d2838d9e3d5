"""Wavefront path tracer tests — protocol + statistical parity vs the
iterative tracer."""

import numpy as np
import jax.numpy as jnp

from messyerraytracer.render.camera import CameraParams, generate_rays
from messyerraytracer.render.pathtrace import PathTracer, PathTraceParams
from messyerraytracer.render.shade import (
    make_environment,
    make_lights,
    make_materials,
)
from messyerraytracer.render.wavefront import WavefrontPathTracer
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes


def setup_scene():
    tris = np.concatenate(
        [meshes.cornell_room(4.0),
         meshes.uv_sphere(0.8, 8, 16, center=(0, -1.2, 0))]
    )
    scene = build_scene_from_tri_array(tris, backend="brute")
    lights = make_lights(
        [
            {"type": 0, "direction": (0.3, 1.0, 0.5), "energy": 1.3},
            {"type": 1, "position": (1.0, 1.2, 1.0), "energy": 4.0,
             "range": 8.0},
        ]
    )
    env = make_environment()
    mats = make_materials([[0.7, 0.65, 0.6]])
    cam = CameraParams.look_at((0, 0, 5.4), (0, 0, 0), fov_degrees=60)
    rays = generate_rays(cam, 16, 12)
    return scene, lights, env, mats, rays


class TestWavefront:
    def test_frame_finite_and_lit(self):
        scene, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        img = np.asarray(wf.trace_frame(rays, max_bounces=2))
        assert img.shape == (192, 3)
        assert np.isfinite(img).all()
        assert img.min() >= 0.0
        assert img.mean() > 0.01

    def test_deferred_nee_shadowing(self):
        # Direct light through the deferred protocol must be <= the
        # unshadowed contribution and strictly less somewhere (the sphere
        # casts a shadow in the room).
        scene, lights, env, mats, rays = setup_scene()
        env0 = make_environment(
            sky_zenith=(0, 0, 0), sky_horizon=(0, 0, 0), sky_ground=(0, 0, 0),
            ambient_energy=0.0,
        )
        wf = WavefrontPathTracer(scene, lights, env0, mats)
        img = np.asarray(wf.trace_frame(rays, max_bounces=0))
        # single bounce, no sky/ambient: all energy is deferred-NEE direct
        # light resolved by Connect + finalize
        assert img.max() > 0.01  # lit somewhere
        # statistical sanity: not everything fully lit (shadow exists)
        assert (img.sum(axis=1) < 1e-5).sum() > 3

    def test_miss_at_bounce0_is_exact_sky(self):
        # Rays that never hit anything must accumulate EXACTLY
        # throughput(=1) * sky at bounce 0 and stay untouched by the
        # deferred-NEE/finalize machinery (pt_shade.comp.glsl:598-647
        # inactive-path semantics).
        from messyerraytracer.render.shade import sky_color

        scene, lights, env, mats, _ = setup_scene()
        cam = CameraParams.look_at((0, 20, 0), (0, 30, 5), fov_degrees=50)
        rays = generate_rays(cam, 8, 6)  # camera above the room, looking up
        wf = WavefrontPathTracer(scene, lights, env, mats)
        img = np.asarray(wf.trace_frame(rays, max_bounces=3))
        expect = np.asarray(sky_color(rays.direction, env))
        assert np.allclose(img, expect, rtol=1e-5, atol=1e-6)

    def test_finalize_resolves_last_bounce_nee(self):
        # At max_bounces the Shade stage still STORES pending NEE; only
        # the finalize pass multiplies it by Connect's visibility
        # (pt_shade.comp.glsl:598-635).  Replaying the stages by hand and
        # dropping the finalize must lose that energy.
        scene, lights, env, mats, rays = setup_scene()
        env0 = make_environment(
            sky_zenith=(0, 0, 0), sky_horizon=(0, 0, 0),
            sky_ground=(0, 0, 0), ambient_energy=0.0,
        )
        wf = WavefrontPathTracer(scene, lights, env0, mats)
        full = np.asarray(wf.trace_frame(rays, max_bounces=0))

        state = wf.generate(rays, 0)
        hits = wf.extend(state)
        state = wf.shade(state, hits, 0, 0)
        state = wf.connect(state)
        without_finalize = np.asarray(state.accum)
        with_finalize = np.asarray(
            state.accum
            + jnp.where(state.visibility[:, None], state.pending_nee, 0.0)
        )
        assert np.allclose(full, with_finalize, rtol=1e-5, atol=1e-6)
        # the deferred direct light is REAL energy the finalize adds
        assert with_finalize.sum() > without_finalize.sum() + 1e-3

    def test_single_jit_frame_matches_eager_stages(self):
        # The production single-dispatch jitted frame (kernel backend)
        # must equal the eager per-stage path bit-for-bit in RNG usage
        # (same PCG32 streams) and match numerically.
        tris = np.concatenate(
            [meshes.cornell_room(4.0),
             meshes.uv_sphere(0.8, 8, 16, center=(0, -1.2, 0))]
        )
        scene = build_scene_from_tri_array(tris)  # kernel backend
        _, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        jit_img = np.asarray(wf.trace_frame(rays, max_bounces=2,
                                            sample_index=3))
        eager_img = np.asarray(wf._trace_frame_stages(rays, max_bounces=2,
                                                      sample_index=3))
        assert np.allclose(jit_img, eager_img, rtol=1e-4, atol=1e-5)
        # the carried-sort production frame must also match the legacy
        # per-wave-sorted eager path (same RNG streams, same estimator;
        # permuted execution order only)
        legacy_img = np.asarray(wf._trace_frame_stages(
            rays, max_bounces=2, sample_index=3, carried=False))
        assert np.allclose(jit_img, legacy_img, rtol=1e-4, atol=1e-5)

    def test_russian_roulette_terminates_and_stays_finite(self):
        # RR from bounce 2 (pt_shade.comp.glsl:753-764): deep-bounce
        # frames stay finite and unbiased-ish (energy does not blow up).
        scene, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        img2 = np.asarray(wf.trace_frame(rays, max_bounces=2))
        img8 = np.asarray(wf.trace_frame(rays, max_bounces=8))
        assert np.isfinite(img8).all() and (img8 >= 0).all()
        # extra bounces add bounded indirect energy, never runaway
        assert img8.mean() < img2.mean() * 3 + 1.0

    def test_sorted_waves_exact_vs_unsorted(self):
        # The in-frame octant-major coherence sort of bounce/shadow waves
        # (ray_dispatcher.h:130-150 semantics applied inside the PT
        # frame) is a pure permutation: sort -> cast -> unshuffle must be
        # EXACTLY the unsorted cast, hit-for-hit.
        tris = np.concatenate(
            [meshes.cornell_room(4.0),
             meshes.uv_sphere(0.8, 8, 16, center=(0, -1.2, 0))]
        )
        scene = build_scene_from_tri_array(tris)
        _, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        assert wf.bounds is not None  # scene BVH root wired as sort bounds
        state = wf.generate(rays, 5)
        hits = wf.extend(state)
        state = wf.shade(state, hits, 0, 2)  # makes incoherent bounce rays
        h_uns = wf.extend(state, sort=False)
        h_srt = wf.extend(state, sort=True)
        assert np.array_equal(np.asarray(h_uns.prim_id),
                              np.asarray(h_srt.prim_id))
        assert np.array_equal(np.asarray(h_uns.t), np.asarray(h_srt.t))
        v_uns = np.asarray(wf.connect(state, sort=False).visibility)
        v_srt = np.asarray(wf.connect(state, sort=True).visibility)
        assert np.array_equal(v_uns, v_srt)

    def test_occluded_nee_is_dropped_exactly(self):
        # Deferred NEE must add pending ONLY where Connect proved
        # visibility; occluded pixels lose it entirely, not partially
        # (pt_shade.comp.glsl:598-635).  Verified as an exact protocol
        # identity over every pixel of a real shadow-casting frame.
        scene, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        state = wf.generate(rays, 1)
        hits = wf.extend(state)
        state = wf.shade(state, hits, 0, 3)
        state = wf.connect(state)
        vis = np.asarray(state.visibility)
        pend = np.asarray(state.pending_nee)
        acc_before = np.asarray(state.accum)
        hits2 = wf.extend(state)
        acc_after = np.asarray(wf.shade(state, hits2, 1, 3).accum)
        resolved = acc_after - acc_before  # NEE + bounce-1 sky/emission
        # occluded-but-pending pixels exist in this scene (real shadows)
        occluded = ~vis & (pend.sum(axis=1) > 1e-6)
        assert occluded.sum() > 0 and vis.sum() > 0
        # the resolved delta includes the pending term exactly where
        # visible: subtracting it must never go negative, and removing
        # it from an occluded pixel would (it was never added)
        expected_nee = np.where(vis[:, None], pend, 0.0)
        assert (resolved - expected_nee >= -1e-6).all()
        # pixels with NO other bounce-1 energy receive exactly the NEE
        miss2 = ~np.asarray(hits2.hit) & ~np.asarray(state.active)
        pure = miss2 & vis
        if pure.sum():
            assert np.allclose(resolved[pure], pend[pure],
                               rtol=1e-5, atol=1e-6)

    def test_rr_kill_freezes_path_energy(self):
        # A Russian-roulette-killed path (bounce >= 1,
        # pt_shade.comp.glsl:753-764) must stop accumulating bounce
        # energy: replaying further waves may only change pixels that
        # stayed active or had pending NEE in flight.
        scene, lights, env, mats, rays = setup_scene()
        env0 = make_environment(
            sky_zenith=(0, 0, 0), sky_horizon=(0, 0, 0),
            sky_ground=(0, 0, 0), ambient_energy=0.0,
        )
        wf = WavefrontPathTracer(scene, lights, env0, mats)
        state = wf.generate(rays, 9)
        for bounce in range(3):
            hits = wf.extend(state, sort=bounce > 0)
            state = wf.shade(state, hits, bounce, 8)
            state = wf.connect(state, sort=bounce > 0)
        a2 = np.asarray(state.active)
        acc2 = np.asarray(state.accum)
        dead = ~a2 & ~np.asarray(state.shadow_valid)
        assert dead.sum() > 0  # RR + misses really killed paths
        hits = wf.extend(state, sort=True)
        state3 = wf.shade(state, hits, 3, 8)
        # active never resurrects
        assert not (np.asarray(state3.active) & ~a2).any()
        # dead paths' pixels are bit-frozen through the next wave
        assert np.array_equal(np.asarray(state3.accum)[dead], acc2[dead])
        assert np.asarray(state3.pending_nee)[dead].sum() == 0.0

    def test_shadow_ray_protocol_invariants(self):
        # Shadow rays must be disabled (t_max < t_min) exactly where
        # shadow_valid is false, and carry dist-limited t_max for point
        # lights vs unbounded for directionals
        # (pt_shade.comp.glsl:697-717).
        scene, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        state = wf.generate(rays, 2)
        hits = wf.extend(state)
        state = wf.shade(state, hits, 0, 1)
        sv = np.asarray(state.shadow_valid)
        tmax = np.asarray(state.shadow_ray.t_max)
        tmin = np.asarray(state.shadow_ray.t_min)
        assert sv.any() and (~sv).any()
        assert (tmax[~sv] < tmin[~sv]).all()   # disabled, never cast
        assert (tmax[sv] > 0).all()
        # directions are unit for valid shadow rays
        d = np.asarray(state.shadow_ray.direction)[sv]
        assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)
        # pending energy only where a shadow ray exists
        assert np.asarray(state.pending_nee)[~sv].sum() == 0.0

    def test_multi_light_stochastic_nee_unbiased(self):
        # Uniform single-light picking scaled by light_count must equal
        # evaluating BOTH lights in expectation: duplicating one light K
        # times leaves the many-sample mean unchanged (up to MC noise).
        scene, _, env, mats, rays = setup_scene()
        env0 = make_environment(
            sky_zenith=(0, 0, 0), sky_horizon=(0, 0, 0),
            sky_ground=(0, 0, 0), ambient_energy=0.0,
        )
        one = {"type": 1, "position": (1.0, 1.2, 1.0), "energy": 4.0,
               "range": 8.0}
        wf1 = WavefrontPathTracer(scene, make_lights([one]), env0, mats)
        wf4 = WavefrontPathTracer(scene, make_lights([one] * 4), env0,
                                  mats)
        # duplicated lights: every pick evaluates the SAME light, so the
        # estimator is exact per sample, not just in expectation
        i1 = np.asarray(wf1.trace_frame(rays, max_bounces=0,
                                        sample_index=0))
        i4 = np.asarray(wf4.trace_frame(rays, max_bounces=0,
                                        sample_index=0))
        assert np.allclose(i4, 4.0 * i1, rtol=1e-4, atol=1e-5)

    def test_statistical_parity_vs_iterative(self):
        # Both integrators target the same estimator; their multi-sample
        # means must agree within Monte-Carlo noise.
        scene, lights, env, mats, rays = setup_scene()
        wf = WavefrontPathTracer(scene, lights, env, mats)
        it = PathTracer(scene, lights, env, mats)
        spp = 24
        acc_w = acc_i = None
        for s in range(spp):
            iw = np.asarray(wf.trace_frame(rays, max_bounces=2, sample_index=s))
            ii = np.asarray(
                it.trace_frame(PathTraceParams(16, 12, 2, sample_index=s), rays)
            )
            acc_w = iw if acc_w is None else acc_w + iw
            acc_i = ii if acc_i is None else acc_i + ii
        mean_w = acc_w / spp
        mean_i = acc_i / spp
        # clamp outliers (fireflies) before comparing means
        cw, ci = np.clip(mean_w, 0, 4), np.clip(mean_i, 0, 4)
        assert abs(cw.mean() - ci.mean()) / max(ci.mean(), 1e-6) < 0.25
        # pixelwise correlation must be strong
        corr = np.corrcoef(cw.reshape(-1), ci.reshape(-1))[0, 1]
        assert corr > 0.9


class TestInstancedPT:
    def test_frame_over_instanced_tlas(self):
        # full path-traced frame over the TRUE two-level TLAS (memory ~
        # meshes, never flattening): the reference's CPU PT traces
        # through the TLAS dispatcher (cpu_path_tracer.h:56-223 ->
        # scene_tlas.h:203-251)
        from messyerraytracer.accel.tlas import SceneTLAS

        def translate(t):
            m = np.zeros((3, 4), np.float32)
            m[:, :3] = np.eye(3)
            m[:, 3] = t
            return m

        room = meshes.cornell_room(4.0)
        ball = meshes.uv_sphere(0.7, 8, 16)
        tlas = SceneTLAS()
        rid = tlas.add_mesh(room)
        bid = tlas.add_mesh(ball)
        tlas.add_instance(rid, translate((0, 0, 0)))
        tlas.add_instance(bid, translate((0, -1.2, 0)))
        tlas.add_instance(bid, translate((1.2, -1.0, 0.5)))
        tlas.build_tlas()
        inst_scene = tlas.instanced_scene()

        lights = make_lights(
            [{"type": 1, "position": (0.5, 1.2, 1.0), "energy": 4.0,
              "range": 8.0}]
        )
        env = make_environment()
        mats = make_materials([[0.7, 0.65, 0.6]])
        cam = CameraParams.look_at((0, 0, 5.4), (0, 0, 0), fov_degrees=60)
        rays = generate_rays(cam, 16, 12)

        wf_i = WavefrontPathTracer(inst_scene, lights, env, mats)
        img_i = np.asarray(wf_i.trace_frame(rays, max_bounces=1))
        assert img_i.shape == (192, 3)
        assert np.isfinite(img_i).all() and img_i.min() >= 0.0
        assert img_i.mean() > 0.01

        # statistical parity vs the same scene flattened: identical RNG
        # and wave structure, only the cast backend differs (object-space
        # vs world-space fp -> per-pixel noise, means must agree)
        wf_f = WavefrontPathTracer(tlas.flat, lights, env, mats)
        img_f = np.asarray(wf_f.trace_frame(rays, max_bounces=1))
        np.testing.assert_allclose(img_i.mean(axis=0), img_f.mean(axis=0),
                                   rtol=0.05, atol=0.01)
        close = np.isclose(img_i, img_f, rtol=1e-3, atol=1e-3).mean()
        assert close > 0.9, f"only {close:.2%} of pixels match"
