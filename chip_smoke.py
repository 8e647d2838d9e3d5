"""Smoke test of the main path on one GPU (or the ray- and scene-sharded
paths on four).

    python chip_smoke.py                 # one card: phases 1-4
    python chip_smoke.py --four-cards    # four cards: phase 5 only

Phases (one process; any failure exits nonzero before the result line):

  1. service: ``RayTracerService`` answers the README quick-start
     ``cast_ray`` (unit sphere, t ~ 3, normal facing the ray), then
     registers the headline scene's 4 meshes and 215 instances, builds,
     and answers a 1080p ``submit`` and an any-hit query;
  2. casts at bench sizes, each parity-gated against the brute-force
     oracle (t rtol 1e-5, tie-aware prim_id, bench.parity): the
     instanced 1M TLAS and its flat twin at 1920x1080, the 99K composite
     and the 2M terrain at 1024x768 (``stack_drops == 0``);
  3. one ``WavefrontPathTracer`` frame, 640x480, 3 bounces: finite, with
     a nonzero counted wave-ray total;
  4. the card-marked tests (``pytest -m card``), run in this process so
     no second process competes for the card;
  5. ``--four-cards`` only: ``cast_rays_sharded`` over a 1-D mesh of 4
     cards on the 1M flat scene at 1080p against the one-card cast,
     ``render_step_sharded`` against the one-card render, and
     ``build_sharded_scene`` + ``cast_rays_scene_sharded`` against the
     one-card cast.

The last line printed is one JSON object: ``{"ok": true, "device":
{"platform": ..., "kind": ..., "count": ...}}``.  Without a GPU the
script exits nonzero and prints no result.
"""

import json
import os
import sys
import time

import numpy as np

import bench

RENDER_FRAME = (640, 480)   # render_step_sharded frame (four-card phase)


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed(fn):
    """(output, first-call seconds, one warm call's seconds)."""
    t, out = bench.measure(fn, runs=1)
    return out, t["first_call_s"], t["median_ms"] / 1e3


def phase_service(tlas_scene):
    """Quick-start cast, then the headline scene through the service."""
    import jax.numpy as jnp

    from messyerraytracer.api.service import (MODE_ANY_HIT, RayQuery,
                                              RayTracerService)
    from messyerraytracer.core.types import make_rays
    from messyerraytracer.utils import meshes

    svc = RayTracerService()
    svc.register_mesh(meshes.uv_sphere(1.0, 16, 32))
    svc.build()
    hit = svc.cast_ray(origin=(0, 0, 4), direction=(0, 0, -1))
    log(f"service quick-start: hit={hit['hit']} t={hit['distance']:.6f} "
        f"normal={np.round(hit['normal'], 4).tolist()}")
    check(hit["hit"] and abs(hit["distance"] - 3.0) < 0.05
          and hit["normal"][2] > 0.0, "quick-start cast_ray")

    mesh_list, inst = tlas_scene
    svc = RayTracerService()
    ids = {}
    for b, m in inst:
        if b not in ids:
            svc.register_mesh(mesh_list[b], m)
            ids[b] = len(svc.tlas.meshes) - 1
        else:
            svc.add_instance(ids[b], m)
    t0 = time.perf_counter()
    svc.build()
    build_s = time.perf_counter() - t0
    check(len(svc.tlas.meshes) == 4 and len(svc.tlas.instances) == 215,
          "service holds 4 meshes, 215 instances")
    rays = bench.block_swizzled_frame_rays(1920, 1080,
                                           bench.camera_headline())
    res = svc.submit(RayQuery(rays=rays, coherent=True))
    res = svc.submit(RayQuery(rays=rays, coherent=True))
    hr = float(jnp.mean(res.hits.hit))
    sub = bench.subsample(rays, 4096)
    ref, _, _, _ = svc.tlas.cast_rays_instanced(sub)
    got = svc.submit(RayQuery(rays=sub, coherent=True)).hits
    ok, det = bench.parity(got, ref)
    occ = svc.submit(RayQuery(rays=sub, mode=MODE_ANY_HIT)).hit_flags
    occ_ok = bool(np.array_equal(np.asarray(occ), np.asarray(ref.hit)))
    far = svc.cast_ray((0.0, 200.0, 0.0), (0.0, 1.0, 0.0))
    log(f"service headline: build {build_s:.2f} s, 1080p submit "
        f"{res.elapsed_ms:.2f} ms, hit rate {hr:.4f}, stack_drops "
        f"{int(res.stats.stack_drops)}, submit-vs-instanced parity {ok} "
        f"{det}, any-hit agrees {occ_ok}")
    check(ok and occ_ok and 0.2 < hr < 1.0 and not far["hit"]
          and int(res.stats.stack_drops) == 0, "service headline")
    check(bool(jnp.all(jnp.isfinite(res.hits.t))), "service t finite")


def phase_casts(tlas, flat, scene99, scene2m):
    """Bench-size casts, parity-gated against the oracle."""
    from messyerraytracer.core.brute import cast_rays_brute

    def gate(name, cast, tris, rays, n_sub, need_no_drops=True):
        sub = bench.subsample(rays, n_sub)
        (hits, stats), first, second = timed(lambda: cast(rays))
        hs, ss = cast(sub)
        hb, _ = cast_rays_brute(sub, tris)
        ok, det = bench.parity(hs, hb)
        drops = int(stats.stack_drops) + int(ss.stack_drops)
        hr = float(np.mean(np.asarray(hits.hit)))
        log(f"{name}: rays {rays.count}, first call {first:.3f} s, "
            f"warm {second * 1e3:.3f} ms, hit rate {hr:.4f}, "
            f"stack_drops {drops}, parity {ok} {det}")
        check(ok and hr > 0.05 and (drops == 0 or not need_no_drops),
              f"{name} parity")

    rays = bench.block_swizzled_frame_rays(1920, 1080,
                                           bench.camera_headline())
    gate("instanced 1M 1080p",
         lambda r: tlas.cast_rays_instanced(r)[:2], flat.tris, rays, 4096)
    gate("flat 1M 1080p", flat.cast_rays, flat.tris, rays, 4096)
    rays = bench.block_swizzled_frame_rays(1024, 768, bench.camera_99k())
    gate("flat 99K 1024x768", scene99.cast_rays, scene99.tris, rays, 4096)
    gate("terrain 2M 1024x768", scene2m.cast_rays, scene2m.tris, rays,
         2048)


def phase_path_tracer(scene99):
    import jax.numpy as jnp

    from messyerraytracer.render.shade import (
        LIGHT_DIRECTIONAL, default_materials, make_environment, make_lights)
    from messyerraytracer.render.wavefront import WavefrontPathTracer

    lights = make_lights([{
        "type": LIGHT_DIRECTIONAL, "direction": (-0.4, -1.0, -0.2),
        "color": (1.0, 1.0, 1.0), "energy": 1.5}])
    pt = WavefrontPathTracer(scene99, lights, make_environment(),
                             default_materials())
    rays = bench.block_swizzled_frame_rays(640, 480, bench.camera_99k())
    (img, waves), first, second = timed(lambda: pt.trace_frame(
        rays, max_bounces=3, sample_index=1, with_counts=True))
    finite = bool(jnp.all(jnp.isfinite(img)))
    log(f"path tracer 640x480x3: first call {first:.3f} s, warm "
        f"{second * 1e3:.3f} ms, wave rays {int(waves)}, finite {finite}, "
        f"mean {float(jnp.mean(img)):.4f}")
    check(img.shape == (rays.count, 3) and finite and int(waves) > 0
          and float(jnp.mean(img)) > 0.0, "path-traced frame")


def phase_card_tests():
    import pytest

    os.environ["MRT_CARD_TESTS"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main([os.path.join(here, "tests", "test_card.py"), "-q",
                      "-m", "card",
                      "-p", "no:cacheprovider", "-p", "no:randomly"])
    log(f"card tests: pytest exit {int(rc)}")
    check(int(rc) == 0, "card tests")


def phase_four_cards():
    """Ray-sharded and scene-sharded casts over 4 cards against one."""
    import jax
    import jax.numpy as jnp

    from messyerraytracer.parallel.sharding import (
        build_sharded_scene, cast_rays_scene_sharded, cast_rays_sharded,
        make_mesh, render_step_sharded)
    from messyerraytracer.render.shade import make_environment, make_lights
    from messyerraytracer.scene.scene import build_scene_from_tri_array

    check(len(jax.devices()) >= 4, "four cards visible")
    mesh = make_mesh(4)
    mesh_list, inst = bench.headline_meshes()
    world = np.concatenate([
        (np.asarray(mesh_list[b]) @ m[:3, :3].T + m[:3, 3]).astype(
            np.float32) for b, m in inst])
    flat = build_scene_from_tri_array(world)
    rays = bench.block_swizzled_frame_rays(1920, 1080,
                                           bench.camera_headline())
    (h1, s1), _, t1 = timed(lambda: flat.cast_rays(rays))
    (h4, s4, _), first, t4 = timed(
        lambda: cast_rays_sharded(rays, flat, mesh))
    pid_eq = bool(np.array_equal(np.asarray(h4.prim_id),
                                 np.asarray(h1.prim_id)))
    t_ok = bool(np.allclose(np.asarray(h4.t), np.asarray(h1.t), rtol=1e-5))
    log(f"ray-sharded 1M 1080p: 4 cards {t4 * 1e3:.3f} ms (first "
        f"{first:.3f} s), 1 card {t1 * 1e3:.3f} ms, prim_id equal "
        f"{pid_eq}, t rtol 1e-5 {t_ok}, hits {int(s4.hits)} vs "
        f"{int(s1.hits)}")
    check(pid_eq and t_ok and int(s4.hits) == int(s1.hits),
          "ray-sharded cast")

    lights = make_lights([{"type": 0, "direction": (0.3, 1.0, 0.4),
                           "energy": 1.2}])
    env = make_environment()
    cam = bench.camera_headline()
    w, h = RENDER_FRAME
    img4, _, tr4 = timed(lambda: render_step_sharded(
        flat, cam, w, h, mesh, lights=lights, env=env, max_bounces=2))
    one = make_mesh(1)
    img1, _, tr1 = timed(lambda: render_step_sharded(
        flat, cam, w, h, one, lights=lights, env=env, max_bounces=2))
    close = bool(np.allclose(np.asarray(img4), np.asarray(img1),
                             rtol=1e-4, atol=1e-5))
    log(f"render_step_sharded {w}x{h}x2: 4 cards {tr4 * 1e3:.3f} ms, "
        f"1 card {tr1 * 1e3:.3f} ms, allclose {close}, finite "
        f"{bool(jnp.all(jnp.isfinite(img4)))}")
    check(close, "sharded render step")

    stacked, meta, id_maps = build_sharded_scene(world, 4)
    (hs, ss), first, ts = timed(lambda: cast_rays_scene_sharded(
        rays, stacked, meta, id_maps, mesh))
    set_eq = bool(np.array_equal(np.asarray(hs.hit), np.asarray(h1.hit)))
    t_ok = bool(np.allclose(np.asarray(hs.t), np.asarray(h1.t), rtol=1e-5))
    log(f"scene-sharded 1M 1080p: {ts * 1e3:.3f} ms (first {first:.3f} s),"
        f" hit set equal {set_eq}, t rtol 1e-5 {t_ok}, stack_drops "
        f"{int(ss.stack_drops)}")
    check(set_eq and t_ok and int(ss.stack_drops) == 0,
          "scene-sharded cast")


def main(argv):
    four = "--four-cards" in argv[1:]
    import jax

    if jax.default_backend() != "gpu":
        log(f"no GPU: JAX backend is {jax.default_backend()!r}")
        return 1
    from messyerraytracer.utils.compile_cache import enable_compile_cache
    from messyerraytracer.scene.scene import build_scene_from_tri_array

    enable_compile_cache()
    device, smi = bench.card_info()
    log(smi)
    log(f"devices: {jax.devices()}")
    t_start = time.perf_counter()
    if four:
        phase_four_cards()
    else:
        tlas_scene = bench.headline_meshes()
        phase_service(tlas_scene)
        tlas, build_s = bench.headline_tlas()
        log(f"instanced build {build_s:.2f} s")
        flat = build_scene_from_tri_array(tlas._world_tris_np())
        scene99 = build_scene_from_tri_array(bench.composite_99k())
        scene2m = build_scene_from_tri_array(bench.terrain_2m())
        phase_casts(tlas, flat, scene99, scene2m)
        del tlas, flat, scene2m
        phase_path_tracer(scene99)
        phase_card_tests()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
