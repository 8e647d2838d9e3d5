"""Benchmark harness: traversal kernel against the plain XLA paths, on the GPU.

    python bench.py                  # every cell, one JSON line each

Cells (each: the kernel's time and the plain-XLA rival's time, medians of
``RUNS`` runs after a warm-up call, compile time reported apart):

  * ``instanced_1m_1080p``: the 215-instance, 4-mesh, ~1M-world-triangle
    TLAS (BASELINE config #3/#4) at 1920x1080 — ``SceneTLAS.
    cast_rays_instanced`` against the frontier two-level cast
    (accel/tlas_frontier.py);
  * ``flat_1m_1080p``: its flattened twin — ``RayScene.cast_rays`` against
    the vmapped jnp stack walk (accel/traverse.py);
  * ``pt_99k_640x480_3b``: one ``WavefrontPathTracer`` frame, 3 bounces,
    over the 99K composite — kernel scene against the same frame with the
    jnp traversal.

Kernel-only extras: the 99K and 2M-terrain casts at 1024x768 (the 2M
scene must show ``stack_drops == 0``) and 512K incoherent rays through
the dispatcher.  Every cell's kernel result is parity-gated against the
brute-force oracle on a strided subsample (t rtol 1e-5, tie-aware
prim_id).  The script refuses to run without a GPU.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

BASELINE_CPU_MRAYS = 27.0  # reference SSE+ThreadPool path (BASELINE.md)
RUNS = 5


# ---------------------------------------------------------------------------
# scenes and rays shared with chip_smoke.py
# ---------------------------------------------------------------------------

def xf(tx, ty, tz, s=1.0):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = (tx, ty, tz)
    return m


def headline_meshes():
    """The 4 meshes and 215 instance transforms of the headline scene
    (BASELINE config #3: a TLAS over instanced BLAS meshes with world
    transforms, scene_tlas.h:140-176 build shape): 16 terrain tiles,
    60 high- and 99 low-resolution spheres, 40 rocks, ~1.02M world
    triangles.  Returns (meshes, [(mesh index, 4x4 transform)])."""
    from messyerraytracer.utils import meshes

    terrain = meshes.plane(20.0, y=0.0, subdiv=100)          # 20K tris
    terrain[:, :, 1] = (np.sin(terrain[:, :, 0] * 0.9)
                        * np.cos(terrain[:, :, 2] * 0.8))
    mesh_list = [terrain, meshes.uv_sphere(1.6, 64, 64),
                 meshes.uv_sphere(1.0, 32, 32), meshes.box((1.4, 1.0, 1.2))]
    rng = np.random.default_rng(11)
    inst = []
    for gx in range(4):
        for gz in range(4):
            inst.append((0, xf((gx - 1.5) * 20, 0.0, (gz - 1.5) * 20)))
    for _ in range(60):
        c = rng.uniform(-35, 35, 2)
        inst.append((1, xf(c[0], rng.uniform(1.5, 4.0), c[1],
                           s=rng.uniform(0.6, 1.4))))
    for _ in range(99):
        c = rng.uniform(-35, 35, 2)
        inst.append((2, xf(c[0], rng.uniform(0.8, 2.5), c[1],
                           s=rng.uniform(0.5, 1.5))))
    for _ in range(40):
        c = rng.uniform(-35, 35, 2)
        inst.append((3, xf(c[0], 0.5, c[1])))
    return mesh_list, inst


def headline_tlas():
    """Built SceneTLAS of the headline scene and its build seconds."""
    from messyerraytracer.accel.tlas import SceneTLAS

    mesh_list, inst = headline_meshes()
    t0 = time.perf_counter()
    tlas = SceneTLAS()
    ids = [tlas.add_mesh(m) for m in mesh_list]
    for b, m in inst:
        tlas.add_instance(ids[b], m)
    tlas.build_tlas()
    tlas.build_instanced()
    return tlas, time.perf_counter() - t0


def composite_99k():
    """Flat ~99K-triangle composite: wavy ground, a sphere, 2000 boxes."""
    from messyerraytracer.utils import meshes

    g = meshes.plane(40.0, y=0.0, subdiv=158)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.6) * np.cos(g[:, :, 2] * 0.5)) * 1.5
    sph = meshes.uv_sphere(4.0, 112, 112, center=(0, 6, 0))
    rng = np.random.default_rng(7)
    boxes = []
    for _ in range(2000):
        c = rng.uniform(-18, 18, 2)
        hgt = rng.uniform(0.5, 4.0)
        boxes.append(meshes.box(
            (rng.uniform(0.5, 2), hgt, rng.uniform(0.5, 2)),
            center=(c[0], hgt / 2, c[1])))
    return np.concatenate([g, sph] + boxes)


def terrain_2m():
    """2M-triangle wavy terrain (the capacity tier)."""
    from messyerraytracer.utils import meshes

    g = meshes.plane(40.0, y=0.0, subdiv=1004)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.7) * np.cos(g[:, :, 2] * 0.6)) * 1.5
    return g


def camera_headline():
    import messyerraytracer as mrt

    return mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)


def camera_99k():
    import messyerraytracer as mrt

    return mrt.CameraParams.look_at((0, 14, 30), (0, 2, 0), fov_degrees=60.0)


def block_swizzled_frame_rays(w, h, cam):
    """Frame rays in 32x32 raster blocks (the dispatcher's coherent
    order)."""
    import jax.numpy as jnp

    import messyerraytracer as mrt
    from messyerraytracer.dispatch.morton import (apply_permutation,
                                                  raster_block_permutation)

    rays = mrt.generate_rays(cam, w, h)
    return apply_permutation(rays,
                             jnp.asarray(raster_block_permutation(w, h, 32)))


def subsample(rays, n):
    """Strided sample covering the WHOLE frame (the first rays of a
    block-swizzled frame are all sky)."""
    from messyerraytracer.core.types import Rays

    idx = np.arange(n, dtype=np.int32) * (rays.count // n)
    return Rays(origin=rays.origin[idx], direction=rays.direction[idx],
                t_min=rays.t_min[idx], t_max=rays.t_max[idx])


def parity(hs, hb, rtol=1e-5):
    """t + prim_id parity against the oracle.

    prim_id may differ on shared-edge ties (a ray exactly on the common
    edge of two triangles): the oracle keeps the lowest index, a
    traversal the first it visits — both correct closest hits.  The card
    contracts FMAs, so tied t values agree only to rounding: a prim
    mismatch passes when t agrees within TIE_RTOL, any larger swap
    fails, and every ray's t must agree to ``rtol``.  Returns
    (ok, details)."""
    TIE_RTOL = 4e-6   # ~8 ulps at f32: formulation noise, not geometry
    ps, pb = np.asarray(hs.prim_id), np.asarray(hb.prim_id)
    ts, tb = np.asarray(hs.t), np.asarray(hb.t)
    tie = np.abs(ts - tb) <= TIE_RTOL * np.maximum(np.abs(tb), 1.0)
    pid_ok = bool(np.all((ps == pb) | tie))
    t_ok = bool(np.allclose(ts, tb, rtol=rtol))
    return pid_ok and t_ok, {
        "rays": int(ps.shape[0]), "oracle_hits": int((pb >= 0).sum()),
        "prim_equal": int((ps == pb).sum()),
        "t_max_rel_err": float(np.max(np.abs(ts - tb)
                                      / np.maximum(np.abs(tb), 1.0))),
    }


def measure(fn, runs=RUNS):
    """(timing dict, last output): the first call (compile + run) apart,
    then ``runs`` calls, each fenced with ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    q = np.percentile(np.asarray(times) * 1e3, [25, 50, 75])
    return {"first_call_s": first, "median_ms": float(statistics.median(
        times) * 1e3), "q1_ms": float(q[0]), "q3_ms": float(q[2]),
        "runs": runs}, out


def card_info():
    """(device dict, nvidia-smi 'name, power.limit' line)."""
    import jax

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}, smi


def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"no GPU: JAX backend is {jax.default_backend()!r}; this "
            "measures the card and never falls back to the CPU")


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def main():
    require_gpu()
    from messyerraytracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from messyerraytracer.accel.traverse import cast_rays_bvh
    from messyerraytracer.core.brute import cast_rays_brute
    from messyerraytracer.core.types import Rays
    from messyerraytracer.dispatch.dispatcher import RayDispatcher
    from messyerraytracer.render.shade import (
        LIGHT_DIRECTIONAL, default_materials, make_environment, make_lights)
    from messyerraytracer.render.wavefront import WavefrontPathTracer
    from messyerraytracer.scene.scene import build_scene_from_tri_array

    device, smi = card_info()
    print(f"# card: {smi}", flush=True)
    print(f"# devices: {jax.devices()}", flush=True)
    common = {"device": device, "card": smi}

    def emit(cell, **kw):
        print(json.dumps({"cell": cell, **kw, **common}), flush=True)

    # ---- instanced 1M at 1080p ------------------------------------------
    tlas, build_s = headline_tlas()
    world = tlas._world_tris_np()
    t0 = time.perf_counter()
    flat = build_scene_from_tri_array(world)
    build_flat_s = time.perf_counter() - t0
    rays = block_swizzled_frame_rays(1920, 1080, camera_headline())
    n = rays.count
    sub = subsample(rays, 4096)
    hb, _ = cast_rays_brute(sub, flat.tris)

    k_inst, out = measure(lambda: tlas.cast_rays_instanced(rays))
    ok_k, par_k = parity(tlas.cast_rays_instanced(sub)[0], hb)
    inst_cell = dict(
        rays=n, world_tris=int(world.shape[0]),
        instances=len(tlas.instances), build_s=build_s, kernel=k_inst,
        parity_kernel=ok_k, parity_detail=par_k,
        hit_rate=float(jnp.mean(out[0].hit)),
        stack_drops=int(out[1].stack_drops),
        mrays_kernel=n / k_inst["median_ms"] / 1e3,
        vs_baseline_cpu=n / k_inst["median_ms"] / 1e3 / BASELINE_CPU_MRAYS)

    # ---- flat 1M at 1080p -------------------------------------------------
    k_flat, out = measure(lambda: flat.cast_rays(rays))
    ok_k, par_k = parity(flat.cast_rays(sub)[0], hb)
    jnp_cast = jax.jit(lambda r: cast_rays_bvh(r, flat.tris, flat.bvh)[0])
    p_flat, _ = measure(lambda: jnp_cast(rays))
    ok_p, _ = parity(jnp_cast(sub), hb)
    emit("flat_1m_1080p", rays=n, tris=flat.num_tris, build_s=build_flat_s,
         kernel=k_flat, plain_xla=p_flat,
         plain_path="accel/traverse.py cast_rays_bvh",
         parity_kernel=ok_k, parity_plain=ok_p, parity_detail=par_k,
         tri_tests_per_ray=float(out[1].tri_tests) / n,
         nodes_per_ray=float(out[1].bvh_nodes_visited) / n,
         stack_drops=int(out[1].stack_drops),
         mrays_kernel=n / k_flat["median_ms"] / 1e3)
    del flat

    # ---- PT frame, 99K composite, 640x480, 3 bounces --------------------
    tris99 = composite_99k()
    scene99 = build_scene_from_tri_array(tris99)
    lights = make_lights([{
        "type": LIGHT_DIRECTIONAL, "direction": (-0.4, -1.0, -0.2),
        "color": (1.0, 1.0, 1.0), "energy": 1.5}])
    env, mats = make_environment(), default_materials()
    rays_pt = block_swizzled_frame_rays(640, 480, camera_99k())
    pt = WavefrontPathTracer(scene99, lights, env, mats)
    k_pt, out = measure(lambda: pt.trace_frame(
        rays_pt, max_bounces=3, sample_index=1, with_counts=True))
    img_k, waves = out
    scene99_jnp = build_scene_from_tri_array(tris99, backend="jnp")
    pt_j = WavefrontPathTracer(scene99_jnp, lights, env, mats)
    frame_j = jax.jit(lambda r: pt_j._trace_frame_stages(
        r, 3, 1, with_counts=True))
    p_pt, out_j = measure(lambda: frame_j(rays_pt))
    emit("pt_99k_640x480_3b", pixels=rays_pt.count, kernel=k_pt,
         plain_xla=p_pt, plain_path="wavefront frame over accel/traverse.py",
         wave_rays=int(waves), finite=bool(jnp.isfinite(img_k).all()),
         mean_abs_diff_vs_plain=float(jnp.mean(jnp.abs(img_k - out_j[0]))))

    # ---- kernel-only extras ---------------------------------------------
    rays99 = block_swizzled_frame_rays(1024, 768, camera_99k())
    sub99 = subsample(rays99, 4096)
    k99, out = measure(lambda: scene99.cast_rays(rays99))
    ok, par = parity(scene99.cast_rays(sub99)[0],
                     cast_rays_brute(sub99, scene99.tris)[0])
    emit("flat_99k_1024x768", rays=rays99.count, kernel=k99, parity=ok,
         parity_detail=par, stack_drops=int(out[1].stack_drops),
         mrays_kernel=rays99.count / k99["median_ms"] / 1e3)

    rng = np.random.default_rng(3)
    o = rng.uniform(-20, 20, (512 * 1024, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.standard_normal((512 * 1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rand = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                t_min=jnp.full((o.shape[0],), 1e-3, jnp.float32),
                t_max=jnp.full((o.shape[0],), 3e38, jnp.float32))
    disp = RayDispatcher(scene99)
    kinc, _ = measure(lambda: disp.cast_rays(rand))
    emit("incoherent_512k_99k", rays=rand.count, kernel=kinc,
         mrays_kernel=rand.count / kinc["median_ms"] / 1e3)
    del scene99, scene99_jnp

    scene2m = build_scene_from_tri_array(terrain_2m())
    rays2m = block_swizzled_frame_rays(1024, 768, camera_99k())
    sub2m = subsample(rays2m, 2048)
    k2m, out = measure(lambda: scene2m.cast_rays(rays2m))
    hs, s_sub = scene2m.cast_rays(sub2m)
    ok, par = parity(hs, cast_rays_brute(sub2m, scene2m.tris)[0])
    drops = int(out[1].stack_drops) + int(s_sub.stack_drops)
    emit("terrain_2m_1024x768", rays=rays2m.count, tris=scene2m.num_tris,
         kernel=k2m, parity=ok and drops == 0, parity_detail=par,
         stack_drops=drops, bvh_levels=len(scene2m.bvh.levels),
         mrays_kernel=rays2m.count / k2m["median_ms"] / 1e3)
    del scene2m

    # the plain-XLA two-level cast comes last: its frame-size pair lists
    # are the largest buffers of the run
    tlas.build_two_level()
    p_inst, _ = measure(lambda: tlas.cast_rays_two_level_fast(rays))
    ok_p, _ = parity(tlas.cast_rays_two_level_fast(sub)[0], hb)
    emit("instanced_1m_1080p", **inst_cell, plain_xla=p_inst,
         plain_path="accel/tlas_frontier.py cast_rays_tlas",
         parity_plain=ok_p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
