"""Headless demo gallery — counterparts of the reference's 11 Godot demos.

The reference ships interactive GDScript scenes (project/demos/: raytracer,
renderer, lighting, pbr, normal_map, panorama, layer, probe, gi_comparison,
rt_graphics, example).  Headless equivalents render the same scenarios
to PPM images:

    python demos/run_demos.py [demo ...]      # default: all
    ls demos/out/

Each demo prints the stats line its reference counterpart shows on its HUD.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import messyerraytracer as mrt  # noqa: E402
from messyerraytracer.api.service import RayTracerService, probe_cast  # noqa: E402
from messyerraytracer.debug.debug import (  # noqa: E402
    DRAW_NORMALS,
    cast_debug_rays,
    stats_summary,
)
from messyerraytracer.render import framebuffer as fbch  # noqa: E402
from messyerraytracer.render.camera import CameraParams, generate_rays  # noqa: E402
from messyerraytracer.render.pathtrace import PathTracer, PathTraceParams  # noqa: E402
from messyerraytracer.render.reflections import RTReflections  # noqa: E402
from messyerraytracer.utils.compile_cache import enable_compile_cache  # noqa: E402
from messyerraytracer.render.renderer import RayRenderer, RenderSettings  # noqa: E402
from messyerraytracer.render.shade import (  # noqa: E402
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    make_environment,
    make_lights,
    make_materials,
)
from messyerraytracer.scene.scene import build_scene_from_tri_array  # noqa: E402
from messyerraytracer.utils import meshes  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "out")
W, H = 320, 240


def save_ppm(name: str, img_u8: np.ndarray) -> str:
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.ppm")
    h, w = img_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img_u8[..., :3].astype(np.uint8).tobytes())
    return path


def room_with_sphere():
    return np.concatenate(
        [
            meshes.cornell_room(4.0),
            meshes.uv_sphere(0.8, 16, 32, center=(0, -1.2, 0)),
        ]
    )


def sun(energy=1.3):
    return make_lights(
        [{"type": LIGHT_DIRECTIONAL, "direction": (0.35, 1.0, 0.5),
          "energy": energy}]
    )


# ---------------------------------------------------------------------------
def demo_raytracer():
    """Server + debug grid (project/demos/raytracer_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere())
    d = cast_debug_rays(scene, (0, 0, 5.0), (0, 0, -1), 64, 48, 60.0,
                        draw_mode=DRAW_NORMALS)
    img = (d.colors.reshape(48, 64, 3) * 255).astype(np.uint8)
    print(f"  tri/ray={d.tri_tests_per_ray:.1f} hit_rate={d.hit_rate:.2f} "
          f"elapsed={d.elapsed_ms:.1f}ms")
    return save_ppm("raytracer", img)


def demo_renderer():
    """Full-frame AOV renderer (renderer_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere())
    cam = CameraParams.look_at((0, 0.3, 5.4), (0, -0.3, 0), fov_degrees=60)
    r = RayRenderer(scene, cam, lights=sun(), env=make_environment(tonemap_mode=3),
                    settings=RenderSettings(width=W, height=H))
    fb = r.render_frame()
    print(f"  timings: { {k: round(v, 1) for k, v in r.timings.items()} }")
    return save_ppm("renderer", fb.to_u8(fbch.COLOR))


def demo_lighting():
    """Point + spot lights (lighting_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere())
    cam = CameraParams.look_at((0, 0.3, 5.4), (0, -0.3, 0), fov_degrees=60)
    lights = make_lights(
        [
            {"type": LIGHT_POINT, "position": (1.2, 1.2, 1.2),
             "color": (1.0, 0.6, 0.3), "energy": 6.0, "range": 8.0},
            {"type": LIGHT_SPOT, "position": (-1.4, 1.6, 0.5),
             "direction": (0.5, -1.0, -0.2), "color": (0.4, 0.6, 1.0),
             "energy": 8.0, "range": 10.0, "spot_angle": 0.6},
        ]
    )
    r = RayRenderer(scene, cam, lights=lights,
                    env=make_environment(ambient_energy=0.15, tonemap_mode=3),
                    settings=RenderSettings(width=W, height=H))
    return save_ppm("lighting", r.render_frame().to_u8(fbch.COLOR))


def demo_pbr():
    """Material sweep: metallic x roughness spheres over a checkerboard-
    textured floor sampled through the atlas (pbr_demo.gd)."""
    import jax.numpy as jnp

    from messyerraytracer.core.attributes import make_attributes
    from messyerraytracer.render.textures import TextureRegistry

    spheres, mat_ids, mats_albedo, mats_metal, mats_rough = [], [], [], [], []
    k = 0
    for i, metal in enumerate(np.linspace(0, 1, 4)):
        for j, rough in enumerate(np.linspace(0.05, 0.9, 4)):
            c = (-2.4 + i * 1.6, -1.2 + j * 0.9, 0)
            s = meshes.uv_sphere(0.38, 10, 20, center=c)
            spheres.append(s)
            mat_ids.append(np.full(s.shape[0], k, np.int32))
            mats_albedo.append([0.9, 0.3, 0.2])
            mats_metal.append(metal)
            mats_rough.append(rough)
            k += 1
    floor = meshes.plane(10.0, y=-1.8, subdiv=2)
    spheres.append(floor)
    mat_ids.append(np.full(floor.shape[0], k, np.int32))
    mats_albedo.append([1.0, 1.0, 1.0])
    mats_metal.append(0.0)
    mats_rough.append(0.8)
    tris = np.concatenate(spheres)
    scene = build_scene_from_tri_array(tris)

    # checkerboard albedo for the floor, sampled via per-vertex UVs
    s = 64
    yy, xx = np.mgrid[0:s, 0:s]
    checker = np.where(((xx // 8 + yy // 8) % 2)[..., None],
                       np.float32([0.85, 0.85, 0.9]),
                       np.float32([0.25, 0.3, 0.35]))
    reg = TextureRegistry(size=s)
    cid = reg.add(checker)
    t_all = tris.shape[0]
    uv = np.zeros((t_all, 3, 2), np.float32)
    uv[-floor.shape[0]:] = floor[:, :, [0, 2]] / 10.0 + 0.5
    # vertex normals default to face normals (flat-shading degradation,
    # triangle_normals.h:8-11) so sphere shading matches the geometric path
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    attrs = make_attributes(t_all, uv=uv, face_normals=fn)
    tex_ids = [0] * k + [cid]

    mats = make_materials(mats_albedo, metallic=np.float32(mats_metal),
                          roughness=np.float32(mats_rough),
                          albedo_tex=np.int32(tex_ids))
    cam = CameraParams.look_at((0, 0.1, 6.0), (0, 0.1, 0), fov_degrees=45)
    r = RayRenderer(scene, cam, lights=sun(2.0),
                    env=make_environment(tonemap_mode=3),
                    materials=mats,
                    mat_id_of_prim=jnp.asarray(np.concatenate(mat_ids)),
                    attributes=attrs, atlas=reg.build(),
                    settings=RenderSettings(width=W, height=H))
    return save_ppm("pbr", r.render_frame().to_u8(fbch.COLOR))


def demo_normal_map():
    """Normal-mapped shading via the FULL pipeline — per-vertex UVs +
    tangents, a normal-map texture in the atlas, TBN perturbation inside
    extract_surface (normal_map_demo.gd; shade_pass.h:527-553)."""
    import jax.numpy as jnp

    from messyerraytracer.core.attributes import make_attributes
    from messyerraytracer.render.textures import TextureRegistry

    tri = meshes.plane(6.0, y=0.0, subdiv=8)
    t = tri.shape[0]
    scene = build_scene_from_tri_array(tri)
    # planar UVs, +Y vertex normals, +X tangents (bitangent sign +1)
    uv = (tri[:, :, [0, 2]] / 6.0 + 0.5).astype(np.float32)
    normals = np.broadcast_to(
        np.float32([0, 1, 0]), (t, 3, 3)).copy()
    tangents = np.broadcast_to(
        np.float32([1, 0, 0, 1]), (t, 3, 4)).copy()
    attrs = make_attributes(t, uv=uv, normals=normals, tangents=tangents)
    # procedural ridged normal map, encoded [0,1] like an image asset
    s = 128
    yy, xx = np.mgrid[0:s, 0:s] / s
    nm = np.stack(
        [0.35 * np.sin(xx * 40.0), 0.35 * np.sin(yy * 40.0),
         np.ones((s, s))], axis=-1
    )
    nm = nm / np.linalg.norm(nm, axis=-1, keepdims=True)
    reg = TextureRegistry(size=s)
    nid = reg.add((nm * 0.5 + 0.5).astype(np.float32))
    mats = make_materials([[0.72, 0.72, 0.78]], roughness=0.35,
                          normal_tex=[nid])
    cam = CameraParams.look_at((0, 3.5, 4.5), (0, 0, 0), fov_degrees=50)
    r = RayRenderer(
        scene, cam, lights=sun(1.8),
        env=make_environment(tonemap_mode=3),
        materials=mats, mat_id_of_prim=jnp.zeros((t,), jnp.int32),
        attributes=attrs, atlas=reg.build(),
        settings=RenderSettings(width=W, height=H,
                                channels=(fbch.COLOR, fbch.NORMAL)),
    )
    fb = r.render_frame()
    save_ppm("normal_map_normals", fb.to_u8(fbch.NORMAL))
    return save_ppm("normal_map", fb.to_u8(fbch.COLOR))


def demo_panorama():
    """HDR panorama environment (panorama_demo.gd).

    Exercises the real .hdr asset path: the panorama is written to disk
    as a Radiance RGBE file and loaded back through the cached
    ``load_panorama`` (the reference loads gradient_sky.hdr through its
    panorama cache, ray_renderer.cpp:679-704)."""
    from messyerraytracer.render.hdr import load_panorama, write_hdr

    # procedural sky panorama: horizontal hue gradient + bright band
    ph, pw = 64, 128
    yy, xx = np.mgrid[0:ph, 0:pw]
    pan = np.stack(
        [0.5 + 0.5 * np.sin(xx / pw * 6.28),
         0.4 + 0.3 * np.cos(xx / pw * 12.56),
         np.clip(1.2 - yy / ph, 0, 1)], axis=-1
    ).astype(np.float32)
    os.makedirs(OUT, exist_ok=True)
    hdr_path = os.path.join(OUT, "sky.hdr")
    write_hdr(hdr_path, pan)
    pan = load_panorama(hdr_path)
    env = make_environment(panorama=pan, panorama_energy=1.0, tonemap_mode=3)
    scene = build_scene_from_tri_array(
        meshes.uv_sphere(1.0, 16, 32, center=(0, 0, 0))
    )
    cam = CameraParams.look_at((0, 0.4, 4), (0, 0, 0), fov_degrees=70)
    r = RayRenderer(scene, cam, lights=sun(), env=env,
                    settings=RenderSettings(width=W, height=H))
    return save_ppm("panorama", r.render_frame().to_u8(fbch.COLOR))


def demo_layer():
    """Layer-mask filtering (layer_demo.gd)."""
    s1 = meshes.uv_sphere(0.9, 12, 24, center=(-1.2, 0, 0))
    s2 = meshes.uv_sphere(0.9, 12, 24, center=(1.2, 0, 0))
    tris = np.concatenate([s1, s2])
    layers = np.concatenate(
        [np.full(s1.shape[0], 0b01, np.int32),
         np.full(s2.shape[0], 0b10, np.int32)]
    )
    scene = build_scene_from_tri_array(tris, layers=layers)
    cam = CameraParams.look_at((0, 0, 5), (0, 0, 0), fov_degrees=60)
    rays = generate_rays(cam, W, H)
    h1, _ = scene.cast_rays(rays, query_mask=0b01)
    h2, _ = scene.cast_rays(rays, query_mask=0b10)
    img = np.zeros((W * H, 3), np.float32)
    img[np.asarray(h1.hit)] = [1.0, 0.3, 0.2]
    img[np.asarray(h2.hit)] = [0.2, 0.5, 1.0]
    print(f"  layer1 hits={int(np.asarray(h1.hit).sum())} "
          f"layer2 hits={int(np.asarray(h2.hit).sum())}")
    return save_ppm("layer", (img.reshape(H, W, 3) * 255).astype(np.uint8))


def demo_probe():
    """RayTracerProbe-style transform casts (probe_demo.gd)."""
    svc = RayTracerService()
    svc.register_mesh(room_with_sphere())
    svc.build()
    for z in (4.0, 2.0, 0.5):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (0.11, 0.07, z)
        r = probe_cast(svc, m)
        print(f"  probe at z={z}: hit={r['hit']} distance={r['distance']:.2f}")
    print(f"  stats: {svc.get_last_stats()}")
    return None


def demo_gi_comparison():
    """Cornell-box path tracing (gi_comparison_demo.gd)."""
    import jax.numpy as jnp

    room = meshes.cornell_room(4.0)
    ball = meshes.uv_sphere(0.7, 12, 24, center=(0.6, -1.3, -0.4))
    box = meshes.box((0.8, 1.6, 0.8), center=(-0.8, -1.2, 0.6))
    tris = np.concatenate([room, ball, box])
    # classic red/green side walls: per-tri materials
    mat = np.zeros(tris.shape[0], np.int32)
    mat[6:8] = 1   # left wall red
    mat[8:10] = 2  # right wall green
    mats = make_materials(
        [[0.73, 0.73, 0.73], [0.65, 0.05, 0.05], [0.12, 0.45, 0.15]],
        roughness=[0.8, 0.8, 0.8],
    )
    scene = build_scene_from_tri_array(tris)
    # mat ids follow the BVH reorder via prim_id lookup
    cam = CameraParams.look_at((0, 0, 5.4), (0, 0, 0), fov_degrees=55)
    w, h = 192, 144
    rays = generate_rays(cam, w, h)
    pt = PathTracer(scene, sun(2.0), make_environment(tonemap_mode=3), mats,
                    mat_id_of_prim=jnp.asarray(mat))
    t0 = time.time()
    acc = None
    spp = 4
    for s in range(spp):
        img = pt.trace_frame_srgb(PathTraceParams(w, h, 3, sample_index=s),
                                  rays)
        acc = img if acc is None else acc + (img - acc) / (s + 1)
    print(f"  {spp}spp {w}x{h} in {time.time()-t0:.1f}s")
    out = (np.clip(np.asarray(acc), 0, 1).reshape(h, w, 3) * 255).astype(np.uint8)
    return save_ppm("gi_comparison", out)


def demo_rt_graphics():
    """RT reflections compositor pipeline (rt_graphics_demo.gd)."""
    import jax.numpy as jnp

    tris = np.concatenate(
        [meshes.plane(16.0, y=-1.0, subdiv=2),
         meshes.uv_sphere(1.0, 14, 28, center=(0, 0.4, 0))]
    )
    scene = build_scene_from_tri_array(tris)
    env = make_environment(tonemap_mode=3)
    cam = CameraParams.look_at((0, 1.4, 6), (0, -0.2, 0), fov_degrees=55)
    r = RayRenderer(scene, cam, lights=sun(), env=env,
                    settings=RenderSettings(width=W, height=H,
                                            accumulate=False))
    fb = r.render_frame()
    rays = generate_rays(cam, W, H)
    hits, _ = scene.cast_rays(rays)
    rt = RTReflections(scene, env)
    base = fb.get(fbch.COLOR)[:, :3].reshape(H, W, 3)
    rough = jnp.full((H, W), 0.15, jnp.float32)
    out = rt.render(hits, rays.direction, base, rough, W, H)
    img = (np.clip(np.asarray(out), 0, 1) * 255).astype(np.uint8)
    return save_ppm("rt_graphics", img)


def demo_example():
    """Minimal API walkthrough (example_demo.gd)."""
    svc = RayTracerService()
    svc.register_mesh(meshes.uv_sphere(1.0, 12, 24))
    svc.build()
    hit = svc.cast_ray((0.11, 0.07, 4), (0, 0, -1))
    print(f"  cast_ray -> {{hit: {hit['hit']}, distance: "
          f"{hit['distance']:.3f}, prim_id: {hit['prim_id']}}}")
    return None


DEMOS = {
    "raytracer": demo_raytracer,
    "renderer": demo_renderer,
    "lighting": demo_lighting,
    "pbr": demo_pbr,
    "normal_map": demo_normal_map,
    "panorama": demo_panorama,
    "layer": demo_layer,
    "probe": demo_probe,
    "gi_comparison": demo_gi_comparison,
    "rt_graphics": demo_rt_graphics,
    "example": demo_example,
}


def main(argv):
    enable_compile_cache()
    names = argv[1:] or list(DEMOS)
    for name in names:
        print(f"[{name}]")
        t0 = time.time()
        path = DEMOS[name]()
        extra = f" -> {os.path.relpath(path)}" if path else ""
        print(f"  done in {time.time()-t0:.1f}s{extra}")


if __name__ == "__main__":
    main(sys.argv)
