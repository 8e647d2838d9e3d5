"""Two-level (TLAS over instances -> BLAS) walk of the traversal kernel,
interpret mode on CPU.

Parity oracle: flatten every instance's triangles to world space and
brute-force cast — the reference's own validation move (scene_tlas.h
:345-379 brute fallback).  Hits must agree on instance id and the
flattened prim id, with world-space t within transform rounding.
"""

import numpy as np
import pytest

from messyerraytracer.accel.tlas import SceneTLAS
from messyerraytracer.core.brute import cast_rays_brute
from messyerraytracer.core.types import NO_HIT, make_rays, make_triangles
from messyerraytracer.kernels.walk import cast_rays_walk_instanced
from messyerraytracer.utils import meshes


def xform(translate=(0, 0, 0), scale=1.0, rot_y=0.0):
    c, s = np.cos(rot_y), np.sin(rot_y)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) * scale
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = r
    m[:, 3] = translate
    return m


def random_rays(n, seed=0, extent=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


MESHES = [meshes.uv_sphere(1.0, 8, 16), meshes.box((1.0, 2.0, 1.0))]
INSTANCES = [
    (0, xform((0, 0, 0))),
    (0, xform((3, 0.5, -1), scale=0.5)),
    (1, xform((-3, 0, 0), rot_y=0.7)),
    (1, xform((0, -2.5, 2), scale=1.5, rot_y=-0.3)),
    (0, xform((-1, 3, -3), scale=2.0, rot_y=1.1)),
]


def build(mesh_list, instances, mesh_layers=None, inst_layers=None):
    tlas = SceneTLAS()
    for k, m in enumerate(mesh_list):
        tlas.add_mesh(m, layers=None if mesh_layers is None
                      else mesh_layers[k])
    for i, (b, t) in enumerate(instances):
        tlas.add_instance(b, t, layers=-1 if inst_layers is None
                          else inst_layers[i])
    tlas.build_tlas()
    return tlas


def flat_reference(mesh_list, instances, rays, query_mask=-1,
                   mesh_layers=None, inst_layers=None):
    """World-space flattening + brute cast -> (hits, instance of hit)."""
    world, inst_of, lay = [], [], []
    for i, (b, t) in enumerate(instances):
        tri = np.asarray(mesh_list[b], np.float32)
        world.append((tri @ t[:, :3].T + t[:, 3]).astype(np.float32))
        inst_of.append(np.full(len(tri), i, np.int32))
        ml = (np.full(len(tri), -1, np.int32) if mesh_layers is None
              else mesh_layers[b])
        il = -1 if inst_layers is None else inst_layers[i]
        lay.append(ml & il)
    w = np.concatenate(world)
    tris = make_triangles(w[:, 0], w[:, 1], w[:, 2],
                          layers=np.concatenate(lay))
    ref, _ = cast_rays_brute(rays, tris, query_mask)
    pid = np.asarray(ref.prim_id)
    inst_of = np.concatenate(inst_of)
    return ref, np.where(pid >= 0, inst_of[np.maximum(pid, 0)], -1)


def assert_tlas_parity(hits, inst, ref, ref_inst, rtol=2e-4):
    np.testing.assert_array_equal(np.asarray(hits.prim_id),
                                  np.asarray(ref.prim_id))
    np.testing.assert_array_equal(np.asarray(inst), ref_inst)
    hit = np.asarray(ref.prim_id) != NO_HIT
    np.testing.assert_allclose(np.asarray(hits.t)[hit],
                               np.asarray(ref.t)[hit], rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(hits.hit_layers),
                                  np.asarray(ref.hit_layers))


class TestInstancedWalk:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_parity_vs_flattened_brute(self, seed):
        tlas = build(MESHES, INSTANCES)
        rays = random_rays(512, seed=seed)
        hits, stats, occ, inst = tlas.cast_rays_instanced(rays)
        ref, ref_inst = flat_reference(MESHES, INSTANCES, rays)
        assert_tlas_parity(hits, inst, ref, ref_inst)
        assert int(stats.hits) == int(np.asarray(ref.hit).sum()) > 0
        assert int(stats.stack_drops) == 0
        np.testing.assert_array_equal(np.asarray(occ),
                                      np.asarray(ref.hit))

    def test_world_normals(self):
        # a scaled+rotated sphere instance reports outward world normals
        # (inverse-transpose mapping, blas_instance.h:62-70)
        ms = [meshes.uv_sphere(1.0, 10, 20)]
        inst = [(0, xform((5, 0, 0), scale=3.0, rot_y=0.9))]
        tlas = build(ms, inst)
        rays = make_rays((5.2, 0.3, 10), (0, 0, -1))
        hits, _, _, iid = tlas.cast_rays_instanced(rays)
        assert int(iid[0]) == 0
        n = np.asarray(hits.normal[0])
        assert abs(np.linalg.norm(n) - 1.0) < 1e-4
        assert n[2] > 0.8
        ref, _ = flat_reference(ms, inst, rays)
        np.testing.assert_allclose(n, np.asarray(ref.normal[0]), atol=1e-5)

    def test_single_instance_root_leaf(self):
        # one instance: the TLAS root is itself a leaf
        tlas = build([MESHES[0]], [(0, xform((0.5, 0, 0)))])
        tables = tlas.build_instanced()
        assert tables.n_tlas == 1 and int(tables.count[0]) == 1
        rays = random_rays(128, seed=4, extent=3.0)
        hits, _, _, inst = tlas.cast_rays_instanced(rays)
        ref, ref_inst = flat_reference([MESHES[0]], [(0, xform((0.5, 0, 0)))],
                                       rays)
        assert_tlas_parity(hits, inst, ref, ref_inst)

    def test_any_hit(self):
        tlas = build(MESHES, INSTANCES)
        rays = random_rays(300, seed=3)
        _, _, occ, _ = tlas.cast_rays_instanced(rays, any_hit=True)
        ref, _ = flat_reference(MESHES, INSTANCES, rays)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref.hit))

    def test_set_transform_refit(self):
        tlas = build(MESHES, INSTANCES)
        tlas.cast_rays_instanced(random_rays(8, seed=0))   # tables built
        moved = [xform((1, 1, 1)),
                 xform((4, -0.5, 2), scale=0.75, rot_y=0.4),
                 xform((-2, 1, -1), rot_y=1.5),
                 xform((0, -1.5, 3), scale=1.2),
                 xform((-2, 2, -4), scale=1.8, rot_y=2.0)]
        for i, t in enumerate(moved):
            tlas.set_transform(i, t)
        rays = random_rays(512, seed=7)
        hits, _, _, inst = tlas.cast_rays_instanced(rays)
        inst2 = [(b, t) for (b, _), t in zip(INSTANCES, moved)]
        ref, ref_inst = flat_reference(MESHES, inst2, rays)
        assert_tlas_parity(hits, inst, ref, ref_inst)

    def test_shared_mesh_memory(self):
        # 64 instances of one mesh: the forest holds the mesh once
        ms = [meshes.uv_sphere(1.0, 8, 16)]
        rng = np.random.default_rng(1)
        many = [(0, xform(tuple(rng.uniform(-20, 20, 3)),
                          scale=float(rng.uniform(0.5, 2.0)),
                          rot_y=float(rng.uniform(0, 6))))
                for _ in range(64)]
        tlas = build(ms, many)
        tables = tlas.build_instanced()
        assert tables.tris.count == ms[0].shape[0]
        assert tables.n_tlas == 2 * 64 - 1
        rays = random_rays(256, seed=5, extent=22.0)
        hits, _, _, inst = tlas.cast_rays_instanced(rays)
        ref, ref_inst = flat_reference(ms, many, rays)
        assert_tlas_parity(hits, inst, ref, ref_inst)

    @pytest.mark.parametrize("qm", [0b01, 0b10, 0b11])
    def test_instance_layers_and_triangle_layers(self, qm):
        # effective layers = triangle layers & instance layers
        # (ray_scene.h:124), filtered during the walk
        sphere = meshes.uv_sphere(1.0, 8, 16)
        tl = np.where(np.arange(len(sphere)) % 3 == 0, 0b01,
                      0b11).astype(np.int32)
        ms = [sphere, MESHES[1]]
        mesh_layers = [tl, np.full(len(MESHES[1]), 0b10, np.int32)]
        inst_layers = [0b01, 0b10, 0b11, 0b01, 0b10]
        tlas = build(ms, INSTANCES, mesh_layers, inst_layers)
        rays = random_rays(256, seed=31)
        hits, _, _, inst = tlas.cast_rays_instanced(rays, query_mask=qm)
        ref, ref_inst = flat_reference(ms, INSTANCES, rays, qm,
                                       mesh_layers, inst_layers)
        assert_tlas_parity(hits, inst, ref, ref_inst)

    def test_per_ray_counters(self):
        tlas = build(MESHES, INSTANCES)
        rays = random_rays(256, seed=9)
        hits, stats, _, _, pr = cast_rays_walk_instanced(
            rays, tlas.build_instanced(), return_per_ray=True)
        tt = np.asarray(pr["tri_tests"])
        nv = np.asarray(pr["node_visits"])
        assert int(tt.sum()) == int(stats.tri_tests)
        assert int(nv.sum()) == int(stats.bvh_nodes_visited)
        hit = np.asarray(hits.hit)
        assert (tt[hit] > 0).all() and (nv[hit] >= 2).all()   # TLAS + BLAS

    def test_stack_depth_covers_both_levels(self):
        tlas = build(MESHES, INSTANCES)
        tables = tlas.build_instanced()
        blas_levels = max(len(m.scene.bvh.levels) for m in tlas.meshes)
        assert tables.levels > blas_levels
        _, stats, _, _ = tlas.cast_rays_instanced(random_rays(256, seed=2))
        assert int(stats.stack_drops) == 0


class TestWholeFrameJit:
    def test_flat_kernel_frame_matches_stages(self):
        """The one-dispatch PT frame over a kernel-backend RayScene must
        equal the eagerly staged frame (same kernel, same waves)."""
        from messyerraytracer.render.camera import CameraParams, \
            generate_rays
        from messyerraytracer.render.shade import (
            make_environment, make_lights, make_materials)
        from messyerraytracer.render.wavefront import WavefrontPathTracer
        from messyerraytracer.scene.scene import build_scene_from_tri_array

        scene = build_scene_from_tri_array(np.concatenate([
            meshes.cornell_room(4.0),
            meshes.uv_sphere(0.8, 8, 16, center=(0, -1.2, 0))]))
        lights = make_lights([{"type": 1, "position": (0.5, 1.2, 1.0),
                               "energy": 4.0, "range": 8.0}])
        pt = WavefrontPathTracer(scene, lights, make_environment(),
                                 make_materials([[0.7, 0.65, 0.6]]))
        rays = generate_rays(CameraParams.look_at((0, 0, 5.4), (0, 0, 0),
                                                  fov_degrees=60), 16, 12)
        img, n = pt.trace_frame(rays, max_bounces=2, with_counts=True)
        ref, n_ref = pt._trace_frame_stages(rays, max_bounces=2,
                                            with_counts=True)
        np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        assert int(n) == int(n_ref) > 0
