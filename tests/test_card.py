"""Tests of the compiled traversal kernel on the GPU (marker ``card``).

They skip off the card (the ``card`` fixture decides at run time, so every
worker collects the same tests).  ``chip_smoke.py`` runs them on the card
in its own process.  Compiled results are compared with the Pallas
interpreter running the same kernel and with the brute-force oracle; the
tie-aware prim_id rule and t rtol 1e-5 are bench.py's ``parity`` (the
card contracts FMAs, so the last ulps differ from the CPU).
"""

import numpy as np
import pytest

from messyerraytracer.accel.tlas import SceneTLAS
from messyerraytracer.core.brute import any_hit_brute, cast_rays_brute
from messyerraytracer.core.types import make_rays, make_triangles
from messyerraytracer.kernels import walk
from messyerraytracer.scene.scene import build_scene_from_tri_array
from messyerraytracer.utils import meshes

pytestmark = pytest.mark.card


def random_rays(n, seed=0, extent=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d)


def assert_tie_parity(hits, ref, rtol=1e-5, atol=0.0):
    ps, pb = np.asarray(hits.prim_id), np.asarray(ref.prim_id)
    ts, tb = np.asarray(hits.t), np.asarray(ref.t)
    tie = np.abs(ts - tb) <= max(4e-6, rtol) * np.maximum(np.abs(tb), 1.0)
    assert np.all((ps == pb) | tie)
    np.testing.assert_allclose(ts, tb, rtol=rtol, atol=atol)


def terrain_scene():
    g = meshes.plane(20.0, y=0.0, subdiv=120)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.7) * np.cos(g[:, :, 2] * 0.6))
    return build_scene_from_tri_array(np.concatenate(
        [g, meshes.uv_sphere(2.0, 48, 48, center=(0, 3, 0))]))


def test_kernel_is_compiled_on_the_card(card):
    assert walk.kernel_interpret() is False


def test_compiled_matches_interpreter(card):
    scene = terrain_scene()
    rays = random_rays(4096, seed=1)
    hc, sc, _ = walk.cast_rays_walk(rays, scene.bvh, scene.tris)
    hi, si, _ = walk.cast_rays_walk(rays, scene.bvh, scene.tris,
                                    interpret=True)
    assert_tie_parity(hc, hi)
    assert int(sc.hits) == int(si.hits)
    assert int(sc.stack_drops) == 0


def test_compiled_parity_vs_brute(card):
    scene = terrain_scene()
    rays = random_rays(16384, seed=2)
    hits, stats = scene.cast_rays(rays)
    ref, _ = cast_rays_brute(rays, scene.tris)
    assert_tie_parity(hits, ref)
    assert int(stats.hits) == int(np.asarray(ref.hit).sum()) > 0
    occ = scene.any_hit_rays(rays)
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray(any_hit_brute(rays,
                                                           scene.tris)))


def test_compiled_instanced_parity(card):
    ms = [meshes.uv_sphere(1.0, 24, 48), meshes.box((1.0, 2.0, 1.0))]
    tlas = SceneTLAS()
    ids = [tlas.add_mesh(m) for m in ms]
    rng = np.random.default_rng(5)
    world = []
    for i in range(40):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= rng.uniform(0.5, 1.5)
        m[:3, 3] = rng.uniform(-8, 8, 3)
        b = i % 2
        tlas.add_instance(ids[b], m)
        world.append(ms[b] @ m[:3, :3].T + m[:3, 3])
    tlas.build_tlas()
    rays = random_rays(8192, seed=3, extent=10.0)
    hits, stats, _, inst = tlas.cast_rays_instanced(rays)
    w = np.concatenate(world).astype(np.float32)
    ref, _ = cast_rays_brute(rays, make_triangles(w[:, 0], w[:, 1], w[:, 2]))
    # object-space walk vs world-space oracle: transform rounding, as in
    # tests/test_walk_instanced.py
    assert_tie_parity(hits, ref, rtol=2e-4, atol=1e-5)
    assert int(stats.stack_drops) == 0
    assert (np.asarray(inst)[np.asarray(hits.hit)] >= 0).all()


def test_compiled_layer_mask(card):
    g = meshes.plane(6.0, y=0.0, subdiv=30)
    sph = meshes.uv_sphere(1.0, 24, 32, center=(0, 1.2, 0))
    layers = np.concatenate([np.full(len(g), 1, np.int32),
                             np.full(len(sph), 2, np.int32)])
    scene = build_scene_from_tri_array(np.concatenate([g, sph]),
                                       layers=layers)
    rays = random_rays(4096, seed=4, extent=4.0)
    for qm in (1, 2):
        hits, _ = scene.cast_rays(rays, query_mask=qm)
        ref, _ = cast_rays_brute(rays, scene.tris, query_mask=qm)
        assert_tie_parity(hits, ref)
