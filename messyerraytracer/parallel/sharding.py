"""Multi-chip scaling: shard the ray batch across a device mesh.

The reference is single-process/single-node (SURVEY.md §2.10 — no
NCCL/MPI); its parallelism is a thread pool chunking rays
(src/dispatch/ray_dispatcher.h:153-180).  The multi-device story is
therefore new design: rays are embarrassingly parallel, so the batch is
sharded over a 1-D ``jax.sharding.Mesh`` ("rays" axis — pure data
parallelism) with the scene arrays replicated on every device, and each
device runs the per-ray traversal kernel (kernels/walk.py) on its local
shard via ``jax.shard_map``.  Per-cast stats are combined with a ``psum``
— the collective analogue of the reference's per-thread RayStats merge
(ray_dispatcher.h:163-180).  The mesh follows the algorithm: a 1-D axis,
since every card reaches every other at the same rate.

Scene sharding (BLAS-per-device + hit combine) is for scenes that exceed
one device's memory; see SURVEY.md §2.10.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..accel.bvh import BVH
from ..core.types import Hits, Rays, RayStats, Triangles
from ..kernels.walk import BLOCK, KernelScene, cast_rays_walk, stack_depth

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the ray axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def _pad_to(rays: Rays, multiple: int) -> tuple[Rays, int]:
    n = rays.count
    pad = (-n) % multiple
    if pad == 0:
        return rays, 0
    return Rays(
        origin=jnp.concatenate([rays.origin, jnp.zeros((pad, 3), jnp.float32)]),
        direction=jnp.concatenate(
            [rays.direction,
             jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]]), (pad, 1))]
        ),
        t_min=jnp.concatenate([rays.t_min, jnp.zeros((pad,), jnp.float32)]),
        t_max=jnp.concatenate(
            [rays.t_max, jnp.full((pad,), -1.0, jnp.float32)]
        ),
    ), pad


def cast_rays_sharded(
    rays: Rays,
    scene,
    mesh: Mesh,
    query_mask: int = -1,
    any_hit: bool = False,
) -> tuple[Hits, RayStats, jnp.ndarray]:
    """Batch cast with the ray axis sharded over ``mesh``.

    ``scene`` is a RayScene; its tables are replicated to all devices,
    each device casts its local shard with the traversal kernel, and
    stats are psum-reduced.  Output hits land sharded over the same axis.
    One compiled program per (mesh, shapes, mode), reused across calls.
    """
    n = rays.count
    rays_p, pad = _pad_to(rays, mesh.devices.size * BLOCK)
    hits, stats, occ = _cast_sharded_jit(
        rays_p, scene.bvh, scene.tris, mesh=mesh, query_mask=int(query_mask),
        any_hit=bool(any_hit))
    if pad:
        hits = jax.tree.map(lambda x: x[:n], hits)
        occ = occ[:n]
        stats = stats.replace(rays_cast=jnp.int32(n))
    return hits, stats, occ


def _psum_stats(stats: RayStats) -> RayStats:
    return jax.tree.map(
        lambda x: jax.lax.psum(jnp.asarray(x, jnp.int32), RAY_AXIS), stats)


@partial(jax.jit, static_argnames=("mesh", "query_mask", "any_hit"))
def _cast_sharded_jit(rays, bvh, tris, *, mesh, query_mask, any_hit):
    def local_cast(local, bvh, tris):
        hits, stats, occ = cast_rays_walk(local, bvh, tris, query_mask,
                                          any_hit=any_hit)
        return hits, _psum_stats(stats), occ

    return jax.shard_map(
        local_cast,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P(), P()),
        out_specs=(P(RAY_AXIS), P(), P(RAY_AXIS)),
        check_vma=False,  # pallas_call outputs carry no vma info
    )(rays, bvh, tris)


_SHARD_FIELDS = ("aabb_min", "aabb_max", "left_first", "count",
                 "split_axis")
_SHARD_TRI_FIELDS = ("v0", "edge1", "edge2", "normal", "prim_id", "layers")


def build_sharded_scene(tri_array: np.ndarray, n_shards: int):
    """Partition a triangle soup into ``n_shards`` spatial chunks and
    build one BVH per chunk, padded to common table shapes and stacked on
    a leading shard axis.

    This is the scene-parallel axis (SURVEY.md §2.10: "BLAS-per-chip with
    AllGather of candidate hits" — for scenes exceeding one device's
    memory): each device holds 1/n of the triangles; every device casts
    the FULL ray batch against its sub-scene and the closest hit is
    combined with collectives (``cast_rays_scene_sharded``).  Chunks are
    Morton-ordered by centroid so each shard is spatially compact
    (sub-scene BVHs stay tight).

    Padding is never read: node ids only reach real nodes through the
    tree, so shards of different sizes share one traced program.

    Returns (stacked: dict of (S, ...) arrays, meta: {"depth": stack
    width}, id_maps (S, Lmax) int32 mapping shard-local prim ids to
    original triangle ids).
    """
    from ..dispatch.morton import morton_encode_3d
    from ..scene.scene import build_scene_from_tri_array

    tri_array = np.asarray(tri_array, np.float32)
    t = tri_array.shape[0]
    if t < n_shards:
        raise ValueError(
            f"build_sharded_scene: {t} triangles cannot fill {n_shards} "
            "shards (every shard needs >= 1 triangle) — use the "
            "replicated-scene data-parallel path for tiny scenes"
        )
    cent = tri_array.mean(axis=1)
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = np.clip(((cent - lo) / ext * 1023.0), 0, 1023).astype(np.uint32)
    key = np.asarray(morton_encode_3d(
        jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]), jnp.asarray(q[:, 2])
    ))
    order = np.argsort(key, kind="stable")
    bounds = np.linspace(0, t, n_shards + 1).astype(np.int64)

    scenes = []
    id_maps = []
    for s in range(n_shards):
        idx = order[bounds[s]:bounds[s + 1]]
        scenes.append(build_scene_from_tri_array(
            tri_array[idx], prim_id=np.arange(len(idx), dtype=np.int32)))
        id_maps.append(idx.astype(np.int32))

    def stack(arrs):
        target = tuple(int(x) for x in
                       np.array([a.shape for a in arrs]).max(axis=0))
        return jnp.stack([
            jnp.pad(a, [(0, tg - sh) for sh, tg in zip(a.shape, target)])
            for a in arrs])

    stacked = {f: stack([getattr(sc.bvh, f) for sc in scenes])
               for f in _SHARD_FIELDS}
    stacked.update({f: stack([getattr(sc.tris, f) for sc in scenes])
                    for f in _SHARD_TRI_FIELDS})
    maxmap = max(m.shape[0] for m in id_maps)
    id_maps = jnp.stack([
        jnp.pad(jnp.asarray(m), (0, maxmap - m.shape[0]))
        for m in id_maps
    ])
    meta = {"depth": stack_depth(max(len(sc.bvh.levels) for sc in scenes))}
    return stacked, meta, id_maps


def cast_rays_scene_sharded(rays: Rays, stacked, meta, id_maps,
                            mesh: Mesh):
    """Closest-hit cast with the SCENE sharded over the mesh.

    Rays are replicated to every device; each device walks its sub-scene
    with the traversal kernel; the global winner per ray is the
    lexicographic (t, global prim) minimum combined with two pmin
    collectives + a masked psum gather of the winner's fields — the
    collective version of the reference merging per-thread nearest hits
    (ray_dispatcher.h:163-180).
    """
    if id_maps.shape[0] != mesh.devices.size:
        raise ValueError(f"{id_maps.shape[0]} scene shards for a mesh of "
                         f"{mesh.devices.size} devices")
    return _cast_scene_sharded_jit(rays, stacked, id_maps, mesh=mesh,
                                   depth=int(meta["depth"]))


@partial(jax.jit, static_argnames=("mesh", "depth"))
def _cast_scene_sharded_jit(rays, stacked, id_maps, *, mesh, depth):
    from ..core.types import NO_HIT, T_MAX_DEFAULT

    n = rays.count
    big = jnp.float32(3.0e38)

    def local_cast(shard_tables, id_map, local):
        # tables arrive with a leading length-1 shard axis
        tab = {k: v[0] for k, v in shard_tables.items()}
        bvh = BVH(**{f: tab[f] for f in _SHARD_FIELDS},
                  tri_order=tab["prim_id"], levels=())
        tris = Triangles(**{f: tab[f] for f in _SHARD_TRI_FIELDS})
        hits, stats, _ = cast_rays_walk(local, bvh, tris, depth=depth)
        # to GLOBAL prim ids (original triangle numbering)
        gprim = jnp.where(
            hits.prim_id >= 0, id_map[0][jnp.maximum(hits.prim_id, 0)],
            NO_HIT,
        )
        # lexicographic (t, prim) min across the scene axis
        t_loc = jnp.where(hits.prim_id >= 0, hits.t, big)
        t_best = jax.lax.pmin(t_loc, RAY_AXIS)
        cand = (t_loc == t_best) & (hits.prim_id >= 0)
        p_best = jax.lax.pmin(
            jnp.where(cand, gprim, jnp.int32(2**31 - 1)), RAY_AXIS
        )
        win = cand & (gprim == p_best)

        def pick(x):
            m = win[..., None] if x.ndim == 2 else win
            return jax.lax.psum(jnp.where(m, x, 0), RAY_AXIS)

        found = t_best < big
        hits_out = Hits(
            t=jnp.where(found, t_best, T_MAX_DEFAULT),
            position=pick(hits.position),
            normal=pick(hits.normal),
            u=pick(hits.u),
            v=pick(hits.v),
            prim_id=jnp.where(found, p_best, NO_HIT),
            hit_layers=pick(hits.hit_layers).astype(jnp.int32),
        )
        stats_out = _psum_stats(stats).replace(
            rays_cast=jnp.int32(n), hits=jnp.sum(found.astype(jnp.int32)))
        return hits_out, stats_out

    return jax.shard_map(
        local_cast,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(stacked, id_maps, rays)


def render_step_sharded(scene, cam, width, height, mesh,
                        lights=None, env=None, materials=None,
                        max_bounces=2, sample_index=0):
    """One full path-traced frame with pixels sharded over the mesh.

    The multi-device "training step" analogue: raygen + multi-bounce
    path-trace runs entirely inside ``shard_map`` per device on its pixel
    shard; nothing crosses devices but the pixels.  Scene and shading
    tables are replicated (see SURVEY.md §2.10 for the sharded-scene
    plan).
    """
    from ..render.camera import generate_rays
    from ..render.shade import default_materials, make_environment

    env = env if env is not None else make_environment()
    materials = materials if materials is not None else default_materials()
    rays = generate_rays(cam, width, height)
    rays_p, _ = _pad_to(rays, mesh.devices.size * BLOCK)
    img = _render_sharded_jit(
        rays_p, scene.bvh, scene.tris, lights, env, materials, mesh=mesh,
        width=int(width), height=int(height), max_bounces=int(max_bounces),
        sample_index=int(sample_index))
    return img[: rays.count]


@partial(jax.jit, static_argnames=("mesh", "width", "height", "max_bounces",
                                   "sample_index"))
def _render_sharded_jit(rays, bvh, tris, lights, env, materials, *, mesh,
                        width, height, max_bounces, sample_index):
    from ..render.pathtrace import PathTracer, PathTraceParams

    def local_frame(local, bvh, tris, lights, env, materials):
        pt = PathTracer(KernelScene((tris, bvh)), lights, env, materials)
        # global pixel ids seed the RNG, so the shards reproduce the
        # one-device frame
        offset = jax.lax.axis_index(RAY_AXIS) * local.count
        return pt.trace_frame(
            PathTraceParams(width, height, max_bounces=max_bounces,
                            sample_index=sample_index),
            local, pixel_offset=offset,
        )

    return jax.shard_map(
        local_frame,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,  # pallas_call outputs carry no vma info
    )(rays, bvh, tris, lights, env, materials)
