"""Two-level acceleration: MeshBLAS + instances + SceneTLAS.

Rewrite of ``src/accel/mesh_blas.h`` / ``blas_instance.h`` /
``scene_tlas.h``.  The reference keeps two parallel representations:

  1. a *true* two-level TLAS (TinyBVH native) used by the CPU path, and
  2. a *flattened* world-space copy of every instance's triangles used by
     the GPU/SIMD path (``RayTracerServer::_rebuild_scene``,
     raytracer_server.cpp:700-761).

Here both roles exist:

  * the **instanced path** (``cast_rays_instanced``, ``instanced_scene``)
    is the production cast: a TLAS over instance world AABBs above the
    meshes' BLAS BVHs, walked by the per-ray kernel (kernels/walk.py) —
    memory ~ meshes, never flattened;
  * the **flattened path** builds a world-space twin lazily for users who
    cast through ``flat``; per-instance transform updates are a fully
    device-side re-transform + refit (never rebuilds topology)
  * the **instance-accurate path** (cast_rays_two_level) tests each ray
    against instance world AABBs and traverses each intersected BLAS with
    the object-space ray (direction NOT renormalized so t stays
    world-parameterized, blas_instance.h:48-59), matching
    ``SceneTLAS::cast_ray`` semantics (scene_tlas.h:203-251) including its
    brute-over-instances fallback shape (scene_tlas.h:345-379)

Hit results carry the *instance id* in addition to the usual fields.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
)
from ..kernels.walk import (InstanceTables, KernelScene,
                            cast_rays_walk_instanced)
from ..scene.scene import RayScene, build_scene
from .bvh import build_bvh_over_aabbs


def _bvh_host(bvh, name):
    """Host copy of a BVH build array, from the builder's host mirror
    when present (no device readback)."""
    host = getattr(bvh, "host", None)
    if host is not None and name in host:
        return host[name]
    return np.asarray(getattr(bvh, name))


def _apply_rt(m, p, translate=True):
    """Apply a (3,4) [R|t] to points/vectors (N,3) with explicit f32
    multiply-adds.  ``p @ m.T`` is a matrix product, which the GPU may run
    in TF32 (~1e-3 relative error per coordinate) unless asked for full
    precision; component arithmetic is exact f32 and cheap at 3x4."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    out = jnp.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        axis=-1,
    )
    return out + m[:, 3] if translate else out


def _to_mat4(transform) -> np.ndarray:
    """Accept (4,4), (3,4), or (3,3) and return a (3,4) [R|t] float32."""
    m = np.asarray(transform, np.float32)
    if m.shape == (4, 4):
        return m[:3, :]
    if m.shape == (3, 4):
        return m
    if m.shape == (3, 3):
        return np.concatenate([m, np.zeros((3, 1), np.float32)], axis=1)
    raise ValueError(f"bad transform shape {m.shape}")


@dataclasses.dataclass
class MeshBLAS:
    """Per-mesh object-space BLAS (mesh_blas.h:45-216): a RayScene over the
    mesh's object-space triangles."""

    scene: RayScene
    tri_array: np.ndarray  # (T, 3, 3) object-space vertices (host copy)
    layers_orig: np.ndarray | None = None  # (T,) host layers, ORIGINAL
    #   order — kept so TLAS builds never read layers back off the device

    @property
    def num_tris(self) -> int:
        return self.scene.num_tris

    def object_bounds(self):
        """Object-space AABB from the BLAS root (mesh_blas.h:190-200)."""
        return (
            _bvh_host(self.scene.bvh, "aabb_min")[0],
            _bvh_host(self.scene.bvh, "aabb_max")[0],
        )


@dataclasses.dataclass
class BLASInstance:
    """Instance = blas_id + transform + cached inverse + world AABB
    (blas_instance.h:24-108)."""

    blas_id: int
    transform: np.ndarray      # (3,4) [R|t]
    inv_transform: np.ndarray  # (3,4) world->object
    layers: int = ALL_LAYERS

    @staticmethod
    def create(blas_id: int, transform, layers: int = ALL_LAYERS):
        m = _to_mat4(transform)
        r_inv = np.linalg.inv(m[:, :3])
        t_inv = -r_inv @ m[:, 3]
        inv = np.concatenate([r_inv, t_inv[:, None]], axis=1).astype(np.float32)
        return BLASInstance(blas_id, m, inv, layers)

    def world_aabb(self, obj_min, obj_max):
        """World AABB by transforming all 8 box corners
        (blas_instance.h:74-107)."""
        corners = np.array(
            [
                [x, y, z]
                for x in (obj_min[0], obj_max[0])
                for y in (obj_min[1], obj_max[1])
                for z in (obj_min[2], obj_max[2])
            ],
            np.float32,
        )
        wc = corners @ self.transform[:, :3].T + self.transform[:, 3]
        return wc.min(axis=0), wc.max(axis=0)


@dataclasses.dataclass
class InstancedScene(KernelScene):
    """Scene-like cast view over the instanced two-level tables.

    Duck-types the RayScene cast interface (cast_rays/any_hit_rays ->
    2-tuple / flags) so renderers and the wavefront path tracer consume
    the true two-level structure directly — memory ~ meshes, prim ids
    in the flattened global numbering."""

    tables: InstanceTables
    bounds: tuple


class SceneTLAS:
    """Top-level structure over BLAS instances (scene_tlas.h:46-380).

    Workflow mirrors the reference: ``add_mesh`` -> ``add_instance`` ->
    ``build_tlas``; transform updates go through ``set_transform`` +
    ``refit_tlas`` (10-100x cheaper than rebuild, scene_tlas.h:178-196).
    """

    def __init__(self, backend: str = "kernel"):
        self.backend = backend
        self.meshes: list[MeshBLAS] = []
        self.instances: list[BLASInstance] = []
        self._flat: RayScene | None = None
        # static flatten metadata (built once per topology)
        self._tri_inst: np.ndarray | None = None   # (F,) instance id per flat tri
        self._obj_tris: np.ndarray | None = None   # (F, 3, 3) object-space
        self._slot_inst = None                     # (F,) device, slot order
        self._transforms_dev = None                # (I, 3, 4) device
        self._two_level = None                     # FrontierTLAS cache
        self._itables = None                       # InstanceTables cache
        self._forest = None                        # BLAS forest cache

    # ---- build -------------------------------------------------------
    def add_mesh(self, tri_array, layers=None) -> int:
        """Register an object-space mesh; builds its BLAS
        (scene_tlas.h:62-90).  Returns blas_id."""
        tri_array = np.asarray(tri_array, np.float32)
        scene = build_scene(
            tri_array[:, 0], tri_array[:, 1], tri_array[:, 2],
            layers=layers, backend=self.backend,
        )
        lay_np = (np.full(tri_array.shape[0], ALL_LAYERS, np.int32)
                  if layers is None else np.asarray(layers, np.int32))
        self.meshes.append(MeshBLAS(scene, tri_array, layers_orig=lay_np))
        self._two_level = None  # frontier tables embed the mesh forest
        self._itables = None
        self._forest = None
        return len(self.meshes) - 1

    def add_instance(self, blas_id: int, transform, layers: int = ALL_LAYERS) -> int:
        """Add an instance of a registered BLAS (scene_tlas.h:108-122)."""
        assert 0 <= blas_id < len(self.meshes)
        self.instances.append(BLASInstance.create(blas_id, transform, layers))
        self._two_level = None  # frontier tables embed the instance set
        self._itables = None
        return len(self.instances) - 1

    def build_tlas(self) -> None:
        """Build the flattened world-space scene over all instances.

        The reference flattens for its GPU path
        (raytracer_server.cpp:700-761); here the flat scene IS the hot path
        and the per-instance object-space triangles + transforms are kept on
        device so ``refit_tlas`` is a pure device computation.
        """
        assert self.instances, "build_tlas: no instances"
        self._two_level = None  # rebuilt lazily against the new scene
        self._itables = None
        # per-MESH layer tables, hoisted out of the instance loop
        mesh_layers_orig = {}
        for b, mesh in enumerate(self.meshes):
            if mesh.layers_orig is not None:
                mesh_layers_orig[b] = mesh.layers_orig
                continue
            ml = np.asarray(mesh.scene.tris.layers)
            # instance layer mask ANDs with per-tri layers (we flatten in
            # original order, so invert the BLAS build permutation first)
            perm = _bvh_host(mesh.scene.bvh, "tri_order")
            unperm = np.empty_like(perm)
            unperm[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
            mesh_layers_orig[b] = ml[unperm]
        obj, inst_id, layers = [], [], []
        for i, inst in enumerate(self.instances):
            tris = self.meshes[inst.blas_id].tri_array
            obj.append(tris)
            inst_id.append(np.full(tris.shape[0], i, np.int32))
            layers.append(mesh_layers_orig[inst.blas_id] & inst.layers)

        self._obj_tris = np.concatenate(obj)
        self._tri_inst = np.concatenate(inst_id)
        self._flat_layers = np.concatenate(layers)
        # The flattened world-space twin is built LAZILY on first use:
        # the reference pays a double build every rebuild (TLAS for CPU
        # + flattened scene for GPU, raytracer_server.cpp:616-769 — the
        # cost SURVEY.md flags as not to be replicated); here the
        # instanced walk is the production path and users who never
        # cast through ``flat`` never pay for it.
        self._flat = None
        self._slot_inst = None

    @property
    def flat(self) -> RayScene | None:
        """The flattened world-space twin, built on first access (the
        reference rebuilds it eagerly every build,
        raytracer_server.cpp:616-769 — a double-build cost this design
        defers to flat-path users only)."""
        if self._flat is None and self._obj_tris is not None:
            self._ensure_flat()
        return self._flat

    def _ensure_flat(self) -> None:
        if self._flat is not None:
            return
        assert self._obj_tris is not None, "call build_tlas first"
        world = self._world_tris_np()
        self._flat = build_scene(
            world[:, 0], world[:, 1], world[:, 2],
            layers=self._flat_layers, backend=self.backend,
        )
        perm = _bvh_host(self._flat.bvh, "tri_order")
        self._slot_inst = jnp.asarray(self._tri_inst[perm])
        self._obj_slots = jnp.asarray(self._obj_tris[perm])  # (F,3,3) device
        self._transforms_dev = jnp.asarray(
            np.stack([i.transform for i in self.instances])
        )

    def _world_tris_np(self) -> np.ndarray:
        tf = np.stack([i.transform for i in self.instances])  # (I,3,4)
        r = tf[self._tri_inst, :, :3]          # (F,3,3)
        t = tf[self._tri_inst, :, 3]           # (F,3)
        return np.einsum("fij,fvj->fvi", r, self._obj_tris) + t[:, None, :]

    # ---- dynamic updates ---------------------------------------------
    def set_transform(self, instance_id: int, transform) -> None:
        self.instances[instance_id] = BLASInstance.create(
            self.instances[instance_id].blas_id, _to_mat4(transform),
            self.instances[instance_id].layers,
        )
        # both two-level tables embed instance transforms/AABBs; the
        # kernel tables rebuild only the small TLAS on next use (the
        # BLAS forest is cached), scene_tlas.h:180-196 semantics
        self._two_level = None
        self._itables = None

    def refit_tlas(self) -> None:
        """Re-transform flattened triangles + refit — all on device
        (scene_tlas.h:180-196 semantics; topology unchanged)."""
        self._ensure_flat()
        self._transforms_dev = jnp.asarray(
            np.stack([i.transform for i in self.instances])
        )
        tris, bvh = _tlas_refit_jit(
            self._flat.bvh, self._flat.tris,
            self._obj_slots, self._slot_inst, self._transforms_dev,
        )
        self._flat = dataclasses.replace(
            self._flat, tris=tris, bvh=bvh,
            _frontier=None, _frontier_q=None,  # stale-geometry caches
        )

    # ---- casts -------------------------------------------------------
    def cast_rays(self, rays: Rays, query_mask=ALL_LAYERS):
        """Closest-hit cast via the flattened scene.  Returns
        (hits, stats, instance_id) where instance_id is (N,) int32, -1 on
        miss (the reference reports hits via tray.hit.inst -> instance,
        scene_tlas.h:232-247)."""
        self._ensure_flat()
        hits, stats = self._flat.cast_rays(rays, query_mask)
        inst = self._instance_of_hits(hits)
        return hits, stats, inst

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS):
        self._ensure_flat()
        return self._flat.any_hit_rays(rays, query_mask)

    def _instance_of_hits(self, hits: Hits) -> jnp.ndarray:
        # prim_id is the flat original index; map through sort: slot arrays
        # are in slot order, and hits.prim_id is original order — build the
        # original-order instance table once.
        inst_orig = jnp.asarray(self._tri_inst)
        pid = jnp.maximum(hits.prim_id, 0)
        return jnp.where(hits.hit, inst_orig[pid], -1)

    # ---- scalable two-level cast (frontier TLAS/BLAS forest) ---------
    def build_two_level(self):
        """Build the frontier two-level tables (accel/tlas_frontier.py).

        Memory scales with registered meshes, not instances — the
        sub-linear contract of the reference's native TLAS
        (scene_tlas.h:140-176)."""
        from .tlas_frontier import build_frontier_tlas

        self._two_level = build_frontier_tlas(self)
        return self._two_level

    def cast_rays_two_level_fast(self, rays: Rays, query_mask=ALL_LAYERS,
                                 any_hit: bool = False):
        """Log-time two-level cast: TLAS frontier descent -> per-instance
        object-space rays -> BLAS-forest frontier descent
        (scene_tlas.h:203-251 semantics).  Returns
        (hits, stats, occluded, instance_id)."""
        from .tlas_frontier import cast_rays_tlas

        ft = getattr(self, "_two_level", None)
        if ft is None:
            ft = self.build_two_level()
        return cast_rays_tlas(rays, ft, query_mask, any_hit)

    # ---- production instanced cast (per-ray kernel) ------------------
    def _blas_forest(self):
        """Every registered mesh's BLAS concatenated once (device arrays,
        mesh-relative node ids), cached until a mesh is added."""
        if self._forest is None:
            self._forest = _build_forest(self.meshes)
        return self._forest

    def build_instanced(self) -> InstanceTables:
        """Build the two-level tables for the traversal kernel.

        Memory scales with registered MESHES: the BLAS forest holds each
        mesh once, and an instance adds a transform, a root, a layer mask
        and a prim-id base — the reference's native TLAS memory contract
        (scene_tlas.h:140-176).  Layer semantics match the flattened
        path: effective per-triangle layers = tri_layers &
        instance_layers (ray_scene.h:124, triangle.h:22-56), applied
        during traversal, so masks cost no memory."""
        assert self.instances, "build_instanced: no instances"
        self._itables = _build_instance_tables(
            self._blas_forest(), self.meshes, self.instances)
        return self._itables

    def cast_rays_instanced(self, rays: Rays, query_mask=ALL_LAYERS,
                            any_hit: bool = False):
        """Frame-scale instanced cast on the per-ray kernel.

        Memory ~ meshes (never flattens); prim_id is reported in the
        flattened scene's global numbering (instance base + mesh-local
        id) so results are directly comparable with ``cast_rays``.
        Returns (hits, stats, occluded, instance_id)."""
        if self._itables is None:
            self.build_instanced()
        return cast_rays_walk_instanced(
            rays, self._itables, query_mask=int(query_mask), any_hit=any_hit,
        )

    def instanced_scene(self) -> InstancedScene:
        """Scene-like view over the instanced tables for renderers and
        the wavefront path tracer: full frames with memory ~ MESHES,
        never flattening (the reference's CPU PT traces through the TLAS
        dispatcher, cpu_path_tracer.h:56-223 -> scene_tlas.h:203-251).
        Prim ids are in the flattened global numbering, so material and
        attribute tables built for the flat scene apply."""
        if self._itables is None:
            self.build_instanced()
        return InstancedScene(tables=self._itables,
                              bounds=self._itables.bounds)

    # ---- instance-accurate two-level cast (jnp reference path) -------
    def cast_rays_two_level(self, rays: Rays, query_mask=ALL_LAYERS):
        """Loop over instances: world-AABB cull, transform ray to object
        space (no direction renormalize, blas_instance.h:48-59), traverse
        the BLAS, keep the closest world-t hit.  O(instances) like the
        reference's brute fallback (scene_tlas.h:345-379); exact two-level
        semantics for validation and for memory-constrained scenes.

        prim_id uses the flattened scene's global numbering (instance
        base + mesh-local id) like every other cast path; the mesh-local
        id is ``prim_id - prim_base[instance_id]``."""
        n = rays.count
        prim_base = np.zeros(len(self.instances), np.int64)
        acc = 0
        for i, inst in enumerate(self.instances):
            prim_base[i] = acc
            acc += self.meshes[inst.blas_id].num_tris
        best = None
        best_inst = jnp.full((n,), -1, jnp.int32)
        for i, inst in enumerate(self.instances):
            blas = self.meshes[inst.blas_id].scene
            inv = jnp.asarray(inst.inv_transform)
            o = _apply_rt(inv, rays.origin)
            d = _apply_rt(inv, rays.direction, translate=False)  # NOT renormalized
            obj_rays = Rays(
                origin=o, direction=d, t_min=rays.t_min, t_max=rays.t_max
            )
            mask = query_mask if inst.layers == ALL_LAYERS else (
                jnp.asarray(query_mask) & inst.layers
            )
            h, _ = blas.cast_rays(obj_rays, mask)
            # transform hit back to world: position via forward transform,
            # normal via inverse-transpose basis (blas_instance.h:62-70)
            m = jnp.asarray(inst.transform)
            wpos = _apply_rt(m, h.position)
            # (R^-1)^T basis: n @ R^-1, as explicit f32 mul-adds
            nx, ny, nz = h.normal[:, 0], h.normal[:, 1], h.normal[:, 2]
            wnrm = jnp.stack(
                [
                    nx * inv[0, 0] + ny * inv[1, 0] + nz * inv[2, 0],
                    nx * inv[0, 1] + ny * inv[1, 1] + nz * inv[2, 1],
                    nx * inv[0, 2] + ny * inv[1, 2] + nz * inv[2, 2],
                ],
                axis=-1,
            )
            nlen = jnp.linalg.norm(wnrm, axis=-1, keepdims=True)
            wnrm = wnrm / jnp.where(nlen > 0, nlen, 1.0)
            h = Hits(
                t=h.t,
                position=jnp.where(h.hit[:, None], wpos, 0.0),
                normal=jnp.where(h.hit[:, None], wnrm, 0.0),
                u=h.u, v=h.v,
                prim_id=jnp.where(
                    h.hit, h.prim_id + jnp.int32(prim_base[i]), NO_HIT
                ),
                hit_layers=h.hit_layers,
            )
            if best is None:
                best = h
                best_inst = jnp.where(h.hit, i, -1)
            else:
                closer = h.hit & (h.t < best.t)
                best = Hits(
                    t=jnp.where(closer, h.t, best.t),
                    position=jnp.where(closer[:, None], h.position, best.position),
                    normal=jnp.where(closer[:, None], h.normal, best.normal),
                    u=jnp.where(closer, h.u, best.u),
                    v=jnp.where(closer, h.v, best.v),
                    prim_id=jnp.where(closer, h.prim_id, best.prim_id),
                    hit_layers=jnp.where(closer, h.hit_layers, best.hit_layers),
                )
                best_inst = jnp.where(closer, i, best_inst)
        return best, best_inst


def _build_forest(meshes) -> dict:
    """Concatenate the meshes' BLAS BVHs and slot-ordered triangles.

    Node ids stay mesh-relative for internal nodes (offset by the mesh's
    first node) and become global tri slots for leaves; the TLAS size is
    added when the tables are assembled."""
    cat = np.concatenate
    mins, maxs, lfs, cnts, axes, node_off = [], [], [], [], [], []
    n_nodes = n_tris = 0
    levels = 1
    for m in meshes:
        bvh = m.scene.bvh
        cnt = _bvh_host(bvh, "count")
        lf = _bvh_host(bvh, "left_first")
        node_off.append(n_nodes)
        mins.append(_bvh_host(bvh, "aabb_min"))
        maxs.append(_bvh_host(bvh, "aabb_max"))
        lfs.append(np.where(cnt > 0, lf + n_tris, lf + n_nodes))
        cnts.append(cnt)
        axes.append(_bvh_host(bvh, "split_axis"))
        levels = max(levels, len(bvh.levels))
        n_nodes += cnt.shape[0]
        n_tris += m.num_tris
    parts = [m.scene.tris for m in meshes]
    tris = Triangles(**{
        f: jnp.concatenate([getattr(t, f) for t in parts])
        for f in ("v0", "edge1", "edge2", "normal", "prim_id", "layers")
    })
    return {
        "aabb_min": cat(mins).astype(np.float32),
        "aabb_max": cat(maxs).astype(np.float32),
        "left_first": cat(lfs).astype(np.int32),
        "count": cat(cnts).astype(np.int32),
        "split_axis": cat(axes).astype(np.int32),
        "node_off": np.asarray(node_off, np.int64),
        "levels": levels,
        "tris": tris,
    }


def _build_instance_tables(forest: dict, meshes, instances) -> InstanceTables:
    """TLAS (singleton leaves) over instance world AABBs, joined with the
    BLAS forest into one node space (kernels/walk.py InstanceTables)."""
    n_inst = len(instances)
    box_min = np.zeros((n_inst, 3), np.float32)
    box_max = np.zeros((n_inst, 3), np.float32)
    prim_base = np.zeros(n_inst, np.int64)
    acc = 0
    for i, inst in enumerate(instances):
        omn, omx = meshes[inst.blas_id].object_bounds()
        box_min[i], box_max[i] = inst.world_aabb(omn, omx)
        prim_base[i] = acc
        acc += meshes[inst.blas_id].num_tris
    tbvh = build_bvh_over_aabbs(box_min, box_max, (box_min + box_max) * 0.5,
                                max_leaf_size=1)
    t_cnt = _bvh_host(tbvh, "count")
    t_lf = _bvh_host(tbvh, "left_first")
    order = _bvh_host(tbvh, "tri_order")
    n_tlas = t_cnt.shape[0]
    # TLAS leaves carry their instance id; forest internal nodes move past
    # the TLAS in the joint node space
    t_lf = np.where(t_cnt > 0, order[np.clip(t_lf, 0, n_inst - 1)], t_lf)
    f_lf = np.where(forest["count"] > 0, forest["left_first"],
                    forest["left_first"] + n_tlas)
    cat = np.concatenate
    blas = np.asarray([i.blas_id for i in instances], np.int64)
    return InstanceTables(
        aabb_min=jnp.asarray(cat([_bvh_host(tbvh, "aabb_min"),
                                  forest["aabb_min"]])),
        aabb_max=jnp.asarray(cat([_bvh_host(tbvh, "aabb_max"),
                                  forest["aabb_max"]])),
        left_first=jnp.asarray(cat([t_lf, f_lf]).astype(np.int32)),
        count=jnp.asarray(cat([t_cnt, forest["count"]]).astype(np.int32)),
        split_axis=jnp.asarray(cat([_bvh_host(tbvh, "split_axis"),
                                    forest["split_axis"]]).astype(np.int32)),
        tris=forest["tris"],
        inst_inv=jnp.asarray(
            np.stack([i.inv_transform for i in instances]).reshape(-1)),
        inst_root=jnp.asarray(
            (forest["node_off"][blas] + n_tlas).astype(np.int32)),
        inst_layers=jnp.asarray(
            np.asarray([i.layers for i in instances], np.int64)
            .astype(np.int32)),
        inst_prim_base=jnp.asarray(prim_base.astype(np.int32)),
        n_tlas=int(n_tlas),
        levels=len(tbvh.levels) + int(forest["levels"]),
    )


@jax.jit
def _tlas_refit_jit(bvh, old_tris, obj_slots, slot_inst, transforms):
    """Device-side: world tris from object tris + per-instance transforms,
    then triangle rederivation + BVH refit."""
    r = transforms[slot_inst, :, :3]       # (F,3,3)
    t = transforms[slot_inst, :, 3]        # (F,3)
    # explicit f32 mul-adds: an einsum is a matrix product the GPU may
    # run in TF32 (~1e-3 coordinate error); refit must stay exact f32.
    world = (
        r[:, None, :, 0] * obj_slots[:, :, None, 0]
        + r[:, None, :, 1] * obj_slots[:, :, None, 1]
        + r[:, None, :, 2] * obj_slots[:, :, None, 2]
        + t[:, None, :]
    )
    v0, v1, v2 = world[:, 0], world[:, 1], world[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = jnp.cross(e1, e2)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nlen > 0, nlen, 1.0)
    tris = Triangles(
        v0=v0, edge1=e1, edge2=e2, normal=nrm,
        prim_id=old_tris.prim_id, layers=old_tris.layers,
    )
    from ..accel.bvh import refit_bvh
    from ..core.geometry import aabb_of_triangles

    tmin, tmax = aabb_of_triangles(tris.v0, tris.v1, tris.v2)
    return tris, refit_bvh(bvh, tmin, tmax)
