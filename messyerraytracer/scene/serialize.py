"""Scene checkpointing: save/load built scenes without rebuilding.

The reference rebuilds from the live Godot scene tree on every build()
(the "Godot-Native Principle", SURVEY.md §5) and leaves TinyBVH's BVH file
cache unused (tiny_bvh.h:96-97).  For a headless framework the
device-resident scene arrays ARE the state, so checkpointing is a plain
.npz round trip of every SoA array — build once (the only host-side step),
reload in milliseconds on any host.
"""

from __future__ import annotations

import numpy as np

from ..accel.bvh import BVH
from ..core.types import Triangles
from .scene import BACKENDS, RayScene

import jax.numpy as jnp

_FORMAT_VERSION = 3


def save_scene(path: str, scene: RayScene) -> None:
    """Serialize a built RayScene (tris + BVH) to ``path``."""
    arrs = {
        "format_version": np.int32(_FORMAT_VERSION),
        "use_bvh": np.bool_(scene.use_bvh),
        "backend": np.bytes_(scene.backend.encode()),
        # triangles
        "tri_v0": np.asarray(scene.tris.v0),
        "tri_e1": np.asarray(scene.tris.edge1),
        "tri_e2": np.asarray(scene.tris.edge2),
        "tri_n": np.asarray(scene.tris.normal),
        "tri_pid": np.asarray(scene.tris.prim_id),
        "tri_lay": np.asarray(scene.tris.layers),
        # bvh
        "bvh_min": np.asarray(scene.bvh.aabb_min),
        "bvh_max": np.asarray(scene.bvh.aabb_max),
        "bvh_lf": np.asarray(scene.bvh.left_first),
        "bvh_cnt": np.asarray(scene.bvh.count),
        "bvh_order": np.asarray(scene.bvh.tri_order),
        "bvh_axis": np.asarray(scene.bvh.split_axis),
        "bvh_num_levels": np.int32(len(scene.bvh.levels)),
    }
    for i, lvl in enumerate(scene.bvh.levels):
        arrs[f"bvh_level_{i}"] = np.asarray(lvl)
    np.savez_compressed(path, **arrs)


def load_scene(path: str) -> RayScene:
    """Load a scene saved by ``save_scene``; arrays go straight to device."""
    z = np.load(path)
    assert int(z["format_version"]) in (1, 2, 3), "scene format mismatch"
    tris = Triangles(
        v0=jnp.asarray(z["tri_v0"]), edge1=jnp.asarray(z["tri_e1"]),
        edge2=jnp.asarray(z["tri_e2"]), normal=jnp.asarray(z["tri_n"]),
        prim_id=jnp.asarray(z["tri_pid"]), layers=jnp.asarray(z["tri_lay"]),
    )
    levels = tuple(
        jnp.asarray(z[f"bvh_level_{i}"]) for i in range(int(z["bvh_num_levels"]))
    )
    bvh = BVH(
        aabb_min=jnp.asarray(z["bvh_min"]), aabb_max=jnp.asarray(z["bvh_max"]),
        left_first=jnp.asarray(z["bvh_lf"]), count=jnp.asarray(z["bvh_cnt"]),
        tri_order=jnp.asarray(z["bvh_order"]),
        split_axis=jnp.asarray(z["bvh_axis"]), levels=levels,
    )
    # files from before the traversal kernel name retired backends; the
    # scene's own tables are all any backend needs
    backend = bytes(z["backend"]).decode()
    if backend not in BACKENDS:
        backend = "kernel"
    return RayScene(tris=tris, bvh=bvh, use_bvh=bool(z["use_bvh"]),
                    backend=backend)
