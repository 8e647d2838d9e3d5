"""User-facing service API — rewrite of the reference's api/ firewall
and RayTracerServer.

Maps the reference surface onto the JAX backend:

  * ``RayQuery`` / ``RayQueryResult`` — the POD batch request/response
    (src/api/ray_query.h:52-118): rays + layer mask + NEAREST/ANY_HIT mode
    + ``coherent`` hint + ``collect_stats``
  * ``RayTracerService`` — the central server object
    (src/godot/raytracer_server.{h,cpp} + src/api/ray_service.h:42-179):
    mesh/instance registration, scene (re)build, single + batch casts,
    backend switching, per-cast stats and timing,
    async submit/collect
  * ``RayBatch`` — incremental builder for script-style use
    (src/godot/ray_batch.{h,cpp})
  * ``probe_cast`` — RayTracerProbe-style cast from a transform
    (src/godot/raytracer_probe.*)

Locking note: the reference guards its scene with a shared_mutex
(raytracer_server.h:90-93) because casts and rebuilds race; here scene
state is immutable device arrays — a rebuild creates a new array set while
in-flight casts keep the old ones alive (XLA buffers are refcounted), so
no lock exists at all.

Async note: the reference exposes submit_async/collect for GPU overlap
(ray_dispatcher.h:290-354).  JAX dispatch is already asynchronous — a cast
returns device arrays immediately while the device works; ``collect`` simply
blocks on the result.  ``submit_async``/``collect_async`` make that
contract explicit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import ALL_LAYERS, Hits, Rays, RayStats, make_rays
from ..dispatch.dispatcher import RayDispatcher
from ..accel.tlas import SceneTLAS, _to_mat4
from ..scene.scene import BACKENDS as SCENE_BACKENDS, RayScene

MODE_NEAREST = 0  # ray_query.h RayQueryMode
MODE_ANY_HIT = 1


@dataclasses.dataclass
class RayQuery:
    """Batch cast request (src/api/ray_query.h:52-89)."""

    rays: Rays
    layer_mask: int = ALL_LAYERS
    mode: int = MODE_NEAREST
    coherent: bool = False     # primary rays: skip Morton sort
    collect_stats: bool = True


@dataclasses.dataclass
class RayQueryResult:
    """Batch cast response (src/api/ray_query.h:95-118)."""

    hits: Optional[Hits] = None
    hit_flags: Optional[jnp.ndarray] = None   # ANY_HIT mode
    stats: Optional[RayStats] = None
    elapsed_ms: float = 0.0


class RayTracerService:
    """The central scene-owning service (RayTracerServer analogue).

    Usage mirrors the reference demos: ``register_mesh`` (optionally many
    times / with transforms), ``build()``, then ``cast_ray`` / ``submit``.
    """

    # CPU/GPU/AUTO analogue: "auto" is the traversal kernel
    BACKENDS = SCENE_BACKENDS + ("auto",)

    def __init__(self, backend: str = "auto"):
        assert backend in self.BACKENDS
        self._backend = backend
        self._tlas = SceneTLAS()
        self._dispatcher: RayDispatcher | None = None
        self._last_stats: RayStats | None = None
        self._last_elapsed_ms = 0.0
        self._pending: list[tuple] = []

    # ---- scene management (ray_service.h:49-70) ----------------------
    def register_mesh(self, tri_array, transform=None,
                      layers: int = ALL_LAYERS) -> int:
        """Register a mesh instance; returns instance id.

        ``tri_array``: (T,3,3) object-space vertices.  ``transform``: 4x4 /
        3x4 world transform (identity if None).  Meshes with identical
        geometry can be registered once and instanced via
        ``add_instance``.
        """
        blas_id = self._tlas.add_mesh(np.asarray(tri_array, np.float32))
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        return self._tlas.add_instance(blas_id, transform, layers)

    def add_instance(self, blas_id: int, transform,
                     layers: int = ALL_LAYERS) -> int:
        return self._tlas.add_instance(blas_id, transform, layers)

    def build(self) -> None:
        """(Re)build the scene (RayTracerServer::build,
        raytracer_server.cpp:161-181)."""
        self._tlas.build_tlas()
        self._dispatcher = RayDispatcher(self._tlas.flat,
                                         backend=self._resolve_backend())

    def set_transform(self, instance_id: int, transform) -> None:
        self._tlas.set_transform(instance_id, transform)

    def refit(self) -> None:
        """Device-side refit after transform updates (10-100x cheaper than
        build, scene_tlas.h:178-196)."""
        self._tlas.refit_tlas()
        self._dispatcher = RayDispatcher(self._tlas.flat,
                                         backend=self._resolve_backend())

    def clear_scene(self) -> None:
        self._tlas = SceneTLAS()
        self._dispatcher = None

    @property
    def scene(self) -> RayScene | None:
        return self._tlas.flat

    @property
    def tlas(self) -> SceneTLAS:
        return self._tlas

    # ---- backend control (ray_service.h:95-110) ----------------------
    def set_backend(self, backend: str) -> None:
        """Switch cast backend (raytracer_server.cpp:348-355); "auto" is
        the traversal kernel."""
        assert backend in self.BACKENDS
        self._backend = backend
        if self._dispatcher is not None:
            self._dispatcher.backend = self._resolve_backend()

    def get_backend(self) -> str:
        return self._resolve_backend()

    def _resolve_backend(self) -> str:
        return "kernel" if self._backend == "auto" else self._backend

    # ---- casts (ray_service.h:72-93) ----------------------------------
    def cast_ray(self, origin, direction, t_min=1e-3, t_max=None,
                 layer_mask: int = ALL_LAYERS) -> dict:
        """Single-ray convenience; returns a dict like the reference's
        GDScript API (raytracer_server.cpp:253-272):
        {hit, position, normal, distance, prim_id, hit_layers,
        instance_id}."""
        rays = make_rays(origin, direction, t_min=t_min, t_max=t_max)
        res = self.submit(RayQuery(rays=rays, layer_mask=layer_mask))
        h = res.hits
        inst = self._tlas._instance_of_hits(h)
        return {
            "hit": bool(h.hit[0]),
            "position": np.asarray(h.position[0]),
            "normal": np.asarray(h.normal[0]),
            "distance": float(h.t[0]) if bool(h.hit[0]) else float("inf"),
            "prim_id": int(h.prim_id[0]),
            "hit_layers": int(h.hit_layers[0]),
            "instance_id": int(inst[0]),
        }

    def submit(self, query: RayQuery) -> RayQueryResult:
        """Batch cast — the preferred module entry point
        (RayTracerServer::submit, raytracer_server.cpp:295-328); wall-clock
        timed."""
        assert self._dispatcher is not None, "submit: call build() first"
        t0 = time.perf_counter()
        result = RayQueryResult()
        if query.mode == MODE_ANY_HIT:
            occ = self._dispatcher.any_hit_rays(
                query.rays, query.layer_mask, coherent=query.coherent
            )
            occ.block_until_ready()
            result.hit_flags = occ
        else:
            hits, stats = self._dispatcher.cast_rays(
                query.rays, query.layer_mask, coherent=query.coherent
            )
            hits.t.block_until_ready()
            result.hits = hits
            if query.collect_stats:
                result.stats = stats
                self._last_stats = stats
        result.elapsed_ms = (time.perf_counter() - t0) * 1e3
        self._last_elapsed_ms = result.elapsed_ms
        return result

    def cast_rays_batch(self, rays: Rays, layer_mask: int = ALL_LAYERS,
                        coherent: bool = False) -> tuple[Hits, RayStats]:
        res = self.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, coherent=coherent)
        )
        return res.hits, res.stats

    def any_hit_batch(self, rays: Rays, layer_mask: int = ALL_LAYERS):
        res = self.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, mode=MODE_ANY_HIT)
        )
        return res.hit_flags

    # ---- async (ray_service.h:112-131; dispatch is async by nature) ---
    def submit_async(self, query: RayQuery) -> int:
        """Launch a cast without blocking; returns a ticket for
        ``collect_async``.  The device computes in the background."""
        assert self._dispatcher is not None, "submit_async: build() first"
        if query.mode == MODE_ANY_HIT:
            occ = self._dispatcher.any_hit_rays(
                query.rays, query.layer_mask, coherent=query.coherent
            )
            payload = (None, occ, None)
        else:
            hits, stats = self._dispatcher.cast_rays(
                query.rays, query.layer_mask, coherent=query.coherent
            )
            payload = (hits, None, stats)
        self._pending.append(payload)
        return len(self._pending) - 1

    def collect_async(self, ticket: int) -> RayQueryResult:
        """Block until the ticketed cast finishes and return it."""
        hits, occ, stats = self._pending[ticket]
        result = RayQueryResult(hits=hits, hit_flags=occ, stats=stats)
        if hits is not None:
            hits.t.block_until_ready()
        if occ is not None:
            occ.block_until_ready()
        return result

    # ---- stats / observability (raytracer_server.cpp:376-391) --------
    def get_last_stats(self) -> dict:
        if self._last_stats is None:
            return {}
        from ..debug.debug import stats_summary

        d = stats_summary(self._last_stats)
        d["elapsed_ms"] = self._last_elapsed_ms
        d["backend"] = self._resolve_backend()
        return d


class RayBatch:
    """Incremental ray batch builder (src/godot/ray_batch.{h,cpp}):
    ``add_ray`` repeatedly, ``cast()`` once, then read indexed results."""

    def __init__(self, service: RayTracerService):
        self._svc = service
        self._origins: list = []
        self._dirs: list = []
        self._tmins: list = []
        self._tmaxs: list = []
        self._result: RayQueryResult | None = None

    def add_ray(self, origin, direction) -> int:
        return self.add_ray_ex(origin, direction, 1e-3, 3.4e38)

    def add_ray_ex(self, origin, direction, t_min, t_max) -> int:
        self._origins.append(tuple(origin))
        self._dirs.append(tuple(direction))
        self._tmins.append(float(t_min))
        self._tmaxs.append(float(t_max))
        return len(self._origins) - 1

    @property
    def size(self) -> int:
        return len(self._origins)

    def clear(self) -> None:
        self.__init__(self._svc)

    def cast(self, layer_mask: int = ALL_LAYERS, coherent=False) -> None:
        rays = Rays(
            origin=jnp.asarray(self._origins, jnp.float32),
            direction=jnp.asarray(self._dirs, jnp.float32),
            t_min=jnp.asarray(self._tmins, jnp.float32),
            t_max=jnp.asarray(self._tmaxs, jnp.float32),
        )
        self._result = self._svc.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, coherent=coherent)
        )

    def _h(self):
        assert self._result is not None, "cast() first"
        return self._result.hits

    def is_hit(self, i: int) -> bool:
        return bool(self._h().hit[i])

    def get_distance(self, i: int) -> float:
        return float(self._h().t[i])

    def get_position(self, i: int) -> np.ndarray:
        return np.asarray(self._h().position[i])

    def get_normal(self, i: int) -> np.ndarray:
        return np.asarray(self._h().normal[i])

    def get_prim_id(self, i: int) -> int:
        return int(self._h().prim_id[i])

    def get_stats(self) -> dict:
        return self._svc.get_last_stats()


def probe_cast(service: RayTracerService, transform, local_direction=(0, 0, -1),
               max_distance=1000.0, layer_mask: int = ALL_LAYERS) -> dict:
    """Cast from a node transform like RayTracerProbe
    (src/godot/raytracer_probe.*): origin = transform translation,
    direction = local direction through the basis."""
    m = _to_mat4(transform)
    origin = m[:, 3]
    d = m[:, :3] @ np.asarray(local_direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-12)
    return service.cast_ray(origin, d, t_max=max_distance,
                            layer_mask=layer_mask)
