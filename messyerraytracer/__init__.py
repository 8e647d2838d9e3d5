"""messyerraytracer — a JAX ray-casting and path-tracing framework.

A ground-up JAX / XLA / Pallas rebuild of the capabilities of
MessyerRaytracer (a Godot GDExtension C++ raytracer with CPU-SIMD and Vulkan
compute backends).  The reference's thread-pool + SSE packet path and its GPU
compute path collapse into a single JAX backend: ray generation, Morton-code
ray sorting, slab AABB tests, Moller-Trumbore intersection, and binned-SAH
BVH build / refit / traversal run over HBM-resident SoA scene arrays, with
the hot traversal loops as Pallas kernels.

Public API mirrors the reference's ``build_scene`` / ``cast_ray`` /
batch-cast surface with the same hit semantics
(t, position, normal, u/v, prim_id, layer masks) — see SURVEY.md.
"""

__version__ = "0.1.0"


_malloc_tuned = False


def _tune_malloc():
    """Keep 100MB-class build buffers on the heap instead of mmap.

    glibc mmap()s allocations above ~32MB and returns them to the OS on
    free, so every scene (re)build pays first-touch page faults on its
    large numpy staging buffers — measured ~25s of a 39s cold 1M-triangle
    build.  Raising M_MMAP_THRESHOLD (mallopt param -3) makes the heap
    reuse those pages: cold build 39s -> 14s, warm 14s -> 9s (CPU host).

    Called lazily from the scene-build entry points (NOT at import): it
    mutates the process-global allocator, which only pays off for
    builds, and applications that merely import the package should not
    inherit a higher steady-state RSS.
    """
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD = 1 GB
    except Exception:
        pass  # non-glibc platforms: harmless to skip


from .core.types import (  # noqa: F401
    ALL_LAYERS,
    NO_HIT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    make_rays,
    make_triangles,
)
from .render.camera import CameraParams, debug_grid_rays, generate_rays  # noqa: F401
