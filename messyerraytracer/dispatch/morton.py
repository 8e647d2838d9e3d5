"""Morton-code ray sorting for traversal coherence.

Rewrite of ``src/dispatch/ray_sort.h``: the bit-spread, direction
quantization, and 30-bit Morton encode are identical (ray_sort.h:41-76), but
the sort itself is a device-side ``jnp.argsort`` over the whole batch instead
of a host ``std::sort``, and permutation apply/unshuffle are dense gathers
(ray_sort.h:87-152).

Also provides the pixel-block swizzle used for *coherent* primary rays:
reordering a raster-order W x H ray grid into square pixel blocks so each
run of consecutive rays is a 32x32 screen block instead of a 1024x1 strip
— what the reference's ``coherent`` query hint (ray_query.h:72-76) buys:
skipping the Morton sort but still keeping neighbouring rays together.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Hits, Rays


def morton_spread_10(v: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits to 30 by inserting 2 zero bits between each bit
    (ray_sort.h:41-50)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_encode_3d(x, y, z):
    """30-bit 3D Morton code (ray_sort.h:53-58)."""
    return (
        (morton_spread_10(x) << 2) | (morton_spread_10(y) << 1) | morton_spread_10(z)
    )


def ray_direction_morton(direction: jnp.ndarray) -> jnp.ndarray:
    """(N,) int32 Morton keys from direction vectors, [-1,1]^3 -> [0,1023]^3
    (ray_sort.h:64-76)."""
    n = jnp.clip((direction + 1.0) * 0.5, 0.0, 1.0)
    q = (n * 1023.0).astype(jnp.int32)
    return morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])


def ray_position_morton(origin: jnp.ndarray, lo, hi) -> jnp.ndarray:
    """Origin-based Morton keys over a scene AABB — better for secondary
    rays whose origins scatter (not in the reference)."""
    n = jnp.clip((origin - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
    q = (n * 1023.0).astype(jnp.int32)
    return morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])


def sort_rays_by_direction(rays: Rays) -> tuple[Rays, jnp.ndarray]:
    """Stable-sort rays by direction Morton key.

    Returns (sorted_rays, perm) with ``sorted[i] = rays[perm[i]]``
    (ray_sort.h:87-113 semantics, device-side).
    """
    keys = ray_direction_morton(rays.direction)
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)
    return apply_permutation(rays, perm), perm


def ray_6d_morton(origin: jnp.ndarray, direction: jnp.ndarray,
                  lo, hi) -> jnp.ndarray:
    """Origin-major 6D coherence key: 27-bit origin Morton (9 bits/axis
    over the scene AABB) with the 3-bit direction octant as the minor
    bits.  Fully incoherent batches (random origins AND directions) sort
    into runs that are compact in SPACE first: neighbouring rays then
    touch the same nodes, and scattered origins, not scattered
    directions, are what spread them.  (The reference's direction-only
    sort is ray_sort.h:64-76.)"""
    n = jnp.clip((origin - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
    q = (n * 511.0).astype(jnp.int32)   # 9 bits/axis -> 27-bit Morton
    okey = morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])
    octant = (
        ((direction[:, 0] < 0).astype(jnp.int32) << 2)
        | ((direction[:, 1] < 0).astype(jnp.int32) << 1)
        | (direction[:, 2] < 0).astype(jnp.int32)
    )
    return (okey << 3) | octant


def sort_rays_6d(rays: Rays, lo, hi, octant_major: bool = True,
                 dir_bits: int = 1) -> tuple[Rays, jnp.ndarray]:
    """Stable-sort rays by the 6D key (incoherent batches).

    octant_major (default) puts ``dir_bits`` direction Morton bits per
    axis ABOVE the origin Morton bits: tiles share a traversal
    direction, so the kernel's front-to-back consensus ordering and
    early-out work, and the tile's traversal footprint stops being the
    union of all directions — measured 2.1x over origin-major and 2.3x
    over the reference's direction-only key on 512K fully random rays
    (PERF.md r3).  octant_major=False keys origin-major with the octant
    minor instead.

    Returns (sorted_rays, perm) with ``sorted[i] = rays[perm[i]]``."""
    perm = sort_perm_6d(rays, lo, hi, octant_major=octant_major,
                        dir_bits=dir_bits)
    return apply_permutation(rays, perm), perm


def sort_perm_6d(rays: Rays, lo, hi, octant_major: bool = True,
                 dir_bits: int = 1, live=None) -> jnp.ndarray:
    """The 6D coherence-sort permutation alone (no gathers applied) —
    for callers that permute a larger carried state themselves (the
    wavefront tracer's carried-sort frame).

    ``live`` (bool (N,), optional): dead rays get the maximal key so
    they compact at the END into all-dead kernel tiles (which exit
    after one root pop) instead of diluting live rows — late PT waves
    are mostly dead (RR + misses) and otherwise pay near-full-frame
    traversal cost."""
    if octant_major:
        b = dir_bits
        qmax = (1 << b) - 1
        nd = jnp.clip((rays.direction + 1.0) * 0.5, 0.0, 1.0)
        qd = jnp.minimum((nd * (qmax + 1)).astype(jnp.int32), qmax)
        dirm = morton_encode_3d(qd[:, 0], qd[:, 1], qd[:, 2])
        # encode3d of b-bit inputs occupies the low 3b bits
        no = jnp.clip((rays.origin - lo)
                      / jnp.maximum(hi - lo, 1e-12), 0.0, 1.0)
        qo = (no * 511.0).astype(jnp.int32)
        okey = morton_encode_3d(qo[:, 0], qo[:, 1], qo[:, 2])  # 27 bits
        minor = 28 - 3 * b
        keys = (dirm << minor) | (okey >> (27 - minor))
    else:
        keys = ray_6d_morton(rays.origin, rays.direction, lo, hi)
    if live is not None:
        keys = jnp.where(live, keys, jnp.int32(0x7FFFFFFF))
    return jnp.argsort(keys, stable=True).astype(jnp.int32)


# Live-first compaction is a masked-key stable argsort + gathers
# (sort_perm_6d(live=...)); a cumsum + scatter partition is the
# alternative, not measured on the GPU yet.


def apply_permutation(rays: Rays, perm: jnp.ndarray) -> Rays:
    """Permute a ray batch with ONE packed gather.

    One (N,8) row gather instead of four per-field gathers."""
    packed = jnp.concatenate(
        [rays.origin, rays.direction, rays.t_min[:, None],
         rays.t_max[:, None]], axis=1)
    g = packed[perm]
    return Rays(origin=g[:, 0:3], direction=g[:, 3:6],
                t_min=g[:, 6], t_max=g[:, 7])


def unshuffle_hits(hits: Hits, perm: jnp.ndarray) -> Hits:
    """Invert the sort permutation on a Hits batch
    (unshuffle_intersections, ray_sort.h:133-141).  One packed f32
    gather + one packed i32 gather (see apply_permutation)."""
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(perm.shape[0], dtype=perm.dtype)
    )
    pf = jnp.concatenate(
        [hits.t[:, None], hits.position, hits.normal,
         hits.u[:, None], hits.v[:, None]], axis=1)[inv]
    pi = jnp.stack([hits.prim_id, hits.hit_layers], axis=1)[inv]
    return Hits(
        t=pf[:, 0],
        position=pf[:, 1:4],
        normal=pf[:, 4:7],
        u=pf[:, 7],
        v=pf[:, 8],
        prim_id=pi[:, 0],
        hit_layers=pi[:, 1],
    )


def unshuffle_flags(flags: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    """Invert the permutation on a bool array (unshuffle_bools,
    ray_sort.h:144-152)."""
    return jnp.zeros_like(flags).at[perm].set(flags)


def raster_block_permutation(width: int, height: int, block: int = 32,
                             patch: tuple[int, int] | None = (16, 8)
                             ) -> np.ndarray:
    """Static permutation: raster order -> block-major order.

    ``perm[i]`` = raster index of the ray that should sit at position i, so
    consecutive ``block*block`` rays form one square screen block (pad
    blocks at the right/bottom edges are smaller).  Host/numpy — it depends
    only on (width, height, block, patch) and is cached by callers.

    ``patch=(pw, ph)`` additionally orders pixels WITHIN each block by
    pw x ph sub-patches (patch-major, raster within the patch):
    patch=(16, 8) makes each run of 128 rays — one traversal-kernel block
    — a 16x8 screen patch instead of a 32x4 strip, so a block's rays
    touch fewer distinct nodes.
    """
    ys, xs = np.mgrid[0:height, 0:width]
    by, bx = ys // block, xs // block
    yb, xb = ys % block, xs % block
    bkey = by * ((width + block - 1) // block) + bx
    if patch is None:
        inkey = yb * block + xb
    else:
        pw, ph = min(patch[0], block), min(patch[1], block)
        pidx = (yb // ph) * (block // pw) + (xb // pw)
        inkey = (pidx * ph + yb % ph) * pw + xb % pw
    key = bkey * (block * block) + inkey
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)
