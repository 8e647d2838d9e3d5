"""Wavefront path tracer — rewrite of ``GPUPathTracer``.

The reference runs 4 compute kernels per bounce on GPU-resident buffers
with no host round trip until the final accumulation
(src/modules/graphics/gpu_path_tracer.cpp:197-283):

    Generate -> [ Extend -> Shade -> Connect ] x bounces -> finalize-Shade

Here each kernel is a jitted stage over HBM-resident SoA path-state arrays
and the compute barriers between dispatches are just XLA dataflow
(SURVEY.md §2.10: kernel-to-kernel handoff is dataflow, not barriers).

Protocol details mirrored from the shaders:

  * **deferred NEE** (pt_shade.comp.glsl:598-635): Shade at bounce b
    *stores* the light contribution as ``pending_nee`` without adding it;
    Connect then traces the shadow ray; the NEXT Shade (or the finalize
    pass at bounce > max_bounces) multiplies the pending contribution by
    Connect's visibility and accumulates it.
  * **stochastic single-light NEE** (pt_shade.comp.glsl:697-717): one
    uniformly-picked light per bounce, contribution multiplied by the
    light count to stay unbiased.
  * per-pixel PCG32 seeded exactly like the CPU path
    (pt_generate.comp.glsl:94-103 mirrors path_state.h:84-93).
  * Russian roulette from bounce 2 (pt_shade.comp.glsl:753-764).
  * finalize applies tonemap + gamma (pt_shade.comp.glsl:613-616).

The iterative CPU-style tracer (render/pathtrace.py) applies NEE in the
same bounce instead; both converge to the same estimator in expectation —
parity is statistical, covered by tests comparing mean images.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..core.types import Rays
from ..kernels.walk import KernelScene
from ..utils.struct import pytree_dataclass
from .pathtrace import (
    SHADOW_EPS,
    pcg32_float,
    pcg32_seed,
    sample_bounce,
)
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    cook_torrance_single,
    extract_surface,
    light_sample_picked,
    sky_color,
    to_srgb,
    tonemap,
)

PI = 3.14159265358979


def _prefix_buckets(n: int, levels: int = 5, floor: int = 16384):
    """Static live-prefix bucket sizes: n, then halving (2048-aligned)
    down to ``floor``.  PT live counts shrink roughly 2x per bounce, so
    halving buckets keep the sorted prefix within ~2x of the live
    count."""
    out = [n]
    b = n
    for _ in range(levels - 1):
        b = max(floor, ((b // 2) + 2047) // 2048 * 2048)
        if b >= out[-1]:
            break
        out.append(b)
    return out


def _switch_prefix(buckets, cnt, fn):
    """lax.switch over static prefix sizes: runs ``fn(B)`` for the
    smallest bucket B >= cnt.  Branch bodies are XLA-only (sorts,
    gathers); kernel casts are hoisted out so each stays one full-shape
    instance (dead rays retire at the kernel's root-box gate)."""
    if len(buckets) == 1:
        return fn(buckets[0])
    idx = jnp.int32(0)
    for t in buckets[1:]:
        idx = idx + (cnt <= t).astype(jnp.int32)
    return jax.lax.switch(idx, [functools.partial(fn, b)
                                for b in buckets])


def _slice_rays(r: Rays, b: int, tail: bool = False) -> Rays:
    sl = (lambda x: x[b:]) if tail else (lambda x: x[:b])
    return Rays(origin=sl(r.origin), direction=sl(r.direction),
                t_min=sl(r.t_min), t_max=sl(r.t_max))


def _concat_rays(a: Rays, b: Rays) -> Rays:
    cat = jnp.concatenate
    return Rays(origin=cat([a.origin, b.origin]),
                direction=cat([a.direction, b.direction]),
                t_min=cat([a.t_min, b.t_min]),
                t_max=cat([a.t_max, b.t_max]))


@pytree_dataclass
class WavefrontState:
    """GPU-resident path state (GPUPathStatePacked analogue,
    api/gpu_types.h): throughput/accum + the deferred-NEE slot + RNG +
    current and shadow rays, all (N,...) SoA."""

    throughput: jnp.ndarray    # (N, 3)
    accum: jnp.ndarray         # (N, 3)
    pending_nee: jnp.ndarray   # (N, 3) deferred light contribution
    rng: jnp.ndarray           # (N,) uint32 PCG32 state
    active: jnp.ndarray        # (N,) bool
    ray: Rays                  # current extension rays
    shadow_ray: Rays           # current connect rays
    shadow_valid: jnp.ndarray  # (N,) bool — pending_nee wants visibility
    visibility: jnp.ndarray    # (N,) bool — Connect's result


class WavefrontPathTracer:
    """4-stage wavefront integrator over a scene with cast/any-hit."""

    def __init__(self, scene, lights: Lights | None, env: EnvironmentData,
                 materials: Materials, mat_id_of_prim=None,
                 attributes=None, atlas=None, bounds=None):
        self.scene = scene
        self.lights = lights
        self.env = env
        self.materials = materials
        self.mat_id_of_prim = mat_id_of_prim
        self.attributes = attributes
        self.atlas = atlas
        # scene AABB for the bounce-wave coherence sort; defaults to the
        # scene BVH root when available
        if bounds is None:
            bvh = getattr(scene, "bvh", None)
            if bvh is not None:
                bounds = (bvh.aabb_min[0], bvh.aabb_max[0])
        self.bounds = bounds

    def _mat_ids(self, hits):
        pid = jnp.maximum(hits.prim_id, 0)
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return jnp.zeros_like(pid)

    # ---- Generate (pt_generate.comp.glsl:109-151) ---------------------
    def generate(self, rays: Rays, sample_index: int) -> WavefrontState:
        n = rays.count
        pixel = jnp.arange(n, dtype=jnp.uint32)
        rng = pcg32_seed(
            pixel * jnp.uint32(1009)
            + jnp.uint32(sample_index) * jnp.uint32(6529)
            + jnp.uint32(7)
        )
        z3 = jnp.zeros((n, 3), jnp.float32)
        f = jnp.zeros((n,), bool)
        return WavefrontState(
            throughput=jnp.ones((n, 3), jnp.float32),
            accum=z3,
            pending_nee=z3,
            rng=rng,
            active=jnp.ones((n,), bool),
            ray=rays,
            shadow_ray=rays,
            shadow_valid=f,
            visibility=f,
        )

    # ---- Extend (cwbvh RAY_MODE=0 dispatch) ---------------------------
    def extend(self, state: WavefrontState, sort: bool = False):
        cast = Rays(
            origin=state.ray.origin,
            direction=state.ray.direction,
            t_min=state.ray.t_min,
            t_max=jnp.where(state.active, state.ray.t_max, -1.0),
        )
        if sort and self.bounds is not None:
            # Bounce waves are incoherent (hemisphere-sampled
            # directions); the octant-major 6D sort re-packs them into
            # direction-consensus tiles before the cast — the
            # dispatcher's incoherent path (ray_dispatcher.h:130-150)
            # applied inside the PT frame jit.
            from ..dispatch.morton import sort_rays_6d, unshuffle_hits

            sorted_rays, perm = sort_rays_6d(cast, *self.bounds)
            hits, _ = self.scene.cast_rays(sorted_rays)
            return unshuffle_hits(hits, perm)
        hits, _ = self.scene.cast_rays(cast)
        return hits

    # ---- Connect (cwbvh RAY_MODE=1 dispatch) --------------------------
    def connect(self, state: WavefrontState,
                sort: bool = False) -> WavefrontState:
        if sort and self.bounds is not None:
            from ..dispatch.morton import sort_rays_6d, unshuffle_flags

            sorted_rays, perm = sort_rays_6d(state.shadow_ray,
                                             *self.bounds)
            occluded = unshuffle_flags(
                self.scene.any_hit_rays(sorted_rays),
                perm
            )
        else:
            occluded = self.scene.any_hit_rays(state.shadow_ray)
        return state.replace(visibility=~occluded & state.shadow_valid)

    # ---- Shade (pt_shade.comp.glsl:588-775) ---------------------------
    def shade(self, state: WavefrontState, hits, bounce: int,
              max_bounces: int) -> WavefrontState:
        n = state.rng.shape[0]
        # 1) resolve the PREVIOUS bounce's deferred NEE with Connect's
        #    visibility (pt_shade.comp.glsl:598-635)
        accum = state.accum + jnp.where(
            state.visibility[:, None], state.pending_nee, 0.0
        )

        hit = hits.hit & state.active
        sky = sky_color(state.ray.direction, self.env)
        accum = accum + jnp.where(
            (state.active & ~hits.hit)[:, None], state.throughput * sky, 0.0
        )

        surf = extract_surface(
            hits, state.ray.direction, self.materials, self._mat_ids(hits),
            attrs=self.attributes, atlas=self.atlas,
        )
        accum = accum + jnp.where(
            hit[:, None], state.throughput * surf.emission, 0.0
        )

        # 2) stochastic single-light NEE -> store as pending, build shadow
        #    ray (pt_shade.comp.glsl:697-717)
        rng = state.rng
        pending = jnp.zeros((n, 3), jnp.float32)
        shadow_valid = jnp.zeros((n,), bool)
        shadow_ray = state.shadow_ray
        if self.lights is not None and self.lights.count > 0:
            rng, u_pick = pcg32_float(rng)
            li_pick = jnp.minimum(
                (u_pick * self.lights.count).astype(jnp.int32),
                self.lights.count - 1,
            )
            # ONE gathered evaluation of the picked light per pixel
            # (pt_shade.comp.glsl:697-717) — O(1), not evaluate-all+select
            ldir, atten, lvalid, dist, lcolor, is_dir = light_sample_picked(
                surf.position, self.lights, li_pick
            )
            contrib, n_dot_l = cook_torrance_single(
                surf, ldir, lcolor * atten[:, None]
            )
            lvalid = lvalid & (n_dot_l > 0.0)
            contrib = jnp.where(lvalid[:, None], contrib, 0.0)
            # x light_count to unbias the uniform pick
            pending = state.throughput * contrib * float(self.lights.count)
            shadow_valid = hit & lvalid
            tmax = jnp.where(is_dir, 1e30, dist - 2.0 * SHADOW_EPS)
            shadow_ray = Rays(
                origin=hits.position + surf.normal * SHADOW_EPS,
                direction=ldir,
                t_min=jnp.full((n,), SHADOW_EPS, jnp.float32),
                t_max=jnp.where(shadow_valid, tmax, -1.0),
            )
            pending = jnp.where(shadow_valid[:, None], pending, 0.0)

        # 3) sample the bounce (pt_shade.comp.glsl:503-543)
        rng, bdir, bweight, bvalid = sample_bounce(surf, rng)
        active = hit & bvalid
        throughput = jnp.where(
            active[:, None], state.throughput * bweight, state.throughput
        )

        # 4) Russian roulette from bounce 2 (pt_shade.comp.glsl:753-764)
        if bounce >= 1:
            survival = jnp.minimum(jnp.max(throughput, axis=-1), 0.95)
            rng, u = pcg32_float(rng)
            survive = u < survival
            throughput = jnp.where(
                (active & survive)[:, None],
                throughput / jnp.maximum(survival, 1e-6)[:, None],
                throughput,
            )
            active = active & survive

        next_ray = Rays(
            origin=hits.position + surf.normal * SHADOW_EPS,
            direction=bdir,
            t_min=jnp.full((n,), 1e-3, jnp.float32),
            t_max=jnp.full((n,), 3.0e38, jnp.float32),
        )
        return WavefrontState(
            throughput=throughput,
            accum=accum,
            pending_nee=pending,
            rng=rng,
            active=active,
            ray=next_ray,
            shadow_ray=shadow_ray,
            shadow_valid=shadow_valid,
            visibility=jnp.zeros((n,), bool),
        )

    # ---- frame orchestration (gpu_path_tracer.cpp:241-283) ------------
    def trace_frame(self, rays: Rays, max_bounces: int = 3,
                    sample_index: int = 0, with_counts: bool = False):
        """One path-traced frame.

        ``with_counts=True`` additionally returns the COUNTED number of
        live wave rays actually traced (active extend rays + valid
        shadow rays per bounce) — the honest denominator for PT Mrays/s
        (replaces the old x4 wave estimate).

        Production path: the WHOLE frame (generate + all extend/shade/
        connect waves + finalize) compiles to ONE jitted dispatch when
        the scene casts through the traversal kernel (a kernel-backend
        RayScene or an instanced TLAS view) — the reference needs 4
        kernel dispatches per bounce with compute barriers
        (gpu_path_tracer.cpp:251-283); here the phases are XLA dataflow
        inside one computation.  Other backends dispatch each stage.
        """
        sc = self.scene
        if getattr(sc, "tables", None) is not None:
            # instanced TLAS scene: full path-traced frame with memory ~
            # meshes, never flattening (cpu_path_tracer.h:56-223 traces
            # through the TLAS dispatcher, scene_tlas.h:203-251)
            return _wavefront_frame_instanced(
                sc.tables, self.bounds, self.lights, self.env,
                self.materials, self.mat_id_of_prim, self.attributes,
                self.atlas, rays, jnp.uint32(sample_index),
                max_bounces=max_bounces, with_counts=with_counts,
            )
        if (getattr(sc, "backend", None) == "kernel"
                and getattr(sc, "use_bvh", False)):
            return _wavefront_frame_flat(
                sc.tris, sc.bvh, self.bounds, self.lights, self.env,
                self.materials, self.mat_id_of_prim, self.attributes,
                self.atlas, rays, jnp.uint32(sample_index),
                max_bounces=max_bounces, with_counts=with_counts,
            )
        return self._trace_frame_stages(rays, max_bounces, sample_index,
                                        with_counts=with_counts)

    def _trace_frame_stages(self, rays: Rays, max_bounces: int = 3,
                            sample_index: int = 0,
                            with_counts: bool = False,
                            carried: bool | None = None):
        if carried is None:
            carried = self.bounds is not None
        if carried:
            return self._trace_frame_carried(rays, max_bounces,
                                             sample_index, with_counts)
        state = self.generate(rays, sample_index)
        wave_rays = jnp.int32(0)
        for bounce in range(max_bounces + 1):
            # bounce-0 primaries are camera-coherent already; later
            # waves get the octant-major coherence sort
            hits = self.extend(state, sort=bounce > 0)
            wave_rays = wave_rays + jnp.sum(state.active.astype(jnp.int32))
            state = self.shade(state, hits, bounce, max_bounces)
            wave_rays = wave_rays + jnp.sum(
                state.shadow_valid.astype(jnp.int32))
            state = self.connect(state, sort=bounce > 0)
        # finalize-Shade: resolve the last bounce's deferred NEE
        accum = state.accum + jnp.where(
            state.visibility[:, None], state.pending_nee, 0.0
        )
        if with_counts:
            return accum, wave_rays
        return accum

    def _trace_frame_carried(self, rays: Rays, max_bounces: int,
                             sample_index: int, with_counts: bool):
        """Carried-sort frame: ONE coherence sort per bounce, at the
        LIVE-PREFIX size.

        Sorting (and unshuffling) every extend AND every connect wave
        independently costs 2 argsorts + ~28 gathered fields per
        bounce.  Here the whole path state is re-sorted
        once per bounce by the NEXT extend ray's octant-major key and
        the waves stay in that order: the connect wave reuses the
        extend order (shadow origins == bounce origins, so the tiles
        stay origin-compact; for directional lights the shadow
        directions are globally parallel anyway), hits are consumed
        sorted instead of unshuffled, and pixel ids ride along for one
        final scatter.

        Every sort after the first runs on a STATIC PREFIX bucket
        chosen by the previous bounce's live count (one lax.switch over
        XLA-only branches — argsort + gathers at the bucket size,
        untouched dead tail concatenated back).  The previous live-first
        sort compacted all live rays into that prefix, so the result is
        identical and the sort shrinks with the wave.  Kernel casts stay
        ONE full-shape instance; dead rays leave the kernel at its
        root-box gate.

        Every stage computes identical values in permuted order, so
        the result equals the per-wave-sorted path up to exact-t tie
        order and fp addition order."""
        from ..dispatch.morton import (
            apply_permutation,
            sort_perm_6d,
            unshuffle_flags,
        )

        state = self.generate(rays, sample_index)
        n = rays.count
        buckets = _prefix_buckets(n)
        pix = jnp.arange(n, dtype=jnp.int32)
        wave_rays = jnp.int32(0)
        # live rays are compacted into prefix[bound] by the previous
        # bounce's sort; bound starts at n (pixel order, unsorted)
        bound_cnt = jnp.int32(n)
        for bounce in range(max_bounces + 1):
            # bounce-0 primaries are camera-coherent (block-swizzled);
            # later waves arrive pre-sorted from the bounce re-sort
            cast = Rays(
                origin=state.ray.origin,
                direction=state.ray.direction,
                t_min=state.ray.t_min,
                t_max=jnp.where(state.active, state.ray.t_max, -1.0),
            )
            hits, _ = self.scene.cast_rays(cast)
            wave_rays = wave_rays + jnp.sum(state.active.astype(jnp.int32))
            state = self.shade(state, hits, bounce, max_bounces)
            wave_rays = wave_rays + jnp.sum(
                state.shadow_valid.astype(jnp.int32))
            # connect: bounce-0 shadow rays are camera-coherent (pixel
            # order); later waves get a valid-first 6D sort at the
            # live-prefix bucket — shadow origins sit at hit points,
            # one bounce fresher than the carried extend order
            if bounce > 0:
                # the cast itself is HOISTED OUT of the switch so the
                # kernel stays one full-shape instance; branches only
                # build the prefix-sorted rays + full permutation
                def sperm_branch(B):
                    sub = _slice_rays(state.shadow_ray, B)
                    sperm = sort_perm_6d(sub, *self.bounds,
                                         live=state.shadow_valid[:B])
                    rs = _concat_rays(
                        apply_permutation(sub, sperm),
                        _slice_rays(state.shadow_ray, B, tail=True))
                    return rs, jnp.concatenate(
                        [sperm, jnp.arange(B, n, dtype=jnp.int32)])

                rs, fullperm = _switch_prefix(buckets, bound_cnt,
                                              sperm_branch)
                occ_s = self.scene.any_hit_rays(rs)

                def unsh_branch(B):
                    return jnp.concatenate(
                        [unshuffle_flags(occ_s[:B], fullperm[:B]),
                         occ_s[B:]])

                occluded = _switch_prefix(buckets, bound_cnt,
                                          unsh_branch)
            else:
                occluded = self.scene.any_hit_rays(state.shadow_ray)
            state = state.replace(
                visibility=~occluded & state.shadow_valid)
            if bounce < max_bounces:
                new_cnt = jnp.sum(state.active.astype(jnp.int32))

                def resort(B):
                    sub = _slice_rays(state.ray, B)
                    perm = sort_perm_6d(sub, *self.bounds,
                                        live=state.active[:B])
                    # packed gathers: the ~10 per-field gathers become
                    # one f32 + one i32 gather
                    fl = jnp.concatenate(
                        [state.throughput, state.accum,
                         state.pending_nee, state.ray.origin,
                         state.ray.direction], axis=1)       # (n,15)
                    il = jnp.stack(
                        [pix,
                         jax.lax.bitcast_convert_type(state.rng,
                                                      jnp.int32),
                         state.active.astype(jnp.int32),
                         state.shadow_valid.astype(jnp.int32),
                         state.visibility.astype(jnp.int32)],
                        axis=1)                              # (n,5)
                    flp = jnp.concatenate([fl[:B][perm], fl[B:]], axis=0)
                    ilp = jnp.concatenate([il[:B][perm], il[B:]], axis=0)
                    return (
                        ilp[:, 0],
                        WavefrontState(
                            throughput=flp[:, 0:3],
                            accum=flp[:, 3:6],
                            pending_nee=flp[:, 6:9],
                            rng=jax.lax.bitcast_convert_type(
                                ilp[:, 1], jnp.uint32),
                            active=ilp[:, 2].astype(bool),
                            ray=Rays(origin=flp[:, 9:12],
                                     direction=flp[:, 12:15],
                                     t_min=state.ray.t_min,
                                     t_max=state.ray.t_max),
                            shadow_ray=state.shadow_ray,  # consumed
                            shadow_valid=ilp[:, 3].astype(bool),
                            visibility=ilp[:, 4].astype(bool),
                        ),
                    )

                pix, state = _switch_prefix(buckets, bound_cnt, resort)
                bound_cnt = new_cnt
        accum = state.accum + jnp.where(
            state.visibility[:, None], state.pending_nee, 0.0
        )
        # one final scatter back to pixel order
        accum = jnp.zeros_like(accum).at[pix].set(accum)
        if with_counts:
            return accum, wave_rays
        return accum

    def trace_frame_srgb(self, rays: Rays, max_bounces: int = 3,
                         sample_index: int = 0) -> jnp.ndarray:
        linear = self.trace_frame(rays, max_bounces, sample_index)
        return to_srgb(tonemap(linear, self.env.tonemap_mode))


def _frame(tables, bounds, lights, env, materials, mat_id_of_prim,
           attributes, atlas, rays, sample_index, max_bounces,
           with_counts):
    pt = WavefrontPathTracer(KernelScene(tables), lights, env,
                             materials, mat_id_of_prim=mat_id_of_prim,
                             attributes=attributes, atlas=atlas,
                             bounds=bounds)
    return pt._trace_frame_stages(rays, max_bounces, sample_index,
                                  with_counts=with_counts)


@functools.partial(
    jax.jit, static_argnames=("max_bounces", "with_counts"))
def _wavefront_frame_flat(tris, bvh, bounds, lights, env, materials,
                          mat_id_of_prim, attributes, atlas, rays,
                          sample_index, *, max_bounces, with_counts=False):
    """The whole flat-scene wavefront frame as ONE compiled computation."""
    return _frame((tris, bvh), bounds, lights, env, materials,
                  mat_id_of_prim, attributes, atlas, rays, sample_index,
                  max_bounces, with_counts)


@functools.partial(
    jax.jit, static_argnames=("max_bounces", "with_counts"))
def _wavefront_frame_instanced(tables, bounds, lights, env, materials,
                               mat_id_of_prim, attributes, atlas, rays,
                               sample_index, *, max_bounces,
                               with_counts=False):
    """The whole instanced-TLAS wavefront frame as ONE computation —
    every extend/connect wave walks the true two-level structure
    (memory ~ meshes)."""
    return _frame(tables, bounds, lights, env, materials, mat_id_of_prim,
                  attributes, atlas, rays, sample_index, max_bounces,
                  with_counts)
