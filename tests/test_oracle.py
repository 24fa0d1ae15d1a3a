"""Production vs the INDEPENDENT oracle (oracle/ package, zero production
imports) and its checked-in golden images (tests/goldens/*.npz).

This suite breaks the self-referential loop of comparing production
code with itself: every comparison here is against a scalar NumPy
transcription of
/root/reference/executable/shader.frag, so a math bug in the shared
production code (renderer + forward kernel import the same geometry/RNG/
sampler) now fails CI instead of cancelling out.

Tolerance rationale: the oracle and XLA differ at ulp level in
transcendentals (arccos/sin/cos) and in normalize (divide vs reciprocal
multiply). Geometry-only comparisons (0 bounces) are tight — only
silhouette pixels may flip. Multi-bounce path tracing amplifies ulp
differences chaotically (a 1-ulp sampler difference flips discrete
hit/mirror/sun decisions downstream), so multi-bounce image comparisons
are statistical: the agreeing-pixel fraction and mean error are bounded.
A real shared-math bug (wrong sign, wrong clip radius, wrong stream)
shifts entire objects/images and fails both bounds; the per-primitive
and per-subcomponent tests below catch it at source with tight
tolerances.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from oracle import frag as ofrag
from oracle import scenes as oscenes
from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig, render_light
from fourd_ray_tracing_tpu.models.scene import intersect_scene
from fourd_ray_tracing_tpu.ops import rng as prng
from fourd_ray_tracing_tpu.ops.sampler import w_by_volume_newton
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

from pathlib import Path

F = np.float32
GOLDEN_DIR = Path(__file__).parent / "goldens"
SEED = 12345
SCENE_NAMES = sorted(oscenes.SCENES)

# Must mirror tools/gen_goldens.py.
A_W, A_H = 32, 20
B_W, B_H, B_SPP, B_BOUNCES = 24, 16, 2, 3


def production_camera(view="yxz"):
    return cam.camera_from_state(
        focus=Vec4.of(0.0, -2.0, 0.0, 0.0),
        angles=cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        focus_to_matrix_distance=1.5,
        matrix_height=2.0,
        view=view,
    )


def golden(scene_name, key):
    return np.load(GOLDEN_DIR / f"{scene_name}.npz")[key]


def tonemap(light, c=0.12):
    return 1.0 - 1.0 / (c * np.asarray(light, np.float64) + 1.0)


def image_stats(a, b):
    """(fraction of pixels with max-channel diff > 1e-3, mean abs diff)
    over tone-mapped images."""
    ta, tb = tonemap(a), tonemap(b)
    per_pixel = np.abs(ta - tb).reshape(-1, 3).max(axis=-1)
    return float((per_pixel > 1e-3).mean()), float(np.abs(ta - tb).mean())


# --- RNG: bit-exact against the oracle --------------------------------------

def test_rng_bitexact_vs_oracle():
    """ops/rng.py must reproduce the oracle's (= shader.frag:88-121)
    integer stream EXACTLY — integers leave no tolerance to hide in."""
    scr = [(F(0.3), F(0.7)), (F(0.015625), F(0.975)), (F(0.5), F(0.5))]
    seed = 0xDEADBEEF
    for sx, sy in scr:
        orng = ofrag.Rng(seed, sx, sy)
        bits = prng.pixel_stream_bits(jnp.float32(sx), jnp.float32(sy))
        counter = prng.init_counter(np.uint32(seed))
        for _ in range(16):
            u_o = orng.rand()
            u_p, counter = prng.uniform01(bits, np.uint32(seed), counter)
            assert ofrag.float_bits(u_o) == ofrag.float_bits(F(np.asarray(u_p))), (
                sx, sy)


def test_per_sample_stream_key_matches_oracle():
    """The production sample_stream_bits and the oracle's independent
    re-derivation must agree exactly for every sample index."""
    from fourd_ray_tracing_tpu.models.renderer import sample_stream_bits

    pixel_bits = 0x12345678
    for s in (0, 1, 2, 7, 255):
        got = int(np.asarray(sample_stream_bits(jnp.uint32(pixel_bits), s)))
        want = ofrag._per_sample_bits(pixel_bits, s)
        assert got == want


# --- S^3 sampler -------------------------------------------------------------

def test_newton_sampler_vs_oracle():
    """Production w_by_volume_newton vs the oracle's literal do-while.

    Both converge to |step| < SMALL_FLOAT ~ 3e-4 of the same fixed point;
    transcendental ulp differences may flip one trip count, so the bound
    is 2*SMALL_FLOAT."""
    v = np.linspace(0.001, 0.999, 199, dtype=np.float32)
    got = np.asarray(w_by_volume_newton(jnp.asarray(v)))
    want = np.array([ofrag.w_by_volume(F(x)) for x in v], np.float32)
    assert np.abs(got - want).max() < 2 * 3e-4


def test_newton_sampler_vs_float64_inverse():
    """Both solvers sit within their own tolerance of the true float64
    inverse CDF (bisection oracle)."""

    def cdf64(w):
        return (w * np.sqrt(1 - w * w) - np.arccos(w)) / np.pi + 1

    def inv64(v):
        lo, hi = -1.0, 1.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if cdf64(mid) < v:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    v = np.linspace(0.01, 0.99, 51, dtype=np.float32)
    got = np.asarray(w_by_volume_newton(jnp.asarray(v)))
    want = np.array([inv64(float(x)) for x in v])
    assert np.abs(got - want).max() < 6e-4


# --- Per-scene intersection parity (eager; no jit compiles) ------------------

def _random_rays(n, rng_np):
    """Deterministic ray batch covering the scene region: origins around
    the camera area and inside the scene, directions uniform on S^3."""
    o = rng_np.uniform(-3.0, 3.0, size=(n, 4)).astype(np.float32)
    o[: n // 2] = np.array([0, -2, 0, 0], np.float32) + 0.2 * o[: n // 2]
    d = rng_np.normal(size=(n, 4)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _oracle_signature(oracle_scene, o, d):
    """(hit, dist, norm, glow) of the oracle at one ray."""
    inter = oracle_scene.find_intersection(o, d)
    return (
        bool(inter.did_intersect), float(inter.dist),
        np.asarray(inter.norm, np.float32), float(inter.material.glow),
    )


def _near_decision_boundary(oracle_scene, o, d, eps=3e-4):
    """Per-flip boundary certificate: the ray lies within
    an eps-band of SOME decision boundary of the intersection function
    iff an eps-perturbation of the ray flips the ORACLE'S OWN answer —
    hit/miss, winning material, a distance jump, or a normal flip. This
    certifies every tolerated disagreement directly against the decision
    structure (tangency |disc|~0, plane cos_dh~SMALL_FLOAT, annulus clip
    margins, winner ties, ...) without enumerating per-primitive band
    formulas. eps is ulp-scale for these unit-scale scenes: float32
    arithmetic on coordinates up to ~30 carries ~1e-5 relative error,
    magnified ~10-30x through the quadratic/trig chains.
    """
    hit0, dist0, norm0, glow0 = _oracle_signature(oracle_scene, o, d)
    perts = [o + s * eps * d for s in (1.0, -1.0)]
    for ax in range(4):
        e = np.zeros(4, np.float32)
        e[ax] = eps
        perts += [o + e, o - e]
        dn = d + e
        dn /= np.linalg.norm(dn)
        perts.append((o, dn.astype(np.float32)))
        dn2 = d - e
        dn2 /= np.linalg.norm(dn2)
        perts.append((o, dn2.astype(np.float32)))
    for p in perts:
        po, pd = p if isinstance(p, tuple) else (p, d)
        hit, dist, norm, glow = _oracle_signature(oracle_scene, po, pd)
        if hit != hit0 or glow != glow0:
            return True
        if hit0 and (
            abs(dist - dist0) > 50 * eps * max(1.0, abs(dist0))
            or np.abs(norm - norm0).max() > 0.5
        ):
            return True
    return False


@pytest.mark.parametrize("scene_name", SCENE_NAMES)
@pytest.mark.parametrize("mode", ["trig", "spec", "fast"])
def test_intersect_vs_oracle(scene_name, mode, rng_np):
    """intersect_scene in every mode vs the oracle's find_intersection,
    ray by ray. trig is the literal transcription (tight); spec/fast use
    the algebraically equivalent quadratic (equal up to ulp at edges).

    EVERY disagreement (hit/miss flip, >1e-4 relative distance error,
    normal or material mismatch) must carry a per-ray boundary
    certificate: the oracle's own answer flips under an ulp-scale
    perturbation (`_near_decision_boundary`), proving the ray sits on a
    decision edge where float reassociation may legitimately differ —
    no blanket statistical allowance."""
    o_np, d_np = _random_rays(256, rng_np)
    oracle_scene = oscenes.SCENES[scene_name]()
    want_hit, want_dist, want_norm, want_glow = [], [], [], []
    for k in range(o_np.shape[0]):
        inter = oracle_scene.find_intersection(o_np[k], d_np[k])
        want_hit.append(inter.did_intersect)
        want_dist.append(inter.dist)
        want_norm.append(inter.norm)
        want_glow.append(inter.material.glow)
    want_hit = np.array(want_hit)
    want_dist = np.array(want_dist, np.float32)
    want_norm = np.array(want_norm, np.float32)
    want_glow = np.array(want_glow, np.float32)

    scene = library.SCENES[scene_name]()
    with jax.disable_jit():
        got = intersect_scene(
            scene, Vec4.unstack(jnp.asarray(o_np)), Vec4.unstack(jnp.asarray(d_np)),
            mode,
        )
    got_hit = np.asarray(got.hit)
    got_dist = np.asarray(got.dist)
    got_norm = np.asarray(got.norm.stack())
    got_glow = np.asarray(got.glow)

    both = np.logical_and(got_hit, want_hit)
    rel = np.where(
        both,
        np.abs(got_dist - want_dist) / np.maximum(np.abs(want_dist), 1.0),
        0.0,
    )
    disagree = (
        (got_hit != want_hit)
        | (both & (rel > 1e-4))
        | (both & (np.abs(got_norm - want_norm).max(axis=-1) > 1e-2))
        | (both & (got_glow != want_glow))
    )
    # Sanity cap: boundary rays are rare in a 256-ray uniform batch; a
    # systematic error would blow past this before certification runs.
    assert disagree.mean() <= 0.05, f"{disagree.sum()} disagreements of 256"
    for k in np.nonzero(disagree)[0]:
        assert _near_decision_boundary(oracle_scene, o_np[k], d_np[k]), (
            f"ray {k} disagrees with the oracle but is NOT within an "
            f"ulp band of any decision boundary: got hit={got_hit[k]} "
            f"dist={got_dist[k]:.6g} glow={got_glow[k]} vs want "
            f"hit={want_hit[k]} dist={want_dist[k]:.6g} glow={want_glow[k]}"
        )
    # The typical (non-boundary) agreement stays tight.
    assert np.quantile(rel[both], 0.98) < 1e-4


# --- Golden images: geometry (0 bounces — deterministic, tight) -------------

@pytest.mark.parametrize("scene_name", SCENE_NAMES)
def test_golden_geometry(scene_name):
    cfg = RenderConfig(
        width=A_W, height=A_H, samples=1, reflections_amount=0,
        sampler_method="newton", rng_mode="sequential", intersect="spec",
    )
    got = np.asarray(
        render_light(library.SCENES[scene_name](), production_camera(), cfg,
                     np.uint32(SEED))
    )
    want = golden(scene_name, "a_light")
    per_pixel = np.abs(tonemap(got) - tonemap(want)).reshape(-1, 3).max(axis=-1)
    frac = (per_pixel > 1e-4).mean()
    assert frac <= 0.02, f"{frac:.2%} of pixels differ (max {per_pixel.max():.3g})"


def test_golden_geometry_additional_view():
    """The ywz section (top, w_drct basis — three_window_group.cpp:43)."""
    cfg = RenderConfig(
        width=A_W, height=A_H, samples=1, reflections_amount=0,
        sampler_method="newton", rng_mode="sequential", intersect="spec",
    )
    got = np.asarray(
        render_light(library.sphere_plane_light(), production_camera("ywz"), cfg,
                     np.uint32(SEED))
    )
    want = golden("sphere_plane_light", "a_light_ywz")
    per_pixel = np.abs(tonemap(got) - tonemap(want)).reshape(-1, 3).max(axis=-1)
    assert (per_pixel > 1e-4).mean() <= 0.02


# --- Golden images: full path tracing (statistical bounds) -------------------

def _b_cfg(rng_mode):
    return RenderConfig(
        width=B_W, height=B_H, samples=B_SPP, reflections_amount=B_BOUNCES,
        sampler_method="newton", rng_mode=rng_mode, intersect="spec",
    )


@pytest.mark.parametrize("scene_name", SCENE_NAMES)
def test_golden_pathtrace_jnp(scene_name):
    got = np.asarray(
        render_light(library.SCENES[scene_name](), production_camera(),
                     _b_cfg("per_sample"), np.uint32(SEED))
    )
    frac, mean = image_stats(got, golden(scene_name, "b_per"))
    assert frac <= 0.10 and mean <= 0.01, f"frac={frac:.2%} mean={mean:.4f}"


def test_golden_pathtrace_sequential_stream():
    """Sequential RNG carries across the sample loop INCLUDING the
    reference's final-iteration draws (shader.frag:488-491 run on
    i == reflections_amount); with 2 samples this fails if the stream is
    cut short."""
    got = np.asarray(
        render_light(library.sphere_plane_light(), production_camera(),
                     _b_cfg("sequential"), np.uint32(SEED))
    )
    frac, mean = image_stats(got, golden("sphere_plane_light", "b_seq"))
    assert frac <= 0.10 and mean <= 0.01, f"frac={frac:.2%} mean={mean:.4f}"


@pytest.mark.parametrize("scene_name", SCENE_NAMES)
@pytest.mark.slow
def test_golden_pathtrace_pallas(scene_name):
    """The forward kernel (Pallas interpreter) against the ORACLE golden
    — non-circular: even though the kernel shares math with the jnp
    renderer, the reference here is the independent scalar
    transcription."""
    from fourd_ray_tracing_tpu.ops.pallas.megakernel import render_light_pallas

    got = np.asarray(
        render_light_pallas(library.SCENES[scene_name](), production_camera(),
                            _b_cfg("per_sample"), np.uint32(SEED),
                            interpret=True)
    )
    frac, mean = image_stats(got, golden(scene_name, "b_per"))
    assert frac <= 0.10 and mean <= 0.01, f"frac={frac:.2%} mean={mean:.4f}"


# --- Goldens freshness guard --------------------------------------------------

def test_goldens_are_fresh():
    """Regenerate one golden from the oracle in-test: catches a stale or
    hand-edited goldens directory (oracle is deterministic)."""
    from tools.gen_goldens import oracle_camera

    scene = oscenes.sphere_plane_light()
    a = ofrag.render_light(scene, oracle_camera(), A_W, A_H, SEED, 1, 0)
    np.testing.assert_array_equal(a, golden("sphere_plane_light", "a_light"))
    b = ofrag.render_light(
        scene, oracle_camera(), B_W, B_H, SEED, B_SPP, B_BOUNCES,
        rng_mode="per_sample",
    )
    np.testing.assert_array_equal(b, golden("sphere_plane_light", "b_per"))
