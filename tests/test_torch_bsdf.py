"""The port's Disney BSDF, texture sampling and quad-light sampling against
chameleonrt_tpu on the same random inputs, plus the white-furnace check of
tests/test_ops_bsdf.py on the port.

Tolerance rtol 1e-5 / atol 1e-6: float32 with the operations in another
order (XLA on the CPU also fuses multiply-adds; the port does not). A
sampled direction lands on the peak of its lobe, where the GGX and GTR1
terms (1 + (a^2 - 1) cos^2) cancel, so the bsdf value and pdf there are
ill-conditioned: those hold at 1e-5 on all but 0.5% of the lanes
(measured: 8 of 4096), at rtol 2e-2 on all (measured 9.6e-3), and the
estimator weight f |cos| / pdf that the renderer uses at rtol 1e-3
(measured 7e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.ops import bsdf as jb
from chameleonrt_tpu.ops import lights as jl
from chameleonrt_tpu.ops import rng as jrng
from chameleonrt_tpu.ops import texture as jt
from chameleonrt_tpu_torch.ops import bsdf as tb
from chameleonrt_tpu_torch.ops import lights as tl
from chameleonrt_tpu_torch.ops import rng as trng
from chameleonrt_tpu_torch.ops import texture as tt

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def lanes():
    """Random materials (a quarter transmissive, a third anisotropic), a
    shading frame and directions on both sides of the surface."""
    rng = np.random.default_rng(11)
    f = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    mat = dict(
        base_color=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        metallic=f(), specular=f(), roughness=f(0.02, 1.0),
        specular_tint=f(), anisotropy=np.where(rng.random(N) < 0.33, f(), 0).astype(np.float32),
        sheen=f(), sheen_tint=f(), clearcoat=f(), clearcoat_gloss=f(), ior=f(1.0, 2.0),
        specular_transmission=np.where(rng.random(N) < 0.25, f(), 0).astype(np.float32),
    )
    n = _unit(rng, N)
    helper = np.where(np.abs(n[:, :1]) < 0.6, [[1, 0, 0]], [[0, 1, 0]]).astype(np.float32)
    v_x = np.cross(helper, n)
    v_x /= np.linalg.norm(v_x, axis=1, keepdims=True)
    v_y = np.cross(n, v_x).astype(np.float32)
    w_o = _unit(rng, N)
    w_o = np.where((w_o * n).sum(1, keepdims=True) < 0, -w_o, w_o)
    w_i = _unit(rng, N)
    seeds = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    return mat, n, v_x.astype(np.float32), v_y, w_o, w_i, seeds


def _both(mat, *arrays):
    jm = jb.MaterialBatch(**{k: jnp.asarray(v) for k, v in mat.items()})
    tm = tb.MaterialBatch(**{k: torch.from_numpy(v) for k, v in mat.items()})
    return (jm, *map(jnp.asarray, arrays)), (tm, *(torch.from_numpy(a) for a in arrays))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_disney_brdf_and_pdf_match_jax(lanes):
    mat, n, v_x, v_y, w_o, w_i, _ = lanes
    (jm, jn, jo, ji, jx, jy), (tm, tn, to, ti, tx, ty) = _both(mat, n, w_o, w_i, v_x, v_y)
    _close(tb.disney_brdf(tm, tn, to, ti, tx, ty), jb.disney_brdf(jm, jn, jo, ji, jx, jy))
    _close(tb.disney_pdf(tm, tn, to, ti, tx, ty), jb.disney_pdf(jm, jn, jo, ji, jx, jy))


def test_sample_disney_brdf_matches_jax(lanes):
    mat, n, v_x, v_y, w_o, _, seeds = lanes
    (jm, jn, jo, jx, jy), (tm, tn, to, tx, ty) = _both(mat, n, w_o, v_x, v_y)
    js = jrng.get_rng(jnp.asarray(seeds), jnp.uint32(9))
    ts = trng.get_rng(torch.from_numpy(seeds.astype(np.int64)), 9)
    js, jf, jw, jp = jb.sample_disney_brdf(jm, jn, jo, jx, jy, js)
    ts, tf, tw, tp = tb.sample_disney_brdf(tm, tn, to, tx, ty, ts)
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    # the component choice is an integer function of the draw: the same
    # lanes are valid on both sides
    np.testing.assert_array_equal(tp.numpy() == 0, np.asarray(jp) == 0)
    _close(tw, jw)
    jf, jp, jw = np.asarray(jf), np.asarray(jp), np.asarray(jw)
    tf, tp, tw = tf.numpy(), tp.numpy(), tw.numpy()
    for got, want in ((tf, jf), (tp, jp)):
        off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
        assert off.reshape(N, -1).any(axis=1).mean() <= 0.005
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=ATOL)
    ok = jp > 0
    weight = lambda f, w, p: f[ok] * (np.abs((w * n).sum(1)) / np.where(ok, p, 1))[ok, None]  # noqa: E731
    np.testing.assert_allclose(weight(tf, tw, tp), weight(jf, jw, jp), rtol=1e-3, atol=ATOL)


def test_texture_sampling_matches_jax():
    rng = np.random.default_rng(4)
    textures = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for h, w in ((8, 16), (5, 3))]
    rows = np.concatenate([jt.build_quad_rows(t) for t in textures])
    np.testing.assert_array_equal(rows, np.concatenate([tt.build_quad_rows(t) for t in textures]))
    table = np.array([[0, 16, 8, 1], [128, 3, 5, 2]], np.int32)
    ja = jt.TextureAtlas(atlas=jnp.asarray(rows), table=jnp.asarray(table))
    ta = tt.TextureAtlas(atlas=torch.from_numpy(rows), table=torch.from_numpy(table))
    uv = rng.uniform(-2.5, 2.5, (N, 2)).astype(np.float32)
    tex = rng.integers(0, 2, N).astype(np.int32)
    ch = rng.integers(0, 4, N).astype(np.int32)
    _close(tt.sample_rgb(ta, torch.from_numpy(tex), torch.from_numpy(uv)),
           jt.sample_rgb(ja, jnp.asarray(tex), jnp.asarray(uv)))
    _close(tt.sample_channel(ta, torch.from_numpy(tex), torch.from_numpy(ch), torch.from_numpy(uv)),
           jt.sample_channel(ja, jnp.asarray(tex), jnp.asarray(ch), jnp.asarray(uv)))
    # texture handles in material slots: top bit, channel in bits 29-30
    handles = (0x80000000 | (ch.astype(np.uint32) << 29) | tex.astype(np.uint32)).view(np.float32)
    plain = rng.uniform(0, 1, N).astype(np.float32)
    x = np.where(rng.random(N) < 0.5, handles, plain).astype(np.float32)
    _close(tt.textured_scalar_param(ta, torch.from_numpy(x), torch.from_numpy(uv)),
           jt.textured_scalar_param(ja, jnp.asarray(x), jnp.asarray(uv)))
    rgb = np.stack([x, plain, plain], axis=1)
    _close(tt.textured_color_param(ta, torch.from_numpy(rgb), torch.from_numpy(uv)),
           jt.textured_color_param(ja, jnp.asarray(rgb), jnp.asarray(uv)))


def test_light_sampling_matches_jax():
    rng = np.random.default_rng(8)
    L = dict(
        emission=rng.uniform(1, 10, (N, 3)), position=rng.uniform(-1, 1, (N, 3)) + [0, 3, 0],
        normal=np.tile([0.0, -1.0, 0.0], (N, 1)), v_x=np.tile([1.0, 0, 0], (N, 1)),
        v_y=np.tile([0, 0, 1.0], (N, 1)), width=rng.uniform(0.2, 1, N), height=rng.uniform(0.2, 1, N),
    )
    L = {k: np.asarray(v, np.float32) for k, v in L.items()}
    jlt = jl.LightArrays(**{k: jnp.asarray(v) for k, v in L.items()})
    tlt = tl.LightArrays(**{k: torch.from_numpy(v) for k, v in L.items()})
    s = rng.random((N, 2)).astype(np.float32)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = _unit(rng, N)
    d[: N // 2, 1] = np.abs(d[: N // 2, 1])
    jpos = jl.sample_quad_light_position(jlt, jnp.asarray(s))
    tpos = tl.sample_quad_light_position(tlt, torch.from_numpy(s))
    _close(tpos, jpos)
    _close(tl.quad_light_pdf(tlt, tpos, torch.from_numpy(p), torch.from_numpy(d)),
           jl.quad_light_pdf(jlt, jpos, jnp.asarray(p), jnp.asarray(d)))
    jh, jtl, jlp = jl.quad_intersect(jlt, jnp.asarray(p), jnp.asarray(d))
    th, ttl, tlp = tl.quad_intersect(tlt, torch.from_numpy(p), torch.from_numpy(d))
    assert (th.numpy() != np.asarray(jh)).sum() <= 2
    both = th.numpy() & np.asarray(jh)
    assert both.sum() > 0
    np.testing.assert_allclose(ttl.numpy()[both], np.asarray(jtl)[both], rtol=RTOL, atol=ATOL)


def _furnace(mat_kw, w_o, n_samples=200_000):
    """E[f * |cos| / pdf] over BSDF samples for one material (the port of
    tests/test_ops_bsdf.py's sample_many + white furnace)."""
    B = n_samples
    base = dict(base_color=[0.9] * 3, metallic=0.0, specular=0.0, roughness=1.0,
                specular_tint=0.0, anisotropy=0.0, sheen=0.0, sheen_tint=0.0, clearcoat=0.0,
                clearcoat_gloss=0.0, ior=1.5, specular_transmission=0.0)
    base.update(mat_kw)
    mat = tb.MaterialBatch(**{
        k: torch.tensor(v, dtype=torch.float32).expand((B, 3) if k == "base_color" else (B,))
        for k, v in base.items()
    })
    n = torch.tensor([0.0, 0.0, 1.0]).expand(B, 3)
    v_x = torch.tensor([1.0, 0.0, 0.0]).expand(B, 3)
    v_y = torch.tensor([0.0, 1.0, 0.0]).expand(B, 3)
    w = torch.tensor(w_o, dtype=torch.float32)
    w = (w / w.norm()).expand(B, 3)
    state = trng.get_rng(torch.arange(B, dtype=torch.int64), 3)
    _, f, w_i, pdf = tb.sample_disney_brdf(mat, n, w, v_x, v_y, state)
    ok = pdf > 1e-6
    contrib = torch.where(
        ok[:, None], f * (w_i[:, 2].abs() / torch.clamp(pdf, min=1e-6))[:, None], torch.zeros_like(f)
    )
    return contrib.mean(dim=0).numpy()


@pytest.mark.parametrize(
    "mat_kw, w_o, lo, hi",
    [
        (dict(base_color=[1.0] * 3, roughness=1.0), [0.3, -0.2, 0.93], 0.7, 1.15),
        (dict(base_color=[1.0] * 3, metallic=1.0, roughness=0.5), [0.0, 0.0, 1.0], 0.0, 1.3),
    ],
)
def test_white_furnace(mat_kw, w_o, lo, hi):
    """Energy conservation: diffuse keeps most energy without gaining any;
    rough metal loses some to the G term but never explodes."""
    mean = _furnace(mat_kw, w_o)
    assert np.all(mean < hi), mean
    assert np.all(mean > lo), mean
