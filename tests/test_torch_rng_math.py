"""The port's RNG, math, camera and tonemap against chameleonrt_tpu on the same
inputs. RNG draws must be bit-equal; float math agrees to atol 1e-6
(float32, the same operations in a possibly different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chameleonrt_tpu.ops import camera as jcam
from chameleonrt_tpu.ops import math as jmath
from chameleonrt_tpu.ops import rng as jrng
from chameleonrt_tpu.ops import tonemap as jtone
from chameleonrt_tpu_torch.ops import camera as tcam
from chameleonrt_tpu_torch.ops import math as tmath
from chameleonrt_tpu_torch.ops import rng as trng
from chameleonrt_tpu_torch.ops import tonemap as ttone

torch.set_num_threads(1)

N_SEEDS = 120_000


@pytest.fixture(scope="module")
def seeds():
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 2**32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    frm = rng.integers(0, 2**32, N_SEEDS, dtype=np.uint64).astype(np.uint32)
    pix[:4] = [0, 1, 2**31, 2**32 - 1]
    frm[:4] = [0, 2**32 - 1, 1, 7]
    return pix, frm


def _t64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_get_rng_bit_equal(seeds):
    pix, frm = seeds
    want = np.asarray(jrng.get_rng(jnp.asarray(pix), jnp.asarray(frm)))
    got = trng.get_rng(_t64(pix), _t64(frm)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("draws", [1, 5])
def test_lcg_draws_bit_equal(seeds, draws):
    """lcg_randomf and lcg_randomf2 along a stream, as float bits: the u32
    draw rounds to float32 before the 2**-32 scale, so 1.0 can occur."""
    pix, frm = seeds
    js = jrng.get_rng(jnp.asarray(pix), jnp.asarray(frm))
    ts = trng.get_rng(_t64(pix), _t64(frm))
    for _ in range(draws):
        js, jf = jrng.lcg_randomf(js)
        ts, tf = trng.lcg_randomf(ts)
        np.testing.assert_array_equal(tf.numpy().view(np.uint32), np.asarray(jf).view(np.uint32))
        js, jf2 = jrng.lcg_randomf2(js)
        ts, tf2 = trng.lcg_randomf2(ts)
        np.testing.assert_array_equal(tf2.numpy().view(np.uint32), np.asarray(jf2).view(np.uint32))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))


def test_lcg_randomf_can_return_one():
    """The largest draws round up to exactly 1.0, as in the reference."""
    state = torch.tensor([(2**32 - 1 - 1013904223) * pow(1664525, -1, 2**32) % 2**32])
    _, f = trng.lcg_randomf(state)
    assert float(f[0]) == 1.0


def test_camera_rays_match_jax():
    W, H = 48, 32
    pos, d, up = [0.3, 1.2, 4.0], [-0.1, -0.2, -1.0], [0.0, 1.0, 0.0]
    jv = jcam.compute_view_params(pos, d, up, 55.0, W, H)
    tv = tcam.compute_view_params(pos, d, up, 55.0, W, H)
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(a), b)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = xs.reshape(-1).astype(np.uint32), ys.reshape(-1).astype(np.uint32)
    js = jrng.get_rng(jnp.asarray(px + py * W), jnp.uint32(3))
    ts = trng.get_rng(_t64(px + py * W), 3)
    js, jo, jd = jcam.generate_primary_rays(jv, jnp.asarray(px), jnp.asarray(py), float(W), float(H), js)
    ts, to, td = tcam.generate_primary_rays(tv, _t64(px), _t64(py), float(W), float(H), ts)
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(tcam.miss_shader(td).numpy(), np.asarray(jcam.miss_shader(jd)))


def test_tonemap_and_math_match_jax():
    rng = np.random.default_rng(5)
    accum = (rng.gamma(0.6, 0.4, (24, 20, 3)) * (rng.random((24, 20, 3)) > 0.05)).astype(np.float32)
    accum[0, 0] = [0.0, 0.0031308, 1e-12]
    want = np.asarray(jtone.linear_to_srgb_u8(jnp.asarray(accum)))
    got = ttone.linear_to_srgb_u8(torch.from_numpy(accum)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tmath.linear_to_srgb(torch.from_numpy(accum)).numpy(),
        np.asarray(jmath.linear_to_srgb(jnp.asarray(accum))), atol=1e-6,
    )

    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    jx, jy = jmath.ortho_basis(jnp.asarray(n))
    tx, ty = tmath.ortho_basis(torch.from_numpy(n))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    a, b = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    np.testing.assert_allclose(
        tmath.power_heuristic(1.0, torch.from_numpy(a), 1.0, torch.from_numpy(b)).numpy(),
        np.asarray(jmath.power_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b))),
        atol=1e-6,
    )
