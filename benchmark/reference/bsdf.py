"""Disney BSDF evaluation, pdf and sampling of the plain reference: a
frozen copy of chameleonrt_tpu_torch/ops/bsdf.py (ChameleonRT's
disney_bsdf.ih:38-429).

Lane-level branches are torch.where over guarded denominators, so a masked
lane cannot poison an active one with NaNs. Sampling draws and component
choice follow the reference order (disney_bsdf.ih:364-429).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rng
from .vmath import (
    M_1_PI,
    M_PI,
    dot,
    lerp,
    luminance,
    normalize,
    reflect,
    refract,
    saturate,
    sqr,
)

_ALPHA_MIN = 0.001


class MaterialBatch(NamedTuple):
    """SoA Disney material parameters, one entry per lane."""

    base_color: torch.Tensor  # (..., 3)
    metallic: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    specular_tint: torch.Tensor
    anisotropy: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor


def _where(c, a, b):
    """torch.where that accepts Python scalars on either side."""
    ref = b if torch.is_tensor(b) else a
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return torch.where(c, a, b)


def same_hemisphere(w_o, w_i, n):
    return dot(w_o, n) * dot(w_i, n) > 0.0


def cos_sample_hemisphere(u):
    """Concentric-disk cosine hemisphere sample about +z (disney_bsdf.ih:44-62)."""
    s = 2.0 * u - 1.0
    sx, sy = s[..., 0], s[..., 1]
    use_x = sx.abs() > sy.abs()
    radius = torch.where(use_x, sx, sy)
    safe_sx = _where(sx == 0.0, 1.0, sx)
    safe_sy = _where(sy == 0.0, 1.0, sy)
    theta = torch.where(
        use_x,
        (M_PI / 4.0) * (sy / safe_sx),
        M_PI / 2.0 - (M_PI / 4.0) * (sx / safe_sy),
    )
    degenerate = (sx == 0.0) & (sy == 0.0)
    radius = _where(degenerate, 0.0, radius)
    dx = radius * torch.cos(theta)
    dy = radius * torch.sin(theta)
    dz = torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))
    return torch.stack([dx, dy, dz], dim=-1)


def spherical_dir(sin_theta, cos_theta, phi):
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def schlick_weight(cos_theta):
    # x**5 as square-square-multiply, the order XLA's integer power uses
    x = saturate(1.0 - cos_theta)
    x2 = x * x
    return x2 * x2 * x


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Full Fresnel dielectric (disney_bsdf.ih:82-89)."""
    g2 = sqr(eta_t) / torch.clamp(sqr(eta_i), min=1e-20) - 1.0 + sqr(cos_theta_i)
    total = g2 < 0.0
    g = torch.sqrt(torch.clamp(g2, min=0.0))
    denom1 = _where((g + cos_theta_i).abs() < 1e-20, 1.0, g + cos_theta_i)
    denom2 = cos_theta_i * (g - cos_theta_i) + 1.0
    denom2 = _where(denom2.abs() < 1e-20, 1.0, denom2)
    f = (
        0.5
        * sqr(g - cos_theta_i)
        / sqr(denom1)
        * (1.0 + sqr(cos_theta_i * (g + cos_theta_i) - 1.0) / sqr(denom2))
    )
    return _where(total, 1.0, f)


def gtr_1(cos_theta_h, alpha):
    """GTR gamma=1 NDF for clearcoat (disney_bsdf.ih:93-99)."""
    alpha_sqr = sqr(alpha)
    log_a = torch.log(torch.clamp(alpha_sqr, min=1e-20))
    log_a = _where(log_a == 0.0, 1.0, log_a)
    d = M_1_PI * (alpha_sqr - 1.0) / (log_a * (1.0 + (alpha_sqr - 1.0) * sqr(cos_theta_h)))
    return _where(alpha >= 1.0, M_1_PI, d)


def gtr_2(cos_theta_h, alpha):
    """GTR gamma=2 (GGX) NDF (disney_bsdf.ih:103-106)."""
    alpha_sqr = sqr(alpha)
    return M_1_PI * alpha_sqr / torch.clamp(
        sqr(1.0 + (alpha_sqr - 1.0) * sqr(cos_theta_h)), min=1e-20
    )


def gtr_2_aniso(h_dot_n, h_dot_x, h_dot_y, alpha_x, alpha_y):
    """Anisotropic GTR2 NDF (disney_bsdf.ih:110-113)."""
    denom = alpha_x * alpha_y * sqr(
        sqr(h_dot_x / alpha_x) + sqr(h_dot_y / alpha_y) + sqr(h_dot_n)
    )
    return M_1_PI / torch.clamp(denom, min=1e-20)


def smith_shadowing_ggx(n_dot_o, alpha_g):
    a = sqr(alpha_g)
    b = sqr(n_dot_o)
    return 1.0 / torch.clamp(
        n_dot_o + torch.sqrt(torch.clamp(a + b - a * b, min=0.0)), min=1e-10
    )


def smith_shadowing_ggx_aniso(n_dot_o, o_dot_x, o_dot_y, alpha_x, alpha_y):
    return 1.0 / torch.clamp(
        n_dot_o
        + torch.sqrt(
            torch.clamp(
                sqr(o_dot_x * alpha_x) + sqr(o_dot_y * alpha_y) + sqr(n_dot_o), min=0.0
            )
        ),
        min=1e-10,
    )


def _to_world(hemi, n, v_x, v_y):
    return hemi[..., 0:1] * v_x + hemi[..., 1:2] * v_y + hemi[..., 2:3] * n


def sample_lambertian_dir(n, v_x, v_y, s):
    return _to_world(normalize(cos_sample_hemisphere(s)), n, v_x, v_y)


def sample_gtr_1_h(n, v_x, v_y, alpha, s):
    """Clearcoat half-vector sample (disney_bsdf.ih:132-140)."""
    phi_h = 2.0 * M_PI * s[..., 0]
    alpha_sqr = torch.clamp(sqr(alpha), min=1e-8)
    cos_theta_h_sqr = (1.0 - torch.pow(alpha_sqr, 1.0 - s[..., 1])) / _where(
        alpha_sqr == 1.0, 1.0, 1.0 - alpha_sqr
    )
    cos_theta_h = torch.sqrt(torch.clamp(cos_theta_h_sqr, min=0.0))
    sin_theta_h = torch.sqrt(torch.clamp(1.0 - cos_theta_h_sqr, min=0.0))
    hemi = normalize(spherical_dir(sin_theta_h, cos_theta_h, phi_h))
    return _to_world(hemi, n, v_x, v_y)


def sample_gtr_2_h(n, v_x, v_y, alpha, s):
    """GGX half-vector sample (disney_bsdf.ih:142-149)."""
    phi_h = 2.0 * M_PI * s[..., 0]
    cos_theta_h_sqr = (1.0 - s[..., 1]) / torch.clamp(
        1.0 + (sqr(alpha) - 1.0) * s[..., 1], min=1e-20
    )
    cos_theta_h = torch.sqrt(torch.clamp(cos_theta_h_sqr, min=0.0))
    sin_theta_h = torch.sqrt(torch.clamp(1.0 - cos_theta_h_sqr, min=0.0))
    hemi = normalize(spherical_dir(sin_theta_h, cos_theta_h, phi_h))
    return _to_world(hemi, n, v_x, v_y)


def sample_gtr_2_aniso_h(n, v_x, v_y, alpha_x, alpha_y, s):
    """Anisotropic GGX half-vector sample (disney_bsdf.ih:151-155)."""
    x = 2.0 * M_PI * s[..., 0]
    scale = torch.sqrt(s[..., 1] / torch.clamp(1.0 - s[..., 1], min=1e-20))
    w_h = (
        scale[..., None]
        * (
            alpha_x[..., None] * torch.cos(x)[..., None] * v_x
            + alpha_y[..., None] * torch.sin(x)[..., None] * v_y
        )
        + n
    )
    return normalize(w_h)


def lambertian_pdf(w_i, n):
    d = dot(w_i, n)
    return _where(d > 0.0, d * M_1_PI, 0.0)


def _half_vector_pdf(w_o, w_i, n, d_of_cos):
    """Shared reflection-pdf shape: D(cos_h) * cos_h / (4 |w_o . w_h|)."""
    w_h = normalize(w_i + w_o)
    cos_theta_h = dot(n, w_h)
    d = d_of_cos(cos_theta_h, w_h)
    o_dot_h = dot(w_o, w_h)
    o_dot_h = _where(o_dot_h.abs() < 1e-10, 1e-10, o_dot_h)
    pdf = d * cos_theta_h / (4.0 * o_dot_h)
    return _where(same_hemisphere(w_o, w_i, n), pdf, 0.0)


def gtr_1_pdf(w_o, w_i, n, alpha):
    return _half_vector_pdf(w_o, w_i, n, lambda c, _h: gtr_1(c, alpha))


def gtr_2_pdf(w_o, w_i, n, alpha):
    return _half_vector_pdf(w_o, w_i, n, lambda c, _h: gtr_2(c, alpha))


def gtr_2_aniso_pdf(w_o, w_i, n, v_x, v_y, alpha_x, alpha_y):
    return _half_vector_pdf(
        w_o,
        w_i,
        n,
        lambda c, h: gtr_2_aniso(c, dot(h, v_x).abs(), dot(h, v_y).abs(), alpha_x, alpha_y),
    )


def gtr_2_transmission_pdf(w_o, w_i, n, alpha, ior):
    """Transmission half-vector pdf with the refraction Jacobian
    (disney_bsdf.ih:185-201)."""
    entering = dot(w_o, n) > 0.0
    eta_o = _where(entering, 1.0, ior)
    eta_i = _where(entering, ior, 1.0)
    w_h = normalize(w_o + w_i * (eta_i / eta_o)[..., None])
    cos_theta_h = dot(n, w_h).abs()
    i_dot_h = dot(w_i, w_h)
    o_dot_h = dot(w_o, w_h)
    d = gtr_2(cos_theta_h, alpha)
    denom = sqr(eta_o * o_dot_h + eta_i * i_dot_h)
    dwh_dwi = o_dot_h * sqr(eta_o) / torch.clamp(denom, min=1e-20)
    pdf = d * cos_theta_h * dwh_dwi.abs()
    return _where(same_hemisphere(w_o, w_i, n), 0.0, pdf)


def disney_diffuse(mat: MaterialBatch, n, w_o, w_i):
    """Burley diffuse with retro-reflection (disney_bsdf.ih:215-226)."""
    w_h = normalize(w_i + w_o)
    n_dot_o = dot(w_o, n).abs()
    n_dot_i = dot(w_i, n).abs()
    i_dot_h = dot(w_i, w_h)
    fd90 = 0.5 + 2.0 * mat.roughness * sqr(i_dot_h)
    fi = schlick_weight(n_dot_i)
    fo = schlick_weight(n_dot_o)
    return mat.base_color * (M_1_PI * lerp(1.0, fd90, fi) * lerp(1.0, fd90, fo))[..., None]


def _tint(mat: MaterialBatch):
    lum = luminance(mat.base_color)[..., None]
    return _where(lum > 0.0, mat.base_color / torch.clamp(lum, min=1e-20), 1.0)


def _specular_color(mat: MaterialBatch):
    return lerp(
        (mat.specular * 0.08)[..., None] * lerp(1.0, _tint(mat), mat.specular_tint[..., None]),
        mat.base_color,
        mat.metallic[..., None],
    )


def disney_microfacet_isotropic(mat: MaterialBatch, n, w_o, w_i):
    """(disney_bsdf.ih:228-241)"""
    w_h = normalize(w_i + w_o)
    spec = _specular_color(mat)
    alpha = torch.clamp(sqr(mat.roughness), min=_ALPHA_MIN)
    d = gtr_2(dot(n, w_h), alpha)
    f = lerp(spec, 1.0, schlick_weight(dot(w_i, w_h))[..., None])
    g = smith_shadowing_ggx(dot(n, w_i), alpha) * smith_shadowing_ggx(dot(n, w_o), alpha)
    return (d * g)[..., None] * f


def _aniso_alphas(mat: MaterialBatch, a):
    aspect = torch.sqrt(torch.clamp(1.0 - mat.anisotropy * 0.9, min=1e-8))
    return torch.clamp(a / aspect, min=_ALPHA_MIN), torch.clamp(a * aspect, min=_ALPHA_MIN)


def disney_microfacet_anisotropic(mat: MaterialBatch, n, w_o, w_i, v_x, v_y):
    """(disney_bsdf.ih:271-287)"""
    w_h = normalize(w_i + w_o)
    spec = _specular_color(mat)
    alpha_x, alpha_y = _aniso_alphas(mat, sqr(mat.roughness))
    d = gtr_2_aniso(dot(n, w_h), dot(w_h, v_x).abs(), dot(w_h, v_y).abs(), alpha_x, alpha_y)
    f = lerp(spec, 1.0, schlick_weight(dot(w_i, w_h))[..., None])
    g = smith_shadowing_ggx_aniso(
        dot(n, w_i), dot(w_i, v_x).abs(), dot(w_i, v_y).abs(), alpha_x, alpha_y
    ) * smith_shadowing_ggx_aniso(
        dot(n, w_o), dot(w_o, v_x).abs(), dot(w_o, v_y).abs(), alpha_x, alpha_y
    )
    return (d * g)[..., None] * f


def disney_microfacet_transmission_isotropic(mat: MaterialBatch, n, w_o, w_i):
    """(disney_bsdf.ih:243-269)"""
    o_dot_n = dot(w_o, n)
    i_dot_n = dot(w_i, n)
    degenerate = (o_dot_n == 0.0) | (i_dot_n == 0.0)
    entering = o_dot_n > 0.0
    eta_o = _where(entering, 1.0, mat.ior)
    eta_i = _where(entering, mat.ior, 1.0)
    w_h = normalize(w_o + w_i * (eta_i / eta_o)[..., None])
    alpha = torch.clamp(sqr(mat.roughness), min=_ALPHA_MIN)
    d = gtr_2(dot(n, w_h).abs(), alpha)
    f = fresnel_dielectric(dot(w_i, n).abs(), eta_o, eta_i)
    g = smith_shadowing_ggx(dot(n, w_i).abs(), alpha) * smith_shadowing_ggx(
        dot(n, w_o).abs(), alpha
    )
    i_dot_h = dot(w_i, w_h)
    o_dot_h = dot(w_o, w_h)
    c = (
        o_dot_h.abs()
        / torch.clamp(o_dot_n.abs(), min=1e-10)
        * i_dot_h.abs()
        / torch.clamp(i_dot_n.abs(), min=1e-10)
        * sqr(eta_o)
        / torch.clamp(sqr(eta_o * o_dot_h + eta_i * i_dot_h), min=1e-20)
    )
    val = mat.base_color * (c * (1.0 - f) * g * d)[..., None]
    return _where(degenerate[..., None], 0.0, val)


def disney_clear_coat(mat: MaterialBatch, n, w_o, w_i):
    """(disney_bsdf.ih:289-298)"""
    w_h = normalize(w_i + w_o)
    alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)
    d = gtr_1(dot(n, w_h), alpha)
    f = lerp(0.04, 1.0, schlick_weight(dot(w_i, n)))
    g = smith_shadowing_ggx(dot(n, w_i), 0.25) * smith_shadowing_ggx(dot(n, w_o), 0.25)
    return 0.25 * mat.clearcoat * d * f * g


def disney_sheen(mat: MaterialBatch, n, w_o, w_i):
    """(disney_bsdf.ih:300-309)"""
    sheen_color = lerp(1.0, _tint(mat), mat.sheen_tint[..., None])
    f = schlick_weight(dot(w_i, n))
    return (f * mat.sheen)[..., None] * sheen_color


def disney_brdf(mat: MaterialBatch, n, w_o, w_i, v_x, v_y):
    """Full Disney BSDF evaluation (disney_bsdf.ih:311-332)."""
    same_hemi = same_hemisphere(w_o, w_i, n)

    spec_trans = disney_microfacet_transmission_isotropic(mat, n, w_o, w_i)
    trans_val = spec_trans * ((1.0 - mat.metallic) * mat.specular_transmission)[..., None]
    trans_val = _where((mat.specular_transmission > 0.0)[..., None], trans_val, 0.0)

    coat = disney_clear_coat(mat, n, w_o, w_i)
    sheen = disney_sheen(mat, n, w_o, w_i)
    diffuse = disney_diffuse(mat, n, w_o, w_i)
    gloss_iso = disney_microfacet_isotropic(mat, n, w_o, w_i)
    gloss_aniso = disney_microfacet_anisotropic(mat, n, w_o, w_i, v_x, v_y)
    gloss = torch.where((mat.anisotropy == 0.0)[..., None], gloss_iso, gloss_aniso)
    refl_val = (
        (diffuse + sheen)
        * ((1.0 - mat.metallic) * (1.0 - mat.specular_transmission))[..., None]
        + gloss
        + coat[..., None]
    )
    return torch.where(same_hemi[..., None], refl_val, trans_val)


def disney_pdf(mat: MaterialBatch, n, w_o, w_i, v_x, v_y):
    """Mixture pdf over the sampled components (disney_bsdf.ih:334-359)."""
    alpha = torch.clamp(sqr(mat.roughness), min=_ALPHA_MIN)
    alpha_x, alpha_y = _aniso_alphas(mat, alpha)
    clearcoat_alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)

    diffuse = lambertian_pdf(w_i, n)
    clear_coat = gtr_1_pdf(w_o, w_i, n, clearcoat_alpha)
    micro_iso = gtr_2_pdf(w_o, w_i, n, alpha)
    micro_aniso = gtr_2_aniso_pdf(w_o, w_i, n, v_x, v_y, alpha_x, alpha_y)
    microfacet = torch.where(mat.anisotropy == 0.0, micro_iso, micro_aniso)
    has_trans = mat.specular_transmission > 0.0
    micro_trans = _where(has_trans, gtr_2_transmission_pdf(w_o, w_i, n, alpha, mat.ior), 0.0)
    n_comp = _where(has_trans, 4.0, torch.full_like(alpha, 3.0))
    return (diffuse + microfacet + micro_trans + clear_coat) / n_comp


def sample_disney_brdf(mat: MaterialBatch, n, w_o, v_x, v_y, rng_state):
    """Sample a continuation direction (disney_bsdf.ih:364-429). Returns
    (rng_state, bsdf value, w_i, pdf); an invalid sample gives pdf = 0,
    bsdf = 0 and w_i = 0, the reference's terminate-on-invalid rule."""
    has_trans = mat.specular_transmission > 0.0
    rng_state, u_comp = rng.lcg_randomf(rng_state)
    n_comp = _where(has_trans, 4.0, torch.full_like(u_comp, 3.0))
    max_comp = _where(has_trans, 3, torch.full_like(u_comp, 2, dtype=torch.int32))
    component = torch.minimum(
        torch.clamp((u_comp * n_comp).to(torch.int32), min=0), max_comp
    )

    rng_state, samples = rng.lcg_randomf2(rng_state)

    alpha = torch.clamp(sqr(mat.roughness), min=_ALPHA_MIN)
    alpha_x, alpha_y = _aniso_alphas(mat, alpha)

    # component 0: diffuse
    w_i_diffuse = sample_lambertian_dir(n, v_x, v_y, samples)

    # component 1: microfacet reflection (iso or aniso)
    w_h_iso = sample_gtr_2_h(n, v_x, v_y, alpha, samples)
    w_h_aniso = sample_gtr_2_aniso_h(n, v_x, v_y, alpha_x, alpha_y, samples)
    w_h_micro = torch.where((mat.anisotropy == 0.0)[..., None], w_h_iso, w_h_aniso)
    w_i_micro = reflect(-w_o, w_h_micro)
    micro_valid = same_hemisphere(w_o, w_i_micro, n)

    # component 2: clearcoat reflection
    cc_alpha = lerp(0.1, 0.001, mat.clearcoat_gloss)
    w_h_cc = sample_gtr_1_h(n, v_x, v_y, cc_alpha, samples)
    w_i_cc = reflect(-w_o, w_h_cc)
    cc_valid = same_hemisphere(w_o, w_i_cc, n)

    # component 3: microfacet transmission
    w_h_t = sample_gtr_2_h(n, v_x, v_y, alpha, samples)
    w_h_t = torch.where(dot(w_o, w_h_t)[..., None] < 0.0, -w_h_t, w_h_t)
    entering = dot(w_o, n) > 0.0
    eta = _where(entering, 1.0 / mat.ior, mat.ior)
    w_i_t = refract(-w_o, w_h_t, eta)
    t_valid = dot(w_i_t, w_i_t) > 0.0

    c = component[..., None]
    w_i = torch.where(
        c == 0,
        w_i_diffuse,
        torch.where(c == 1, w_i_micro, torch.where(c == 2, w_i_cc, w_i_t)),
    )
    valid = torch.where(
        component == 0,
        torch.ones_like(micro_valid),
        torch.where(component == 1, micro_valid, torch.where(component == 2, cc_valid, t_valid)),
    )

    pdf = disney_pdf(mat, n, w_o, w_i, v_x, v_y)
    bsdf = disney_brdf(mat, n, w_o, w_i, v_x, v_y)

    pdf = _where(valid, pdf, 0.0)
    bsdf = _where(valid[..., None], bsdf, 0.0)
    w_i = _where(valid[..., None], w_i, 0.0)
    return rng_state, bsdf, w_i, pdf
