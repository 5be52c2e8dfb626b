"""The JAX backend's row-chunked ray count against the port's exact one.

Without its packet kernels (on the CPU), the JAX backend renders a scene
of more than 1M triangles, or any scene under CHAMELEONRT_CHUNKS=k, in k
launches of Hc = ceil(H / k) rows (chameleonrt_tpu/engine/backend_base.py
_render_chunks). The last launch's rows past H wrap onto the top rows,
and its ray count is scaled by its real rows, real / Hc, which assumes
every row traces as many rays as any other. The port counts every lane
exactly. So the JAX count is the port's less A - floor((A + B) * real /
Hc), where A counts the rays of the last launch's real rows and B those of
its wrapped rows, within the packages' allowance (C2: one bounce of one
path, 3 rays). This is why the two packages' counts part on the 6.7M
triangle city (27 launches of 14 rows) and agree on scenes of one launch.
"""

import numpy as np
import pytest
import torch

from chameleonrt_tpu.core import get_backend as jax_get_backend
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core import get_backend
from chameleonrt_tpu_torch.engine import path_tracer
from chameleonrt_tpu_torch.ops import camera as camera_ops
from chameleonrt_tpu_torch.scene.loader import load_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

CORNELL = "proc://cornell"
W, H = 32, 29
RAYS_ALLOWANCE = 3  # C2


def _view(scene):
    cam = scene.cameras[0]
    d = cam.center - cam.position
    return cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y


@pytest.fixture(scope="module")
def port_rows():
    """rays(y0, y1): the port's exact ray count of frame 0's rows [y0, y1)."""
    scene = load_scene(CORNELL)
    b = get_backend("cuda", device="cpu")
    b.initialize(W, H)
    b.set_scene(scene)
    view = camera_ops.compute_view_params(*_view(scene), W, H)

    def rays(y0, y1):
        ys, xs = torch.meshgrid(torch.arange(y0, y1), torch.arange(W), indexing="ij")
        _, r = path_tracer.render_pixels(b.flat, b.meta, *b._trace, view, 0, xs.reshape(-1),
                                         ys.reshape(-1), W, H, 1)
        return int(r)

    return rays


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_chunked_count_is_the_last_chunks_estimate(chunks, port_rows, monkeypatch):
    """H = 29 rows in k launches (H % k != 0 for k > 1): the JAX frame's
    count against the port's exact count corrected by the last launch's
    estimate; exactly the port's count with one launch."""
    monkeypatch.setenv("CHAMELEONRT_CHUNKS", str(chunks))
    scene = jax_load_scene(CORNELL)
    jb = jax_get_backend("tpu")
    jb.initialize(W, H)
    jb.set_scene(scene)
    assert jb._render_chunks() == chunks
    got = jb.render(*_view(scene), camera_changed=True).rays_traced

    exact = port_rows(0, H)
    hc = -(-H // chunks)
    last = (chunks - 1) * hc
    real = H - last
    assert 0 < real <= hc and (chunks == 1) == (real == hc)
    if real == hc:
        want = exact
    else:
        a, b = port_rows(last, H), port_rows(0, hc - real)
        want = exact - a + (a + b) * real // hc
        # the estimate parts from the exact count by more than the allowance
        assert abs(exact - want) > RAYS_ALLOWANCE
    assert abs(got - want) <= RAYS_ALLOWANCE, (got, want, exact)
