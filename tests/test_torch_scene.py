"""The port's scene tables against chameleonrt_tpu's: shade rows, material
rows, instance tables, lights and the texture atlas from
build_device_scene (on the port's own loader's scene) are bit-equal to the
JAX arrays (on the JAX loader's), and convert.from_jax hands the JAX tables
over unchanged. The BVH tables built on this host equal the JAX package's
(which pads them to bucketed row counts) when both run on one native SAH
library (test_torch_host.jax_native_on_port_library)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chameleonrt_tpu.engine import device_scene as jds
from chameleonrt_tpu.engine import trace_bvh as jtb
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import convert, native
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.engine import trace_bvh as ttb
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_torch_host import jax_native_on_port_library

torch.set_num_threads(1)

SCENES = ["proc://cornell", "proc://hall?subdiv=1&textured=1&columns=4"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(port, jflat):
    for name in ("tri_v0", "tri_e1", "tri_e2", "shade_rows", "mat_rows",
                 "inst_transform", "inst_inv", "inst_mat_table"):
        a, b = _np(getattr(port, name)), _np(getattr(jflat, name))
        assert a.dtype == b.dtype, name
        # bit-equal, as integers (float slots carry texture-handle bits)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=name)
    for f in port.lights._fields:
        np.testing.assert_array_equal(_np(getattr(port.lights, f)), _np(getattr(jflat.lights, f)))
    np.testing.assert_array_equal(_np(port.atlas.atlas), _np(jflat.atlas.atlas))
    np.testing.assert_array_equal(_np(port.atlas.table), _np(jflat.atlas.table))


@pytest.mark.parametrize("uri", SCENES)
def test_device_scene_matches_jax(uri):
    jflat, jmeta = jds.build_device_scene(jax_load_scene(uri))
    flat, meta = tds.build_device_scene(load_scene(uri), torch.device("cpu"))
    _assert_tables_equal(flat, jflat)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    if "textured" in uri:
        assert meta.has_textures and any(meta.textured_fields)


@pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")
@pytest.mark.parametrize("uri", SCENES)
def test_from_jax_and_bvh_tables(uri):
    jflat, jmeta, host = jds.build_device_scene(jax_load_scene(uri), want_host=True)
    with jax_native_on_port_library():
        jblas = jtb.build_blas_set(jflat, jmeta, host)
    flat_np = jax.tree.map(np.asarray, jflat)
    blas_np = jax.tree.map(np.asarray, jblas)
    conv, cmeta = convert.from_jax(flat_np, jmeta, blas_np, torch.device("cpu"))
    _assert_tables_equal(conv, jflat)
    assert dataclasses.asdict(cmeta) == dataclasses.asdict(jmeta)

    flat, meta = tds.build_device_scene(load_scene(uri), torch.device("cpu"))
    blas = ttb.build_blas_set(flat, meta)
    assert len(blas) == len(conv.blas) == 1
    for kind in ("closest", "any"):
        mine, theirs = getattr(blas[0], kind), getattr(conv.blas[0], kind)
        n, m = mine.nodes.shape[0], mine.leaf_rows.shape[0]
        assert mine.max_depth == theirs.max_depth
        # the JAX tables are the same rows followed by zero padding,
        # compared as bits (child codes bitcast to float can read as NaN)
        assert torch.equal(mine.nodes.view(torch.int32), theirs.nodes[:n].view(torch.int32))
        assert torch.equal(mine.leaf_rows.view(torch.int32), theirs.leaf_rows[:m].view(torch.int32))
        assert not theirs.nodes[n:].any() and not theirs.leaf_rows[m:].any()
