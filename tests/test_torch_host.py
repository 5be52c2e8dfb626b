"""The port's own host layer (scene/, core/, utils/, native.py) against the
JAX package's, and the rule that the port imports nothing of it.

- Every loader of the port gives the same scene as its JAX counterpart:
  geometry, instances, materials, texture bytes and colour spaces, lights,
  cameras, sample count and material mode.
- The port's native binding returns the same tables as the JAX package's
  binding over the same library. The port compiles native/ without
  -march=native and without contracted multiply-adds, so against the JAX
  package's own build (native/Makefile, -march=native) it agrees on the
  triangles and the root box; the split choices may differ on a host with
  FMA, whose SAH costs round otherwise.
- A static scan of the port and of chip_smoke.py, and a fresh interpreter
  that renders a frame on the CPU, find no import of jax or of
  chameleonrt_tpu.
- The entry points refuse a Scene of the JAX package.

port_scene and jax_native_on_port_library serve the other test_torch_*
files too.
"""

import ast
import contextlib
import dataclasses
import enum
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chameleonrt_tpu import native as jnative
from chameleonrt_tpu.core import registry as jregistry
from chameleonrt_tpu.scene import pbrt_gen as jgen
from chameleonrt_tpu.scene import types as jtypes
from chameleonrt_tpu.scene.loader import load_scene as jax_load_scene
from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch import native as pnative
from chameleonrt_tpu_torch.core import registry as pregistry
from chameleonrt_tpu_torch.engine import device_scene as tds
from chameleonrt_tpu_torch.scene import pbrt_gen as pgen
from chameleonrt_tpu_torch.scene import types as ptypes
from chameleonrt_tpu_torch.scene.loader import load_scene
from test_crts import make_crts
from test_gltf import make_quad_gltf
from test_native_obj import MTL, OBJ

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny San Miguel (pbrt_gen's own test variant)
TINY_SAN_MIGUEL = dict(col_subdiv=1, leaf_tris=400, canopy_instances=4)


def port_scene(scene):
    """The port's Scene with the fields of a JAX package Scene: every
    dataclass and enum rebuilt from the port's scene/types.py."""

    def conv(x):
        if isinstance(x, enum.Enum):
            return getattr(ptypes, type(x).__name__)[x.name]
        if dataclasses.is_dataclass(x):
            cls = getattr(ptypes, type(x).__name__)
            return cls(**{f.name: conv(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x

    return conv(scene)


@contextlib.contextmanager
def jax_native_on_port_library():
    """The JAX package's native binding (chameleonrt_tpu/native.py) over
    the port's library, so that both packages' table code runs on one SAH
    build."""
    saved = (jnative._LIB_PATH, jnative._lib, jnative._tried)
    jnative._LIB_PATH, jnative._lib, jnative._tried = pnative.get_lib()._name, None, False
    try:
        assert jnative.get_lib() is not None
        yield
    finally:
        jnative._LIB_PATH, jnative._lib, jnative._tried = saved


def _write_obj(d):
    (d / "t.obj").write_text(OBJ)
    (d / "m.mtl").write_text(MTL)
    return str(d / "t.obj")


# uri, or a writer of the file into a directory
SOURCES = {
    "cornell": "proc://cornell",
    "hall_textured": "proc://hall?subdiv=1&textured=1",
    "instances": "proc://instances?nx=2&ny=2&subdiv=0",
    "city": "proc://city?n=8",
    "random": "proc://random?n_tris=256",
    "san_miguel_tiny": lambda d: None,  # generated by each package's own pbrt_gen
    "gltf": lambda d: make_quad_gltf(d, glb=True, with_texture=True),
    "crts": make_crts,
    "obj": _write_obj,
}


def _both_scenes(name, tmp_path):
    src = SOURCES[name]
    if isinstance(src, str):
        return jax_load_scene(src), load_scene(src)
    if name == "san_miguel_tiny":
        jpath = jgen.generate_san_miguel_proxy(str(tmp_path / "jax"), **TINY_SAN_MIGUEL)
        ppath = pgen.generate_san_miguel_proxy(str(tmp_path / "port"), **TINY_SAN_MIGUEL)
        for f in sorted(os.listdir(tmp_path / "jax")):
            with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "port" / f, "rb") as b:
                assert a.read() == b.read(), f
        return jax_load_scene(jpath), load_scene(ppath)
    path = str(src(tmp_path))
    return jax_load_scene(path), load_scene(path)


def _assert_same(a, b, where):
    """a (JAX package) and b (port) hold the same values, field by field."""
    if isinstance(a, enum.Enum):
        assert type(b).__module__.startswith("chameleonrt_tpu_torch."), where
        assert (type(a).__name__, a.name, a.value) == (type(b).__name__, b.name, b.value), where
    elif dataclasses.is_dataclass(a):
        assert type(b).__name__ == type(a).__name__, where
        assert type(b).__module__ == "chameleonrt_tpu_torch.scene.types", where
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                      np.ascontiguousarray(b).view(np.uint8), err_msg=where)
    else:
        assert a == b or (a != a and b != b), where


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_loaders_match_jax(name, tmp_path):
    """Vertices, indices, normals and uvs of every geometry, the
    parameterized meshes and instance transforms, every material field
    (texture handles compared as bits), texture bytes, names and colour
    spaces, lights, cameras, the sample count and the material mode."""
    jscene, scene = _both_scenes(name, tmp_path)
    assert isinstance(scene, ptypes.Scene) and isinstance(jscene, jtypes.Scene)
    assert scene.total_tris() > 0
    _assert_same(jscene, scene, "scene")
    if name in ("hall_textured", "gltf"):
        assert scene.textures and any(t.color_space == ptypes.ColorSpace.SRGB for t in scene.textures)
    if name == "san_miguel_tiny":
        assert len(scene.instances) > 1


def _triangles(uri):
    scene = load_scene(uri)
    v0s, e1s, e2s = [], [], []
    for mesh in scene.meshes:
        for g in mesh.geometries:
            v = g.vertices[g.indices.astype(np.int64)]
            v0s.append(v[:, 0])
            e1s.append(v[:, 1] - v[:, 0])
            e2s.append(v[:, 2] - v[:, 0])
    return tuple(np.concatenate(x) for x in (v0s, e1s, e2s))


def _bits(res):
    return [x.view(np.int32) if isinstance(x, np.ndarray) else x for x in res]


@pytest.mark.parametrize("uri", ["proc://hall?subdiv=2&textured=1", "proc://city?n=14",
                                 "proc://random?n_tris=5000"])
def test_native_binding_matches_jax(uri):
    tris = _triangles(uri)
    mine = pnative.build_bvh_pair_native(*tris, 4)
    with jax_native_on_port_library():
        theirs = jnative.build_bvh_pair_native(*tris, 4)
    for a, b in zip(_bits(mine), _bits(theirs)):
        np.testing.assert_array_equal(a, b)
    # the JAX package's own build (native/Makefile), where this process has
    # it: the same triangles in the leaves and the same root box, whatever
    # the split choices
    own = jnative.build_bvh_pair_native(*tris, 4) or mine
    for res in (mine, own):
        leaf = res[2]
        prims = leaf[:, 36:40].view(np.int32)
        assert np.array_equal(np.sort(prims[prims >= 0]), np.arange(len(tris[0])))
    # the binary root's two child boxes
    for a, b in ((mine[0][0], own[0][0]),):
        np.testing.assert_array_equal(np.minimum(a[0:3], a[6:9]), np.minimum(b[0:3], b[6:9]))
        np.testing.assert_array_equal(np.maximum(a[3:6], a[9:12]), np.maximum(b[3:6], b[9:12]))


def test_native_obj_parser_matches_jax(tmp_path):
    path = _write_obj(tmp_path)
    with jax_native_on_port_library():
        theirs = jnative.parse_obj_native(path)
    mine = pnative.parse_obj_native(path)
    assert mine[1] == theirs[1] == ["m.mtl"]
    assert len(mine[0]) == len(theirs[0]) == 2
    for a, b in zip(mine[0], theirs[0]):
        assert (a.material, a.mixed_materials) == (b.material, b.mixed_materials)
        for f in ("vertices", "normals", "uvs", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_native_library_builds_once_under_concurrent_workers(tmp_path):
    """Three processes load the native library at once from an empty build
    directory: one compiles under the lock, the others wait and load the
    same file, and no temporary file is left behind."""
    code = ("import sys\n"
            "from chameleonrt_tpu_torch import _build\n"
            "_build.BUILD_DIR = sys.argv[1]\n"
            "from chameleonrt_tpu_torch import native\n"
            "lib = native.get_lib()\n"
            "r = native.build_bvh_pair_native([[0, 0, 0]], [[1, 0, 0]], [[0, 1, 0]], 4)\n"
            "print(lib._name, r[1].shape[0], r[2].shape[0])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    name = lines.pop().split()[0]
    assert os.path.dirname(name) == str(tmp_path)
    assert os.path.basename(name).startswith("libcrt_native_")
    assert sorted(os.listdir(tmp_path)) == sorted([os.path.basename(name), "native.lock"])


def test_library_name_hashes_sources_compiler_and_flags(tmp_path):
    """A library built from the same sources by another compiler, another
    version of it or other flags gets another name, so it is never loaded
    in place of this build's."""
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    build = ("/usr/bin/g++", "g++ 13.2", *pnative.CXX_FLAGS)
    base = _build._digest([str(src)], build)
    assert _build._digest([str(src)], build) == base
    for other in (("/usr/bin/clang++", *build[1:]), (build[0], "g++ 14.1", *build[2:]),
                  (*build, "-march=native"), ()):
        assert _build._digest([str(src)], other) != base, other
    src.write_text("int f() { return 2; }\n")
    assert _build._digest([str(src)], build) != base


def _port_sources():
    pkg = os.path.join(ROOT, "chameleonrt_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_of_the_port_imports_the_jax_package():
    """Every import statement, at module level or inside a function."""
    bad = []
    paths = _port_sources()
    assert len(paths) > 30
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("chameleonrt_tpu", "jax", "jaxlib"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}")
    assert not bad, bad


def test_fresh_interpreter_renders_without_the_jax_package(tmp_path):
    """Import every module of the port, load the tiny San Miguel through
    the port's generator and PBRT loader, render one 16 px frame on the
    CPU, and list what was imported."""
    code = f"""
import importlib, pkgutil, sys
import numpy as np
import chameleonrt_tpu_torch
for m in pkgutil.walk_packages(chameleonrt_tpu_torch.__path__, "chameleonrt_tpu_torch."):
    importlib.import_module(m.name)
from chameleonrt_tpu_torch.core.registry import get_backend
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.scene.pbrt_gen import generate_san_miguel_proxy
scene = load_scene(generate_san_miguel_proxy({str(tmp_path)!r}, **{TINY_SAN_MIGUEL!r}))
b = get_backend("cuda", device="cpu")
b.initialize(16, 16)
b.set_scene(scene)
cam = scene.cameras[0]
d = cam.center - cam.position
b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True)
assert b.img.shape == (16, 16, 4) and b.img[..., :3].max() > 0
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "chameleonrt_tpu")))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("entry", ["set_scene", "build_device_scene"])
def test_entry_points_refuse_a_jax_scene(entry):
    """A JAX Scene's enums compare unequal to the port's: taken as it is,
    its sRGB textures would decode as linear. The port's own Scene of the
    same file passes."""
    jscene = jax_load_scene("proc://hall?subdiv=0&textured=1")
    if entry == "set_scene":
        b = pregistry.get_backend("cuda", device="cpu")
        b.initialize(8, 8)
        call = b.set_scene
    else:
        def call(s):
            return tds.build_device_scene(s, torch.device("cpu"))
    with pytest.raises(TypeError, match="chameleonrt_tpu_torch"):
        call(jscene)
    flat, meta = tds.build_device_scene(port_scene(jscene), torch.device("cpu"))
    assert meta.has_textures and int(flat.atlas.table[:, 3].sum()) > 0  # sRGB textures


def test_registries_are_separate():
    assert pregistry.list_backends() == ["cuda", "reference"]
    assert "cuda" not in jregistry.list_backends()
    with pytest.raises(ValueError, match="tpu"):
        pregistry.get_backend("tpu")
