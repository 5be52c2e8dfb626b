"""ctypes binding of the native SAH BVH builder and OBJ parser
(native/bvhbuilder.cpp, native/objparser.cpp): the port's counterpart of
chameleonrt_tpu/native.py, over the same plain C interface.

The library is compiled at first use from the repository's sources and
nothing else, with g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off into
chameleonrt_tpu_torch/_build/, named by a hash of its sources, the
compiler and its flags, as _build.py names the CUDA kernels' library. Without -march=native a library built on
one host loads on any other, and without contracted multiply-adds every
host builds the same tables. (native/Makefile builds the JAX package's
copy with -march=native: on a host with FMA its SAH costs round otherwise,
so its split choices, and so its tables, can differ from the port's.)

The build holds _build's file lock and writes a temporary file that
os.replace moves into place, so concurrent processes (test workers, for
one) neither race nor load a half-written library. get_lib() is None only
where there is no C++ compiler; a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from chameleonrt_tpu_torch import _build
from chameleonrt_tpu_torch.core import tracing

_NATIVE_DIR = os.path.join(os.path.dirname(_build._PKG), "native")
SOURCES = tuple(os.path.join(_NATIVE_DIR, f) for f in ("bvhbuilder.cpp", "objparser.cpp"))
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")


def library_path(cxx: str) -> str:
    """Path of the native library, compiled with cxx if missing. Its name
    hashes the sources, cxx's path and version, and CXX_FLAGS."""
    version = _build._run([cxx, "--version"], 60)
    out = os.path.join(_build.BUILD_DIR,
                       f"libcrt_native_{_build._digest(SOURCES, (cxx, version, *CXX_FLAGS))}.so")
    with _build._file_lock("native"):
        if not os.path.exists(out):
            tracing.count("native_builds")
            tmp = out + f".tmp{os.getpid()}"
            try:
                _build._run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES], 300)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return out


def compiler() -> Optional[str]:
    """Path of the C++ compiler that builds the native library (CXX, else
    g++, looked up on PATH); None where there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, compiled and loaded on first call; None where
    no C++ compiler is installed (compiler())."""
    cxx = compiler()
    if cxx is None:
        return None
    with tracing.span("native.load"):
        lib = ctypes.CDLL(library_path(cxx))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.crt_obj_parse.restype = vp
    lib.crt_obj_parse.argtypes = [ctypes.c_char_p]
    lib.crt_obj_error.restype = ctypes.c_char_p
    lib.crt_obj_error.argtypes = [vp]
    lib.crt_obj_num_shapes.restype = i32
    lib.crt_obj_num_shapes.argtypes = [vp]
    lib.crt_obj_num_mtllibs.restype = i32
    lib.crt_obj_num_mtllibs.argtypes = [vp]
    lib.crt_obj_mtllib.restype = ctypes.c_char_p
    lib.crt_obj_mtllib.argtypes = [vp, i32]
    lib.crt_obj_shape_counts.argtypes = [vp, i32] + [ctypes.POINTER(i64)] * 2 + [ctypes.POINTER(i32)] * 3
    lib.crt_obj_shape_material.restype = ctypes.c_char_p
    lib.crt_obj_shape_material.argtypes = [vp, i32]
    lib.crt_obj_shape_data.argtypes = [vp, i32, fptr, fptr, fptr, ctypes.POINTER(ctypes.c_uint32)]
    lib.crt_obj_free.argtypes = [vp]
    lib.crt_bvh_build_w.restype = vp
    lib.crt_bvh_build_w.argtypes = [fptr, fptr, fptr, i64, i32, i32]
    lib.crt_bvh_num_internal.restype = i64
    lib.crt_bvh_num_internal.argtypes = [vp]
    lib.crt_bvh_num_leaves.restype = i64
    lib.crt_bvh_num_leaves.argtypes = [vp]
    lib.crt_bvh_max_depth.restype = i32
    lib.crt_bvh_max_depth.argtypes = [vp]
    lib.crt_bvh_nodes.argtypes = [vp, fptr]
    lib.crt_bvh_leaf_rows.argtypes = [vp, fptr]
    lib.crt_bvh_num_nodes4.restype = i64
    lib.crt_bvh_num_nodes4.argtypes = [vp]
    lib.crt_bvh_max_stack4.restype = i32
    lib.crt_bvh_max_stack4.argtypes = [vp]
    lib.crt_bvh_nodes4.argtypes = [vp, fptr]
    lib.crt_bvh_free.argtypes = [vp]
    return lib


def build_bvh_pair_native(v0, e1, e2, leaf_size: int, wide_arity: int = 4):
    """One binned-SAH build in both packed layouts: the binary 16-float-row
    table and the collapsed wide 8W-float-row table over shared
    component-major leaf rows, unpadded. Returns (nodes2, nodesw, leaf_rows,
    depth2, max_stackw), or None where the library is unavailable or there
    are no triangles."""
    lib = get_lib()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = v0.shape[0]
    if n == 0:
        return None
    fptr = ctypes.POINTER(ctypes.c_float)
    handle = lib.crt_bvh_build_w(v0.ctypes.data_as(fptr), e1.ctypes.data_as(fptr),
                                 e2.ctypes.data_as(fptr), n, leaf_size, wide_arity)
    if not handle:
        return None
    try:
        nodes2 = np.zeros((lib.crt_bvh_num_internal(handle), 16), np.float32)
        nodesw = np.zeros((lib.crt_bvh_num_nodes4(handle), 8 * wide_arity), np.float32)
        leaf_rows = np.zeros((lib.crt_bvh_num_leaves(handle), 10 * leaf_size), np.float32)
        lib.crt_bvh_nodes(handle, nodes2.ctypes.data_as(fptr))
        lib.crt_bvh_nodes4(handle, nodesw.ctypes.data_as(fptr))
        lib.crt_bvh_leaf_rows(handle, leaf_rows.ctypes.data_as(fptr))
        return (nodes2, nodesw, leaf_rows, int(lib.crt_bvh_max_depth(handle)),
                int(lib.crt_bvh_max_stack4(handle)))
    finally:
        lib.crt_bvh_free(handle)


class NativeObjShape:
    def __init__(self, vertices, normals, uvs, indices, material: str, mixed: bool):
        self.vertices = vertices
        self.normals = normals
        self.uvs = uvs
        self.indices = indices
        self.material = material
        self.mixed_materials = mixed


def parse_obj_native(path: str) -> Optional[Tuple[List[NativeObjShape], List[str]]]:
    """Parse OBJ geometry with the native library. Returns (shapes, mtllib
    names), or None where the library is unavailable or cannot open the
    file; raises IOError on a parse error."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.crt_obj_parse(path.encode())
    if not handle:
        return None
    fptr = ctypes.POINTER(ctypes.c_float)
    try:
        err = lib.crt_obj_error(handle)
        if err:
            raise IOError(err.decode())
        shapes = []
        for si in range(lib.crt_obj_num_shapes(handle)):
            nv, nt = ctypes.c_int64(), ctypes.c_int64()
            hn, hu, mm = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
            lib.crt_obj_shape_counts(handle, si, ctypes.byref(nv), ctypes.byref(nt),
                                     ctypes.byref(hn), ctypes.byref(hu), ctypes.byref(mm))
            verts = np.empty((nv.value, 3), np.float32)
            norms = np.empty((nv.value, 3), np.float32) if hn.value else None
            uvs = np.empty((nv.value, 2), np.float32) if hu.value else None
            tris = np.empty((nt.value, 3), np.uint32)
            lib.crt_obj_shape_data(
                handle, si, verts.ctypes.data_as(fptr),
                norms.ctypes.data_as(fptr) if norms is not None else None,
                uvs.ctypes.data_as(fptr) if uvs is not None else None,
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            )
            mat = lib.crt_obj_shape_material(handle, si).decode()
            shapes.append(NativeObjShape(verts, norms, uvs, tris, mat, bool(mm.value)))
        mtllibs = [lib.crt_obj_mtllib(handle, i).decode()
                   for i in range(lib.crt_obj_num_mtllibs(handle))]
        return shapes, mtllibs
    finally:
        lib.crt_obj_free(handle)
