"""Minimal PLY mesh I/O (ascii and binary little-endian).

Parity: `vtgaussian_slam_tpu/eval/plyio.py`, kept as the port's own copy
(numpy only). Reads vertex x / y / z (with optional red / green / blue)
and faces, fan-splitting polygons into triangles; writes binary
little-endian with optional uint8 vertex colours. Files written by either
package read back in the other.
"""
from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns (verts (V,3) f32, faces (F,3) i32, colors (V,3) f32 in [0,1]
    or None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # [(name, count, [(prop_name, dtype | ("list", ct, it))])]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[4], ("list", _DTYPES[tok[2]],
                                                     _DTYPES[tok[3]])))
                else:
                    elements[-1][2].append((tok[2], _DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt == "binary_big_endian":
            raise ValueError(f"{path}: big-endian PLY not supported")
        binary = fmt == "binary_little_endian"

        verts = faces = colors = None
        for name, count, props in elements:
            if name == "vertex":
                verts, colors = _read_vertices(f, count, props, binary)
            elif name == "face":
                faces = _read_faces(f, count, props, binary)
            else:
                _skip_element(f, count, props, binary)
    if verts is None:
        raise ValueError(f"{path}: no vertex element")
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    return verts, faces, colors


def _read_vertices(f, count, props, binary):
    if any(isinstance(d, tuple) for _, d in props):
        raise ValueError("list property on vertex element not supported")
    dt = np.dtype([(n, "<" + d) for n, d in props])
    if binary:
        rec = np.frombuffer(f.read(dt.itemsize * count), dt, count)
    else:
        rows = [f.readline().split() for _ in range(count)]
        rec = np.array([tuple(r[: len(props)]) for r in rows], dt)
    verts = np.stack([rec["x"], rec["y"], rec["z"]], 1).astype(np.float32)
    colors = None
    names = dt.names
    if all(c in names for c in ("red", "green", "blue")):
        colors = np.stack([rec["red"], rec["green"], rec["blue"]],
                          1).astype(np.float32)
        if colors.max() > 1.0 + 1e-6:
            colors /= 255.0
    return verts, colors


def _read_faces(f, count, props, binary):
    # the list property is usually first, but writers may emit scalar
    # props before it; only the all-triangles fast path requires it first
    (pname, pdef) = props[0]
    if not isinstance(pdef, tuple):
        raise ValueError(
            "unsupported face layout: scalar properties before the "
            "vertex-index list")
    _, cnt_t, idx_t = pdef
    tris = []
    if binary:
        cnt_dt = np.dtype("<" + cnt_t)
        idx_dt = np.dtype("<" + idx_t)
        if len(props) == 1:
            # bulk fast path for the overwhelmingly common case (uniform
            # triangles, no trailing props): one structured read replaces
            # a two-reads-per-face Python loop that cost minutes on
            # Replica-scale GT meshes (millions of faces)
            rec = np.dtype([("n", cnt_dt), ("idx", idx_dt, (3,))])
            pos = f.tell()
            buf = f.read(rec.itemsize * count)
            if len(buf) == rec.itemsize * count:
                arr = np.frombuffer(buf, rec, count)
                if (arr["n"] == 3).all():
                    return arr["idx"].astype(np.int64)
            f.seek(pos)  # polygons present: fall through to the slow loop
        for _ in range(count):
            n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt, 1)[0])
            idx = np.frombuffer(f.read(idx_dt.itemsize * n), idx_dt, n)
            for k in range(1, n - 1):  # fan-triangulate polygons
                tris.append((idx[0], idx[k], idx[k + 1]))
            for _pn, _pd in props[1:]:
                _skip_prop(f, _pd)
    else:
        for _ in range(count):
            row = f.readline().split()
            n = int(row[0])
            idx = [int(x) for x in row[1: 1 + n]]
            for k in range(1, n - 1):
                tris.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(tris, np.int32).reshape(-1, 3)


def _skip_prop(f, pdef):
    if isinstance(pdef, tuple):
        _, cnt_t, idx_t = pdef
        cnt_dt = np.dtype("<" + cnt_t)
        n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt, 1)[0])
        f.read(np.dtype("<" + idx_t).itemsize * n)
    else:
        f.read(np.dtype("<" + pdef).itemsize)


def _skip_element(f, count, props, binary):
    if binary:
        for _ in range(count):
            for _n, pd in props:
                _skip_prop(f, pd)
    else:
        for _ in range(count):
            f.readline()


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY with optional uint8 vertex colors."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    if colors is not None and np.asarray(colors).size == 0:
        colors = None
    V, F = len(verts), len(faces)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {F}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(verts.astype("<f4").tobytes())
        else:
            c8 = np.clip(np.asarray(colors, np.float64)
                         * (255.0 if np.asarray(colors).max() <= 1.0 + 1e-6
                            else 1.0), 0, 255).astype(np.uint8)
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                           ("r", "u1"), ("g", "u1"), ("b", "u1")])
            rec = np.empty(V, dt)
            rec["x"], rec["y"], rec["z"] = verts.T
            rec["r"], rec["g"], rec["b"] = c8.T
            f.write(rec.tobytes())
        fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
        frec = np.empty(F, fdt)
        frec["n"] = 3
        frec["i"] = faces
        f.write(frec.tobytes())
