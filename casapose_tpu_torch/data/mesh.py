"""Mesh loading: PLY (ascii / binary) and OBJ vertices and triangles, bounding-box corners, diameters.

A copy of ``casapose_tpu/data/mesh.py``: the vertex loaders the dataset uses,
and the triangle loaders of the dataset converter's "render" mask mode.
"""

import struct

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply_vertices(path):
    """Vertex positions [N, 3] float64 from an ascii or binary-LE PLY."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) or ('list', ...)])
        current = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                current = (tokens[1], int(tokens[2]), [])
                elements.append(current)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    current[2].append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    current[2].append((tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break

        for name, count, props in elements:
            if name != "vertex":
                # Only need vertices; everything after the vertex element is
                # ignored, so bail if vertex was already read.
                break
            prop_names = [p[-1] for p in props]
            ix = [prop_names.index(k) for k in ("x", "y", "z")]
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    vals = f.readline().split()
                    rows.append([float(vals[i]) for i in ix])
                return np.asarray(rows, np.float64)
            if fmt in ("binary_little_endian", "binary_big_endian"):
                endian = "<" if fmt == "binary_little_endian" else ">"
                if any(p[0] == "list" for p in props):
                    raise ValueError(f"{path}: list property in vertex element")
                fmt_str = endian + "".join(_PLY_TYPES[p[0]][0] for p in props)
                size = struct.calcsize(fmt_str)
                raw = f.read(size * count)
                arr = np.array(
                    [struct.unpack_from(fmt_str, raw, i * size) for i in range(count)], np.float64
                )
                return arr[:, ix]
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    raise ValueError(f"{path}: no vertex element found")


def load_obj_vertices(path):
    """Vertex positions [N, 3] from a Wavefront OBJ."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                rows.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(rows, np.float64)


def load_mesh_vertices(path):
    if str(path).lower().endswith(".obj"):
        return load_obj_vertices(path)
    return load_ply_vertices(path)


def bounding_box_corners(vertices):
    """The 8 axis-aligned bounding-box corners (trimesh corner ordering)."""
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    corners = []
    for x in (lo[0], hi[0]):
        for y in (lo[1], hi[1]):
            for z in (lo[2], hi[2]):
                corners.append([x, y, z])
    return np.asarray(corners, np.float64)


def mesh_diameter(vertices):
    """Max pairwise vertex distance, via the convex hull for large meshes.

    Same quantity as the reference's Gram-matrix computation
    (vectorfield_dataset.py:647-654) but O(hull^2) instead of O(N^2).
    """
    v = np.asarray(vertices, np.float64)
    if len(v) > 400:
        try:
            from scipy.spatial import ConvexHull

            v = v[ConvexHull(v).vertices]
        except Exception:
            pass
    G = v @ v.T
    d2 = np.diag(G)[:, None] + np.diag(G)[None, :] - 2 * G
    return float(np.sqrt(max(d2.max(), 0.0)))


def _triangulate_fan(indices):
    """[i0, i1, ..., ik] polygon -> fan triangles [[i0, i1, i2], [i0, i2, i3], ...]."""
    return [[indices[0], indices[j], indices[j + 1]] for j in range(1, len(indices) - 1)]


def load_ply_mesh(path):
    """(vertices [N, 3] float64, faces [M, 3] int32) from an ascii/binary PLY.

    Polygon faces are fan-triangulated. Needed only by the offline
    dataset-converter "render" mask mode (the reference loads meshes through
    trimesh for pyrender, util_scripts/dataset_converter.py:228-240)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []
        current = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                current = (tokens[1], int(tokens[2]), [])
                elements.append(current)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    current[2].append(("list", tokens[2], tokens[3], tokens[4]))
                else:
                    current[2].append((tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break

        endian = "<" if fmt != "binary_big_endian" else ">"
        vertices, faces = None, None
        for name, count, props in elements:
            is_vertex = name == "vertex"
            is_face = name == "face"
            if fmt == "ascii":
                if is_vertex:
                    prop_names = [p[-1] for p in props]
                    ix = [prop_names.index(k) for k in ("x", "y", "z")]
                    rows = []
                    for _ in range(count):
                        vals = f.readline().split()
                        rows.append([float(vals[i]) for i in ix])
                    vertices = np.asarray(rows, np.float64)
                elif is_face:
                    tris = []
                    for _ in range(count):
                        vals = [int(v) for v in f.readline().split()]
                        tris.extend(_triangulate_fan(vals[1 : 1 + vals[0]]))
                    faces = np.asarray(tris, np.int64)
                else:
                    for _ in range(count):  # skip unknown ascii element
                        f.readline()
            elif fmt in ("binary_little_endian", "binary_big_endian"):
                if any(p[0] == "list" for p in props) and not is_face:
                    if vertices is not None and faces is not None:
                        break
                    raise ValueError(f"{path}: list property in non-face element {name}")
                if is_face:
                    if len(props) != 1:
                        raise ValueError(f"{path}: unsupported extra face properties")
                    cnt_ch, cnt_sz = _PLY_TYPES[props[0][1]]
                    idx_ch, idx_sz = _PLY_TYPES[props[0][2]]
                    # Fast path: homogeneous triangle lists read in one shot
                    # (the overwhelmingly common case for BOP models).
                    stride = cnt_sz + 3 * idx_sz
                    raw = f.read(stride * count)
                    dt = np.dtype([("n", endian + cnt_ch), ("i", endian + idx_ch, (3,))])
                    rec = np.frombuffer(raw, dtype=dt, count=min(count, len(raw) // stride))
                    if len(rec) == count and np.all(rec["n"] == 3):
                        faces = rec["i"].astype(np.int64)
                    else:
                        # Mixed polygon sizes: sequential parse over the rest
                        # of the file (face must then be the last element).
                        buf, off, tris = raw + f.read(), 0, []
                        for _ in range(count):
                            n = struct.unpack_from(endian + cnt_ch, buf, off)[0]
                            off += cnt_sz
                            idxs = struct.unpack_from(endian + str(n) + idx_ch, buf, off)
                            off += n * idx_sz
                            tris.extend(_triangulate_fan(list(idxs)))
                        faces = np.asarray(tris, np.int64)
                else:
                    fmt_str = endian + "".join(_PLY_TYPES[p[0]][0] for p in props)
                    size = struct.calcsize(fmt_str)
                    raw = f.read(size * count)
                    if is_vertex:
                        # One vectorized frombuffer over the packed block
                        # (struct codes are valid numpy codes; BOP meshes run
                        # to 100k+ vertices, per-row unpacks cost seconds).
                        dt = np.dtype([(f"p{j}", endian + _PLY_TYPES[p[0]][0]) for j, p in enumerate(props)])
                        assert dt.itemsize == size
                        rec = np.frombuffer(raw, dtype=dt, count=count)
                        prop_names = [p[-1] for p in props]
                        vertices = np.stack(
                            [rec[f"p{prop_names.index(k)}"].astype(np.float64) for k in ("x", "y", "z")], axis=1
                        )
            else:
                raise ValueError(f"{path}: unsupported PLY format {fmt}")
        if vertices is None:
            raise ValueError(f"{path}: no vertex element found")
        if faces is None:
            faces = np.zeros((0, 3), np.int64)
        return vertices, faces


def load_obj_mesh(path):
    """(vertices, faces) from a Wavefront OBJ; polygons fan-triangulated."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idxs = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idxs.append(i - 1 if i > 0 else len(verts) + i)
                tris.extend(_triangulate_fan(idxs))
    return np.asarray(verts, np.float64), np.asarray(tris, np.int64)


def load_mesh(path):
    """(vertices [N, 3], faces [M, 3]) for PLY or OBJ."""
    if str(path).lower().endswith(".obj"):
        return load_obj_mesh(path)
    return load_ply_mesh(path)
