"""Mesh vertex loading: PLY (ascii / binary) and OBJ, bounding-box corners, diameters.

A copy of the parts of ``casapose_tpu/data/mesh.py`` that the dataset uses.
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
