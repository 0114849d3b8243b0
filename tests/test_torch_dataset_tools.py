"""The port's offline dataset tools against the JAX package's, on the CPU.

* ``python -m casapose_tpu_torch.dataset_converter`` against
  ``util_scripts/dataset_converter.py::generate_data`` on
  tests/test_dataset_converter.py's synthetic BOP scenes, in "reuse" mask
  mode (random meshes, meshes copied) and "render" mode (cube meshes and a
  distractor that occludes): every file of the two output trees is equal
  byte for byte (JSON trees, merged or rendered masks, copied images and
  meshes);
* ``data/raster.py`` and the mesh loaders of ``data/mesh.py`` against
  ``casapose_tpu.data.raster`` / ``.mesh`` on tests/test_raster.py's meshes
  and scenes: depth maps, id masks, vertices and faces equal bit for bit;
* ``python -m casapose_tpu_torch.convert_h5_weights`` against
  ``util_scripts/convert_h5_weights.py`` on one ``.h5`` written by the JAX
  package's ``export_keras_h5``: the same names and the same arrays bit for
  bit (the two archives list them in another order, and a zip stamps its
  time of writing).
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from tests.test_dataset_converter import H as BOP_H
from tests.test_dataset_converter import W as BOP_W
from tests.test_dataset_converter import _make_bop_dataset, _write_cube_ply
from tests.test_raster import H, K, W, _square

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("mode", ["reuse", "render"])
def test_converter_writes_the_jax_converters_trees(mode, tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "util_scripts"))
    try:
        from dataset_converter import generate_data
    finally:
        sys.path.remove(os.path.join(ROOT, "util_scripts"))

    src = str(tmp_path / "bop")
    os.makedirs(src)
    render = mode == "render"
    _make_bop_dataset(src, cube_models=render, distractor=render)
    flags = {"width": BOP_W, "height": BOP_H, "filetype_in": "png", "mask": mode, "copy_meshes": not render,
             "near": 100.0, "far": 2000.0}
    generate_data(src, str(tmp_path / "jax"), flags)
    cmd = [sys.executable, "-m", "casapose_tpu_torch.dataset_converter", src, str(tmp_path / "port"),
           "--mask", mode, "--copy_meshes", str(int(not render)), "--width", str(BOP_W), "--height", str(BOP_H)]
    proc = subprocess.run(cmd, cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port")
    assert sum(f.endswith(".seg.png") for f in files) == 2 and sum(f.endswith(".json") for f in files) >= 4
    assert any(f.startswith("models") for f in files) != render
    for f in files:
        with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f


def _mesh_files(tmp_path):
    """tests/test_raster.py's four mesh files (ascii PLY with a quad, binary PLY, binary mixed polygons, OBJ),
    and tests/test_dataset_converter.py's cube of quads."""
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
        "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n"
        "3 0 1 2\n4 0 1 2 3\n")
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex %d\nproperty float x\nproperty float y\nproperty float z\n"
              b"element face %d\nproperty list uchar int vertex_indices\nend_header\n")
    binary = tmp_path / "binary.ply"
    binary.write_bytes(header % (3, 1) + b"".join(struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (0, 1, 0)])
                       + struct.pack("<B3i", 3, 0, 1, 2))
    mixed = tmp_path / "mixed.ply"
    mixed.write_bytes(header % (4, 2) + b"".join(struct.pack("<3f", *v) for v in [(0, 0, 0), (1, 0, 0), (1, 1, 0),
                                                                                   (0, 1, 0)])
                      + struct.pack("<B3i", 3, 0, 1, 2) + struct.pack("<B4i", 4, 0, 1, 2, 3))
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1/1/1 2/2/2 3/3/3 4/4/4\n")
    cube = tmp_path / "cube.ply"
    _write_cube_ply(str(cube), 60.0)
    return [str(p) for p in (ascii_ply, binary, mixed, obj, cube)]


def test_mesh_loaders_equal_jax(tmp_path):
    from casapose_tpu.data import mesh as jax_mesh

    from casapose_tpu_torch.data import mesh

    for path in _mesh_files(tmp_path):
        for name in ("load_mesh", "load_mesh_vertices"):
            want, got = getattr(jax_mesh, name)(path), getattr(mesh, name)(path)
            for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
                assert g.dtype == w.dtype, (path, name)
                np.testing.assert_array_equal(g, w, err_msg=f"{path} {name}")


def _scenes(tmp_path):
    """(meshes, poses, ids) scenes of tests/test_raster.py: squares at two depths (occlusion), a slanted
    triangle, a triangle larger than the largest bbox group, the cube under a rotation, clipped by near / far."""
    from scipy.spatial.transform import Rotation

    from casapose_tpu_torch.data.mesh import load_mesh

    cube = load_mesh(_mesh_files(tmp_path)[-1])
    slanted = (np.array([[-40.0, -30, 400], [40, -30, 600], [0, 40, 500]]), np.array([[0, 1, 2]]))
    big = (np.array([[-900.0, -900, 500], [900, -900, 500], [0, 900, 500]]), np.array([[0, 1, 2]]))
    R = Rotation.from_rotvec([0.3, -0.5, 0.2]).as_matrix()
    eye, zero = np.eye(3), np.zeros(3)
    return [
        ([_square(40, 500), _square(20, 400, cx=5)], [(eye, zero)] * 2, [1, 2]),
        ([slanted, big], [(eye, zero)] * 2, [3, 4]),
        ([cube, cube], [(R, np.array([10.0, -5, 450])), (eye, np.array([-20.0, 10, 700]))], [1, 2]),
        ([cube], [(eye, np.array([0.0, 0, 120]))], [5]),  # partly before the near plane
    ]


def test_raster_equals_jax(tmp_path):
    from casapose_tpu.data import raster as jax_raster

    from casapose_tpu_torch.data import raster

    drawn = 0
    for meshes, poses, ids in _scenes(tmp_path):
        for near, far in ((100.0, 2000.0), (450.0, 650.0)):
            want = jax_raster.render_id_mask(meshes, poses, ids, K, W, H, near, far)
            got = raster.render_id_mask(meshes, poses, ids, K, W, H, near, far)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            drawn += int(len(np.unique(got)) > 1)
            for (verts, faces), (R, t) in zip(meshes, poses):
                want_d = jax_raster.render_depth(verts, faces, K, R, t, W, H, near, far)
                got_d = raster.render_depth(verts, faces, K, R, t, W, H, near, far)
                np.testing.assert_array_equal(got_d, want_d)
    assert drawn >= 5  # of the 8 (scene, clip planes) pairs, the others clipped away


def test_h5_conversion_equals_the_jax_cli(tmp_path):
    import jax

    from casapose_tpu.core.checkpoint import export_keras_h5
    from casapose_tpu.models.registry import get_model as jax_get_model

    objects, k = 2, 3
    jm = jax_get_model("casapose_c_gcu5", ver_dim=3 * k, seg_dim=1 + objects)
    variables = jax.jit(lambda x: jm.init(jax.random.PRNGKey(3), x, train=False))(np.zeros((1, 32, 32, 3), np.float32))
    h5 = str(tmp_path / "w.h5")
    export_keras_h5(h5, dict(variables), model=jm)
    common = ["--objects", str(objects), "--no_points", str(k), "--height", "32", "--width", "32"]
    runs = {
        "jax": [sys.executable, os.path.join(ROOT, "util_scripts", "convert_h5_weights.py"), h5,
                str(tmp_path / "jax.npz"), *common],
        "port": [sys.executable, "-m", "casapose_tpu_torch.convert_h5_weights", h5, str(tmp_path / "port.npz"),
                 *common, "--device", "cpu"],
    }
    for name, cmd in runs.items():
        proc = subprocess.run(cmd, cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, (name, proc.stderr[-3000:])
        assert "0 h5 datasets had no matching parameter" in proc.stdout, (name, proc.stdout[-2000:])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files) and len(want.files) > 100
    for key in want.files:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_h5_cli_says_it_needs_h5py():
    proc = subprocess.run([sys.executable, "-m", "casapose_tpu_torch.convert_h5_weights", "--help"], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "h5py" in proc.stdout
