"""BOP -> NDDS dataset conversion (offline tooling, numpy and Pillow only).

A copy of ``util_scripts/dataset_converter.py`` that needs neither jax nor
the JAX package, so that it runs where the port runs. It writes the
NDDS-style trees ``VectorfieldDataset`` consumes from a BOP-format dataset:
per-image GT JSON (projected keypoints / cuboids, poses as xyzw quaternions,
pixel counts), ``_camera_settings.json`` / ``_object_settings.json`` per
scene, and integer segmentation masks, either merged from the BOP
``mask_visib`` images ("reuse" mode) or depth-rendered from the object
meshes ("render" mode, with the z-buffer rasterizer of ``data/raster.py``).

    python -m casapose_tpu_torch.dataset_converter BOP_ROOT OUT_ROOT [--mask reuse|render] [--copy_meshes 1]
        [--model_folder models] [--model_folder_out models] [--image_folder train_pbr] [--width 640 --height 480]
        [--filetype_in png] [--near 100 --far 2000]

    MeshCatalog         id -> keypoints/OBB/fixed-transform records,
                        usage counting, settings + mesh copying
    load_scene_tables   one merged per-image record table from the three
                        BOP jsons (scene_camera / scene_gt / scene_gt_info)
    convert_scene       image loop: copy rgb, write GT json + merged mask
    convert_dataset     walk every scene dir (any folder containing rgb/)
    generate_data       the settings-dict entry point of util_scripts/prepare_data.py
"""

import argparse
import dataclasses
import glob
import json
import os
import re
import sys
from shutil import copyfile
from typing import Dict, List

import numpy as np
from PIL import Image

from casapose_tpu_torch.data.mesh import load_mesh, load_mesh_vertices
from casapose_tpu_torch.data.raster import render_id_mask
from casapose_tpu_torch.pose.geometry import (
    create_transformation_matrix_np,
    get_horizontal_width_angle_np,
    matrix_to_quaternion_np,
    project_np,
)


@dataclasses.dataclass
class ConvertOptions:
    """Conversion knobs (the reference passes these as a settings dict)."""

    width: int = 640
    height: int = 480
    filetype_in: str = "png"
    mask: str = "reuse"  # "reuse" merges BOP mask_visib; "render" z-buffers the meshes
    copy_meshes: bool = False
    near: float = 100.0  # render-mode clip planes, mm (reference prepare_data.py:180-181)
    far: float = 2000.0

    @classmethod
    def from_settings(cls, settings: Dict) -> "ConvertOptions":
        return cls(**{f.name: settings[f.name] for f in dataclasses.fields(cls) if f.name in settings})


def _oriented_bbox_corners(vertices):
    """8 corners of the PCA-oriented bounding box (replaces trimesh's
    bounding_box_oriented; used only for visualization cuboids)."""
    v = np.asarray(vertices, np.float64)
    c = v.mean(axis=0)
    centered = v - c
    _, _, Vt = np.linalg.svd(centered, full_matrices=False)
    proj = centered @ Vt.T
    lo, hi = proj.min(axis=0), proj.max(axis=0)
    corners = [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    return np.asarray(corners) @ Vt + c


class MeshCatalog:
    """Object-model registry: per-id keypoints, oriented box, usage counts.

    Loads ``<id>.ply`` + ``<id>_keypoints.ply`` pairs from a BOP models
    folder, optionally copying them (plus models_info.json) into the
    per-object layout the NDDS loader expects
    (``<out>/<name>/<name>{,_keypoints}.ply``).
    """

    def __init__(self):
        self.entries: Dict[int, Dict] = {}
        # Every id with mesh geometry, keypoints or not: render-mode masks
        # must stamp ALL GT objects (the reference renders every scene_gt
        # record, ref dataset_converter.py:72-95), so distractors without
        # keypoint PLYs still occlude the objects of interest correctly.
        self.render_meshes: Dict[int, str] = {}
        self._render_cache: Dict[int, object] = {}

    @classmethod
    def from_bop_models(cls, path: str, out_path: str, copy_meshes: bool = False) -> "MeshCatalog":
        cat = cls()
        os.makedirs(out_path, exist_ok=True)
        info_file = os.path.join(path, "models_info.json")
        if not os.path.isfile(info_file):
            return cat
        kp_files = sorted(glob.glob(os.path.join(path, "*keypoints.ply")))
        mesh_files = [m for m in sorted(glob.glob(os.path.join(path, "*.ply"))) if m not in kp_files]
        if not mesh_files:
            mesh_files = sorted(glob.glob(os.path.join(path, "*.obj")))

        by_id = {}
        for f in kp_files:
            digits = re.findall(r"\d+", os.path.basename(f))
            if digits:
                by_id[int(digits[0])] = f
        for mesh_file in mesh_files:
            name = os.path.splitext(os.path.basename(mesh_file))[0]
            digits = re.findall(r"\d+", name)
            if digits:
                cat.render_meshes[int(digits[0])] = mesh_file
            if not digits or int(digits[0]) not in by_id:
                continue
            obj_id = int(digits[0])
            kp_file = by_id[obj_id]
            keypoints = load_mesh_vertices(kp_file)
            vertices = load_mesh_vertices(mesh_file)
            cat.entries[obj_id] = {
                "name": name,
                "id": obj_id,
                "keypoints": keypoints,
                "volume": _oriented_bbox_corners(vertices),
                "volume_size": (np.max(keypoints, 0) - np.min(keypoints, 0)).tolist(),
                "center": (np.max(keypoints, 0) + np.min(keypoints, 0)) / 2.0,
                "used": 0,
                "fixed_model_transform": np.eye(4),
                "mesh_file": mesh_file,
            }
            if copy_meshes:
                dst = os.path.join(out_path, name)
                os.makedirs(dst, exist_ok=True)
                copyfile(mesh_file, os.path.join(dst, name + ".ply"))
                copyfile(kp_file, os.path.join(dst, name + "_keypoints.ply"))
        if copy_meshes:
            copyfile(info_file, os.path.join(out_path, "models_info.json"))
        return cat

    def reset_usage(self):
        for e in self.entries.values():
            e["used"] = 0

    def render_mesh(self, obj_id):
        """(vertices, faces) for z-buffer mask rendering, loaded lazily."""
        if obj_id not in self._render_cache:
            self._render_cache[obj_id] = load_mesh(self.render_meshes[obj_id])
        return self._render_cache[obj_id]

    def write_object_settings(self, path: str):
        """NDDS ``_object_settings.json`` for the objects seen in a scene."""
        used = [e for e in self.entries.values() if e["used"] > 0]
        data = {
            "exported_object_classes": [e["name"] for e in used],
            "exported_objects": [
                {
                    "class": e["name"],
                    "segmentation_class_id": e["id"],
                    "segmentation_instance_id": 0,
                    "fixed_model_transform": np.asarray(e["fixed_model_transform"]).tolist(),
                    "cuboid_dimensions": list(e["volume_size"]),
                }
                for e in used
            ],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


def _intrinsics_from_bop(cam_K: List[float]) -> np.ndarray:
    K = np.eye(3)
    K[0, 0], K[1, 1] = cam_K[0], cam_K[4]
    K[0, 2], K[1, 2] = cam_K[2], cam_K[5]
    return K


def load_scene_tables(scene_dir: str) -> Dict[int, Dict]:
    """Merge scene_camera / scene_gt / scene_gt_info into one table.

    Returns {image_index: {"cam_mat": K, "objects": [record, ...]}} where a
    record carries id / R / t and, when gt_info is present, the bbox and
    pixel-count statistics.
    """

    def read(name):
        p = os.path.join(scene_dir, name)
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
        return {}

    cameras = read("scene_camera.json")
    gts = read("scene_gt.json")
    infos = read("scene_gt_info.json")

    table: Dict[int, Dict] = {}
    for key, cam in cameras.items():
        table[int(key)] = {"cam_mat": _intrinsics_from_bop(cam["cam_K"]), "objects": []}
    for key, objs in gts.items():
        rows = table.setdefault(int(key), {"cam_mat": None, "objects": []})["objects"]
        extra = infos.get(key, [{}] * len(objs))
        for obj, inf in zip(objs, extra):
            rec = {
                "id": obj["obj_id"],
                "t": obj["cam_t_m2c"],
                "R": np.asarray(obj["cam_R_m2c"], np.float64).reshape(3, 3),
            }
            if inf:
                rec["bb"] = inf["bbox_obj"]
                rec["bb_visib"] = inf["bbox_visib"]
                for k in ("px_count_all", "px_count_valid", "px_count_visib", "visib_fract"):
                    rec[k] = inf[k]
            rows.append(rec)
    return table


def write_camera_settings(path: str, K: np.ndarray, width: int, height: int, name: str = "Viewpoint"):
    """NDDS ``_camera_settings.json`` (the loader reads fx/fy/cx/cy)."""
    fx, fy = K[0, 0], K[1, 1]
    data = {
        "camera_settings": [
            {
                "name": name,
                "horizontal_fov": float(get_horizontal_width_angle_np(width, height, fx, fy)),
                "intrinsic_settings": {
                    "resX": width,
                    "resY": height,
                    "fx": float(fx),
                    "fy": float(fy),
                    "cx": float(K[0, 2]),
                    "cy": float(K[1, 2]),
                    "s": 0,
                },
                "captured_image_size": {"width": width, "height": height},
            }
        ]
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def _ndds_object_record(rec: Dict, mesh: Dict, K: np.ndarray) -> Dict:
    """One object's NDDS GT entry: pose + projected keypoints/cuboid."""
    pose = create_transformation_matrix_np(rec["R"], rec["t"])
    center_2d, center_3d = project_np(mesh["center"][None], K, pose[0:3])
    cuboid_2d, cuboid_3d = project_np(mesh["volume"], K, pose[0:3])
    kp_2d, kp_3d = project_np(mesh["keypoints"], K, pose[0:3])
    bb = rec.get("bb", [0, 0, 0, 0])
    out = {
        "class": mesh["name"],
        "instance_id": 0,
        "visibility": rec.get("visib_fract", 1),
        "location": list(rec["t"]),
        "quaternion_xyzw": matrix_to_quaternion_np(rec["R"]).tolist(),
        "pose_transform": np.transpose(pose).tolist(),
        "cuboid_centroid": center_3d[0].tolist(),
        "projected_cuboid_centroid": center_2d[0].tolist(),
        "bounding_box": {"top_left": [bb[0], bb[1]], "bottom_right": [bb[0] + bb[2], bb[1] + bb[3]]},
        "cuboid": cuboid_3d.tolist(),
        "projected_cuboid": cuboid_2d.tolist(),
        "keypoints_2d": kp_2d.tolist(),
        "keypoints_3d": kp_3d.tolist(),
    }
    for key in ("px_count_all", "px_count_valid", "px_count_visib"):
        if key in rec:
            out[key] = rec[key]
    if "bb_visib" in rec:
        bbv = rec["bb_visib"]
        out["bounding_box_visible"] = {
            "top_left": [bbv[0], bbv[1]],
            "bottom_right": [bbv[0] + bbv[2], bbv[1] + bbv[3]],
        }
    return out


def write_image_gt(path: str, records: List[Dict], catalog: MeshCatalog, K: np.ndarray):
    """Per-image NDDS JSON; counts catalog usage for _object_settings."""
    objects = []
    for rec in records:
        mesh = catalog.entries.get(rec["id"])
        if mesh is None:
            continue
        mesh["used"] += 1
        objects.append(_ndds_object_record(rec, mesh, K))
    data = {
        "camera_data": {
            "location_worldframe": [0.0, 0.0, 0.0],
            "quaternion_xyzw_worldframe": [0.0, 0.0, 0.0, 1.0],
        },
        "objects": objects,
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def merge_visib_masks(mask_dir: str, stem: str, records: List[Dict], width: int, height: int, out_path: str):
    """BOP per-object ``mask_visib`` PNGs -> one integer-id mask image."""
    merged = np.zeros([height, width], np.uint8)
    for idx, rec in enumerate(records):
        p = os.path.join(mask_dir, f"{stem}_{idx:06d}.png")
        arr = np.asarray(Image.open(p))
        merged[arr == 255] = rec["id"]
    Image.fromarray(merged).save(out_path)


def convert_scene(scene_dir: str, out_dir: str, catalog: MeshCatalog, opts: ConvertOptions):
    """Convert one BOP scene (a folder containing rgb/ + the GT jsons)."""
    rgb_in = os.path.join(scene_dir, "rgb")
    rgb_out = os.path.join(out_dir, "rgb")
    os.makedirs(rgb_out, exist_ok=True)
    catalog.reset_usage()
    table = load_scene_tables(scene_dir)
    if not table:
        return
    first_K = next(v["cam_mat"] for v in table.values() if v["cam_mat"] is not None)
    write_camera_settings(os.path.join(rgb_out, "_camera_settings.json"), first_K, opts.width, opts.height)

    ext = "." + opts.filetype_in
    for img_path in sorted(glob.glob(os.path.join(rgb_in, "[0-9]" * 6 + ext))):
        stem = os.path.splitext(os.path.basename(img_path))[0]
        idx = int(stem)
        if idx not in table:
            continue
        entry = table[idx]
        out_img = os.path.join(rgb_out, os.path.basename(img_path))
        if os.path.abspath(out_img) != os.path.abspath(img_path):
            copyfile(img_path, out_img)
        write_image_gt(os.path.join(rgb_out, stem + ".json"), entry["objects"], catalog, entry["cam_mat"])
        if opts.mask == "reuse":
            merge_visib_masks(
                os.path.join(scene_dir, "mask_visib"), stem, entry["objects"], opts.width, opts.height,
                os.path.join(rgb_out, stem + ".seg.png"),
            )
        elif opts.mask == "render":
            known = [rec for rec in entry["objects"] if rec["id"] in catalog.render_meshes]
            mask = render_id_mask(
                [catalog.render_mesh(rec["id"]) for rec in known],
                [(rec["R"], np.asarray(rec["t"], np.float64)) for rec in known],
                [rec["id"] for rec in known],
                entry["cam_mat"], opts.width, opts.height, opts.near, opts.far,
            )
            Image.fromarray(mask).save(os.path.join(rgb_out, stem + ".seg.png"))
    catalog.write_object_settings(os.path.join(rgb_out, "_object_settings.json"))


def iter_scene_dirs(root: str):
    """Yield every directory under ``root`` that contains an rgb/ folder."""
    for dirpath, dirnames, _ in os.walk(root):
        if "rgb" in dirnames:
            yield dirpath
            dirnames.remove("rgb")


def convert_dataset(images_root: str, images_out: str, catalog: MeshCatalog, opts: ConvertOptions):
    os.makedirs(images_out, exist_ok=True)
    for scene_dir in sorted(iter_scene_dirs(images_root)):
        rel = os.path.relpath(scene_dir, images_root)
        convert_scene(scene_dir, os.path.join(images_out, rel), catalog, opts)


def generate_data(dataset_path, dataset_path_out, settings, model_folder="models", model_folder_out="models",
                  image_folder="train_pbr"):
    """settings-dict entry point (kept for prepare_data.py compatibility)."""
    opts = ConvertOptions.from_settings(settings)
    catalog = MeshCatalog.from_bop_models(
        os.path.join(dataset_path, model_folder),
        os.path.join(dataset_path_out, model_folder_out),
        copy_meshes=opts.copy_meshes,
    )
    convert_dataset(
        os.path.join(dataset_path, image_folder), os.path.join(dataset_path_out, image_folder), catalog, opts
    )


def main(argv=None):
    """``python -m casapose_tpu_torch.dataset_converter``: :func:`generate_data` with the settings as flags."""
    defaults = ConvertOptions()
    parser = argparse.ArgumentParser(description="Convert a BOP dataset into the NDDS trees the loader reads.")
    parser.add_argument("dataset_path", help="BOP dataset root (holds the model and image folders)")
    parser.add_argument("dataset_path_out", help="output root")
    parser.add_argument("--model_folder", default="models")
    parser.add_argument("--model_folder_out", default="models")
    parser.add_argument("--image_folder", default="train_pbr")
    parser.add_argument("--width", type=int, default=defaults.width)
    parser.add_argument("--height", type=int, default=defaults.height)
    parser.add_argument("--filetype_in", default=defaults.filetype_in)
    parser.add_argument("--mask", choices=("reuse", "render"), default=defaults.mask,
                        help="reuse: merge the BOP mask_visib images; render: z-buffer the meshes")
    parser.add_argument("--copy_meshes", type=int, default=int(defaults.copy_meshes),
                        help="1: copy the meshes and models_info.json into the per-object layout the loader reads")
    parser.add_argument("--near", type=float, default=defaults.near, help="render mode's near clip plane, mm")
    parser.add_argument("--far", type=float, default=defaults.far, help="render mode's far clip plane, mm")
    args = parser.parse_args(argv)
    settings = {f.name: getattr(args, f.name) for f in dataclasses.fields(ConvertOptions)}
    settings["copy_meshes"] = bool(args.copy_meshes)
    generate_data(args.dataset_path, args.dataset_path_out, settings, model_folder=args.model_folder,
                  model_folder_out=args.model_folder_out, image_folder=args.image_folder)
    print(f"converted {os.path.join(args.dataset_path, args.image_folder)} -> "
          f"{os.path.join(args.dataset_path_out, args.image_folder)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
