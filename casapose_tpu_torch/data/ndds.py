"""NDDS-format dataset: folder scan, ground-truth parse and per-sample preprocessing.

A copy of ``casapose_tpu/data/ndds.py::VectorfieldDataset`` (the port imports
nothing of the JAX package): the same folder scan for ``*seg.png`` + sibling
image + JSON GT, the same ``_object_settings.json`` /
``_camera_settings.json`` / ``models_info.json`` and persisted train/val
splits, and the same batch schema. ``models_info.json`` is read as JSON.
Pixels are decoded by ``data/pipeline.py``.
"""

import glob
import json
import os
from itertools import compress

import numpy as np

from casapose_tpu_torch.data.mesh import bounding_box_corners, load_mesh_vertices, mesh_diameter
from casapose_tpu_torch.pose.geometry import (
    get_rotation_matrix_2D_np,
    quaternion_matrix_np,
    reproject_np,
    transform_points_np,
)


def _to_json(data):
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        raise TypeError(type(o))

    return json.dumps(data, indent=2, default=default)


def load_split(path, ratio):
    """Load or create the persisted per-folder train/val split vector."""
    file_path = path + "/_split_settings.json"
    if os.path.isfile(file_path):
        with open(file_path) as f:
            split_info = json.load(f)
        if split_info["split"][0]["ratio"] == ratio:
            return split_info["split"][0]["values"]
    return write_json_split(path, ratio)


def write_json_split(path, ratio):
    files = glob.glob(path + "/*seg.png")
    file_count = len(files)
    split = np.zeros([file_count], dtype=int)
    split[0 : int(file_count * ratio)] = 1
    np.random.shuffle(split)
    with open(path + "/_split_settings.json", "w") as outfile:
        outfile.write(_to_json({"split": [{"ratio": ratio, "values": split}]}))
    return split


class VectorfieldDataset:
    """NDDS dataset with the reference's constructor surface."""

    def __init__(
        self,
        root,
        path_meshes,
        no_points=9,
        color_input=False,
        normal=(0.5, 0.5),
        test=False,
        objectsofinterest=(),
        save=False,
        noise=2,
        data_size=None,
        random_translation=(25.0, 25.0),
        random_rotation=15.0,
        random_crop=True,
        contrast=0.2,
        brightness=0.2,
        hue=0.05,
        saturation=0.2,
        use_train_split=False,
        use_validation_split=False,
        train_validation_split=0.9,
        output_folder="",
        use_imgaug=False,
        visibility_filter=False,
        separated_vectorfields=False,
        wxyz_quaterion_input=False,
        path_filter_root=None,
        record_cache_dir=None,
    ):
        self.path_meshes = path_meshes
        self.no_points = no_points
        self.color_input = color_input
        self.normal = normal
        self.test = test
        self.objectsofinterest = list(objectsofinterest)
        self.save = save
        self.noise = noise
        self.data_size = data_size
        self.random_translation = random_translation
        self.random_rotation = random_rotation
        self.random_crop = random_crop
        self.contrast = contrast
        self.brightness = brightness
        self.hue = hue
        self.saturation = saturation
        self.use_train_split = use_train_split
        self.use_validation_split = use_validation_split
        self.train_validation_split = train_validation_split
        self.output_folder = output_folder
        self.use_imgaug = use_imgaug
        self.visibility_filter = visibility_filter
        self.separated_vectorfields = separated_vectorfields
        self.wxyz_quaterion_input = wxyz_quaterion_input
        # Pre-decoded frame cache of the JAX package; not ported (make_dataset raises if it is set).
        self.record_cache_dir = record_cache_dir

        self.meshes = self.load_meshes(path_meshes) if path_meshes else {}
        self.imgs = []
        self.class_labels = {}
        self.camera_data = {}
        self.fixed_transformations = {}
        self._gt_cache = {}

        if root:
            for name in sorted(os.listdir(str(root))):
                if path_filter_root is None or name in path_filter_root:
                    imgs, cls, fixed, cams = self.load_image_data(os.path.join(root, name))
                    self.imgs += imgs
                    self.class_labels.update(cls)
                    self.fixed_transformations.update(fixed)
                    self.camera_data.update(cams)

    # ------------------------------------------------------------------ scan

    def load_image_data(self, root):
        imgs = []
        class_labels = {}
        fixed_transformations = {}
        camera_data = {}

        def collect(path):
            files = sorted(glob.glob(path + "/*seg.png"))
            if files:
                if self.use_train_split or self.use_validation_split:
                    split = np.array(load_split(path, self.train_validation_split), dtype=bool)
                    keep = split if self.use_train_split else np.invert(split)
                    files = list(compress(files, keep.tolist()))
                if path not in class_labels:
                    class_labels[path], fixed_transformations[path] = self.load_json_classes(
                        path + "/_object_settings.json"
                    )
                if path not in camera_data:
                    camera_data[path] = self.load_json_camera(path + "/_camera_settings.json")
            for seg_path in files:
                for filetype in ("png", "bmp", "jpg"):
                    imgpath = seg_path.replace("seg.png", filetype)
                    if os.path.exists(imgpath):
                        break
                jsonpath = imgpath.rsplit(".", 1)[0] + ".json"
                if os.path.exists(imgpath) and os.path.exists(jsonpath):
                    name = os.path.basename(imgpath)
                    imgs.append((imgpath, name, jsonpath, seg_path, path))

        def explore(path):
            if not os.path.isdir(path):
                return
            folders = [os.path.join(path, o) for o in sorted(os.listdir(path)) if os.path.isdir(os.path.join(path, o))]
            if folders:
                for folder in folders:
                    explore(folder)
            else:
                collect(path)

        explore(root)
        return imgs, class_labels, fixed_transformations, camera_data

    def __len__(self):
        if self.data_size is not None:
            return int(self.data_size)
        return len(self.imgs)

    def __getitem__(self, index):
        path, name, txt, seg, path_raw = self.imgs[index]
        return {"path": path, "name": name, "txt": txt, "seg": seg, "path_raw": path_raw}

    # ----------------------------------------------------------------- loads

    def load_json_classes(self, path):
        with open(path) as f:
            data = json.load(f)
        classes = {}
        fixed = {}
        for info in data["exported_objects"]:
            classes[info["class"]] = info["segmentation_class_id"]
            fixed[info["class"]] = np.transpose(np.array(info["fixed_model_transform"], np.float32))
        return classes, fixed

    def load_json_camera(self, path):
        with open(path) as f:
            data = json.load(f)
        cam = data["camera_settings"][0]["intrinsic_settings"]
        K = np.zeros((3, 3))
        K[0, 0], K[1, 1] = cam["fx"], cam["fy"]
        K[0, 2], K[1, 2] = cam["cx"], cam["cy"]
        K[2, 2] = 1
        return K

    def load_meshes(self, path):
        meshes = {}
        info_file = os.path.join(path, "models_info.json")
        model_info = None
        if os.path.isfile(info_file):
            with open(info_file) as f:
                model_info = json.load(f)
        for name in sorted(os.listdir(path)):
            folder = os.path.join(path, name)
            if not os.path.isdir(folder):
                continue
            model_file = os.path.join(folder, name + ".obj")
            if not os.path.exists(model_file):
                model_file = os.path.join(folder, name + ".ply")
            kp_file = os.path.join(folder, name + "_keypoints.ply")
            if os.path.isfile(model_file) and os.path.isfile(kp_file):
                vertices = load_mesh_vertices(model_file)
                meshes[name] = {
                    "keypoints": load_mesh_vertices(kp_file),
                    "vertices": vertices,
                    "volume": bounding_box_corners(vertices),
                    "diameter": (
                        model_info[name]["diameter"] if model_info and name in model_info else mesh_diameter(vertices)
                    ),
                }
        return meshes

    def load_json_minimal(self, path):
        """Parse (and cache) one image's ground-truth JSON."""
        cached = self._gt_cache.get(path)
        if cached is not None:
            return cached
        with open(path) as f:
            data = json.load(f)
        keypoints2d = []
        poses_quaternions = []
        poses_loc = []
        px_count_all = []
        object_classes = {}
        obj_idx = 0
        for info in data["objects"]:
            if not self.visibility_filter or info["visibility"] > 0.10:
                object_classes.setdefault(info["class"], []).append(obj_idx)
                px_count_all.append(int(info.get("px_count_all", 0)))
                keypoints2d.append(np.asarray(info["keypoints_2d"], np.float64)[:, :2])
                poses_quaternions.append(np.asarray(info["quaternion_xyzw"], np.float32))
                poses_loc.append(np.asarray(info["location"], np.float32))
                obj_idx += 1
        out = {
            "keypoints2d": keypoints2d,
            "objectClasses": object_classes,
            "poses_quaternions": poses_quaternions,
            "poses_loc": poses_loc,
            "px_count_all": px_count_all,
        }
        self._gt_cache[path] = out
        return out

    # ---------------------------------------------------------- per-sample

    def preprocess_sample(self, index, imagesize, cropratio, max_instance_count, rng, img_size_orig):
        """Geometric GT preprocessing for one sample (no pixels touched).

        Mirrors ``apply_preprocessing`` (vectorfield_dataset.py:291-509):
        random crop window + rotation/translation offsets, keypoint
        transform into network space with the (y, x) axis flip, per-object /
        per-instance padding, label remap table.
        Returns a dict of numpy arrays (images are decoded separately).
        """
        path, name, txt, seg_path, path_raw = self.imgs[index]
        data = self.load_json_minimal(txt)

        p = os.path.normpath(path_raw.replace("\\", "/")).split(os.sep)
        image_id = p[-2] + "_" + p[-1] + "_" + os.path.splitext(name)[0]

        class_labels = self.class_labels[path_raw]
        camera_data = self.camera_data[path_raw]
        fixed_transformations = self.fixed_transformations[path_raw]

        width, height = img_size_orig
        crop_height = round(float(height) * cropratio)
        crop_width = crop_height * (float(imagesize[1]) / float(imagesize[0]))
        img_size_out = (int(crop_height), int(crop_width))  # (h, w)
        scale = imagesize[0] / img_size_out[0]
        px_count_all = [int(float(i) * scale + 0.5) for i in data["px_count_all"]]

        if self.random_crop:
            w_crop = int(rng.integers(0, width - img_size_out[1] + 1))
            h_crop = int(rng.integers(0, height - img_size_out[0] + 1))
        else:
            w_crop = int((width - img_size_out[1]) / 2)
            h_crop = int((height - img_size_out[0]) / 2)

        no_points = self.no_points
        O = len(self.objectsofinterest)
        I = max_instance_count
        keypoints2d = np.full((O, I, no_points, 2), -1000.0, np.float32)
        keypoints3d = np.zeros((O, I, no_points, 3), np.float32)
        cuboid3d = np.zeros((O, I, 8, 3), np.float32)
        transform_mats = np.zeros((O, I, 3, 4), np.float32)
        pixel_gt = np.zeros((O, I, 1), np.float32)
        diameters = np.full((O, I, 1), -1.0, np.float32)
        object_labels = [None] * O

        dx = round(float(rng.normal(0, 2)) * float(self.random_translation[0]))
        dy = round(float(rng.normal(0, 2)) * float(self.random_translation[1]))
        angle = round(float(rng.normal(0, 1)) * float(self.random_rotation))
        offsets = np.asarray(
            [h_crop, w_crop, img_size_out[0], img_size_out[1], dx, dy, angle, scale, width, height], np.float32
        )
        tm = np.float32([[1, 0, dx], [0, 1, dy]])
        rm = get_rotation_matrix_2D_np((width / 2, height / 2), angle)
        tm2 = np.float32([[1, 0, -dx], [0, 1, -dy]])
        rm2 = get_rotation_matrix_2D_np((width / 2, height / 2), -angle)
        affine_r = np.identity(3)
        affine_r[0:2] = rm2
        affine_t = np.identity(3)
        affine_t[0:2] = tm2
        affine = np.matmul(affine_r, affine_t).astype(np.float32)
        crop_offset = [w_crop, h_crop]

        for oi, objectofinterest in enumerate(self.objectsofinterest):
            kp3d_mesh = self.meshes[objectofinterest]["keypoints"]
            cuboid_mesh = self.meshes[objectofinterest]["volume"]
            if objectofinterest in fixed_transformations:
                tr_points = np.array(transform_points_np(kp3d_mesh, fixed_transformations[objectofinterest]))
                tr_cuboid = np.array(transform_points_np(cuboid_mesh, fixed_transformations[objectofinterest]))
            else:
                tr_points = np.array(kp3d_mesh)
                tr_cuboid = np.array(cuboid_mesh)
            keypoints3d[oi, :] = tr_points[0:no_points]
            cuboid3d[oi, :] = tr_cuboid

            for object_name, ids in data["objectClasses"].items():
                if objectofinterest in object_name:
                    object_labels[oi] = class_labels[objectofinterest]
                    for ii, object_id in enumerate(ids[:I]):
                        transform_mats[oi, ii] = quaternion_matrix_np(
                            data["poses_quaternions"][object_id],
                            data["poses_loc"][object_id],
                            wxyz_input=self.wxyz_quaterion_input,
                        )
                        kp2d = data["keypoints2d"][object_id][0:no_points]
                        keypoints2d[oi, ii] = (reproject_np(kp2d, tm, rm, crop_offset) * scale).astype(np.float32)
                        pixel_gt[oi, ii, 0] = px_count_all[object_id]
                        object_scale = np.linalg.norm(fixed_transformations[objectofinterest][:, 0])
                        diameters[oi, ii, 0] = self.meshes[objectofinterest]["diameter"] * object_scale
                    break

        keypoints2d = keypoints2d[..., ::-1].copy()  # (x, y) -> (y, x), ref quirk

        new_labels = np.zeros((O, 2), np.uint8)
        for oi, lab in enumerate(object_labels):
            if lab is not None:
                new_labels[oi] = [lab, oi + 1]

        return {
            "keypoints2d": keypoints2d.astype(np.float32),
            "keypoints3d": keypoints3d,
            "camera": camera_data.astype(np.float32),
            "diameters": diameters,
            "offsets": offsets,
            "affine": affine,
            "cuboid3d": cuboid3d,
            "poses_gt": transform_mats,
            "pixel_gt_count": pixel_gt,
            "image_id": image_id,
            "new_labels": new_labels,
        }

    # ----------------------------------------------------------- eval data

    def generate_object_vertex_array(self):
        """Padded per-object eval-mesh vertex arrays + counts (for ADD)."""
        O = len(self.objectsofinterest)
        vertex_count = np.zeros([O, 1], np.int32)
        for idx, name in enumerate(self.objectsofinterest):
            if name in self.meshes:
                vertex_count[idx, 0] = len(self.meshes[name]["vertices"])
        vertex_array = np.zeros([O, int(vertex_count.max(initial=1)), 3], np.float32)
        for idx, name in enumerate(self.objectsofinterest):
            if name not in self.meshes:
                continue
            for _, fixed in self.fixed_transformations.items():
                if name in fixed:
                    vertex_array[idx, : vertex_count[idx, 0]] = transform_points_np(
                        self.meshes[name]["vertices"], fixed[name]
                    )
                    break
        return vertex_array, vertex_count

    def generate_dataset(self, *args, **kwargs):
        """Build the host input pipeline; see pipeline.make_dataset."""
        from casapose_tpu_torch.data.pipeline import make_dataset

        return make_dataset(self, *args, **kwargs)
