"""Result export: BOP-challenge CSV and per-object pose text files.

A copy of ``casapose_tpu/utils/io.py::write_poses``: ``bop_evaluation.csv``
with scene_id,im_id,obj_id,score,R,t,time rows, and per-object GT and
estimated pose dumps.
"""

import os
import re

import numpy as np


def write_poses(gt_poses, estimated_poses, names, image_id, path_out, time_needed=None):
    """Write poses for one image.

    Args:
      gt_poses: [oc, ic, 3, 4] ground-truth poses.
      estimated_poses: [oc, 3, 4].
      names: object names (obj_000001, ...).
      image_id: array/bytes/str identifier "scene_imgfolder_imgname".
      path_out: output directory (trailing slash optional).
    """
    gt_poses = np.asarray(gt_poses)[:, 0]  # squeeze instance axis
    estimated_poses = np.asarray(estimated_poses)
    raw_id = np.asarray(image_id).reshape(-1)[0]
    if isinstance(raw_id, bytes):
        raw_id = raw_id.decode("utf-8")
    m = re.findall(r"\d*\.*\d+", str(raw_id))
    scene_id = int(m[0])
    img_id = int(m[1])
    t_val = -1.0 if time_needed is None else float(time_needed)

    os.makedirs(path_out, exist_ok=True)
    path_out_fp = os.path.join(path_out, "all_poses/")
    path_out_filtered = os.path.join(path_out, "filtered_poses/")
    os.makedirs(path_out_fp, exist_ok=True)
    os.makedirs(path_out_filtered, exist_ok=True)

    def print_pose(path, pose):
        exists = os.path.isfile(path)
        with open(path, "a") as f:
            if not exists:
                f.write("#r11 r12 r13 r21 r22 r23 r31 r32 r33 tx ty tz\n")
            R = np.asarray(pose)[:, :3].reshape(-1)
            t = np.asarray(pose)[:, 3].reshape(-1)
            f.write(" ".join(map(str, R)) + " " + " ".join(map(str, t)) + "\n")

    def print_pose_bop(path, pose, obj_id):
        exists = os.path.isfile(path)
        confidence = 1.0 if abs(float(np.sum(pose))) > 0 else 0.0
        with open(path, "a") as f:
            if not exists:
                f.write("scene_id,im_id,obj_id,score,R,t,time\n")
            R = np.asarray(pose)[:, :3].reshape(-1)
            t = np.asarray(pose)[:, 3].reshape(-1)
            f.write(
                f"{scene_id},{img_id},{obj_id},{confidence},"
                + " ".join(map(str, R))
                + ","
                + " ".join(map(str, t))
                + f",{t_val}\n"
            )

    for idx, name in enumerate(names):
        obj_id = int(re.findall(r"\d*\.*\d+", name)[0])
        if abs(float(np.sum(gt_poses[idx]))) > 0.0001:
            print_pose_bop(os.path.join(path_out, "bop_evaluation.csv"), estimated_poses[idx], obj_id)
            print_pose(path_out_filtered + "poses_gt_" + name + ".txt", gt_poses[idx])
            print_pose(path_out_filtered + "poses_init_" + name + ".txt", estimated_poses[idx])
        else:
            print_pose(path_out_filtered + "poses_gt_" + name + ".txt", np.zeros([3, 4]))
            print_pose(path_out_filtered + "poses_init_" + name + ".txt", np.zeros([3, 4]))
        print_pose(path_out_fp + "poses_init_" + name + ".txt", estimated_poses[idx])
