"""Dataset layer: rebuild of `src/dataset/` (HWC numpy, host-side).

Covers: BaseDataset (txt-split / jsonl-metadata manifests, tar archives,
EXR/png/npy/raw decoders, per-task GT loaders + validity masks, training
preprocess) and the 11 dataset adapters with their decode scales and
evaluation crops (reference files cited per class). Outputs are dicts of
numpy arrays in HWC layout, ready to collate and ship to device.

A copy of ``genpercept_tpu/data/datasets.py`` with two changes: jsonl
metadata is read with the standard library's json (not pandas), and the
bilinear resize of matting/dis labels is torch with cv2 INTER_LINEAR's
semantics (``ops/resize.py::resize_linear_halfpixel``). cv2 is imported
only to decode .exr files, as in the JAX module.
"""

from __future__ import annotations

import io
import json
import os
import os.path as osp
import tarfile
from enum import Enum
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")  # base_dataset.py:20

from genpercept_tpu_torch.data.transforms import DepthNormalizer
from genpercept_tpu_torch.ops.resize import resize_linear_halfpixel


class DatasetMode(Enum):
    RGB_ONLY = "rgb_only"
    EVAL = "evaluate"
    TRAIN = "train"


class PredNameMode(Enum):
    """Prediction filename conventions (base_dataset.py:43-49)."""

    id = 1        # pred_<id>
    rgb_id = 2    # pred_<id> from rgb_<id>
    i_d_rgb = 3   # <id>_pred from <id>_rgb
    rgb_i_d = 4   # pred_<i>_<d> from rgb_<i>_<d>


def get_pred_name(rgb_basename: str, name_mode: PredNameMode, suffix: str = ".png") -> str:
    if name_mode == PredNameMode.rgb_id:
        base = "pred_" + rgb_basename.split("_")[1]
    elif name_mode == PredNameMode.i_d_rgb:
        base = rgb_basename.replace("_rgb.", "_pred.")
    elif name_mode == PredNameMode.id:
        base = "pred_" + rgb_basename
    elif name_mode == PredNameMode.rgb_i_d:
        base = "pred_" + "_".join(rgb_basename.split("_")[1:])
    else:
        raise NotImplementedError(name_mode)
    return os.path.splitext(base)[0] + suffix


def _nearest_exact_np(x: np.ndarray, out_hw) -> np.ndarray:
    h, w = x.shape[:2]
    oh, ow = out_hw
    ys = np.clip(np.floor((np.arange(oh) + 0.5) * h / oh).astype(int), 0, h - 1)
    xs = np.clip(np.floor((np.arange(ow) + 0.5) * w / ow).astype(int), 0, w - 1)
    return x[ys][:, xs]


def _bilinear_np(x: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize(x, INTER_LINEAR) on float32: (H, W[, C]) -> (h, w[, C]),
    a single channel returned as (h, w), as cv2 returns it."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    out = resize_linear_halfpixel(x.reshape(x.shape[:2] + (-1,))[None], tuple(out_hw))[0]
    return (out[..., 0] if out.shape[-1] == 1 else out).numpy()


class BaseDataset:
    """Mirror of reference BaseDataset (base_dataset.py:58-528), HWC numpy.

    Output keys follow the reference: rgb_int, rgb_norm, depth_raw_linear /
    depth_raw_norm, depth_filled_*, normal_*, matting_*, dis_*, seg_*,
    valid_mask_raw[...], index, rgb_relative_path.
    """

    min_depth = 0.0
    max_depth = 1e8
    has_filled_depth = False
    name_mode = PredNameMode.id
    # Known camera geometry: (fx, fy, cx, cy) at NATIVE_HW. Emitted as a 3x3
    # K per TRAIN sample for the metric3d losses (VNL back-projects depth
    # with intrinsics; reference consumes batch['intrinsic'] at
    # genpercept_trainer.py:776-780 but no reference dataset ever emits it).
    INTRINSIC = None
    NATIVE_HW = None

    def __init__(
        self,
        mode: DatasetMode,
        filename_ls_path: str,
        dataset_dir: str,
        disp_name: str = "",
        depth_transform: Optional[DepthNormalizer] = None,
        augmentation_args=None,
        resize_to_hw=None,
        move_invalid_to_far_plane: bool = True,
        rng: Optional[np.random.Generator] = None,
        **kwargs,
    ):
        self.mode = mode
        self.filename_ls_path = filename_ls_path
        self.dataset_dir = dataset_dir
        self.disp_name = disp_name
        self.depth_transform = depth_transform
        self.augm_args = augmentation_args
        self.resize_to_hw = resize_to_hw
        self.move_invalid_to_far_plane = move_invalid_to_far_plane
        self.rng = rng or np.random.default_rng(0)
        self.is_exr_data = False

        assert os.path.exists(dataset_dir), f"Dataset does not exist at: {dataset_dir}"

        if filename_ls_path.endswith(".txt"):
            with open(filename_ls_path) as f:
                self.filenames = [s.split() for s in f.readlines() if s.strip()]
        elif osp.isdir(filename_ls_path):  # diffusers-style jsonl metadata dir
            self.filenames = []
            for fn in sorted(os.listdir(filename_ls_path)):
                if not fn.endswith(".jsonl"):
                    continue
                with open(osp.join(filename_ls_path, fn)) as f:
                    meta = [json.loads(line) for line in f if line.strip()]
                for row in meta:
                    def col(name):
                        return row[name] if isinstance(row.get(name), str) else None

                    depth = col("depth_conditioning_image")
                    self.filenames.append([
                        row["image"], depth, None,
                        col("normal_conditioning_image"),
                        col("matting_conditioning_image"),
                        col("dis_conditioning_image"),
                        col("seg_conditioning_image"),
                    ])
                    if depth is not None and str(depth).endswith(".exr"):
                        self.is_exr_data = True
        else:
            raise NotImplementedError(filename_ls_path)

        self.tar_obj = None
        self.is_tar = os.path.isfile(dataset_dir) and tarfile.is_tarfile(dataset_dir)

    # ------------------------------------------------------------- protocol

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        rasters, other = self._get_data_item(index)
        if self.mode == DatasetMode.TRAIN:
            rasters = self._training_preprocess(rasters)
        rasters.update(other)
        return rasters

    def skip(self, index) -> None:
        """Draw what __getitem__(index) draws from self.rng, and load
        nothing: a data-parallel rank passes over the samples of a global
        batch that the other ranks load, so that its own samples get the
        flips one process gives them."""
        if self.mode == DatasetMode.TRAIN and self.augm_args is not None:
            self.rng.random()

    # --------------------------------------------------------------- loading

    def _get_data_path(self, index):
        line = self.filenames[index]
        rgb = line[0]
        depth = filled = normal = matting = dis = seg = None
        if self.mode != DatasetMode.RGB_ONLY:
            if len(line) > 1:
                depth = line[1]
            if self.has_filled_depth and len(line) > 2:
                filled = line[2]
            if len(line) > 3:
                normal, matting, dis, seg = (line[3:7] + [None] * 4)[:4]
        return rgb, depth, filled, normal, matting, dis, seg

    def _get_data_item(self, index):
        rgb_p, depth_p, filled_p, normal_p, matting_p, dis_p, seg_p = (
            self._get_data_path(index)
        )
        rasters: Dict[str, np.ndarray] = {}
        rasters.update(self._load_rgb_data(rgb_p))
        hw = rasters["rgb_norm"].shape[:2]

        if self.mode != DatasetMode.RGB_ONLY:
            if depth_p is not None and depth_p != "None":
                rasters.update(self._load_depth_data(depth_p, filled_p, hw))
                rasters["valid_mask_raw"] = self._get_valid_mask(
                    rasters["depth_raw_linear"]
                )
                if self.has_filled_depth and "depth_filled_linear" in rasters:
                    rasters["valid_mask_filled"] = self._get_valid_mask(
                        rasters["depth_filled_linear"]
                    )
            if normal_p is not None:
                rasters["normal_raw_linear"] = self._load_gt_image(normal_p, hw, 0.0)
                rasters["valid_mask_raw_normal"] = (
                    rasters["normal_raw_linear"] != 0
                ).any(-1)
            if matting_p is not None:
                rasters["matting_raw_linear"] = self._load_gt_image(matting_p, hw, -1.0)
                rasters["valid_mask_raw_matting"] = (
                    rasters["matting_raw_linear"] != -1
                ).any(-1)
            if dis_p is not None:
                rasters["dis_raw_linear"] = self._load_gt_image(dis_p, hw, -1.0)
                rasters["valid_mask_raw_dis"] = (rasters["dis_raw_linear"] != -1).any(-1)
            if seg_p is not None:
                rasters["seg_raw_linear"] = self._load_gt_image(
                    seg_p, hw, -1.0, convert_rgb=True
                )
                rasters["valid_mask_raw_seg"] = (rasters["seg_raw_linear"] != -1).any(-1)

        if self.mode == DatasetMode.TRAIN:
            intrinsic = self._intrinsic_for(hw)
            if intrinsic is not None:
                rasters["intrinsic"] = intrinsic

        other = {"index": index, "rgb_relative_path": rgb_p}
        return rasters, other

    def _intrinsic_for(self, hw) -> Optional[np.ndarray]:
        """3x3 camera K at raster resolution `hw`, scaled from NATIVE_HW."""
        if self.INTRINSIC is None:
            return None
        fx, fy, cx, cy = self.INTRINSIC
        if self.NATIVE_HW is not None and tuple(hw) != tuple(self.NATIVE_HW):
            sy = hw[0] / self.NATIVE_HW[0]
            sx = hw[1] / self.NATIVE_HW[1]
            fx, cx, fy, cy = fx * sx, cx * sx, fy * sy, cy * sy
        return np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32
        )

    def _load_rgb_data(self, rgb_rel_path):
        rgb = self._read_image(rgb_rel_path)  # (H, W, 3) uint8
        return {
            "rgb_int": rgb.astype(np.int32),
            "rgb_norm": (rgb.astype(np.float32) / 255.0 * 2.0 - 1.0),
        }

    def _load_depth_data(self, depth_rel_path, filled_rel_path, hw):
        out = {}
        try:
            depth = np.squeeze(self._read_depth_file(depth_rel_path))
            out["depth_raw_linear"] = depth.astype(np.float32)
        except Exception:
            out["depth_raw_linear"] = np.full(hw, -1.0, np.float32)  # dummy raster
        if self.has_filled_depth and filled_rel_path is not None:
            filled = np.squeeze(self._read_depth_file(filled_rel_path))
            out["depth_filled_linear"] = filled.astype(np.float32)
        return out

    def _load_gt_image(self, rel_path, hw, dummy_value, convert_rgb=False):
        try:
            img = np.squeeze(self._read_image(rel_path, convert_rgb=convert_rgb))
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            return img.astype(np.float32)
        except Exception:
            return np.full(hw + (3,), dummy_value, np.float32)

    def _read_bytes(self, rel_path) -> bytes:
        if self.is_tar:
            if self.tar_obj is None:
                self.tar_obj = tarfile.open(self.dataset_dir)
            return self.tar_obj.extractfile("./" + rel_path).read()
        with open(os.path.join(self.dataset_dir, rel_path), "rb") as f:
            return f.read()

    def _read_image(self, rel_path, convert_rgb=False) -> np.ndarray:
        data = self._read_bytes(rel_path)
        if rel_path.endswith(".exr"):
            import cv2

            buf = np.frombuffer(data, np.uint8)
            image = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
            if image.ndim == 2:
                image = np.repeat(image[:, :, None], 3, axis=2)
            elif image.ndim == 3 and image.shape[2] < 10:
                image = image[..., :3][..., ::-1]  # BGR -> RGB
            else:
                raise ValueError(image.shape)
            return np.ascontiguousarray(image)
        from PIL import Image

        img = Image.open(io.BytesIO(data))
        if convert_rgb:
            img = img.convert("RGB")
        return np.asarray(img)

    def _read_depth_file(self, rel_path) -> np.ndarray:
        depth = self._read_image(rel_path)
        if depth.ndim == 3 and depth.shape[2] == 3:
            depth = depth[:, :, 0]
        return depth

    def _get_valid_mask(self, depth: np.ndarray) -> np.ndarray:
        return (depth > self.min_depth) & (depth < self.max_depth)

    # ------------------------------------------------------------ preprocess

    def _training_preprocess(self, rasters):
        if self.augm_args is not None:
            rasters = self._augment_data(rasters)

        if "depth_raw_linear" in rasters:
            rasters["depth_raw_norm"] = self.depth_transform(
                rasters["depth_raw_linear"], rasters["valid_mask_raw"]
            )
            del rasters["depth_raw_linear"]
        if self.has_filled_depth and "depth_filled_linear" in rasters:
            rasters["depth_filled_norm"] = self.depth_transform(
                rasters["depth_filled_linear"], rasters["valid_mask_filled"]
            )
            del rasters["depth_filled_linear"]

        if "normal_raw_linear" in rasters:
            n = rasters["normal_raw_linear"]
            if "valid_mask_raw" in rasters:
                n = np.where(rasters["valid_mask_raw"][..., None], n, 0.0)
            norm = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
            rasters["normal_raw_norm"] = (n / norm).astype(np.float32)
            del rasters["normal_raw_linear"]

        for key in ("matting", "dis", "seg"):
            k = f"{key}_raw_linear"
            if k in rasters:
                x = rasters[k]
                lo, hi = x.min(), x.max()
                x = (x - lo) / max(hi - lo, 1e-8)
                rasters[f"{key}_raw_norm"] = ((x - 0.5) * 2).astype(np.float32)
                del rasters[k]

        if self.move_invalid_to_far_plane and self.has_filled_depth and \
                "depth_filled_norm" in rasters:
            far = (
                self.depth_transform.norm_max
                if self.depth_transform.far_plane_at_max
                else self.depth_transform.norm_min
            )
            rasters["depth_filled_norm"] = np.where(
                rasters["valid_mask_filled"], rasters["depth_filled_norm"], far
            )

        if self.resize_to_hw is not None:
            src_hw = rasters["rgb_norm"].shape[:2]
            for k, v in rasters.items():
                if k == "intrinsic":  # scale K, don't raster-resize it
                    sy = self.resize_to_hw[0] / src_hw[0]
                    sx = self.resize_to_hw[1] / src_hw[1]
                    rasters[k] = v * np.array(
                        [[sx, 1, sx], [1, sy, sy], [1, 1, 1]], np.float32
                    )
                # bilinear for matting/dis, nearest-exact otherwise
                # (base_dataset.py:498-511)
                elif ("matting" in k or "dis" in k) and v.dtype != bool:
                    rasters[k] = _bilinear_np(v, self.resize_to_hw)
                else:
                    rasters[k] = _nearest_exact_np(v, self.resize_to_hw)
        return rasters

    def _augment_data(self, rasters):
        if self.rng.random() < getattr(self.augm_args, "lr_flip_p", 0.5):
            rasters = {
                k: np.ascontiguousarray(v[:, ::-1])
                if (v.ndim >= 2 and k != "intrinsic") else v
                for k, v in rasters.items()
            }
            if "normal_raw_linear" in rasters:
                rasters["normal_raw_linear"][..., 0] *= -1
            if "intrinsic" in rasters:  # mirrored principal point
                w = rasters["rgb_norm"].shape[1]
                k3 = rasters["intrinsic"].copy()
                k3[0, 2] = (w - 1) - k3[0, 2]
                rasters["intrinsic"] = k3
        return rasters

    def __del__(self):
        if getattr(self, "tar_obj", None) is not None:
            self.tar_obj.close()


# ------------------------------------------------------------------ adapters

class KITTIDataset(BaseDataset):
    """kitti_dataset.py:22-121: depth png/256, 352x1216 benchmark crop,
    garg/eigen eval masks."""

    min_depth = 1e-5
    max_depth = 80
    name_mode = PredNameMode.id
    KB_CROP = (352, 1216)
    # KITTI eigen-split camera (fx, fy, cx, cy) at the typical 375x1242
    # raster; KB_INTRINSIC is shifted for the 352x1216 benchmark crop
    # (top = 375-352 = 23, left = 13)
    INTRINSIC = (721.5377, 721.5377, 609.5593, 172.854)
    NATIVE_HW = (375, 1242)
    KB_INTRINSIC = (721.5377, 721.5377, 596.5593, 149.854)

    def _intrinsic_for(self, hw):
        if self.kitti_bm_crop:
            fx, fy, cx, cy = self.KB_INTRINSIC
            sy, sx = hw[0] / self.KB_CROP[0], hw[1] / self.KB_CROP[1]
            return np.array(
                [[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy], [0, 0, 1]],
                np.float32,
            )
        return super()._intrinsic_for(hw)

    def __init__(self, kitti_bm_crop=True, valid_mask_crop="garg", **kwargs):
        super().__init__(**kwargs)
        self.kitti_bm_crop = kitti_bm_crop
        assert valid_mask_crop in (None, "garg", "eigen")
        self.valid_mask_crop = valid_mask_crop
        self.filenames = [f for f in self.filenames if len(f) > 1 and f[1] != "None"]

    def _read_depth_file(self, rel_path):
        d = super()._read_depth_file(rel_path)
        return d if self.is_exr_data else d / 256.0

    @classmethod
    def kitti_benchmark_crop(cls, img):
        kh, kw = cls.KB_CROP
        h, w = img.shape[:2]
        top, left = int(h - kh), int((w - kw) / 2)
        return img[top : top + kh, left : left + kw]

    def _load_rgb_data(self, rgb_rel_path):
        out = super()._load_rgb_data(rgb_rel_path)
        if self.kitti_bm_crop:
            out = {k: self.kitti_benchmark_crop(v) for k, v in out.items()}
        return out

    def _load_depth_data(self, depth_rel_path, filled_rel_path, hw):
        out = super()._load_depth_data(depth_rel_path, filled_rel_path, hw)
        if self.kitti_bm_crop:
            out = {k: self.kitti_benchmark_crop(v) for k, v in out.items()}
        return out

    def _get_valid_mask(self, depth):
        valid = super()._get_valid_mask(depth)
        if self.valid_mask_crop is not None:
            h, w = valid.shape[-2:]
            ev = np.zeros_like(valid)
            if self.valid_mask_crop == "garg":
                ev[int(0.40810811 * h): int(0.99189189 * h),
                   int(0.03594771 * w): int(0.96405229 * w)] = True
            else:  # eigen
                ev[int(0.3324324 * h): int(0.91351351 * h),
                   int(0.0359477 * w): int(0.96405229 * w)] = True
            valid &= ev
        return valid


class VirtualKITTIDataset(KITTIDataset):
    """vkitti_dataset.py: depth png/100, cm -> m; KITTI crops reused."""

    min_depth = 1e-5
    max_depth = 80
    INTRINSIC = (725.0087, 725.0087, 620.5, 187.0)  # vKITTI2 camera
    NATIVE_HW = (375, 1242)
    KB_INTRINSIC = (725.0087, 725.0087, 607.5, 164.0)

    def _read_depth_file(self, rel_path):
        d = BaseDataset._read_depth_file(self, rel_path)
        return d if self.is_exr_data else d / 100.0


class NYUDataset(BaseDataset):
    """nyu_dataset.py:22-58: depth png/1000, eigen crop [45:471, 41:601],
    has filled depth."""

    min_depth = 1e-3
    max_depth = 10.0
    has_filled_depth = True
    name_mode = PredNameMode.rgb_id
    INTRINSIC = (518.8579, 519.46961, 325.58245, 253.73617)  # Kinect v1
    NATIVE_HW = (480, 640)

    def __init__(self, eigen_valid_mask=True, **kwargs):
        super().__init__(**kwargs)
        self.eigen_valid_mask = eigen_valid_mask

    def _read_depth_file(self, rel_path):
        d = super()._read_depth_file(rel_path)
        return d if self.is_exr_data else d / 1000.0

    def _get_valid_mask(self, depth):
        valid = super()._get_valid_mask(depth)
        if self.eigen_valid_mask:
            ev = np.zeros_like(valid)
            ev[45:471, 41:601] = True
            valid &= ev
        return valid


class HypersimDataset(BaseDataset):
    """hypersim_dataset.py: depth png/1000 (or exr), max depth 65."""

    min_depth = 1e-5
    max_depth = 65.0
    name_mode = PredNameMode.rgb_i_d
    INTRINSIC = (886.81, 886.81, 512.0, 384.0)  # Hypersim pinhole @1024x768
    NATIVE_HW = (768, 1024)

    def _read_depth_file(self, rel_path):
        d = super()._read_depth_file(rel_path)
        return d if self.is_exr_data else d / 1000.0


class TaskonomyDataset(HypersimDataset):
    """taskonomy_dataset.py: depth png/512."""

    def _read_depth_file(self, rel_path):
        d = BaseDataset._read_depth_file(self, rel_path)
        return d if self.is_exr_data else d / 512.0


class CityscapesDataset(HypersimDataset):
    """cityscapes_dataset.py: depth png/300, max 80."""

    max_depth = 80.0

    def _read_depth_file(self, rel_path):
        d = BaseDataset._read_depth_file(self, rel_path)
        return d if self.is_exr_data else d / 300.0


class ScanNetDataset(BaseDataset):
    """scannet_dataset.py: depth png/1000."""

    min_depth = 1e-3
    max_depth = 10.0
    name_mode = PredNameMode.id
    INTRINSIC = (577.87, 577.87, 319.5, 239.5)  # ScanNet color camera
    NATIVE_HW = (480, 640)

    def _read_depth_file(self, rel_path):
        d = super()._read_depth_file(rel_path)
        return d if self.is_exr_data else d / 1000.0


class ETH3DDataset(BaseDataset):
    """eth3d_dataset.py:25-59: raw float32 binary 4032x6048, inf -> 0."""

    min_depth = 1e-5
    max_depth = np.inf
    name_mode = PredNameMode.id
    HEIGHT, WIDTH = 4032, 6048

    def _read_depth_file(self, rel_path):
        depth = np.frombuffer(self._read_bytes(rel_path), np.float32).copy()
        depth[np.isinf(depth)] = 0.0
        return depth.reshape(self.HEIGHT, self.WIDTH)


class DIODEDataset(BaseDataset):
    """diode_dataset.py: .npy depth + explicit .npy mask files."""

    min_depth = 0.6
    max_depth = 350
    name_mode = PredNameMode.id

    def _read_npy_file(self, rel_path):
        return np.load(io.BytesIO(self._read_bytes(rel_path))).squeeze()

    def _read_depth_file(self, rel_path):
        return self._read_npy_file(rel_path)

    def _get_data_item(self, index):
        rgb_p, depth_p, mask_p = self.filenames[index][:3]
        rasters: Dict[str, np.ndarray] = {}
        rasters.update(self._load_rgb_data(rgb_p))
        if self.mode != DatasetMode.RGB_ONLY:
            hw = rasters["rgb_norm"].shape[:2]
            rasters.update(self._load_depth_data(depth_p, None, hw))
            mask = self._read_npy_file(mask_p).astype(bool)
            rasters["valid_mask_raw"] = mask
            rasters["valid_mask_filled"] = mask.copy()
        return rasters, {"index": index, "rgb_relative_path": rgb_p}


class P3M10KDataset(HypersimDataset):
    """p3m10k_dataset.py: plain image GT (matting)."""


class DIS5KDataset(HypersimDataset):
    """dis5k_dataset.py: plain image GT (dichotomous segmentation)."""


DATASET_REGISTRY = {
    "kitti": KITTIDataset,
    "vkitti": VirtualKITTIDataset,
    "nyu_v2": NYUDataset,
    "hypersim": HypersimDataset,
    "taskonomy": TaskonomyDataset,
    "cityscapes": CityscapesDataset,
    "scannet": ScanNetDataset,
    "eth3d": ETH3DDataset,
    "diode": DIODEDataset,
    "p3m10k": P3M10KDataset,
    "dis5k": DIS5KDataset,
}


def get_dataset(cfg_data_split, base_data_dir: str, mode: DatasetMode, **kwargs):
    """Registry dispatch (src/dataset/__init__.py:48-70); `name: mixed`
    recurses into the dataset list and returns a list of datasets."""

    def g(cfg, name, default=None):
        if hasattr(cfg, name):
            return getattr(cfg, name)
        return cfg.get(name, default) if hasattr(cfg, "get") else default

    name = g(cfg_data_split, "name")
    if name == "mixed":
        return [
            get_dataset(c, base_data_dir, mode, **kwargs)
            for c in g(cfg_data_split, "dataset_list")
        ]
    cls = DATASET_REGISTRY[name]
    extra = {
        k: g(cfg_data_split, k)
        for k in ("kitti_bm_crop", "valid_mask_crop", "eigen_valid_mask",
                  "resize_to_hw")
        if g(cfg_data_split, k) is not None
    }
    return cls(
        mode=mode,
        filename_ls_path=g(cfg_data_split, "filenames"),
        dataset_dir=os.path.join(base_data_dir, g(cfg_data_split, "dir", "")),
        disp_name=g(cfg_data_split, "name", ""),
        **extra,
        **kwargs,
    )
