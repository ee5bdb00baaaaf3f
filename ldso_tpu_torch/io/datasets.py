"""Dataset readers: TUM monoVO (zip or folder), KITTI odometry, EuRoC.

Counterpart of ldso_tpu/io/datasets.py (examples/DatasetReader.h). The
host decodes the raw 8/16-bit frame and only that crosses to the device,
where `rectify` (one K2 launch on the card) applies the photometric
calibration and the rectification remap. `.png` frames go through the port's own decoder
(io/png.py) on every machine; `.jpg` frames need PIL, and without it the
reader raises.
"""

from __future__ import annotations

import io as _io
import os
import re
import zipfile
from typing import List, Optional

import numpy as np
import torch

from ldso_tpu_torch.camera.undistort import Undistorter
from ldso_tpu_torch.io.png import decode_png
from ldso_tpu_torch.ops.perturb import benchmark_perturb, perturb_fields
from ldso_tpu_torch.ops.preprocess import rectify
from ldso_tpu_torch.utils.device import DEFAULT_DEVICE, entry_device


def _decode_image(data: bytes, name: str) -> np.ndarray:
    if name.lower().endswith(".png"):
        return decode_png(data)
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{name}: decoding JPEG needs PIL, which this Python does not "
            f"have; convert the frames to PNG") from None
    img = Image.open(_io.BytesIO(data))
    if img.mode not in ("L", "I;16"):
        img = img.convert("L")
    return np.asarray(img)


def _read_image_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _decode_image(f.read(), path)


class ImageFolderReader:
    """TUM monoVO / KITTI / EuRoC reader (DatasetReader.h:78-416).

    dataset_type: 'tum' | 'kitti' | 'euroc'. Frames come out of
    `get_image` on `device` (the card by default)."""

    def __init__(self, path: str, calib_file: str,
                 gamma_file: Optional[str] = None,
                 vignette_file: Optional[str] = None,
                 dataset_type: str = "tum", device=DEFAULT_DEVICE):
        self.device = entry_device(device)
        self.path = path
        self.dataset_type = dataset_type
        self.is_zipped = path.endswith(".zip")
        self.zip = None
        self.files: List[str] = []
        self.timestamps: List[float] = []
        self.exposures: List[float] = []

        if self.is_zipped:
            self.zip = zipfile.ZipFile(path)
            names = [n for n in self.zip.namelist()
                     if n.lower().endswith((".png", ".jpg"))]
            self.files = sorted(names)
        elif dataset_type == "kitti":
            self._load_kitti()
        elif dataset_type == "euroc":
            self._load_euroc()
        else:
            self.files = sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.lower().endswith((".png", ".jpg")))

        if dataset_type == "tum":
            self._load_tum_times()

        vig = None
        if vignette_file and os.path.exists(vignette_file):
            vig = _read_image_file(vignette_file)
        self.undistorter = Undistorter.from_file(calib_file, gamma_file, vig)
        # benchmark fault-injection knobs (benchmark_varNoise /
        # benchmark_varBlurNoise / benchmark_noiseGridsize, Setting.cc:95-101;
        # applied where the reference does, inside the undistortion stage,
        # Undistort.cc:372-470). CLI: noise= / blur=.
        self.var_noise = 0.0
        self.var_blur = 0.0
        self.noise_grid_size = 3
        self._tables = None

    # ------------------------------------------------------------- loaders
    def _load_kitti(self):
        """times.txt + image_0/%06d.png (DatasetReader.h:285-320)."""
        with open(os.path.join(self.path, "times.txt")) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.timestamps.append(float(line))
        for i in range(len(self.timestamps)):
            self.files.append(os.path.join(self.path, "image_0", f"{i:06d}.png"))

    def _load_euroc(self):
        """cam0 data.csv: '<ns>,<filename>' (DatasetReader.h:254-283)."""
        with open(os.path.join(self.path, "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.strip().split(",")
                if len(parts) >= 2 and parts[0]:
                    self.timestamps.append(float(parts[0]) * 1e-9)
                    self.files.append(os.path.join(self.path, "data",
                                                   parts[1].strip()))

    def _load_tum_times(self):
        """times.txt: 'id stamp [exposure]' with zero-exposure repair
        (DatasetReader.h:322-393)."""
        base = self.path[:-4] if self.is_zipped else self.path
        candidates = [os.path.join(os.path.dirname(base), "times.txt"),
                      os.path.join(base, "times.txt"),
                      re.sub(r"images.*$", "times.txt", base)]
        times_file = next((c for c in candidates if os.path.exists(c)), None)
        if times_file is None:
            return
        stamps, expos = [], []
        with open(times_file) as f:
            for line in f:
                t = line.split()
                if len(t) >= 3:
                    stamps.append(float(t[1]))
                    expos.append(float(t[2]))
                elif len(t) == 2:
                    stamps.append(float(t[1]))
                    expos.append(0.0)
        expos = np.asarray(expos, np.float32)
        good = len(expos) == self.num_images()
        for i in range(len(expos)):
            if expos[i] == 0:
                nb = [expos[j] for j in (i - 1, i + 1)
                      if 0 <= j < len(expos) and expos[j] > 0]
                if nb:
                    expos[i] = float(np.mean(nb))
            if expos[i] == 0:
                good = False
        if len(stamps) != self.num_images():
            stamps, expos, good = [], [], False
        self.timestamps = list(stamps)
        self.exposures = list(expos) if good else []

    # ------------------------------------------------------------- access
    def num_images(self) -> int:
        return len(self.files)

    def get_raw(self, idx: int) -> np.ndarray:
        if self.is_zipped:
            name = self.files[idx]
            return _decode_image(self.zip.read(name), name)
        return _read_image_file(self.files[idx])

    def _device_tables(self):
        """The response LUT, inverse vignette and remap on the device
        (uploaded once)."""
        if self._tables is None:
            u, dev = self.undistorter, self.device
            pc = u.photometric
            G = (torch.as_tensor(pc.G, device=dev)
                 if pc is not None and pc.valid else None)
            vig = (torch.as_tensor(pc.vignette_inv, device=dev)
                   if pc is not None and pc.vignette_inv is not None else None)
            self._tables = (G, vig, torch.as_tensor(u.remap_x, device=dev),
                            torch.as_tensor(u.remap_y, device=dev))
        return self._tables

    def get_image(self, idx: int):
        """(rectified photometric-linear image, exposure, timestamp), the
        reference's ImageAndExposure (DatasetReader.h:193). The image is a
        float32 tensor on the reader's device: only the raw frame crosses
        from the host, and FullSystem.add_active_frame takes the tensor as
        it is."""
        raw = torch.from_numpy(np.require(self.get_raw(idx),
                                          requirements=("C", "W")))
        if raw.dtype == torch.uint16:       # no uint16 indexing on the card
            raw = raw.to(torch.int32)
        G, vig, rx, ry = self._device_tables()
        img = rectify(raw.to(self.device), G, vig, rx, ry)
        if self.var_noise > 0.0 or self.var_blur > 0.0:
            fields = perturb_fields(idx, self.noise_grid_size, self.device)
            img = benchmark_perturb(img, fields, self.var_noise,
                                    self.var_blur, self.noise_grid_size)
        expo = self.exposures[idx] if self.exposures else 1.0
        ts = self.timestamps[idx] if self.timestamps else 0.0
        return img, float(expo), float(ts)

    def get_photometric_gamma(self) -> Optional[np.ndarray]:
        pc = self.undistorter.photometric
        if pc is None or not pc.valid:
            return None
        return pc.G

    def calibration(self):
        return self.undistorter.calibration()
