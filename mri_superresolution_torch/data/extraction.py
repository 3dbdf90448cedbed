"""Paired HR/LR slice extraction from NIfTI volumes, on the card.

The port's own copy of the JAX package's ``data/extraction.py``, the
reference's behaviour (utils/extraction_utils.py:74-164 and
scripts/extract_paired_slices.py):
- pick ``n_slices`` linspaced z-indices within [lower%, upper%] of the
  volume,
- HR: percentile window (0.5/99.5) -> min-max to [0, 1] -> LANCZOS
  letterbox to ``target_size`` -> uint8 PNG,
- LR: robust normalize -> k-space low-field simulation -> clip [0, 1] ->
  AREA letterbox to ``target_size / 2`` -> uint8 PNG under the same file
  name, so that pairs match by name.

Where JAX runs a volume's slices through one jitted batched pipeline, the
port runs them as one batch of torch ops on the slices' device (the card
unless the caller asks for the CPU): percentiles by sort, one batched
``torch.fft.fft2``, the resizes as fp32 matrix products. The slices are
picked and cast to fp32 on the host before the upload (a volume never
crosses as float64), and the uint8 rounding and PNG encoding stay on the
host (``native.imwrite_gray``), the same numpy expression for either
device's output.

The simulation's noise is drawn from a ``torch.Generator`` on the device,
seeded per volume and timepoint (``ops/kspace.draw_kspace_noise``): the
draws are distributed as JAX's, not the same bits.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mri_superresolution_torch import native, nifti
from mri_superresolution_torch.ops.kspace import (draw_kspace_noise,
                                                  simulate_low_field_mri)
from mri_superresolution_torch.ops.normalize import (minmax_normalize,
                                                     percentile_window,
                                                     robust_normalize)
from mri_superresolution_torch.ops.resize import Interp, letterbox_resize
from mri_superresolution_torch.utils.device import resolve_device

_MODALITIES = ("T1w", "T2w", "FLAIR", "BOLD", "PD", "PDw", "DWI")
STAGES = ("read", "select_upload", "hr_pipeline", "lr_pipeline", "fetch",
          "png_write")


class StageTimes:
    """Wall milliseconds of extraction by stage (``STAGES``), summed over
    the volumes of a run, and the slices extracted. With ``sync`` each
    stage on the card ends in a synchronize, so that its device work
    counts in it; without, the card synchronizes only at the fetch, and
    the device stages hold only their launches (their device work counts
    in the fetch)."""

    def __init__(self, sync: bool = False):
        self.ms: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        self.slices = 0
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        t0 = time.perf_counter()
        yield
        if self.sync and device.type == "cuda":
            torch.cuda.synchronize(device)
        self.ms[name] += (time.perf_counter() - t0) * 1e3


def generate_bids_identifier(nifti_file: str) -> str:
    """BIDS-entity identifier from a NIfTI filename
    (utils/extraction_utils.py:9-53)."""
    basename = os.path.basename(nifti_file)
    if basename.endswith(".nii.gz"):
        basename = basename[:-7]
    elif basename.endswith(".nii"):
        basename = basename[:-4]

    bids_entities = re.findall(r"([a-zA-Z0-9]+)-([a-zA-Z0-9]+)", basename)
    if bids_entities:
        base_id = "_".join(f"{k}-{v}" for k, v in bids_entities)
        modality_match = re.search(r"_([A-Za-z0-9]+)$", basename)
        if modality_match and modality_match.group(1) in _MODALITIES:
            base_id += f"_{modality_match.group(1)}"
        return base_id
    return basename


def generate_filename(subject: str, slice_idx: int,
                      timepoint: Optional[int] = None) -> str:
    """``Subject[_T{t}]_s{idx:03d}.png``, the same for HR and LR so that
    pairs match by name (utils/extraction_utils.py:55-72)."""
    if timepoint is not None:
        return f"{subject}_T{timepoint}_s{slice_idx:03d}.png"
    return f"{subject}_s{slice_idx:03d}.png"


def select_slice_indices(num_slices: int, lower_percent: float,
                         upper_percent: float, n_slices: int) -> np.ndarray:
    """Linspaced z-indices (utils/extraction_utils.py:112-115), clamped into
    the volume: ``upper_percent`` 1.0 puts the last one past the end, where
    the reference crashes."""
    lower_index = int(lower_percent * num_slices)
    upper_index = int(upper_percent * num_slices)
    idx = np.linspace(lower_index, upper_index, n_slices, dtype=int)
    return np.clip(idx, 0, num_slices - 1)


def sub_seed(seed: int, index: int) -> int:
    """An independent 63-bit seed for item ``index`` (a file of a run, a
    timepoint of a volume) of a run seeded ``seed``."""
    state = np.random.SeedSequence([seed % 2 ** 63, index]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def pick_slices(data: np.ndarray, n_slices: int, lower_percent: float,
                upper_percent: float,
                hdr: Optional[nifti.NiftiHeader] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The z-indices to extract from an (H, W, D) volume and their slices
    as one (n, H, W) fp32 host stack. ``data`` is the volume's values, or
    its stored voxels when ``hdr`` is given: then only the picked slices
    are scaled (``nifti.apply_scaling``), never the whole volume."""
    indices = select_slice_indices(data.shape[2], lower_percent,
                                   upper_percent, n_slices)
    picked = data[:, :, indices]
    if hdr is not None:
        picked = nifti.apply_scaling(picked, hdr)
    return indices, np.ascontiguousarray(
        np.transpose(picked, (2, 0, 1))).astype(np.float32)


def hr_pipeline(slices: torch.Tensor,
                target_size: Tuple[int, int]) -> torch.Tensor:
    """Batched HR preprocessing of (N, H, W) slices: percentile window ->
    min-max -> LANCZOS letterbox to ``target_size`` (width, height)
    (utils/preprocessing.py:295-374)."""
    x = minmax_normalize(percentile_window(slices))
    return letterbox_resize(x, target_size, Interp.LANCZOS, 0.0)


def lr_pipeline(slices: torch.Tensor,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]],
                target_size: Tuple[int, int],
                kspace_crop_factor: float = 0.5,
                noise_std: float = 5.0) -> torch.Tensor:
    """Batched LR generation of (N, H, W) slices: robust normalize ->
    k-space simulation with the unscaled draws ``noise`` -> clip -> AREA
    letterbox to ``target_size / 2`` (utils/extraction_utils.py:136-157)."""
    x = robust_normalize(slices)
    x = simulate_low_field_mri(x, noise, kspace_crop_factor, noise_std)
    x = x.clamp(0.0, 1.0)
    lr_size = (target_size[0] // 2, target_size[1] // 2)
    return letterbox_resize(x, lr_size, Interp.AREA, 0.0)


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """float [0, 1] -> uint8, truncating like the reference's PNG save
    (utils/extraction_utils.py:131)."""
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def extract_slices_3d(data: np.ndarray, subject: str, hr_output_dir: str,
                      lr_output_dir: Optional[str] = None,
                      timepoint: Optional[int] = None,
                      n_slices: int = 10,
                      lower_percent: float = 0.2,
                      upper_percent: float = 0.8,
                      target_size: Tuple[int, int] = (256, 256),
                      apply_simulation: bool = True,
                      noise_std: float = 5.0,
                      kspace_crop_factor: float = 0.5,
                      seed: Optional[int] = None,
                      verbose: bool = True,
                      hdr: Optional[nifti.NiftiHeader] = None,
                      device=None,
                      times: Optional[StageTimes] = None) -> List[str]:
    """Extract paired slices from one 3D volume; returns the file names
    written. ``data`` and ``hdr`` are as :func:`pick_slices` takes them.
    ``seed`` seeds the simulation's generator on the device; None derives
    it from the subject and timepoint."""
    dev = resolve_device(device)
    times = times if times is not None else StageTimes()
    with times.stage("select_upload", dev):
        indices, stack = pick_slices(data, n_slices, lower_percent,
                                     upper_percent, hdr)
        x = torch.from_numpy(stack).to(dev)

    with times.stage("hr_pipeline", dev):
        hr = hr_pipeline(x, tuple(target_size))
    lr = None
    if lr_output_dir is not None and apply_simulation:
        with times.stage("lr_pipeline", dev):
            if seed is None:
                # as the JAX package derives its key, the same in every
                # process (Python's hash() is salted)
                seed = zlib.crc32(f"{subject}|{timepoint}".encode())
            noise = draw_kspace_noise(
                tuple(x.shape), torch.Generator(device=dev).manual_seed(seed))
            lr = lr_pipeline(x, noise, tuple(target_size),
                             kspace_crop_factor, noise_std)
    with times.stage("fetch", dev):
        hr = hr.cpu().numpy()
        lr = None if lr is None else lr.cpu().numpy()

    written = []
    with times.stage("png_write", torch.device("cpu")):
        for i, idx in enumerate(indices):
            filename = generate_filename(subject, int(idx), timepoint)
            hr_path = os.path.join(hr_output_dir, filename)
            native.imwrite_gray(hr_path, to_uint8(hr[i]))
            if verbose:
                print(f"Saved HR: {hr_path}")
            if lr is not None:
                lr_path = os.path.join(lr_output_dir, filename)
                native.imwrite_gray(lr_path, to_uint8(lr[i]))
                if verbose:
                    print(f"Saved LR: {lr_path} (Size: "
                          f"{(target_size[0] // 2, target_size[1] // 2)})")
            written.append(filename)
    times.slices += len(written)
    return written


def extract_from_nifti(nifti_file: str, hr_output_dir: str,
                       lr_output_dir: Optional[str],
                       seed: Optional[int] = None, device=None,
                       times: Optional[StageTimes] = None,
                       **kwargs) -> List[str]:
    """Read one NIfTI file and extract its pairs, from a 3D volume or from
    each timepoint of a 4D one (scripts/extract_paired_slices.py:59-95).
    A 4D volume seeds timepoint t with ``sub_seed(seed, t)``."""
    times = times if times is not None else StageTimes()
    with times.stage("read", torch.device("cpu")):
        data, hdr = nifti.load_stored(nifti_file)
    subject = generate_bids_identifier(nifti_file)
    common = dict(hdr=hdr, device=device, times=times, **kwargs)
    written: List[str] = []
    if data.ndim == 3:
        written += extract_slices_3d(data, subject, hr_output_dir,
                                     lr_output_dir, seed=seed, **common)
    elif data.ndim == 4:
        for t in range(data.shape[3]):
            written += extract_slices_3d(
                data[:, :, :, t], subject, hr_output_dir, lr_output_dir,
                timepoint=t, seed=None if seed is None else sub_seed(seed, t),
                **common)
    else:
        print(f"Unexpected data dimensionality for {nifti_file}: "
              f"{data.ndim}D")
    return written


def find_nifti_files(datasets_dir: str, anat_only: bool = True) -> List[str]:
    """Walk the dataset's set folders, descending only into ``anat/``
    directories (scripts/extract_paired_slices.py:148-158). A missing root
    gives [] like an empty one, so that the CLI prints its "No NIfTI files
    found" message.

    The folders are walked in sorted order, so the list, and with it each
    file's noise seed (``sub_seed(seed, index)``), is the same on every
    machine. The JAX package walks a set's subject folders in the order
    the filesystem lists them, which differs from one filesystem to
    another: there the same seed gives other pairs on another machine."""
    if not os.path.isdir(datasets_dir):
        return []
    found = []
    for set_name in sorted(os.listdir(datasets_dir)):
        set_path = os.path.join(datasets_dir, set_name)
        if not os.path.isdir(set_path):
            continue
        for root, dirs, files in os.walk(set_path):
            dirs.sort()
            if anat_only and os.path.basename(root).lower() != "anat":
                continue
            for file in sorted(files):
                if file.endswith(".nii") or file.endswith(".nii.gz"):
                    found.append(os.path.join(root, file))
    return found
