"""Host-side image augmentation (NumPy; no torchvision).

A copy of `occdepth_tpu/data/augment.py`: the same per-(epoch, index)
RandomState and the same draw order, so both packages augment a sample
alike.  Reference behaviours: ColorJitter(0.4, 0.4, 0.4) + random
horizontal flip with projection-coordinate bookkeeping
(kitti_dataset.py:101-121, 367-412), ImageNet normalization
(kitti_dataset.py:164-171).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0, 1] -> ImageNet-normalized float32."""
    return ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """Per-(epoch, sample) augmentation RNG.

    Derived from (seed, epoch, index) alone so the flip/jitter draws are
    identical no matter how dataloader workers schedule the samples —
    the reference gets worker-determinism from torch's worker_init_fn +
    per-worker torch RNG streams (data/utils/torch_util.py:5-15); a
    shared RandomState consumed by concurrent workers would be racy.
    """
    return np.random.RandomState(
        (seed + 100003 * (epoch + 1) + 15485863 * (index + 1)) % (2**31 - 1)
    )


def color_jitter(
    img: np.ndarray,
    rng: np.random.RandomState,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.4,
) -> np.ndarray:
    """Random brightness/contrast/saturation like torchvision ColorJitter.

    Applied in a random order with factors ~ U[max(0, 1-f), 1+f].
    """
    ops = []
    if brightness > 0:
        b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(("b", b))
    if contrast > 0:
        c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(("c", c))
    if saturation > 0:
        s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(("s", s))
    rng.shuffle(ops)
    out = img.astype(np.float32)
    for kind, f in ops:
        if kind == "b":
            out = out * f
        elif kind == "c":
            gray = 0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
            out = gray.mean() * (1 - f) + out * f
        else:
            gray = (
                0.299 * out[..., 0] + 0.587 * out[..., 1] + 0.114 * out[..., 2]
            )[..., None]
            out = gray * (1 - f) + out * f
        # PIL ImageEnhance saturates to uint8 range after EVERY op; a
        # single final clip diverges badly for saturated pixels (e.g.
        # brightness 1.4 then contrast 0.6 operating on the unclamped
        # value).  Clamp per op like the reference's PIL path.
        out = np.clip(out, 0.0, 1.0)
    return out


def gaussian_blur(img: np.ndarray, rng: np.random.RandomState,
                  kernel_size: int = 3, sigma=(0.1, 2.0)) -> np.ndarray:
    """GaussianBlur(kernel_size=3, sigma~U[0.1, 2]) on (H, W, C)."""
    s = rng.uniform(*sigma)
    half = kernel_size // 2
    xs = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / s) ** 2)
    k /= k.sum()
    pad = np.pad(img, ((half, half), (half, half), (0, 0)), mode="reflect")
    out = np.zeros_like(img)
    for i, kv in enumerate(k):  # separable 1D passes (k is tiny)
        out += kv * pad[i: i + img.shape[0], half: half + img.shape[1]]
    pad = np.pad(out, ((half, half), (half, half), (0, 0)), mode="reflect")
    out2 = np.zeros_like(img)
    for j, kv in enumerate(k):
        out2 += kv * pad[half: half + img.shape[0], j: j + img.shape[1]]
    return out2


def strong_img_aug(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """RandomGrayscale(p=0.1) + RandomErasing(scale 0.01-0.02, ratio 0.3-3)
    on a normalized (H, W, C) image (kitti_dataset.py:106-121)."""
    out = img
    if rng.rand() < 0.1:
        gray = (0.299 * out[..., 0] + 0.587 * out[..., 1]
                + 0.114 * out[..., 2])[..., None]
        out = np.repeat(gray, 3, axis=-1)
    # RandomErasing default p=0.5
    if rng.rand() < 0.5:
        H, W, _ = out.shape
        area = H * W
        for _ in range(10):
            target = rng.uniform(0.01, 0.02) * area
            ratio = np.exp(rng.uniform(np.log(0.3), np.log(3.0)))
            h = int(round(np.sqrt(target * ratio)))
            w = int(round(np.sqrt(target / ratio)))
            if h < H and w < W:
                top = rng.randint(0, H - h + 1)
                left = rng.randint(0, W - w + 1)
                out = out.copy()
                out[top: top + h, left: left + w] = 0.0
                break
    return out


def ida_matrix(crop: Tuple[int, int, int, int], flip: bool) -> np.ndarray:
    """Image-data-augmentation matrix fed to the frustum generator.

    Encodes crop translation and horizontal flip as a 4x4 affine on
    (u, v, ., 1) (kitti_dataset.py:20-37 img_transform).
    """
    rot = np.eye(2)
    tran = -np.array(crop[:2], np.float64)
    if flip:
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        b = np.array([crop[2] - crop[0], 0.0])
        rot = A @ rot
        tran = A @ tran + b
    ida = np.zeros((4, 4))
    ida[3, 3] = 1
    ida[2, 2] = 1
    ida[:2, :2] = rot
    ida[:2, 3] = tran
    return ida.astype(np.float32)


def flip_projected_pix(projected_pix: np.ndarray, img_W: int) -> np.ndarray:
    """Mirror precomputed pattern pixel x-coords after a horizontal flip
    (kitti_dataset.py:384-389)."""
    out = projected_pix.copy()
    out[..., 0] = img_W - 1 - out[..., 0]
    return out
