"""CPU-side image and depth augmentation (the port's own copy of
cspn_monodepth_tpu/data/transforms.py; the port imports nothing of the JAX
package).

Rotation, scale, crop and flip are all affine maps, so they compose into
ONE inverse-affine resample per record: the reference's augmentation
distribution (rotate +-deg, scale s in [1, s_max] with depth /= s, hflip
p=0.5, color jitter, center or bottom crop) in a single resampling step.

Two interchangeable executors, bit for bit the JAX package's:
  * `affine_resample`, pure numpy (where no compiler is found, and the
    parity oracle);
  * the C++ kernel in `native/augment.cpp` via ctypes (the default when it
    builds; it releases the interpreter lock so worker threads scale).

Outputs are channels-last float32: rgb in [0, 1], depth in meters with
0 = invalid (rotation borders are 0 == invalid, as in the reference).
"""

from __future__ import annotations

import ctypes

import numpy as np

from cspn_monodepth_tpu_torch import native


def compose_affine(
    in_hw: tuple[int, int],
    resized_hw: tuple[int, int],
    out_hw: tuple[int, int],
    *,
    deg: float = 0.0,
    crop: str = "center",
    hflip: bool = False,
) -> np.ndarray:
    """Inverse-affine coefficients for: rotate(deg) about the input
    center -> resize to `resized_hw` -> crop `out_hw` -> optional hflip.

    Returns c (6,) float32 with source coords for output pixel (y, x):
        ys = c[0] + c[1]*y + c[2]*x
        xs = c[3] + c[4]*y + c[5]*x
    using the half-pixel-center resize convention and the (size-1)/2
    rotation center, identical to the staged numpy ops they replace.
    """
    in_h, in_w = in_hw
    rh, rw = resized_hw
    out_h, out_w = out_hw
    if crop == "bottom":
        i0, j0 = rh - out_h, (rw - out_w) // 2
    elif crop == "center":
        i0, j0 = (rh - out_h) // 2, (rw - out_w) // 2
    else:
        raise ValueError(f"unknown crop {crop!r}")

    # resize inverse map: resized (y_r, x_r) samples (y_r+0.5)*in/r - 0.5
    ky, kx = in_h / rh, in_w / rw
    by = (i0 + 0.5) * ky - 0.5
    bx = (j0 + 0.5) * kx - 0.5
    # hflip acts on the output x axis: x' = (out_w - 1) - x
    axx = -kx if hflip else kx
    if hflip:
        bx = bx + kx * (out_w - 1)

    # rotation inverse map about the input center
    th = np.deg2rad(deg)
    cy, cx = (in_h - 1) / 2.0, (in_w - 1) / 2.0
    cos, sin = np.cos(th), np.sin(th)
    # ys = cy + (ys1-cy)cos - (xs1-cx)sin ; xs = cx + (ys1-cy)sin + (xs1-cx)cos
    # with ys1 = ky*y + by, xs1 = axx*x + bx
    c = np.array([
        cy + (by - cy) * cos - (bx - cx) * sin,   # ys constant
        ky * cos,                                  # ys <- y
        -axx * sin,                                # ys <- x
        cx + (by - cy) * sin + (bx - cx) * cos,   # xs constant
        ky * sin,                                  # xs <- y
        axx * cos,                                 # xs <- x
    ], dtype=np.float32)
    return c


def affine_resample(
    img: np.ndarray,
    coef: np.ndarray,
    out_h: int,
    out_w: int,
    *,
    nearest: bool = False,
    gain: np.ndarray | None = None,
    scale: float = 1.0,
    clip: tuple[float, float] | None = None,
) -> np.ndarray:
    """Numpy reference for the native kernel: inverse-affine gather with
    out-of-bounds -> 0. Bilinear for (H, W, C) images (per-channel `gain`
    multiplier, optional `clip`), nearest for (H, W) planes (`scale`
    multiplier — the depth /= s of scale augmentation)."""
    h, w = img.shape[:2]
    ys = (coef[0] + coef[1] * np.arange(out_h, dtype=np.float32)[:, None]
          + coef[2] * np.arange(out_w, dtype=np.float32)[None, :])
    xs = (coef[3] + coef[4] * np.arange(out_h, dtype=np.float32)[:, None]
          + coef[5] * np.arange(out_w, dtype=np.float32)[None, :])
    inside = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    if nearest:
        yi = np.clip(np.rint(ys).astype(np.int64), 0, h - 1)
        xi = np.clip(np.rint(xs).astype(np.int64), 0, w - 1)
        out = img[yi, xi].astype(np.float32) * np.float32(scale)
        return np.where(inside, out, 0.0).astype(np.float32)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0, 1).astype(np.float32)[..., None]
    wx = np.clip(xs - x0, 0, 1).astype(np.float32)[..., None]
    imgf = np.asarray(img, np.float32)
    out = (imgf[y0, x0] * (1 - wy) * (1 - wx) + imgf[y0, x1] * (1 - wy) * wx
           + imgf[y1, x0] * wy * (1 - wx) + imgf[y1, x1] * wy * wx)
    if gain is not None:
        out = out * np.asarray(gain, np.float32).reshape(1, 1, -1)
    if clip is not None:
        out = np.clip(out, clip[0], clip[1])
    out = np.where(inside[..., None], out, 0.0).astype(np.float32)
    return out


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _native_rgb(lib, rgb: np.ndarray, coef: np.ndarray, out_h: int,
                out_w: int, gain: np.ndarray,
                clip: tuple[float, float] | None) -> np.ndarray:
    ch = rgb.shape[2]
    out = np.empty((out_h, out_w, ch), np.float32)
    gain = np.ascontiguousarray(gain, np.float32)
    coef = np.ascontiguousarray(coef, np.float32)
    lo, hi = clip if clip is not None else (0.0, -1.0)  # hi<=lo: no clip
    if rgb.dtype == np.uint8:
        src = np.ascontiguousarray(rgb)
        lib.affine_bilinear_u8(
            _ptr(src, ctypes.c_uint8), rgb.shape[0], rgb.shape[1], ch,
            _ptr(coef, ctypes.c_float), _ptr(out, ctypes.c_float),
            out_h, out_w, _ptr(gain, ctypes.c_float), lo, hi)
    else:
        src = np.ascontiguousarray(rgb, np.float32)
        lib.affine_bilinear_f32(
            _ptr(src, ctypes.c_float), rgb.shape[0], rgb.shape[1], ch,
            _ptr(coef, ctypes.c_float), _ptr(out, ctypes.c_float),
            out_h, out_w, _ptr(gain, ctypes.c_float), lo, hi)
    return out


def _native_depth(lib, depth: np.ndarray, coef: np.ndarray, out_h: int,
                  out_w: int, scale: float) -> np.ndarray:
    out = np.empty((out_h, out_w), np.float32)
    src = np.ascontiguousarray(depth, np.float32)
    coef = np.ascontiguousarray(coef, np.float32)
    lib.affine_nearest_f32(
        _ptr(src, ctypes.c_float), depth.shape[0], depth.shape[1],
        _ptr(coef, ctypes.c_float), _ptr(out, ctypes.c_float),
        out_h, out_w, ctypes.c_float(scale))
    return out


def resample_pair(
    rgb: np.ndarray,
    depth: np.ndarray,
    coef: np.ndarray,
    out_h: int,
    out_w: int,
    *,
    gain: np.ndarray,
    depth_scale: float = 1.0,
    clip: tuple[float, float] | None = (0.0, 1.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Resample an rgb/depth record through one affine — native kernel if
    available, numpy otherwise. `gain` must already fold in any
    uint8 -> [0, 1] normalization of the rgb source."""
    lib = native.lib()
    if lib is not None:
        return (_native_rgb(lib, rgb, coef, out_h, out_w, gain, clip),
                _native_depth(lib, depth, coef, out_h, out_w, depth_scale))
    return (affine_resample(rgb, coef, out_h, out_w, gain=gain, clip=clip),
            affine_resample(depth, coef, out_h, out_w, nearest=True,
                            scale=depth_scale))


def _rgb_gain(rgb: np.ndarray, jitter_gain: np.ndarray) -> np.ndarray:
    """Fold uint8 (or 0..255 float) normalization into the jitter gain so
    the resample pass emits [0, 1] floats directly."""
    if rgb.dtype == np.uint8 or float(rgb.max(initial=0.0)) > 1.5:
        return jitter_gain / 255.0
    return jitter_gain


def train_transform(
    rgb: np.ndarray,
    depth: np.ndarray,
    rng: np.random.Generator,
    *,
    out_h: int,
    out_w: int,
    rotate_deg: float = 5.0,
    scale_max: float = 1.5,
    hflip_prob: float = 0.5,
    jitter: float = 0.2,
    crop: str = "center",
) -> tuple[np.ndarray, np.ndarray]:
    """Reference train aug (SURVEY.md section 4.4): rotate, scale (with
    depth /= s), hflip, color jitter, crop — one fused affine resample.

    rgb: (H, W, 3) uint8 or float; depth: (H, W) float meters.
    Returns float32 (out_h, out_w, 3) in [0, 1] and (out_h, out_w).
    """
    s = float(rng.uniform(1.0, scale_max)) if scale_max > 1.0 else 1.0
    deg = float(rng.uniform(-rotate_deg, rotate_deg)) if rotate_deg > 0 else 0.0
    hflip = bool(rng.uniform() < hflip_prob) if hflip_prob > 0 else False
    if jitter > 0:
        jitter_gain = rng.uniform(1 - jitter, 1 + jitter, 3).astype(np.float32)
    else:
        jitter_gain = np.ones(3, np.float32)

    rh, rw = int(round(out_h * s)), int(round(out_w * s))
    coef = compose_affine(depth.shape[:2], (rh, rw), (out_h, out_w),
                          deg=deg, crop=crop, hflip=hflip)
    return resample_pair(rgb, depth, coef, out_h, out_w,
                         gain=_rgb_gain(rgb, jitter_gain),
                         depth_scale=1.0 / s, clip=(0.0, 1.0))


def val_transform(
    rgb: np.ndarray,
    depth: np.ndarray,
    *,
    out_h: int,
    out_w: int,
    resized_hw: tuple[int, int] | None = None,
    crop: str = "center",
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic eval path: resize to `resized_hw` (default: the crop
    size itself, i.e. a plain resize), then center/bottom crop."""
    if resized_hw is None:
        resized_hw = (out_h, out_w) if crop == "center" else depth.shape[:2]
    coef = compose_affine(depth.shape[:2], resized_hw, (out_h, out_w),
                          deg=0.0, crop=crop, hflip=False)
    return resample_pair(rgb, depth, coef, out_h, out_w,
                         gain=_rgb_gain(rgb, np.ones(3, np.float32)),
                         depth_scale=1.0, clip=(0.0, 1.0))
