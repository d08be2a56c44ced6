"""Detector training augmentation: random affine crop + colorizers.

The port's copy of ``findtextcenternet_tpu/data/augment.py``, the host-side
numpy form of the upstream Cython augmenter (``dataset/processer.pyx:
260-876``): random rotation / scale / aspect / shear, a random crop
centered near a random box, bilinear (or 5% nearest) resampling of the
page image and the quarter-scale line/separator maps, partial-inversion
augmentation, 1% all-blank samples, and the four fg/bg contrast-separated
colorizers. Target maps come from :mod:`.targets`.

Two backends apply the pre-sampled transform: ``"native"`` (the default)
runs ``native/augment/augment.cpp`` (:mod:`.augment_native`, built at
first use); ``"numpy"`` is its plain version, :func:`_warp_numpy` and
:func:`.targets.make_target_maps`. The JAX package's numpy backend warps
with OpenCV when it is installed; the port does not use OpenCV.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..const import IMAGE_HEIGHT, IMAGE_WIDTH, SCALE
from .targets import make_target_maps


def _affine_matrix(cx, cy, angle, size_x, size_y, sh_x, sh_y) -> np.ndarray:
    """Forward 3x3 matrix: shear @ resize @ move(+c) @ rot @ move(-c)."""
    shear = np.array([[1, sh_y, 0], [sh_x, 1, 0], [0, 0, 1]], np.float64)
    resize = np.diag([size_x, size_y, 1.0])
    move = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float64)
    rot = np.array([[np.cos(angle), -np.sin(angle), 0],
                    [np.sin(angle), np.cos(angle), 0], [0, 0, 1]], np.float64)
    back = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float64)
    return shear @ resize @ move @ rot @ back


def sample_affine_params(rng: np.random.Generator, minsize: float,
                         strong: bool = True):
    """Augmentation parameter sampling (train step1 flavor)."""
    angle = np.deg2rad(rng.normal() * (5.0 if strong else 1.0))
    if strong:
        size_x = rng.normal() + 1.0
        aspect = abs(rng.normal()) + 1.0
        if size_x < 0.8:
            size_x = 0.8 - size_x + 0.8
        if size_x < 1.0 and size_x * minsize < 10:
            size_x = 10 / max(minsize, 1e-6)
            aspect = 1.0
    else:
        size_x = abs(rng.normal()) + 1.0
        aspect = 0.1 * abs(rng.normal()) + 1.0
    size_y = size_x * aspect if rng.uniform() < 0.5 else size_x / aspect
    sh_x = rng.normal() * 0.01
    sh_y = rng.normal() * 0.01
    return angle, size_x, size_y, sh_x, sh_y


@dataclasses.dataclass
class AffineParams:
    """Pre-sampled augmentation parameters (shared by numpy/native)."""
    angle: float
    size_x: float
    size_y: float
    sh_x: float
    sh_y: float
    startx: float
    starty: float
    nearest: bool
    inv_rect: Tuple[int, int, int, int]   # y0, y1, x0, x1; (-1,..) = none

    def as_array(self):
        return np.array([
            self.angle, self.size_x, self.size_y, self.sh_x, self.sh_y,
            self.startx, self.starty, 1.0 if self.nearest else 0.0,
            *self.inv_rect], np.float64)


def inverse_partial(image: np.ndarray, rng: np.random.Generator) -> None:
    """Invert a random axis-aligned subrectangle of a uint8 image in place
    (the same draws as :func:`sample_params`' inversion)."""
    im_h, im_w = image.shape[:2]
    h = int(rng.uniform() * (im_h - 1))
    w = int(rng.uniform() * (im_w - 1))
    i = int(rng.uniform() * (im_h - h + 1))
    j = int(rng.uniform() * (im_w - w + 1))
    image[i:i + h, j:j + w] = 255 - image[i:i + h, j:j + w]


def sample_params(image: np.ndarray, position: np.ndarray,
                  rng: np.random.Generator,
                  out_hw: Tuple[int, int] = (IMAGE_HEIGHT, IMAGE_WIDTH),
                  strong: bool = True,
                  invert: bool = True) -> AffineParams:
    """Sample the full augmentation parameter set."""
    out_h, out_w = out_hw
    im_h, im_w = image.shape[:2]
    n = len(position)
    mean_size = 10.0
    if n:
        ssum = float(np.sum(np.maximum(position[:, 2], position[:, 3])))
        mean_size = ssum / n if ssum > 0 else 10.0
    angle, size_x, size_y, sh_x, sh_y = sample_affine_params(
        rng, mean_size, strong)

    if invert:
        h = int(rng.uniform() * (im_h - 1))
        w = int(rng.uniform() * (im_w - 1))
        i = int(rng.uniform() * (im_h - h + 1))
        j = int(rng.uniform() * (im_w - w + 1))
        inv_rect = (i, i + h, j, j + w)
    else:
        inv_rect = (-1, -1, -1, -1)

    # crop origin near a random (transformed) box
    M = _affine_matrix(im_w / 2, im_h / 2, angle, size_x, size_y, sh_x, sh_y)
    if n:
        cidx = int(rng.uniform() * n)
        c = position[cidx, :2].astype(np.float64)
        rc = M[:2, :2] @ c + M[:2, 2]
        startx = rc[0] - (rng.uniform() * out_w * 0.75 + out_w / 8)
        starty = rc[1] - (rng.uniform() * out_h * 0.75 + out_h / 8)
    else:
        startx = rng.uniform() * out_w
        starty = rng.uniform() * out_h
    nearest = rng.uniform() < 0.05
    return AffineParams(float(angle), float(size_x), float(size_y),
                        float(sh_x), float(sh_y), float(startx),
                        float(starty), bool(nearest), inv_rect)


def apply_transform_numpy(image, textline, sepline, position, codelist,
                          p: AffineParams,
                          out_hw: Tuple[int, int] = (IMAGE_HEIGHT,
                                                     IMAGE_WIDTH),
                          scale: int = SCALE):
    """Apply pre-sampled augmentation (the numpy backend)."""
    out_h, out_w = out_hw
    mh, mw = out_h // scale, out_w // scale
    im_h, im_w = image.shape
    n = len(position)

    M = _affine_matrix(im_w / 2, im_h / 2, p.angle, p.size_x, p.size_y,
                       p.sh_x, p.sh_y)
    M2 = _affine_matrix(textline.shape[1] / 2, textline.shape[0] / 2,
                        p.angle, p.size_x, p.size_y, p.sh_x, p.sh_y)
    Minv = np.linalg.inv(M)
    M2inv = np.linalg.inv(M2)

    image = image.copy()
    y0, y1, x0, x1 = p.inv_rect
    if y0 >= 0:
        image[y0:y1, x0:x1] = 255 - image[y0:y1, x0:x1]

    pos = position.astype(np.float64).copy()
    if n:
        p1 = pos[:, :2] - pos[:, 2:] / 2
        p2 = pos[:, :2] + pos[:, 2:] / 2
        r1 = (M[:2, :2] @ p1.T).T + M[:2, 2]
        r2 = (M[:2, :2] @ p2.T).T + M[:2, 2]
        pos[:, :2] = (r1 + r2) / 2
        pos[:, 2:] = r2 - r1
    pos[:, 0] -= p.startx
    pos[:, 1] -= p.starty

    keysize, idmap, minsize = make_target_maps(
        pos.astype(np.float32), codelist, (mh, mw), scale)

    out_img = _warp_numpy(image, Minv, p.startx, p.starty, out_h, out_w,
                          p.nearest) / 255.0
    line = _warp_numpy(textline, M2inv, p.startx / 2, p.starty / 2,
                       mh, mw, False, step=scale / 2) / 255.0
    seps = _warp_numpy(sepline, M2inv, p.startx / 2, p.starty / 2,
                       mh, mw, False, step=scale / 2) / 255.0

    labelmap = np.concatenate(
        [keysize, line[..., None], seps[..., None]], axis=-1)
    return (out_img.astype(np.float32), labelmap.astype(np.float32),
            idmap, minsize, pos.astype(np.float32))


def transform_crop(
    image: np.ndarray,        # (H, W) uint8 page rendering
    textline: np.ndarray,     # (H/2, W/2) uint8
    sepline: np.ndarray,      # (H/2, W/2) uint8
    position: np.ndarray,     # (N, 4) float32 cx,cy,w,h
    codelist: np.ndarray,     # (N, 2) int32
    rng: np.random.Generator,
    out_hw: Tuple[int, int] = (IMAGE_HEIGHT, IMAGE_WIDTH),
    scale: int = SCALE,
    return_positions: bool = False,
    backend: str = "native",
    strong: bool = True,
    invert: bool = True,
):
    """Random affine + crop; returns (image[h,w] f32 in [0,1],
    labelmap (h/s, w/s, 5), idmap (h/s, w/s, 2), minsize) and, when
    ``return_positions``, the transformed (N, 4) box array in crop
    coordinates as a fifth element.

    ``backend``: ``"native"`` (the C++ kernels, built at first use) or
    ``"numpy"`` (their plain version).
    ``strong=False, invert=False`` is the milder stage-2 law (the upstream
    transform_crop2: 1-degree rotation sigma, mild aspect, no partial
    inversion, ``dataset/processer.pyx:497-520``).
    """
    params = sample_params(image, position, rng, out_hw, strong=strong,
                           invert=invert)
    if backend == "native":
        from .augment_native import apply_transform_native
        apply = apply_transform_native
    elif backend == "numpy":
        apply = apply_transform_numpy
    else:
        raise ValueError(f"backend={backend!r}: expected 'native' or "
                         f"'numpy'")
    img, labelmap, idmap, minsize, pos = apply(
        image, textline, sepline, position, codelist, params, out_hw, scale)
    if return_positions:
        return img, labelmap, idmap, minsize, pos
    return img, labelmap, idmap, minsize


def _warp_numpy(img, Minv, sx, sy, out_h, out_w, nearest, step=1.0):
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    xs = xs * step + sx
    ys = ys * step + sy
    rx = Minv[0, 0] * xs + Minv[0, 1] * ys + Minv[0, 2]
    ry = Minv[1, 0] * xs + Minv[1, 1] * ys + Minv[1, 2]
    h, w = img.shape

    def get(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.zeros(xi.shape, np.float32)
        out[valid] = img[yi[valid], xi[valid]]
        return out

    if nearest:
        return get((rx + 0.5).astype(np.int64), (ry + 0.5).astype(np.int64))
    x0 = np.floor(rx).astype(np.int64)
    y0 = np.floor(ry).astype(np.int64)
    dx = (rx - x0).astype(np.float32)
    dy = (ry - y0).astype(np.float32)
    return ((1 - dx) * (1 - dy) * get(x0, y0) + dx * (1 - dy) * get(x0 + 1, y0)
            + (1 - dx) * dy * get(x0, y0 + 1) + dx * dy * get(x0 + 1, y0 + 1))


# ---------------------------------------------------------------------------
# colorizers: grayscale glyph alpha -> RGB with forced fg/bg contrast
# (upstream `dataset/processer.pyx:676-876` semantics)
# ---------------------------------------------------------------------------

def _contrast_bg(fg: float, rng) -> float:
    """Sample a background level at least 0.5 away from ``fg``."""
    b = rng.uniform()
    if fg > 0.5:
        return b * (fg - 0.5)
    return 1 - b * (1 - (fg + 0.5))


def colorize_mono(im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    fg = rng.uniform()
    bg = _contrast_bg(fg, rng)
    out = im * fg + (1 - im) * bg
    return np.repeat(out[..., None], 3, axis=-1).astype(np.float32)


def colorize_single(im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    chans = []
    for _ in range(3):
        fg = rng.uniform()
        bg = _contrast_bg(fg, rng)
        chans.append(im * fg + (1 - im) * bg)
    return np.stack(chans, axis=-1).astype(np.float32)


def colorize_double(im: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Two foreground colors split at a random rectangle boundary."""
    h, w = im.shape
    fg1 = rng.uniform(size=3)
    fg2 = rng.uniform(size=3)
    # fg2 is conditioned onto fg1's side of 0.5 per channel
    # (upstream `dataset/processer.pyx:817-830`) so the two
    # foregrounds never straddle the midpoint — otherwise the background
    # could land within <0.5 contrast of one of them
    fg2 = np.where(fg1 > 0.5, fg2 * 0.5 + 0.5, fg2 * 0.5)
    top = int(rng.uniform() * (h - 1))
    bottom = int(rng.uniform() * (h - top)) + top
    left = int(rng.uniform() * (w - 1))
    right = int(rng.uniform() * (w - left)) + left
    region = np.zeros((h, w), bool)
    region[top:bottom, left:right] = True

    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fg_hi = max(fg1[c], fg2[c]) + 0.5
        fg_lo = min(fg1[c], fg2[c]) - 0.5
        b = rng.uniform()
        if fg_lo > 0:
            bg = b * fg_lo
        else:
            bg = 1 - b * (1 - min(fg_hi, 1.0))
        fg = np.where(region, fg1[c], fg2[c])
        out[..., c] = im * fg + (1 - im) * bg
    return out


def colorize_background(im: np.ndarray, bgimg: np.ndarray,
                        rng: np.random.Generator) -> np.ndarray:
    """Composite glyphs over a random crop of a photo background with a
    foreground color contrast-separated from the local background mean."""
    h, w = im.shape
    bh, bw = bgimg.shape[:2]
    sy = int(rng.uniform() * max(1, bh - h))
    sx = int(rng.uniform() * max(1, bw - w))
    crop = bgimg[sy:sy + h, sx:sx + w].astype(np.float32) / 255.0
    if crop.shape[0] < h or crop.shape[1] < w:
        crop = np.pad(crop, ((0, h - crop.shape[0]),
                             (0, w - crop.shape[1]), (0, 0)), mode="wrap")
    out = np.empty((h, w, 3), np.float32)
    for c in range(3):
        bg_mean = float(np.mean(crop[..., c]))
        fg = _contrast_bg(bg_mean, rng)  # symmetric relation
        out[..., c] = im * fg + (1 - im) * crop[..., c]
    return out


def colorize(im: np.ndarray, rng: np.random.Generator,
             bgimg: Optional[np.ndarray] = None) -> np.ndarray:
    """Random colorizer choice, mirroring transforms3's nested branch
    weights (upstream `dataset/data_detector.py:48-57`): photo
    background 0.30, mono 0.35, single 0.175, double 0.175. Without a
    photo corpus the background share falls to mono (a solid page, the
    closest analog)."""
    if rng.uniform() < 0.3:
        if bgimg is not None:
            return colorize_background(im, bgimg, rng)
        return colorize_mono(im, rng)
    if rng.uniform() < 0.5:
        return colorize_mono(im, rng)
    if rng.uniform() < 0.5:
        return colorize_single(im, rng)
    return colorize_double(im, rng)


def color_jitter(im: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5, hue: float = 0.5) -> np.ndarray:
    """torchvision-style ColorJitter on a float RGB image in [0, 1].

    Stage-2 finetuning applies ColorJitter(0.5, 0.5, 0.5, 0.5) to every
    fixdata sample (upstream `train2.py:30,193-204`). Factors are
    drawn like torchvision: brightness/contrast/saturation uniform in
    [1-f, 1+f], hue shift uniform in [-h, h] half-turns, applied in a
    random order.
    """
    ops = []
    if brightness > 0:
        b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * b)
    if contrast > 0:
        c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(x, c=c):
            # torchvision pivots on the mean of the grayscale image
            g = (0.299 * x[..., 0] + 0.587 * x[..., 1] +
                 0.114 * x[..., 2]).mean()
            return (x - g) * c + g
        ops.append(_contrast)
    if saturation > 0:
        s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)

        def _saturate(x, s=s):
            g = (0.299 * x[..., 0] + 0.587 * x[..., 1] +
                 0.114 * x[..., 2])[..., None]
            return (x - g) * s + g
        ops.append(_saturate)
    if hue > 0:
        h = rng.uniform(-hue, hue)

        def _hue(x, h=h):
            # rotate hue by h half-turns via HSV round trip
            mx = x.max(axis=-1)
            mn = x.min(axis=-1)
            d = mx - mn
            hch = np.zeros_like(mx)
            m = d > 1e-12
            r, g, b = x[..., 0], x[..., 1], x[..., 2]
            sel = m & (mx == r)
            hch[sel] = ((g - b)[sel] / d[sel]) % 6
            sel = m & (mx == g) & (mx != r)
            hch[sel] = (b - r)[sel] / d[sel] + 2
            sel = m & (mx == b) & (mx != r) & (mx != g)
            hch[sel] = (r - g)[sel] / d[sel] + 4
            hch = (hch / 6.0 + h) % 1.0
            # HSV -> RGB
            i = np.floor(hch * 6).astype(int)
            f = hch * 6 - i
            sat = np.where(mx > 1e-12, d / np.maximum(mx, 1e-12), 0)
            v = mx
            p = v * (1 - sat)
            q = v * (1 - f * sat)
            t = v * (1 - (1 - f) * sat)
            i = i % 6
            out = np.stack([
                np.choose(i, [v, q, p, p, t, v]),
                np.choose(i, [t, v, v, q, p, p]),
                np.choose(i, [p, p, t, v, v, q]),
            ], axis=-1)
            return out
        ops.append(_hue)
    order = rng.permutation(len(ops))
    out = im.astype(np.float32)
    for k in order:
        out = ops[int(k)](out)
    return np.clip(out, 0.0, 1.0)


def random_salt(im: np.ndarray, minsize: float, rng: np.random.Generator,
                prob: float = 0.1) -> np.ndarray:
    """Block salt-and-pepper noise scaled to the glyph size
    (upstream `dataset/data_detector.py:17-27` semantics)."""
    h, w = im.shape
    s = min(max(1, int(minsize / 4)), int(rng.integers(1, 16)))
    shape = ((h + s) // s, (w + s) // s)
    noise = rng.choice(np.array([0.0, 1.0, np.nan], im.dtype),
                       p=[prob / 2, 1 - prob, prob / 2], size=shape)
    noise = np.repeat(np.repeat(noise, s, axis=0), s, axis=1)[:h, :w]
    return np.nan_to_num(im * noise, nan=1.0)


def random_distortion(im: np.ndarray, minsize: float,
                      rng: np.random.Generator) -> np.ndarray:
    """Gaussian pixel noise / blur / unsharp sharpening
    (upstream `dataset/data_detector.py:29-42` semantics)."""
    from scipy.ndimage import gaussian_filter

    if rng.random() < 0.3:
        alpha = min(0.4 * rng.random(), 20 / max(1.0, minsize))
        im = np.clip(im + alpha * rng.normal(size=im.shape), 0, 1)
    if rng.random() < 0.3:
        sigma = min(minsize / 8, 1.5 * rng.random())
        im = np.clip(gaussian_filter(im, sigma=sigma), 0, 1)
    elif rng.random() < 0.3:
        blurred = gaussian_filter(im, sigma=5.0)
        im = np.clip(im + 10.0 * rng.random() * (im - blurred), 0, 1)
    return im.astype(np.float32)


def process_sample(sample: Dict[str, np.ndarray], rng: np.random.Generator,
                   blank_prob: float = 0.01,
                   out_hw: Tuple[int, int] = (IMAGE_HEIGHT, IMAGE_WIDTH),
                   backend: str = "native") -> Dict[str, np.ndarray]:
    """Full step1 sample pipeline: crop/warp + targets + colorize.

    ``sample``: image (H,W) u8, textline/sepline (H/2,W/2) u8,
    position (N,4) f32, code_list (N,2) i32.
    Returns image (h,w,3) f32, labelmap (h/s,w/s,5), idmap (h/s,w/s,2).
    """
    oh, ow = out_hw
    if rng.uniform() < blank_prob:
        # blank negatives keep zero targets but still flow through the
        # colorize/distortion pipeline (the reference's process()
        # returns a zero-ink image with minsize=0 and transforms3 runs
        # unconditionally, `processer.pyx:666-670` +
        # `data_detector.py:44-58`) — so the detector sees random
        # colored empty pages, not pure black
        img = np.zeros((oh, ow), np.float32)
        labelmap = np.zeros((oh // SCALE, ow // SCALE, 5), np.float32)
        idmap = np.zeros((oh // SCALE, ow // SCALE, 2), np.int32)
        minsize = 0.0
    else:
        img, labelmap, idmap, minsize = transform_crop(
            sample["image"], sample["textline"], sample["sepline"],
            sample["position"], sample["code_list"], rng, out_hw=out_hw,
            backend=backend)
    if rng.random() < 0.2:
        img = random_salt(img, minsize, rng, prob=0.2 * rng.random())
    rgb = colorize(img, rng, sample.get("background"))
    rgb = random_distortion(rgb, minsize, rng)
    return {"image": rgb, "labelmap": labelmap, "idmap": idmap}
