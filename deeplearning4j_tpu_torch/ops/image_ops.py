"""Image ops of the port.

Counterpart of ``deeplearning4j_tpu/ops/image_ops.py``, under the same
names and keywords (NHWC images). What it takes care over:

* the resizes are ``jax.image.resize`` (``image_ops.py:34``), not
  ``F.interpolate``: half-pixel sample positions, a weight matrix per axis
  from the method's kernel (triangle for bilinear; Keys' cubic with
  a = −0.5 for bicubic, where torch's bicubic takes a = −0.75 and clamps
  its taps), the weights renormalized over the in-bounds taps, and no
  antialiasing. Nearest takes source index ⌊(i + ½)·in/out⌋;
* ``extract_image_patches`` orders the features (kh, kw, C)
  (``image_ops.py:151-155``);
* ``non_max_suppression`` keeps the reference's static-shape result
  (indices padded with −1, a 0/1 validity mask), a fixed number of greedy
  steps on the device with no host read.

Every op registers a validation spec (:mod:`.validation`).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import validation as V
from deeplearning4j_tpu_torch.ops.nn_ops import _explicit_pads, patches
from deeplearning4j_tpu_torch.ops.registry import op


def _triangle(x):
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def weight_matrix(in_size: int, out_size: int, kernel, device):
    """(in_size, out_size) float32 weights of ``jax.image``'s
    ``compute_weight_mat`` with no antialiasing: column j samples the
    input at (j + ½)·in/out − ½."""
    inv_scale = in_size / out_size
    sample = (torch.arange(out_size, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(
        in_size, dtype=torch.float32, device=device)[:, None])
    w = kernel(dist)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, size, method):
    out_h, out_w = int(size[0]), int(size[1])
    if method == "nearest":
        for d, n in ((1, out_h), (2, out_w)):
            m = x.shape[d]
            if m != n:
                src = torch.floor((torch.arange(n, dtype=torch.float32,
                                                device=x.device) + 0.5)
                                  * m / n).to(torch.int64)
                x = torch.index_select(x, d, src)
        return x
    kernel = _triangle if method == "bilinear" else _keys_cubic
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(torch.float32)
    if x.shape[1] != out_h:
        wh = weight_matrix(x.shape[1], out_h, kernel, x.device).to(x.dtype)
        x = torch.einsum("nhwc,ho->nowc", x, wh)
    if x.shape[2] != out_w:
        ww = weight_matrix(x.shape[2], out_w, kernel, x.device).to(x.dtype)
        x = torch.einsum("nhwc,wo->nhoc", x, ww)
    return x


@op("resize_bilinear")
def resize_bilinear(x, *, size):
    """NHWC bilinear resize (generic/parity_ops/resize_bilinear.cpp)."""
    return _resize(x, size, "bilinear")


@op("resize_nearest_neighbor")
def resize_nearest_neighbor(x, *, size):
    """NHWC nearest resize (generic/parity_ops/resize_neighbor.cpp)."""
    return _resize(x, size, "nearest")


@op("resize_bicubic")
def resize_bicubic(x, *, size):
    """NHWC bicubic resize (generic/parity_ops/resize_bicubic.cpp): Keys'
    cubic, a = −0.5."""
    return _resize(x, size, "cubic")


@op("crop_and_resize")
def crop_and_resize(image, boxes, box_indices, *, crop_size):
    """crop normalized boxes then bilinear-resize each to crop_size
    (generic/images/crop_and_resize.cpp). image: (N,H,W,C); boxes (B,4)
    as [y1,x1,y2,x2] in [0,1]; box_indices (B,) into N."""
    n, h, w, c = image.shape
    ch, cw = int(crop_size[0]), int(crop_size[1])
    dev = image.device
    y1, x1, y2, x2 = (boxes[:, i:i + 1] for i in range(4))

    def grid(lo, hi, count, size):
        # TF sampling rule: a size-1 crop dim samples the box CENTER,
        # larger dims run corner to corner
        if count > 1:
            steps = torch.arange(count, dtype=boxes.dtype, device=dev)
            return lo * (size - 1) + steps / (count - 1) * (hi - lo) * (size - 1)
        return 0.5 * (lo + hi) * (size - 1)

    ys, xs = grid(y1, y2, ch, h), grid(x1, x2, cw, w)  # (B, ch), (B, cw)
    img = image[box_indices.to(torch.int64)]  # (B, H, W, C)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.int64)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    bidx = torch.arange(img.shape[0], device=dev)[:, None, None]

    def at(yi, xi):
        return img[bidx, yi[:, :, None], xi[:, None, :]]

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


@op("non_max_suppression")
def non_max_suppression(boxes, scores, *, max_output_size: int,
                        iou_threshold: float = 0.5,
                        score_threshold: float = -np.inf):
    """greedy IoU NMS (generic/images [parity_ops]/non_max_suppression.cpp).

    Static shapes: returns (indices[max_output_size] int32, valid 0/1 mask
    int32) — the reference returns a dynamic-length index list; the mask
    carries the same information. boxes: (N,4) [y1,x1,y2,x2]."""
    n = boxes.shape[0]
    dev = boxes.device
    y1, x1, y2, x2 = (boxes[:, i] for i in range(4))
    area = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    live = scores > score_threshold
    ninf = torch.full((), float("-inf"), dtype=scores.dtype, device=dev)
    steps = torch.arange(n, device=dev)
    sel_idx, sel_mask = [], []
    for _ in range(int(max_output_size)):
        s = torch.where(live, scores, ninf)
        i = torch.argmax(s)
        ok = s[i] > ninf
        yy1 = torch.maximum(y1[i], y1)
        xx1 = torch.maximum(x1[i], x1)
        yy2 = torch.minimum(y2[i], y2)
        xx2 = torch.minimum(x2[i], x2)
        inter = torch.clamp_min(yy2 - yy1, 0) * torch.clamp_min(xx2 - xx1, 0)
        iou = inter / torch.clamp_min(area[i] + area - inter, 1e-9)
        sel_idx.append(torch.where(ok, i, torch.full_like(i, -1)))
        sel_mask.append(ok)
        live = live & torch.where(ok, iou <= iou_threshold, live) & \
            (steps != i)
    return (torch.stack(sel_idx).to(torch.int32),
            torch.stack(sel_mask).to(torch.int32))


@op("extract_image_patches")
def extract_image_patches(x, *, kernel, strides, rates=(1, 1),
                          padding: str = "VALID"):
    """extract_image_patches (generic/images [parity_ops]/
    extract_image_patches.cpp) — NHWC, returns (N, H', W', kh*kw*C) with the
    features ordered (kh, kw, C)."""
    k = (int(kernel[0]), int(kernel[1]))
    s = (int(strides[0]), int(strides[1]))
    d = (int(rates[0]), int(rates[1]))
    pad = "SAME" if padding.upper() == "SAME" else "VALID"
    pads = _explicit_pads(pad, x.shape[1:3], k, s, d)
    p = patches(x, k, s, d, pads)  # features (C, kh, kw)
    n, oh, ow, _ = p.shape
    c = x.shape[3]
    return p.reshape(n, oh, ow, c, k[0] * k[1]).transpose(3, 4).reshape(
        n, oh, ow, k[0] * k[1] * c)


@op("adjust_contrast")
def adjust_contrast(x, *, factor: float):
    """scale distance from per-channel mean (custom/adjust_contrast.cpp)."""
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    safe = torch.where(d == 0, one, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, zero, h)
    s = torch.where(mx == 0, zero, d / torch.where(mx == 0, one, mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6)[..., None]

    def choose(*opts):
        return torch.gather(torch.stack(opts, dim=-1), -1, i)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


@op("rgb_to_hsv")
def rgb_to_hsv(x):
    """RGB→HSV on the last axis (generic/images/rgb_to_hsv.cpp)."""
    return _rgb_to_hsv(x)


@op("hsv_to_rgb")
def hsv_to_rgb(x):
    """HSV→RGB on the last axis (generic/images/hsv_to_rgb.cpp)."""
    return _hsv_to_rgb(x)


@op("adjust_hue")
def adjust_hue(x, *, delta: float):
    """rotate hue by delta (custom/adjust_hue.cpp)."""
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@op("adjust_saturation")
def adjust_saturation(x, *, factor: float):
    """scale saturation (custom/adjust_saturation.cpp)."""
    hsv = _rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


@op("rgb_to_grs")
def rgb_to_grs(x):
    """RGB→grayscale, ITU-R 601 weights (generic/images/rgb_to_grs.cpp)."""
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=x.dtype).to(x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


# ---- validation specs -------------------------------------------------------


def _img(seed_shape=(2, 8, 8, 3)):
    return lambda r: [r.rand(*seed_shape).astype(np.float32)]


for _name in ("resize_bilinear", "resize_bicubic", "resize_nearest_neighbor"):
    for _size in ((4, 4), (16, 12), (5, 11)):
        V.case(_name, _img(), kwargs={"size": _size},
               dtypes=V.HALF if _size == (5, 11) else V.FLOAT,
               grad=_name != "resize_nearest_neighbor",
               label=f"{_size[0]}x{_size[1]}")


def _boxes(r):
    return [r.rand(2, 10, 10, 2).astype(np.float32),
            np.asarray([[0.0, 0.0, 0.5, 0.5], [0.2, 0.2, 0.9, 0.8],
                        [0.9, 0.1, 0.3, 0.7]], np.float32),
            np.asarray([0, 1, 1], np.int32)]


V.case("crop_and_resize", _boxes, kwargs={"crop_size": (4, 3)},
       dtypes=V.HALF, grad=True, cast=(0,), rtol=1e-5, atol=1e-5)
V.case("crop_and_resize", _boxes, kwargs={"crop_size": (1, 1)},
       cast=(0,), rtol=1e-5, atol=1e-5, label="center")


def _nms(r):
    base = r.rand(12, 2).astype(np.float32)
    boxes = np.concatenate(
        [base, base + 0.3 + 0.2 * r.rand(12, 2).astype(np.float32)], 1)
    return [boxes, r.rand(12).astype(np.float32)]


V.case("non_max_suppression", _nms, kwargs={"max_output_size": 5,
                                            "iou_threshold": 0.5})
V.case("non_max_suppression", _nms, kwargs={"max_output_size": 12,
                                            "iou_threshold": 0.3,
                                            "score_threshold": 0.4},
       label="exhausted")
for _pad in ("VALID", "SAME"):
    V.case("extract_image_patches", _img((1, 6, 7, 2)),
           kwargs={"kernel": (3, 2), "strides": (2, 2), "padding": _pad},
           dtypes=V.HALF, grad=True, label=_pad)
V.case("extract_image_patches", _img((1, 7, 7, 2)),
       kwargs={"kernel": (2, 2), "strides": (1, 2), "rates": (2, 1)},
       label="rates")
V.case("adjust_contrast", _img(), kwargs={"factor": 1.7}, dtypes=V.HALF,
       grad=True)
V.case("rgb_to_hsv", _img(), dtypes=V.HALF, grad=True, rtol=1e-5,
       atol=1e-6)
V.case("hsv_to_rgb", _img(), dtypes=V.HALF, grad=True)
# a hue one 16-bit unit apart can fall on the other side of a sextant
# boundary (floor(6h) in hsv_to_rgb): the card and the CPU round the
# bfloat16 hue's remainder differently at a few pixels, which then differ
# by up to a few units of the channel (4 of 384 by at most 0.027 seen)
V.case("adjust_hue", _img(), kwargs={"delta": 0.15}, dtypes=V.HALF,
       rtol=1e-5, atol=1e-6, card_tol={"bfloat16": (2.0 ** -6, 2.0 ** -4)})
V.case("adjust_saturation", _img(), kwargs={"factor": 0.6}, dtypes=V.HALF,
       rtol=1e-5, atol=1e-6)
V.case("rgb_to_grs", _img(), dtypes=V.HALF, grad=True)
