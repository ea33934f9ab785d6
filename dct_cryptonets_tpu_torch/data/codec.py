"""Batched DCT and RGB ingest, counterpart of
``dct_cryptonets_tpu.data.codec`` (``CodecConfig``, the eval and train
paths and what they call).

    uint8 RGB (B, H, W, 3)
      -> resize(1.15 * fs * S) -> center-crop(fs * S)   (cv2 fixed point)
      -> YCbCr split + 2x chroma downsample
      -> blockwise S_f x S_f orthonormal DCT-II        (ops.dct)
         (filter_size 8: the bit-exact libjpeg q100 path, ops.jpegdct)
      -> bilinear upscale of coefficient maps to (S, S)
      -> low-frequency channel subset, Y|Cb|Cr concat, normalization
      -> float32 (B, S, S, C)  NHWC

The integer pixel stages are exact; the float DCT and coefficient resize
agree with the JAX package to float32 rounding.

The train path (``dct_ingest_train``, ``rgb_ingest_train``) is
RandomResizedCrop -> brightness / contrast / saturation jitter -> hflip ->
round, then the DCT (or RGB normalization).  Each random stage is split
into a draw (:func:`draw_train`, from a ``torch.Generator`` on the CPU, so
the CPU and the GPU see the same draws) and a deterministic function of
the draws (:func:`augment`).
"""
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.dct import blockwise_dct2
from ..ops.jpegdct import (fdct_islow_q100_tiles, h2v2_downsample,
                           jpeg_q100_coefficients, rgb_to_ycbcr_libjpeg)
from ..parallel.mesh import shard_batch
from .tables import normalization_stats, subset_indices


@dataclass(frozen=True)
class CodecConfig:
    """Static configuration of the DCT ingest pipeline (reference flags)."""
    channels: int = 24
    filter_size: int = 4
    image_size_dct: int = 16
    dct_pattern: str = "default"

    @property
    def pixel_size(self) -> int:
        return self.filter_size * self.image_size_dct

    def subset(self):
        return subset_indices(self.channels, self.dct_pattern,
                              self.filter_size)

    def stats(self):
        return normalization_stats(self.channels)


def rgb_to_ycrcb_cv(x: torch.Tensor) -> torch.Tensor:
    """OpenCV RGB -> (Y, Cr, Cb), cv2's 14-bit fixed point, as float32."""
    xi = x.to(torch.int32)
    r, g, b = xi[..., 0], xi[..., 1], xi[..., 2]

    def descale(v):
        return (v + (1 << 13)) >> 14

    y = descale(r * 4899 + g * 9617 + b * 1868)
    cr = descale((r - y) * 11682) + 128
    cb = descale((b - y) * 9241) + 128
    return torch.clamp(torch.stack([y, cr, cb], dim=-1), 0, 255).to(
        torch.float32)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Float bilinear resize of (..., H, W, C) maps, half-pixel centers, no
    antialias."""
    *lead, H, W, C = x.shape
    y = x.to(torch.float32).reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C)


def _cv2_linear_plan(src: int, dst: int):
    """cv2 INTER_LINEAR 8U taps for one axis: output d reads src pixels
    i0[d], i1[d] with int weights a0, a1 at scale 2^11."""
    scale = src / dst
    d = np.arange(dst)
    fx = (d + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src - 1] = 0.0
    sx[sx >= src - 1] = src - 1
    a1 = np.rint(fx * 2048.0).astype(np.int32)
    a0 = np.rint((1.0 - fx) * 2048.0).astype(np.int32)
    return sx, np.minimum(sx + 1, src - 1), a0, a1


def resize_linear_u8_cv(x: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """cv2.resize(INTER_LINEAR) on uint8-valued (..., H, W) planes, bit
    exact: int horizontal taps, rows >> 4, then cv2's 8U vertical combine
    ((b0*r0 >> 16) + (b1*r1 >> 16) + 2) >> 2.  Returns float32."""
    H, W = x.shape[-2], x.shape[-1]
    dev = x.device
    xi = x.to(torch.int32)
    j0, j1, c0, c1 = (torch.as_tensor(a, device=dev)
                      for a in _cv2_linear_plan(W, out_w))
    rows = (xi[..., j0] * c0 + xi[..., j1] * c1) >> 4
    i0, i1, b0, b1 = (torch.as_tensor(a, device=dev)
                      for a in _cv2_linear_plan(H, out_h))
    t0 = (rows[..., i0, :] * b0[:, None]) >> 16
    t1 = (rows[..., i1, :] * b1[:, None]) >> 16
    return torch.clamp((t0 + t1 + 2) >> 2, 0, 255).to(torch.float32)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop with the reference's round-half-to-even offsets."""
    h, w = x.shape[-3], x.shape[-2]
    top = int(np.round((h - size) * 0.5))
    left = int(np.round((w - size) * 0.5))
    return x[..., top:top + size, left:left + size, :]


def _upscale_coeffs_i16(c: torch.Tensor, S: int) -> torch.Tensor:
    """UpScaleDCT on int16 coefficient maps (the fs=8 path): float
    bilinear, then round half to even."""
    if c.shape[-3] == S and c.shape[-2] == S:
        return c.to(torch.float32)
    return torch.round(resize_bilinear(c, S, S))


def _component_coeffs(plane: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """(B, H, W) pixel plane -> (B, S, S, S_f^2) upscaled coefficient maps."""
    c = blockwise_dct2(plane, cfg.filter_size, level_shift=True)
    S = cfg.image_size_dct
    if c.shape[-3] != S or c.shape[-2] != S:
        c = resize_bilinear(c, S, S)
    return c


def dct_from_pixels(cropped: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """uint8 RGB (B, P, P, 3), P = filter_size * S -> normalized
    (B, S, S, C): GetDCT -> UpScaleDCT -> SubsetDCT -> Aggregate ->
    NormalizeDCT."""
    if cfg.filter_size == 8:
        S = cfg.image_size_dct
        coeff_y, coeff_cb, coeff_cr = (
            _upscale_coeffs_i16(c, S)
            for c in jpeg_q100_coefficients(cropped))
    else:
        ycc = rgb_to_ycrcb_cv(cropped)
        # reference quirk: its "cb" slot holds Cr (cv2.split of YCrCb)
        hh, hw = cropped.shape[-3] // 2, cropped.shape[-2] // 2
        coeff_y = _component_coeffs(ycc[..., 0], cfg)
        coeff_cb = _component_coeffs(
            resize_linear_u8_cv(ycc[..., 1], hh, hw), cfg)
        coeff_cr = _component_coeffs(
            resize_linear_u8_cv(ycc[..., 2], hh, hw), cfg)
    dev = cropped.device
    y_idx, cb_idx, cr_idx = (torch.as_tensor(i, device=dev)
                             for i in cfg.subset())
    agg = torch.cat([coeff_y[..., y_idx], coeff_cb[..., cb_idx],
                     coeff_cr[..., cr_idx]], dim=-1)
    mean, std = (torch.as_tensor(a, device=dev) for a in cfg.stats())
    return (agg - mean) / std


def _eval_resize_crop(images_u8: torch.Tensor, P: int) -> torch.Tensor:
    """Resize(1.15 P, shorter edge) -> CenterCrop(P), cv2 fixed point."""
    rs = int(P * 1.15)
    H, W = images_u8.shape[-3], images_u8.shape[-2]
    if not ((W <= H and W == rs) or (H <= W and H == rs)):
        if W < H:
            oh, ow = int(rs * H / W), rs
        else:
            oh, ow = rs, int(rs * W / H)
        planes = resize_linear_u8_cv(images_u8.movedim(-1, -3), oh, ow)
        images_u8 = planes.movedim(-3, -1)
    return center_crop(images_u8, P)


def dct_ingest(images_u8, cfg: CodecConfig) -> torch.Tensor:
    """Eval-path ingest: uint8 RGB (B, H, W, 3) (tensor or numpy) ->
    float32 (B, S, S, C) on the input tensor's device."""
    return dct_from_pixels(_eval_resize_crop(_as_tensor(images_u8),
                                             cfg.pixel_size), cfg)


def dct_ingest_sharded(images_u8, cfg: CodecConfig, mesh) -> torch.Tensor:
    """DCT-tile-parallel eval ingest, counterpart of the JAX
    ``dct_ingest_sharded``: the S_f x S_f tile grid of the whole batch
    (every image's tiles flattened, so one image's grid spreads over the
    mesh) is zero-padded to a multiple of the mesh and sharded over it
    (``parallel.Mesh``); each entry runs the per-tile DCT and the static
    channel selection on its shard, and only the selected channels are
    gathered (an all-gather when the mesh spans processes).  The pixel
    prologue (resize, crop, color conversion, chroma downsample) and the
    upscale / normalize epilogue run on the input's device for the whole
    batch.  Equal to :func:`dct_ingest` bit for bit; returns float32
    (B, S, S, C) on the input tensor's device."""
    x = _eval_resize_crop(_as_tensor(images_u8), cfg.pixel_size)
    dev = x.device
    S, S_f = cfg.image_size_dct, cfg.filter_size
    if S_f == 8:
        y, cb, cr = rgb_to_ycbcr_libjpeg(x)
        cb, cr = h2v2_downsample(cb), h2v2_downsample(cr)
        tile_fn = fdct_islow_q100_tiles

        def post(c):
            return _upscale_coeffs_i16(c, S)
    else:
        ycc = rgb_to_ycrcb_cv(x)
        hh, hw = x.shape[-3] // 2, x.shape[-2] // 2
        y = ycc[..., 0]
        cb = resize_linear_u8_cv(ycc[..., 1], hh, hw)
        cr = resize_linear_u8_cv(ycc[..., 2], hh, hw)

        def tile_fn(tiles):
            # each tile is a plane of one S_f x S_f block
            c = blockwise_dct2(tiles, S_f, level_shift=True)
            return c.reshape(c.shape[0], S_f * S_f)

        def post(c):
            if c.shape[-3] != S or c.shape[-2] != S:
                c = resize_bilinear(c, S, S)
            return c

    def component(plane, idx):
        B, H, W = plane.shape
        nh, nw = H // S_f, W // S_f
        tiles = plane.reshape(B, nh, S_f, nw, S_f).movedim(-3, -2)
        tiles = tiles.reshape(B * nh * nw, S_f, S_f)
        t = tiles.shape[0]
        tiles = F.pad(tiles, (0, 0, 0, 0, 0, (-t) % mesh.size))
        shards = shard_batch(mesh, tiles)
        for i, part in shards.local():
            sel = torch.as_tensor(idx, device=part.device)
            shards.shards[i] = tile_fn(part)[:, sel]
        out = shards.gather(dev)
        # the upscale runs on all S_f^2 maps (the unselected ones zero), as
        # in dct_ingest: the CPU's bilinear resize vectorizes over the
        # channels, so its rounding depends on their count
        sel = torch.as_tensor(idx, device=dev)
        full = out.new_zeros((B, nh, nw, S_f * S_f))
        full[..., sel] = out[:t].reshape(B, nh, nw, len(idx))
        return post(full)[..., sel]

    y_idx, cb_idx, cr_idx = cfg.subset()
    agg = torch.cat([component(y, y_idx), component(cb, cb_idx),
                     component(cr, cr_idx)], dim=-1)
    mean, std = (torch.as_tensor(a, device=dev) for a in cfg.stats())
    return (agg - mean) / std


def _as_tensor(images) -> torch.Tensor:
    return images if isinstance(images, torch.Tensor) else \
        torch.as_tensor(np.asarray(images))


# ---------------------------------------------------------------------------
# train-path augmentation


@dataclass(frozen=True)
class TrainDraws:
    """Per-image random parameters of the train path (CPU tensors):
    ``crop`` = (h, w, top, left), each (B,) float32 in input pixels;
    ``jitter`` (B, 3) float32 brightness, contrast and color factors;
    ``flip`` (B,) bool."""
    crop: tuple
    jitter: torch.Tensor
    flip: torch.Tensor

    def take(self, rows) -> "TrainDraws":
        """The draws of ``rows`` of the batch (a data-parallel shard)."""
        return TrainDraws(tuple(c[rows] for c in self.crop),
                          self.jitter[rows], self.flip[rows])


def draw_train(generator: torch.Generator, B: int, H: int, W: int,
               jitter: float = 0.4) -> TrainDraws:
    """The JAX ``_random_resized_crop``'s box (area a share in [0.08, 1]
    of the image, log-uniform aspect in [3/4, 4/3]), ``_image_jitter``'s
    factors ``1 + jitter * U(-1, 1)`` and a fair flip per image."""
    scale, ratio = (0.08, 1.0), (3.0 / 4.0, 4.0 / 3.0)
    u = torch.rand((4, B), generator=generator)
    area = (u[0] * (scale[1] - scale[0]) + scale[0]) * (H * W)
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(u[1] * (hi - lo) + lo)
    w = torch.clamp(torch.sqrt(area * r), 1.0, W)
    h = torch.clamp(torch.sqrt(area / r), 1.0, H)
    crop = (h, w, u[2] * (H - h), u[3] * (W - w))
    f = 1.0 + jitter * (torch.rand((B, 3), generator=generator) * 2 - 1)
    flip = torch.rand((B,), generator=generator) < 0.5
    return TrainDraws(crop, f, flip)


def _crop_weights(in_size: int, out_size: int, scale: torch.Tensor,
                  translation: torch.Tensor) -> torch.Tensor:
    """(B, out_size, in_size) weights of ``jax.image.scale_and_translate``
    (method "linear", antialias off) along one axis: the triangle kernel
    at the sample positions, each row normalized, a row zeroed where its
    sample falls outside the input."""
    dev = scale.device
    inv = (torch.ones_like(scale) / scale)[:, None]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (o + 0.5) * inv - translation[:, None] * inv - 0.5   # (B, P)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    wts = torch.clamp(1 - torch.abs(sample[:, :, None] - i), min=0)
    total = wts.sum(dim=2, keepdim=True)
    wts = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(
        np.float32).eps), wts / torch.where(total != 0, total, 1.0),
        torch.zeros_like(wts))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, :, None], wts, torch.zeros_like(wts))


def resized_crop(images: torch.Tensor, h, w, top, left,
                 out_size: int) -> torch.Tensor:
    """Crop the box (h, w, top, left) of each image and resize it to
    (out_size, out_size): one batched weight matrix per axis, as the JAX
    ``_random_resized_crop`` does through ``scale_and_translate``.
    (B, H, W, C) -> float32 (B, out_size, out_size, C)."""
    B, H, W, C = images.shape
    dev = images.device
    h, w, top, left = (t.to(dev, torch.float32) for t in (h, w, top, left))
    p = torch.full_like(h, out_size)
    sy, sx = p / h, p / w
    wy = _crop_weights(H, out_size, sy, -top * sy)
    wx = _crop_weights(W, out_size, sx, -left * sx)
    x = torch.einsum("bph,bhwc->bpwc", wy, images.to(torch.float32))
    return torch.einsum("bqw,bpwc->bpqc", wx, x)


def _gray(img: torch.Tensor) -> torch.Tensor:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def image_jitter(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, then saturation ("Color"), each measuring its
    gray statistics on the previous stage's image, as the JAX
    ``_image_jitter``.  x: float (B, H, W, 3); factors (B, 3)."""
    fb, fc, fs = (factors[:, i].to(x.device).view(-1, 1, 1, 1)
                  for i in range(3))
    x = x * fb
    mean = _gray(x).mean(dim=(1, 2), keepdim=True)
    x = mean + (x - mean) * fc
    gray = _gray(x)
    x = gray + (x - gray) * fs
    return torch.clamp(x, 0, 255)


def augment(images_u8: torch.Tensor, draws: TrainDraws,
            out_size: int) -> torch.Tensor:
    """The train path's pixel stages for given draws: resized crop ->
    jitter -> hflip -> round and clip.  Returns float32 (B, P, P, 3)."""
    x = resized_crop(images_u8, *draws.crop, out_size)
    x = image_jitter(x, draws.jitter)
    flip = draws.flip.to(x.device).view(-1, 1, 1, 1)
    x = torch.where(flip, x.flip(2), x)
    return torch.clamp(torch.round(x), 0, 255)


def _shard_draws(x, draws, rows):
    return (x, draws) if rows is None else (x[rows], draws.take(rows))


def dct_ingest_train(generator: torch.Generator, images_u8,
                     cfg: CodecConfig, rows=None) -> torch.Tensor:
    """Train-path ingest: RandomResizedCrop(P) -> jitter -> hflip -> DCT
    (reference datamgr.py:150-191), on the images' device.  ``rows``: a
    data-parallel shard's rows; the draws are the whole batch's, sliced."""
    x = _as_tensor(images_u8)
    x, draws = _shard_draws(x, draw_train(generator, *x.shape[:3]), rows)
    return dct_from_pixels(augment(x, draws, cfg.pixel_size), cfg)


# RGB (non-DCT) normalization stats: CIFAR stats + 0.1 jitter for cifar10
# RGB, ImageNet stats + 0.4 jitter otherwise (reference
# homomorphic_eval.py:100-111, datamgr.py:26-42)
RGB_STATS = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "default": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def rgb_jitter_param(dataset: str) -> float:
    """0.1 for cifar10 RGB, 0.4 (the datamgr default) otherwise."""
    return 0.1 if dataset == "cifar10" else 0.4


def rgb_normalize(x: torch.Tensor, dataset: str = "cifar10") -> torch.Tensor:
    """ToTensor + Normalize for the RGB path; input is 0..255."""
    mean, std = RGB_STATS.get(dataset, RGB_STATS["default"])
    dev = x.device
    mean = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (x.to(torch.float32) - mean) / std


def rgb_ingest(images_u8, image_size: int,
               dataset: str = "cifar10") -> torch.Tensor:
    """RGB eval-path ingest: Resize(1.15x) -> CenterCrop -> Normalize
    (reference datamgr.py:82-90)."""
    big = int(image_size * 1.15)
    x = resize_bilinear(_as_tensor(images_u8).to(torch.float32), big, big)
    return rgb_normalize(center_crop(x, image_size), dataset)


def rgb_ingest_train(generator: torch.Generator, images_u8, image_size: int,
                     dataset: str = "cifar10", rows=None) -> torch.Tensor:
    """RGB train-path ingest: RandomResizedCrop -> jitter (per dataset) ->
    hflip -> Normalize (reference datamgr.py:69-80); ``rows`` as for
    :func:`dct_ingest_train`."""
    x = _as_tensor(images_u8)
    x, draws = _shard_draws(x, draw_train(generator, *x.shape[:3],
                                          jitter=rgb_jitter_param(dataset)),
                            rows)
    return rgb_normalize(augment(x, draws, image_size), dataset)


def make_ingest(codec_cfg: CodecConfig | None, device, image_size: int = 32,
                dataset: str = "cifar10"):
    """Eval-path ingest closure: uint8 RGB batch -> float32 model input on
    ``device``: the DCT codec when ``codec_cfg`` is given, else the RGB
    transform (Resize 1.15x, CenterCrop, Normalize with per-dataset
    stats)."""
    def _in(images):
        x = torch.as_tensor(np.asarray(images), device=device)
        if codec_cfg is None:
            return rgb_ingest(x, image_size, dataset)
        return dct_ingest(x, codec_cfg)
    return _in
