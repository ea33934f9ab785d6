"""Batched spatial and color transforms (the cvtransforms equivalents),
counterpart of ``dct_cryptonets_tpu.data.transforms``.

Every transform is a function of a batch ``(B, H, W, C)`` float tensor and
runs on the tensor's device.  A random transform takes a
``torch.Generator`` and is split in two: a draw (``draw_*``, on the
generator's device) and a deterministic function of the draw.  Given a CPU
generator, the CPU and the GPU see the same draws; the deterministic halves
take the JAX package's parameters as they are, so the two packages can be
held to each other on the same draws.

Geometric transforms (rotate / affine / perspective) share one inverse-warp
bilinear sampler (:func:`_warp_bilinear`): the output grid is pulled back
through the inverse coordinate map and sampled bilinearly with a constant
border fill, the semantics of ``cv2.warpAffine``/``cv2.warpPerspective``
with ``INTER_LINEAR`` (reference cvfunctional.py:744-865).  It gathers the
four taps from the flattened image with the JAX code's clamp, in-bounds
mask and fill (``F.grid_sample`` rounds and treats borders otherwise).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .codec import center_crop, resize_bilinear  # re-exported pipeline stages

__all__ = [
    "resize", "rescale", "center_crop", "random_crop", "pad",
    "hflip", "vflip", "random_hflip", "random_vflip",
    "color_jitter", "grayscale",
    "rotate", "affine", "perspective",
    "random_rotation", "random_affine", "random_perspective",
    "gaussian_noise", "salt_pepper_noise",
    "compose",
]

F32 = torch.float32


def _uniform(generator, shape, lo=0.0, hi=1.0) -> torch.Tensor:
    """U(lo, hi) float32 of ``shape`` on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _batch(v, B: int, device, tail=()) -> torch.Tensor:
    """A scalar, array or tensor parameter broadcast to (B, *tail) float32
    on ``device``."""
    return torch.as_tensor(v, dtype=F32, device=device).expand(B, *tail)


# ---------------------------------------------------------------------------
# sizing


def resize(x: torch.Tensor, size: int | tuple[int, int]) -> torch.Tensor:
    """Resize to ``size`` (an int is a square, not a shorter side)."""
    if isinstance(size, int):
        size = (size, size)
    return resize_bilinear(x, size[0], size[1])


def rescale(x: torch.Tensor, factor: float) -> torch.Tensor:
    """Scale H and W by ``factor`` (reference cvtransforms Rescale)."""
    h = int(round(x.shape[-3] * factor))
    w = int(round(x.shape[-2] * factor))
    return resize_bilinear(x, h, w)


def pad(x: torch.Tensor, padding: int, fill: float = 0.0) -> torch.Tensor:
    p = padding
    return F.pad(x, (0, 0, p, p, p, p), value=fill)


def draw_crop(generator, B: int, H: int, W: int, size: int):
    """Per-image (top, left) of a size x size crop, uniform over an
    H x W (already padded) image: int64 (B,) each."""
    dev = generator.device
    top = torch.randint(0, H - size + 1, (B,), generator=generator,
                        device=dev)
    left = torch.randint(0, W - size + 1, (B,), generator=generator,
                         device=dev)
    return top, left


def crop(x: torch.Tensor, top, left, size: int) -> torch.Tensor:
    """The size x size crop of each image at its (top, left)."""
    dev = x.device
    top, left = (torch.as_tensor(t, device=dev).long() for t in (top, left))
    r = torch.arange(size, device=dev)
    b = torch.arange(x.shape[0], device=dev)[:, None, None]
    return x[b, (top[:, None] + r)[:, :, None], (left[:, None] + r)[:, None]]


def random_crop(generator, x: torch.Tensor, size: int,
                padding: int = 0) -> torch.Tensor:
    """Batched RandomCrop (reference cvtransforms RandomCrop): optional
    zero padding then a uniform-position size x size crop per sample."""
    if padding:
        x = pad(x, padding)
    B, H, W, _ = x.shape
    return crop(x, *draw_crop(generator, B, H, W, size), size)


# ---------------------------------------------------------------------------
# flips


def hflip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-2)


def vflip(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-3)


def draw_flags(generator, B: int, p: float) -> torch.Tensor:
    """(B,) bool, each True with probability p."""
    return _uniform(generator, (B,)) < p


def where_flagged(flags, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y for the images whose flag is set, x for the others."""
    flags = torch.as_tensor(flags, device=x.device).reshape(-1, 1, 1, 1)
    return torch.where(flags, y, x)


def random_hflip(generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    return where_flagged(draw_flags(generator, x.shape[0], p), hflip(x), x)


def random_vflip(generator, x: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    return where_flagged(draw_flags(generator, x.shape[0], p), vflip(x), x)


# ---------------------------------------------------------------------------
# photometric


def grayscale(x: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    """ITU-R 601 luma (reference cvfunctional to_grayscale)."""
    g = (0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])[..., None]
    return g.repeat_interleave(3, dim=-1) if keep_channels else g


# YIQ and its inverse: the hue turn rotates the chroma (I, Q) about the
# gray axis
_TO_YIQ = ((0.299, 0.596, 0.211), (0.587, -0.274, -0.523),
           (0.114, -0.322, 0.312))
_FROM_YIQ = ((1.0, 1.0, 1.0), (0.956, -0.272, -1.106),
             (0.621, -0.647, 1.703))


def draw_color_jitter(generator, B: int, brightness: float = 0.0,
                      contrast: float = 0.0, saturation: float = 0.0,
                      hue: float = 0.0):
    """The factors of :func:`jitter_colors`: brightness, contrast and
    saturation U(max(0, 1 - a), 1 + a) and the hue turn U(-h, h) (of a
    full turn), each (B,), or None where its strength is 0."""
    def factor(a):
        return _uniform(generator, (B,), max(0.0, 1 - a), 1 + a) if a else None
    fb, fc, fs = factor(brightness), factor(contrast), factor(saturation)
    turn = _uniform(generator, (B,), -hue, hue) if hue else None
    return fb, fc, fs, turn


def jitter_colors(x: torch.Tensor, brightness=None, contrast=None,
                  saturation=None, hue=None, lo: float = 0.0,
                  hi: float = 255.0) -> torch.Tensor:
    """ColorJitter for given (B,) factors (None skips a stage): brightness
    scales, contrast and saturation blend with the mean luma and the luma,
    hue turns the YIQ chroma by ``hue`` of a full turn; then a clip to
    [lo, hi]."""
    dev = x.device

    def col(v):
        return torch.as_tensor(v, dtype=F32, device=dev).reshape(-1, 1, 1, 1)

    if brightness is not None:
        x = x * col(brightness)
    if contrast is not None:
        mean = grayscale(x, keep_channels=False).mean(dim=(1, 2),
                                                      keepdim=True)
        x = mean + (x - mean) * col(contrast)
    if saturation is not None:
        g = grayscale(x, keep_channels=False)
        x = g + (x - g) * col(saturation)
    if hue is not None:
        theta = torch.as_tensor(hue, dtype=F32, device=dev).reshape(
            -1, 1, 1) * 2 * math.pi
        cos, sin = torch.cos(theta), torch.sin(theta)
        yiq = torch.einsum("bhwc,cd->bhwd", x,
                           torch.tensor(_TO_YIQ, dtype=F32, device=dev))
        i, q = yiq[..., 1], yiq[..., 2]
        ir = cos * i - sin * q
        qr = sin * i + cos * q
        yiq = torch.stack([yiq[..., 0], ir, qr], dim=-1)
        x = torch.einsum("bhwd,dc->bhwc", yiq,
                         torch.tensor(_FROM_YIQ, dtype=F32, device=dev))
    return torch.clamp(x, lo, hi)


def color_jitter(generator, x: torch.Tensor, brightness: float = 0.0,
                 contrast: float = 0.0, saturation: float = 0.0,
                 hue: float = 0.0, lo: float = 0.0,
                 hi: float = 255.0) -> torch.Tensor:
    """Batched ColorJitter (reference cvtransforms ColorJitter semantics;
    the hue turn matches the effect, not the bit pattern, of the
    reference's HSV round trip)."""
    draws = draw_color_jitter(generator, x.shape[0], brightness, contrast,
                              saturation, hue)
    return jitter_colors(x, *draws, lo=lo, hi=hi)


def draw_normal(generator, shape) -> torch.Tensor:
    """Standard normal float32 of ``shape`` on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device)


def add_noise(x: torch.Tensor, noise, mean: float = 0.0, std: float = 10.0,
              lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """x + mean + std * noise, clipped to [lo, hi]."""
    return torch.clamp(x + mean + std * noise.to(x.device), lo, hi)


def gaussian_noise(generator, x: torch.Tensor, mean: float = 0.0,
                   std: float = 10.0, lo: float = 0.0,
                   hi: float = 255.0) -> torch.Tensor:
    """Additive gaussian noise (reference cvfunctional gaussian_noise,
    cvfunctional.py:866-879)."""
    return add_noise(x, draw_normal(generator, x.shape), mean, std, lo, hi)


def salt_pepper(x: torch.Tensor, u, prob: float = 0.01, lo: float = 0.0,
                hi: float = 255.0) -> torch.Tensor:
    """Salt where u < prob/2, pepper where u > 1 - prob/2, for a uniform
    draw u of shape (B, H, W, 1)."""
    u = u.to(x.device)
    x = torch.where(u < prob / 2, torch.tensor(hi, dtype=x.dtype,
                                               device=x.device), x)
    return torch.where(u > 1 - prob / 2, torch.tensor(lo, dtype=x.dtype,
                                                      device=x.device), x)


def salt_pepper_noise(generator, x: torch.Tensor, prob: float = 0.01,
                      lo: float = 0.0, hi: float = 255.0) -> torch.Tensor:
    """Salt-and-pepper noise (reference cvfunctional.py:880-893): each
    pixel independently becomes ``hi`` with probability prob/2 or ``lo``
    with probability prob/2."""
    u = _uniform(generator, tuple(x.shape[:3]) + (1,))
    return salt_pepper(x, u, prob, lo, hi)


# ---------------------------------------------------------------------------
# geometric warps: one shared inverse-map bilinear sampler


def _warp_bilinear(x: torch.Tensor, inv: torch.Tensor,
                   fill: float = 0.0) -> torch.Tensor:
    """Sample ``x`` (B, H, W, C) through per-sample inverse maps.

    inv: (B, 3, 3) projective matrices taking OUTPUT pixel homogeneous
    coords (col, row, 1) to INPUT coords (cv2's ``WARP_INVERSE_MAP``).
    Out-of-bounds taps read ``fill``."""
    B, H, W, C = x.shape
    dev = x.device
    cols, rows = torch.meshgrid(torch.arange(W, dtype=F32, device=dev),
                                torch.arange(H, dtype=F32, device=dev),
                                indexing="xy")
    grid = torch.stack([cols, rows, torch.ones_like(cols)], dim=-1)
    src = torch.einsum("bij,hwj->bhwi", inv.to(dev, F32), grid)
    den = torch.clamp(torch.abs(src[..., 2]), min=1e-8)
    sgn = torch.sign(src[..., 2])
    sx = src[..., 0] / den * sgn
    sy = src[..., 1] / den * sgn

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    flat = x.reshape(B, H * W, C)
    fill_t = torch.tensor(fill, dtype=x.dtype, device=dev)

    def tap(yi, xi):
        """Clamped lookup + in-bounds mask."""
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(B, H * W, 1).expand(B, H * W, C)
        v = torch.gather(flat, 1, idx).reshape(B, H, W, C)
        return torch.where(inb[..., None], v, fill_t)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def _affine_inverse(angle, translate, scale, shear, cx, cy) -> torch.Tensor:
    """Inverse 3x3 maps of per-sample affine params (B,) (translate (B, 2);
    degrees) about the center (cx, cy): the forward map is
    T(c) R(angle) Shear Scale T(-c) T(translate) (reference
    cvfunctional.py:744-781)."""
    a = torch.deg2rad(angle)
    sh = torch.deg2rad(shear)
    cos_a = torch.cos(a)
    sin_a = torch.sin(a)
    tan_s = torch.tan(sh)
    # R * Shear * S = s * [[cos - sin*tan, -sin], [sin + cos*tan, cos]]
    m00 = scale * (cos_a - sin_a * tan_s)
    m01 = scale * (-sin_a)
    m10 = scale * (sin_a + cos_a * tan_s)
    m11 = scale * cos_a
    det = m00 * m11 - m01 * m10
    i00 = m11 / det
    i01 = -m01 / det
    i10 = -m10 / det
    i11 = m00 / det
    tx, ty = translate[:, 0], translate[:, 1]
    # x_in = A^-1 (x_out - c - t) + c
    ox = cx + tx
    oy = cy + ty
    b0 = cx - (i00 * ox + i01 * oy)
    b1 = cy - (i10 * ox + i11 * oy)
    zeros = torch.zeros_like(angle)
    ones = torch.ones_like(angle)
    return torch.stack([
        torch.stack([i00, i01, b0], -1),
        torch.stack([i10, i11, b1], -1),
        torch.stack([zeros, zeros, ones], -1),
    ], dim=1)


def affine(x: torch.Tensor, angle, translate=(0.0, 0.0), scale=1.0,
           shear=0.0, fill: float = 0.0) -> torch.Tensor:
    """Batched affine warp (reference cvtransforms RandomAffine kernel,
    cvfunctional.py:744-781).  Scalars broadcast over the batch;
    ``translate`` is (2,) or (B, 2) pixels."""
    B, dev = x.shape[0], x.device
    inv = _affine_inverse(
        _batch(angle, B, dev), _batch(translate, B, dev, (2,)),
        _batch(scale, B, dev), _batch(shear, B, dev),
        (x.shape[2] - 1) * 0.5, (x.shape[1] - 1) * 0.5)
    return _warp_bilinear(x, inv, fill)


def rotate(x: torch.Tensor, angle, fill: float = 0.0) -> torch.Tensor:
    """Rotate about the image center by ``angle`` degrees (reference
    cvtransforms RandomRotation kernel)."""
    return affine(x, angle, fill=fill)


def _solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Per-sample 3x3 homography mapping 4 src points to 4 dst points.

    src/dst: (B, 4, 2) in (col, row).  The 8x8 DLT linear system, solved
    batched in float32 (cv2.getPerspectiveTransform's result)."""
    B = src.shape[0]
    one = torch.ones((B,), dtype=src.dtype, device=src.device)
    zero = torch.zeros_like(one)
    rows = []
    for i in range(4):
        xs, ys = src[:, i, 0], src[:, i, 1]
        xd, yd = dst[:, i, 0], dst[:, i, 1]
        rows.append(torch.stack(
            [xs, ys, one, zero, zero, zero, -xd * xs, -xd * ys], -1))
        rows.append(torch.stack(
            [zero, zero, zero, xs, ys, one, -yd * xs, -yd * ys], -1))
    A = torch.stack(rows, dim=1)                              # (B, 8, 8)
    b = torch.stack([dst[:, i // 2, i % 2] for i in range(8)], -1)
    h = torch.linalg.solve(A, b[..., None])[..., 0]           # (B, 8)
    return torch.cat([h, one[:, None]], -1).reshape(B, 3, 3)


def perspective(x: torch.Tensor, startpoints, endpoints,
                fill: float = 0.0) -> torch.Tensor:
    """Batched perspective warp: startpoints -> endpoints, (B, 4, 2) each
    in (col, row) order (reference cvfunctional.py:782-820 semantics)."""
    fwd = _solve_homography(
        torch.as_tensor(startpoints, dtype=F32, device=x.device),
        torch.as_tensor(endpoints, dtype=F32, device=x.device))
    return _warp_bilinear(x, torch.linalg.inv(fwd), fill)


# -- random-parameter wrappers ------------------------------------------------


def random_rotation(generator, x: torch.Tensor, degrees: float,
                    fill: float = 0.0) -> torch.Tensor:
    a = _uniform(generator, (x.shape[0],), -degrees, degrees)
    return rotate(x, a, fill=fill)


def draw_affine(generator, B: int, H: int, W: int, degrees: float = 0.0,
                translate: tuple[float, float] = (0.0, 0.0),
                scale_range: tuple[float, float] = (1.0, 1.0),
                shear: float = 0.0):
    """Reference cvtransforms RandomAffine parameter sampling: (angle (B,),
    translate (B, 2) pixels, scale (B,), shear (B,)) for :func:`affine`."""
    a = _uniform(generator, (B,), -degrees, degrees)
    max_t = torch.tensor([translate[0] * W, translate[1] * H], dtype=F32,
                         device=generator.device)
    t = _uniform(generator, (B, 2), -1.0, 1.0) * max_t
    s = _uniform(generator, (B,), scale_range[0], scale_range[1])
    sh = _uniform(generator, (B,), -shear, shear)
    return a, t, s, sh


def random_affine(generator, x: torch.Tensor, degrees: float = 0.0,
                  translate: tuple[float, float] = (0.0, 0.0),
                  scale_range: tuple[float, float] = (1.0, 1.0),
                  shear: float = 0.0, fill: float = 0.0) -> torch.Tensor:
    B, H, W, _ = x.shape
    return affine(x, *draw_affine(generator, B, H, W, degrees, translate,
                                  scale_range, shear), fill=fill)


def draw_perspective(generator, B: int, H: int, W: int,
                     distortion_scale: float = 0.5, p: float = 0.5):
    """Reference cvtransforms RandomPerspective: (apply (B,) bool, corner
    jitter (B, 4, 2) pixels, each U(0, d/2) of the extent inward)."""
    apply = draw_flags(generator, B, p)
    max_d = torch.tensor([W, H], dtype=F32, device=generator.device) * (
        distortion_scale / 2.0)
    return apply, _uniform(generator, (B, 4, 2)) * max_d


def warp_corners(x: torch.Tensor, apply, jitter,
                 fill: float = 0.0) -> torch.Tensor:
    """The perspective warp that moves the image corners inward by
    ``jitter`` (B, 4, 2) pixels, for the images where ``apply`` is set."""
    B, H, W, _ = x.shape
    jitter = jitter.to(x.device)
    base = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [W - 1.0, H - 1.0],
                         [0.0, H - 1.0]], dtype=F32, device=x.device)
    base = base.expand(B, 4, 2)
    signs = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]], dtype=F32,
                         device=x.device)
    warped = perspective(x, base, base + jitter * signs, fill=fill)
    return where_flagged(apply, warped, x)


def random_perspective(generator, x: torch.Tensor,
                       distortion_scale: float = 0.5, p: float = 0.5,
                       fill: float = 0.0) -> torch.Tensor:
    B, H, W, _ = x.shape
    return warp_corners(x, *draw_perspective(generator, B, H, W,
                                             distortion_scale, p), fill=fill)


# ---------------------------------------------------------------------------


def compose(*fns):
    """Compose transforms left-to-right.  Random transforms are curried
    with their generator by the caller:
    ``compose(partial(random_hflip, g), ...)``."""
    def run(x):
        for f in fns:
            x = f(x)
        return x
    return run
