"""The port's batched transforms (``data/transforms.py``) against the JAX
package's, and the checks of ``tests/test_transforms.py`` on the port.

Each random transform of the port is a draw and a deterministic function
of it.  The deterministic halves are fed the draws the JAX functions make
from a key (re-derived with ``jax.random`` as the JAX code derives them)
and held against the JAX function of that key.

Tolerances, on the 0-255 scale: flips, crops, padding, the luma and
salt-and-pepper are bit for bit; the resizes and the color jitter sum
float32 terms in another order, and the affine warps take cos, sin and tan
from another library, an ulp or two off in the sample positions (atol
1e-3, a few hundred ulps of 255); the perspective warp inverts its
homography with another LAPACK routine, whose float32 error the 8x8
system's conditioning carries into the sample positions (atol 1e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_cryptonets_tpu.data import transforms as J
from dct_cryptonets_tpu_torch.data import transforms as T

torch.set_num_threads(1)

ATOL = {"exact": 0.0, "float": 1e-3, "perspective": 1e-2}


def images(seed, B=3, H=20, W=24):
    return (np.random.default_rng(seed).random((B, H, W, 3)) * 255).astype(
        np.float32)


def check(got, want, tol):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL[tol])


def corners(B, H, W, seed, spread=3.0):
    base = np.broadcast_to(np.array(
        [[0, 0], [W - 1.0, 0], [W - 1.0, H - 1.0], [0, H - 1.0]],
        np.float32), (B, 4, 2)).copy()
    end = base + np.random.default_rng(seed).uniform(
        -spread, spread, (B, 4, 2)).astype(np.float32)
    return base, end


def per_sample(seed, B):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-30, 30, B).astype(np.float32),
            rng.uniform(-3, 3, (B, 2)).astype(np.float32),
            rng.uniform(0.8, 1.2, B).astype(np.float32),
            rng.uniform(-10, 10, B).astype(np.float32))


DETERMINISTIC = {
    "resize": (lambda m, x: m.resize(x, 13), "float"),
    "resize_hw": (lambda m, x: m.resize(x, (31, 17)), "float"),
    "rescale": (lambda m, x: m.rescale(x, 0.5), "float"),
    "center_crop": (lambda m, x: m.center_crop(x, 11), "exact"),
    "pad": (lambda m, x: m.pad(x, 3, 7.0), "exact"),
    "hflip": (lambda m, x: m.hflip(x), "exact"),
    "vflip": (lambda m, x: m.vflip(x), "exact"),
    "grayscale": (lambda m, x: m.grayscale(x), "exact"),
    "grayscale_1ch": (lambda m, x: m.grayscale(x, keep_channels=False),
                      "exact"),
    "rotate": (lambda m, x: m.rotate(x, 30.0, fill=9.0), "float"),
    "affine_scalars": (lambda m, x: m.affine(x, 12.0, (2.5, -1.0), 1.1, 4.0),
                       "float"),
    "affine_per_sample": (lambda m, x: m.affine(x, *per_sample(5, 3),
                                                fill=5.0), "float"),
    "perspective": (lambda m, x: m.perspective(x, *corners(3, 20, 24, 6)),
                    "perspective"),
    "compose": (lambda m, x: m.compose(m.hflip, lambda y: m.rotate(y, 10.0),
                                       lambda y: m.pad(y, 1))(x), "float"),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_transform_matches_jax(name):
    fn, tol = DETERMINISTIC[name]
    x = images(1)
    check(fn(T, torch.as_tensor(x)), fn(J, jnp.asarray(x)), tol)


def test_homography_matches_jax():
    base, end = corners(4, 448, 448, 7, spread=60.0)
    got = T._solve_homography(torch.as_tensor(base), torch.as_tensor(end))
    want = J._solve_homography(jnp.asarray(base), jnp.asarray(end))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


# -- the random wrappers: the JAX draws of a key, fed to the port ------------


def jax_random(name, key, x):
    """(the JAX random transform of ``key``, the port's output from the
    same draws)."""
    B, H, W, _ = x.shape
    jx, tx = jnp.asarray(x), torch.as_tensor(x)

    def t(a):
        return torch.as_tensor(np.array(a))

    if name == "random_crop":
        ky, kx = jax.random.split(key)
        top = jax.random.randint(ky, (B,), 0, H + 4 - 9 + 1)
        left = jax.random.randint(kx, (B,), 0, W + 4 - 9 + 1)
        return (J.random_crop(key, jx, 9, padding=2),
                T.crop(T.pad(tx, 2), t(top), t(left), 9))
    if name in ("random_hflip", "random_vflip"):
        flags = t(jax.random.bernoulli(key, 0.5, (B, 1, 1, 1)))
        flip = T.hflip if name == "random_hflip" else T.vflip
        return (getattr(J, name)(key, jx),
                T.where_flagged(flags.reshape(B), flip(tx), tx))
    if name == "color_jitter":
        kb, kc, ks, kh = jax.random.split(key, 4)
        f = [t(jax.random.uniform(k, (B, 1, 1, 1), minval=0.6,
                                  maxval=1.4)).reshape(B)
             for k in (kb, kc, ks)]
        hue = t(jax.random.uniform(kh, (B, 1, 1), minval=-0.1, maxval=0.1))
        return (J.color_jitter(key, jx, 0.4, 0.4, 0.4, 0.1),
                T.jitter_colors(tx, *f, hue.reshape(B)))
    if name == "gaussian_noise":
        noise = t(jax.random.normal(key, x.shape))
        return (J.gaussian_noise(key, jx, 1.0, 5.0),
                T.add_noise(tx, noise, 1.0, 5.0))
    if name == "salt_pepper_noise":
        ku, _ = jax.random.split(key)
        u = t(jax.random.uniform(ku, (B, H, W, 1)))
        return (J.salt_pepper_noise(key, jx, 0.2),
                T.salt_pepper(tx, u, 0.2))
    if name == "random_rotation":
        a = t(jax.random.uniform(key, (B,), minval=-20.0, maxval=20.0))
        return J.random_rotation(key, jx, 20.0), T.rotate(tx, a)
    if name == "random_affine":
        ka, kt, ks, kh = jax.random.split(key, 4)
        a = jax.random.uniform(ka, (B,), minval=-10.0, maxval=10.0)
        tr = jax.random.uniform(kt, (B, 2), minval=-1.0, maxval=1.0) * \
            jnp.asarray([0.1 * W, 0.1 * H], jnp.float32)
        s = jax.random.uniform(ks, (B,), minval=0.9, maxval=1.1)
        sh = jax.random.uniform(kh, (B,), minval=-5.0, maxval=5.0)
        return (J.random_affine(key, jx, 10.0, (0.1, 0.1), (0.9, 1.1), 5.0),
                T.affine(tx, t(a), t(tr), t(s), t(sh)))
    if name == "random_perspective":
        kp, kd = jax.random.split(key)
        jitter = jax.random.uniform(kd, (B, 4, 2)) * jnp.asarray(
            [W, H], jnp.float32) * (0.3 / 2.0)
        apply = t(jax.random.bernoulli(kp, 0.5, (B, 1, 1, 1))).reshape(B)
        return (J.random_perspective(key, jx, 0.3, p=0.5),
                T.warp_corners(tx, apply, t(jitter)))
    raise KeyError(name)


RANDOM_TOL = {"random_crop": "exact", "random_hflip": "exact",
              "random_vflip": "exact", "color_jitter": "float",
              "gaussian_noise": "float", "salt_pepper_noise": "exact",
              "random_rotation": "float", "random_affine": "float",
              "random_perspective": "perspective"}


@pytest.mark.parametrize("name", sorted(RANDOM_TOL))
def test_random_transform_on_the_jax_draws_matches_jax(name):
    want, got = jax_random(name, jax.random.key(11), images(2, B=6))
    check(got, want, RANDOM_TOL[name])


def test_draws_repeat_from_a_seed_within_their_ranges():
    """A seed repeats its draws; each draw has the documented range."""
    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (T.draw_crop(g, 64, 20, 24, 9), T.draw_flags(g, 64, 0.3),
                T.draw_color_jitter(g, 64, 0.4, 0.2, 0.0, 0.1),
                T.draw_affine(g, 64, 20, 24, 10.0, (0.1, 0.2), (0.9, 1.1),
                              5.0),
                T.draw_perspective(g, 64, 20, 24, 0.3, 0.5))
    a, b = run(3), run(3)
    flat = lambda d: [v for v in jax.tree_util.tree_leaves(d)  # noqa: E731
                      if isinstance(v, torch.Tensor)]
    for u, v in zip(flat(a), flat(b)):
        assert torch.equal(u, v)
    (top, left), flags, (fb, fc, fs, hue), (ang, tr, sc, sh), (ap, jit) = a
    assert top.max() <= 11 and left.max() <= 15 and top.min() >= 0
    assert flags.dtype == torch.bool and fs is None
    assert 0.6 <= fb.min() and fb.max() <= 1.4 and 0.8 <= fc.min()
    assert hue.abs().max() <= 0.1 and ang.abs().max() <= 10.0
    assert tr[:, 0].abs().max() <= 2.4 and tr[:, 1].abs().max() <= 4.0
    assert 0.9 <= sc.min() and sc.max() <= 1.1 and sh.abs().max() <= 5.0
    assert ap.dtype == torch.bool and jit.shape == (64, 4, 2)
    assert jit[..., 0].max() <= 24 * 0.15 and jit[..., 1].max() <= 20 * 0.15


# -- the checks of tests/test_transforms.py, on the port ----------------------


def _np_warp(img, inv, fill=0.0):
    """Reference inverse-map bilinear warp; img (H, W, C), inv (3, 3)."""
    H, W, C = img.shape
    out = np.full((H, W, C), fill, np.float64)
    for r in range(H):
        for c in range(W):
            x, y, w = inv @ np.array([c, r, 1.0])
            x, y = x / w, y / w
            x0, y0 = int(np.floor(x)), int(np.floor(y))
            fx, fy = x - x0, y - y0
            acc = np.zeros(C)
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    yy, xx = y0 + dy, x0 + dx
                    v = (img[yy, xx] if 0 <= yy < H and 0 <= xx < W
                         else np.full(C, fill))
                    acc += wy * wx * v
            out[r, c] = acc
    return out


def rand_img(seed, n=2, size=12):
    return torch.as_tensor(images(seed, n, size, size))


def test_rotate_matches_numpy():
    img = rand_img(0, n=1)
    got = T.rotate(img, 30.0)[0].numpy()
    a = np.deg2rad(30.0)
    c = (img.shape[1] - 1) / 2
    ca, sa = np.cos(a), np.sin(a)
    inv = np.array([[ca, sa, c - ca * c - sa * c],
                    [-sa, ca, c + sa * c - ca * c], [0, 0, 1.0]])
    np.testing.assert_allclose(got, _np_warp(img[0].double().numpy(), inv),
                               atol=1e-2)


def test_rotate_360_identity():
    img = rand_img(1)
    got = T.rotate(img, 360.0)
    np.testing.assert_allclose(got[:, 2:-2, 2:-2], img[:, 2:-2, 2:-2],
                               atol=1e-2)


def test_affine_translate_identity_and_scale():
    img = rand_img(2)
    got = T.affine(img, 0.0, translate=(3.0, 2.0)).numpy()
    want = np.zeros_like(got)
    want[:, 2:, 3:] = img.numpy()[:, :-2, :-3]
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(T.affine(img, 0.0), img, atol=1e-3)
    up, src, f = T.affine(img, 0.0, scale=2.0).numpy(), img.numpy(), 0.75
    want = ((1 - f) * (1 - f) * src[:, 5, 5] + (1 - f) * f * src[:, 5, 6]
            + f * (1 - f) * src[:, 6, 5] + f * f * src[:, 6, 6])
    np.testing.assert_allclose(up[:, 6, 6], want, atol=1e-2)


def test_perspective_identity_and_numpy():
    img = rand_img(4, n=1)
    base, end = corners(1, 12, 12, 0, spread=0.0)
    np.testing.assert_allclose(T.perspective(img, base, base), img,
                               atol=1e-2)
    end = base + np.array([[[1.0, 0.5], [-1.0, 0.5], [-0.5, -1.0],
                            [0.5, -1.0]]], np.float32)
    got = T.perspective(img, base, end)[0].numpy()
    fwd = T._solve_homography(torch.as_tensor(base),
                              torch.as_tensor(end))[0].double().numpy()
    want = _np_warp(img[0].double().numpy(), np.linalg.inv(fwd))
    np.testing.assert_allclose(got, want, atol=0.5)


def test_homography_maps_corners():
    g = torch.Generator().manual_seed(5)
    src = torch.rand((3, 4, 2), generator=g) * 10
    dst = src + torch.randn((3, 4, 2), generator=g)
    Hm = T._solve_homography(src, dst)
    pts = torch.cat([src, torch.ones((3, 4, 1))], -1)
    mapped = torch.einsum("bij,bpj->bpi", Hm, pts)
    np.testing.assert_allclose(mapped[..., :2] / mapped[..., 2:], dst,
                               atol=1e-3)


@pytest.mark.parametrize("fn", [
    lambda g, x: T.random_rotation(g, x, 15.0),
    lambda g, x: T.random_affine(g, x, 10.0, (0.1, 0.1), (0.9, 1.1), 5.0),
    lambda g, x: T.random_perspective(g, x, 0.3, p=1.0)],
    ids=["rotation", "affine", "perspective"])
def test_random_wrappers_shapes_and_bounds(fn):
    img = rand_img(7, n=4)
    out = fn(torch.Generator().manual_seed(8), img)
    assert out.shape == img.shape and bool(torch.isfinite(out).all())


def test_color_jitter_ranges_and_identity():
    img = rand_img(9, n=8)
    out = T.color_jitter(torch.Generator().manual_seed(10), img, 0.4, 0.4,
                         0.4, 0.1)
    assert out.shape == img.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 255.0
    same = T.color_jitter(torch.Generator().manual_seed(11), img)
    np.testing.assert_allclose(same, img, atol=1e-4)


def test_hue_preserves_luma():
    img = rand_img(12) * 0.2 + 100
    out = T.color_jitter(torch.Generator().manual_seed(13), img, hue=0.2)
    np.testing.assert_allclose(T.grayscale(out, keep_channels=False),
                               T.grayscale(img, keep_channels=False),
                               atol=1.5)


def test_gaussian_noise_stats():
    img = torch.full((2, 64, 64, 3), 128.0)
    d = T.gaussian_noise(torch.Generator().manual_seed(14), img,
                         std=5.0) - 128.0
    assert abs(float(d.mean())) < 0.5 and abs(float(d.std()) - 5.0) < 0.5


def test_salt_pepper_fraction():
    img = torch.full((2, 128, 128, 3), 100.0)
    out = T.salt_pepper_noise(torch.Generator().manual_seed(15), img,
                              prob=0.1)
    frac_salt = float((out == 255.0).all(-1).float().mean())
    frac_pepper = float((out == 0.0).all(-1).float().mean())
    assert 0.03 < frac_salt < 0.07 and 0.03 < frac_pepper < 0.07


def test_random_crop_content():
    img = rand_img(16, n=3, size=16)
    out = T.random_crop(torch.Generator().manual_seed(17), img, 8)
    assert out.shape == (3, 8, 8, 3)
    for b in range(3):
        assert any(torch.equal(img[b, t:t + 8, l:l + 8], out[b])
                   for t in range(9) for l in range(9))


def test_flips_and_rescale():
    img = rand_img(18)
    assert torch.equal(T.hflip(T.hflip(img)), img)
    assert torch.equal(T.vflip(T.vflip(img)), img)
    assert T.rescale(img, 0.5).shape == (2, 6, 6, 3)
    g = torch.Generator().manual_seed(19)
    assert torch.equal(T.random_hflip(g, img, p=0.0), img)
    assert torch.equal(T.random_vflip(g, img, p=1.0), T.vflip(img))


def test_composed_pipeline():
    """A composed augmentation runs on one generator and repeats from its
    seed."""
    def pipe(seed, x):
        g = torch.Generator().manual_seed(seed)
        return T.compose(lambda y: T.random_hflip(g, y),
                         lambda y: T.random_rotation(g, y, 10.0),
                         lambda y: T.gaussian_noise(g, y, std=2.0))(x)

    img = rand_img(20, n=4, size=16)
    out = pipe(21, img)
    assert out.shape == img.shape and torch.equal(out, pipe(21, img))
    assert not torch.equal(out, pipe(22, img))
