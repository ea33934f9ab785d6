"""Plot artifacts: the example-image grid and the confusion-matrix heatmap,
counterpart of ``dct_cryptonets_tpu.viz`` (reference utils.py:141-184,
``plot_examples`` and ``pred_classes``), written into the checkpoint
directory.

The JAX package draws them with matplotlib; this package draws them with
Pillow, imported at the first call, so a machine without matplotlib
writes them too.  What is drawn is the JAX package's: the same sampled
examples (:func:`example_panels`) and the same normalized matrix
(:func:`confusion_matrix`), with its values written in each cell.
"""
import os

import numpy as np

# matplotlib's viridis at 0, 0.1, ..., 1 (the JAX heatmap's colormap)
_VIRIDIS = np.array([
    (68, 1, 84), (72, 36, 117), (65, 68, 135), (53, 95, 141),
    (42, 120, 142), (33, 145, 140), (34, 168, 132), (68, 191, 112),
    (122, 209, 81), (189, 223, 38), (253, 231, 37)], np.float64)


def example_panels(images: np.ndarray, labels: np.ndarray, classes,
                   k: int = 16, seed: int = 0) -> list:
    """[(image scaled to [0, 1] as float32, title)] of ``k`` examples
    sampled without replacement by ``np.random.default_rng(seed)``: the
    JAX ``plot_examples``' panels."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(images), size=min(k, len(images)), replace=False)
    out = []
    for j in idx:
        img = images[j].astype(np.float32)
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        out.append((img, f"Class : {classes[labels[j]]}"))
    return out


def confusion_matrix(y_true, y_pred, n: int) -> np.ndarray:
    """(n, n) counts of (true, predicted) pairs over their sum, times 10
    (the JAX ``confusion_heatmap``'s matrix)."""
    mat = np.zeros((n, n))
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        mat[t, p] += 1
    return mat / max(mat.sum(), 1) * 10


def _pil():
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError as e:
        raise ImportError("the plots need Pillow (pip install pillow)") from e
    return Image, ImageDraw, ImageFont


def _rgb(img: np.ndarray) -> np.ndarray:
    """A [0, 1] image as uint8 RGB; a single channel through viridis, as
    ``imshow`` colors it."""
    if img.ndim == 3 and img.shape[-1] == 3:
        return np.round(img * 255).astype(np.uint8)
    return _viridis(img.reshape(img.shape[:2]))


def _viridis(v: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> uint8 RGB by linear steps between the anchors."""
    x = np.clip(v, 0.0, 1.0) * (len(_VIRIDIS) - 1)
    i = np.minimum(x.astype(int), len(_VIRIDIS) - 2)
    f = (x - i)[..., None]
    return np.round(_VIRIDIS[i] * (1 - f) + _VIRIDIS[i + 1] * f).astype(
        np.uint8)


def plot_examples(ckpt_dir: str, images: np.ndarray, labels: np.ndarray,
                  classes, k: int = 16, seed: int = 0) -> str:
    """Save a 4x4 grid of training examples (reference utils.py:141-156)
    as ``example_images.png``; returns its path."""
    Image, ImageDraw, ImageFont = _pil()
    cell, title_h = 480, 40
    font = ImageFont.load_default(size=24)
    sheet = Image.new("RGB", (4 * cell, 4 * (cell + title_h)), "white")
    draw = ImageDraw.Draw(sheet)
    for i, (img, title) in enumerate(example_panels(images, labels, classes,
                                                    k, seed)):
        x0, y0 = (i % 4) * cell, (i // 4) * (cell + title_h)
        pic = Image.fromarray(_rgb(img)).resize((cell - 20, cell - 20),
                                                Image.NEAREST)
        sheet.paste(pic, (x0 + 10, y0 + title_h))
        draw.text((x0 + cell // 2, y0 + title_h // 2), title, fill="black",
                  font=font, anchor="mm")
    out = os.path.join(ckpt_dir, "example_images.png")
    sheet.save(out)
    return out


def confusion_heatmap(ckpt_dir: str, y_true, y_pred, classes) -> str:
    """Save the normalized confusion-matrix heatmap (reference
    utils.py:159-184) as ``heatmap.png``: one cell per (true, predicted)
    pair colored by viridis and labelled with its value, the class names
    on both axes and a color bar; returns its path."""
    Image, ImageDraw, ImageFont = _pil()
    n = len(classes)
    mat = confusion_matrix(y_true, y_pred, n)
    cell, margin, bar, top = 90, 260, 40, 30
    font = ImageFont.load_default(size=20)
    side = n * cell
    sheet = Image.new("RGB", (margin + side + 3 * bar + 80,
                              top + side + margin // 2), "white")
    draw = ImageDraw.Draw(sheet)
    peak = mat.max()
    for i in range(n):
        for j in range(n):
            x0, y0 = margin + j * cell, top + i * cell
            color = tuple(int(c) for c in _viridis(mat[i, j] / max(peak,
                                                                  1e-12)))
            draw.rectangle((x0, y0, x0 + cell, y0 + cell), fill=color)
            draw.text((x0 + cell // 2, y0 + cell // 2), f"{mat[i, j]:.2f}",
                      font=font, anchor="mm",
                      fill="white" if mat[i, j] < peak / 2 else "black")
    for c, name in enumerate(classes):
        draw.text((margin - 10, top + c * cell + cell // 2), str(name),
                  font=font, anchor="rm", fill="black")
        label = Image.new("RGBA", (margin - 20, 30), (255, 255, 255, 0))
        ImageDraw.Draw(label).text((margin - 20, 15), str(name), font=font,
                                   anchor="rm", fill="black")
        label = label.rotate(45, expand=True)
        sheet.paste(label, (margin + c * cell + cell // 2 - label.width,
                            top + side + 5), label)
    ramp = _viridis(np.linspace(1.0, 0.0, side))[:, None, :]
    x_bar = margin + side + bar
    sheet.paste(Image.fromarray(np.repeat(ramp, bar, axis=1)), (x_bar, top))
    for v in np.linspace(0.0, peak, 5):
        y = top + int(round((1 - v / max(peak, 1e-12)) * (side - 1)))
        draw.text((x_bar + bar + 6, y), f"{v:.2f}", font=font, anchor="lm",
                  fill="black")
    out = os.path.join(ckpt_dir, "heatmap.png")
    sheet.save(out)
    return out
