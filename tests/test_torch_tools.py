"""The port's own tools and plots against the JAX package's:
``tools/circuit_cost.py``'s table from the port's compiler equal to the
JAX tool's printout on the same weights, ``tools/train_rate.py`` on the
trainer of the tree it is given, and ``viz.py``'s sampled
examples and normalized confusion matrix equal to what the JAX
``viz.py`` draws (matplotlib stubbed to capture its calls); the port's
plots are written as PNGs by the functions and by the trainer."""
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct_cryptonets_tpu import viz as JVIZ
from dct_cryptonets_tpu.data import CodecConfig as JCodec
from dct_cryptonets_tpu.data import dct_ingest as jdct_ingest
from dct_cryptonets_tpu.data.pipeline import load_synthetic
from dct_cryptonets_tpu.models import (build_spec, calibrate_scales,
                                       forward, init_model)
from dct_cryptonets_tpu_torch import train as TRAIN
from dct_cryptonets_tpu_torch import viz as VIZ
from dct_cryptonets_tpu_torch.fhe.compiler import lower
from dct_cryptonets_tpu_torch.models.resnet import build_spec as tbuild_spec

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "dct_cryptonets_tpu_torch", "tools")


def load_tool(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAIN_RATE = load_tool(os.path.join(TOOLS, "train_rate.py"), "train_rate")


def test_circuit_cost_table_equals_the_jax_tools(monkeypatch, capsys):
    """The JAX tool at a small config (``--calib --img 8``) against the
    port's ``cost_lines`` of the port's lowering of the same weights and
    calibration batch: every printed line equal."""
    jtool = load_tool(os.path.join(REPO, "tools", "circuit_cost.py"),
                      "jax_circuit_cost")
    monkeypatch.setattr(sys, "argv", ["circuit_cost.py", "--calib", "--img",
                                      "8"])
    jtool.main()
    want = capsys.readouterr().out.rstrip("\n").split("\n")

    # the JAX tool's model and calibration batch, as numpy
    spec = build_spec("ResNet20qat", in_channels=24, img_size=8,
                      num_classes=10, bit_width=4)
    params, state = init_model(jax.random.key(0), spec)
    x = jdct_ingest(jnp.asarray(load_synthetic(64, 64, 10, seed=0).images),
                    JCodec(channels=24, filter_size=4, image_size_dct=8))
    params = calibrate_scales(params, state, x, spec)
    _, _, state = forward(params, state, x, spec, train=True)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    circ = lower(to_np(params), to_np(state),
                 tbuild_spec("ResNet20qat", in_channels=24, img_size=8,
                             num_classes=10, bit_width=4),
                 rounding_threshold_bits=6, calib_data=np.array(x))
    tool = load_tool(os.path.join(TOOLS, "circuit_cost.py"), "circuit_cost")
    got = "\n".join(tool.cost_lines(circ)).split("\n")
    assert got == want
    assert len(got) > 20


class Recorder:
    """Stand-ins for ``matplotlib`` and ``matplotlib.pyplot`` that record
    what the JAX ``viz`` functions draw."""

    def __init__(self):
        self.calls = []
        plt = types.ModuleType("matplotlib.pyplot")
        for name in ("figure", "colorbar", "xticks", "yticks",
                     "tight_layout", "close"):
            setattr(plt, name, lambda *a, **k: None)
        plt.subplot = lambda *a: self
        plt.imshow = lambda m, **k: self.calls.append(("imshow",
                                                       np.array(m)))
        plt.text = lambda j, i, s, **k: self.calls.append(
            ("text", (i, j, s, k["color"])))
        plt.savefig = lambda path, **k: self.calls.append(("savefig", path))
        mpl = types.ModuleType("matplotlib")
        mpl.use = lambda *a: None
        mpl.pyplot = plt
        self.modules = {"matplotlib": mpl, "matplotlib.pyplot": plt}

    # the axes of plt.subplot
    def imshow(self, img):
        self.calls.append(("imshow", np.array(img)))

    def set_title(self, title, **kw):
        self.calls.append(("title", title))

    def axis(self, *a):
        pass

    def of(self, kind):
        return [v for k, v in self.calls if k == kind]


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    for name, mod in rec.modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return rec


@pytest.mark.parametrize("n,shape", [(40, (12, 10, 3)), (9, (8, 8))])
def test_plot_examples_draws_the_jax_panels(recorder, tmp_path, n, shape):
    rng = np.random.default_rng(n)
    images = rng.integers(0, 256, (n,) + shape).astype(np.uint8)
    labels = rng.integers(0, 4, n)
    classes = ["cat", "dog", "ship", "frog"]
    JVIZ.plot_examples(str(tmp_path), images, labels, classes)
    panels = VIZ.example_panels(images, labels, classes)
    assert len(panels) == min(16, n)
    assert [t for _, t in panels] == recorder.of("title")
    for (img, _), want in zip(panels, recorder.of("imshow")):
        np.testing.assert_array_equal(img, want)
    path = VIZ.plot_examples(str(tmp_path), images, labels, classes)
    assert path == os.path.join(str(tmp_path), "example_images.png")
    from PIL import Image
    with Image.open(path) as im:
        assert im.size[0] > 0 and im.mode == "RGB"


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_heatmap_draws_the_jax_matrix(recorder, tmp_path, seed):
    rng = np.random.default_rng(seed)
    classes = [f"c{i}" for i in range(5)]
    y_true = rng.integers(0, 5, 50 * (seed + 1))
    y_pred = np.where(rng.random(len(y_true)) < 0.6, y_true,
                      rng.integers(0, 5, len(y_true)))
    JVIZ.confusion_heatmap(str(tmp_path), y_true, y_pred, classes)
    mat = VIZ.confusion_matrix(y_true, y_pred, len(classes))
    (want,) = recorder.of("imshow")
    np.testing.assert_array_equal(mat, want)
    assert recorder.of("text") == [
        (i, j, f"{mat[i, j]:.2f}",
         "white" if mat[i, j] < mat.max() / 2 else "black")
        for i in range(5) for j in range(5)]
    path = VIZ.confusion_heatmap(str(tmp_path), y_true, y_pred, classes)
    assert path == os.path.join(str(tmp_path), "heatmap.png")
    from PIL import Image
    with Image.open(path) as im:
        assert im.mode == "RGB"


def test_trainer_writes_both_plots_on_the_rgb_path(tmp_path):
    """The RGB path of a synthetic run writes the example grid and the
    confusion heatmap, where the JAX trainer plots them."""
    d = str(tmp_path / "rgb")
    res = TRAIN.main(["--dataset", "synthetic", "--synthetic_size", "160",
                      "--model", "ResNet20qat", "--image_size", "32",
                      "--batch_size", "32", "--test_batch_size", "40",
                      "--stop_epoch", "1", "--device", "cpu",
                      "--checkpoint_dir", d])
    assert res["steps"] == 144 // 32
    assert {"example_images.png", "heatmap.png"} <= set(os.listdir(d))


def test_train_rate_times_the_trainer_of_the_tree_it_is_given(tmp_path):
    """``tools/train_rate.py --tree DIR`` runs the flagship recipe through
    DIR's trainer (a stub here, in a process of its own, as the tool runs)
    and prints its rate from the summary ``train.main`` returns."""
    tree = tmp_path / "tree"
    (tree / "dct_cryptonets_tpu_torch").mkdir(parents=True)
    (tree / "benchmark").mkdir()
    (tree / "dct_cryptonets_tpu_torch" / "__init__.py").write_text("")
    (tree / "benchmark" / "__init__.py").write_text("")
    (tree / "benchmark" / "common.py").write_text(
        "def card_line():\n    return 'stub card, 1.00 W'\n")
    (tree / "dct_cryptonets_tpu_torch" / "train.py").write_text(
        "def main(argv):\n"
        "    print('ARGV', ' '.join(argv))\n"
        "    return {'steps': 30, 'epochs': 3, 'epoch_s': [4.0, 1.0, 1.0],\n"
        "            'best_val': 90.0, 'test_top1': 91.0}\n")
    res = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "train_rate.py"), "--tree",
         str(tree), "--epochs", "3", "--cpu"], capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    argv = next(x for x in lines if x.startswith("ARGV ")).split()[1:]
    assert argv[:argv.index("--stop_epoch")] == TRAIN_RATE.RECIPE
    assert argv[argv.index("--stop_epoch") + 1] == "3"
    assert argv[argv.index("--device") + 1] == "cpu"
    assert lines[-2] == "stub card, 1.00 W"
    out = json.loads(lines[-1].removeprefix("TRAIN_RATE: "))
    assert out["tree"] == str(tree) and out["steps"] == 30
    assert out["steps_per_s"] == 5.0 and out["steps_per_s_after_first"] == 10.0
    assert (out["best_val"], out["test_top1"]) == (90.0, 91.0)
