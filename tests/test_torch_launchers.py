"""The port's launchers (``scripts/run_train_torch.sh``,
``scripts/run_homomorphic_eval_torch.sh``) start the port's modules with
the JAX launchers' per-model presets: each launcher runs with a stand-in
``python`` first on ``PATH`` that records its arguments, and the port's
argument list must equal the JAX launcher's but for the module name."""
import os
import stat
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"train": ("run_train.sh", "run_train_torch.sh"),
         "homomorphic_eval": ("run_homomorphic_eval.sh",
                              "run_homomorphic_eval_torch.sh")}
# (MODEL, DATASET) -> the per-model flags both launchers must pass
PRESETS = {
    ("ResNet20qat", "cifar10"): {"--filter_size": "4", "--channels": "24",
                                 "--image_size_dct": "16",
                                 "--bit_width": "4"},
    ("ResNet18qat", "cifar10"): {"--filter_size": "8", "--channels": "64",
                                 "--image_size_dct": "56",
                                 "--bit_width": "4"},
    ("ResNet18qat", "ImageNet"): {"--filter_size": "8", "--channels": "64",
                                  "--image_size_dct": "56",
                                  "--bit_width": "5"},
}
ROUNDING = {"cifar10": "6", "ImageNet": "7"}


def launch(script, tmp_path, model, dataset):
    shim = tmp_path / "python"
    shim.write_text('#!/bin/sh\nfor a in "$@"; do echo "$a"; done\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{tmp_path}:{os.environ['PATH']}",
               MODEL=model, DATASET=dataset)
    res = subprocess.run(["bash", os.path.join(REPO, "scripts", script),
                          "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout.splitlines()


@pytest.mark.parametrize("model,dataset", list(PRESETS))
@pytest.mark.parametrize("entry", list(PAIRS))
def test_launcher_starts_the_port_with_the_jax_presets(tmp_path, entry,
                                                       model, dataset):
    jax_args = launch(PAIRS[entry][0], tmp_path, model, dataset)
    args = launch(PAIRS[entry][1], tmp_path, model, dataset)
    assert args[:2] == ["-m", f"dct_cryptonets_tpu_torch.{entry}"]
    assert jax_args[:2] == ["-m", f"dct_cryptonets_tpu.{entry}"]
    assert args[2:] == jax_args[2:]
    flags = dict(zip(args[2:], args[3:]))
    want = dict(PRESETS[(model, dataset)], **{"--model": model,
                                              "--dataset": dataset})
    if entry == "homomorphic_eval":
        want["--rounding_threshold_bits"] = ROUNDING[dataset]
    assert {k: flags[k] for k in want} == want
    assert args[-2:] == ["--device", "cpu"]
