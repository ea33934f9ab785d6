"""The port's training half against the JAX package: the fake-quant op and
its gradients, ``init_model``, the train-mode forward with its BatchNorm
state and gradients, calibration, post-training quantization, the summary,
the optimizers and clipping against optax, checkpoints, the trainer's CLI
and its resume behaviour.

Tolerances: the fake-quant forward and its input gradient are bit for bit;
its scale gradient is a sum taken in another order (rtol 1e-5).  The
train-mode forward normalizes with batch statistics that torch and XLA
reduce in other orders, so activations, BatchNorm state and gradients
agree to float32 rounding carried through the network (stated per test);
the eval-mode forward is bit for bit."""
import dataclasses
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from dct_cryptonets_tpu import train as JTRAIN
from dct_cryptonets_tpu import utils as JUTILS
from dct_cryptonets_tpu.config import checkpoint_dir_for as j_ckpt_dir
from dct_cryptonets_tpu.config import parse_args as j_parse_args
from dct_cryptonets_tpu.fhe import compiler as JCOMP
from dct_cryptonets_tpu.fhe import runtime as JRUN
from dct_cryptonets_tpu.models import resnet as JRES
from dct_cryptonets_tpu.models.topology import StemSpec as JStem
from dct_cryptonets_tpu.ops import quant as JQ
from dct_cryptonets_tpu_torch import train as TRAIN
from dct_cryptonets_tpu_torch import utils as UTILS
from dct_cryptonets_tpu_torch.checkpoint import load_ckpt
from dct_cryptonets_tpu_torch.config import checkpoint_dir_for, parse_args
from dct_cryptonets_tpu_torch.fhe import compiler as COMP
from dct_cryptonets_tpu_torch.fhe import runtime as RUN
from dct_cryptonets_tpu_torch.fhe.circuit import simulate
from dct_cryptonets_tpu_torch.models import resnet as RES
from dct_cryptonets_tpu_torch.models.topology import StemSpec
from dct_cryptonets_tpu_torch.ops import quant as Q

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "digits_flagship", "best.tar")

# two stages, a strided shortcut, 8x8 input: every node kind of the ResNets
SMALL_KW = dict(name="smallqat", block_counts=(1, 1), widths=(4, 8),
                in_channels=3, img_size=8, num_classes=5, bit_width=4,
                quantized=True)


def specs(quantized=True):
    kw = dict(SMALL_KW, quantized=quantized,
              name="smallqat" if quantized else "small")
    return (RES.ModelSpec(**kw, stem_override=StemSpec(
                1, 1, 0, None, None, 4, True)),
            JRES.ModelSpec(**kw, stem_override=JStem(
                1, 1, 0, None, None, 4, True)))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees(got, want, **tol):
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert np.shape(g) == np.shape(w)
        if tol:
            np.testing.assert_allclose(g, w, **tol)
        else:
            np.testing.assert_array_equal(g, w)


def grads_tree(model):
    """The module's parameter gradients laid out as its params pytree."""
    saved = [p.data for p in model.parameters()]
    for p in model.parameters():
        p.data = p.grad
    try:
        return model.to_params()[0]
    finally:
        for p, d in zip(model.parameters(), saved):
            p.data = d


# ---------------------------------------------------------------------------
# the fake-quant op


def quant_inputs(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (n,)).astype(np.float32)
    x[:64] = (np.arange(64) - 32 + 0.5).astype(np.float32) * 0.25  # ties
    g = rng.normal(0, 1, (n,)).astype(np.float32)
    return x.reshape(16, 16, 16), g.reshape(16, 16, 16)


@pytest.mark.parametrize("kind,bits", [("relu", 4), ("signed", 4),
                                       ("relu", 3), ("signed", 5)])
def test_fake_quant_act_and_gradients_match_jax(kind, bits):
    x, g = quant_inputs(bits)
    scale = np.float32(0.25)
    jfn = {"relu": JQ.fake_quant_relu, "signed": JQ.fake_quant_act_signed}
    tfn = {"relu": Q.fake_quant_relu, "signed": Q.fake_quant_act_signed}
    want, vjp = jax.vjp(lambda a, s: jfn[kind](a, s, bits), jnp.asarray(x),
                        jnp.asarray(scale))
    wgx, wgs = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    got = tfn[kind](tx, ts, bits)
    got.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(wgx))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(wgs), rtol=1e-5)
    assert ts.grad.shape == ts.shape


def test_fake_quant_weight_and_int_weights_match_jax():
    w, g = quant_inputs(7)
    want, vjp = jax.vjp(lambda a: JQ.fake_quant_weight(a, 4), jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    got = Q.fake_quant_weight(tw, 4)
    got.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(tw.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    wi, ws = Q.quantize_weight_int(torch.as_tensor(w), 4)
    jwi, jws = JQ.quantize_weight_int(jnp.asarray(w), 4)
    assert wi.dtype == torch.int32
    np.testing.assert_array_equal(wi.numpy(), np.asarray(jwi))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


def test_fake_quant_scale_is_floored():
    """A zero scale is floored at 1e-8 (through max, as the JAX op)."""
    x = torch.tensor([0.0, 1e-9, 3e-8], requires_grad=True)
    s = torch.tensor(0.0, requires_grad=True)
    y = Q.fake_quant_act_signed(x, s, 4)
    want = JQ.fake_quant_act_signed(jnp.asarray(x.detach().numpy()),
                                    jnp.asarray(0.0), 4)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("model", ["ResNet20qat", "ResNet20", "ResNet18qat"])
def test_init_model_tree_matches_jax(model):
    kw = dict(in_channels=24, img_size=16) if "20" in model else dict(
        in_channels=6, img_size=32)
    spec = RES.build_spec(model, **kw)
    got = RES.init_model(spec, torch.Generator().manual_seed(3))
    want = to_np(JRES.init_model(jax.random.key(0),
                                 JRES.build_spec(model, **kw)))
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32


def test_init_model_draws():
    """Fan-in normal convolutions (std sqrt(2 / (kh kw cout))), a uniform
    +-1/sqrt(feat) classifier with a zero bias, unit scales and BN; the
    same generator seed gives the same draws."""
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=16)
    params, state = RES.init_model(spec, torch.Generator().manual_seed(0))
    again, _ = RES.init_model(spec)
    assert_trees(params, again)
    for w in [params["stem"]["conv"]["w"]] + [
            b[k]["w"] for b in params["blocks"]
            for k in ("c1", "c2", "shortcut") if k in b]:
        kh, kw, _, cout = w.shape
        std = np.sqrt(2.0 / (kh * kw * cout))
        assert abs(w.std() / std - 1) < 0.1 and abs(w.mean()) < 0.1 * std
    lim = 1 / np.sqrt(RES.trunk_feat_dim(spec))
    cw = params["classifier"]["w"]
    assert np.abs(cw).max() <= lim and abs(cw.std() * np.sqrt(3) / lim
                                           - 1) < 0.1
    assert not params["classifier"]["b"].any()
    for leaf in jax.tree_util.tree_leaves(params):
        if leaf.ndim == 0:
            assert leaf == 1.0
    for bn in jax.tree_util.tree_leaves(state):
        assert set(np.unique(bn)) <= {0.0, 1.0}


@pytest.fixture(scope="module")
def small_qat():
    spec, jspec = specs()
    rng = np.random.default_rng(0)
    x, x_cal = rng.normal(0, 1, (2, 8, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 8)
    params, state = JRES.init_model(jax.random.key(1), jspec)
    # scales from another batch: calibrating on the step's own batch puts
    # each node's largest input on its range edge, where the straight-
    # through mask turns on float32 rounding
    params = JRES.calibrate_scales(params, state, jnp.asarray(x_cal), jspec)
    return spec, jspec, to_np(params), to_np(state), x, labels


def test_train_forward_bn_state_and_gradients_match_jax(small_qat):
    """One train-mode forward and backward of the cross-entropy loss from
    the same params: logits, the new BatchNorm state and every gradient
    against ``jax.value_and_grad`` (float32 rounding through six
    normalized layers: rtol 1e-4, atol 1e-5 on O(1) values)."""
    spec, jspec, params, state, x, labels = small_qat

    def loss_fn(p):
        _, logits, new_state = JRES.forward(p, state, jnp.asarray(x), jspec,
                                            train=True)
        return JTRAIN.cross_entropy(logits, jnp.asarray(labels)), (
            logits, new_state)

    (wloss, (wlogits, wstate)), wgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, params))
    model = RES.QATResNet.from_params(params, state, spec).train()
    _, logits = model(torch.as_tensor(x))
    loss = TRAIN.cross_entropy(logits, torch.as_tensor(labels))
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(wloss), rtol=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), wlogits, **tol)
    assert_trees(model.to_params()[1], to_np(wstate), **tol)
    assert_trees(grads_tree(model), to_np(wgrads), **tol)


def test_float_model_train_forward_matches_jax():
    spec, jspec = specs(quantized=False)
    x = np.random.default_rng(1).normal(0, 1, (8, 8, 8, 3)).astype(
        np.float32)
    params, state = to_np(JRES.init_model(jax.random.key(2), jspec))
    _, wlogits, wstate = JRES.forward(params, state, jnp.asarray(x), jspec,
                                      train=True)
    model = RES.QATResNet(params, state, spec).train()
    _, logits = model(torch.as_tensor(x))
    np.testing.assert_allclose(logits.detach().numpy(), wlogits, rtol=1e-5,
                               atol=1e-6)
    assert_trees(model.to_params()[1], to_np(wstate), rtol=1e-5, atol=1e-6)
    model = RES.QATResNet(params, state, spec).eval()
    _, wlogits, _ = JRES.forward(params, state, jnp.asarray(x), jspec)
    _, logits = model(torch.as_tensor(x))
    np.testing.assert_allclose(logits.detach().numpy(), wlogits, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_calibrate_scales_matches_jax(small_qat, train):
    """Every node's scale from the batch, progressively, with batch (QAT
    init) or running (PTQ) statistics; the weights pass through as they
    are.  The scales are maxima of float32 activations (rtol 1e-5)."""
    spec, jspec, params, state, x, _ = small_qat
    params = to_np(JRES.init_model(jax.random.key(4), jspec)[0])
    # running statistics away from their init
    _, _, state = JRES.forward(params, state, jnp.asarray(x), jspec,
                               train=True)
    state = to_np(state)
    want = to_np(JRES.calibrate_scales(params, state, jnp.asarray(x), jspec,
                                       train=train))
    got = RES.calibrate_scales(params, state, torch.as_tensor(x), spec,
                               train=train)
    assert_trees(got, want, rtol=1e-5)
    for g, p in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(params)):
        if np.ndim(p):
            np.testing.assert_array_equal(g, p)


def test_quantize_float_model_matches_jax():
    spec, jspec = specs(quantized=False)
    x = np.random.default_rng(5).normal(0, 1, (8, 8, 8, 3)).astype(
        np.float32)
    params, state = JRES.init_model(jax.random.key(5), jspec)
    _, _, state = JRES.forward(params, state, jnp.asarray(x), jspec,
                               train=True)
    params, state = to_np(params), to_np(state)
    wp, wspec = JRES.quantize_float_model(params, state, jnp.asarray(x),
                                          jspec, n_bits=5)
    gp, gspec = RES.quantize_float_model(params, state, torch.as_tensor(x),
                                         spec, n_bits=5)
    assert dataclasses.asdict(gspec) == dataclasses.asdict(wspec)
    assert_trees(gp, to_np(wp), rtol=1e-5)
    with pytest.raises(ValueError, match="already QAT"):
        RES.quantize_float_model(gp, state, torch.as_tensor(x), gspec)


@pytest.mark.parametrize("model,kw", [
    ("ResNet20qat", dict(in_channels=24, img_size=16)),
    ("ResNet20", dict(in_channels=24, img_size=8)),
    ("ResNet18qat", dict(in_channels=3, img_size=224)),
    ("ResNet18", dict(in_channels=6, img_size=32))])
def test_model_summary_matches_jax(model, kw):
    spec, jspec = RES.build_spec(model, **kw), JRES.build_spec(model, **kw)
    assert RES.model_summary(spec) == JRES.model_summary(jspec)
    params = RES.init_model(spec)[0]
    assert RES.model_summary(spec, params) == JRES.model_summary(jspec,
                                                                 params)


class _FrozenEvalResNet(torch.nn.Module):
    """The port's eval-only QATResNet as it was before training came:
    weights fake-quantized once when built, running-stats BatchNorm."""

    def __init__(self, params, state, spec):
        super().__init__()
        t = RES._t
        b, st = spec.bit_width, spec.stem
        self.spec, self.nodes = spec, []

        def fq(x, scale, qmin, qmax):
            return torch.clamp(torch.round(x / scale), qmin, qmax) * scale

        def conv(w, stride, pad):
            qmax = 2 ** (b - 1) - 1
            w = t(w)
            wq = fq(w, torch.clamp(w.abs().max(), min=1e-8) / qmax, -qmax,
                    qmax).permute(3, 2, 0, 1)
            return lambda h: F.conv2d(h, wq, stride=stride, padding=pad)

        def bn(p, s):
            sh = (1, -1, 1, 1)
            return lambda h: ((h - t(s["mean"]).view(sh)) * torch.rsqrt(
                t(s["var"]).view(sh) + 1e-5) * t(p["gamma"]).view(sh)
                + t(p["beta"]).view(sh))

        def act(node, relu):
            lo, hi = (0, 2 ** b - 1) if relu else (-2 ** (b - 1),
                                                   2 ** (b - 1) - 1)
            s = torch.clamp(t(node["scale"]), min=1e-8)
            return lambda h: fq(h, s, lo, hi)

        sp, ss = params["stem"], state["stem"]
        self.stem = [act(sp["quant_in"], False),
                     conv(sp["conv"]["w"], st.conv1_stride, st.conv1_padding),
                     bn(sp["bn"], ss["bn"])]
        if st.relu1:
            self.stem.append(act(sp["relu1"], True))
        self.stem.append(act(sp["quant_stem"], False))
        self.blocks = []
        for bp, bs, (i, o, half) in zip(params["blocks"], state["blocks"],
                                        spec.block_layout()):
            s = 2 if half else 1
            main = [conv(bp["c1"]["w"], s, 1), bn(bp["bn1"], bs["bn1"]),
                    act(bp["relu1"], True), conv(bp["c2"]["w"], 1, 1),
                    bn(bp["bn2"], bs["bn2"]), act(bp["quant_out"], False)]
            sc = [] if i == o else [
                conv(bp["shortcut"]["w"], s, 0), bn(bp["bn_sc"], bs["bn_sc"]),
                act(bp["quant_sc"], False)]
            self.blocks.append((main, sc, act(bp["relu2"], True)))
        self.pool = act(params["head"]["quant_pool"], False)
        self.w, self.b = (t(params["classifier"][k]) for k in "wb")

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for f in self.stem:
            h = f(h)
        for main, sc, relu2 in self.blocks:
            out, short = h, h
            for f in main:
                out = f(out)
            for f in sc:
                short = f(short)
            h = relu2(out + short)
        k = self.spec.stem.avgpool_kernel
        h = self.pool(F.avg_pool2d(h, k, k))
        feats = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return feats, feats @ self.w + self.b


def test_eval_forward_equals_the_eval_only_model():
    """The trainable module in eval mode gives the eval-only model's
    features and logits bit for bit on the flagship checkpoint, and its
    weights cross to the pytree and back unchanged."""
    params, state = load_ckpt(CKPT)["state"]
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=16)
    x = torch.as_tensor(np.clip(np.random.default_rng(0).normal(
        0, 1, (8, 16, 16, 24)), -3, 3).astype(np.float32))
    model = RES.QATResNet(params, state, spec).eval()
    with torch.no_grad():
        got = model(x)
        want = _FrozenEvalResNet(params, state, spec)(x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    p2, s2 = model.to_params()
    assert_trees((p2, s2), (params, state))


# ---------------------------------------------------------------------------
# optimizers, utilities, checkpoints


def opt_cfg(optimizer, clip):
    return types.SimpleNamespace(
        optimizer=optimizer, weight_decay=1e-2, momentum=0.9,
        grad_clip_value=0.05 if clip == "value" else None,
        grad_clip_norm=0.5 if clip == "norm" else None)


@pytest.mark.parametrize("clip", ["none", "value", "norm"])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(optimizer, clip):
    """Four steps of the same gradient sequence: the parameters equal the
    JAX trainer's optax chain to float32 rounding (a few ulps of the O(1)
    parameters: rtol 1e-6, atol 1e-6): clip, then Adam's L2 term, then
    the update; AdamW decays decoupled; SGD takes no decay."""
    cfg = opt_cfg(optimizer, clip)
    rng = np.random.default_rng(len(optimizer) * 10 + len(clip))
    p0 = {"a": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.3, v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    opt = JTRAIN.make_optimizer(cfg, 1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
          for k, v in p0.items()}
    topt = TRAIN.make_optimizer(cfg, 1e-2, tp.values())
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k].copy())
        TRAIN.clip_gradients(list(tp.values()), cfg)
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), jp[k], rtol=1e-6,
                                   atol=1e-6)


def test_step_decay_early_stop_and_ckpt_dir_match_jax():
    for sched in (None, [2, 5], [1]):
        for epoch in range(7):
            assert (UTILS.step_decay_lr(0.1, sched, 0.1, epoch)
                    == JUTILS.step_decay_lr(0.1, sched, 0.1, epoch))
    losses = [1.0, 0.9, 0.95, 0.94, 1.0, 0.99, 0.92, 1.2, 1.3, 1.3, 0.8]
    got, want = UTILS.EarlyStopper(3, 0.03), JUTILS.EarlyStopper(3, 0.03)
    assert [got(v) for v in losses] == [want(v) for v in losses]
    for argv in (["--dct_status"], ["--model", "ResNet20qat"],
                 ["--checkpoint_dir", "x/y"]):
        assert checkpoint_dir_for(parse_args("train", argv)) == j_ckpt_dir(
            j_parse_args("train", argv))


# ---------------------------------------------------------------------------
# the trainer's CLI

TINY_RUN = ["--dataset", "synthetic", "--synthetic_size", "160",
            "--dct_status", "--model", "ResNet20qat", "--channels", "24",
            "--filter_size", "4", "--image_size_dct", "8", "--batch_size",
            "16", "--test_batch_size", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """Two tiny epochs of the trainer on the CPU, with augmentation and
    dropout, the LR decayed for epoch 1 and a checkpoint every epoch."""
    d = str(tmp_path_factory.mktemp("train"))
    res = TRAIN.main(TINY_RUN + ["--train_aug", "--dropout", "0.1",
                                 "--stop_epoch", "2", "--save_freq", "1",
                                 "--schedule", "2", "--checkpoint_dir", d])
    return d, res


def test_cli_epoch_writes_a_checkpoint_jax_reads_and_lowers(tiny_run):
    """``best.tar`` loads with the JAX package's plain ``pickle.load``;
    its params lower to the same circuit in both packages."""
    d, res = tiny_run
    assert res["epochs"] == 2 and res["steps"] == 2 * (144 // 16)
    assert res["test_total"] == 40 and len(res["epoch_s"]) == 2
    # the synthetic set's confusion heatmap, as the JAX trainer writes it
    assert sorted(os.listdir(d)) == ["0.tar", "1.tar", "best.tar",
                                     "heatmap.png", "train_log.jsonl"]
    ck = JTRAIN.load_ckpt(os.path.join(d, "best.tar"))
    assert set(ck) == {"epoch", "state", "prec1", "prec5", "optimizer"}
    params, state = ck["state"]
    assert isinstance(ck["optimizer"]["state"][0]["exp_avg"], np.ndarray)
    with open(os.path.join(d, "best.tar"), "rb") as fh:
        assert "torch" not in str(pickle.load(fh))
    x = np.clip(np.random.default_rng(0).normal(0, 1, (4, 8, 8, 24)), -3,
                3).astype(np.float32)
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    jspec = JRES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    got = COMP.lower(params, state, spec, calib_data=x)
    want = JCOMP.lower(params, state, jspec, calib_data=x)
    assert got.dump() == want.dump()
    lines = open(os.path.join(d, "train_log.jsonl")).read().splitlines()
    assert [json.loads(l)["lr"] for l in lines] == [1e-3, 1e-3 * 0.1]


def test_resume_quirk_restarts_at_the_saved_epoch(tiny_run, tmp_path,
                                                  capsys):
    """Reference quirk (JAX train.py:200, ROADMAP Queue 3): a resume
    from ``{e}.tar`` trains epoch e again, not e + 1."""
    d, _ = tiny_run
    TRAIN.main(TINY_RUN + ["--stop_epoch", "2", "--resume",
                           os.path.join(d, "1.tar"),
                           "--checkpoint_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "Epoch: [2 | 2]" in out and "Epoch: [1 | 2]" not in out


def test_resume_quirk_runs_the_base_lr_until_the_next_milestone(
        tiny_run, tmp_path, capsys):
    """Reference quirk (JAX train.py:189, 219-224, ROADMAP Queue 3): a
    resume past a milestone prints the decayed LR but steps at the base
    LR, since the optimizer is rebuilt at ``--lr`` and decayed only when
    the next milestone comes: resumed at epoch 1 under milestone 1, it
    steps at 1e-3."""
    d, _ = tiny_run
    ck0 = load_ckpt(os.path.join(d, "1.tar"))
    assert ck0["optimizer"]["param_groups"][0]["lr"] == pytest.approx(1e-4)
    TRAIN.main(TINY_RUN + ["--stop_epoch", "3", "--save_freq", "1",
                           "--schedule", "1", "--resume",
                           os.path.join(d, "1.tar"),
                           "--checkpoint_dir", str(tmp_path)])
    assert "LR: 0.0001" in capsys.readouterr().out
    ck = load_ckpt(str(tmp_path / "2.tar"))
    assert ck["optimizer"]["param_groups"][0]["lr"] == 1e-3
    assert ck["optimizer"]["state"][0]["step"] > ck0["optimizer"]["state"][
        0]["step"]


def test_resume_refuses_a_jax_optimizer_state(tmp_path):
    """The port resumes only its own optimizer state (optax's does not
    map onto ``torch.optim``)."""
    ck = str(tmp_path / "jax.tar")
    params, state = load_ckpt(CKPT)["state"]
    JTRAIN.save_ckpt(ck, 3, params, state, optax.adam(1e-3).init(
        jax.tree_util.tree_map(jnp.asarray, params)), 90.0, 99.0)
    with pytest.raises(ValueError, match="not written by this package"):
        TRAIN.main(["--dataset", "synthetic", "--synthetic_size", "64",
                    "--dct_status", "--model", "ResNet20qat", "--channels",
                    "24", "--filter_size", "4", "--image_size_dct", "16",
                    "--resume", ck, "--checkpoint_dir", str(tmp_path),
                    "--device", "cpu"])


# ---------------------------------------------------------------------------
# the PTQ compile


def test_compile_ptq_model_matches_jax(small_qat):
    """Post-training quantization of the same float params and
    calibration batch: the same circuit listing and simulated integers."""
    spec, jspec = specs(quantized=False)
    x = small_qat[4]
    params, state = JRES.init_model(jax.random.key(6), jspec)
    _, _, state = JRES.forward(params, state, jnp.asarray(x), jspec,
                               train=True)
    params, state = to_np(params), to_np(state)
    got = RUN.compile_ptq_model(params, state, spec, x, n_bits=5,
                                rounding_threshold_bits=6, device="cpu")
    want = JRUN.compile_ptq_model(params, state, jspec, x, n_bits=5,
                                  rounding_threshold_bits=6)
    assert got.circuit.dump() == want.circuit.dump()
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    np.testing.assert_array_equal(
        simulate(got.circuit, torch.as_tensor(x)).numpy(),
        np.asarray(want.forward(x, fhe="simulate")))


def test_train_step_backward_runs_without_tf32():
    """The trainer's backward convolutions see cuDNN's TF32 flag off while
    the caller's flag is on (a hook in every convolution's backward reads
    it; the forward's own flag context has exited by then), and the
    caller's flag is back after the step."""
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    model = RES.QATResNet.from_params(*RES.init_model(spec), spec)
    seen = []
    for m in model.modules():
        if isinstance(m, RES._QConv):
            m.register_full_backward_hook(
                lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    cfg = parse_args("train", ["--device", "cpu"])
    opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        TRAIN.train_step(model, opt, cfg, torch.randn((4, 8, 8, 24)),
                         torch.arange(4), torch.Generator())
        assert len(seen) == 21 and not any(seen)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("caller", [(False, True, True), (True, False, False)])
def test_train_step_convolutions_run_deterministic(caller):
    """Every convolution of the train step, forward and backward, sees
    cuDNN's deterministic algorithms on, autotuning off and TF32 off,
    whatever the caller's flags; the caller's flags are back after the
    step."""
    cudnn = torch.backends.cudnn
    spec = RES.build_spec("ResNet20qat", in_channels=24, img_size=8)
    model = RES.QATResNet.from_params(*RES.init_model(spec), spec)
    seen = {"forward": [], "backward": []}

    def flags(kind):
        return lambda *_: seen[kind].append(
            (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32))
    for m in model.modules():
        if isinstance(m, RES._QConv):
            m.register_forward_hook(flags("forward"))
            m.register_full_backward_hook(flags("backward"))
    cfg = parse_args("train", ["--device", "cpu"])
    opt = TRAIN.make_optimizer(cfg, cfg.lr, model.parameters())
    before = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = caller
    try:
        TRAIN.train_step(model, opt, cfg, torch.randn((4, 8, 8, 24)),
                         torch.arange(4), torch.Generator())
        after = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32)
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = before
    assert len(seen["forward"]) == len(seen["backward"]) == 21
    assert set(seen["forward"]) == set(seen["backward"]) == {
        (True, False, False)}
    assert after == caller


def test_reproducible_only_on_the_card(monkeypatch):
    """``reproducible`` leaves a CPU run alone; on a CUDA device it raises
    unless the environment holds a fixed cuBLAS workspace configuration
    (set there it could come after the process's first cuBLAS call), and
    otherwise turns deterministic algorithms on and restores the caller's
    setting."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = torch.are_deterministic_algorithms_enabled()
    with TRAIN.reproducible(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled() == before
    for value in (None, ":0:0"):
        if value is not None:
            monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
        with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
            with TRAIN.reproducible(torch.device("cuda")):
                pass
        assert torch.are_deterministic_algorithms_enabled() == before
    try:
        for value in (":4096:8", ":16:8"):
            monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", value)
            with TRAIN.reproducible(torch.device("cuda")):
                assert torch.are_deterministic_algorithms_enabled()
            assert torch.are_deterministic_algorithms_enabled() == before
    finally:
        torch.use_deterministic_algorithms(before)
