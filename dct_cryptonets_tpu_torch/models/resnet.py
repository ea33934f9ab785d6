"""Float and QAT DCT-ResNets as one trainable ``nn.Module``, counterpart
of ``dct_cryptonets_tpu.models.resnet``.

The declarative :class:`ModelSpec` (same fields, same registry) drives both
the module and the circuit compiler (``fhe.compiler.lower``).  Weights live
in the JAX package's (params, state) numpy pytree (HWIO convolutions, a 0-d
``scale`` per quantizer node) wherever they are stored or compiled:
:func:`init_model` draws one, ``QATResNet(params, state, spec)`` builds
the module from one in eval mode with its weights frozen,
:meth:`QATResNet.from_params` the trainable module, and
:meth:`QATResNet.to_params` gives the pytree back.  The module is NHWC at its
public boundary like the JAX forward; inside, convolutions run NCHW on
OIHW weights.

``train()`` mode normalizes with batch statistics and updates the running
ones (the JAX ``forward(train=True)``); ``eval()`` mode uses the running
statistics.  The forward runs its convolutions in full float32, as the JAX
package's float32 model does: cuDNN would otherwise take TF32 for them on
the GPU (its default), which can move the clear model's class.  A training
step must keep its backward inside :func:`fp32_convolutions` too, and the
trainer's runs it inside :func:`train_convolutions` (also deterministic).
"""
import copy
import dataclasses
from contextlib import contextmanager
from dataclasses import dataclass
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.quant import (fake_quant_act_signed, fake_quant_relu,
                         fake_quant_weight, true_div)
from .topology import StemSpec, stem_spec


@dataclass(frozen=True)
class ModelSpec:
    name: str
    block_counts: tuple
    widths: tuple
    in_channels: int
    img_size: int
    num_classes: int = 10
    bit_width: int = 4
    quantized: bool = True
    skip_single_downsample: bool = False
    stem_override: StemSpec | None = None  # for tests / custom topologies

    @property
    def stem(self) -> StemSpec:
        if self.stem_override is not None:
            return self.stem_override
        return stem_spec(self.widths[0], self.in_channels, self.img_size)

    def block_layout(self):
        """Yield (indim, outdim, half_res) per block."""
        indim = self.widths[0]
        for i, n in enumerate(self.block_counts):
            for j in range(n):
                if self.skip_single_downsample:
                    half = (i >= 2) and (j == 0)
                else:
                    half = (i >= 1) and (j == 0)
                yield indim, self.widths[i], half
                indim = self.widths[i]


def trunk_feat_dim(spec: ModelSpec) -> int:
    """Flattened feature count after the trunk's avgpool."""
    st = spec.stem
    oh = (spec.img_size + 2 * st.conv1_padding
          - st.conv1_kernel) // st.conv1_stride + 1
    if st.pool1_kernel is not None:
        oh = (oh + 2 * 1 - st.pool1_kernel) // st.pool1_stride + 1
    for _, _, half in spec.block_layout():
        oh = (oh + 2 - 3) // (2 if half else 1) + 1
    oh //= st.avgpool_kernel
    return oh * oh * spec.widths[-1]


def build_spec(model: str, *, in_channels: int, img_size: int,
               num_classes: int = 10, bit_width: int = 4) -> ModelSpec:
    """Model registry (same entries as the JAX package)."""
    m = model.lower()
    if m in ("resnet20", "resnet20qat"):
        return ModelSpec(
            name=model, block_counts=(3, 3, 3), widths=(48, 56, 64),
            in_channels=in_channels, img_size=img_size,
            num_classes=num_classes, bit_width=bit_width,
            quantized=m.endswith("qat"), skip_single_downsample=True)
    if m in ("resnet18", "resnet18qat"):
        return ModelSpec(
            name=model, block_counts=(2, 2, 2, 2),
            widths=(64, 128, 256, 512), in_channels=in_channels,
            img_size=img_size, num_classes=num_classes, bit_width=bit_width,
            quantized=m.endswith("qat"), skip_single_downsample=False)
    raise ValueError(f"unknown model {model!r}")




# ---------------------------------------------------------------------------
# initialization


def _conv_init(gen, kh, kw, cin, cout):
    """Fan-in normal HWIO weights, std sqrt(2 / (kh * kw * cout))."""
    n = kh * kw * cout
    return (torch.randn((kh, kw, cin, cout), generator=gen)
            * math.sqrt(2.0 / n)).numpy()


def _bn_init(c):
    return {"gamma": np.ones((c,), np.float32),
            "beta": np.zeros((c,), np.float32)}


def _bn_state(c):
    return {"mean": np.zeros((c,), np.float32),
            "var": np.ones((c,), np.float32)}


def _act_scale():
    # Brevitas QuantIdentity(scaling_init=1.0); learned thereafter (LSQ)
    return {"scale": np.asarray(1.0, np.float32)}


def init_model(spec: ModelSpec, generator: torch.Generator | None = None):
    """Random (params, state) numpy pytrees with the JAX ``init_model``'s
    keys, shapes and draws, from ``generator`` (default: seed 0)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    st = spec.stem
    stem_p, stem_s = {}, {}
    if spec.quantized:
        stem_p["quant_in"] = _act_scale()
    k = st.conv1_kernel
    stem_p["conv"] = {"w": _conv_init(gen, k, k, spec.in_channels,
                                      spec.widths[0])}
    stem_p["bn"] = _bn_init(spec.widths[0])
    stem_s["bn"] = _bn_state(spec.widths[0])
    if st.relu1 and spec.quantized:
        stem_p["relu1"] = _act_scale()
    if spec.quantized:
        stem_p["quant_stem"] = _act_scale()

    blocks_p, blocks_s = [], []
    for indim, outdim, _ in spec.block_layout():
        bp = {"c1": {"w": _conv_init(gen, 3, 3, indim, outdim)},
              "bn1": _bn_init(outdim),
              "c2": {"w": _conv_init(gen, 3, 3, outdim, outdim)},
              "bn2": _bn_init(outdim)}
        bs = {"bn1": _bn_state(outdim), "bn2": _bn_state(outdim)}
        if spec.quantized:
            bp.update(relu1=_act_scale(), relu2=_act_scale(),
                      quant_out=_act_scale())
        if indim != outdim:
            bp["shortcut"] = {"w": _conv_init(gen, 1, 1, indim, outdim)}
            bp["bn_sc"] = _bn_init(outdim)
            bs["bn_sc"] = _bn_state(outdim)
            if spec.quantized:
                bp["quant_sc"] = _act_scale()
        blocks_p.append(bp)
        blocks_s.append(bs)

    feat_dim = trunk_feat_dim(spec)
    # torch nn.Linear's default draw, uniform +-1/sqrt(fan_in); zero bias
    lim = 1.0 / math.sqrt(feat_dim)
    clf_w = (torch.rand((feat_dim, spec.num_classes), generator=gen)
             * (2 * lim) - lim).numpy()
    params = {"stem": stem_p, "blocks": blocks_p,
              "head": {"quant_pool": _act_scale()} if spec.quantized else {},
              "classifier": {"w": clf_w,
                             "b": np.zeros((spec.num_classes,), np.float32)}}
    return params, {"stem": stem_s, "blocks": blocks_s}


# ---------------------------------------------------------------------------
# the module


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _np(t):
    return t.detach().cpu().numpy().copy()


@contextmanager
def fp32_convolutions():
    """cuDNN convolutions in full float32 (TF32 off); the caller's other
    cuDNN flags hold."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


@contextmanager
def train_convolutions():
    """A train step's cuDNN convolutions, forward and backward: full
    float32 (TF32 off), deterministic algorithms and no autotuning, so one
    seed gives one set of weights on the card as on XLA (cuDNN's fastest
    backward algorithms sum with atomics in an order that changes from run
    to run, and the 4-bit fake-quant turns an ulp into a whole step).  The
    caller's flags come back afterwards."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                     deterministic=True, allow_tf32=False):
        yield


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group, with the sum's gradient: every rank's
    loss depends on the sum, so a rank's input gets the summed output
    gradient."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_moments(x, group=None):
    """(mean, biased variance, count) of NCHW ``x`` per channel.  With a
    process ``group``, over the global batch of the data-parallel ranks,
    as the JAX train step takes them over its sharded batch: the global
    mean first, then the global mean of the squared deviations from it
    (``jnp.var``'s order), each an all-reduce of per-rank sums."""
    if group is None:
        return (x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), correction=0),
                x.numel() // x.shape[1])
    s = torch.cat([x.sum(dim=(0, 2, 3)),
                   x.new_full((1,), x.numel() // x.shape[1])])
    s = _AllReduceSum.apply(s, group)
    n = s[-1].detach()
    mean = s[:-1] / n
    d = x - mean.view(1, -1, 1, 1)
    var = _AllReduceSum.apply((d * d).sum(dim=(0, 2, 3)), group) / n
    return mean, var, int(n)


class _BN(nn.Module):
    """BatchNorm over the channel axis of NCHW, the JAX ``batchnorm``:
    train mode normalizes with the biased batch variance and moves the
    running statistics (momentum 0.1) with the unbiased one.  ``group``
    (set by :meth:`QATResNet.data_parallel`): the process group whose
    global batch the train-mode statistics are taken over."""

    MOMENTUM, EPS = 0.1, 1e-5

    def __init__(self, p, s):
        super().__init__()
        self.gamma = nn.Parameter(_t(p["gamma"]))
        self.beta = nn.Parameter(_t(p["beta"]))
        self.register_buffer("mean", _t(s["mean"]))
        self.register_buffer("var", _t(s["var"]))
        self.group = None

    def forward(self, x):
        sh = (1, -1, 1, 1)
        if self.training:
            mean, var, n = batch_moments(x, self.group)
            m = self.MOMENTUM
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var
                               + m * true_div(var * n, max(n - 1, 1)))
        else:
            mean, var = self.mean, self.var
        return ((x - mean.view(sh)) * torch.rsqrt(var.view(sh) + self.EPS)
                * self.gamma.view(sh) + self.beta.view(sh))

    def node(self):
        return ({"gamma": _np(self.gamma), "beta": _np(self.beta)},
                {"mean": _np(self.mean), "var": _np(self.var)})


class _QConv(nn.Module):
    """Convolution; with ``bits``, on Brevitas per-tensor fake-quantized
    weights.  HWIO in the pytree, OIHW here."""

    def __init__(self, w, bits, stride, padding):
        super().__init__()
        self.w = nn.Parameter(_t(w).permute(3, 2, 0, 1).contiguous())
        self.bits, self.stride, self.padding = bits, stride, padding

    def forward(self, x):
        w = self.w if self.bits is None else fake_quant_weight(self.w,
                                                               self.bits)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)

    def node(self):
        return {"w": _np(self.w.permute(2, 3, 1, 0))}, None


class _Act(nn.Module):
    """Activation fake-quant node with a learned scale.  While
    ``calibrating`` it first sets its scale from the batch (max over the
    batch, of |h| for signed nodes) and then quantizes with it, so later
    nodes see already-quantized activations.  ``group`` (set by
    :meth:`QATResNet.data_parallel`): the process group whose global batch
    (of equal shards) sizes the scale's LSQ gradient."""

    def __init__(self, node, bits, relu):
        super().__init__()
        self.scale = nn.Parameter(_t(node["scale"]))
        self.bits, self.relu = bits, relu
        self.calibrating = False
        self.group = None

    def forward(self, x):
        if self.calibrating:
            qmax = (2 ** self.bits - 1) if self.relu else (
                2 ** (self.bits - 1) - 1)
            ref = x.max() if self.relu else x.abs().max()
            with torch.no_grad():
                self.scale.copy_(true_div(torch.clamp(ref, min=1e-6),
                                          qmax))
        numel = None
        if self.group is not None:
                numel = x.numel() * dist.get_world_size(self.group)
        if self.relu:
            return fake_quant_relu(x, self.scale, self.bits, numel)
        return fake_quant_act_signed(x, self.scale, self.bits, numel)

    def node(self):
        return {"scale": _np(self.scale)}, None


def _relu_node(p, name, bits):
    """The QuantReLU node ``name`` of a QAT model, or a plain ReLU."""
    return _Act(p[name], bits, True) if bits is not None else nn.ReLU()


class _Stem(nn.Module):
    def __init__(self, sp, ss, spec):
        super().__init__()
        st, b = spec.stem, (spec.bit_width if spec.quantized else None)
        self.quant_in = _Act(sp["quant_in"], b, False) if b is not None \
            else None
        self.conv = _QConv(sp["conv"]["w"], b, st.conv1_stride,
                           st.conv1_padding)
        self.bn = _BN(sp["bn"], ss["bn"])
        self.relu1 = _relu_node(sp, "relu1", b) if st.relu1 else None
        self.quant_stem = _Act(sp["quant_stem"], b, False) \
            if b is not None else None
        self.pool = st.pool1_kernel, st.pool1_stride

    def forward(self, h):
        if self.quant_in is not None:
            h = self.quant_in(h)
        h = self.bn(self.conv(h))
        if self.relu1 is not None:
            h = self.relu1(h)
        if self.pool[0] is not None:
            h = F.max_pool2d(h, self.pool[0], self.pool[1], 1)
        return h if self.quant_stem is None else self.quant_stem(h)


class _Block(nn.Module):
    def __init__(self, bp, bs, indim, outdim, half, bits):
        super().__init__()
        stride = 2 if half else 1
        self.c1 = _QConv(bp["c1"]["w"], bits, stride, 1)
        self.bn1 = _BN(bp["bn1"], bs["bn1"])
        self.relu1 = _relu_node(bp, "relu1", bits)
        self.c2 = _QConv(bp["c2"]["w"], bits, 1, 1)
        self.bn2 = _BN(bp["bn2"], bs["bn2"])
        self.quant_out = _Act(bp["quant_out"], bits, False) \
            if bits is not None else None
        self.shortcut = self.bn_sc = self.quant_sc = None
        if indim != outdim:
            self.shortcut = _QConv(bp["shortcut"]["w"], bits, stride, 0)
            self.bn_sc = _BN(bp["bn_sc"], bs["bn_sc"])
            if bits is not None:
                self.quant_sc = _Act(bp["quant_sc"], bits, False)
        self.relu2 = _relu_node(bp, "relu2", bits)

    def forward(self, h):
        out = self.bn2(self.c2(self.relu1(self.bn1(self.c1(h)))))
        if self.quant_out is not None:
            out = self.quant_out(out)
        sc = h
        if self.shortcut is not None:
            sc = self.bn_sc(self.shortcut(h))
            if self.quant_sc is not None:
                sc = self.quant_sc(sc)
        return self.relu2(out + sc)


class _Head(nn.Module):
    def __init__(self, hp, spec):
        super().__init__()
        self.quant_pool = (_Act(hp["quant_pool"], spec.bit_width, False)
                           if spec.quantized else None)
        self.k = spec.stem.avgpool_kernel

    def forward(self, h):
        h = F.avg_pool2d(h, self.k, self.k)
        return h if self.quant_pool is None else self.quant_pool(h)


def _tree(module):
    """(params, state) nodes of a module whose children carry the
    pytree's names."""
    p, s = {}, {}
    for name, child in module.named_children():
        if isinstance(child, (_BN, _QConv, _Act)):
            p[name], sn = child.node()
            if sn is not None:
                s[name] = sn
    return p, s


class QATResNet(nn.Module):
    """Float or fake-quant (QAT) DCT-ResNet.

    ``forward(x)`` takes NHWC float input (B, S, S, C) and returns
    ``(features, logits)`` like the JAX ``forward``; in ``train()`` mode it
    also moves the BatchNorm running statistics, as the JAX forward's
    returned state does.

    ``QATResNet(params, state, spec)`` is the clear model of
    ``homomorphic_eval`` and the bench: in eval mode, its weights frozen (no gradients);
    :meth:`from_params` gives the trainable module, in train mode."""

    def __init__(self, params, state, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        bits = spec.bit_width if spec.quantized else None
        self.stem = _Stem(params["stem"], state["stem"], spec)
        self.blocks = nn.ModuleList(
            _Block(bp, bs, i, o, h, bits) for bp, bs, (i, o, h) in zip(
                params["blocks"], state["blocks"], spec.block_layout()))
        self.head = _Head(params["head"], spec)
        self.clf_w = nn.Parameter(_t(params["classifier"]["w"]))
        self.clf_b = nn.Parameter(_t(params["classifier"]["b"]))
        self.requires_grad_(False)
        self.eval()

    @classmethod
    def from_params(cls, params, state, spec: ModelSpec) -> "QATResNet":
        """The trainable module (every weight, BatchNorm affine and
        quantizer scale a parameter with gradients), in train mode,
        holding the (params, state) pytree's weights."""
        return cls(params, state, spec).requires_grad_(True).train()

    def data_parallel(self, group):
        """Take what depends on the batch over the global batch of the
        data-parallel process ``group`` (``None``: this process's batch),
        as the JAX train step does over its sharded batch: the train-mode
        BatchNorm statistics and the LSQ gradient scale of the activation
        quantizers.  Returns the module."""
        for m in self.modules():
            if isinstance(m, (_BN, _Act)):
                m.group = group
        return self

    def to_params(self):
        """The module's weights as (params, state) numpy pytrees."""
        sp, ss = _tree(self.stem)
        blocks = [_tree(b) for b in self.blocks]
        params = {"stem": sp, "blocks": [b[0] for b in blocks],
                  "head": _tree(self.head)[0],
                  "classifier": {"w": _np(self.clf_w), "b": _np(self.clf_b)}}
        return params, {"stem": ss, "blocks": [b[1] for b in blocks]}

    def forward(self, x):
        with fp32_convolutions():
            return self._forward(x)

    def _forward(self, x):
        h = self.stem(x.permute(0, 3, 1, 2))
        for blk in self.blocks:
            h = blk(h)
        h = self.head(h)
        feats = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return feats, feats @ self.clf_w + self.clf_b


# ---------------------------------------------------------------------------
# calibration, post-training quantization, summary


@torch.no_grad()
def calibrate_scales(params, state, x, spec: ModelSpec, train: bool = True):
    """Brevitas runtime-stats initialization of the activation scales: one
    forward in which each quantizer takes its scale from the batch,
    progressively.  ``train=True`` (QAT init) normalizes with batch
    statistics, ``train=False`` (post-training quantization) with the
    running ones.  Returns the params pytree with those scales; ``state``
    is not changed.  Runs on ``x``'s device."""
    model = QATResNet(params, state, spec).to(x.device).train(train)
    for m in model.modules():
        if isinstance(m, _Act):
            m.calibrating = True
    model(x)
    return model.to_params()[0]


def quantize_float_model(params, state, x_calib, spec: ModelSpec,
                         n_bits: int = 5):
    """Post-training quantization of a trained float model: its weights
    grafted into a QAT skeleton at ``n_bits``, activation scales calibrated
    on ``x_calib`` with running-stats BatchNorm.  Returns ``(params_q,
    spec_q)`` for the QAT lowering."""
    if spec.quantized:
        raise ValueError("model is already QAT; compile it directly")
    spec_q = dataclasses.replace(spec, name=spec.name + "-ptq",
                                 quantized=True, bit_width=n_bits)
    skeleton, _ = init_model(spec_q)

    def graft(skel, src):
        """Trained float leaves into the skeleton, which keeps its extra
        quantizer nodes."""
        if isinstance(skel, dict):
            return {k: (graft(v, src[k]) if k in src else v)
                    for k, v in skel.items()}
        if isinstance(skel, list):
            return [graft(sv, xv) for sv, xv in zip(skel, src)]
        return src

    merged = graft(skeleton, copy.deepcopy(params))
    return calibrate_scales(merged, state, x_calib, spec_q,
                            train=False), spec_q


def tree_leaves(tree):
    """The arrays of a (params or state) pytree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def model_summary(spec: ModelSpec, params=None) -> str:
    """Per-layer table (output shape, parameter count, total), the same
    text as the JAX package's ``model_summary``."""
    st = spec.stem
    rows = []
    H = spec.img_size

    def n_params(*shapes):
        return sum(int(np.prod(s)) for s in shapes)

    oh = (H + 2 * st.conv1_padding - st.conv1_kernel) // st.conv1_stride + 1
    w0 = spec.widths[0]
    rows.append((f"stem conv {st.conv1_kernel}x{st.conv1_kernel}"
                 f"/s{st.conv1_stride}",
                 (oh, oh, w0),
                 n_params((st.conv1_kernel, st.conv1_kernel,
                           spec.in_channels, w0))))
    rows.append(("stem bn", (oh, oh, w0), n_params((w0,), (w0,))))
    if st.relu1:
        rows.append(("stem relu (quant)", (oh, oh, w0), 0))
    if st.pool1_kernel is not None:
        oh = (oh + 2 * 1 - st.pool1_kernel) // st.pool1_stride + 1
        rows.append((f"maxpool {st.pool1_kernel}x{st.pool1_kernel}"
                     f"/s{st.pool1_stride}", (oh, oh, w0), 0))
    for i, (indim, outdim, half) in enumerate(spec.block_layout()):
        stride = 2 if half else 1
        oh = (oh + 2 - 3) // stride + 1
        p = (n_params((3, 3, indim, outdim), (outdim,), (outdim,),
                      (3, 3, outdim, outdim), (outdim,), (outdim,)))
        if indim != outdim:
            p += n_params((1, 1, indim, outdim), (outdim,), (outdim,))
        tag = f"block{i} {indim}->{outdim}" + ("/s2" if half else "")
        if indim != outdim:
            tag += " +shortcut"
        rows.append((tag, (oh, oh, outdim), p))
    kp = st.avgpool_kernel
    oh_p = oh // kp
    F_ = oh_p * oh_p * spec.widths[-1]
    rows.append((f"avgpool {kp}x{kp} + flatten", (F_,), 0))
    rows.append(("classifier (clear)", (spec.num_classes,),
                 n_params((F_, spec.num_classes), (spec.num_classes,))))

    if params is not None:
        total = sum(int(np.prod(np.shape(leaf)))
                    for leaf in tree_leaves(params))
    else:
        total = sum(r[2] for r in rows)
    name_w = max(len(r[0]) for r in rows) + 2
    lines = [f"{spec.name}: input {spec.in_channels}x{spec.img_size}^2, "
             f"bit_width {spec.bit_width}, "
             f"{'QAT' if spec.quantized else 'float'}"]
    lines += [f"  {r[0]:<{name_w}} out={'x'.join(map(str, r[1])):<12} "
              f"params={r[2]:,}" for r in rows]
    lines.append(f"  total params: {total:,}"
                 + (" (from param pytree)" if params is not None else ""))
    return "\n".join(lines)
