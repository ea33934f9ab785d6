"""Fake quantization (Brevitas semantics) with its QAT gradients,
counterpart of ``dct_cryptonets_tpu.ops.quant``.

* weights — per-tensor scale max|w| / (2^(b-1)-1), narrow signed range,
  the scale taken from the weights and not trained;
* QuantIdentity activations — signed [-2^(b-1), 2^(b-1)-1], learned scale;
* QuantReLU activations — unsigned [0, 2^b - 1], learned scale.

The rounding has a straight-through gradient inside the range and the
learned scales take the LSQ gradient (Esser et al., 2020), as the JAX
package's ``_fake_quant`` custom VJP does.
"""
import torch


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` rounded once, on every device: a Python-number divisor
    takes a reciprocal multiply on CUDA, an ulp away from the JAX
    package's division, which moves a value on a rounding or range edge."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def weight_scale(w: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    return true_div(torch.clamp(w.abs().max(), min=1e-8), qmax)


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x / scale), qmin, qmax) * scale``.  Backward: the input
    gradient passes where ``x / scale`` lies in [qmin, qmax]; the scale
    gradient is LSQ's, ``sum(g * ds) / sqrt(numel * qmax)`` with
    ``ds = round(xs) - xs`` inside the range and ``clip(xs, qmin, qmax)``
    outside it; ``numel`` is ``x.numel()`` unless given (a data-parallel
    shard passes the global batch's)."""

    @staticmethod
    def forward(ctx, x, scale, qmin: int, qmax: int, numel=None):
        ctx.save_for_backward(x, scale)
        ctx.qrange = (qmin, qmax)
        ctx.numel = x.numel() if numel is None else numel
        return torch.clamp(torch.round(x / scale), qmin, qmax) * scale

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        qmin, qmax = ctx.qrange
        xs = x / scale
        in_range = (xs >= qmin) & (xs <= qmax)
        gx = torch.where(in_range, g, torch.zeros_like(g))
        ds = torch.where(in_range, torch.round(xs) - xs,
                         torch.clamp(xs, qmin, qmax))
        n = torch.tensor(ctx.numel, dtype=x.dtype, device=x.device)
        grad_scale = 1.0 / torch.sqrt(n * qmax)
        gscale = (torch.sum(g * ds) * grad_scale).reshape(scale.shape)
        return gx, gscale, None, None, None


def _fake_quant(x: torch.Tensor, scale: torch.Tensor, qmin: int,
                qmax: int, numel=None) -> torch.Tensor:
    return _FakeQuant.apply(x, scale, qmin, qmax, numel)


def _floor_scale(scale: torch.Tensor) -> torch.Tensor:
    return torch.maximum(scale, scale.new_tensor(1e-8))


def fake_quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Brevitas weight fake-quant: scale from the weights (no gradient),
    straight-through rounding."""
    qmax = 2 ** (bits - 1) - 1
    return _fake_quant(w, weight_scale(w, bits).detach(), -qmax, qmax)


def quantize_weight_int(w: torch.Tensor, bits: int):
    """Integer weight and its scale, for circuit lowering."""
    qmax = 2 ** (bits - 1) - 1
    scale = weight_scale(w, bits)
    w_int = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int32)
    return w_int, scale


def fake_quant_act_signed(x: torch.Tensor, scale: torch.Tensor,
                          bits: int, numel=None) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    return _fake_quant(x, _floor_scale(scale), -(qmax + 1), qmax, numel)


def fake_quant_relu(x: torch.Tensor, scale: torch.Tensor,
                    bits: int, numel=None) -> torch.Tensor:
    return _fake_quant(x, _floor_scale(scale), 0, 2 ** bits - 1, numel)


def act_qrange(bits: int, signed: bool, relu: bool):
    if relu:
        return 0, 2 ** bits - 1
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1
