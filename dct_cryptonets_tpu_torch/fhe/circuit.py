"""Levelled-op + TLU circuit IR and its bit-exact integer simulator.

Counterpart of ``dct_cryptonets_tpu.fhe.circuit``: the same IR dataclasses
(the compiler's output, the runtime's input), and the integer simulator on
``int64`` tensors.  The simulator's integer convolutions run as exact
float64 products (im2col + matmul), never through cuDNN, whose float32
convolutions may use TF32, Winograd or FFT on the card and are then not
exact.

TLU semantics (the bit-exactness contract between simulator and runtime):

  index  u = floor((acc + 2^(shift-1)) / 2^shift) + 2^(in_bits-1)
  output y = table[channel, u]
"""
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .intmm import conv_out_hw, im2col


@dataclass(frozen=True)
class TluSpec:
    in_bits: int          # r_eff: table has 2^r_eff entries
    shift: int            # accumulator LSBs dropped (n_in - in_bits)
    out_n: int            # bit budget of the output tensor (sets Delta_out)

    def __post_init__(self):
        assert self.in_bits >= 1 and self.shift >= 0


@dataclass
class QuantIn:
    scale: float          # x_int = clamp(round(x / scale), lo, hi)
    bits: int             # signed symmetric n_bits quantization
    n: int                # encoding budget of the produced tensor
    out: str = "x0"


@dataclass
class Conv:
    x: str
    w: np.ndarray         # (kh, kw, Cin, Cout) int32
    stride: int
    padding: int
    out: str


@dataclass
class PoolSum:
    x: str
    k: int
    out: str


@dataclass
class Window:
    """Strided spatially-shifted view with zero padding (levelled).

    out[i, j] = x[i*stride + dy - pad, j*stride + dx - pad]  (0 outside)
    Used to expand maxpool into pairwise maxes (max(a,b) = a + relu(b-a),
    one PBS per pair) for the RGB 7x7-stem topologies.
    """
    x: str
    dy: int
    dx: int
    stride: int
    pad: int
    out_h: int
    out_w: int
    out: str


@dataclass
class AddScaled:
    a: str
    ca: int               # simulator multiplier for a
    b: str
    cb: int
    ja: int               # FHE-side extra power-of-two (encoding align)
    jb: int
    out: str


@dataclass
class AddScaledPC:
    """Per-channel scaled add: out[..., c] = ca[c]*a[..., c] + cb[c]*b[..., c].

    The requant-elided residual add (compiler ``residual_mode='fused'``):
    raw conv accumulators carry a per-channel scale (conv scale x folded-BN
    gamma), so scale unification needs a multiplier pair *per channel*.
    Levelled in FHE — a per-channel integer scalar-mul broadcast over the
    trailing channel axis, no PBS (the per-channel interpretation scale and
    the folded BN bias live in the consuming TLU's per-channel table).
    Multipliers may be negative (negative BN gamma) or zero (dead channel:
    that branch contributes only its bias, which the TLU table carries).
    """
    a: str
    ca: np.ndarray        # (C,) int32 per-channel multipliers for a
    b: str
    cb: np.ndarray        # (C,) int32
    ja: int               # FHE-side extra power-of-two (encoding align)
    jb: int
    out: str


@dataclass
class Rescale:
    """Phase-only re-encoding: out carries the SAME integer value as x but
    at the finer budget n(out) = enc(x) - j (Delta multiplied by 2^j).

    Needed when a tensor's encoding was inflated by a wider consumer on a
    shared path (e.g. the stage-transition block input feeds both the wide
    conv1 and the narrow shortcut conv): the narrow TLU pre-scales its
    accumulator so the table keeps full rounding resolution.  Identity in
    the integer simulator; a single power-of-two scalar-mul in FHE
    (noise also scales by 2^j — negligible next to keyswitch/mod-switch
    noise for the small j seen in practice)."""
    x: str
    j: int
    out: str


@dataclass
class Tlu:
    x: str
    spec: TluSpec
    table: np.ndarray     # (C, 2^in_bits) int32
    out: str


@dataclass
class Output:
    x: str
    scale: float          # feats = y * scale


@dataclass
class Circuit:
    ops: list
    input_shape: tuple            # (H, W, C) of the float input
    n_budget: dict = field(default_factory=dict)   # tensor name -> n bits
    meta: dict = field(default_factory=dict)

    @property
    def num_pbs(self) -> int:
        """PBS invocations per single input sample (per-sample TLU sites)."""
        shapes = self.meta["shapes"]
        return sum(int(np.prod(shapes[op.x]))
                   for op in self.ops if isinstance(op, Tlu))

    def max_bit_width(self) -> int:
        """Largest accumulator bit budget — the reference checks this <= 16
        for FHE feasibility (homomorphic_eval.py:301-306)."""
        return max(self.n_budget.values())

    def dump(self) -> str:
        """Human-readable circuit listing — the framework's analog of the
        reference's MLIR dump (``homomorphic_eval.py:309-311`` writes
        Concrete's circuit to ``mlir.txt``).  One line per op with tensor
        shapes, bit budgets, scales/multipliers, and TLU geometry; suffixed
        with the per-sample cost summary the audit consumes."""
        shapes = self.meta.get("shapes", {})
        nb = self.n_budget

        def fmt(name):
            sh = "x".join(map(str, shapes.get(name, ())))
            return f"{name}:{sh}/n{nb.get(name, '?')}"

        lines = [f"circuit input={self.input_shape} "
                 f"n_bits={self.meta.get('n_bits')} "
                 f"r={self.meta.get('rounding_threshold_bits')} "
                 f"bit_width={self.meta.get('bit_width')}"]
        pbs = 0
        extract = 0
        for op in self.ops:
            if isinstance(op, QuantIn):
                lines.append(f"  quant_in scale={op.scale:.6g} "
                             f"bits={op.bits} -> {fmt(op.out)}")
            elif isinstance(op, Conv):
                lines.append(f"  conv {fmt(op.x)} w={op.w.shape} "
                             f"s={op.stride} p={op.padding} -> {fmt(op.out)}")
            elif isinstance(op, PoolSum):
                lines.append(f"  pool_sum {fmt(op.x)} k={op.k} "
                             f"-> {fmt(op.out)}")
            elif isinstance(op, Window):
                lines.append(f"  window {fmt(op.x)} d=({op.dy},{op.dx}) "
                             f"s={op.stride} -> {fmt(op.out)}")
            elif isinstance(op, AddScaled):
                lines.append(f"  add {op.ca}*{fmt(op.a)}<<{op.ja} + "
                             f"{op.cb}*{fmt(op.b)}<<{op.jb} -> {fmt(op.out)}")
            elif isinstance(op, AddScaledPC):
                lines.append(
                    f"  add_pc |ca|<= {int(np.abs(op.ca).max())}*"
                    f"{fmt(op.a)}<<{op.ja} + |cb|<="
                    f"{int(np.abs(op.cb).max())}*{fmt(op.b)}<<{op.jb} "
                    f"-> {fmt(op.out)}")
            elif isinstance(op, Rescale):
                lines.append(f"  rescale {fmt(op.x)} <<{op.j} "
                             f"-> {fmt(op.out)}")
            elif isinstance(op, Tlu):
                sites = int(np.prod(shapes[op.x]))
                pbs += sites
                extract += sites * op.spec.shift
                lines.append(f"  tlu {fmt(op.x)} r={op.spec.in_bits} "
                             f"shift={op.spec.shift} sites={sites} "
                             f"table={op.table.shape} -> {fmt(op.out)}")
            elif isinstance(op, Output):
                lines.append(f"  output {fmt(op.x)} scale={op.scale:.6g}")
        lines.append(f"  # per-sample: {pbs} PBS, {extract} dropped "
                     f"accumulator bits (exact-rounding extraction upper "
                     f"bound; the audit's keep_low reduces it), "
                     f"max bit-width {self.max_bit_width()}")
        return "\n".join(lines)

    def verify_encodings(self) -> list[str]:
        """Cross-check every op against the forward torus encodings.

        Levelled ops preserve Delta = 2^(63 - enc); a TLU materialized with
        ``in_bits + shift != enc(input)`` or an AddScaled whose ja/jb do not
        re-align actual input encodings would make encrypted execution
        misread phases (invisible to the integer simulator).  Returns a
        list of violation strings — empty means consistent.
        """
        nb = self.n_budget
        enc: dict = {}
        bad: list[str] = []
        for op in self.ops:
            if isinstance(op, QuantIn):
                enc[op.out] = op.n
            elif isinstance(op, (Conv, PoolSum, Window)):
                enc[op.out] = enc[op.x]
            elif isinstance(op, (AddScaled, AddScaledPC)):
                if op.ja != enc[op.a] - nb[op.out]:
                    bad.append(f"add {op.out}: ja={op.ja}, "
                               f"enc({op.a})={enc[op.a]}, n_out={nb[op.out]}")
                if op.jb != enc[op.b] - nb[op.out]:
                    bad.append(f"add {op.out}: jb={op.jb}, "
                               f"enc({op.b})={enc[op.b]}, n_out={nb[op.out]}")
                enc[op.out] = nb[op.out]
            elif isinstance(op, Rescale):
                if op.j < 0:
                    bad.append(f"rescale {op.out}: negative j={op.j}")
                enc[op.out] = enc[op.x] - op.j
            elif isinstance(op, Tlu):
                n_assumed = op.spec.in_bits + op.spec.shift
                if n_assumed != enc[op.x]:
                    bad.append(f"tlu on {op.x}: assumed n={n_assumed}, "
                               f"actual enc={enc[op.x]}")
                enc[op.out] = op.spec.out_n
            elif isinstance(op, Output):
                if nb.get(op.x) != enc[op.x]:
                    bad.append(f"output {op.x}: n_budget={nb.get(op.x)}, "
                               f"enc={enc[op.x]}")
        return bad


# ---------------------------------------------------------------------------
# simulator


def _conv_int(x: torch.Tensor, w: np.ndarray, stride: int,
              padding: int) -> torch.Tensor:
    """Exact integer conv (B, H, W, C) x HWIO -> (B, oh, ow, Cout) int64,
    as a float64 product (operands are small integers: exact)."""
    kh, kw, cin, cout = w.shape
    B, H, W, _ = x.shape
    oh, ow = conv_out_hw(H, W, kh, kw, stride, padding)
    cols = im2col(x.to(torch.float64), kh, kw, stride, padding)
    wm = torch.as_tensor(np.asarray(w, np.float64).reshape(-1, cout),
                         device=x.device)
    return torch.round(cols @ wm).to(torch.int64).reshape(B, oh, ow, cout)


def _pool_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    B, H, W, C = x.shape
    oh, ow = H // k, W // k
    return x[:, :oh * k, :ow * k].reshape(B, oh, k, ow, k, C).sum(dim=(2, 4))


def _window(x: torch.Tensor, op: "Window") -> torch.Tensor:
    """Strided shifted view with zero padding; x: (B, H, W, C) int."""
    p, s = op.pad, op.stride
    xp = F.pad(x, (0, 0, p, p, p, p)) if p else x
    return xp[:, op.dy:op.dy + op.out_h * s:s,
              op.dx:op.dx + op.out_w * s:s, :]


def tlu_index(acc: torch.Tensor, spec: TluSpec) -> torch.Tensor:
    """The canonical rounded-index computation (shared with the runtime)."""
    if spec.shift > 0:
        acc = (acc + (1 << (spec.shift - 1))) >> spec.shift
    u = acc + (1 << (spec.in_bits - 1))
    return torch.clamp(u, 0, (1 << spec.in_bits) - 1)


def quantize_input(x: torch.Tensor, op: "QuantIn") -> torch.Tensor:
    """clip(round(x / scale)) in float32 with a true division (a CUDA
    division by a host scalar multiplies by its reciprocal, which can round
    differently)."""
    qmax = 2 ** (op.bits - 1) - 1
    qmin = -(2 ** (op.bits - 1))
    scale = torch.tensor(op.scale, dtype=torch.float32, device=x.device)
    v = torch.clamp(torch.round(x.to(torch.float32) / scale), qmin, qmax)
    return v.to(torch.int64)


def _lookup(table: np.ndarray, u: torch.Tensor) -> torch.Tensor:
    """out[..., c] = table[c, u[..., c]]."""
    t = torch.as_tensor(np.asarray(table, np.int64), device=u.device)
    return t[torch.arange(t.shape[0], device=u.device), u]


def _run(circuit: Circuit, x: torch.Tensor, ranges: dict | None,
         slip=None):
    """``slip``: optional ``(index, spec) -> index`` applied to every TLU's
    rounded index before its lookup (:func:`simulate_noisy`)."""
    env = {}
    out = None

    def pc_max(name):
        if ranges is not None:
            ranges[name] = env[name].abs().amax(dim=(0, 1, 2)).cpu().numpy()

    for op in circuit.ops:
        if isinstance(op, QuantIn):
            env[op.out] = quantize_input(x, op)
        elif isinstance(op, Conv):
            env[op.out] = _conv_int(env[op.x], op.w, op.stride, op.padding)
            pc_max(op.out)
        elif isinstance(op, PoolSum):
            env[op.out] = _pool_sum(env[op.x], op.k)
            pc_max(op.out)
        elif isinstance(op, Window):
            env[op.out] = _window(env[op.x], op)
        elif isinstance(op, Rescale):
            env[op.out] = env[op.x]          # integer value unchanged
        elif isinstance(op, AddScaled):
            env[op.out] = op.ca * env[op.a] + op.cb * env[op.b]
            pc_max(op.out)
        elif isinstance(op, AddScaledPC):
            dev = env[op.a].device
            ca = torch.as_tensor(np.asarray(op.ca, np.int64), device=dev)
            cb = torch.as_tensor(np.asarray(op.cb, np.int64), device=dev)
            env[op.out] = ca * env[op.a] + cb * env[op.b]
            pc_max(op.out)
        elif isinstance(op, Tlu):
            u = tlu_index(env[op.x], op.spec)
            if slip is not None:
                u = slip(u, op.spec)
            env[op.out] = _lookup(op.table, u)
        elif isinstance(op, Output):
            y = env[op.x]
            out = y.reshape(y.shape[0], -1).to(torch.float32) * op.scale
        else:
            raise TypeError(f"unknown op {op!r}")
    return out, env


def simulate(circuit: Circuit, x, return_env: bool = False):
    """Run the integer circuit on a float input batch (B, H, W, C) (a tensor
    or numpy array; the simulation runs on the tensor's device).

    Returns the dequantized float32 features (B, F); ``return_env=True``
    also returns the wire -> integer tensor environment."""
    x = torch.as_tensor(x)
    out, env = _run(circuit, x, None)
    assert out is not None, "circuit has no Output op"
    return (out, env) if return_env else out


def simulate_noisy(circuit: Circuit, x, generator: torch.Generator,
                   p_slip: float) -> torch.Tensor:
    """:func:`simulate` with the TFHE statistical fault model injected:
    every TLU index moves by +-1 (each direction equally likely) with
    probability ``p_slip``, then is clipped to [0, 2^in_bits) — a PBS
    landing one table window off.  A fast preview of encrypted-accuracy
    degradation without ciphertexts.

    ``generator``: the source of the draws (two uniforms per TLU site, on
    the generator's device); the same seed gives the same output.  Its
    draws are not those of the JAX package's ``jax.random`` key."""
    def slip(u, spec):
        draws = torch.rand((2,) + tuple(u.shape), generator=generator,
                           device=generator.device).to(u.device)
        step = torch.where(draws[1] < 0.5, -1, 1)
        u = u + torch.where(draws[0] < p_slip, step, 0)
        return torch.clamp(u, 0, (1 << spec.in_bits) - 1)

    out, _ = _run(circuit, torch.as_tensor(x), None, slip)
    assert out is not None, "circuit has no Output op"
    return out


def collect_acc_ranges(circuit: Circuit, x) -> dict:
    """Per-channel max |value| of every accumulator tensor (Conv / PoolSum /
    AddScaled(PC) outputs) over a calibration batch: name -> (C,) numpy."""
    ranges: dict = {}
    _run(circuit, torch.as_tensor(x), ranges)
    return ranges
