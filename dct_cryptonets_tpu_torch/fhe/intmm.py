"""Exact int8 x int8 -> int32 matrix products for the levelled ops and the
keyswitch (plain large products outside any TPU kernel; the TPU package
left them to XLA's int8 dot).

``torch._int_mm`` on CUDA needs more than 16 rows and a depth and width
that are multiples of 8, so operands are zero-padded to those rules and
the result is sliced back.  Zero rows and columns add nothing, so the
product is unchanged.  A column-major ``b`` (the transpose of a contiguous
matrix) is passed on as it is: the card's int8 GEMM runs about 7x faster
on it than on a row-major one (NVIDIA H100 80GB HBM3, 700 W, at
4096 x 8192 x 32768).
"""
import torch
import torch.nn.functional as F


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact."""
    m, k = a.shape
    k2, n = b.shape
    assert k == k2, (a.shape, b.shape)
    pm = max(0, 17 - m)
    pk = (-k) % 8
    pn = (-n) % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    if not b.t().is_contiguous():
        b = b.contiguous()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n]


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int,
           padding: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * oh * ow, kh * kw * C) patches, columns in the
    (dy, dx, c) order of an HWIO kernel reshaped to (kh * kw * C, Cout)."""
    B, H, W, C = x.shape
    p, s = padding, stride
    if p:
        x = F.pad(x, (0, 0, p, p, p, p))
    oh = (H + 2 * p - kh) // s + 1
    ow = (W + 2 * p - kw) // s + 1
    cols = [x[:, dy:dy + (oh - 1) * s + 1:s, dx:dx + (ow - 1) * s + 1:s, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(cols, dim=3).reshape(B * oh * ow, kh * kw * C)


def conv_out_hw(H: int, W: int, kh: int, kw: int, stride: int,
                padding: int):
    return ((H + 2 * padding - kh) // stride + 1,
            (W + 2 * padding - kw) // stride + 1)
