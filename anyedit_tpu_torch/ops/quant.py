"""W8A8 int8 quantization for the diffusion hot path (the opt-in fast mode).

Counterpart of `anyedit_tpu/ops/quant.py`, with the same arithmetic:

  * weights: symmetric int8 per OUTPUT channel, clipped to +-127, with an
    fp32 `kernel_scale`; activations: a dynamic absmax scale per row (Dense)
    or per sample over (C, H, W) (conv), the finest that keeps the scaled
    contraction linear;
  * the contraction is int8 x int8 accumulated exactly in int32, then
    dequantized as `acc * (x_scale * kernel_scale) + bias` in fp32 and cast
    to the module dtype;
  * rounding is half to even (`torch.round`, as `jnp.round`).

Weights keep the port's layouts: (out, in) for Dense, OIHW for conv. The
int32 contraction is a library GEMM, as the JAX package leaves it to XLA:
`torch._int_mm` (cuBLASLt) on CUDA, with the conv as an int8 im2col in
front of it (torch has no int8 conv on CUDA, and a bf16 or TF32 conv over
int8 values is not exact once partial sums pass 2^24: up to
127^2 * 9 * 2560 = 3.7e8 here). On the CPU the plain version contracts in
float64, which is exact for these sums.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

_EPS = 1e-8


@functools.lru_cache(maxsize=None)
def _c127(device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode (the
    # zoo's), so that autograd may still save it as a divisor later
    with torch.inference_mode(False):
        return torch.tensor(127.0, device=device)


def div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 in fp32, correctly rounded on every device (the CPU's and
    JAX's quotient). PyTorch's CUDA kernel turns a division by a Python
    scalar into a multiplication by the scalar's rounded reciprocal, which
    misses the IEEE quotient by one unit in the last place for some t, and
    the x / s = 63.5 ties of the absmax scales then round to the other
    code. A divisor that is a tensor on t's device takes the IEEE
    division, in the same one launch."""
    return t / _c127(t.device)


def absmax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Symmetric quantization scale so that absmax(x) maps to 127 (fp32,
    reduced dims kept). The max-norm is exact in x's own dtype, so it is
    taken there and upcast after."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=dim, keepdim=True).float()
    return div127(torch.clamp(amax, min=_EPS))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # x / scale promotes x to fp32 exactly, then divides (as x.astype(f32) / s);
    # a tensor divisor takes CUDA's IEEE division
    q = torch.div(x, scale).round_().clamp_(-127, 127)
    return q.to(torch.int8)


def quantize_kernel(kernel: torch.Tensor, out_dim: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float kernel -> (int8 kernel, fp32 per-output-channel scale).

    `out_dim` names the output-channel axis: 0 for the port's (out, in) and
    OIHW layouts, -1 for the JAX package's (in, out) and HWIO."""
    out_dim %= kernel.dim()
    dims = tuple(d for d in range(kernel.dim()) if d != out_dim)
    scale = absmax_scale(kernel, dims)
    return quantize_int8(kernel, scale), scale.reshape(-1).float()


# `torch._int_mm` raises unless M > 16: fewer rows are padded up to this
_INT_MM_MIN_ROWS = 32


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact.

    CPU tensors contract in float64 (exact below 2^53). CUDA tensors go to
    `torch._int_mm` (cuBLASLt), which raises unless M > 16 and K and N are
    multiples of 8 (the UNet's and the Llamas' K and N are). A smaller M (a
    decode step at batch 8, a short self-check batch) is padded with zero
    rows up to _INT_MM_MIN_ROWS and the result sliced back: exact, since a
    zero row contracts to zero and touches no other row. The rows are padded
    after quantization, so no zero row reaches an activation scale.
    b is best column-major (a transposed (N, K) weight)."""
    if a.device.type == "cpu":
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {a.device}")
    return int_mm_padded(a, b)


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm` at any M: at most 16 rows are padded with zero rows
    to _INT_MM_MIN_ROWS, and the result sliced back."""
    m = a.shape[0]
    if m > 16:
        return torch._int_mm(a, b)
    return torch._int_mm(F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m)), b)[:m]


def int8_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """int8 NCHW x int8 OIHW conv -> int32 NHWC (N, Ho, Wo, O), exact.

    im2col by views (any dtype) and one copy, then `int8_matmul`; the
    column order (c, i, j) matches w.reshape(O, C*kh*kw)."""
    o, c, kh, kw = w.shape
    if padding:
        x = F.pad(x, (padding,) * 4)
    n = x.shape[0]
    cols = x.unfold(2, kh, stride).unfold(3, kw, stride)   # (N, C, Ho, Wo, kh, kw)
    ho, wo = cols.shape[2], cols.shape[3]
    cols = cols.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw)
    acc = int8_matmul(cols, w.reshape(o, c * kh * kw).t())
    return acc.reshape(n, ho, wo, o)


class _Quant(nn.Module):
    """Buffers shared by the W8A8 modules: `weight` (int8, output channel
    first), `kernel_scale` (fp32, per output channel), `bias` (fp32)."""

    def __init__(self, shape, use_bias: bool, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(shape, dtype=torch.int8,
                                                   device=device))
        self.register_buffer("kernel_scale", torch.ones(shape[0], device=device))
        self.register_buffer("bias", torch.zeros(shape[0], device=device)
                             if use_bias else None)

    def _dequant(self, acc: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        # int32 * fp32 converts acc to fp32 inside the one multiply
        y = acc * (xs * self.kernel_scale)
        if self.bias is not None:
            y += self.bias
        return y.to(self.dtype)


class QuantDense(_Quant):
    """W8A8 Linear: int8 weight (out, in), per-row activation scale."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__((out_features, in_features), bias, dtype, device)

    def forward(self, x):
        xs = absmax_scale(x, -1)                       # (..., 1)
        xq = quantize_int8(x, xs)
        acc = int8_matmul(xq.reshape(-1, x.shape[-1]), self.weight.t())
        return self._dequant(acc.reshape(*x.shape[:-1], -1), xs)


class QuantConv(_Quant):
    """W8A8 NCHW conv: int8 OIHW weight, per-sample activation scale."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dtype=torch.bfloat16,
                 device=None):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size),
                         True, dtype, device)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        xs = absmax_scale(x, (1, 2, 3))                # (N, 1, 1, 1)
        acc = int8_conv2d(quantize_int8(x, xs), self.weight, self.stride,
                          self.padding)                # (N, Ho, Wo, O) int32
        y = self._dequant(acc, xs.reshape(-1, 1, 1, 1))
        return y.permute(0, 3, 1, 2).contiguous()


class QuantTokenProj(QuantDense):
    """W8A8 Linear over the tokens (B, L, C) of one feature map, with one
    activation scale per sample over (L, C): the arithmetic of a W8A8 1x1
    conv (the JAX module's projection) on weights held in the Linear layout."""

    def forward(self, x):
        xs = absmax_scale(x, (1, 2))                   # (B, 1, 1)
        acc = int8_matmul(quantize_int8(x, xs).reshape(-1, x.shape[-1]), self.weight.t())
        return self._dequant(acc.reshape(*x.shape[:-1], -1), xs)


def make_dense(in_features: int, out_features: int, *, quant: bool,
               bias: bool = True, dtype=torch.bfloat16, device=None) -> nn.Module:
    """nn.Linear or its W8A8 drop-in: the one place the choice lives."""
    cls = QuantDense if quant else nn.Linear
    return cls(in_features, out_features, bias=bias, dtype=dtype, device=device)


def make_conv1x1(in_channels: int, out_channels: int, *, quant: bool,
                 dtype=torch.bfloat16, device=None) -> nn.Module:
    """1x1 nn.Conv2d or its W8A8 drop-in (projection convs)."""
    if quant:
        return QuantConv(in_channels, out_channels, 1, padding=0, dtype=dtype,
                         device=device)
    return nn.Conv2d(in_channels, out_channels, 1, dtype=dtype, device=device)


def make_token_proj(in_features: int, out_features: int, *, quant: bool,
                    dtype=torch.bfloat16, device=None) -> nn.Module:
    """A transformer's proj_in / proj_out in the Linear layout (SDXL's
    `use_linear_projection`): nn.Linear, or `QuantTokenProj`."""
    cls = QuantTokenProj if quant else nn.Linear
    return cls(in_features, out_features, dtype=dtype, device=device)


def quantize_state_dict(quant_module: nn.Module,
                        float_state_dict: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """A float state dict -> the state dict of `quant_module`.

    Walks the quant module's keys: wherever it holds an int8 `weight` beside
    a `kernel_scale`, the float dict's same-key weight is quantized per
    output channel; every other entry is copied in the target's dtype.
    Raises KeyError on a structural mismatch (a missing key or a wrong
    shape), so a wrong pairing fails loudly instead of running half-random.
    """
    target = quant_module.state_dict()
    out: dict[str, torch.Tensor] = {}
    for key, tgt in target.items():
        if key.endswith(".kernel_scale"):
            if key[:-len("kernel_scale")] + "weight" not in target:
                raise KeyError(f"kernel_scale without weight at {key}")
            continue
        if key not in float_state_dict:
            raise KeyError(f"missing float param {key}")
        src = float_state_dict[key]
        if tuple(src.shape) != tuple(tgt.shape):
            raise KeyError(f"shape mismatch at {key}: float {tuple(src.shape)} "
                           f"vs quant {tuple(tgt.shape)}")
        scale_key = key[:-len("weight")] + "kernel_scale"
        if tgt.dtype == torch.int8 and key.endswith("weight") and scale_key in target:
            out[key], out[scale_key] = quantize_kernel(src.float())
        else:
            out[key] = src.to(tgt.dtype)
    return out
