"""LaMa, large-mask inpainting with Fast Fourier Convolutions (counterpart
of `anyedit_tpu/models/lama.py`).

A ResNet-style generator whose residual blocks are FFCs: a local conv
branch and a global branch that convolves in the Fourier domain
(`torch.fft.rfft2` / `irfft2` over H and W, `norm="ortho"`). BatchNorm is
`FrozenBN`, the inference affine with loadable running statistics, in fp32.

Modules carry the saicinpainting big-lama generator's names (`model.1.ffc.
convl2l`, `model.5.conv1.ffc.convg2g.fu.conv_layer`, ...), so its state dict
loads by name; `weights/bridge.py::lama_state_dict` maps the JAX package's
tree onto them. Two layouts differ from the JAX module and are the
bridge's to carry: the FourierUnit interleaves (re, im) per channel on its
1x1 conv where the JAX one concatenates [re..., im...], and the up-sampling
`ConvTranspose2d(3, stride 2, padding 1, output_padding 1)` is what the JAX
side writes as padding ((1, 2), (1, 2)) with `transpose_kernel=True`.

Convolutions run channels-first; the generator takes and returns NHWC, as
the JAX one does. The stem, block and out convs reflect-pad (numpy
"reflect", the edge not repeated); the stride-2 downsamples zero-pad.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    base: int = 64
    n_downsample: int = 3
    n_blocks: int = 9            # big-lama: 18
    ratio_g: float = 0.75        # global-branch channel fraction in blocks
    dtype: Any = torch.float32   # the FFT path runs in fp32


LAMA = LamaConfig()
BIG_LAMA = LamaConfig(n_blocks=18)
TINY_LAMA = LamaConfig(base=8, n_downsample=2, n_blocks=2)


class FrozenBN(nn.Module):
    """Inference BatchNorm over NCHW in fp32:
    y = (x - mean) * sqrt(1 / (var + eps)) * weight + bias."""

    param_init = {"weight": ("const", 1.0), "bias": ("const", 0.0),
                  "running_mean": ("const", 0.0), "running_var": ("const", 1.0)}

    def __init__(self, c: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        kw = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def col(t):
            return t[None, :, None, None]
        y = (x.float() - col(self.running_mean)) \
            * col(torch.sqrt(1.0 / (self.running_var + self.eps))) \
            * col(self.weight) + col(self.bias)
        return y.to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1, reflect: bool = True, **kw):
    """k x k conv with bias, padded k // 2: reflect (stem, blocks, out) or
    zeros (the stride-2 downsamples)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     padding_mode="reflect" if reflect else "zeros", **kw)


class FourierUnit(nn.Module):
    """rFFT2 -> 1x1 conv over (re, im) interleaved per channel -> FrozenBN
    -> ReLU -> irFFT2 at the input's spatial size."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv_layer = nn.Conv2d(2 * cin, 2 * cout, 1, **kw)
        self.bn = FrozenBN(2 * cout, device=kw.get("device"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        f = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        f = torch.stack([f.real, f.imag], dim=2).reshape(b, 2 * c, h, -1)
        f = F.relu(self.bn(self.conv_layer(f.to(x.dtype)))).float()
        f = f.reshape(b, -1, 2, h, f.shape[-1])
        out = torch.fft.irfft2(torch.complex(f[:, :, 0], f[:, :, 1]), s=(h, w),
                               dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    """The global-to-global path: 1x1 conv, FrozenBN, ReLU (`conv1`), the
    FourierUnit added back, then a 1x1 conv (`conv2`)."""

    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(cin, cout // 2, 1, **kw),
                                   FrozenBN(cout // 2, device=kw.get("device")), nn.ReLU())
        self.fu = FourierUnit(cout // 2, cout // 2, **kw)
        self.conv2 = nn.Conv2d(cout // 2, cout, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        return self.conv2(h + self.fu(h))


class FFC(nn.Module):
    """Fast Fourier Convolution: the 2x2 grid of local/global cross paths
    (a global input of width 0 has no g2l / g2g)."""

    def __init__(self, cin_l: int, cin_g: int, cout: int, ratio_g: float, k: int = 3,
                 stride: int = 1, reflect: bool = True, **kw):
        super().__init__()
        og = int(cout * ratio_g)
        ol = cout - og
        self.convl2l = _conv(cin_l, ol, k, stride, reflect, **kw)
        if og:
            self.convl2g = _conv(cin_l, og, k, stride, reflect, **kw)
        if cin_g:
            self.convg2l = _conv(cin_g, ol, k, stride, reflect, **kw)
            self.convg2g = SpectralTransform(cin_g, og, **kw)

    def forward(self, x_l, x_g=None):
        y_l = self.convl2l(x_l)
        y_g = self.convl2g(x_l) if hasattr(self, "convl2g") else None
        if x_g is not None:
            y_l = y_l + self.convg2l(x_g)
            y_g = y_g + self.convg2g(x_g)
        return y_l, y_g


class FFCBnAct(nn.Module):
    """FFC, then FrozenBN and ReLU on each branch that exists."""

    def __init__(self, cin_l: int, cin_g: int, cout: int, ratio_g: float, **kw):
        super().__init__()
        dev = kw.get("device")
        self.ffc = FFC(cin_l, cin_g, cout, ratio_g, **kw)
        og = int(cout * ratio_g)
        self.bn_l = FrozenBN(cout - og, device=dev)
        if og:
            self.bn_g = FrozenBN(og, device=dev)

    def forward(self, x_l, x_g=None):
        y_l, y_g = self.ffc(x_l, x_g)
        y_l = F.relu(self.bn_l(y_l))
        return y_l, (None if y_g is None else F.relu(self.bn_g(y_g)))


class FFCResBlock(nn.Module):
    def __init__(self, ch: int, ratio_g: float, **kw):
        super().__init__()
        g = int(ch * ratio_g)
        self.conv1 = FFCBnAct(ch - g, g, ch, ratio_g, **kw)
        self.conv2 = FFCBnAct(ch - g, g, ch, ratio_g, **kw)

    def forward(self, x_l, x_g):
        h_l, h_g = self.conv2(*self.conv1(x_l, x_g))
        return x_l + h_l, x_g + h_g


class LamaGenerator(nn.Module):
    """(image (B, H, W, 3) in [0, 1] or [-1, 1], mask (B, H, W, 1) in {0, 1})
    -> the inpainted image, same range: the input is the masked image and the
    mask, the output `mask * prediction + (1 - mask) * image`. H and W are
    multiples of 2**n_downsample (`pad_to_modulo`).

    `model` is the saicinpainting Sequential's index space: 0 pad, 1 stem,
    2..1+nd downsamples, then the blocks, the concat, (ConvTranspose2d,
    FrozenBN, ReLU) trios, pad and the out conv; the parameter-free entries
    are kept so the indices match."""

    def __init__(self, cfg: LamaConfig = LAMA, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        kw = dict(dtype=c.dtype, device=device)
        layers: list[nn.Module] = [nn.Identity(),
                                   FFCBnAct(4, 0, c.base, 0.0, k=7, **kw)]
        ch = c.base
        for i in range(c.n_downsample):
            ratio = c.ratio_g if i == c.n_downsample - 1 else 0.0
            layers.append(FFCBnAct(ch, 0, 2 * ch, ratio, stride=2, reflect=False, **kw))
            ch *= 2
        layers += [FFCResBlock(ch, c.ratio_g, **kw) for _ in range(c.n_blocks)]
        layers.append(nn.Identity())                       # the tuple concat
        for _ in range(c.n_downsample):
            layers += [nn.ConvTranspose2d(ch, ch // 2, 3, stride=2, padding=1,
                                          output_padding=1, **kw),
                       FrozenBN(ch // 2, device=device), nn.ReLU()]
            ch //= 2
        layers += [nn.Identity(), _conv(ch, 3, 7, **kw)]
        self.model = nn.ModuleList(layers)

    def forward(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        nd, nb = c.n_downsample, c.n_blocks
        x = torch.cat([image * (1.0 - mask), mask], dim=-1).permute(0, 3, 1, 2)
        h_l, h_g = self.model[1](x.to(c.dtype).contiguous())
        for i in range(2, 2 + nd):
            h_l, h_g = self.model[i](h_l, h_g)
        for i in range(2 + nd, 2 + nd + nb):
            h_l, h_g = self.model[i](h_l, h_g)
        h = torch.cat([h_l, h_g], dim=1)
        for i in range(3 + nd + nb, 3 + 4 * nd + nb):
            h = self.model[i](h)
        out = self.model[4 + 4 * nd + nb](h)
        out = torch.sigmoid(out.float()).permute(0, 2, 3, 1)
        return mask * out + (1.0 - mask) * image


def _reflect_index(n: int, total: int, device) -> torch.Tensor:
    """numpy's "reflect" indices for an axis of n padded at its end to
    `total`: the edge is not repeated, and a pad wider than the axis
    reflects again (where `F.pad` refuses it)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    i = i % (2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def pad_to_modulo(x: torch.Tensor, mod: int = 8) -> tuple[torch.Tensor, tuple[int, int]]:
    """Reflect-pad the H, W of (..., H, W, C) at their ends to multiples of
    `mod` (the reference's pad_img_to_modulo); returns (padded, (H, W))."""
    h, w = x.shape[-3], x.shape[-2]
    ph, pw = (mod - h % mod) % mod, (mod - w % mod) % mod
    y = x.index_select(-3, _reflect_index(h, h + ph, x.device))
    return y.index_select(-2, _reflect_index(w, w + pw, x.device)), (h, w)
