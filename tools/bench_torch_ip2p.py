"""bench.py's workload through the PyTorch port, on one NVIDIA GPU.

    python3 tools/bench_torch_ip2p.py              # pairs/hour, one JSON line
    python3 tools/bench_torch_ip2p.py --kernels    # K1/K2 vs plain, JSON lines
    python3 tools/bench_torch_ip2p.py --profile    # device time by kernel class

The workload is `bench.py`'s: 512 px, 50 DDIM steps, 3-way CFG as one
batch-3n UNet call per step, batch n = 8, VAE encode + decode, seeded
random weights drawn on the card (throughput does not depend on the
weights). The time is the best of 3 runs after one warm-up run, host clock
around work that ends in a device synchronise. `--kernels` times the hand
kernels against their plain PyTorch versions at the main path's shapes.
Every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZE = 512
STEPS = 50
BATCH = 8


def card() -> dict:
    import torch
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": out.strip().splitlines()[0]}


def bench_pairs_per_hour(dev, n: int) -> dict:
    import torch
    from anyedit_tpu_torch.diffusion import ip2p_edit
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.models.vae import SD_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.schedulers import make_noise_schedule
    from anyedit_tpu_torch.weights.init import seeded_init_

    ucfg, vcfg = SD15_IP2P_UNET, SD_VAE
    unet = seeded_init_(UNet2DCondition(ucfg, device=dev), 0).eval()
    vae = seeded_init_(AutoencoderKL(vcfg, device=dev), 1).eval()
    ns = make_noise_schedule(device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    px = torch.randn(n, SIZE, SIZE, 3, generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.zeros(n, 77, ucfg.context_dim, device=dev, dtype=torch.bfloat16)
    sf = vcfg.scaling_factor
    hw = SIZE // 2 ** (len(vcfg.block_channels) - 1)
    lc = vcfg.latent_channels

    @torch.inference_mode()
    def edit_batch(seed):
        img_lat = vae.encode(px)[0] * sf
        g = torch.Generator(device=dev).manual_seed(seed)
        lat = ip2p_edit(unet, ns, img_lat, ctx, ctx, num_steps=STEPS,
                        guidance_scale=8.0, image_guidance_scale=0.9, generator=g)
        out = vae.decode((lat / sf).to(torch.bfloat16))
        torch.cuda.synchronize()
        return out

    edit_batch(0)
    best = float("inf")
    for i in range(3):
        t0 = time.perf_counter()
        out = edit_batch(i + 1)
        best = min(best, time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite decoded output")

    x = torch.randn(3 * n, hw, hw, ucfg.in_channels, device=dev)
    t = torch.full((3 * n,), 501, device=dev)
    ctx3 = torch.cat([ctx, ctx, ctx])
    with torch.inference_mode():
        step_ms = time_ms(lambda: unet(x, t, ctx3), iters=5)
        enc_ms = time_ms(lambda: vae.encode(px), iters=3)
        dec_ms = time_ms(lambda: vae.decode(torch.randn(n, hw, hw, lc, device=dev)),
                         iters=3)
    return {"metric": "edited pairs/hour/GPU (512px, 50-step DDIM, 3-way CFG "
                      f"IP2P, batch {n}, PyTorch port)",
            "value": 3600.0 / best * n, "unit": "pairs/hour",
            "seconds_per_batch": best, "unet_step_ms": step_ms,
            "vae_encode_ms": enc_ms, "vae_decode_ms": dec_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def bench_kernels(dev) -> list[dict]:
    """K1 and K2 against their plain versions at the main path's shapes
    (n = 2 images: UNet batch 6, so B*H = 48; VAE at n = 1)."""
    import torch
    from anyedit_tpu_torch.ops import kernel_check as kc

    rows = []
    for bh, l, d in ((48, 4096, 40), (48, 1024, 80)):
        r = kc.check_flash_nomax(bh, l, d, dev)
        rows.append({"kernel": "flash_nomax", "shape": [bh, l, d], **r})
    for shape, silu in (((6, 320, 64, 64), True), ((6, 640, 64, 64), True),
                        ((6, 640, 32, 32), False), ((6, 1280, 16, 16), True),
                        ((6, 2560, 8, 8), True), ((1, 128, 512, 512), True),
                        ((1, 256, 256, 256), True), ((1, 512, 64, 64), True)):
        r = kc.check_group_norm(shape, silu, dev, dtype=torch.bfloat16)
        rows.append({"kernel": "group_norm", "shape": list(shape), "silu": silu, **r})
    return rows


def _category(kernel: str) -> str:
    """Coarse class of a CUDA kernel name, for the time breakdown."""
    n = kernel.lower()
    for cat, keys in (("K1 flash_nomax", ("flash_nomax",)),
                      ("K2 group_norm", ("group_norm",)),
                      ("conv (cuDNN, incl. layout transposes)",
                       ("conv", "cudnn", "fprop", "nchwtonhwc", "nhwctonchw")),
                      ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "gemv")),
                      ("softmax", ("softmax",)),
                      ("elementwise / copy / reduce",
                       ("elementwise", "vectorized", "reduce", "copy", "cat",
                        "index", "fill", "upsample", "unrolled"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def profile_breakdown(dev) -> list[dict]:
    """Device time by kernel class for one full-width UNet call at batch 3
    (one request) and 24 (the bench batch), and for VAE encode and decode at
    n = 1: `torch.profiler` over a few calls, beside the CUDA-event time of
    the same calls unprofiled. busy_share = device busy / event time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.models.vae import SD_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.weights.init import seeded_init_

    unet = seeded_init_(UNet2DCondition(SD15_IP2P_UNET, device=dev), 0).eval()
    vae = seeded_init_(AutoencoderKL(SD_VAE, device=dev), 1).eval()
    hw = SIZE // 8
    work = []
    for b in (3, 3 * BATCH):
        x = torch.randn(b, hw, hw, SD15_IP2P_UNET.in_channels, device=dev)
        t = torch.full((b,), 501, device=dev)
        ctx = torch.randn(b, 77, SD15_IP2P_UNET.context_dim, device=dev,
                          dtype=torch.bfloat16)
        work.append((f"unet batch {b}", lambda x=x, t=t, ctx=ctx: unet(x, t, ctx), 5))
    px = torch.randn(1, SIZE, SIZE, 3, device=dev, dtype=torch.bfloat16)
    z = torch.randn(1, hw, hw, SD_VAE.latent_channels, device=dev)
    work += [("vae encode n=1", lambda: vae.encode(px), 3),
             ("vae decode n=1", lambda: vae.decode(z), 3)]

    rows = []
    for label, fn, iters in work:
        with torch.inference_mode():
            event_ms = time_ms(fn, iters)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        ms, launches = collections.Counter(), collections.Counter()
        for e in prof.key_averages():
            # self_cuda_time_total is the older torch's name of the field
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if e.device_type != DeviceType.CUDA or us <= 0:
                continue
            cat = _category(e.key)
            ms[cat] += us / iters / 1e3
            launches[cat] += e.count / iters
        busy = sum(ms.values())
        rows.append({"label": label, "event_ms": event_ms, "device_busy_ms": busy,
                     "busy_share": busy / event_ms,
                     "ms_by_class": dict(ms.most_common()),
                     "launches_by_class": {k: round(v) for k, v in launches.items()}})
    return rows


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="time K1/K2 against their plain versions instead")
    mode.add_argument("--profile", action="store_true",
                      help="device time by kernel class for the UNet and VAE instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_ip2p: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    device = card()
    if args.kernels or args.profile:
        for row in (bench_kernels if args.kernels else profile_breakdown)(dev):
            print(json.dumps({**row, "device": device}))
    else:
        print(json.dumps({**bench_pairs_per_hour(dev, BATCH), "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
