"""bench.py's workload through the PyTorch port, on one NVIDIA GPU.

    python3 tools/bench_torch_ip2p.py              # pairs/hour, one JSON line
    python3 tools/bench_torch_ip2p.py --int8       # the same with the W8A8 UNet
    python3 tools/bench_torch_ip2p.py --kernels    # K1-K4 vs plain, JSON lines
    python3 tools/bench_torch_ip2p.py --k1-blocks  # K1 at each block shape
    python3 tools/bench_torch_ip2p.py --k2-plans   # K2 under each launch plan
    python3 tools/bench_torch_ip2p.py --k34-blocks # K3 and K4 at each warps a block
    python3 tools/bench_torch_ip2p.py --paths      # UNet calls through K3 and K4
    python3 tools/bench_torch_ip2p.py --profile    # device time by kernel class
    python3 tools/bench_torch_ip2p.py --profile --int8
    python3 tools/bench_torch_ip2p.py --latency [--int8]  # s per 100-step request
    python3 tools/bench_torch_ip2p.py --ground     # grounding stage + color_alter record
    python3 tools/bench_torch_ip2p.py --scorers    # scorer slots + one executor record
    python3 tools/bench_torch_ip2p.py --ultraedit  # SD3-UltraEdit: MMDiT, conditioning, record
    python3 tools/bench_torch_ip2p.py --masactrl   # MasaCtrl / P2P: UNet b4, two records
    python3 tools/bench_torch_ip2p.py --flux       # Flux-schnell: call, pair, textual_change
    python3 tools/bench_torch_ip2p.py --sdxl       # SDXL refine stack: UNet b2, two records
    python3 tools/bench_torch_ip2p.py --visual     # AnyDoor / composition UNet b2, 8 records

The workload is `bench.py`'s: 512 px, 50 DDIM steps, 3-way CFG as one
batch-3n UNet call per step, batch n = 8, VAE encode + decode, seeded
random weights drawn on the card (throughput does not depend on the
weights). `--int8` mirrors `bench.py --int8`: the UNet is W8A8, quantized
from the float init as the zoo does (ops/quant.py), and the VAE stays bf16.
The time is the best of 3 runs after one warm-up run, host clock around
work that ends in a device synchronise. `--kernels` times the hand kernels
against their plain PyTorch versions at the paths' shapes, beside each
kernel's bound and the one PyTorch call that computes the same function
(`ops/kernel_check.py`). `--ground` times the full-width grounding stage
(GroundingDINO SwinB at 800 px, SAM ViT-H at 1024) part by part and one
`color_alter` record, each the median of 3 runs after a warm-up, beside
its device-busy share and its device time by kernel class. `--scorers`
does the same for the full-width scorer slots (CLIP-L vision and text,
the aesthetic MLP, EVA ViT-g + Q-Former + FLAN-T5-XL yes/no) and one gated
`color_alter` record through `FactoryExecutor` (pre-gate on the image size,
as `chip_smoke.py`'s executor run (b)), with the record's seconds by
executor stage. `--ultraedit` does the same for SD3-UltraEdit at full
width (SD3_ULTRAEDIT MMDiT, T5-XXL, CLIP-L with projection, CLIP-bigG, the
SD3 VAE): one MMDiT call at batch 3, the SD3 conditioning of one text, and
one appearance_alter record through the registry with the slot installed
(50 steps, two groundings), with the peak memory of the run.
`--masactrl` times the caption-pair synthesizers on the SD1.5 UNet
(SD15_UNET, SD VAE, CLIP-L): one batch-4 UNet call under the MasaCtrl
processor (swap active) and one under the AttentionStore, one
action_change record (50 steps) and one implicit_change record (3 P2P
pairs of 20 steps); `--flux` times FLUX_SCHNELL (T5-XXL, CLIP-L, the Flux
VAE): one Flux call at batch 1, one `flux_pair` (2 x 4 steps) and one
textual_change record; both the same way, with the run's peak GiB.
`--sdxl` times the SDXL refine stack at published widths (SDXL_UNET, the
SDXL VAE, CLIP-L and CLIP-bigG, the canny and depth ControlNets with their
zero convs drawn live, the IP-Adapter on CLIP-L vision, DEPTH_ANYTHING_L,
the grounder): one UNet call at batch 2 plain, with the canny ControlNet,
and with the ControlNet and the IP-Adapter processor, one implicit_change
record with all four stages and one 480x640 material_transfer record, the
same way. `--visual` times the last slice's edit types at published widths
(`chip_smoke.visual_toolbox`: the grounder, HED, UperNet on Swin-T,
Depth-Anything-V2, SD15_UNET, SD21_ANYDOOR_UNET with its ControlNet, zero
convs drawn live, DINOV2_G at 224 px, the SD VAE): the AnyDoor UNet +
ControlNet call at batch 2 and the SD1.5 UNet call at batch 2 under the
regional processor of a three-region canvas plan, each beside its
`sdxl_bound_ms`, and one 480x640 record of each of the eight types
(visual_bbox, visual_depth, visual_scribble, visual_segment, visual_sketch,
rotation_change, composition, visual_reference) through the registry, the
records profiled on device events only. Every line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402  (the repo root, just put on the path)
    GROUND_HW, K2_GDINO_SHAPES, K3_SHAPES, MATERIAL_RECORD, RECORD, SYNTH_RECORDS,
    VQA_QUESTIONS,
)

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


def build_unet(dev, int8: bool):
    """The full-width IP2P UNet from seed 0: bf16, or W8A8 quantized from
    the fp32 init (the float values the JAX package quantizes)."""
    import dataclasses

    import torch
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.ops.quant import quantize_state_dict
    from anyedit_tpu_torch.weights.init import seeded_init_

    if not int8:
        return seeded_init_(UNet2DCondition(SD15_IP2P_UNET, device=dev), 0).eval()
    fcfg = dataclasses.replace(SD15_IP2P_UNET, dtype=torch.float32)
    float_sd = seeded_init_(UNet2DCondition(fcfg, device=dev), 0).state_dict()
    unet = UNet2DCondition(dataclasses.replace(SD15_IP2P_UNET, quant=True), device=dev)
    unet.load_state_dict(quantize_state_dict(unet, float_sd), strict=True)
    return unet.eval()


def bench_pairs_per_hour(dev, n: int, int8: bool = False) -> dict:
    import torch
    from anyedit_tpu_torch.diffusion import ip2p_edit
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET
    from anyedit_tpu_torch.models.vae import SD_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.schedulers import make_noise_schedule
    from anyedit_tpu_torch.weights.init import seeded_init_

    ucfg, vcfg = SD15_IP2P_UNET, SD_VAE
    unet = build_unet(dev, int8)
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
    mode = ", W8A8 int8 UNet" if int8 else ""
    return {"metric": "edited pairs/hour/GPU (512px, 50-step DDIM, 3-way CFG "
                      f"IP2P{mode}, batch {n}, PyTorch port)",
            "value": 3600.0 / best * n, "unit": "pairs/hour",
            "seconds_per_batch": best, "unet_step_ms": step_ms,
            "vae_encode_ms": enc_ms, "vae_decode_ms": dec_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def bench_latency(dev, int8: bool = False, requests: int = 3) -> dict:
    """The latency cell: seconds per 100-step `ModelZoo.ip2p()` request on
    one 512x512 image (s_txt 8.0, s_img 0.9, as `chip_smoke.py` serves it),
    `requests` of them after one warm-up request. Beside them, the UNet call
    at batch 3 on the card (CUDA events over back-to-back calls) and on the
    host alone (the time to enqueue one call onto an idle device: where it
    is near the event time, the host bounds the cell), and the host's
    1-minute load average before and after."""
    import statistics

    import numpy as np
    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    load0 = os.getloadavg()[0]
    zoo = ModelZoo(ZooConfig(quant_ip2p=int8), dev, seed=0)
    edit = zoo.ip2p()
    img = np.random.default_rng(0).integers(0, 256, (SIZE, SIZE, 3), np.uint8)
    seconds = []
    for i in range(requests + 1):
        t0 = time.perf_counter()
        out = edit(img, "make the sky a deep orange", None, steps=100, s_txt=8.0,
                   s_img=0.9, seed=i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if out.shape != img.shape or out.dtype != np.uint8:
        raise RuntimeError(f"ip2p() returned {out.shape} {out.dtype}")

    unet, _ = zoo._ip2p_core()
    c = zoo.cfg
    hw = c.canvas.edit_size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(3, hw, hw, c.ip2p_unet.in_channels, generator=g, device=dev)
    t = torch.full((3,), 501, device=dev)
    ctx = torch.randn(3, 77, c.ip2p_unet.context_dim, generator=g, device=dev)
    host = []
    with torch.inference_mode():
        step_ms = time_ms(lambda: unet(x, t, ctx), iters=20)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unet(x, t, ctx)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    mode = "W8A8" if int8 else "bf16"
    return {"metric": f"seconds per 100-step ip2p() request (512x512, {mode}, "
                      "PyTorch port)",
            "value": statistics.median(seconds[1:]), "unit": "s",
            "seconds": seconds[1:], "warmup_s": seconds[0],
            "unet_b3_ms": step_ms, "unet_b3_host_ms": statistics.median(host),
            "loadavg_1min": [load0, os.getloadavg()[0]], "cpus": os.cpu_count()}


# K1 and K2 at the main path's shapes: the UNet at batch 3 (one request,
# B*H = 24) and 24 (the bench's batch 8, B*H = 192); the VAE at n = 1.
K1_SHAPES = ((24, 4096, 40), (24, 1024, 80), (192, 4096, 40), (192, 1024, 80))
K2_SHAPES = (((3, 320, 64, 64), True), ((3, 640, 32, 32), False),
             ((3, 1280, 8, 8), True), ((3, 2560, 16, 16), True),
             ((24, 320, 64, 64), True), ((24, 640, 32, 32), False),
             ((24, 1280, 8, 8), True), ((1, 128, 512, 512), True),
             ((1, 256, 512, 512), True), ((1, 256, 256, 256), True),
             ((1, 512, 64, 64), True)) + tuple((shape, False) for shape in K2_GDINO_SHAPES)


K1_BLOCKS = ((4, 1), (8, 1), (4, 2))


def bench_k1_blocks(dev) -> list[dict]:
    """K1 at its main-path shapes with each block shape it takes (warps,
    m16 tiles of q rows a warp), in turns: the list, then the list
    reversed."""
    import torch
    from anyedit_tpu_torch.ops import attention
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    chosen = attention._k1_blocks
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = {s: [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(3)] for s in K1_SHAPES}
    rows = []
    try:
        for block in K1_BLOCKS + K1_BLOCKS[::-1]:
            attention._k1_blocks = lambda l, d, b=block: b
            for shape, (q, k, v) in inputs.items():
                ms = time_ms(lambda: attention.flash_nomax(q, k, v, shape[2] ** -0.5),
                             iters=20)
                rows.append({"kernel": "flash_nomax", "warps": block[0],
                             "tiles_per_warp": block[1], "shape": list(shape), "ms": ms})
    finally:
        attention._k1_blocks = chosen
    return rows


# K3 and K4 at their paths' shapes (one image: B*H = 24)
K4_SHAPES = ((24, 4096, 40), (24, 1024, 80))
K34_WARPS = (1, 2, 4, 8)


def bench_k34_blocks(dev) -> list[dict]:
    """K3 (bf16) and K4 at their paths' shapes with each block size they
    take (warps a block, 16 q rows each), in turns: the list, then the list
    reversed. Device time alone (`device_profile`), since the small shapes
    are bound by the host's launch cost under CUDA events."""
    import torch
    from anyedit_tpu_torch.ops import attention
    from anyedit_tpu_torch.ops.kernel_check import device_profile

    chosen = attention._k3_warps, attention._k4_warps
    g = torch.Generator(device=dev).manual_seed(0)
    k3 = {s: (torch.randn(s[0], s[1], s[3], generator=g, device=dev).to(torch.bfloat16),
              *(torch.randn(s[0], s[2], s[3], generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))) for s in K3_SHAPES}
    k4 = {s: [torch.randn(s, generator=g, device=dev).to(torch.bfloat16) for _ in range(3)]
          for s in K4_SHAPES}
    rows = []
    try:
        for warps in K34_WARPS + K34_WARPS[::-1]:
            attention._k3_warps = lambda *a, w=warps: w
            attention._k4_warps = lambda *a, w=warps: w
            for shape, (q, k, v) in k3.items():
                ms = device_profile(lambda: attention.flash_attention(q, k, v, shape[3] ** -0.5),
                                    iters=20)[0]
                rows.append({"kernel": "flash_attention", "warps": warps,
                             "shape": list(shape), "device_ms": ms})
            for shape, (q, k, v) in k4.items():
                ms = device_profile(lambda: attention.flash_int8(q, k, v, shape[2] ** -0.5),
                                    iters=20)[0]
                rows.append({"kernel": "flash_int8", "warps": warps,
                             "shape": list(shape), "device_ms": ms})
    finally:
        attention._k3_warps, attention._k4_warps = chosen
    return rows


# K2 launch plans to compare: (target blocks, min chunk KB, shared-memory cap KB)
K2_PLANS = ((132, 16, 96), (264, 16, 96), (132, 32, 96), (132, 16, 48), (132, 16, 200))


def bench_k2_plans(dev) -> list[dict]:
    """K2's device time in one full-width UNet call at batch 3 and 24 and in
    one VAE encode + decode (n = 1), under each launch plan of `K2_PLANS`
    (the settings of `ops/groupnorm.py`), in turns: the list, then the list
    reversed. From `torch.profiler`: the kernels named group_norm."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET
    from anyedit_tpu_torch.models.vae import SD_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops import groupnorm
    from anyedit_tpu_torch.weights.init import seeded_init_

    unet = build_unet(dev, False)
    vae = seeded_init_(AutoencoderKL(SD_VAE, device=dev), 1).eval()
    hw = SIZE // 8
    work = {}
    for b in (3, 3 * BATCH):
        x = torch.randn(b, hw, hw, SD15_IP2P_UNET.in_channels, device=dev)
        t = torch.full((b,), 501, device=dev)
        ctx = torch.randn(b, 77, SD15_IP2P_UNET.context_dim, device=dev,
                          dtype=torch.bfloat16)
        work[f"unet batch {b}"] = lambda x=x, t=t, ctx=ctx: unet(x, t, ctx)
    px = torch.randn(1, SIZE, SIZE, 3, device=dev, dtype=torch.bfloat16)
    z = torch.randn(1, hw, hw, SD_VAE.latent_channels, device=dev)
    work["vae encode + decode n=1"] = lambda: (vae.encode(px), vae.decode(z))

    saved = (groupnorm._K2_TARGET_BLOCKS, groupnorm._K2_MIN_CHUNK_BYTES,
             groupnorm._K2_SMEM_CAP)
    rows = []
    try:
        for target, min_kb, cap_kb in K2_PLANS + K2_PLANS[::-1]:
            groupnorm._K2_TARGET_BLOCKS = target
            groupnorm._K2_MIN_CHUNK_BYTES = min_kb * 1024
            groupnorm._K2_SMEM_CAP = cap_kb * 1024
            groupnorm._k2_plan.cache_clear()
            row = {"kernel": "group_norm", "target_blocks": target,
                   "min_chunk_kb": min_kb, "smem_cap_kb": cap_kb}
            for label, fn in work.items():
                with torch.inference_mode():
                    fn()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        fn()
                        torch.cuda.synchronize()
                us = 0.0
                for e in prof.key_averages():
                    if "group_norm" in e.key:
                        t_us = getattr(e, "self_device_time_total", None)
                        us += e.self_cuda_time_total if t_us is None else t_us
                row[f"{label} ms"] = us / 1e3
            rows.append(row)
    finally:
        (groupnorm._K2_TARGET_BLOCKS, groupnorm._K2_MIN_CHUNK_BYTES,
         groupnorm._K2_SMEM_CAP) = saved
        groupnorm._k2_plan.cache_clear()
    return rows


def bench_kernels(dev) -> list[dict]:
    """K1 and K2 against their plain versions at the main path's shapes
    (`K1_SHAPES`, `K2_SHAPES`); K3 and K4 at their paths' shapes (one
    image: B*H = 24), and the W8A8 int8 contraction."""
    import torch
    from anyedit_tpu_torch.ops import kernel_check as kc

    rows = []
    for bh, lq, lkv, d in K3_SHAPES:
        r = kc.check_flash_attention(bh, lq, lkv, d, dev)
        rows.append({"kernel": "flash_attention", "shape": [bh, lq, lkv, d], **r})
    r = kc.check_flash_attention(6, 300, 77, 40, dev, dtype=torch.float32)
    rows.append({"kernel": "flash_attention", "shape": [6, 300, 77, 40], "fp32": True, **r})
    for bh, l, d in K4_SHAPES:
        r = kc.check_flash_int8(bh, l, d, dev)
        rows.append({"kernel": "flash_int8", "shape": [bh, l, d], **r})
    for kind in ("conv", "dense"):
        rows.append({"kernel": f"int8 {kind}", **kc.check_int8_contraction(kind, dev)})
    for bh, l, d in K1_SHAPES:
        r = kc.check_flash_nomax(bh, l, d, dev)
        rows.append({"kernel": "flash_nomax", "shape": [bh, l, d], **r})
    for shape, silu in K2_SHAPES:
        r = kc.check_group_norm(shape, silu, dev, dtype=torch.bfloat16)
        rows.append({"kernel": "group_norm", "shape": list(shape), "silu": silu, **r})
    return rows


def bench_paths(dev) -> list[dict]:
    """The two opt-in kernel paths of `chip_smoke.py`, through its
    processors: one full-width bf16 UNet call with every attention site on
    K3, and one W8A8 UNet call with the level-0/1 self-attention on K4, at
    batch 3 (one request) and 24 (the bench batch), beside the same calls
    on the default route. Each row: CUDA-event ms per call and the kernel's
    device ms per call (`torch.profiler`)."""
    import torch
    from chip_smoke import flash_processor, int8_flash_processor
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET
    from anyedit_tpu_torch.ops.kernel_check import named_device_ms, time_ms

    hw = SIZE // 8
    rows = []
    for int8 in (False, True):
        unet = build_unet(dev, int8)
        proc, kernel = ((int8_flash_processor, "flash_int8") if int8
                        else (flash_processor, "flash_attention"))
        for b in (3, 3 * BATCH):
            g = torch.Generator(device=dev).manual_seed(5)
            x = torch.randn(b, hw, hw, SD15_IP2P_UNET.in_channels, generator=g, device=dev)
            t = torch.full((b,), 501, device=dev)
            ctx = torch.randn(b, 77, SD15_IP2P_UNET.context_dim, generator=g, device=dev)
            with torch.inference_mode():
                row = {"path": "K4" if int8 else "K3", "unet": "W8A8" if int8 else "bf16",
                       "batch": b,
                       "ms": time_ms(lambda: unet(x, t, ctx, processor=proc), iters=5),
                       "default_route_ms": time_ms(lambda: unet(x, t, ctx), iters=5),
                       "kernel_device_ms": named_device_ms(
                           lambda: unet(x, t, ctx, processor=proc), kernel, iters=3)}
            rows.append(row)
        del unet
        torch.cuda.empty_cache()
    return rows


def _category(kernel: str) -> str:
    """Coarse class of a CUDA kernel name, for the time breakdown."""
    n = kernel.lower()
    for cat, keys in (("K1 flash_nomax", ("flash_nomax",)),
                      ("K2 group_norm", ("group_norm",)),
                      ("K3 flash_attention", ("flash_attention",)),
                      ("K4 flash_int8", ("flash_int8", "k4_absmax", "k4_quantize")),
                      ("int8 matmul (cuBLASLt)", ("gemm_s8", "imma", "i8i8", "s8s8")),
                      ("conv (cuDNN, incl. layout transposes)",
                       ("conv", "cudnn", "fprop", "nchwtonhwc", "nhwctonchw")),
                      ("matmul (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "gemv")),
                      ("softmax", ("softmax",)),
                      ("grid_sample (deformable attention)", ("grid_sampler",)),
                      ("sort / top-k", ("sort", "radix")),
                      ("elementwise / copy / reduce",
                       ("elementwise", "vectorized", "reduce", "copy", "cat",
                        "index", "fill", "upsample", "unrolled"))):
        if any(k in n for k in keys):
            return cat
    return "other"


def device_classes(prof, iters: int):
    """(ms, launches, ms by kernel) per call, by `_category`, from the CUDA
    events of a `torch.profiler` run over `iters` calls."""
    import collections

    from torch.autograd import DeviceType

    ms, launches, by_kernel = (collections.Counter() for _ in range(3))
    for e in prof.key_averages():
        # self_cuda_time_total is the older torch's name of the field
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        cat = _category(e.key)
        ms[cat] += us / iters / 1e3
        launches[cat] += e.count / iters
        by_kernel[e.key[:90]] += us / iters / 1e3
    return ms, launches, by_kernel


def profile_breakdown(dev, int8: bool = False) -> list[dict]:
    """Device time by kernel class for one full-width UNet call at batch 3
    (one request) and 24 (the bench batch), and for VAE encode and decode at
    n = 1: `torch.profiler` over a few calls, beside the CUDA-event time of
    the same calls unprofiled. busy_share = device busy / event time. With
    `int8` the UNet is the W8A8 one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET
    from anyedit_tpu_torch.models.vae import SD_VAE, AutoencoderKL
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.weights.init import seeded_init_

    unet = build_unet(dev, int8)
    tag = " W8A8" if int8 else ""
    vae = seeded_init_(AutoencoderKL(SD_VAE, device=dev), 1).eval()
    hw = SIZE // 8
    work = []
    for b in (3, 3 * BATCH):
        x = torch.randn(b, hw, hw, SD15_IP2P_UNET.in_channels, device=dev)
        t = torch.full((b,), 501, device=dev)
        ctx = torch.randn(b, 77, SD15_IP2P_UNET.context_dim, device=dev,
                          dtype=torch.bfloat16)
        work.append((f"unet{tag} batch {b}", lambda x=x, t=t, ctx=ctx: unet(x, t, ctx), 5))
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
        ms, launches, by_kernel = device_classes(prof, iters)
        busy = sum(ms.values())
        rows.append({"label": label, "event_ms": event_ms, "device_busy_ms": busy,
                     "busy_share": busy / event_ms,
                     "ms_by_class": dict(ms.most_common()),
                     "launches_by_class": {k: round(v) for k, v in launches.items()},
                     "top_kernels_ms": dict(by_kernel.most_common(10))})
    return rows


def bench_ground(dev, runs: int = 3) -> list[dict]:
    """The grounding stage at full width (`ModelZoo(ZooConfig(box_threshold
    =0.0))`, seeded weights on the card, a 480x640 image) part by part: the
    GroundingDINO forward, the SAM encode, the SAM decode of the 32
    candidate boxes, the whole `ground()` call, and one `color_alter`
    record at 100 steps through the registry. Each row: the median and
    the runs (host clock around work that ends in a device synchronise) of
    `runs` calls after a warm-up, then one call under `torch.profiler`:
    device-busy ms, busy_share = busy / median, device ms and launches by
    kernel class, and the top kernels. Every part is timed before the
    first profiled call, so no timing follows a profiler session."""
    import numpy as np
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    ground, gd, sam = zoo.grounder(), zoo._gdino(), zoo._sam()
    img = np.random.default_rng(2).integers(0, 256, GROUND_HW + (3,), np.uint8)
    phrase = RECORD["edited object"]
    with torch.inference_mode():
        pixels, ids, mask, _ = zoo.detector_inputs(img, phrase)
        sam_px, scale = zoo.sam_inputs(img)
        emb = sam.encode(sam_px)
        prompts = (ground(img, phrase).boxes * scale)[None]
    tb, rec = zoo.toolbox(), InstructionRecord.from_json(RECORD)
    record = get_pipeline(rec.edit_type)
    work = [("gdino forward (800 px, 900 queries, 256 tokens)", lambda: gd(pixels, ids, mask)),
            ("sam encode (ViT-H, 1024)", lambda: sam.encode(sam_px)),
            (f"sam decode ({prompts.shape[1]} boxes)", lambda: sam.decode_boxes(emb, prompts)),
            (f"ground() {GROUND_HW[0]}x{GROUND_HW[1]}", lambda: ground(img, phrase)),
            ("color_alter record (100 steps)",
             lambda: record(tb, rec, img, np.random.default_rng(0)))]
    return timed_rows(work, runs)


def timed_rows(work, runs: int, device_only: tuple = ()) -> list[dict]:
    """For each (label, fn): `runs` timed calls after a warm-up (host clock
    around work that ends in a device synchronise), all parts before the
    first profiled call; then one call each under `torch.profiler`, which
    records only the device's events for the labels in `device_only` (a
    record of some 10^6 launches, whose host events would take the
    profiler longer than the record). Each row is also printed to stderr
    as it is done."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    timed = []
    for _, fn in work:
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            secs = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        timed.append(secs)
    rows = []
    for (label, fn), secs in zip(work, timed):
        acts = [ProfilerActivity.CUDA] if label in device_only else \
            [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.inference_mode():
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
        ms, launches, by_kernel = device_classes(prof, 1)
        median_ms = statistics.median(secs) * 1e3
        busy = sum(ms.values())
        rows.append({"label": label, "median_ms": median_ms,
                     "runs_ms": [t * 1e3 for t in secs], "device_busy_ms": busy,
                     "busy_share": busy / median_ms, "ms_by_class": dict(ms.most_common()),
                     "launches_by_class": {k: round(v) for k, v in launches.items()},
                     "top_kernels_ms": dict(by_kernel.most_common(8))})
        print(f"# {label}: median {median_ms:.1f} ms, busy {busy:.1f} ms", file=sys.stderr,
              flush=True)
    return rows


def bench_scorers(dev, runs: int = 3) -> list[dict]:
    """The full-width scorer slots on a 480x640 image, and one gated
    color_alter record through `FactoryExecutor` with every scorer
    installed (a fresh executor and ledger each call; the pre-gate sees the
    image size only, as random weights fail its CLIP, aesthetic and
    object-ratio thresholds), as `bench_ground` times its parts. The record's
    row adds its mean seconds by executor stage over the timed calls."""
    import tempfile

    import numpy as np
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.filters.pre_filter import PreScores
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    tb = zoo.toolbox(slots=("clip", "aesthetic", "vqa"))
    img = np.random.default_rng(7).integers(0, 256, GROUND_HW + (3,), np.uint8)
    rec = InstructionRecord.from_json(RECORD)
    reports = []
    with tempfile.TemporaryDirectory() as root:
        def record():
            ex = FactoryExecutor(tb, ExecutorConfig(output_root=f"{root}/{len(reports)}"))
            scored = ex.pre_scorer

            def size_only(r, i):
                s = scored(r, i)
                return PreScores(width=s.width, height=s.height)
            ex.pre_scorer = size_only
            ex.run([rec], lambda r: img)
            reports.append(ex.timer.report())

        work = [("clip_image (CLIP_L_VISION, 224)", lambda: tb.clip_image(img)),
                ("clip_text (CLIP-L text + projection)",
                 lambda: tb.clip_text(RECORD["output"])),
                ("aesthetic (clip_image + MLP)", lambda: tb.extra["aesthetic"](img)),
                ("vqa_yes_no (EVA_VIT_G + BLIP2_QFORMER + FLAN_T5_XL)",
                 lambda: tb.vqa_yes_no(img, VQA_QUESTIONS[0])),
                ("executor color_alter record (gated, 100 steps)", record)]
        rows = timed_rows(work, runs)
        with open(f"{root}/1/ledger.jsonl") as f:
            status = [json.loads(line)["status"] for line in f]
    timed = reports[1:1 + runs]          # the warm-up call comes first
    rows[-1]["stage_mean_s"] = {k: float(np.mean([r[k]["total_s"] for r in timed]))
                                for k in timed[0]}
    rows[-1]["status"] = status
    return rows


def bench_ultraedit(dev, runs: int = 3) -> list[dict]:
    """SD3-UltraEdit at full width (`ModelZoo(ZooConfig(box_threshold=0.0))`,
    seeded weights on the card, a 480x640 image), as `bench_ground` times
    its parts: the MMDiT call at batch 3 (3-way CFG: 77 CLIP + 77 T5 text
    tokens, 1,024 image tokens), the SD3 conditioning of one text, and one
    appearance_alter record through `get_pipeline` with
    `install(tb, "ultraedit")`. The last row adds the run's peak allocated
    GiB."""
    import numpy as np
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    tb = Toolbox(ground=zoo.grounder())
    zoo.install(tb, "ultraedit")
    c = zoo.cfg
    text = "make the car look like brushed leather"
    img = np.random.default_rng(14).integers(0, 256, GROUND_HW + (3,), np.uint8)
    rec = InstructionRecord.from_json(dict(RECORD, edit_type="appearance_alter", edit=text))
    record, cond, mmdit = get_pipeline(rec.edit_type), zoo.sd3_cond(), zoo._mmdit()
    hw = c.canvas.edit_size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(6)
    with torch.inference_mode():
        ctx, pooled = cond(text)
    args = (torch.randn(3, hw, hw, c.mmdit.in_channels, generator=g, device=dev),
            torch.full((3,), 500.0, device=dev), ctx.expand(3, -1, -1), pooled.expand(3, -1))
    tokens = ctx.shape[1] + (hw // c.mmdit.patch) ** 2
    torch.cuda.reset_peak_memory_stats()
    work = [(f"mmdit call (SD3_ULTRAEDIT, batch 3, {tokens} tokens)", lambda: mmdit(*args)),
            ("sd3 conditioning of one text (T5-XXL, CLIP-L, CLIP-bigG)", lambda: cond(text)),
            ("appearance_alter record through UltraEdit (50 steps, 2 groundings)",
             lambda: record(tb, rec, img, np.random.default_rng(0)))]
    rows = timed_rows(work, runs)
    rows[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows


def _synth_record(tb, edit_type: str):
    """A closure running one record of `edit_type` through `get_pipeline`."""
    import numpy as np
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline

    rec = InstructionRecord.from_json(dict(SYNTH_RECORDS[edit_type], edit_type=edit_type))
    img = np.zeros(GROUND_HW + (3,), np.uint8)
    return lambda: get_pipeline(edit_type)(tb, rec, img, np.random.default_rng(0))


def bench_masactrl(dev, runs: int = 3) -> list[dict]:
    """The MasaCtrl and P2P pair slots at full width (`ModelZoo(ZooConfig())`,
    seeded weights on the card), as `bench_ground` times its parts: the
    SD1.5 UNet at batch 4 (two branches x CFG, 77 text tokens) under
    `masactrl_processor(0, 0)` (the K/V swap at every self-attention site)
    and under the AttentionStore (every site's fp32 probabilities written
    out, the cross maps up to 32 x 32 kept), one action_change record and
    one implicit_change record. The last row adds the run's peak GiB."""
    import torch
    from anyedit_tpu_torch.diffusion.processors import AttentionStore, masactrl_processor
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(), dev, seed=0)
    tb = Toolbox()
    for slot in ("masactrl", "p2p_pair"):
        zoo.install(tb, slot)
    unet, _ = zoo._sd_core()
    hw = zoo.cfg.canvas.edit_size // zoo.cfg.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(4, hw, hw, 4, generator=g, device=dev)
    t = torch.full((4,), 501, device=dev)
    ctx = torch.randn(4, 77, zoo.cfg.sd_unet.context_dim, generator=g, device=dev).bfloat16()
    masa = masactrl_processor(0, 0)
    store = AttentionStore(max_hw=(hw // 2) ** 2)

    def stored():
        store.reset()
        return unet(x, t, ctx, processor=store.processor())
    torch.cuda.reset_peak_memory_stats()
    work = [("unet call under MasaCtrl (SD15_UNET, batch 4, swap at all 16 sites)",
             lambda: unet(x, t, ctx, processor=masa, extra={"step": 10})),
            ("unet call under the AttentionStore (SD15_UNET, batch 4)", stored),
            ("action_change record (MasaCtrl, 50 steps)", _synth_record(tb, "action_change")),
            ("implicit_change record (3 P2P pairs of 20 steps)",
             _synth_record(tb, "implicit_change"))]
    rows = timed_rows(work, runs)
    rows[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows


def bench_flux(dev, runs: int = 3) -> list[dict]:
    """The Flux pair slot at full width (`ModelZoo(ZooConfig())`: FLUX_SCHNELL,
    T5-XXL, CLIP-L, the Flux VAE; seeded weights on the card), as
    `bench_ground` times its parts: one Flux call at batch 1
    (`ZooConfig.flux_t5_len` text tokens, 77 by default, + 1,024 image
    tokens), one `flux_pair` (2 x 4 steps, two T5 and CLIP encodes, two Flux
    VAE decodes) and one textual_change record. The last row adds the run's
    peak GiB."""
    import torch
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(), dev, seed=0)
    tb = Toolbox()
    zoo.install(tb, "flux_pair")
    c = zoo.cfg
    flux = zoo._flux()
    hw = c.canvas.edit_size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(6)
    text = SYNTH_RECORDS["textual_change"]["output"]
    with torch.inference_mode():
        ctx = zoo._t5(c.flux_t5_len)(text).to(torch.bfloat16)
        _, pooled, _ = zoo._text_raw("clip_text", c.text)(text)
    args = (torch.randn(1, hw, hw, c.flux.in_channels, generator=g, device=dev),
            torch.full((1,), 500.0, device=dev), ctx, pooled)
    rec = SYNTH_RECORDS["textual_change"]
    tokens = ctx.shape[1] + (hw // c.flux.patch) ** 2
    torch.cuda.reset_peak_memory_stats()
    work = [(f"flux call (FLUX_SCHNELL, batch 1, {tokens} tokens)", lambda: flux(*args)),
            ("flux_pair (2 x 4 steps, T5-XXL + CLIP-L, Flux VAE decodes)",
             lambda: tb.extra["flux_pair"](rec["input"], rec["output"], 0)),
            ("textual_change record (flux_pair)", _synth_record(tb, "textual_change"))]
    rows = timed_rows(work, runs)
    rows[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows


def bench_sdxl(dev, runs: int = 3) -> list[dict]:
    """The SDXL refine stack at full width (`chip_smoke.sdxl_toolbox`: the
    production `ZooConfig` at box_threshold 0.0, seeded weights on the card,
    the ControlNets' zero convs drawn live), as `bench_ground` times its
    parts: the SDXL UNet at batch 2 (64 x 64 latents, 77 tokens, the micro-
    conditioning) plain, with the canny ControlNet's residuals, and with
    them under the IP-Adapter processor; one implicit_change record with all
    four stages installed and one 480x640 material_transfer record through
    the registry. The last row adds the run's peak GiB."""
    import numpy as np
    import torch
    from chip_smoke import sdxl_toolbox, sdxl_unet_inputs
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline

    zoo, tb, exemplar = sdxl_toolbox(dev)
    unet, _ = zoo._refine_unet()
    cn = zoo._control_unet("controlnet_canny")
    (x, t, ctx2, pooled2, tid2), hint2, proc = sdxl_unet_inputs(zoo, exemplar, dev)
    plain = zoo._refine_eps(unet, pooled2, tid2)
    with_cn = zoo._refine_eps(unet, pooled2, tid2, cn, hint2)
    full = zoo._refine_eps(unet, pooled2, tid2, cn, hint2, proc)
    img = np.random.default_rng(23).integers(0, 256, GROUND_HW + (3,), np.uint8)
    recs = {et: InstructionRecord.from_json(dict(fields, edit_type=et))
            for et, fields in (("implicit_change", SYNTH_RECORDS["implicit_change"]),
                               ("material_transfer", MATERIAL_RECORD))}

    def record(et):
        return lambda: get_pipeline(et)(tb, recs[et], img, np.random.default_rng(0))
    torch.cuda.reset_peak_memory_stats()
    work = [("sdxl unet call (SDXL_UNET, batch 2, 64 x 64 latents)", lambda: plain(x, t, ctx2)),
            ("sdxl unet call with the canny ControlNet", lambda: with_cn(x, t, ctx2)),
            ("sdxl unet call with the canny ControlNet and the IP-Adapter",
             lambda: full(x, t, ctx2)),
            ("implicit_change record (3 candidates, all four stages)",
             record("implicit_change")),
            ("material_transfer record (480x640, 27 steps)", record("material_transfer"))]
    rows = timed_rows(work, runs, device_only=tuple(label for label, _ in work[3:]))
    rows[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows


def bench_visual(dev, runs: int = 3) -> list[dict]:
    """The visual conditions, rotation, composition and AnyDoor at full width
    (`chip_smoke.visual_toolbox`), as `bench_sdxl` times its parts: the
    AnyDoor UNet + ControlNet call at batch 2 and the composition UNet call
    at batch 2 under the regional processor, each with its `sdxl_bound_ms`
    (ms, "operations" or "bytes", TFLOP), then one record of each of
    VISUAL_TYPES through the registry. The last row adds the run's peak GiB."""
    import numpy as np
    import torch
    from chip_smoke import (
        COMPOSITION_PLAN, VISUAL_RECORD, VISUAL_TYPES, anydoor_unet_inputs, sdxl_bound_ms,
        visual_toolbox,
    )
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.diffusion.regional import (
        build_regional_conditioning, parse_canvas_plan,
    )
    from anyedit_tpu_torch.edits.registry import get_pipeline

    zoo, tb, img = visual_toolbox(dev)
    unet, cn, _, _ = zoo._anydoor_core()
    x, t, ctx2, hint2 = anydoor_unet_inputs(zoo, dev)

    def anydoor_call():
        res, mid = cn(x, t, ctx2, hint2)
        return unet(x, t, ctx2, controlnet_residuals=res, controlnet_mid=mid)
    sd_unet, _ = zoo._sd_core()
    text = zoo._text_encoder()
    hw = x.shape[1]
    gp, regions = parse_canvas_plan(COMPOSITION_PLAN)
    with torch.inference_mode():
        ctx, proc = build_regional_conditioning(text, gp, regions, [hw, hw // 2, hw // 4])
        cctx2 = torch.cat([ctx, torch.cat([text("")] * (1 + len(regions)), dim=1)])
    cctx2 = cctx2.to(torch.bfloat16)

    def composition_call():
        return sd_unet(x, t, cctx2, processor=proc)

    def record(et):
        fields = dict(VISUAL_RECORD, edit_type=et, canvas_plan=COMPOSITION_PLAN)
        return lambda: get_pipeline(et)(tb, InstructionRecord.from_json(fields), img,
                                        np.random.default_rng(0))
    torch.cuda.reset_peak_memory_stats()
    work = [(f"anydoor unet + controlnet call (SD21_ANYDOOR_UNET, batch 2, {hw} x {hw} "
             f"latents, {ctx2.shape[1]} tokens)", anydoor_call),
            (f"composition unet call under the regional processor (SD15_UNET, batch 2, "
             f"{cctx2.shape[1]} tokens)", composition_call)]
    work += [(f"{et} record (480x640)", record(et)) for et in VISUAL_TYPES]
    rows = timed_rows(work, runs, device_only=tuple(label for label, _ in work[2:]))
    for row, (modules, call) in zip(rows, (([unet, cn], anydoor_call),
                                           ([sd_unet], composition_call))):
        row["bound_ms"], row["bound_by"], row["bound_tflop"] = sdxl_bound_ms(modules, call)
    rows[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rows


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="time K1-K4 against their plain versions instead")
    mode.add_argument("--k1-blocks", action="store_true",
                      help="time K1 at each block shape it takes instead")
    mode.add_argument("--k2-plans", action="store_true",
                      help="K2's device time in the UNet and VAE per launch plan instead")
    mode.add_argument("--k34-blocks", action="store_true",
                      help="time K3 and K4 at each block size they take instead")
    mode.add_argument("--paths", action="store_true",
                      help="time UNet calls with attention on K3 and on K4 instead")
    mode.add_argument("--profile", action="store_true",
                      help="device time by kernel class for the UNet and VAE instead")
    mode.add_argument("--latency", action="store_true",
                      help="seconds per 100-step ip2p() request instead")
    mode.add_argument("--ground", action="store_true",
                      help="the grounding stage and one color_alter record instead")
    mode.add_argument("--scorers", action="store_true",
                      help="the scorer slots and one gated executor record instead")
    mode.add_argument("--ultraedit", action="store_true",
                      help="the MMDiT, the SD3 conditioning and one UltraEdit record instead")
    mode.add_argument("--masactrl", action="store_true",
                      help="the UNet under MasaCtrl / the AttentionStore and two records instead")
    mode.add_argument("--flux", action="store_true",
                      help="the Flux call, one Flux pair and one textual_change record instead")
    mode.add_argument("--sdxl", action="store_true",
                      help="the SDXL UNet call and the implicit_change and material_transfer "
                           "records instead")
    mode.add_argument("--visual", action="store_true",
                      help="the AnyDoor and composition UNet calls and one record of each "
                           "visual / rotation / composition type instead")
    ap.add_argument("--int8", action="store_true",
                    help="W8A8 int8 UNet (bench.py --int8); VAE and CLIP stay bf16")
    args = ap.parse_args()
    if args.int8 and (args.kernels or args.k1_blocks or args.k2_plans or args.k34_blocks
                      or args.paths or args.ground or args.scorers or args.ultraedit
                      or args.masactrl or args.flux or args.sdxl or args.visual):
        ap.error("--int8 applies to the bench, --profile and --latency")
    if not torch.cuda.is_available():
        print("bench_torch_ip2p: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    device = card()
    if args.kernels:
        rows = bench_kernels(dev)
    elif args.k1_blocks:
        rows = bench_k1_blocks(dev)
    elif args.k2_plans:
        rows = bench_k2_plans(dev)
    elif args.k34_blocks:
        rows = bench_k34_blocks(dev)
    elif args.paths:
        rows = bench_paths(dev)
    elif args.profile:
        rows = profile_breakdown(dev, args.int8)
    elif args.latency:
        rows = [bench_latency(dev, args.int8)]
    elif args.ground:
        rows = bench_ground(dev)
    elif args.scorers:
        rows = bench_scorers(dev)
    elif args.ultraedit:
        rows = bench_ultraedit(dev)
    elif args.masactrl:
        rows = bench_masactrl(dev)
    elif args.flux:
        rows = bench_flux(dev)
    elif args.sdxl:
        rows = bench_sdxl(dev)
    elif args.visual:
        rows = bench_visual(dev)
    else:
        rows = [bench_pairs_per_hour(dev, BATCH, args.int8)]
    for row in rows:
        print(json.dumps({**row, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
