"""Drive the PyTorch port's IP2P editor slot once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line with the seconds it took:
  1. the card: CUDA must be available; prints nvidia-smi's name and power
     limit;
  2. build: compiles anyedit_tpu_torch/csrc/*.cu with nvcc for sm_90a;
  3. kernels: K1 (flash_nomax) and K2 (GroupNorm+SiLU) against their plain
     PyTorch versions at the main path's shapes, in bf16, TF32 off;
  4. reference: the slice at the tiny config in bf16 on the card against
     the same slice in fp32 on the CPU (plain versions), same weights and
     noise, bounded by the CPU's own bf16 error;
  5. slice: the full-width SD1.5-IP2P + SD-VAE + CLIP-L editor (seeded
     random weights drawn on the card) serves two 100-step edit requests
     through `ModelZoo.ip2p()`; K1 must launch exactly 10 times per UNet
     call and K2 at least once.
Any failure raises and exits non-zero. The last lines are one JSON object
with the kernels' numbers and one with the device.
"""

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

STEPS = 100             # edits/global_.py color_alter / tone_transfer knobs
S_TXT, S_IMG = 8.0, 0.9
K1_PER_UNET_CALL = 10   # 5 self-attention sites at 64x64 latents, 5 at 32x32
REQUESTS = [((512, 512), "make the sky a deep orange"),
            ((480, 640), "turn it into a winter scene")]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_kernels(dev):
    from anyedit_tpu_torch.ops import kernel_check as kc
    import torch

    # (24, L, D): B*H = 3 (CFG rows) x 8 heads, the slice's own shapes below
    k1 = [(str(s), kc.check_flash_nomax(*s, dev))
          for s in ((24, 4096, 40), (24, 1024, 80), (16, 4096, 40), (16, 1024, 80))]
    for shape, r in k1:
        print(f"K1 flash_nomax {shape}: max {r['max_abs_err']:.3e} mean "
              f"{r['mean_abs_err']:.3e} | kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s) plain {r['plain_ms']:.4f} ms", flush=True)
        require(r["finite"] and r["mean_abs_err"] <= 2e-3 and r["max_abs_err"] <= 3e-2,
                f"K1 {shape} agrees with its plain version")
    clamp = kc.check_flash_nomax_clamp(dev)
    print(f"K1 clamp case: max |out - v| {clamp['max_abs_err']:.3e}", flush=True)
    require(clamp["finite"] and clamp["max_abs_err"] <= 1e-2,
            "K1 saturates past the clamp")

    k2 = [("(3, 320, 64, 64) silu", kc.check_group_norm((3, 320, 64, 64), True, dev)),
          ("(6, 320, 64, 64) silu", kc.check_group_norm((6, 320, 64, 64), True, dev)),
          ("(6, 640, 32, 32)", kc.check_group_norm((6, 640, 32, 32), False, dev)),
          ("(1, 128, 512, 512) silu",
           kc.check_group_norm((1, 128, 512, 512), True, dev, iters=5)),
          # fp32: bf16's grid at 100 (0.5) is coarser than the 0.1 spread
          ("(2, 320, 16, 16) silu |mean|/std=1e3 fp32",
           kc.check_group_norm((2, 320, 16, 16), True, dev, dtype=torch.float32,
                               magnitude=100.0))]
    for shape, r in k2:
        print(f"K2 group_norm {shape}: max {r['max_abs_err']:.3e} mean "
              f"{r['mean_abs_err']:.3e} | kernel {r['ms']:.4f} ms "
              f"({r['gbps']:.0f} GB/s) plain {r['plain_ms']:.4f} ms", flush=True)
        require(r["finite"] and r["max_abs_err"] <= 5e-2 and r["mean_abs_err"] <= 2e-3,
                f"K2 {shape} agrees with its plain version")
    return k1, k2


def check_reference(dev):
    """The tiny slice in bf16 on the card against the same slice in fp32 on
    the CPU (plain versions), with the same weights and noise. bf16 error
    is amplified by the guidance (s_txt 8), so the bound is relative: the
    card may stray from the fp32 reference at most twice as far as the
    CPU's own bf16 run does."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()

    def cfg(dtype):
        return dataclasses.replace(
            tiny, ip2p_unet=dataclasses.replace(tiny.ip2p_unet, dtype=dtype),
            vae=dataclasses.replace(tiny.vae, dtype=dtype),
            text=dataclasses.replace(tiny.text, dtype=dtype))

    def models(z):
        return z._ip2p_core()[0], z._vae(), z._text_model("clip_text", z.cfg.text)

    ref = ModelZoo(cfg(torch.float32), "cpu", seed=0)
    cpu16 = ModelZoo(cfg(torch.bfloat16), "cpu", seed=0)
    card16 = ModelZoo(cfg(torch.bfloat16), dev, seed=0)
    for z in (cpu16, card16):
        for src, dst in zip(models(ref), models(z)):
            dst.load_state_dict(src.state_dict())
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    noise = torch.from_numpy(rng.standard_normal((2, 1, 32, 32, 4)).astype(np.float32))
    out = {name: z.ip2p()(img, "make it blue", None, steps=3, s_txt=S_TXT,
                          s_img=S_IMG, init_latents=noise[0], renoise=noise[1]
                          ).astype(np.int32)
           for name, z in (("ref", ref), ("cpu16", cpu16), ("card16", card16))}
    err = {k: np.abs(out[k] - out["ref"]) for k in ("cpu16", "card16")}
    for k, e in err.items():
        print(f"tiny slice, {k} vs CPU fp32: uint8 max diff {e.max()} "
              f"mean {e.mean():.4f}", flush=True)
    require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
            and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
            "the card's bf16 slice is within twice the CPU's bf16 error")


def serve_slice(dev):
    import torch
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    t0 = time.perf_counter()
    zoo = ModelZoo(ZooConfig(), dev, seed=0)
    edit = zoo.ip2p()
    torch.cuda.synchronize()
    print(f"full-width zoo (SD15_IP2P_UNET, SD_VAE, CLIP_L_TEXT, 512 canvas) "
          f"built on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    latents = []
    zoo._vae().post_quant_conv.register_forward_pre_hook(
        lambda mod, args: latents.append(args[0].detach()))
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, hw + (3,), np.uint8) for hw, _ in REQUESTS]

    flash_nomax.launches = 0
    group_norm.launches = 0
    seconds = []
    for img, (_, instruction) in zip(images, REQUESTS):
        t0 = time.perf_counter()
        out = edit(img, instruction, None, steps=STEPS, s_txt=S_TXT, s_img=S_IMG,
                   seed=len(seconds))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        require(out.shape == img.shape and out.dtype == np.uint8,
                f"output of {img.shape} is {out.shape} {out.dtype}")
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}

    require(len(latents) == len(REQUESTS) and
            all(bool(torch.isfinite(z.float()).all()) for z in latents),
            "final latents are finite")
    want = len(REQUESTS) * STEPS * K1_PER_UNET_CALL
    require(launches["flash_nomax"] == want,
            f"K1 launched {launches['flash_nomax']} times, want {want}")
    require(launches["group_norm"] > 0, "K2 launched on the main path")

    unet, _ = zoo._ip2p_core()
    c = zoo.cfg
    hw = c.canvas.edit_size // c.canvas.latent_down
    x = torch.randn(3, hw, hw, c.ip2p_unet.in_channels, device=dev)
    t = torch.full((3,), 501, device=dev)
    ctx = torch.randn(3, 77, c.ip2p_unet.context_dim, device=dev)
    with torch.inference_mode():
        step_ms = time_ms(lambda: unet(x, t, ctx), iters=10)
    for (hw, _), s in zip(REQUESTS, seconds):
        print(f"request {hw[0]}x{hw[1]}: {s:.3f} s for {STEPS} steps", flush=True)
    print(f"UNet call at batch 3 (one 3-way-CFG step): {step_ms:.3f} ms", flush=True)
    print(f"launches on the main path: {launches}", flush=True)
    return launches, seconds, step_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with phase("card"):
        card_line = card()
        print(card_line, flush=True)

    with phase("build"):
        from anyedit_tpu_torch.ops import _build
        t0 = time.perf_counter()
        lib = _build.build()
        _build.library()
        print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:     # registers, smem, spills
                print(line.strip(), flush=True)

    with phase("kernels"):
        k1, k2 = check_kernels(dev)

    with phase("reference"):
        check_reference(dev)

    with phase("slice"):
        launches, seconds, step_ms = serve_slice(dev)
        print(f"{card_line}: {np.mean(seconds):.3f} s per request, "
              f"{step_ms:.3f} ms per UNet step", flush=True)

    kernels = [
        {"name": "flash_nomax", "route": "cuda",
         "source": "anyedit_tpu_torch/csrc/flash_nomax.cu",
         "replaces": "anyedit_tpu/ops/attention.py:153",
         "launches": launches["flash_nomax"],
         "max_abs_err": max(r["max_abs_err"] for _, r in k1),
         "ms": k1[0][1]["ms"], "plain_ms": k1[0][1]["plain_ms"]},
        {"name": "group_norm", "route": "cuda",
         "source": "anyedit_tpu_torch/csrc/group_norm.cu",
         "replaces": "anyedit_tpu/ops/groupnorm.py:160",
         "launches": launches["group_norm"],
         "max_abs_err": max(r["max_abs_err"] for _, r in k2),
         "ms": k2[0][1]["ms"], "plain_ms": k2[0][1]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
