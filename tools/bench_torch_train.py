"""Training-step throughput of the PyTorch port on one NVIDIA GPU (the twin
of `tools/bench_train.py`).

    python3 tools/bench_torch_train.py [--steps 10] [--batch N]
    python3 tools/bench_torch_train.py --distill [--steps 10] [--batch N]

Default: the AnySD reference configuration (`cli.py train`'s): the
SD1.5-IP2P UNet frozen, CLIP-L vision's 768-wide projection as the image
embedding, 11 experts, 256 px (32x32 latents), batch 16, 77 text tokens;
the real `AnySDTrainer.train_step` (loss with the conditioning dropout,
backward through the frozen UNet, clip + AdamW on the adapter).
`--distill`: `LCMDistiller.distill_step` at the JAX `distill` command's
defaults, batch 8 at 512 px (64x64 latents), 50 DDIM steps, skip 1; an
out-of-memory error is reported as such (exit 1), never answered with a
smaller batch. Weights are seeded on the card; inputs are N(0, 1).

Prints one JSON line: steps/s and samples/s (best of `--steps` timed steps
after one warm-up; the median too), the device-busy share of one profiled
step (device time of its kernels over the median step's wall time), peak
GiB, K1 and K2 launches a step, and `train_bound_ms`: the step's least time
on the card, the larger of its operations at the bf16 tensor-core peak
(989 TFLOP/s) and its bytes at 3.35 TB/s. Operations are counted from the
code as it runs, by forward hooks: every Conv2d and Linear (MACs), every
attention's QK^T and PV; where a layer's input needs a gradient its
backward adds the same MACs again for dX, and where its weight trains once
more for dW; an attention that needs a gradient adds twice its forward
(dP, dS, dQ, dK, dV), and a K1 site under grad once more (the recompute).
Bytes: the parameters read once a pass, and the optimizer's fp32 state
read and written once. Numbers carry the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BF16, HBM = 989e12, 3.35e12


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


class OpCounter:
    """Forward hooks on every Conv2d, Linear and MultiHeadAttention of
    `modules`, summing the MACs of the forward and of the backward the step
    will run (see the module docstring) while active."""

    def __init__(self, modules):
        import torch
        from anyedit_tpu_torch.models.layers import MultiHeadAttention
        from anyedit_tpu_torch.ops.attention import _on_k1_route

        self.fwd = self.bwd = 0
        self.active = False

        def conv(m, inp, out):
            self._dense(out.numel() * m.in_channels // m.groups * m.kernel_size[0]
                        * m.kernel_size[1], inp[0], m.weight)

        def linear(m, inp, out):
            self._dense(out.numel() * m.in_features, inp[0], m.weight)

        def attn(m, inp, out):
            if not self.active:
                return
            x, context = inp[0], inp[1]
            b, lq = x.shape[:2]
            lkv = lq if context is None else context.shape[1]
            mac = 2 * b * lq * lkv * m.meta.num_heads * m.meta.head_dim
            self.fwd += mac
            if out.requires_grad:
                self.bwd += 2 * mac
                if context is None and _on_k1_route(lq, lkv, m.meta.head_dim):
                    self.bwd += mac
        self.hooks = []
        for mod in modules:
            for sub in mod.modules():
                fn = (conv if isinstance(sub, torch.nn.Conv2d) else
                      linear if isinstance(sub, torch.nn.Linear) else
                      attn if isinstance(sub, MultiHeadAttention) else None)
                if fn is not None:
                    self.hooks.append(sub.register_forward_hook(fn))

    def _dense(self, mac, x, weight):
        if not self.active:
            return
        self.fwd += mac
        self.bwd += mac * (int(x.requires_grad) + int(weight.requires_grad))

    @property
    def flop(self) -> float:
        return 2.0 * (self.fwd + self.bwd)

    def remove(self):
        for h in self.hooks:
            h.remove()


def param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def measure(step, steps: int, counter: OpCounter, extra_bytes: int) -> dict:
    """Warm-up (with the op count), then `steps` timed steps, then one
    profiled step; launches of one step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    counter.active = True
    step()
    torch.cuda.synchronize()
    counter.active = False
    flash_nomax.launches = group_norm.launches = 0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1, k2 = flash_nomax.launches // steps, group_norm.launches // steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    dev_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if e.device_type == DeviceType.CUDA and t > 0:
            dev_us += t
    best, med = min(times), sorted(times)[len(times) // 2]
    ops_ms = counter.flop / PEAK_BF16 * 1e3
    bytes_ms = extra_bytes / HBM * 1e3
    return {"best_ms": best * 1e3, "median_ms": med * 1e3, "steps_per_s": 1.0 / best,
            "busy_share": dev_us / 1e3 / (med * 1e3), "device_ms": dev_us / 1e3,
            "k1_per_step": k1, "k2_per_step": k2,
            "train_bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tflop_per_step": counter.flop / 1e12, "bound_bytes_gb": extra_bytes / 1e9}


def bench_anysd(dev, batch: int, steps: int) -> dict:
    import torch
    from anyedit_tpu_torch.cli import _anysd_configs
    from anyedit_tpu_torch.train.anysd import AnySDTrainer

    cfg = _anysd_configs(False)[0]
    tr = AnySDTrainer(cfg, device=dev)
    unet, adapter, opt = tr.init(seed=0)
    g = torch.Generator(device=dev).manual_seed(0)
    hw = 32
    b = {"edited_latents": torch.randn(batch, hw, hw, 4, generator=g, device=dev),
         "orig_latents": torch.randn(batch, hw, hw, 4, generator=g, device=dev),
         "text_emb": torch.randn(batch, 77, cfg.unet.context_dim, generator=g, device=dev),
         "image_embed": torch.nn.functional.normalize(
             torch.randn(batch, cfg.image_embed_dim, generator=g, device=dev), dim=-1),
         "task_id": torch.arange(batch, device=dev) % cfg.num_experts}
    state = {"opt": opt}

    def step():
        _, state["opt"], _ = tr.train_step(adapter, state["opt"], unet, b, tr.draw(g, b))
    counter = OpCounter([unet, adapter])
    # the UNet's weights read in the forward and the backward; the adapter,
    # its gradients and AdamW's two fp32 moments read and written
    nbytes = 2 * param_bytes(unet) + 7 * param_bytes(adapter)
    torch.cuda.reset_peak_memory_stats()
    res = measure(step, steps, counter, nbytes)
    counter.remove()
    res.update(mode="anysd", batch=batch, latent_hw=hw,
               samples_per_s=batch * res["steps_per_s"],
               adapter_params=sum(p.numel() for p in adapter.parameters()),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return res


def bench_distill(dev, batch: int, steps: int) -> dict:
    import torch
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.train.distill import DistillConfig, LCMDistiller
    from anyedit_tpu_torch.weights.init import seeded_init_

    torch.cuda.reset_peak_memory_stats()
    fp32 = dataclasses.replace(SD15_IP2P_UNET, dtype=torch.float32)
    teacher_sd = seeded_init_(UNet2DCondition(fp32, device=dev), 0).state_dict()
    dist = LCMDistiller(DistillConfig(), device=dev)
    teacher, student, ema, opt = dist.init(teacher_sd)
    del teacher_sd
    g = torch.Generator(device=dev).manual_seed(0)
    hw, dc = 64, dist.cfg.unet.context_dim
    b = {"edited_latents": torch.randn(batch, hw, hw, 4, generator=g, device=dev),
         "orig_latents": torch.randn(batch, hw, hw, 4, generator=g, device=dev),
         "text_emb": torch.randn(batch, 77, dc, generator=g, device=dev),
         "uncond_emb": torch.randn(batch, 77, dc, generator=g, device=dev)}
    state = {"s": student, "e": ema, "opt": opt}
    state_gib = torch.cuda.memory_allocated() / 2 ** 30

    def step():
        state["s"], state["e"], state["opt"], _ = dist.distill_step(
            state["s"], state["e"], state["opt"], teacher, b, dist.draw(g, b))
    counter = OpCounter([teacher, student.unet, ema.unet])
    n = sum(p.numel() for p in student.unet.parameters())
    # three UNets' bf16 weights read in their forwards and the student's in
    # its backward; the bf16 gradients written and read; the fp32 masters,
    # the two moments and the EMA masters read and written; both bf16
    # modules rewritten
    nbytes = 4 * param_bytes(student.unet) + 2 * 2 * n + 4 * 2 * 4 * n + 2 * 2 * n
    res = measure(step, steps, counter, nbytes)
    counter.remove()
    res.update(mode="distill", batch=batch, latent_hw=hw, ddim_steps=dist.cfg.num_ddim_steps,
               samples_per_s=batch * res["steps_per_s"], state_gib=state_gib,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return res


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--distill", action="store_true")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch_train: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    name = card()
    batch = args.batch or (8 if args.distill else 16)
    try:
        res = (bench_distill if args.distill else bench_anysd)(dev, batch, args.steps)
    except torch.cuda.OutOfMemoryError as e:
        print(json.dumps({"mode": "distill" if args.distill else "anysd", "batch": batch,
                          "out_of_memory": True, "error": str(e).splitlines()[0],
                          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                          "card": name}))
        return 1
    res["card"] = name
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
