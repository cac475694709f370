"""AnySD Stage-II trainer: a task-routed mixture-of-experts adapter trained
through the frozen SD1.5-IP2P UNet (counterpart of `anyedit_tpu/train/anysd.py`).

The adapter maps (CLIP image embedding, task id) to extra context tokens
appended to the text context; only it trains. The loss is the denoising
MSE with InstructPix2Pix conditioning dropout; the optimizer is
`optax.chain(clip_by_global_norm(1.0), adamw(lr))` (`train/optim.py`).

The JAX `loss_fn` draws the timesteps, the noise and the dropout uniform
from `split(key, 3)` inside; here they are an argument, `draws = {"t",
"noise", "p"}` (`AnySDTrainer.draw` makes them from a `torch.Generator`), because
jax.random and torch draw different numbers and the tests hand both sides
the same ones. Latents keep the port UNet's public layout, NHWC, and the
UNet input concatenates on the last axis, as in the JAX package.

Data parallelism (the JAX `shardings` put the batch on the mesh's `dp`
axis): with a `core.dist.Group`, each rank holds its rows of the batch,
`draw` makes the whole batch's draws and keeps the rank's rows, and
`train_step` averages the gradients and the loss over the ranks before
the clip, so the clip sees the global norm, as `clip_by_global_norm` does
on the sharded batch. The JAX `tp` / `ep` layouts have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from anyedit_tpu_torch.core.dist import Group, average, batch_rows
from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, TINY_UNET, UNetConfig
from anyedit_tpu_torch.schedulers import NoiseSchedule, add_noise, make_noise_schedule
from anyedit_tpu_torch.train.optim import ClippedAdamW

# Task-embedding books per editing domain and the 11 experts (copies of the
# JAX package's tables).
TASK_EMB_BOOKS: dict[str, tuple[str, ...]] = {
    "local": ("add", "remove", "replace", "counting", "color_alter",
              "appearance_alter", "material_alter", "action_change",
              "textual_change"),
    "global": ("background_change", "tone_transfer", "style_change"),
    "viewpoint": ("resize", "movement", "outpainting", "rotation_change"),
    "implicit": ("implicit_change", "relation"),
    "visual": ("visual_reference", "visual_bbox", "visual_depth",
               "visual_scribble", "visual_segment", "visual_sketch",
               "visual_material_transfer"),
}

EXPERT_NAMES: tuple[str, ...] = (
    "add_remove", "replace", "color", "appearance", "material", "action",
    "textual", "global", "viewpoint", "implicit", "visual",
)

_TYPE_TO_EXPERT = {
    "add": 0, "remove": 0, "counting": 0,
    "replace": 1,
    "color_alter": 2, "tone_transfer": 2,
    "appearance_alter": 3,
    "material_alter": 4, "visual_material_transfer": 4, "material_transfer": 4,
    "action_change": 5,
    "textual_change": 6,
    "background_change": 7, "style_change": 7,
    "resize": 8, "movement": 8, "outpainting": 8, "rotation_change": 8,
    "implicit_change": 9, "relation": 9,
    "visual_reference": 10, "visual_bbox": 10, "visual_depth": 10,
    "visual_scribble": 10, "visual_segment": 10, "visual_sketch": 10,
}


def expert_id(edit_type: str) -> int:
    return _TYPE_TO_EXPERT.get(edit_type, 7)


@dataclasses.dataclass(frozen=True)
class AnySDConfig:
    unet: UNetConfig = SD15_IP2P_UNET
    num_experts: int = 11
    image_embed_dim: int = 1024
    num_image_tokens: int = 4
    task_emb_dim: int = 768


TINY_ANYSD = AnySDConfig(unet=TINY_UNET, num_experts=4, image_embed_dim=32,
                         num_image_tokens=2, task_emb_dim=32)

# Flax's LayerNorm epsilon (the adapter's `out_ln`)
_LN_EPS = 1e-6
# IP2P conditioning dropout: one uniform p a sample; text dropped for
# p < 2 prob, the image for prob <= p < 3 prob
_DROP_PROB = 0.05


class TaskMoEAdapter(nn.Module):
    """Task-routed mixture of image-projection experts, fp32 (the JAX
    module's params are fp32):

        (image_embed (B, Di), task_id (B,)) -> (B, T + 1, Dc)

    Each sample gathers its expert's `expert_w1` (Di, 2 Di) and `expert_w2`
    (2 Di, T Dc), then h = gelu_tanh(e W1), tokens = LayerNorm(h W2) (eps
    1e-6), and its task embedding (through `task_proj` only when
    task_emb_dim != Dc) as the last token. Parameter names follow the Flax
    tree (`weights/bridge.py::anysd_adapter_state_dict`)."""

    def __init__(self, cfg: AnySDConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, di, dc = cfg.num_experts, cfg.image_embed_dim, cfg.unet.context_dim
        kw = dict(dtype=torch.float32, device=device)
        self.expert_w1 = nn.Parameter(torch.empty(e, di, 2 * di, **kw))
        self.expert_w2 = nn.Parameter(torch.empty(e, 2 * di, cfg.num_image_tokens * dc, **kw))
        self.task_embs = nn.Parameter(torch.empty(e, cfg.task_emb_dim, **kw))
        self.out_ln = nn.LayerNorm(dc, eps=_LN_EPS, **kw)
        self.task_proj = (nn.Linear(cfg.task_emb_dim, dc, **kw)
                          if cfg.task_emb_dim != dc else None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The Flax initializers: the experts and task embeddings
        normal(0.02), LayerNorm one and zero, `task_proj` lecun-normal with
        a zero bias (values differ from jax.random's)."""
        for p in (self.expert_w1, self.expert_w2, self.task_embs):
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        self.out_ln.reset_parameters()
        if self.task_proj is not None:
            from anyedit_tpu_torch.weights.init import seeded_init_
            seed = int(torch.randint(0, 2 ** 31, (1,), generator=generator,
                                     device=None if generator is None else generator.device))
            seeded_init_(self.task_proj, seed)

    def forward(self, image_embed: torch.Tensor, task_id: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        dc, tokens = c.unet.context_dim, c.num_image_tokens
        task_id = task_id.long()
        h = torch.bmm(image_embed.float()[:, None], self.expert_w1[task_id])[:, 0]
        h = F.gelu(h, approximate="tanh")
        tok = torch.bmm(h[:, None], self.expert_w2[task_id])[:, 0].reshape(-1, tokens, dc)
        tok = self.out_ln(tok)
        temb = self.task_embs[task_id]
        if self.task_proj is not None:
            temb = self.task_proj(temb)
        return torch.cat([tok, temb[:, None, :]], dim=1)


class AnySDTrainer:
    """The frozen UNet and the trainable adapter's loss and train step."""

    def __init__(self, cfg: AnySDConfig, ns: NoiseSchedule | None = None,
                 learning_rate: float = 1e-4, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.ns = ns or make_noise_schedule(device=self.device)
        self.tx = ClippedAdamW(learning_rate)

    # ---- init -----------------------------------------------------------
    def init(self, seed: int = 0, unet_tree: Any = None, adapter_tree: Any = None,
             unet_state: Optional[dict] = None):
        """(unet, adapter, opt_state) on the trainer's device. The UNet is
        frozen (requires_grad False, eval); it loads its Flax tree through
        the bridge, or `unet_state` (the port module's state dict, as
        `unet_ip2p.safetensors` holds it), and the adapter its tree; a part
        given neither way gets a seeded init drawn on the device (`seed`
        for the UNet, `seed + 1` for the adapter)."""
        from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
        from anyedit_tpu_torch.weights import bridge
        from anyedit_tpu_torch.weights.init import seeded_init_

        ucfg = self.cfg.unet
        unet = UNet2DCondition(ucfg, device=self.device)
        if unet_tree is not None and unet_state is not None:
            raise ValueError("the UNet is given both as a Flax tree and as a state dict")
        if unet_tree is not None:
            unet_state = bridge.unet_state_dict(unet_tree, len(ucfg.block_channels),
                                                ucfg.use_linear_projection)
        if unet_state is not None:
            unet.load_state_dict(unet_state, strict=True)
        else:
            seeded_init_(unet, seed)
        unet.eval().requires_grad_(False)
        adapter = TaskMoEAdapter(self.cfg, device=self.device)
        if adapter_tree is not None:
            adapter.load_state_dict(bridge.anysd_adapter_state_dict(adapter_tree), strict=True)
        else:
            adapter.reset_parameters(torch.Generator(device=self.device).manual_seed(seed + 1))
        return unet, adapter, self.init_opt(adapter)

    def init_opt(self, adapter: TaskMoEAdapter) -> dict:
        return self.tx.init(dict(adapter.named_parameters()))

    def draw(self, generator: torch.Generator, batch: dict,
             group: Optional[Group] = None) -> dict:
        """The loss's three draws for the batch, on its device: t uniform
        over the training steps, noise N(0, 1) of the latents' shape, p
        uniform in [0, 1). With a group, `batch` is this rank's rows: the
        draws are made at the whole batch's shape and the rank keeps its
        rows, so they are the rows one process would draw."""
        lat = batch["edited_latents"]
        b, dev = lat.shape[0] * (1 if group is None else group.size), lat.device
        return batch_rows({"t": torch.randint(0, self.ns.num_train_steps, (b,),
                                              generator=generator, device=dev),
                           "noise": torch.randn((b,) + lat.shape[1:], generator=generator,
                                                device=dev),
                           "p": torch.rand((b,), generator=generator, device=dev)}, group)

    # ---- loss -----------------------------------------------------------
    def loss_fn(self, adapter: TaskMoEAdapter, unet, batch: dict, draws: dict) -> torch.Tensor:
        """Denoise-MSE with IP2P conditioning dropout.

        batch: edited_latents (B,h,w,4), orig_latents (B,h,w,4),
        text_emb (B,L,Dc), image_embed (B,Di), task_id (B,)."""
        t, noise, p = draws["t"], draws["noise"], draws["p"]
        noisy = add_noise(self.ns, batch["edited_latents"], noise, t)
        drop_txt = (p < 2 * _DROP_PROB)[:, None, None]
        drop_img = ((p >= _DROP_PROB) & (p < 3 * _DROP_PROB))[:, None, None, None]
        text_emb = torch.where(drop_txt, 0.0, batch["text_emb"])
        orig = torch.where(drop_img, 0.0, batch["orig_latents"])
        img_tokens = adapter(batch["image_embed"], batch["task_id"])
        ctx = torch.cat([text_emb, img_tokens.to(text_emb.dtype)], dim=1)
        eps = unet(torch.cat([noisy, orig], dim=-1), t, ctx)
        return torch.mean(torch.square(eps - noise))

    def train_step(self, adapter: TaskMoEAdapter, opt_state: dict, unet, batch: dict,
                   draws: dict, group: Optional[Group] = None):
        """Loss, backward, clip and AdamW. The adapter is updated in place;
        returns (adapter, opt_state, loss). With a group, the gradients and
        the loss are averaged over the ranks (fp32) before the clip."""
        params = dict(adapter.named_parameters())
        loss = self.loss_fn(adapter, unet, batch, draws)
        grads = torch.autograd.grad(loss, list(params.values()))
        loss = loss.detach()
        if group is not None:
            grads, loss = average(grads, loss, group)
        opt_state = self.tx.update_(params, dict(zip(params, grads)), opt_state)
        return adapter, opt_state, loss
