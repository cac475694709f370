"""The reference of the factory's color_alter pair, in fp32 with TF32 off:
CLIP-L text of the instruction and of the empty prompt, VAE encode of the
512 px lanczos canvas, InstructPix2Pix with 3-way classifier-free guidance
over DDIM (eta 0, "leading" spacing, SD's scaled-linear betas), VAE decode,
lanczos back to the image's size, and the feathered composite through the
grounded mask. Written from the InstructPix2Pix paper and pipeline and the
DDIM paper; imports nothing of the program."""

from __future__ import annotations

import hashlib
import re

import torch

from portbench.reference import image as im

SOT, EOT = 49406, 49407


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of (run seed, tag): the first 60 bits of its SHA-256."""
    return int(hashlib.sha256(f"{seed}/{tag}".encode()).hexdigest()[:15], 16)


def clip_hash_ids(text: str, vocab_size: int, max_len: int):
    """The hash tokenizer that stands in for CLIP's BPE without tokenizer
    assets: start token, one bucket id per lower-case word (polynomial hash
    base 131 modulo vocab - 3, plus 1), end token; truncated keeping the end
    token, padded with it."""
    ids = [SOT % vocab_size]
    for w in re.findall(r"[a-z0-9]+", text.lower()):
        h = 0
        for ch in w:
            h = (h * 131 + ord(ch)) % (vocab_size - 3)
        ids.append(1 + h)
    ids.append(EOT % vocab_size)
    if len(ids) > max_len:
        ids = ids[:max_len - 1] + [ids[-1]]
    return ids + [ids[-1]] * (max_len - len(ids))


def alphas_cumprod(device, steps: int = 1000, start: float = 0.00085, end: float = 0.012):
    betas = torch.linspace(start ** 0.5, end ** 0.5, steps, dtype=torch.float32,
                           device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(n: int, train_steps: int = 1000):
    """Descending "leading" timesteps i * (T // n) + 1, and the previous
    level of each (alphas_cumprod[0] below zero)."""
    step = train_steps // n
    ts = [i * step + 1 for i in reversed(range(n))]
    return ts, [t - step for t in ts]


def ip2p_latents(unet, acp, lat, cond, uncond, init, steps: int, s_txt: float,
                 s_img: float):
    """InstructPix2Pix sampling: each step one UNet call over [text + image,
    image only, neither], eps = e_unc + s_txt (e_full - e_img) + s_img
    (e_img - e_unc), then a DDIM step."""
    b = lat.shape[0]
    ctx = torch.cat([cond, uncond, uncond])
    img = torch.cat([lat, lat, torch.zeros_like(lat)])
    x = init
    ts, prev = ddim_timesteps(steps)
    for t, tp in zip(ts, prev):
        tt = torch.full((3 * b,), t, device=lat.device)
        e_full, e_img, e_unc = unet(torch.cat([torch.cat([x, x, x]), img], dim=-1),
                                    tt, ctx).chunk(3)
        eps = e_unc + s_txt * (e_full - e_img) + s_img * (e_img - e_unc)
        a, ap = acp[t], acp[tp] if tp >= 0 else acp[0]
        x0 = (x - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
        x = torch.sqrt(ap) * x0 + torch.sqrt(1 - ap) * eps
    return x


@torch.no_grad()
def color_alter_pairs(nets: dict, cfg: dict, images, instructions, masks, init,
                      steps: int, s_txt: float, s_img: float):
    """The pairs of a batch of records: images (H, W, 3) uint8 tensors,
    masks (H, W) bool tensors, `init` the start latents (B, h, w, C).
    nets: "unet", "vae", "clip_text" reference modules in fp32."""
    size, sf = cfg["canvas"]["edit_size"], cfg["vae"]["scaling_factor"]
    t = cfg["clip_text"]
    ids = torch.tensor([clip_hash_ids(s, t["vocab_size"], t["max_len"])
                        for s in list(instructions) + [""]], device=init.device)
    txt = nets["clip_text"](ids)
    cond, uncond = txt[:-1], txt[-1:].expand(len(instructions), -1, -1)
    px = torch.stack([im.to_unit(im.resize(x, size, size)) for x in images])
    lat = nets["vae"].encode(px)[0] * sf
    acp = alphas_cumprod(init.device)
    out = ip2p_latents(nets["unet"], acp, lat, cond, uncond, init, steps, s_txt, s_img)
    dec = nets["vae"].decode(out / sf)
    pairs = []
    for x, d, m in zip(images, dec, masks):
        full = im.trunc_u8(im.resize(im.unit_to_u8(d).float(), x.shape[0], x.shape[1]))
        pairs.append(im.composite(x, full, m))
    return pairs
