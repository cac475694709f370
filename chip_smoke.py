"""Drive the PyTorch port on one NVIDIA GPU: every path that runs a hand
kernel, the scorers, one record through the factory executor, the
inpainting, geometry and outpainting edits, one chunk through the
executor's chunk mode, one SD3-UltraEdit record, one record of each
caption-pair editor (MasaCtrl, Prompt-to-Prompt, Flux), the SDXL
refine stack (implicit_change with all four stages, material_transfer),
one record of each of the last eight edit types (the five visual
conditions, rotation_change, composition, visual_reference through AnyDoor),
the factory's two LM gates (VILA-1.5 as the VQA judge, GOT-OCR2 on
textual_change), instruction generation on Llama-3-8B in bf16 and W8A8,
and training: AnySD through the `train` command and LCM distillation with
the distilled student served by the zoo.

    python3 chip_smoke.py

Phases, each printing its own line with the seconds it took:
  1. card: CUDA must be available; prints nvidia-smi's name and power limit;
  2. build: compiles anyedit_tpu_torch/csrc/*.cu with nvcc for sm_90a (one
     nvcc per source, in parallel);
  3. kernels: K1 (flash_nomax), K2 (GroupNorm+SiLU; also without SiLU at
     the four GroundingDINO input-projection shapes), K3 (online-softmax
     flash on tensor cores) and K4 (int8 flash over 512-key blocks) against
     their plain PyTorch versions at the paths' shapes, TF32 off; K4 also
     against fp32 sdpa. Each line also carries the kernel's bound (roofline,
     with the exp term) and the time of the one PyTorch call that computes
     the same function, where there is one;
  4. int8: the W8A8 int32 contraction (int8 im2col + torch._int_mm) equals
     a float64 contraction bit for bit, for a full-width conv and dense; the
     W8A8 scales and codes of tensors full of x / s = 63.5 ties equal the
     CPU's byte for byte (PyTorch's CUDA division by a Python scalar does
     not);
  5. reference: the slice at the tiny config in bf16 on the card against
     the same slice in fp32 on the CPU (plain versions), same weights and
     noise, bounded by the CPU's own bf16 error; then the tiny grounder the
     same way: box scores within twice the CPU's own bf16 distance, merged
     mask IoU >= 0.9;
  6. slice: the full-width SD1.5-IP2P + SD-VAE + CLIP-L editor (seeded
     random weights drawn on the card) serves two 100-step edit requests
     through `ModelZoo.ip2p()`; K1 must launch exactly 10 times per UNet
     call and K2 at least once;
  7. k3 path: one 20-step edit through `ip2p_edit` on the same UNet with a
     processor that sends all 32 attention sites to `attention(...,
     use_flash=True)`; K3 must launch exactly 32 times per UNet call; one
     UNet call through K3 against the default route;
  8. w8a8 slice: `ModelZoo(ZooConfig(quant_ip2p=True))` serves the two
     requests at 100 steps; K1 10 per UNet call, K2 at least once; one W8A8
     UNet call against the bf16 one (cosine > 0.95);
  9. k4 path: one W8A8 UNet call at batch 3 with a processor that sends the
     level-0/1 self-attention sites to `self_attn_int8`; K4 must launch
     exactly 10 times; cosine > 0.95 against `int8_processor`;
 10. grounding: the full-width GroundingDINO SwinB (800 px, 900 queries,
     256 text tokens) and SAM ViT-H (1024) of `ModelZoo.grounder()`, seeded
     weights drawn on the card, ground one 480x640 image: K2 exactly 4
     launches (the input-projection norms), K1 none; finite logits and
     boxes; masks of (h, w); the times of the detector, the SAM encode and
     decode, and the whole call;
 11. color_alter record: one InstructionRecord through
     `get_pipeline("color_alter")` on the same zoo (`box_threshold=0.0`, so
     the random detector keeps boxes): success, a uint8 image of the
     input's shape, a non-empty mask, the edited frame blended over the
     input by the feathered mask (within one level of numpy's blend: the
     check that holds the record's own output), the input's bytes wherever
     the feathered mask is 0 (random weights give a speckle mask whose
     feather may cover the whole frame, so this may hold on 0 pixels of the
     record; the line says how many), the composite re-run on the record's
     frames with the mask cut to a 64-px window keeping the input's bytes
     beyond that window's feather, K1 exactly 1,000 launches and K2 one
     request's
     UNet and VAE launches plus the grounder's 4; seconds per record split
     into ground / edit / composite;
 12. scorers: the full-width CLIP-L vision tower and CLIP-L text model, the
     aesthetic MLP, and EVA ViT-g + Q-Former + FLAN-T5-XL `vqa_yes_no`
     (`ModelZoo.install` of "clip", "aesthetic", "vqa") on a 480x640
     image: ms of each (median of 3 after a warm-up), finite outputs,
     unit-norm embeddings, K1 and K2 launched 0 times;
 13. executor record: the same record through `FactoryExecutor` on the
     full-width zoo with ground, ip2p and every scorer installed, three
     times. (a) The default scorers and both gates: random weights score
     CLIP and the aesthetic MLP near 0, so the pre-filter is expected to
     filter; the pre-scores match a recompute through the same closures
     within 1e-3 and the decision equals `pre_filter_decision` on them.
     (b) Both gates again, with a pre-scorer that computes every default
     pre-score on the card (the grounding fills the record memo) and
     passes on only the image size, since random weights fail the CLIP,
     aesthetic and object-ratio thresholds (the union of 32 random boxes
     covers the frame): the ledger line is `success` or `filtered`, its
     post-filter scores match a recompute within 1e-3, the decision equals
     `post_filter_decision` on them, K1 launches 1,000 times and K2 one
     request's count plus 4 (one grounding: the memo holds); the
     StageTimer report is printed. (c) Both gates off: a `success` whose
     `edited_img/*.png`, decoded here with zlib, holds the pipeline's bytes.
Between phases 5 and 6, `scorer reference` holds the tiny scorers (a
CLIP-layout tower, an EVA-layout tower, the aesthetic MLP and Blip2VQA) in
bf16 on the card against fp32 on the CPU, within twice the CPU's own bf16
distance (at least 2^-8); `inpaint reference` the tiny SD inpainter
(`sample_inpaint` on the 9-channel UNet) the same way as phase 5 holds the
IP2P slice; and `lama` LaMa at LAMA through the `inpainter()` entry point
on one 477x633 image (reflect-padded to 480x640 and cropped back), with
cuDNN's TF32 at PyTorch's default (on), so that the slot has to run its
convolutions in fp32 itself: the card's slot against the CPU zoo's on the
same weights, within LAMA_BOUND, with its ms on the card. The kernels phase
also holds K1 and K2 at this slice's shapes (SLICE_K1, SLICE_K2): the
batched edit's UNet at 2 x 3 rows (the chunk) and 4 x 3 (the bucket), the
VAE at batch 2 and 4, GroundingDINO's four input projections at batch 4,
and the SD inpainter's 2-way CFG UNet; each gets its own row in the kernels
line, with the launches of the path that gives the kernel that shape. Then:
 14. slice 3 records: one background_change (SD inpainter, 50 steps) and
     one style_change (IP2P, 50 steps) record through `get_pipeline` on the
     full-width zoo: success, K1 500 each, seconds;
 15. chunk: on the production `ZooConfig` (box_threshold 0.25) with every
     slot (ground, LaMa, IP2P, CLIP, aesthetic, VQA, SD inpainter), four
     records (2 color_alter, 2 remove, each its own image array) through
     `FactoryExecutor(grounding_batch=4)` with both gates forced open, then
     per record: the chunk's report has ground_batch, clip_batch and
     edit_batch, no batch call fell back, no live unmasked IP2P call was made
     (the zoo's ip2p wrapped here), K1 one batched UNet call a step (1,000),
     the ledger outcomes equal per-record mode's, and each batched edit is
     within a mean of CHUNK_EDIT_MEAN_BOUND uint8 levels of its per-record
     edit; seconds a record and peak allocated memory in both modes. Then
     the bucket: four color_alter records, each its own image, in one
     chunk, so the batched edit fills `edit_batch_bucket` (the UNet at
     batch 12): the batch stages present, no fall-back, no live unmasked
     IP2P call, the four edits in one batched call (K1 1,000).
After `inpaint reference`, `ultraedit reference` holds the tiny UltraEdit
slot (MMDiT with its modulations drawn live, the flow edit, the SD3 VAE,
CLIP-L with projection, CLIP-G, T5) in bf16 on the card against fp32 on the
CPU, within twice the CPU's own bf16 distance. After phase 14:
 16. geometry records: one real `ground()` of a 480x640 image (K2 exactly
     4, K1 0), then one resize, movement, relation and outpainting record
     through `get_pipeline` on the full-width grounder and LaMa, the
     grounder's answer on the source image replaced by synthetic detections
     of two drawn objects (the real grounding still runs), so that the
     erase-and-paste path runs: each succeeds, K1 0, K2 4 a grounding, the
     moved object's pixels are the source's bytes, the outpainting input is
     the box expanded by 10 %; seconds a record; K2's launches tallied by
     shape.
After the chunk phase, on a zoo of its own (freed after):
 17. ultraedit: one appearance_alter record at 480x640 through
     `get_pipeline` with `install(tb, "ultraedit")` at full width
     (SD3_ULTRAEDIT, T5_XXL, CLIP_BIGG_TEXT, the SD3 VAE; seeded weights,
     the modulations zero as in the JAX package) and an IP2P slot that
     raises: success, 50 steps at 8.0 / 1.5, K1 0 (so the UltraEdit route
     ran, not the IP2P fallback), K2 two groundings' 8 plus one SD3 VAE
     encode and decode (counted alone first), tallied by shape; seconds for
     the record and its edit, the MMDiT call at batch 3 beside its bound
     (`mmdit_bound_ms`), the SD3 conditioning of one text, the peak GiB;
     then, all with the same live modulations, the bf16 MMDiT call against
     an fp32 MMDiT (relative L2 <= MMDIT_FP32_REL_L2) and a W8A8 MMDiT
     (`quant_diffusion`) against the bf16 one (cosine > 0.95).
The kernels phase also holds K2 at the shapes of these two paths (the
GroundingDINO norms at batch 1; the SD3 VAE's norms at batch 1 and 512 px,
K2_SD3_VAE_SHAPES); each of those rows carries the launches at its shape in
its path's run (`k2_tally`), which must launch K2 at no other shape. The K1
row carries `launches_geometry` and `launches_ultraedit` (0 both).
After `ultraedit reference`, `synth reference` holds the tiny caption-pair
synthesizers in bf16 on the card against fp32 on the CPU (same weights,
the Flux's modulations drawn live, same noise), each within twice the
CPU's own bf16 distance: `consistent_synthesis` with the MasaCtrl swap
active from step 1 and site 1, `p2p_pair()` (frames and keyword mask),
`flux_pair_fn()` and the W8A8 tiny Flux. After phase 17, on a zoo of its
own (the production `ZooConfig`, freed after):
 18. masactrl / p2p: `install(tb, "masactrl" | "p2p_pair")` at full width
     (SD15_UNET at batch 4, the SD VAE, CLIP-L; one resident UNet), one
     action_change record (50 steps) and one implicit_change record (3 P2P
     pairs of 20 steps) through `FactoryExecutor` with both gates open:
     success, both synthesized sides written as 512 px PNGs that differ,
     K1 0 (every site takes sdpa), K2 tallied by shape; seconds and peak
     GiB; then one `p2p_pair()` call: its keyword mask is a non-empty
     512 x 512 bool array;
 19. flux: `install(tb, "flux_pair")` (FLUX_SCHNELL, T5-XXL, CLIP-L, the
     Flux VAE; the modulations drawn live so that the captions reach the
     image), one textual_change record the same way (K1 0), then the three
     types in one chunk (`grounding_batch=3`), every record a success and
     K1 0; one Flux call at batch 1 beside `flux_bound_ms`, peak GiB; the
     zoo freed, then a W8A8 Flux (`quant_diffusion`) built alone with the
     same modulations against the bf16 call's output (cosine > 0.95), its
     build's peak GiB. K2 is then held at every (shape, SiLU) these paths
     launched it (`synth_k2_rows`: the UNet at batch 4, the SD VAE decode
     at batch 2, the Flux VAE decode at batch 1), each row with the
     launches at its shape in each path's run; the K1 row carries
     `launches_masactrl`, `launches_implicit` and `launches_flux` (0 all).
After `synth reference`, `sdxl reference` holds the tiny refine slots
(img2img, sdxl_inpaint, canny_consistency with the IP-Adapter, sdxl_material,
depth; the ControlNets' zero convs drawn live, `live_zero_convs_`) in bf16
on the card against fp32 on the CPU, each within twice the CPU's own bf16
distance. After phase 19, on a zoo of its own (the production `ZooConfig`
at box_threshold 0.0, freed after):
 20. sdxl: SDXL_UNET, the SDXL VAE, CLIP-L, CLIP-bigG, CLIP-L vision, the
     canny and depth ControlNets (zero convs live), the IP-Adapter,
     DEPTH_ANYTHING_L and the grounder, seeded at published widths; one
     implicit_change record with all four stages installed through
     `FactoryExecutor` (gates open): each stage slot called as
     SDXL_STAGE_CALLS says, K1 exactly SDXL_IMPLICIT_K1 (2,406); one 480x640
     material_transfer record (a seeded exemplar through
     `tb.extra["load_visual"]`): success, K1 exactly SDXL_MATERIAL_K1 (108);
     K2 tallied by shape in both; the SDXL UNet call at batch 2, plain and
     with the canny ControlNet and the IP-Adapter, in ms beside
     `sdxl_bound_ms`; the peak GiB; then a W8A8 refine UNet
     (`quant_diffusion`) against the bf16 call (cosine > 0.95). The K1 row
     at (20, 1024, 64) carries both records' launches; K2 gets a row at each
     shape these paths launched it that no earlier row holds
     (`new_k2_rows`), and an earlier row gains their launches.
After `sdxl reference`, `visual reference` holds the tiny `hed_fn()` (fp32
everywhere: within 1e-3), `seg_fn()` (the rendered map within twice the
CPU bf16's differing share, at least 2 %), one `composition_fn()` and one
`anydoor()` call (the ControlNet's zero convs drawn live), noise passed in,
in bf16 on the card against fp32 on the CPU, within twice the CPU's own
bf16 distance. After phase 20, on a zoo of its own (the production
`ZooConfig` at box_threshold 0.0, freed after):
 21. visual: the grounder, HED, UperNet on Swin-T, Depth-Anything-V2,
     Canny, SD15_UNET with the SD VAE and CLIP-L (composition),
     SD21_ANYDOOR_UNET with its ControlNet (zero convs live), DINOV2_G at
     224 px and the projection (AnyDoor), seeded at published widths
     (`visual_toolbox`); one 480x640 record of each of VISUAL_TYPES through
     `FactoryExecutor` with the gates open, the grounder's answer on the
     target and the reference replaced by a synthetic interior detection
     (the real grounding still runs): the five condition types give the
     image as the edit and a condition map, rotation_change the capture
     pair and a left turn, composition a 512 px frame, visual_reference
     the target's bytes outside the mask; K1 0 everywhere but
     visual_reference, which launches exactly ANYDOOR_K1 (350 at (10, 4096,
     64), 350 at (20, 1024, 64)); K2 tallied by shape. Each record's
     seconds, peak GiB and device-busy share (one more run of the record
     under `torch.profiler`, device events only). Then the AnyDoor UNet +
     ControlNet call at batch 2 in ms beside `sdxl_bound_ms`. The kernels
     phase holds K1 at (10, 4096, 64) (its row carries the record's launches
     at that shape; the (20, 1024, 64) row gains `launches_anydoor`), and K2
     gets a row at each new shape these paths launched it (`new_k2_rows`).
After `visual reference`, `llm reference` holds the tiny Llama in bf16 and
in W8A8 (the same int8 codes; the W8A8 decode's 2-row GEMMs through the
padded `torch._int_mm`), the tiny VILA (`vila_fn()`) and the tiny GOT-OCR2
(image tokens, text logits) on the card against fp32 on the CPU, within
twice the CPU's own bf16 distance, and the int8 contraction at M = 1, 8 and
16 rows against float64. After `executor record`, `vila` runs RECORD once
more through `FactoryExecutor` with "vila" installed in place of "vqa"
(VILA-1.5: vicuna-7B + CLIP ViT-L/336 with its last block dropped) and the
pre-gate on the image size: K1 1,000, K2 one request's plus 4, the
post-filter's vqa_yes VILA's answer; one VILA call in ms beside
`vila_bound_ms`. In the flux phase, one more textual_change record with
"ocr" installed (GOT-OCR2: SAM ViT-B at 1,024 px + Qwen2-0.5B): at random
weights the reader matches no quoted text, so the gate fails closed after
its first read (status `failure`, "OCR text mismatch", K1 0); ms a read.
After phase 21, on models of its own (freed after):
 22. llm: Llama-3-8B seeded at published widths in bf16: prefill + one
     decode step against the full causal forward (LLAMA_KV_REL_L2), the
     fp32 8B from the same seed against it (LLAMA_FP32_REL_L2); prefill at
     (8, 1,024) and a decode step at batch 8 over 1,120 cache slots in ms
     beside `llama_bound_ms`; one `InstructionGenerator` batch of 8 captions
     on the instruction bench's workload (5 shots, byte tokens in a
     1,024-token bucket, 96 new tokens, the self-check priced): seconds,
     records/hour, device-busy share, peak GiB, K1 = K2 = 0; then the W8A8
     8B (`quantize_llama`) against bf16 (cosine > 0.95) and its prefill and
     decode ms. The K1 and K2 rows carry `launches_vila` and `launches_llm`;
     K1's carries `launches_ocr`.
Then training (slice 6a), on models of their own:
 23. train kernels: K1's and K2's autograd Functions (the kernel forward,
     the backward recomputing through the plain versions, no launch) at
     the training shapes (K1_GRAD_SHAPES, K2_GRAD_SHAPES): the gradients
     against the plain versions' autograd (K1_GRAD_REL_L2, K2_GRAD_REL_L2),
     the output against the plain version's (K1_FWD_BOUNDS, K2_FWD_BOUNDS),
     a grad_fn on each output, forward and backward ms beside the
     backward's bound and `F.scaled_dot_product_attention` /
     `F.group_norm` + `F.silu` forward and backward;
 24. train reference: the tiny AnySD loss and adapter gradients in bf16 on
     the card against fp32 on the CPU (K1 3, K2 launched), within twice
     the CPU's own bf16 distance;
 25. train: `cli.main(["train", ...])` at full width (seeded on the card)
     on the ledger that `executor record` (c) wrote: 2 steps, then
     `--resume` to 4 with a 20-step validation grid; K1 5 and K2 61 a step
     (counted around `train_step`), the VAE encoder's 22 norms twice a
     step, the grid's edit K1 100; finite losses, the adapter moved, the
     UNet's bytes unchanged, checkpoints 2 and 4; then the disconnect check
     (DISCONNECT_COS, DISCONNECT_REL_L2 against plain autograd; two
     controls, K1's outputs cut from autograd and K2's cut at all but the
     last norm, must each fail it);
 26. distill: `LCMDistiller` on SD15_IP2P_UNET at 512 px, batch 2 (the
     CLI's 8 cut for chip time), 2 steps: finite losses, the fp32 masters
     moved, the bf16 weights equal to the masters rounded, the EMA rule
     exact, the teacher unchanged, K1 30 a step, peak GiB; then
     `ModelZoo(ZooConfig(lcm_steps=4)).ip2p()` on the student serves one
     512 px request: 4 UNet calls at one row, K1 exactly 40;
 27. train shapes: K1 and K2 against their plain versions, with the
     bounds of phase 3, at every shape the paths of 25 and 26 launched them
     (tallied by shape) that no earlier row holds (`new_k1_rows`,
     `new_k2_rows`): the AnySD step at batch 16, its VAE encodes, the
     grid's edit, the LCM request at one row.
     The kernels line gains a row at each such shape, K1's and K2's
     backward rows, and on the K1 and K2 rows `launches_train*`,
     `launches_distill_step`, `launches_lcm_request`.
Then the factory's command line (slice 7a), each run on a zoo of its own:
 28. cli: `cli.main(["run", ...])` at full width (`ZooConfig()`, 512
     canvas, seeded on the card, `--ground-batch 8 --no-filters`) over
     seeded 480x640 PNGs: tone_transfer, color_alter, remove, visual_depth.
     Every record gets a status, tone_transfer succeeds with its edited PNG
     on disk, K1 and K2 launch (`launches_cli` on the K1 and K2 rows, a row
     at each shape no earlier row holds), seconds a record over the
     executor's run, and its busy share: the device events of one more run
     of the same records under `torch.profiler` (device events only) over
     the unprofiled run's seconds; a run of the
     remove record alone builds no UNet; `eval` scores the run directory
     and `export` writes its three reference JSONs. Then the checkpoint
     round trip: the seeded state dicts of every slot a tone_transfer run
     touches, written under the official names (SAM in the HF mirror's
     `vision_encoder.*` layout, LaMa under `generator.`, the UNet as two
     shards with an index, the aesthetic MLP as a torch `.pth`), each
     through `convert`, then `run --weights --require-weights`: the edited
     PNG's bytes equal the run with the same tensors seeded in memory (both
     with the same tokenizer assets; the first timed, the second profiled:
     the tone_transfer record's seconds and busy share alone); with one
     slot file gone the run raises FileNotFoundError. Then (slice 7b) on
     that weights dir: `distill --require-weights` at full width (512 px,
     batch 2, 2 steps, 50 DDIM steps, 4 LCM steps, one eval pair) on the
     run's ledger (the train phase's ungated ledger if the run left fewer
     than two trainable successes): finite losses, the JAX command's
     `quality` keys, K1 exactly 600 (DISTILL_CLI_K1: 30 a step, 500 in the
     teacher's eval edit, 40 in the student's; by shape), the student file
     with every UNet key, finite, unlike the teacher's; the distill step's,
     the eval edits' seconds and peak GiB; `run --lcm-steps 4` of the
     tone_transfer record loads that file, K1 exactly 40, its seconds
     beside the 100-step record's; `eval` on eval_teacher and eval_student;
     `convert --plan`: every convert line names `anyedit_tpu_torch` and a
     `.safetensors` output. K1 and K2 get a row at each new shape of these
     paths (`launches_cli_distill`, `launches_cli_lcm`).
Every kernel count is set to 0 just before a path and read just after it.
Any failure raises and exits non-zero. The last lines are one JSON object
with the kernels' numbers and one with the device.
"""

import collections
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

STEPS = 100             # edits/global_.py color_alter / tone_transfer knobs
S_TXT, S_IMG = 8.0, 0.9
K1_PER_UNET_CALL = 10   # 5 self-attention sites at 64x64 latents, 5 at 32x32
K3_PER_UNET_CALL = 32   # 16 transformer blocks x (self + cross)
K3_STEPS = 20
K4_PER_UNET_CALL = 10   # the K1 sites, through self_attn_int8
K2_PER_GROUND = 4       # GroundingDINO's input-projection GroupNorms
# K2 at the GroundingDINO input projections: 256 channels in 32 groups at
# strides 8, 16, 32 of the 800 px input and the extra stride-2 level
K2_GDINO_SHAPES = [(1, 256, 100, 100), (1, 256, 50, 50), (1, 256, 25, 25),
                   (1, 256, 13, 13)]
GROUND_HW = (480, 640)
RECORD = {"edit": "change the car to red", "edited object": "car",
          "input": "a car parked on a street", "output": "a red car parked on a street",
          "edit_type": "color_alter", "image_file": "street.jpg"}
VQA_QUESTIONS = ["Is the color of car close to red?",
                 "Is the background of this image similar to a street?",
                 "Is there a car in this picture?"]
REQUESTS = [((512, 512), "make the sky a deep orange"),
            ((480, 640), "turn it into a winter scene")]
# K3 shapes at batch 3 x 8 heads: self-attention (Lq = Lkv) and
# cross-attention over 77 text tokens, at head dims 40/80/160
K3_SHAPES = [(24, 4096, 4096, 40), (24, 1024, 1024, 80), (24, 256, 256, 160),
             (24, 64, 64, 160), (24, 4096, 77, 40), (24, 1024, 77, 80),
             (24, 256, 77, 160), (24, 64, 77, 160)]
# K4 against fp32 sdpa: the JAX package's bound is 0.03 at (2, 1024, 128) in
# fp32 (tests/test_quant.py:207). At 4096 keys the /127 probability grid
# errs more: the JAX kernel itself measures 0.0356 there on the CPU (its
# interpret mode, (1, 4096, 40)), so that length is held to 0.04.
K4_SDPA_BOUND = {4096: 0.04}
# One UNet call through K3 (fp32 attention) against the default route (K1
# and sdpa round q and the probabilities to bf16): relative L2 of the
# noise prediction, a few bf16 roundings (2^-8 each) grown through 16
# transformer blocks.
K3_VS_DEFAULT_REL_L2 = 0.05
# LaMa on the card (fp32, TF32 off) against the CPU's fp32 on its [0, 1]
# output: the two sum the convolutions and FFTs in other orders.
LAMA_BOUND = 1e-4
# LaMa's image through the `inpainter()` slot: not a multiple of 8, so the
# slot pads (to 480x640) and crops
LAMA_HW = (477, 633)
# The chunk: 2 color_alter (their edits batched, the UNet at 2 x 3 rows)
# and 2 remove records (LaMa). The bucket: 4 color_alter records, whose
# batched edit fills edit_batch_bucket (the UNet at 4 x 3 rows).
CHUNK_TYPES = ("color_alter", "remove", "color_alter", "remove")
BUCKET_TYPES = ("color_alter",) * 4
# This slice's kernel shapes, each with the path whose run launches the
# kernel at that shape and gives its row's launches: "chunk" (the batched
# edit's UNet at 2 x 3 rows x 8 heads, its VAE at batch 2, GroundingDINO's
# input projections at batch 4), "bucket" (the UNet at 4 x 3 rows, the VAE
# at batch 4) and "sd" (the background_change record's SD inpainter: the
# UNet at 2 CFG rows).
SLICE_K1 = [((48, 4096, 40), "chunk"), ((48, 1024, 80), "chunk"),
            ((96, 4096, 40), "bucket"), ((96, 1024, 80), "bucket"),
            ((16, 4096, 40), "sd"), ((16, 1024, 80), "sd"),
            ((20, 1024, 64), "sdxl_implicit"), ((10, 4096, 64), "anydoor")]
# K2 in one SD3 VAE encode and decode of a 512 px canvas at batch 1, bf16
# (52 launches: 22 in the encoder, 30 in the decoder; without SiLU only at
# the mid-block attention's norm)
K2_SD3_VAE_SHAPES = [((1, 128, 512, 512), True), ((1, 128, 256, 256), True),
                     ((1, 256, 512, 512), True), ((1, 256, 256, 256), True),
                     ((1, 256, 128, 128), True), ((1, 512, 256, 256), True),
                     ((1, 512, 128, 128), True), ((1, 512, 64, 64), True),
                     ((1, 512, 64, 64), False)]
SLICE_K2 = [((6, 320, 64, 64), True, "chunk"), ((2, 128, 512, 512), True, "chunk"),
            ((12, 320, 64, 64), True, "bucket"), ((4, 128, 512, 512), True, "bucket"),
            ((2, 320, 64, 64), True, "sd")] + [
    ((4,) + g[1:], False, "chunk") for g in K2_GDINO_SHAPES] + [
    (g, False, "geometry") for g in K2_GDINO_SHAPES] + [
    (s, silu, "ultraedit") for s, silu in K2_SD3_VAE_SHAPES]
# The rows of "chunk", "bucket" and "sd" carry the kernel's launches in the
# whole run of their path; those of "geometry" and "ultraedit" the launches
# at their own shape (K2_TALLY_PATHS), and the GroundingDINO rows at batch 1
# also the UltraEdit record's (its two groundings).
PATHS = {"chunk": "chunk of 4 (2 color_alter edits batched: the UNet at batch 6; 2 remove)",
         "bucket": "bucket of 4 color_alter edits (the UNet at batch 12)",
         "sd": "background_change record (the SD inpainter's UNet at batch 2)",
         "geometry": "geometry records (resize, movement, relation, outpainting: "
                     "GroundingDINO at batch 1)",
         "ultraedit": "appearance_alter record through UltraEdit (the SD3 VAE's encode "
                      "and decode at batch 1)",
         "sdxl_implicit": "implicit_change record with all four stages (the SDXL UNet's "
                          "and the ControlNet's level-1 self-attention at batch 2: 10 x 64 "
                          "heads of 1,024 tokens)",
         "anydoor": "visual_reference record (AnyDoor: the SD2.1-class UNet's and its "
                    "ControlNet's level-0 self-attention at batch 2: 5 x 64 heads of 4,096 "
                    "tokens)"}
K2_TALLY_PATHS = ("geometry", "ultraedit")
# The geometry records (resize, movement, relation, outpainting) and their
# two drawn objects (xyxy in a 480x640 image): the edited one covers 15.6 %
# of the frame (outpainting takes a box of 10-50 %)
GEOM_TYPES = ("resize", "movement", "relation", "outpainting")
GEOM_BOXES = {"car": (200, 140, 440, 340), "tree": (40, 60, 160, 400)}
ULTRA_STEPS = 50        # edits/global_.py appearance_alter knobs (50, 8.0, 1.5)
# The full-width bf16 MMDiT call (bf16 weights and Linears, fp32 residual
# stream, live modulations) against the same MMDiT in fp32 at batch 3:
# relative L2 of the velocity. An H100 measured 5.63e-3; the limit leaves
# room for other GEMM tilings, not for an overflow or a lost block.
MMDIT_FP32_REL_L2 = 0.02
# A batched 100-step bf16 edit against the same record's per-record edit:
# the UNet at batch 6 against 3 tiles its GEMMs otherwise, and guidance 8
# amplifies the bf16 differences over the steps. Mean uint8 distance; an
# H100 measured 0.71 (largest pixel 6 levels).
CHUNK_EDIT_MEAN_BOUND = 2.0


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


def yardsticks(r: dict) -> str:
    """The bound and the library call of one kernel row, for its line."""
    lib = "none" if r["library_ms"] is None else (
        f"{r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} ms, "
        f"top kernel {r['library_kernel']}")
    return (f" | device {r['device_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['bound_term']}) | library {lib} [{r['library']}]")


# K1 in `check_kernels`: (24, L, D) is B*H = 3 (CFG rows) x 8 heads
K1_SHAPES = [(24, 4096, 40), (24, 1024, 80), (16, 4096, 40), (16, 1024, 80)]
# K1's and K2's forward against their plain versions, bf16: (max, mean)
# absolute error
K1_FWD_BOUNDS, K2_FWD_BOUNDS = (3e-2, 2e-3), (5e-2, 2e-3)


def report_k1(shape: str, r: dict) -> None:
    print(f"K1 flash_nomax {shape}: max {r['max_abs_err']:.3e} mean "
          f"{r['mean_abs_err']:.3e} | kernel {r['ms']:.4f} ms "
          f"({r['tflops']:.1f} TFLOP/s) plain {r['plain_ms']:.4f} ms{yardsticks(r)}",
          flush=True)
    require(r["finite"] and r["max_abs_err"] <= K1_FWD_BOUNDS[0]
            and r["mean_abs_err"] <= K1_FWD_BOUNDS[1], f"K1 {shape} agrees with its plain version")


def report_k2(shape: str, r: dict) -> None:
    print(f"K2 group_norm {shape}: max {r['max_abs_err']:.3e} mean "
          f"{r['mean_abs_err']:.3e} | kernel {r['ms']:.4f} ms "
          f"({r['gbps']:.0f} GB/s) plain {r['plain_ms']:.4f} ms{yardsticks(r)}",
          flush=True)
    require(r["finite"] and r["max_abs_err"] <= K2_FWD_BOUNDS[0]
            and r["mean_abs_err"] <= K2_FWD_BOUNDS[1], f"K2 {shape} agrees with its plain version")


def check_chunk_kernels(dev):
    """K1 and K2 at SLICE_K1 / SLICE_K2, with the bounds of `check_kernels`.
    Returns [(kernel, shape, row, path, (shape, silu))]; K1's silu is None."""
    from anyedit_tpu_torch.ops import kernel_check as kc

    rows = []
    for s, path in SLICE_K1:
        r = kc.check_flash_nomax(*s, dev)
        report_k1(str(s), r)
        rows.append(("flash_nomax", str(s), r, path, (s, None)))
    gdino_hw = {g[1:] for g in K2_GDINO_SHAPES}
    for s, silu, path in SLICE_K2:
        tag = f"{s} {'silu' if silu else 'gdino' if s[1:] in gdino_hw else 'plain'}"
        r = kc.check_group_norm(s, silu, dev, iters=5 if np.prod(s) >= 2 ** 24 else 10)
        report_k2(tag, r)
        rows.append(("group_norm", tag, r, path, (s, silu)))
    return rows


@contextlib.contextmanager
def k2_tally():
    """K2's launches inside the block by (shape, SiLU, dtype): the models
    reach K2 through `models/layers.py`'s `group_norm`, which is wrapped
    for the block; a call is tallied only where the wrapper's count rose."""
    import collections
    from anyedit_tpu_torch.models import layers
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    tally = collections.Counter()

    def spy(x, scale, bias, num_groups=32, eps=1e-5, silu=False):
        n0 = group_norm.launches
        y = group_norm(x, scale, bias, num_groups, eps, silu)
        if group_norm.launches > n0:
            tally[(tuple(x.shape), bool(silu), str(x.dtype))] += 1
        return y
    layers.group_norm = spy
    try:
        yield tally
    finally:
        layers.group_norm = group_norm


def k2_rows_launches(tallies: dict) -> dict:
    """{(shape, silu, path): launches} for the SLICE_K2 rows of
    K2_TALLY_PATHS. Every (shape, SiLU) a path launched must be held at bf16
    by a row of that path, or (the UltraEdit record's groundings) of
    "geometry"."""
    held = {p: {(s, silu) for s, silu, q in SLICE_K2 if q == p} for p in K2_TALLY_PATHS}
    out = {}
    for path, tally in tallies.items():
        seen = {(s, silu) for s, silu, _ in tally}
        dtypes = {d for _, _, d in tally}
        allowed = held[path] | (held["geometry"] if path == "ultraedit" else set())
        require(seen <= allowed and seen >= held[path] and dtypes == {"torch.bfloat16"},
                f"the {path} path launched K2 at {sorted(seen)} in {dtypes}; held at "
                f"{sorted(allowed)} in bf16")
        for (s, silu, _), n in tally.items():
            out[(s, silu, path)] = n
    return out


def check_kernels(dev):
    from anyedit_tpu_torch.ops import kernel_check as kc
    import torch

    k1 = [(str(s), kc.check_flash_nomax(*s, dev)) for s in K1_SHAPES]
    for shape, r in k1:
        report_k1(shape, r)
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
    k2 += [(f"{s} gdino", kc.check_group_norm(s, False, dev)) for s in K2_GDINO_SHAPES]
    for shape, r in k2:
        report_k2(shape, r)

    # K3: bf16 within one bf16 rounding of the output (plus 1e-5 for fp32
    # order near zero); fp32 within 2e-5 (tests/test_ops.py:26)
    k3 = [(str(s), kc.check_flash_attention(*s, dev, iters=5)) for s in K3_SHAPES]
    k3.append(("(6, 300, 77, 40) fp32",
               kc.check_flash_attention(6, 300, 77, 40, dev, dtype=torch.float32)))
    for shape, r in k3:
        print(f"K3 flash_attention {shape}: max {r['max_abs_err']:.3e} "
              f"({r['bf16_ulps']:.2f} bf16 roundings) | kernel {r['ms']:.4f} ms "
              f"({r['tflops']:.2f} TFLOP/s) plain {r['plain_ms']:.4f} ms{yardsticks(r)}",
              flush=True)
        ok = r["max_abs_err"] <= 2e-5 if "fp32" in shape else r["bf16_ulps"] <= 1.0
        require(r["finite"] and ok, f"K3 {shape} agrees with its plain version")

    # K4: against its plain version (same quantization and the JAX kernel's
    # 512-key blocks: fp32 order only), and against fp32 sdpa
    k4 = [(str(s), kc.check_flash_int8(*s, dev)) for s in ((24, 4096, 40), (24, 1024, 80))]
    k4.append(("(2, 1024, 128) fp32",
               kc.check_flash_int8(2, 1024, 128, dev, dtype=torch.float32)))
    for shape, r in k4:
        bound = K4_SDPA_BOUND.get(int(shape.split(",")[1]), 0.03)
        alone = ("not measured" if r["kernel_device_ms"] is None
                 else f"{r['kernel_device_ms']:.4f} ms")
        print(f"K4 flash_int8 {shape}: max {r['max_abs_err']:.3e} mean "
              f"{r['mean_abs_err']:.3e}, rel-L2 to fp32 sdpa {r['rel_l2_sdpa']:.4f} "
              f"(bound {bound}) | kernel {r['ms']:.4f} ms ({r['tops']:.2f} TOP/s, "
              f"device {alone} without the wrapper's "
              f"quantization) plain {r['plain_ms']:.4f} ms{yardsticks(r)}", flush=True)
        require(r["finite"] and r["mean_abs_err"] <= 1e-4 and r["max_abs_err"] <= 3e-2,
                f"K4 {shape} agrees with its plain version")
        require(r["rel_l2_sdpa"] < bound, f"K4 {shape} within {bound} of fp32 sdpa")
    return k1, k2, k3, k4


def check_int8(dev):
    from anyedit_tpu_torch.ops import kernel_check as kc

    rows = []
    for kind, label in (("conv", "3x3 conv (3, 320, 64, 64) -> 320"),
                        ("dense", "dense (4096, 320) -> 2560")):
        r = kc.check_int8_contraction(kind, dev)
        print(f"int8 {label}: exact {r['exact']} | int8 {r['ms']:.4f} ms "
              f"({r['tops']:.1f} TOP/s) float64 {r['plain_ms']:.4f} ms "
              f"bf16 {r['bf16_ms']:.4f} ms", flush=True)
        require(r["exact"] and r["dtype"] == "torch.int32",
                f"the int8 {kind} contraction equals float64 bit for bit")
        rows.append((kind, r))
    ties = kc.check_div_ties(dev)
    print(f"int8 codes at x / s = 63.5 ties ({ties['ties']} ties in {ties['codes']} codes): "
          f"{ties['mismatches']} differ from the CPU's; scales divided by a Python scalar "
          f"on the card would give {ties['scalar_div_mismatches']}", flush=True)
    require(ties["ties"] > 0 and ties["mismatches"] == 0,
            "the W8A8 activation codes equal the CPU's at x / s = 63.5 ties")
    return rows


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


def check_grounding_reference(dev):
    """The tiny grounder (`box_threshold=0.0`) in bf16 on the card against
    the same grounder in fp32 on the CPU, same weights: the 32 candidate
    scores within twice the CPU's own bf16 distance (at least one bf16
    rounding of 1), and the merged masks at IoU >= 0.9."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()

    def cfg(dtype):
        g = tiny.gdino
        return dataclasses.replace(
            tiny, sam=dataclasses.replace(tiny.sam, dtype=dtype),
            gdino=dataclasses.replace(g, swin=dataclasses.replace(g.swin, dtype=dtype),
                                      bert=dataclasses.replace(g.bert, dtype=dtype),
                                      dtype=dtype))

    ref = ModelZoo(cfg(torch.float32), "cpu", seed=0)
    cpu16 = ModelZoo(cfg(torch.bfloat16), "cpu", seed=0)
    card16 = ModelZoo(cfg(torch.bfloat16), dev, seed=0)
    for z in (cpu16, card16):
        z._gdino().load_state_dict(ref._gdino().state_dict())
        z._sam().load_state_dict(ref._sam().state_dict())
    img = np.random.default_rng(3).integers(0, 256, (48, 40, 3), np.uint8)
    out = {name: z.grounder()(img, "red square")
           for name, z in (("ref", ref), ("cpu16", cpu16), ("card16", card16))}
    require(all(g is not None for g in out.values()), "the tiny grounders keep boxes")
    r = out["ref"]
    err, iou = {}, {}
    for k in ("cpu16", "card16"):
        g = out[k]
        err[k] = float((g.scores.cpu().float() - r.scores).abs().max())
        m, rm = g.mask.cpu(), r.mask
        iou[k] = float((m & rm).sum()) / max(float((m | rm).sum()), 1.0)
        print(f"tiny grounder, {k} vs CPU fp32: scores max diff {err[k]:.3e}, "
              f"merged-mask IoU {iou[k]:.4f} ({int(rm.sum())} pixels in the fp32 mask)",
              flush=True)
    require(err["card16"] <= 2 * max(err["cpu16"], 2.0 ** -8) and iou["card16"] >= 0.9,
            "the card's bf16 grounder is within twice the CPU's bf16 score distance, "
            "mask IoU >= 0.9")


def cosine(a, b) -> float:
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def unet_inputs(zoo, dev, batch: int = 3, seed: int = 5):
    """Seeded (latents NHWC, t, context) for one full-width UNet call."""
    import torch
    c = zoo.cfg
    hw = c.canvas.edit_size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, hw, hw, c.ip2p_unet.in_channels, generator=g, device=dev)
    t = torch.full((batch,), 501, device=dev)
    ctx = torch.randn(batch, 77, c.ip2p_unet.context_dim, generator=g, device=dev)
    return x, t, ctx


def serve_slice(dev, zoo, label: str):
    """Two full-width 100-step requests through `zoo.ip2p()`: K1 exactly 10
    launches per UNet call, K2 at least one, uint8 outputs of the input's
    shape, finite final latents. Returns (launches, seconds, step_ms)."""
    import torch
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    t0 = time.perf_counter()
    edit = zoo.ip2p()
    torch.cuda.synchronize()
    print(f"{label} zoo (SD15_IP2P_UNET, SD_VAE, CLIP_L_TEXT, 512 canvas) "
          f"built on the card in {time.perf_counter() - t0:.2f} s", flush=True)
    latents = []
    hook = zoo._vae().post_quant_conv.register_forward_pre_hook(
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
                f"{label}: output of {img.shape} is {out.shape} {out.dtype}")
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    hook.remove()

    require(len(latents) == len(REQUESTS) and
            all(bool(torch.isfinite(z.float()).all()) for z in latents),
            f"{label}: final latents are finite")
    want = len(REQUESTS) * STEPS * K1_PER_UNET_CALL
    require(launches["flash_nomax"] == want,
            f"{label}: K1 launched {launches['flash_nomax']} times, want {want}")
    require(launches["group_norm"] > 0, f"{label}: K2 launched on the main path")

    unet, _ = zoo._ip2p_core()
    x, t, ctx = unet_inputs(zoo, dev)
    with torch.inference_mode():
        step_ms = time_ms(lambda: unet(x, t, ctx), iters=10)
    for (hw, _), s in zip(REQUESTS, seconds):
        print(f"{label} request {hw[0]}x{hw[1]}: {s:.3f} s for {STEPS} steps", flush=True)
    print(f"{label} UNet call at batch 3 (one 3-way-CFG step): {step_ms:.3f} ms", flush=True)
    print(f"{label} launches on the path: {launches}", flush=True)
    return launches, seconds, step_ms


def flash_processor(q, k, v, meta, extra=None):
    """An AttnProcessor that sends every site to K3, as a user of the
    processor slot would write it."""
    from anyedit_tpu_torch.ops.attention import attention
    return attention(q, k, v, use_flash=True)


def int8_flash_processor(q, k, v, meta, extra=None):
    """An AttnProcessor for the W8A8 UNet that sends the level-0/1
    self-attention sites (64x64 and 32x32 latents) to the int8 kernel K4 and
    every other site to `int8_processor`."""
    from anyedit_tpu_torch.models.layers import int8_processor
    from anyedit_tpu_torch.ops.attention import self_attn_int8
    if meta.is_self and meta.name.split(".")[0] in ("down_0", "down_1", "up_0", "up_1"):
        return self_attn_int8(q, k, v)
    return int8_processor(q, k, v, meta, extra)


def k3_path(dev, zoo):
    """One 20-step 3-way-CFG edit through `ip2p_edit` on the full-width bf16
    UNet with every attention site on K3; then one UNet call through K3
    against the default route. Returns (launches, seconds, step_ms, rel_l2)."""
    import torch
    from anyedit_tpu_torch.diffusion import ip2p_edit
    from anyedit_tpu_torch.ops.attention import flash_attention
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.ops.resize import normalize_to_unit

    unet, ns = zoo._ip2p_core()
    vae, text = zoo._vae(), zoo._text_encoder()
    c = zoo.cfg
    size = c.canvas.edit_size
    img = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (size, size, 3), np.uint8)).to(dev).float()
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.inference_mode():
        lat_in = vae.encode(normalize_to_unit(img)[None].to(torch.bfloat16))[0] \
            * c.vae.scaling_factor
        cond = text(REQUESTS[0][1]).to(torch.bfloat16)
        uncond = text("").to(torch.bfloat16)
        torch.cuda.synchronize()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        lat = ip2p_edit(lambda x, t, ctx: unet(x, t, ctx, processor=flash_processor),
                        ns, lat_in, cond, uncond, num_steps=K3_STEPS,
                        guidance_scale=S_TXT, image_guidance_scale=S_IMG, generator=g)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_attention.launches
    require(bool(torch.isfinite(lat).all()), "K3 path: final latents are finite")
    want = K3_STEPS * K3_PER_UNET_CALL
    require(launches == want, f"K3 launched {launches} times, want {want}")

    x, t, ctx = unet_inputs(zoo, dev)
    with torch.inference_mode():
        ref = unet(x, t, ctx)
        out = unet(x, t, ctx, processor=flash_processor)
        step_ms = time_ms(lambda: unet(x, t, ctx, processor=flash_processor), iters=5)
    rel = float((out - ref).norm() / ref.norm())
    print(f"K3 path: {K3_STEPS}-step edit in {seconds:.3f} s, {launches} K3 launches; "
          f"UNet call through K3 {step_ms:.3f} ms; rel-L2 to the default route "
          f"{rel:.4f} (bound {K3_VS_DEFAULT_REL_L2}), cosine {cosine(out, ref):.5f}",
          flush=True)
    require(bool(torch.isfinite(out).all()) and rel <= K3_VS_DEFAULT_REL_L2,
            "one UNet call through K3 agrees with the default route")
    return launches, seconds, step_ms, rel


def k4_path(dev, qzoo):
    """One W8A8 UNet call at batch 3 with the level-0/1 self-attention on K4,
    against the same call with `int8_processor`. Returns (launches, cos, ms)."""
    import torch
    from anyedit_tpu_torch.ops.attention import flash_int8
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    qunet, _ = qzoo._ip2p_core()
    x, t, ctx = unet_inputs(qzoo, dev)
    with torch.inference_mode():
        ref = qunet(x, t, ctx)
        torch.cuda.synchronize()
        flash_int8.launches = 0
        out = qunet(x, t, ctx, processor=int8_flash_processor)
        torch.cuda.synchronize()
        launches = flash_int8.launches
        step_ms = time_ms(lambda: qunet(x, t, ctx, processor=int8_flash_processor),
                          iters=5)
    cos = cosine(out, ref)
    print(f"K4 path: {launches} K4 launches in one W8A8 UNet call "
          f"({step_ms:.3f} ms); cosine to int8_processor {cos:.5f}", flush=True)
    require(launches == K4_PER_UNET_CALL,
            f"K4 launched {launches} times, want {K4_PER_UNET_CALL}")
    require(bool(torch.isfinite(out).all()) and cos > 0.95,
            "the K4 UNet call agrees with int8_processor (cosine > 0.95)")
    return launches, cos, step_ms


def grounding(dev, zoo):
    """One `ground()` of a 480x640 image on the full-width grounder: K2
    exactly 4 launches and K1 none (counted after a warm-up call), a
    result with masks of (h, w); then the detector on the same inputs
    (finite logits and boxes), and CUDA-event times of the detector, the
    SAM encode and the SAM decode of the 32 candidate boxes. Returns the
    launches and the times (ms)."""
    import torch
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    t0 = time.perf_counter()
    ground = zoo.grounder()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    img = np.random.default_rng(2).integers(0, 256, GROUND_HW + (3,), np.uint8)
    ground(img, RECORD["edited object"])
    torch.cuda.synchronize()
    flash_nomax.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    g = ground(img, RECORD["edited object"])
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    require(launches == {"flash_nomax": 0, "group_norm": K2_PER_GROUND},
            f"grounding launched {launches}, want K1 0 and K2 {K2_PER_GROUND}")
    require(g is not None and tuple(g.mask.shape) == GROUND_HW
            and tuple(g.masks.shape[1:]) == GROUND_HW and int(g.count) > 0,
            "ground() keeps boxes and returns masks of the image's shape")

    gd, sam = zoo._gdino(), zoo._sam()
    c = zoo.cfg
    with torch.inference_mode():
        pixels, ids, mask, _ = zoo.detector_inputs(img, RECORD["edited object"])
        logits, boxes = gd(pixels, ids, mask)
        require(tuple(logits.shape) == (1, c.gdino.num_queries, c.gdino.max_text_len)
                and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(boxes).all()),
                "the detector's logits and boxes are finite, of the full-width shapes")
        sam_px, scale = zoo.sam_inputs(img)
        emb = sam.encode(sam_px)
        prompts = (g.boxes * scale)[None]
        ms = {"gdino_forward_ms": time_ms(lambda: gd(pixels, ids, mask), iters=3),
              "sam_encode_ms": time_ms(lambda: sam.encode(sam_px), iters=3),
              "sam_decode_ms": time_ms(lambda: sam.decode_boxes(emb, prompts), iters=3),
              "ground_ms": call_ms}
    print(f"grounder (GDINO_SWINB 800 px, 900 queries, 256 tokens; SAM_VIT_H 1024) built "
          f"on the card in {build_s:.2f} s; ground() of {GROUND_HW[0]}x{GROUND_HW[1]}: "
          f"{call_ms:.1f} ms, {int(g.count)} of {g.valid.numel()} boxes kept, mask covers "
          f"{float(g.mask.float().mean()):.3f}; detector {ms['gdino_forward_ms']:.1f} ms, "
          f"SAM encode {ms['sam_encode_ms']:.1f} ms, SAM decode of {prompts.shape[1]} boxes "
          f"{ms['sam_decode_ms']:.1f} ms; launches {launches}", flush=True)
    return launches, ms


def color_alter_record(dev, zoo, k2_per_request: int):
    """One color_alter record through the registry on the full-width zoo.
    Returns (launches, seconds by stage)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.global_ import crop_composite
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.morphology import dilate, gaussian_blur

    spent = {"ground": 0.0, "edit": 0.0}
    frames = {}

    def timed(stage, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[stage] += time.perf_counter() - t0
            frames[stage] = out
            return out
        return call

    tb = zoo.toolbox()
    tb = Toolbox(ground=timed("ground", tb.ground), ip2p=timed("edit", tb.ip2p))
    rec = InstructionRecord.from_json(RECORD)
    img = np.random.default_rng(4).integers(0, 256, GROUND_HW + (3,), np.uint8)
    torch.cuda.synchronize()
    flash_nomax.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    with k2_tally() as tally:
        out = get_pipeline(rec.edit_type)(tb, rec, img, np.random.default_rng(0))
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}

    require(out.success, f"the color_alter record succeeded ({out.reason})")
    require(out.edited is not None and out.edited.dtype == np.uint8
            and out.edited.shape == img.shape, "a uint8 image of the input's shape")
    require(out.mask is not None and bool(out.mask.any()), "a non-empty mask")
    feather = gaussian_blur(dilate(torch.as_tensor(out.mask, device=dev).float(), 5),
                            2.0).cpu().numpy()
    untouched = feather == 0
    require(np.array_equal(out.edited[untouched], img[untouched]),
            "the input's bytes wherever the feathered mask is 0")
    m = feather[..., None]
    blend = frames["edit"].astype(np.float32) * m + img.astype(np.float32) * (1.0 - m)
    blend_err = np.abs(out.edited.astype(np.int32)
                       - np.clip(blend, 0, 255).astype(np.uint8).astype(np.int32)).max()
    require(blend_err <= 1, "the record is the edit blended over the input by the "
            "feathered mask (numpy, within one level)")
    # Random weights make the merged mask a speckle over the whole frame, so
    # its feathered mask may leave no pixel at 0. The composite is also held
    # on the record's frames with the mask cut to a 64-px window at its first
    # pixel: every pixel beyond that window's feather keeps the input's bytes.
    ys, xs = np.nonzero(out.mask)
    window = np.zeros_like(out.mask)
    window[ys[0]:ys[0] + 64, xs[0]:xs[0] + 64] = out.mask[ys[0]:ys[0] + 64, xs[0]:xs[0] + 64]
    cut = crop_composite(img, frames["edit"], torch.as_tensor(window, device=dev))
    beyond = gaussian_blur(dilate(torch.as_tensor(window, device=dev).float(), 5),
                           2.0).cpu().numpy() == 0
    require(beyond.sum() > 0 and np.array_equal(cut[beyond], img[beyond]),
            "the composite keeps the input's bytes beyond a windowed mask's feather")
    want = {"flash_nomax": STEPS * K1_PER_UNET_CALL,
            "group_norm": k2_per_request + K2_PER_GROUND}
    require(launches == want, f"the record launched {launches}, want {want}")
    seconds = {"record": total, **spent, "composite": total - sum(spent.values())}
    print(f"color_alter record {GROUND_HW[0]}x{GROUND_HW[1]}: {total:.3f} s (ground "
          f"{spent['ground']:.3f}, edit {spent['edit']:.3f} for {STEPS} steps, composite "
          f"and the rest {seconds['composite']:.3f}); mask covers {out.mask.mean():.3f}, "
          f"the feathered mask {float((feather > 0).mean()):.3f}; the record's output is "
          f"the blend within {blend_err} level of numpy's; its byte check held on "
          f"{int(untouched.sum())} pixels outside the feather; the composite re-run with "
          f"the mask cut to a 64-px window kept {int(beyond.sum())} pixels beyond its "
          f"feather byte for byte; launches {launches}", flush=True)
    return launches, seconds


def check_scorer_reference(dev):
    """The tiny scorers in bf16 on the card against the same scorers in fp32
    on the CPU, same weights: the CLIP-layout tower through `clip_image`,
    the CLIP text model, the aesthetic MLP, an EVA-layout tower (no pre-LN,
    no projection, a patch-conv bias, a 48-wide exact-GELU MLP) and
    Blip2VQA's first-step logits on it. Each output within twice the CPU's
    own bf16 distance, at least one bf16 rounding (2^-8); the yes/no
    answers agree wherever the fp32 margin exceeds twice that bound (each
    of the two logits may move by it)."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()
    eva = dataclasses.replace(tiny.eva, pre_ln=False, use_proj=False, patch_bias=True,
                              mlp_dim=48, activation="gelu")

    def cfg(dtype):
        q = tiny.qformer
        return dataclasses.replace(
            tiny, vision=dataclasses.replace(tiny.vision, dtype=dtype),
            text=dataclasses.replace(tiny.text, dtype=dtype),
            eva=dataclasses.replace(eva, dtype=dtype),
            qformer=dataclasses.replace(q, dtype=dtype, lm=dataclasses.replace(q.lm, dtype=dtype)))

    def modules(z):
        c = z.cfg
        return [z._vision("clip_vision", c.vision), z._text_proj(), z._aesthetic_mlp(),
                z._vision("eva_vit", c.eva), z._blip2()]

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    for k in ("cpu16", "card16"):
        for src, dst in zip(modules(zoos["ref"]), modules(zoos[k])):
            dst.load_state_dict(src.state_dict())
    img = np.random.default_rng(5).integers(0, 256, (48, 40, 3), np.uint8)

    def outputs(z):
        clip_image, clip_text = z.clip_towers()
        with torch.inference_mode():
            tokens = z._vision("eva_vit", z.cfg.eva)(z._pixels(img, z.cfg.eva.image_size))[0]
        ask = z.vqa_fn()
        out = {"clip_image": clip_image(img), "clip_text": clip_text(RECORD["input"]),
               "aesthetic": torch.tensor([z.aesthetic_fn()(img)]), "eva_tokens": tokens}
        for i, q in enumerate(VQA_QUESTIONS):
            out[f"vqa_logits_{i}"] = ask.logits(img, q)[0]
        return {k: v.float().cpu() for k, v in out.items()}

    out = {k: outputs(z) for k, z in zoos.items()}
    yes, no = zoos["ref"].vqa_fn().yes_no_ids
    bounds = {}
    for name, ref in out["ref"].items():
        d16 = float((out["cpu16"][name] - ref).abs().max())
        dcard = float((out["card16"][name] - ref).abs().max())
        bounds[name] = 2 * max(d16, 2.0 ** -8)
        print(f"tiny scorer {name}: card bf16 vs CPU fp32 max diff {dcard:.3e}, CPU bf16 "
              f"{d16:.3e} (bound {bounds[name]:.3e})", flush=True)
        require(bool(torch.isfinite(out["card16"][name]).all()) and dcard <= bounds[name],
                f"the card's bf16 {name} is within twice the CPU's bf16 distance")
    checked = 0
    for i in range(len(VQA_QUESTIONS)):
        ref, card = out["ref"][f"vqa_logits_{i}"], out["card16"][f"vqa_logits_{i}"]
        margin = float(ref[yes] - ref[no])
        if abs(margin) > 2 * bounds[f"vqa_logits_{i}"]:
            checked += 1
            require((float(card[yes] - card[no]) > 0) == (margin > 0),
                    f"the card's yes/no answer to question {i} is the CPU's")
    print(f"tiny yes/no answers: {checked} of {len(VQA_QUESTIONS)} margins past the bound, "
          "all agree", flush=True)


def median_ms(fn, runs: int = 3) -> tuple[float, list[float]]:
    """Median host ms of `runs` synchronized calls (after the caller's warm-up)."""
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def scorers(dev, zoo):
    """The full-width scorer slots on a 480x640 image: ms of each (median
    of 3 after a warm-up), finite outputs, unit-norm embeddings, and no K1 or
    K2 launch. Returns the ms by scorer."""
    import torch
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    t0 = time.perf_counter()
    tb = Toolbox()
    for slot in ("clip", "aesthetic", "vqa"):
        zoo.install(tb, slot)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    img = np.random.default_rng(6).integers(0, 256, GROUND_HW + (3,), np.uint8)
    calls = {"clip_image": lambda: tb.clip_image(img),
             "clip_text": lambda: tb.clip_text(RECORD["output"]),
             "aesthetic": lambda: tb.extra["aesthetic"](img),
             "vqa_yes_no": lambda: tb.vqa_yes_no(img, VQA_QUESTIONS[0])}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    flash_nomax.launches = 0
    group_norm.launches = 0
    timed = {name: median_ms(fn) for name, fn in calls.items()}
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    require(launches == {"flash_nomax": 0, "group_norm": 0},
            f"the scorers launched {launches}, want K1 0 and K2 0")
    c = zoo.cfg
    zi, zt = tb.clip_image(img), tb.clip_text(RECORD["output"])
    logits = tb.vqa_yes_no.logits(img, VQA_QUESTIONS[0])
    aesthetic = tb.extra["aesthetic"](img)
    for name, z in (("clip_image", zi), ("clip_text", zt)):
        require(tuple(z.shape) == (1, c.vision.proj_dim) and bool(torch.isfinite(z).all())
                and abs(float(z.norm()) - 1.0) <= 1e-3, f"{name} is a finite unit vector")
    require(tuple(logits.shape) == (1, c.qformer.lm.vocab_size)
            and bool(torch.isfinite(logits).all()) and np.isfinite(aesthetic),
            "the VQA logits and the aesthetic score are finite")
    yes, no = tb.vqa_yes_no.yes_no_ids
    print(f"scorers (CLIP_L_VISION + CLIP-L text, aesthetic MLP, EVA_VIT_G + BLIP2_QFORMER "
          f"+ FLAN_T5_XL) built on the card in {build_s:.2f} s; on {GROUND_HW[0]}x"
          f"{GROUND_HW[1]}: " + ", ".join(
              f"{k} {v[0]:.2f} ms ({', '.join(f'{t:.2f}' for t in v[1])})"
              for k, v in timed.items())
          + f"; CLIP score {float((zi * zt).sum()):.4f}, aesthetic {aesthetic:.4f}, yes-no "
          f"logit margin {float(logits[0, yes] - logits[0, no]):.4f}; launches {launches}",
          flush=True)
    return {k: v[0] for k, v in timed.items()}


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit grayscale, RGB or RGBA PNG whose rows all use filter type 0
    (what the port's writer emits) -> (H, W[, C]) uint8."""
    require(data[:8] == b"\x89PNG\r\n\x1a\n", "a PNG signature")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
    w, h, depth, ctype = hdr[:4]
    ch = {0: 1, 2: 3, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * ch)
    require(depth == 8 and not rows[:, 0].any(), "8-bit rows with filter type 0")
    px = rows[:, 1:].reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def executor_record(dev, zoo, k2_per_request: int, keep_root: Path):
    """RECORD through `FactoryExecutor` three times (the docstring's phase
    13). Returns (launches of run (b), its StageTimer report). Run (c)
    writes under `keep_root`, and the record's original image goes to
    `keep_root/images/<image_file>`: the train phase's ledger and image
    root (color_alter writes no input_img, so the trainer reads the
    original by the record's file name, as the JAX trainer does with
    `--image-root`; the file holds PNG bytes, which the port's reader
    recognises by their signature)."""
    import torch
    from anyedit_tpu_torch.core.png import write_png
    from anyedit_tpu_torch.core.rng import host_rng
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.global_ import crop_composite
    from anyedit_tpu_torch.filters.post_filter import post_filter_decision
    from anyedit_tpu_torch.filters.pre_filter import PreScores, pre_filter_decision
    from anyedit_tpu_torch.filters.scorers import directional_clip_score
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor

    rec = InstructionRecord.from_json(RECORD)
    img = np.random.default_rng(7).integers(0, 256, GROUND_HW + (3,), np.uint8)
    (keep_root / "images").mkdir(parents=True, exist_ok=True)
    write_png(keep_root / "images" / rec.image_file, img)
    seen = {}

    def capture(name, fn):
        def call(*args, **kwargs):
            seen[name] = fn(*args, **kwargs)
            return seen[name]
        return call

    def run(root, label, **cfg):
        """One executor over a fresh toolbox (ground and ip2p captured);
        returns (executor, ledger line, launches, seconds)."""
        tb = zoo.toolbox(slots=("clip", "aesthetic", "vqa"))
        tb.ground, tb.ip2p = capture("ground", tb.ground), capture("edit", tb.ip2p)
        ex = FactoryExecutor(tb, ExecutorConfig(output_root=str(Path(root) / label), **cfg))
        default_pre, default_post = ex.pre_scorer, ex.post_scorer
        ex.pre_scorer = lambda r, i: seen.setdefault("pre", default_pre(r, i))
        ex.post_scorer = lambda r, i, o: seen.setdefault("post", (o, default_post(r, i, o)))[1]
        return ex

    def go(ex):
        torch.cuda.synchronize()
        flash_nomax.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        ex.run([rec], lambda r: img)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
        line = json.loads((Path(ex.cfg.output_root) / "ledger.jsonl").read_text().splitlines()[-1])
        return line, launches, seconds

    clip_image, clip_text = zoo.clip_towers()
    full = {"flash_nomax": STEPS * K1_PER_UNET_CALL,
            "group_norm": k2_per_request + K2_PER_GROUND}
    with tempfile.TemporaryDirectory() as root:
        # (a) the default scorers, both gates on
        seen.clear()
        ex = run(root, "default")
        line, launches, seconds = go(ex)
        pre = seen["pre"]
        ratio = zoo.grounder()(img, rec.edited_object).union_ratio
        recompute = {"clip": float((clip_image(img) * clip_text(rec.input)).sum()),
                     "aesthetic": zoo.aesthetic_fn()(img), "object_ratio": float(ratio)}
        for k, v in recompute.items():
            require(abs(getattr(pre, k) - v) <= 1e-3, f"pre-score {k} matches a recompute")
        keep = pre_filter_decision(rec.edit_type, pre, edited_object=rec.edited_object,
                                   rng_uniform=float(host_rng(0, rec.key()).uniform()))
        pre_filtered = line["status"] == "filtered" and line["payload"].get("stage") == "pre"
        require(keep != pre_filtered, "the pre-gate's decision is pre_filter_decision's")
        want = {"flash_nomax": 0, "group_norm": K2_PER_GROUND} if pre_filtered else full
        require(launches == want, f"run (a) launched {launches}, want {want}")
        print(f"executor record (a), default scorers and gates: {line['status']} "
              f"{line['payload'].get('stage', '')} in {seconds:.3f} s; pre-scores clip "
              f"{pre.clip:.4f}, aesthetic {pre.aesthetic:.4f}, object ratio "
              f"{pre.object_ratio:.4f} (recomputed within 1e-3); launches {launches}",
              flush=True)

        # (b) both gates; the pre-gate sees the image size only
        seen.clear()
        ex = run(root, "gated")
        scored = ex.pre_scorer

        def size_only(r, i):
            s = scored(r, i)
            return PreScores(width=s.width, height=s.height)
        ex.pre_scorer = size_only
        line, launches, seconds = go(ex)
        require(line["status"] in ("success", "filtered")
                and line["payload"].get("stage") != "pre", f"run (b) ended {line}")
        outcome, sc = seen["post"]
        if line["status"] == "filtered":
            require(line["payload"]["scores"] == dataclasses.asdict(sc),
                    "the ledger holds the post-filter's scores")
        edited = outcome.edited
        ie_t, te_t = clip_image(edited), clip_text(rec.output)
        ie_s, te_s = clip_image(img), clip_text(rec.input)
        words = rec.edit.split()
        recompute = {
            "clip": float((ie_t * te_t).sum()),
            "dir_clip": float(directional_clip_score(ie_s, ie_t, te_s, te_t)),
            "l1": float(np.mean(np.abs(img.astype(np.float32) - edited.astype(np.float32)))
                        / 255.0),
            "vqa_yes": zoo.vqa_fn()(edited, f"Is the color of {rec.edited_object} close to "
                                            f"{words[-1]}?")}
        for k, v in recompute.items():
            got = getattr(sc, k)
            require(got == v if isinstance(v, bool) else abs(got - v) <= 1e-3,
                    f"post-score {k} {got} matches a recompute {v}")
        require(post_filter_decision(rec.edit_type, sc) == (line["status"] == "success"),
                "the post-gate's decision is post_filter_decision's")
        require(launches == full, f"run (b) launched {launches}, want {full} (one grounding)")
        report = ex.timer.report()
        print(f"executor record (b), both gates, the pre-gate on the image size: "
              f"{line['status']} in {seconds:.3f} s; post-scores {dataclasses.asdict(sc)} "
              f"(recomputed within 1e-3); launches {launches}", flush=True)
        print(f"executor record (b) StageTimer: {json.dumps(report)}", flush=True)
        b_launches, b_seconds = launches, seconds

        # (c) both gates off: the PNG holds the pipeline's bytes
        seen.clear()
        ex = run(keep_root, "ungated", run_pre_filter=False, run_post_filter=False)
        line, launches, seconds = go(ex)
        require(line["status"] == "success", f"the ungated record succeeded ({line})")
        png = decode_png(Path(line["payload"]["edited_file"]).read_bytes())
        want_px = crop_composite(img, seen["edit"], seen["ground"].mask)
        require(png.shape == img.shape and np.array_equal(png, want_px),
                "edited_img/*.png decodes to the pipeline's bytes")
        require(launches == full, f"run (c) launched {launches}, want {full}")
        print(f"executor record (c), gates off: success in {seconds:.3f} s; "
              f"{Path(line['payload']['edited_file']).name} decodes to the pipeline's "
              f"{png.shape} bytes; launches {launches}", flush=True)
    return b_launches, {"record_s": b_seconds, "stages": report}


def check_lama(dev):
    """LaMa at LAMA (9 FFC blocks, seeded weights) through the `inpainter()`
    entry point on one LAMA_HW image: the card's slot against the CPU zoo's
    slot on the same weights and input. cuDNN's TF32 is at PyTorch's default
    (on) for the phase, so the slot must turn it off itself and restore it;
    the same padded forward with TF32 left on is printed beside, as what the
    slot's fp32 buys. Returns (max abs error, ms of one slot call)."""
    import torch
    from anyedit_tpu_torch.models.lama import pad_to_modulo
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    cpu_zoo, card_zoo = ModelZoo(ZooConfig(), "cpu", seed=0), ModelZoo(ZooConfig(), dev, seed=0)
    card_zoo._lama().load_state_dict(cpu_zoo._lama().state_dict())
    rng = np.random.default_rng(8)
    h, w = LAMA_HW
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.float32)
    mask[120:360, 200:440] = 1.0
    ref = cpu_zoo.inpainter()(img, mask)
    slot = card_zoo.inpainter()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default
    try:
        out = slot(img, mask)
        require(torch.backends.cudnn.allow_tf32, "the slot restores cuDNN's TF32 setting")
        err = float(np.abs(out - ref).max())
        ms = time_ms(lambda: slot(img, mask), iters=5)
        with torch.inference_mode():
            x, _ = pad_to_modulo(torch.from_numpy(img)[None].to(dev), 8)
            m, _ = pad_to_modulo(torch.from_numpy(mask)[None, ..., None].to(dev), 8)
            tf32 = card_zoo._lama()(x, m)[0, :h, :w].cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tf32_err = float(np.abs(tf32 - ref).max())
    print(f"LaMa (LAMA, 9 FFC blocks) through inpainter() on {h}x{w} (padded to "
          f"{x.shape[1]}x{x.shape[2]}), cuDNN TF32 on outside the slot: card vs CPU max abs "
          f"{err:.3e} (bound {LAMA_BOUND}); the same forward with TF32 left on "
          f"{tf32_err:.3e}; {ms:.2f} ms a slot call on the card", flush=True)
    require(out.shape == (h, w, 3) and bool(np.isfinite(out).all()) and err <= LAMA_BOUND,
            f"the inpainter() slot on the card within {LAMA_BOUND} of the CPU's")
    return err, ms


def check_inpaint_reference(dev):
    """The tiny SD inpainter (`sample_inpaint` on the 9-channel UNet) in bf16
    on the card against fp32 on the CPU, same weights and noise, bounded by
    the CPU's own bf16 error, as `check_reference` holds the IP2P slice."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()

    def cfg(dtype):
        return dataclasses.replace(
            tiny, inpaint_unet=dataclasses.replace(tiny.inpaint_unet, dtype=dtype),
            vae=dataclasses.replace(tiny.vae, dtype=dtype),
            text=dataclasses.replace(tiny.text, dtype=dtype))

    def models(z):
        return z._inpaint_core()[0], z._vae(), z._text_model("clip_text", z.cfg.text)

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    for k in ("cpu16", "card16"):
        for src, dst in zip(models(zoos["ref"]), models(zoos[k])):
            dst.load_state_dict(src.state_dict())
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    mask = np.zeros((48, 40), np.float32)
    mask[10:34, 6:30] = 1.0
    noise = torch.from_numpy(rng.standard_normal((2, 1, 32, 32, 4)).astype(np.float32))
    out = {k: z.sd_inpainter()(img, mask, "a red ball", "blurry", steps=3,
                               init_latents=noise[0], renoise=noise[1]).astype(np.int32)
           for k, z in zoos.items()}
    err = {k: np.abs(out[k] - out["ref"]) for k in ("cpu16", "card16")}
    for k, e in err.items():
        print(f"tiny SD inpainter, {k} vs CPU fp32: uint8 max diff {e.max()} "
              f"mean {e.mean():.4f}", flush=True)
    require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
            and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
            "the card's bf16 SD inpainter is within twice the CPU's bf16 error")


@contextlib.contextmanager
def gates_open():
    """Both filter decisions forced to True (the scorers still run), as the
    factory benches do: random weights fail every semantic threshold."""
    from anyedit_tpu_torch.runtime import executor as ex_mod
    saved = ex_mod.pre_filter_decision, ex_mod.post_filter_decision
    ex_mod.pre_filter_decision = ex_mod.post_filter_decision = lambda *a, **k: True
    try:
        yield
    finally:
        ex_mod.pre_filter_decision, ex_mod.post_filter_decision = saved


def ground_as_real_weights(tb, device) -> set:
    """Wrap `tb.ground` and its `.batch` as the JAX factory bench
    (`tools/bench_factory.py`) does at production thresholds, where the
    random detector rarely keeps a box: the real grounding runs, and its
    answer is, on a source image, the detection or a synthetic box and mask
    (the image's second quarter) where none is kept; on any other image
    (the removal check, the post-filter's existence check), None, as real
    weights would find the object gone. Returns the set to which the caller
    adds the ids of its source images."""
    import torch
    from anyedit_tpu_torch.grounding.maskgen import MAX_BOXES, grounding_result

    real = tb.ground
    source_ids: set = set()

    def fallback(h, w):
        m = torch.full((MAX_BOXES, h, w), -1.0, device=device)
        m[0, h // 4:h // 2, w // 4:w // 2] = 1.0
        boxes = torch.zeros((MAX_BOXES, 4), device=device)
        boxes[0] = torch.tensor([w / 4, h / 4, w / 2, h / 2])
        scores = torch.zeros((MAX_BOXES,), device=device)
        scores[0] = 0.9
        valid = torch.zeros((MAX_BOXES,), dtype=torch.bool, device=device)
        valid[0] = True
        return grounding_result(m, boxes, scores, valid, (h, w), "merge", None)

    def answer(image, g):
        if id(image) not in source_ids:
            return None
        return fallback(*image.shape[:2]) if g is None or not bool(g.mask.any()) else g

    def ground(image, phrase, mode="merge", count_k=None):
        return answer(image, real(image, phrase, mode=mode, count_k=count_k))

    def ground_batch(images, phrases, modes=None, count_ks=None):
        return [answer(im, g) for im, g in
                zip(images, real.batch(images, phrases, modes=modes, count_ks=count_ks))]
    ground.batch = ground_batch
    tb.ground = ground
    return source_ids


def chunk(dev, pzoo):
    """CHUNK_TYPES records, each its own 480x640 array, through
    `FactoryExecutor(grounding_batch=4)` on the production zoo with every
    slot, both gates open and the grounder answering as real weights would
    (`ground_as_real_weights`); then the same records per record; then the
    BUCKET_TYPES records in one chunk. Returns {"launches": by path ("chunk",
    "bucket"), "seconds": a record by mode, "peak": GiB by mode, "edit_dist":
    the batched edits' largest mean uint8 distance from per record}."""
    import io
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor

    def make(types, tag):
        return [InstructionRecord.from_json(dict(
            RECORD, edit_type=et, edit=f"{RECORD['edit']} {tag}{i}",
            image_file=f"{tag}{i}.jpg")) for i, et in enumerate(types)]
    recs, bucket = make(CHUNK_TYPES, "chunk_"), make(BUCKET_TYPES, "bucket_")
    rng = np.random.default_rng(10)
    images = {r.key(): rng.integers(0, 256, GROUND_HW + (3,), np.uint8) for r in recs + bucket}
    t0 = time.perf_counter()
    tb = pzoo.toolbox(slots=("clip", "aesthetic", "vqa", "sd_inpaint"))
    torch.cuda.synchronize()
    print(f"production zoo (every slot, box_threshold {pzoo.cfg.box_threshold}) built on "
          f"the card in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB resident", flush=True)
    ground_as_real_weights(tb, dev).update(id(im) for im in images.values())
    real = tb.ip2p
    live, batched, single, calls = [], {}, {}, []

    def ip2p(image, instruction, mask01, **kw):
        out = real(image, instruction, mask01, **kw)
        if mask01 is None:
            live.append(instruction)
            single[instruction] = out
        return out

    def ip2p_batch(images_, instructions, **kw):
        outs = real.batch(images_, instructions, **kw)
        calls.append(list(instructions))
        batched.update(zip(instructions, outs))
        return outs
    ip2p.batch = ip2p_batch
    tb.ip2p = ip2p

    def go(label, records, **cfg):
        live.clear()
        calls.clear()
        err = io.StringIO()
        with tempfile.TemporaryDirectory() as root, gates_open(), \
                contextlib.redirect_stderr(err):
            ex = FactoryExecutor(tb, ExecutorConfig(output_root=root, save_images=False, **cfg))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            flash_nomax.launches = 0
            group_norm.launches = 0
            t0 = time.perf_counter()
            report = ex.run(records, lambda r: images[r.key()])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {"flash_nomax": flash_nomax.launches,
                        "group_norm": group_norm.launches}
            lines = [json.loads(x) for x in (Path(root) / "ledger.jsonl").read_text()
                     .splitlines()]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        sys.stderr.write(err.getvalue())
        require("fell back" not in err.getvalue(), f"{label}: no batch call fell back")
        outcomes = {x["key"]: (x["status"], x["payload"].get("stage"),
                               x["payload"].get("reason")) for x in lines}
        print(f"{label}: {seconds:.3f} s for {len(records)} records "
              f"({seconds / len(records):.3f} s a record), peak {peak:.2f} GiB allocated; "
              f"outcomes {sorted(outcomes.values())}; launches {launches}; StageTimer "
              f"{json.dumps(report['stages'])}", flush=True)
        if cfg.get("grounding_batch"):
            require({"ground_batch", "clip_batch", "edit_batch"} <= set(report["stages"]),
                    f"{label} ran ground_batch, clip_batch and edit_batch: "
                    f"{sorted(report['stages'])}")
            require(live == [], f"{label}: no live unmasked IP2P call for a batched record: "
                    f"{live}")
        return outcomes, launches, seconds, peak

    want = STEPS * K1_PER_UNET_CALL       # one batched UNet call a step
    c_out, c_launches, c_s, c_peak = go("chunk of 4", recs, grounding_batch=4)
    n_color = CHUNK_TYPES.count("color_alter")
    require(calls == [[r.edit for r in recs if r.edit_type == "color_alter"]],
            f"the {n_color} color_alter records' edits are one batched call: {calls}")
    require(c_launches["flash_nomax"] == want and c_launches["group_norm"] > 0,
            f"the chunk launched {c_launches}, want K1 {want} and K2 > 0")
    p_out, p_launches, p_s, p_peak = go("per record", recs, grounding_batch=0)
    require(p_out == c_out, f"chunk outcomes {c_out} equal per-record {p_out}")
    require(p_launches["flash_nomax"] == n_color * want,
            f"per record launched K1 {p_launches['flash_nomax']}, want {n_color * want}")
    require(sorted(single) == sorted(batched), f"per record edited {sorted(single)}")
    dist = {k: np.abs(batched[k].astype(np.int32) - single[k].astype(np.int32)) for k in single}
    for k, d in dist.items():
        print(f"batched edit {k!r} vs its per-record edit: uint8 max {d.max()} mean "
              f"{d.mean():.3f} (bound: mean {CHUNK_EDIT_MEAN_BOUND})", flush=True)
        require(d.mean() <= CHUNK_EDIT_MEAN_BOUND,
                f"the batched edit of {k!r} within a mean of {CHUNK_EDIT_MEAN_BOUND} levels "
                "of its per-record edit")
    b_out, b_launches, b_s, b_peak = go("bucket of 4", bucket, grounding_batch=4)
    require(calls == [[r.edit for r in bucket]],
            f"the bucket's {len(bucket)} edits are one batched call: {calls}")
    require(b_launches["flash_nomax"] == want and b_launches["group_norm"] > 0,
            f"the bucket launched {b_launches}, want K1 {want} and K2 > 0")
    require(all(o[0] == "success" for o in b_out.values()), f"the bucket's outcomes {b_out}")
    return {"launches": {"chunk": c_launches, "bucket": b_launches},
            "seconds": {"chunk": c_s / len(recs), "per_record": p_s / len(recs),
                        "bucket": b_s / len(bucket)},
            "peak": {"chunk": c_peak, "per_record": p_peak, "bucket": b_peak},
            "edit_dist": max(float(d.mean()) for d in dist.values())}


def slice3_records(dev, zoo):
    """One background_change and one style_change record through
    `get_pipeline` on the full-width zoo: K1 500 each (50 steps of a UNet
    with 10 K1 sites), seconds printed; then one more SD-inpainter call,
    warm. Returns the seconds by record, the SD inpainter's seconds (in the
    record, and warm) and the background_change record's launches."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    tb = zoo.toolbox(slots=("sd_inpaint",))
    real_sd, spent = tb.sd_inpaint, {}

    def sd_inpaint(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_sd(*a, **k)
        torch.cuda.synchronize()
        spent["sd_inpaint"] = time.perf_counter() - t0
        return out
    tb.sd_inpaint = sd_inpaint
    img = np.random.default_rng(11).integers(0, 256, GROUND_HW + (3,), np.uint8)
    seconds, launches = {}, {}
    for et in ("background_change", "style_change"):
        rec = InstructionRecord.from_json(dict(RECORD, edit_type=et, output="a beach at dusk",
                                               edit="turn it into a watercolor painting"))
        torch.cuda.synchronize()
        flash_nomax.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        out = get_pipeline(et)(tb, rec, img, np.random.default_rng(0))
        torch.cuda.synchronize()
        seconds[et] = time.perf_counter() - t0
        launches[et] = {"flash_nomax": flash_nomax.launches,
                        "group_norm": group_norm.launches}
        require(out.success and out.edited.shape == img.shape and out.edited.dtype == np.uint8,
                f"the {et} record succeeded with a uint8 image ({out.reason})")
        require(flash_nomax.launches == 50 * K1_PER_UNET_CALL,
                f"{et} launched K1 {flash_nomax.launches} times, want {50 * K1_PER_UNET_CALL}")
        print(f"{et} record {GROUND_HW[0]}x{GROUND_HW[1]}: {seconds[et]:.3f} s"
              + (f" (SD inpainter, 50 steps: {spent['sd_inpaint']:.3f} s)"
                 if et == "background_change" else " (IP2P, 50 steps)")
              + f"; launches {launches[et]}", flush=True)
    first = spent["sd_inpaint"]
    mask = np.zeros(GROUND_HW, np.float32)
    mask[120:360, 160:480] = 1.0
    sd_inpaint(img, mask, "a photo of a red car")
    print(f"SD inpainter, 50 steps on {GROUND_HW[0]}x{GROUND_HW[1]}: {first:.3f} s in the "
          f"record (its first call), {spent['sd_inpaint']:.3f} s warm", flush=True)
    return seconds, (first, spent["sd_inpaint"]), launches["background_change"]


def live_modulations_(model, seed: int):
    """Draw every adaLN modulation weight of an MMDiT or a Flux (zero at the
    seeded init, as in the JAX package, which leaves every gate at 0 and the
    block stack out of the output) from N(0, 1/fan_in), seeded, in place, on
    the weights' device, so that the blocks reach the output."""
    import torch
    gen = None
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith(("norm1.linear", "norm1_context.linear", "norm_out.linear",
                              ".norm.linear")):
                w = mod.weight
                gen = gen or torch.Generator(device=w.device).manual_seed(seed)
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                        / w.shape[1] ** 0.5)
    return model


def check_ultraedit_reference(dev):
    """The tiny UltraEdit slot (MMDiT, flow edit, SD3 VAE, CLIP-L with
    projection, CLIP-G, T5) in bf16 on the card against the same slot in
    fp32 on the CPU, with the same weights (the MMDiT's modulations drawn
    live) and noise: the card within twice the CPU's own bf16 distance."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()

    def cfg(dtype):
        r = dataclasses.replace
        return r(tiny, mmdit=r(tiny.mmdit, dtype=dtype), sd3_vae=r(tiny.sd3_vae, dtype=dtype),
                 text=r(tiny.text, dtype=dtype), text_g=r(tiny.text_g, dtype=dtype),
                 flux_text=r(tiny.flux_text, dtype=dtype))

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    for z in zoos.values():
        z.ultraedit_fn()
    live_modulations_(zoos["ref"]._mmdit(), 7)
    for k in ("cpu16", "card16"):
        for name in ("mmdit", "sd3_vae", "clip_text_sd3", "clip_text_g", "t5"):
            zoos[k]._cache[name].load_state_dict(zoos["ref"]._cache[name].state_dict())
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    mask = np.zeros((48, 40), np.float32)
    mask[8:40, 4:32] = 1.0
    noise = torch.from_numpy(rng.standard_normal((2, 1, 32, 32, 4)).astype(np.float32))
    out = {k: z.ultraedit_fn()(img, "make the jacket leather", mask, steps=3,
                               init_latents=noise[0], renoise=noise[1]).astype(np.int32)
           for k, z in zoos.items()}
    err = {k: np.abs(out[k] - out["ref"]) for k in ("cpu16", "card16")}
    for k, e in err.items():
        print(f"tiny UltraEdit, {k} vs CPU fp32: uint8 max diff {e.max()} "
              f"mean {e.mean():.4f}", flush=True)
    require(np.abs(out["ref"] - img).mean() > 2.0, "the tiny edit changes the image")
    require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
            and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
            "the card's bf16 UltraEdit slot is within twice the CPU's bf16 error")


def geometry_records(dev, zoo):
    """One real `ground()` of a 480x640 image (K2 exactly 4, K1 0), then
    one record of each of GEOM_TYPES through `get_pipeline` on the
    full-width grounder and LaMa. On the source image the grounder's answer
    is replaced by synthetic detections of the two drawn objects (the real
    grounding still runs each time), so that the erase-and-paste path runs:
    every record succeeds with a uint8 frame, K1 0, K2 4 a grounding, the
    movement's pasted pixels are the source object's bytes and the
    outpainting input is the object's box expanded by 10 %. Returns the
    launches of the four records, K2's tally of them (`k2_tally`) and their
    seconds by type."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.grounding.maskgen import MAX_BOXES, grounding_result
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    h, w = GROUND_HW
    img = np.random.default_rng(13).integers(0, 256, GROUND_HW + (3,), np.uint8)
    for (x1, y1, x2, y2), colour in zip(GEOM_BOXES.values(), ((200, 30, 30), (30, 150, 40))):
        img[y1:y2, x1:x2] = colour
    real = zoo.grounder()
    phrases = []

    def synthetic(phrase, mode):
        names = [n for n in GEOM_BOXES if n in phrase] or list(GEOM_BOXES)
        masks = torch.full((MAX_BOXES, h, w), -1.0, device=dev)
        boxes = torch.zeros((MAX_BOXES, 4), device=dev)
        scores = torch.zeros((MAX_BOXES,), device=dev)
        valid = torch.zeros((MAX_BOXES,), dtype=torch.bool, device=dev)
        for i, name in enumerate(names):
            x1, y1, x2, y2 = GEOM_BOXES[name]
            masks[i, y1:y2, x1:x2] = 1.0
            boxes[i] = torch.tensor([x1, y1, x2, y2], dtype=torch.float32)
            scores[i], valid[i] = 0.9 - 0.1 * i, True
        return grounding_result(masks, boxes, scores, valid, (h, w), mode, None)

    def ground(image, phrase, mode="merge", count_k=None):
        g = real(image, phrase, mode=mode, count_k=count_k)
        phrases.append(phrase)
        return synthetic(phrase, mode) if image is img else g

    tb = Toolbox(ground=ground, inpaint=zoo.inpainter())
    real(img, "car")
    torch.cuda.synchronize()
    flash_nomax.launches = 0
    group_norm.launches = 0
    real(img, "car")
    torch.cuda.synchronize()
    one = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    require(one == {"flash_nomax": 0, "group_norm": K2_PER_GROUND},
            f"one ground() launched {one}, want K1 0 and K2 {K2_PER_GROUND}")

    seconds = {}
    flash_nomax.launches = 0
    group_norm.launches = 0
    phrases.clear()
    with k2_tally() as tally:
        for et in GEOM_TYPES:
            rec = InstructionRecord.from_json(dict(RECORD, edit_type=et, **{"new object": "tree"}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = get_pipeline(et)(tb, rec, img, np.random.default_rng(0))
            torch.cuda.synchronize()
            seconds[et] = time.perf_counter() - t0
            require(out.success and out.edited is not None and out.edited.dtype == np.uint8
                    and out.edited.shape == img.shape, f"the {et} record succeeded ({out.reason})")
            x1, y1, x2, y2 = GEOM_BOXES["car"]
            if et == "movement":
                draws = np.random.default_rng(0)
                delta = int(draws.integers(50, 121))
                dx = -delta if draws.choice(["left", "right"]) == "left" else delta
                half = (x2 - x1) // 2
                nx1 = int(np.clip((x1 + x2) // 2 + dx, half, w - half)) - half
                require(np.array_equal(out.edited[y1:y2, nx1:nx1 + x2 - x1], img[y1:y2, x1:x2]),
                        "the moved object's pixels are the source object's bytes")
            if et == "outpainting":
                ex, ey = int(0.1 * (x2 - x1)), int(0.1 * (y2 - y1))
                require(np.array_equal(out.input_image, img[y1 - ey:y2 + ey, x1 - ex:x2 + ex])
                        and out.edited is img, "outpainting: the expanded crop and the full frame")
            print(f"{et} record {h}x{w}: {seconds[et]:.3f} s; \"{rec.edit}\"", flush=True)

    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    want = {"flash_nomax": 0, "group_norm": K2_PER_GROUND * len(phrases)}
    require(launches == want, f"the geometry records launched {launches}, want {want} "
            f"({len(phrases)} groundings)")
    require(sum(tally.values()) == launches["group_norm"], "K2's tally holds every launch")
    print(f"geometry records: {len(phrases)} groundings, launches {launches}", flush=True)
    return launches, dict(tally), seconds


def mmdit_bound_ms(m, batch: int, n_txt: int, n_img: int) -> tuple[float, str, float]:
    """(bound ms, "operations" or "bytes", TFLOP) of one MMDiT call: each
    image token through its stream's q, k, v, out and FFN Linears (12 d^2
    MACs), each text token through its own (the last block: q, k, v only),
    the joint attention's QK^T and PV (2 L^2 d MACs a block), the patch,
    context and output projections and the per-row adaLN Linears, at 989
    TFLOP/s (bf16 dense); against the parameters read once and the inputs
    and output moved once at 3.35 TB/s."""
    c = m.cfg
    d, length = c.dim, n_txt + n_img
    macs = (c.depth * 12 * n_img + (c.depth - 1) * 12 * n_txt + 3 * n_txt) * d * d
    macs += c.depth * 2 * length ** 2 * d
    macs += ((c.in_channels + c.out_channels) * c.patch ** 2 * n_img
             + c.context_dim * n_txt) * d
    macs = batch * (macs + ((c.depth - 1) * 12 + 8 + 2) * d * d)
    flop = 2.0 * macs
    moved = sum(p.numel() * p.element_size() for p in m.parameters()) + batch * 4 * (
        n_img * c.patch ** 2 * (c.in_channels + c.out_channels) + n_txt * c.context_dim)
    ops_ms, bytes_ms = flop / 989e12 * 1e3, moved / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flop / 1e12


def ultraedit(dev, uzoo):
    """One full-width appearance_alter record with the UltraEdit slot
    installed (`install(tb, "ultraedit")`; an IP2P slot that raises beside
    it): success, K1 0 (the IP2P UNet's self-attention is K1's; the MMDiT's
    joint attention and the SD3 VAE's take sdpa), K2 two groundings' plus
    one SD3 VAE encode and decode (counted alone first), tallied by shape
    (`k2_tally`); then the MMDiT call at batch 3 (CUDA events) and the SD3
    conditioning of one text (median of 3). Returns (launches, numbers)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    c = uzoo.cfg

    def no_ip2p(*a, **k):
        raise RuntimeError("the IP2P fallback ran")
    t0 = time.perf_counter()
    tb = Toolbox(ground=uzoo.grounder(), ip2p=no_ip2p)
    uzoo.install(tb, "ultraedit")
    torch.cuda.synchronize()
    print(f"UltraEdit zoo (SD3_ULTRAEDIT MMDiT, T5-XXL, CLIP-L with projection, CLIP-bigG, "
          f"SD3 VAE; grounder) built on the card in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB resident", flush=True)
    edit, spent = tb.extra["ultraedit"], {}

    def timed_edit(*a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = edit(*a, **k)
        torch.cuda.synchronize()
        spent["edit"] = time.perf_counter() - t1
        spent["knobs"] = (k["steps"], k["s_txt"], k["s_img"])
        return out
    tb.extra["ultraedit"] = timed_edit
    img = np.random.default_rng(14).integers(0, 256, GROUND_HW + (3,), np.uint8)
    text = "make the car look like brushed leather"
    with torch.inference_mode():
        uzoo._from_latents(uzoo._to_latents([img], "sd3_vae"), [GROUND_HW], "sd3_vae")
        torch.cuda.synchronize()
        group_norm.launches = 0
        uzoo._from_latents(uzoo._to_latents([img], "sd3_vae"), [GROUND_HW], "sd3_vae")
    k2_vae = group_norm.launches

    rec = InstructionRecord.from_json(dict(RECORD, edit_type="appearance_alter", edit=text))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_nomax.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    with k2_tally() as tally:
        out = get_pipeline(rec.edit_type)(tb, rec, img, np.random.default_rng(0))
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(out.success and out.edited.dtype == np.uint8 and out.edited.shape == img.shape,
            f"the appearance_alter record succeeded with a uint8 frame ({out.reason})")
    require(spent.get("knobs") == (ULTRA_STEPS, 8.0, 1.5),
            f"the record edited through UltraEdit at 50 steps, 8.0 / 1.5: {spent.get('knobs')}")
    want = {"flash_nomax": 0, "group_norm": 2 * K2_PER_GROUND + k2_vae}
    require(launches == want, f"the UltraEdit record launched {launches}, want {want} (K1 0: "
            "the UltraEdit route ran, not the IP2P fallback)")
    require(sum(tally.values()) == launches["group_norm"], "K2's tally holds every launch")

    hw = c.canvas.edit_size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(3, hw, hw, c.mmdit.in_channels, generator=g, device=dev)
    t = torch.full((3,), 500.0, device=dev)
    cond = uzoo.sd3_cond()
    with torch.inference_mode():
        ctx, pooled = cond(text)
        args = (x, t, ctx.expand(3, -1, -1), pooled.expand(3, -1))
        mmdit_ms = time_ms(lambda: uzoo._mmdit()(*args), iters=5)
        cond_ms, _ = median_ms(lambda: cond(text))
    bound_ms, bound_by, tflop = mmdit_bound_ms(uzoo._mmdit(), 3, ctx.shape[1],
                                               (hw // c.mmdit.patch) ** 2)
    nums = {"record_s": total, "edit_s": spent["edit"], "mmdit_ms": mmdit_ms,
            "cond_ms": cond_ms, "peak_gib": peak, "args": args, "k2_tally": dict(tally)}
    print(f"appearance_alter record {GROUND_HW[0]}x{GROUND_HW[1]} through UltraEdit: "
          f"{total:.3f} s (the {ULTRA_STEPS}-step edit {spent['edit']:.3f} s); peak "
          f"{peak:.2f} GiB allocated; MMDiT call at batch 3 ({ctx.shape[1]} text + "
          f"{(hw // c.mmdit.patch) ** 2} image tokens) {mmdit_ms:.3f} ms against a bound of "
          f"{bound_ms:.3f} ms ({bound_by}: {tflop:.3f} TFLOP); SD3 conditioning "
          f"of one text (T5-XXL, CLIP-L, CLIP-bigG) {cond_ms:.2f} ms; K2 of one SD3 VAE "
          f"encode + decode {k2_vae}; launches {launches}", flush=True)
    return launches, nums


def ultraedit_mmdit(dev, uzoo, args):
    """The full-width MMDiT at the timed args, all three with the same live
    modulations (`live_modulations_`, seed 8) and the same seeded init,
    name by name: the bf16 call against an fp32 MMDiT (built once, freed
    after) within MMDIT_FP32_REL_L2, and a W8A8 MMDiT (`quant_diffusion`,
    quantized from the fp32 init; a second MMDiT only) against the bf16
    one at cosine > 0.95. Returns (relative L2, cosine, fp32 ms, W8A8 ms)."""
    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo

    def mmdit(**changes):
        cfg = dataclasses.replace(uzoo.cfg, **changes)
        return live_modulations_(ModelZoo(cfg, dev, seed=0)._mmdit(), 8)

    fm = live_modulations_(uzoo._mmdit(), 8)
    with torch.inference_mode():
        out = fm(*args).float()
        f32 = mmdit(mmdit=dataclasses.replace(uzoo.cfg.mmdit, dtype=torch.float32))
        ref = f32(*args).float()
        f_ms = time_ms(lambda: f32(*args), iters=5)
        del f32
        torch.cuda.empty_cache()
        rel = float((out - ref).norm() / ref.norm())
        qm = mmdit(quant_diffusion=True)
        cos = cosine(qm(*args), out)
        q_ms = time_ms(lambda: qm(*args), iters=5)
    print(f"MMDiT call at batch 3 (live modulations): bf16 against fp32 relative L2 "
          f"{rel:.4e} (fp32 call {f_ms:.3f} ms); W8A8 call {q_ms:.3f} ms, against bf16 "
          f"cosine {cos:.5f}", flush=True)
    require(ref.isfinite().all() and out.isfinite().all() and rel <= MMDIT_FP32_REL_L2,
            f"the bf16 MMDiT tracks the fp32 one (relative L2 <= {MMDIT_FP32_REL_L2})")
    require(cos > 0.95, "the W8A8 MMDiT tracks the bf16 one (cosine > 0.95)")
    return rel, cos, f_ms, q_ms


SYNTH_RECORDS = {
    "action_change": {"edit": "make the dog jump", "input": "a dog sitting on the grass",
                      "output": "a dog jumping over the grass", "edited object": "dog"},
    "implicit_change": {"edit": "what if the ice melted", "input": "an ice cube on a table",
                        "output": "a puddle of water on a table", "edited object": "puddle"},
    "textual_change": {"edit": "change the sign to CLOSED",
                       "input": 'a shop sign that says "OPEN"',
                       "output": 'a shop sign that says "CLOSED"'}}
# the pipelines' own knobs: MasaCtrl 50 steps, 3 P2P pairs of 20, Flux 4
SYNTH_STEPS = {"action_change": 50, "implicit_change": 3 * 20, "textual_change": 2 * 4}
SYNTH_PATHS = {"masactrl": ("action_change", "action_change record (MasaCtrl, 50 steps: the "
                            "SD1.5 UNet at batch 4; the SD VAE decode at batch 2)"),
               "implicit": ("implicit_change", "implicit_change record (3 P2P pairs of 20 "
                            "steps under the AttentionStore: the SD1.5 UNet at batch 4; the "
                            "SD VAE decode at batch 2)"),
               "flux": ("textual_change", "textual_change record (Flux-schnell, 2 x 4 "
                        "steps at batch 1; the Flux VAE decode at batch 1)"),
               "ocr": ("textual_change", "textual_change record with the GOT-OCR2 gate "
                       "(Flux-schnell, 2 x 4 steps at batch 1; the Flux VAE decode at "
                       "batch 1)")}


def check_synth_reference(dev):
    """The tiny pair synthesizers in bf16 on the card against the same in
    fp32 on the CPU, with the same weights (the Flux's modulations drawn
    live) and noise, each within twice the CPU's own bf16 distance:
    `consistent_synthesis` with the MasaCtrl swap active (step 1, site 1),
    `p2p_pair()` (frames and keyword mask), `flux_pair_fn()`, and one call
    of the W8A8 tiny Flux quantized from the same fp32 weights."""
    import torch
    from anyedit_tpu_torch.edits.action_change import consistent_synthesis
    from anyedit_tpu_torch.models.flux import Flux
    from anyedit_tpu_torch.ops.quant import quantize_state_dict
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()
    r = dataclasses.replace

    def cfg(dtype):
        return r(tiny, sd_unet=r(tiny.sd_unet, dtype=dtype),
                 ip2p_unet=r(tiny.ip2p_unet, dtype=dtype), vae=r(tiny.vae, dtype=dtype),
                 flux_vae=r(tiny.flux_vae, dtype=dtype), text=r(tiny.text, dtype=dtype),
                 flux_text=r(tiny.flux_text, dtype=dtype), flux=r(tiny.flux, dtype=dtype))

    def models(z):
        return (z._sd_core()[0], z._vae(), z._vae_named("flux_vae"),
                z._text_model("clip_text", z.cfg.text), z._cache["t5"], z._flux())

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    for z in zoos.values():
        z.masactrl_pair_fn(), z.p2p_pair(), z.flux_pair_fn()
    live_modulations_(zoos["ref"]._flux(), 7)
    for k in ("cpu16", "card16"):
        for src, dst in zip(models(zoos["ref"]), models(zoos[k])):
            dst.load_state_dict(src.state_dict())
    rng = np.random.default_rng(15)
    z0 = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    a, b = SYNTH_RECORDS["action_change"]["input"], SYNTH_RECORDS["action_change"]["output"]

    def masactrl(z):
        unet, ns = z._sd_core()
        text = z._text_encoder()
        with torch.inference_mode():
            lat = consistent_synthesis(
                lambda x, t, c, p, e: unet(x, t, c, processor=p, extra=e), ns,
                *(text(s).to(torch.bfloat16) for s in (a, b, "")), z0.to(z.device),
                num_steps=3, start_step=1, start_layer=1)
            return z._decode_u8(lat)

    outs = {k: {"masactrl": masactrl(z),
                "p2p": z.p2p_pair()(a, b, "dog", 0, steps=3, noise=z0),
                "flux": np.stack(z.flux_pair_fn()(a, b, 0, noise=z0))}
            for k, z in zoos.items()}

    def frames(o):
        return np.stack(o[:2]) if isinstance(o, tuple) else o
    for what in ("masactrl", "p2p", "flux"):
        ref = frames(outs["ref"][what]).astype(np.int32)
        err = {k: np.abs(frames(outs[k][what]).astype(np.int32) - ref)
               for k in ("cpu16", "card16")}
        line = ", ".join(f"{k} uint8 max diff {e.max()} mean {e.mean():.4f}"
                         for k, e in err.items())
        if what == "p2p":
            miss = {k: float((outs[k]["p2p"][2] != outs["ref"]["p2p"][2]).mean())
                    for k in ("cpu16", "card16")}
            line += f"; keyword mask differs on {miss['cpu16']:.4f} / {miss['card16']:.4f}"
            require(outs["card16"]["p2p"][2].dtype == np.bool_
                    and miss["card16"] <= 2 * max(miss["cpu16"], 0.02),
                    "the card's P2P keyword mask is within twice the CPU's bf16 distance")
        print(f"tiny {what} vs CPU fp32: {line}", flush=True)
        require(np.abs(ref[1] - ref[0]).mean() > 0.5, f"tiny {what}: the captions differ")
        require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
                and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
                f"the card's bf16 {what} is within twice the CPU's bf16 error")

    # 20 text tokens: `torch._int_mm` takes more than 16 rows
    float_sd = zoos["ref"]._flux().state_dict()
    g = np.random.default_rng(16)
    args = [torch.from_numpy(g.standard_normal(s).astype(np.float32))
            for s in ((1, 16, 16, 4), (1,), (1, 20, 32), (1, 32))]
    args[1] = args[1].abs() * 500
    vel = {}
    for k, dtype, where in (("ref", torch.float32, "cpu"), ("cpu16", torch.bfloat16, "cpu"),
                            ("card16", torch.bfloat16, dev)):
        q = Flux(r(tiny.flux, dtype=dtype, quant=True), device=where)
        q.load_state_dict(quantize_state_dict(Flux(r(tiny.flux, dtype=dtype, quant=True)),
                                              float_sd))
        with torch.inference_mode():
            vel[k] = q.eval()(*(x.to(where) for x in args)).float().cpu()
    rel = {k: float((vel[k] - vel["ref"]).norm() / vel["ref"].norm()) for k in ("cpu16", "card16")}
    print(f"tiny W8A8 Flux call vs CPU W8A8 fp32: relative L2 cpu16 {rel['cpu16']:.3e}, "
          f"card16 {rel['card16']:.3e}", flush=True)
    require(vel["card16"].isfinite().all() and rel["card16"] <= 2 * max(rel["cpu16"], 2 ** -8),
            "the card's W8A8 Flux is within twice the CPU's bf16 distance")


def synth_executor(tb, records, img, grounding_batch: int = 0):
    """`records` through `FactoryExecutor` with both gates open (no
    pre-filter), in one run: (ledger lines, seconds, K1 / K2 launches, K2's
    tally). A success's frames, visual input and mask are decoded into the
    line. Every count is set to 0 just before the run."""
    import torch
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor

    with tempfile.TemporaryDirectory() as root, gates_open():
        ex = FactoryExecutor(tb, ExecutorConfig(output_root=root, run_pre_filter=False,
                                                grounding_batch=grounding_batch))
        torch.cuda.synchronize()
        flash_nomax.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        with k2_tally() as tally:
            ex.run(records, lambda rec: img)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
        lines = [json.loads(x) for x in (Path(root) / "ledger.jsonl").read_text().splitlines()]
        for line in lines:
            pay = line["payload"]
            if line["status"] == "success":
                edited = decode_png(Path(pay["edited_file"]).read_bytes())
                source = (decode_png(Path(pay["input_file"]).read_bytes())
                          if "input_file" in pay else None)
                line["frames"] = (source, edited)
                for k in ("visual_input", "mask"):
                    if f"{k}_file" in pay:
                        line[k] = decode_png(Path(pay[f"{k}_file"]).read_bytes())
    return lines, seconds, launches, dict(tally)


def synth_record(dev, tb, edit_type: str, size: int):
    """One record of `edit_type` through `synth_executor`: success, both
    synthesized sides written as canvas-size PNGs that differ, K1 0, K2's
    launches all tallied. Returns (line, seconds, launches, tally, peak GiB)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord

    rec = InstructionRecord.from_json(dict(SYNTH_RECORDS[edit_type], edit_type=edit_type,
                                           id=edit_type))
    img = np.random.default_rng(17).integers(0, 256, GROUND_HW + (3,), np.uint8)
    torch.cuda.reset_peak_memory_stats()
    (line,), seconds, launches, tally = synth_executor(tb, [rec], img)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(line["status"] == "success" and "frames" in line,
            f"the {edit_type} record succeeded through the executor ({line})")
    src, out = line["frames"]
    require(src.shape == out.shape == (size, size, 3)
            and np.abs(src.astype(np.int32) - out).mean() > 0.5,
            f"{edit_type}: both sides are {size} px frames and they differ")
    require(launches["flash_nomax"] == 0, f"{edit_type} launched K1 {launches['flash_nomax']} "
            "times, want 0 (every site takes sdpa)")
    require(launches["group_norm"] > 0 and sum(tally.values()) == launches["group_norm"],
            f"{edit_type}: K2 launched ({launches['group_norm']}) and every launch tallied")
    print(f"{edit_type} record through FactoryExecutor (gates open): {seconds:.3f} s "
          f"({SYNTH_STEPS[edit_type]} denoiser calls); peak {peak:.2f} GiB allocated; "
          f"launches {launches}; K2 at {len(tally)} shapes", flush=True)
    return line, seconds, launches, tally, peak


def masactrl_p2p(dev, szoo, tb):
    """One action_change and one implicit_change record through
    `FactoryExecutor` on the full-width pair slots (SD15_UNET, SD VAE,
    CLIP-L), then one 20-step `p2p_pair()` call: its keyword mask is a
    non-empty canvas-size bool array. Returns ({path: (launches, tally)},
    numbers)."""
    import torch

    size = szoo.cfg.canvas.edit_size
    out, nums = {}, {}
    for path in ("masactrl", "implicit"):
        et = SYNTH_PATHS[path][0]
        _, sec, launches, tally, peak = synth_record(dev, tb, et, size)
        out[path] = (launches, tally)
        nums[et] = {"record_s": sec, "peak_gib": peak}
    rec = SYNTH_RECORDS["implicit_change"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ori, tar, mask = tb.extra["p2p_pair"](rec["input"], rec["output"], "puddle", 5)
    torch.cuda.synchronize()
    nums["p2p_pair_s"] = time.perf_counter() - t0
    require(mask.dtype == np.bool_ and mask.shape == (size, size) and mask.any(),
            f"the P2P keyword mask is a non-empty {size} x {size} bool array "
            f"({mask.dtype}, {mask.shape}, {mask.mean():.4f} set)")
    require(ori.shape == tar.shape == (size, size, 3), "the P2P pair is two canvas frames")
    print(f"p2p_pair (20 steps): {nums['p2p_pair_s']:.3f} s; keyword mask "
          f"{mask.mean() * 100:.2f} % of the canvas", flush=True)
    return out, nums


def flux_bound_ms(m, batch: int, n_txt: int, n_img: int) -> tuple[float, str, float]:
    """(bound ms, "operations" or "bytes", TFLOP) of one Flux call, counted
    per stream as `mmdit_bound_ms`: each token through its stream's q, k, v,
    out and FFN Linears in a double block (12 d^2 MACs) and through
    linear1 / linear2 in a single block (7 d^2 + 5 d^2), the joint
    attention's QK^T and PV (2 L^2 d MACs a block), the patch, context and
    output projections, and the per-row modulations (double 12 d^2, single
    3 d^2, final 2 d^2) and embeddings, at 989 TFLOP/s (bf16 dense); against
    the parameters (bf16 and fp32) read once and the inputs and output moved
    once at 3.35 TB/s."""
    c = m.cfg
    d, length = c.dim, n_txt + n_img
    macs = (c.double_depth + c.single_depth) * (12 * length * d * d + 2 * length ** 2 * d)
    macs += (2 * c.patch ** 2 * c.in_channels * n_img + c.context_dim * n_txt) * d
    rows = (12 * c.double_depth + 3 * c.single_depth + 2 + 2 + 2 * c.guidance_embed) * d * d
    rows += (256 * (1 + c.guidance_embed) + c.pooled_dim) * d
    flop = 2.0 * batch * (macs + rows)
    moved = sum(p.numel() * p.element_size() for p in m.parameters()) + batch * 4 * (
        2 * n_img * c.patch ** 2 * c.in_channels + n_txt * c.context_dim + c.pooled_dim)
    ops_ms, bytes_ms = flop / 989e12 * 1e3, moved / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flop / 1e12


def flux_phase(dev, szoo, tb):
    """One textual_change record through `FactoryExecutor` on the
    full-width Flux slot (FLUX_SCHNELL, T5-XXL, CLIP-L, the Flux VAE; its
    modulations drawn live, `live_modulations_` seed 9, since at the seeded
    init, as in the JAX package, the captions do not reach the image), then
    the three synthesized types in one chunk (`grounding_batch=3`): every
    record a success, K1 0. Then one Flux call at batch 1 (77 text + 1,024
    image tokens; CUDA events) beside `flux_bound_ms`; the W8A8 check keeps
    its output. Returns ((launches, tally), numbers, args, bf16 velocity)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    c = szoo.cfg
    size = c.canvas.edit_size
    flux = live_modulations_(szoo._flux(), 9)
    line, sec, launches, tally, peak = synth_record(dev, tb, "textual_change", size)
    nums = {"record_s": sec, "peak_gib": peak}

    recs = [InstructionRecord.from_json(dict(SYNTH_RECORDS[et], edit_type=et, id=et))
            for et in SYNTH_RECORDS]
    img = np.random.default_rng(17).integers(0, 256, GROUND_HW + (3,), np.uint8)
    lines, chunk_s, chunk_launches, _ = synth_executor(tb, recs, img, grounding_batch=3)
    require([x["status"] for x in lines] == ["success"] * 3
            and chunk_launches["flash_nomax"] == 0,
            f"the chunk of three synthesized records: {[x['status'] for x in lines]}, "
            f"launches {chunk_launches}")
    print(f"chunk of 3 (action_change, implicit_change, textual_change; grounding_batch=3): "
          f"{chunk_s:.3f} s, every record a success; launches {chunk_launches}", flush=True)
    nums["chunk_s"] = chunk_s

    hw = size // c.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, hw, hw, c.flux.in_channels, generator=g, device=dev)
    t = torch.full((1,), 500.0, device=dev)
    text = SYNTH_RECORDS["textual_change"]["output"]
    with torch.inference_mode():
        ctx = szoo._t5()(text).to(torch.bfloat16)
        _, pooled, _ = szoo._text_raw("clip_text", c.text)(text)
        args = (x, t, ctx, pooled)
        out = flux(*args).float()
        flux_ms = time_ms(lambda: flux(*args), iters=5)
    bound_ms, bound_by, tflop = flux_bound_ms(flux, 1, ctx.shape[1], (hw // c.flux.patch) ** 2)
    require(out.isfinite().all() and out.shape == x.shape, "the Flux velocity is finite")
    nums.update(flux_ms=flux_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflop=tflop, resident_gib=torch.cuda.memory_allocated() / 2 ** 30)
    print(f"Flux call at batch 1 ({ctx.shape[1]} text + {(hw // c.flux.patch) ** 2} image "
          f"tokens): {flux_ms:.3f} ms against a bound "
          f"of {bound_ms:.3f} ms ({bound_by}: {tflop:.3f} TFLOP); textual_change record "
          f"{sec:.3f} s, peak {peak:.2f} GiB", flush=True)
    return (launches, tally), nums, args, out


def flux_w8a8(dev, args, out):
    """The W8A8 Flux (`quant_diffusion`, quantized from the fp32 seeded init
    on a zoo of its own, the same live modulations) on the timed args
    against the bf16 call's output: cosine > 0.95. Returns (cosine, ms,
    peak GiB of the build and call)."""
    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qzoo = ModelZoo(ZooConfig(quant_diffusion=True), dev, seed=0)
    qm = live_modulations_(qzoo._flux(), 9)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.inference_mode():
        cos = cosine(qm(*args), out)
        q_ms = time_ms(lambda: qm(*args), iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del qm, qzoo
    gc.collect()
    torch.cuda.empty_cache()
    print(f"W8A8 Flux (built in {build_s:.2f} s, peak {peak:.2f} GiB): call at batch 1 "
          f"{q_ms:.3f} ms, against bf16 cosine {cos:.5f}", flush=True)
    require(cos > 0.95, "the W8A8 Flux tracks the bf16 one (cosine > 0.95)")
    return cos, q_ms, peak


def synth_k2_rows(dev, tallies: dict) -> list:
    """K2 at every (shape, SiLU) the synthesized paths launched it (bf16
    only), held against its plain version with `check_kernels`' bounds:
    [(tag, row, first path, {path: launches at the shape}, (shape, silu))]."""
    from anyedit_tpu_torch.ops import kernel_check as kc

    by_shape: dict = {}
    for path, tally in tallies.items():
        for (shape, silu, dtype), n in tally.items():
            require(dtype == "torch.bfloat16", f"the {path} path launched K2 in {dtype}")
            by_shape.setdefault((shape, silu), {})[path] = n
    rows = []
    for (shape, silu), per_path in sorted(by_shape.items()):
        tag = f"{shape} {'silu' if silu else 'plain'}"
        r = kc.check_group_norm(shape, silu, dev, iters=5 if np.prod(shape) >= 2 ** 24 else 10)
        report_k2(tag, r)
        rows.append((tag, r, next(iter(per_path)), per_path, (shape, silu)))
    return rows

# ---- the SDXL refine stack -------------------------------------------------------
# implicit_change's stage slots, called per record: 3 candidates x (2
# inpaints, 1 img2img, 1 consistency pass)
SDXL_STAGE_CALLS = {"sdxl_inpaint": 6, "sdxl_img2img": 3, "canny_consistency": 3}
# K1 at (20, 1024, 64): the SDXL UNet launches it at its 10 level-1
# self-attention sites (10 heads of 64 over 32 x 32 latents at batch 2) and
# the ControlNet at its 4; under the IP-Adapter processor the UNet takes sdpa.
# A candidate: 2 inpaints of round(30 x 0.98) = 29 UNet calls, an img2img of
# 15, a consistency pass of 18 ControlNet calls.
SDXL_IMPLICIT_K1 = 3 * ((2 * 29 + 15) * 10 + 18 * 4)     # 2,406
SDXL_MATERIAL_K1 = round(30 * 0.9) * 4                     # 108: the ControlNet's
MATERIAL_RECORD = {"edit": "make the car out of brushed copper", "edited object": "car",
                   "input": "a car parked on a street",
                   "output": "a brushed copper car parked on a street",
                   "visual_input": "copper.png"}
SDXL_PATHS = {"sdxl_implicit": ("implicit_change", "implicit_change record with all four "
                                "stages (the SDXL UNet and the ControlNet at batch 2, the "
                                "SDXL VAE at 512 px)"),
              "sdxl_material": ("material_transfer", "material_transfer record (the SDXL "
                                "UNet and the depth ControlNet at batch 2, the SDXL VAE at "
                                "batch 1, one grounding)")}


def live_zero_convs_(cn, seed: int):
    """Draw a ControlNet's zero convs and hint projection (zero at the
    seeded init, as in the JAX package, where an untrained ControlNet is an
    exact no-op) from N(0, 1/fan_in), seeded, in place, on the weights'
    device, so that its residuals reach the UNet."""
    import torch
    gen = None
    with torch.no_grad():
        for name, mod in cn.named_modules():
            if name.startswith("controlnet_down_blocks.") or name in (
                    "controlnet_mid_block", "controlnet_cond_embedding.conv_out"):
                w = mod.weight
                gen = gen or torch.Generator(device=w.device).manual_seed(seed)
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                        / w[0].numel() ** 0.5)
    return cn


def check_sdxl_reference(dev):
    """The tiny refine slots in bf16 on the card against fp32 on the CPU,
    with the same weights (the ControlNets' zero convs drawn live) and
    noise: `img2img_fn()`, `sdxl_inpaint_fn()`, `canny_consistency_fn()`
    (masked, the IP-Adapter on an exemplar), `sdxl_material_fn()` and
    `depth_fn()`, each within twice the CPU's own bf16 distance."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()
    r = dataclasses.replace

    def cfg(dtype):
        d = tiny.depth_cfg
        return r(tiny, refine_unet=r(tiny.refine_unet, dtype=dtype),
                 sdxl_vae=r(tiny.sdxl_vae, dtype=dtype), text=r(tiny.text, dtype=dtype),
                 text_g=r(tiny.text_g, dtype=dtype), vision=r(tiny.vision, dtype=dtype),
                 depth_cfg=r(d, dtype=dtype, backbone=r(d.backbone, dtype=dtype)))

    def models(z):
        return (z._refine_unet()[0], z._vae_named("sdxl_vae"),
                z._text_model("clip_text", z.cfg.text), z._text_model("clip_text_g", z.cfg.text_g),
                z._vision("clip_vision", z.cfg.vision), z._text_proj(),
                z._control_unet("controlnet_canny"), z._control_unet("controlnet_depth"),
                *z._ip_modules(), z._depth_model())

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    for i, slot in enumerate(("controlnet_canny", "controlnet_depth")):
        live_zero_convs_(zoos["ref"]._control_unet(slot), 20 + i)
    for k in ("cpu16", "card16"):
        for src, dst in zip(models(zoos["ref"]), models(zoos[k])):
            dst.load_state_dict(src.state_dict())
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    exemplar = rng.integers(0, 256, (40, 40, 3), np.uint8)
    mask = np.zeros((48, 40), bool)
    mask[8:40, 6:30] = True
    noise = [torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
             for _ in range(2)]
    depth_u8 = rng.integers(0, 256, (48, 40), np.uint8)
    prompt = "a marble statue in a garden"

    def run(z):
        return {"img2img": z.img2img_fn()(img, prompt, 0.5, 0, steps=4, noise=noise[0]),
                "sdxl_inpaint": z.sdxl_inpaint_fn()(img, mask, prompt, 1, steps=4,
                                                    noise=noise[0], renoise=noise[1]),
                "canny_consistency": z.canny_consistency_fn()(
                    img, prompt, 2, steps=4, ref_image=exemplar, mask01=mask, noise=noise[0],
                    renoise=noise[1]),
                "sdxl_material": z.sdxl_material_fn()(img, mask, depth_u8, exemplar, steps=4,
                                                      noise=noise[0]),
                "depth": z.depth_fn()(img)}
    outs = {k: run(z) for k, z in zoos.items()}
    for what, ref in outs["ref"].items():
        ref = ref.astype(np.int32)
        err = {k: np.abs(outs[k][what].astype(np.int32) - ref) for k in ("cpu16", "card16")}
        print(f"tiny {what} vs CPU fp32: " + ", ".join(
            f"{k} uint8 max diff {e.max()} mean {e.mean():.4f}" for k, e in err.items()),
            flush=True)
        require(outs["card16"][what].shape == ref.shape, f"tiny {what}: the frame's shape")
        require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
                and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
                f"the card's bf16 {what} is within twice the CPU's bf16 error")
    require(np.abs(outs["ref"]["img2img"].astype(np.int32) - img).mean() > 1.0,
            "tiny img2img changes the image")


def sdxl_bound_ms(modules, call, ip_tokens: int = 0) -> tuple[float, str, float]:
    """(bound ms, "operations" or "bytes", TFLOP) of one `call()` through
    `modules` (the SDXL UNet, and its ControlNet), counted from the code's
    operations as it runs them: forward hooks sum the MACs of every Conv2d
    (out elements x in channels x kernel area) and Linear (out elements x in
    features), and each MultiHeadAttention's QK^T and PV (2 Lq Lkv x its
    inner width; at a cross site under the IP-Adapter processor also Lq x
    `ip_tokens` twice); at 989 TFLOP/s (bf16 dense). Bytes: the modules'
    parameters read once at 3.35 TB/s (activations, norms and elementwise
    work not counted)."""
    import torch
    from anyedit_tpu_torch.models.layers import MultiHeadAttention

    macs = [0]

    def conv(m, inp, out):
        macs[0] += out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]

    def linear(m, inp, out):
        macs[0] += out.numel() * m.in_features

    def attn(m, inp, out):
        x, context, processor = inp[0], inp[1], inp[2]
        b, lq = x.shape[:2]
        inner = m.meta.num_heads * m.meta.head_dim
        lkv = lq if context is None else context.shape[1]
        macs[0] += 2 * b * lq * lkv * inner
        if processor is not None and ip_tokens and not m.meta.is_self:
            macs[0] += 2 * b * lq * ip_tokens * inner
    hooks = []
    for mod in modules:
        for sub in mod.modules():
            fn = (conv if isinstance(sub, torch.nn.Conv2d) else
                  linear if isinstance(sub, torch.nn.Linear) else
                  attn if isinstance(sub, MultiHeadAttention) else None)
            if fn is not None:
                hooks.append(sub.register_forward_hook(fn))
    try:
        with torch.inference_mode():
            call()
    finally:
        for h in hooks:
            h.remove()
    flop = 2.0 * macs[0]
    moved = sum(p.numel() * p.element_size() for m in modules for p in m.parameters())
    ops_ms, bytes_ms = flop / 989e12 * 1e3, moved / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", flop / 1e12


def sdxl_record(dev, tb, edit_type: str, fields: dict, k1_want: int, size):
    """One record through `synth_executor` (gates open): success, the edit a
    (size, 3) uint8 frame, K1 exactly `k1_want`, every K2 launch tallied.
    Returns (line, seconds, launches, tally)."""
    from anyedit_tpu_torch.core.schema import InstructionRecord

    rec = InstructionRecord.from_json(dict(fields, edit_type=edit_type, id=edit_type))
    img = np.random.default_rng(23).integers(0, 256, GROUND_HW + (3,), np.uint8)
    (line,), seconds, launches, tally = synth_executor(tb, [rec], img)
    require(line["status"] == "success" and "frames" in line,
            f"the {edit_type} record succeeded through the executor ({line})")
    require(line["frames"][1].shape == tuple(size) + (3,), f"{edit_type}: a {size} frame")
    require(launches["flash_nomax"] == k1_want,
            f"{edit_type} launched K1 {launches['flash_nomax']} times, want {k1_want}")
    require(launches["group_norm"] > 0 and sum(tally.values()) == launches["group_norm"],
            f"{edit_type}: K2 launched ({launches['group_norm']}) and every launch tallied")
    print(f"{edit_type} record through FactoryExecutor (gates open): {seconds:.3f} s; "
          f"launches {launches}; K2 at {len(tally)} shapes", flush=True)
    return line, seconds, launches, tally


def sdxl_toolbox(dev):
    """The refine stack at published widths on the production `ZooConfig`
    (box_threshold 0.0, so that the random detector keeps boxes), seeded:
    the grounder and the slots of implicit_change and material_transfer,
    the two ControlNets' zero convs drawn live, and a seeded 512 px
    exemplar behind `tb.extra["load_visual"]`. Returns (zoo, tb, exemplar)."""
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    tb = Toolbox(ground=zoo.grounder())
    for slot in ("p2p_pair", "sdxl_inpaint", "sdxl_img2img", "canny_consistency", "clip",
                 "sdxl_material", "depth"):
        zoo.install(tb, slot)
    for i, slot in enumerate(("controlnet_canny", "controlnet_depth")):
        live_zero_convs_(zoo._control_unet(slot), 30 + i)
    exemplar = np.random.default_rng(24).integers(0, 256, (512, 512, 3), np.uint8)
    tb.extra["load_visual"] = lambda rec: exemplar
    return zoo, tb, exemplar


def sdxl_unet_inputs(zoo, exemplar, dev):
    """One refine call's inputs at batch 2 (CFG): seeded latents at the
    canvas' latent size, t = 500, the [cond, uncond] SDXL conditioning of
    the implicit_change record's target caption; and the canny hint and the
    IP-Adapter processor of the exemplar. Returns ((x, t, ctx2, pooled2,
    tid2), hint2, processor)."""
    import torch

    hw = zoo.cfg.canvas.edit_size // zoo.cfg.canvas.latent_down
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn(2, hw, hw, 4, generator=g, device=dev)
    t = torch.full((2,), 500, device=dev)
    with torch.inference_mode():
        ctx2, pooled2, tid2 = zoo._xl_cond(SYNTH_RECORDS["implicit_change"]["output"])
        return ((x, t, ctx2, pooled2, tid2), zoo._hint2(zoo.canny_fn(exemplar)),
                zoo._ip_processor(exemplar))


def sdxl_phase(dev):
    """On `sdxl_toolbox`: one implicit_change record with all four stages
    installed (each stage slot called as often as SDXL_STAGE_CALLS says,
    K1 SDXL_IMPLICIT_K1) and one 480x640 material_transfer record (K1
    SDXL_MATERIAL_K1) through `FactoryExecutor`; then the SDXL UNet call at
    batch 2, plain and with the canny ControlNet plus the IP-Adapter, in ms
    (CUDA events) beside `sdxl_bound_ms`, and the run's peak GiB. Returns
    ({path: (launches, tally)}, numbers, the UNet inputs, the plain call's
    output)."""
    import collections

    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zoo, tb, exemplar = sdxl_toolbox(dev)
    calls = collections.Counter()
    for name in SDXL_STAGE_CALLS:
        def counted(*a, _fn=tb.extra[name], _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        tb.extra[name] = counted
    torch.cuda.synchronize()
    nums = {"build_s": time.perf_counter() - t0}
    size = zoo.cfg.canvas.edit_size

    paths = {}
    line, sec, launches, tally = sdxl_record(dev, tb, "implicit_change",
                                             SYNTH_RECORDS["implicit_change"],
                                             SDXL_IMPLICIT_K1, (size, size))
    require(dict(calls) == SDXL_STAGE_CALLS,
            f"implicit_change called its stages {dict(calls)}, want {SDXL_STAGE_CALLS}")
    paths["sdxl_implicit"] = (launches, tally)
    nums["implicit_s"] = sec
    line, sec, launches, tally = sdxl_record(dev, tb, "material_transfer", MATERIAL_RECORD,
                                             SDXL_MATERIAL_K1, GROUND_HW)
    paths["sdxl_material"] = (launches, tally)
    nums["material_s"] = sec

    unet, _ = zoo._refine_unet()
    cn = zoo._control_unet("controlnet_canny")
    args, hint2, proc = sdxl_unet_inputs(zoo, exemplar, dev)
    x, t, ctx2, pooled2, tid2 = args
    full = zoo._refine_eps(unet, pooled2, tid2, cn, hint2, proc)
    with torch.inference_mode():
        out = unet(x, t, ctx2, pooled_text=pooled2, time_ids=tid2)
        require(out.isfinite().all() and out.shape == x.shape, "the SDXL UNet's output is finite")
        nums["unet_ms"] = time_ms(lambda: unet(x, t, ctx2, pooled_text=pooled2,
                                               time_ids=tid2), iters=5)
        nums["unet_cn_ip_ms"] = time_ms(lambda: full(x, t, ctx2), iters=5)
    nums["bound_ms"], nums["bound_by"], nums["tflop"] = sdxl_bound_ms(
        [unet], lambda: unet(x, t, ctx2, pooled_text=pooled2, time_ids=tid2))
    nums["cn_ip_bound_ms"], nums["cn_ip_bound_by"], nums["cn_ip_tflop"] = sdxl_bound_ms(
        [unet, cn], lambda: full(x, t, ctx2), ip_tokens=4)
    nums["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"SDXL UNet call at batch 2 ({x.shape[1]} x {x.shape[2]} latents): "
          f"{nums['unet_ms']:.3f} ms against a bound of {nums['bound_ms']:.3f} ms "
          f"({nums['bound_by']}: {nums['tflop']:.3f} TFLOP); with the canny ControlNet and the "
          f"IP-Adapter {nums['unet_cn_ip_ms']:.3f} ms (bound {nums['cn_ip_bound_ms']:.3f} ms, "
          f"{nums['cn_ip_tflop']:.3f} TFLOP); build {nums['build_s']:.2f} s, peak "
          f"{nums['peak_gib']:.2f} GiB", flush=True)
    del tb, zoo, full, proc, unet, cn
    return paths, nums, args, out


def sdxl_w8a8(dev, args, out):
    """The W8A8 refine UNet (`quant_diffusion`, quantized from the fp32
    seeded init on a zoo of its own) on the timed inputs against the bf16
    call's output: cosine > 0.95. Returns (cosine, ms)."""
    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    qzoo = ModelZoo(ZooConfig(quant_diffusion=True), dev, seed=0)
    qunet, _ = qzoo._refine_unet()
    x, t, ctx2, pooled2, tid2 = args
    with torch.inference_mode():
        cos = cosine(qunet(x, t, ctx2, pooled_text=pooled2, time_ids=tid2), out)
        q_ms = time_ms(lambda: qunet(x, t, ctx2, pooled_text=pooled2, time_ids=tid2), iters=3)
    del qunet, qzoo
    gc.collect()
    torch.cuda.empty_cache()
    print(f"W8A8 SDXL UNet call at batch 2: {q_ms:.3f} ms, against bf16 cosine {cos:.5f}",
          flush=True)
    require(cos > 0.95, "the W8A8 refine UNet tracks the bf16 one (cosine > 0.95)")
    return cos, q_ms


def new_k2_rows(dev, tallies: dict, held: set) -> tuple[list, dict]:
    """K2 at every (shape, SiLU) the paths of `tallies` launched it that no
    row in `held` holds yet, with `check_kernels`' bounds, as
    `synth_k2_rows`; and {(shape, silu): {path: launches}} for the shapes
    already held, whose rows gain the launches."""
    fresh, seen = {}, {}
    for path, tally in tallies.items():
        for (shape, silu, dtype), n in tally.items():
            require(dtype == "torch.bfloat16", f"the {path} path launched K2 in {dtype}")
            dst = seen if (shape, silu) in held else fresh
            dst.setdefault((shape, silu), {})[path] = n
    return synth_k2_rows(dev, {p: {(s, silu, "torch.bfloat16"): n
                                   for (s, silu), per in fresh.items()
                                   for q, n in per.items() if q == p}
                               for p in tallies}), seen


# ---- the visual conditions, rotation, composition and AnyDoor ------------------
VC_TYPES = ("visual_bbox", "visual_depth", "visual_scribble", "visual_segment",
            "visual_sketch")
VISUAL_TYPES = VC_TYPES + ("rotation_change", "composition", "visual_reference")
VISUAL_RECORD = {"edit": "put the teddy bear on the chair", "edited object": "chair",
                 "ref_object": "teddy bear", "input": "a chair in a room",
                 "output": "a teddy bear on a chair in a room", "visual_input": "bear.png"}
COMPOSITION_PLAN = ("global: a sunny park with a pond and tall trees\n"
                    "region: 0.0,0.3,0.45,1.0 | a brown dog sitting on the grass\n"
                    "region: 0.55,0.0,1.0,0.4 | a red kite in the blue sky\n"
                    "region: 0.5,0.55,0.95,0.95 | a wooden bench")
# the drawn objects (xyxy) of the 480x640 target and the 512 px reference
VISUAL_BOXES = {"target": (220, 150, 420, 380), "reference": (96, 120, 400, 440)}
# K1 in one AnyDoor record: 50 steps x (the UNet's 5 + the ControlNet's 2
# self-attention sites) at each of (10, 4096, 64) and (20, 1024, 64) (5 and
# 10 heads of 64 at CFG batch 2); the VAE's 512-wide mid attention and
# DINOv2's 257 tokens are off K1's route
ANYDOOR_K1 = {(10, 4096, 64): 50 * 7, (20, 1024, 64): 50 * 7}
VISUAL_PATHS = {"visual_condition": "the five visual_* condition records (HED, UperNet on "
                                    "Swin-T, Depth-Anything-V2, Canny, one grounding)",
                "rotation": "rotation_change record (numpy only)",
                "composition": "composition record (regional cross-attention, 50 steps: the "
                               "SD1.5 UNet at batch 2; the SD VAE decode at batch 1)",
                "anydoor": "visual_reference record (AnyDoor, 50 steps: the SD2.1-class UNet "
                           "and its ControlNet at batch 2, 5 heads of 64 over 4,096 tokens; "
                           "the SD VAE decode at batch 1)"}


def new_k1_rows(dev, tallies: dict, held: set) -> list:
    """K1 at every (BH, L, D) the paths of `tallies` ({path: {shape:
    launches}}) launched it that `held` does not hold, against its plain
    version with `check_kernels`' bounds: [(tag, row, first path, {path:
    launches at the shape}, shape)]."""
    from anyedit_tpu_torch.ops import kernel_check as kc

    by_shape: dict = {}
    for path, tally in tallies.items():
        for shape, n in tally.items():
            if shape not in held:
                by_shape.setdefault(shape, {})[path] = n
    rows = []
    for shape, per_path in sorted(by_shape.items()):
        r = kc.check_flash_nomax(*shape, dev)
        report_k1(str(shape), r)
        rows.append((str(shape), r, next(iter(per_path)), per_path, shape))
    return rows


@contextlib.contextmanager
def k1_tally():
    """K1's launches inside the block by (BH, L, D): `attention` reaches K1
    through the module's `flash_nomax`, which is wrapped for the block."""
    import collections
    from anyedit_tpu_torch.ops import attention as attn_mod

    real = attn_mod.flash_nomax
    tally = collections.Counter()

    class Spy:
        """Calls K1's wrapper; its `launches` is the wrapper's own."""

        def __call__(self, q, k, v, scale):
            n0 = real.launches
            out = real(q, k, v, scale)
            if real.launches > n0:
                tally[tuple(q.shape)] += 1
            return out

        launches = property(lambda self: real.launches,
                            lambda self, n: setattr(real, "launches", n))
    attn_mod.flash_nomax = Spy()
    try:
        yield tally
    finally:
        attn_mod.flash_nomax = real


def device_busy_ms(fn) -> float:
    """Device milliseconds of one `fn()` under `torch.profiler` recording the
    device's events only (kernels, copies, sets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if e.device_type == DeviceType.CUDA and t > 0:
            us += t
    return us / 1e3


def check_visual_reference(dev):
    """The tiny visual slots in bf16 on the card against fp32 on the CPU,
    beside the CPU's own bf16, with the same weights (the AnyDoor ControlNet's
    zero convs drawn live) and noise: `hed_fn()` (fp32 on every side: within
    1e-3), `seg_fn()` (the rendered map differs on at most twice the CPU
    bf16's share, at least 2 %), one `composition_fn()` and one `anydoor()`
    call (within twice the CPU's own bf16 distance)."""
    import torch
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config

    tiny = tiny_zoo_config()
    r = dataclasses.replace

    def cfg(dtype):
        return r(tiny, sd_unet=r(tiny.sd_unet, dtype=dtype), vae=r(tiny.vae, dtype=dtype),
                 text=r(tiny.text, dtype=dtype), anydoor_unet=r(tiny.anydoor_unet, dtype=dtype),
                 dino_cfg=r(tiny.dino_cfg, dtype=dtype),
                 seg_cfg=r(tiny.seg_cfg, dtype=dtype,
                           backbone=r(tiny.seg_cfg.backbone, dtype=dtype)))

    def models(z):
        z.hed_fn(), z.seg_fn()
        return (z._sd_core()[0], z._vae(), z._text_model("clip_text", z.cfg.text),
                *z._anydoor_core()[:3], z._dino(), z._cache["hed_model"], z._cache["seg_model"])

    zoos = {"ref": ModelZoo(cfg(torch.float32), "cpu", seed=0),
            "cpu16": ModelZoo(cfg(torch.bfloat16), "cpu", seed=0),
            "card16": ModelZoo(cfg(torch.bfloat16), dev, seed=0)}
    live_zero_convs_(zoos["ref"]._anydoor_core()[1], 41)
    for k in ("cpu16", "card16"):
        for src, dst in zip(models(zoos["ref"]), models(zoos[k])):
            dst.load_state_dict(src.state_dict())
    rng = np.random.default_rng(27)
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    ref_img = rng.integers(0, 256, (40, 44, 3), np.uint8)
    mask = np.zeros((48, 40), bool)
    mask[10:34, 8:30] = True
    hf = rng.uniform(0, 300, (48, 40)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    plan = COMPOSITION_PLAN

    outs = {k: {"hed": z.hed_fn()(img), "seg": z.seg_fn()(img),
                "composition": z.composition_fn()(plan, 0, steps=4, noise=noise),
                "anydoor": z.anydoor()(img, mask, img, hf, ref_img, steps=4, noise=noise)}
            for k, z in zoos.items()}
    hed_err = float(np.abs(outs["card16"]["hed"] - outs["ref"]["hed"]).max())
    miss = {k: float((outs[k]["seg"] != outs["ref"]["seg"]).any(-1).mean())
            for k in ("cpu16", "card16")}
    print(f"tiny hed vs CPU fp32: card max {hed_err:.3e}; tiny seg map differs on "
          f"{miss['cpu16']:.4f} (cpu16) / {miss['card16']:.4f} (card16)", flush=True)
    require(hed_err <= 1e-3, "the card's HED is within 1e-3 of the CPU's")
    require(miss["card16"] <= 2 * max(miss["cpu16"], 0.02),
            "the card's segmentation map is within twice the CPU's bf16 distance")
    for what in ("composition", "anydoor"):
        ref = outs["ref"][what].astype(np.int32)
        err = {k: np.abs(outs[k][what].astype(np.int32) - ref) for k in ("cpu16", "card16")}
        print(f"tiny {what} vs CPU fp32: " + ", ".join(
            f"{k} uint8 max diff {e.max()} mean {e.mean():.4f}" for k, e in err.items()),
            flush=True)
        require(outs["card16"][what].shape == ref.shape, f"tiny {what}: the frame's shape")
        require(err["card16"].max() <= 2 * max(err["cpu16"].max(), 1)
                and err["card16"].mean() <= 2 * max(err["cpu16"].mean(), 0.5),
                f"the card's bf16 {what} is within twice the CPU's bf16 error")
    require(np.abs(outs["ref"]["anydoor"].astype(np.int32) - img)[mask].mean() > 1.0
            and (outs["card16"]["anydoor"][~mask] == img[~mask]).all(),
            "tiny anydoor changes the masked region and keeps the rest")


def visual_toolbox(dev):
    """The visual slots at published widths on the production `ZooConfig`
    (box_threshold 0.0), seeded: the grounder, HED, UperNet on Swin-T,
    Depth-Anything-V2, Canny, the composition slot (SD15_UNET, the SD VAE,
    CLIP-L) and AnyDoor (SD21_ANYDOOR_UNET, its ControlNet with live zero
    convs, DINOV2_G at 224 px, the projection). The grounder's answer on the
    target and on the reference is replaced by a synthetic detection of the
    drawn object (the real grounding still runs), an interior mask, so that
    the completeness gate passes. A seeded 512 px reference behind
    `tb.extra["load_visual"]`, and a `load_rotation_pair` of two seeded
    frames 30 degrees of yaw apart. Returns (zoo, tb, target image)."""
    import torch
    from anyedit_tpu_torch.edits.types import Toolbox
    from anyedit_tpu_torch.grounding.maskgen import MAX_BOXES, grounding_result
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig

    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    g = np.random.default_rng(28)
    img = g.integers(0, 256, GROUND_HW + (3,), np.uint8)
    ref = g.integers(0, 256, (512, 512, 3), np.uint8)
    for im, (x1, y1, x2, y2), colour in ((img, VISUAL_BOXES["target"], (150, 90, 40)),
                                         (ref, VISUAL_BOXES["reference"], (180, 120, 60))):
        im[y1:y2, x1:x2] = colour
    boxes = {id(img): VISUAL_BOXES["target"], id(ref): VISUAL_BOXES["reference"]}
    real = zoo.grounder()

    def ground(image, phrase, mode="merge", count_k=None):
        out = real(image, phrase, mode=mode, count_k=count_k)
        if id(image) not in boxes:
            return out
        h, w = image.shape[:2]
        x1, y1, x2, y2 = boxes[id(image)]
        masks = torch.full((MAX_BOXES, h, w), -1.0, device=dev)
        masks[0, y1:y2, x1:x2] = 1.0
        bx = torch.zeros((MAX_BOXES, 4), device=dev)
        bx[0] = torch.tensor([x1, y1, x2, y2], dtype=torch.float32)
        scores = torch.zeros((MAX_BOXES,), device=dev)
        valid = torch.zeros((MAX_BOXES,), dtype=torch.bool, device=dev)
        scores[0], valid[0] = 0.9, True
        return grounding_result(masks, bx, scores, valid, (h, w), mode, count_k)

    tb = Toolbox(ground=ground)
    for slot in ("hed", "seg", "depth", "canny", "composition", "anydoor"):
        zoo.install(tb, slot)
    live_zero_convs_(zoo._anydoor_core()[1], 42)
    yaw = [np.array([np.cos(a / 2), 0.0, np.sin(a / 2), 0.0]) for a in (0.0, np.radians(30))]
    frames = g.integers(0, 256, (2,) + GROUND_HW + (3,), np.uint8)
    tb.extra["load_visual"] = lambda rec: ref
    tb.extra["load_rotation_pair"] = lambda rec: (frames[0], frames[1], yaw[0], yaw[1])
    return zoo, tb, img


def visual_record(dev, tb, img, edit_type: str, size: int):
    """One record of `edit_type` through `synth_executor` (gates open), K1
    tallied by shape, then the same record once more under the profiler
    (device events only) for its device-busy share of the record's seconds.
    Checks the outcome. Returns a dict of the numbers, the launches and the
    K1 / K2 tallies."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.edits.registry import get_pipeline

    fields = dict(VISUAL_RECORD, edit_type=edit_type, id=edit_type)
    if edit_type == "composition":
        fields["canvas_plan"] = COMPOSITION_PLAN
    rec = InstructionRecord.from_json(fields)
    torch.cuda.reset_peak_memory_stats()
    with k1_tally() as k1:
        (line,), seconds, launches, tally = synth_executor(tb, [rec], img)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(line["status"] == "success" and "frames" in line,
            f"the {edit_type} record succeeded through the executor ({line})")
    src, out = line["frames"]
    if edit_type in VC_TYPES:
        vis = line["visual_input"]
        require(np.array_equal(out, img) and vis.shape == img.shape and vis.any(),
                f"{edit_type}: the edit is the image and the condition a {img.shape} map")
    elif edit_type == "rotation_change":
        frames = tb.extra["load_rotation_pair"](rec)
        require(np.array_equal(src, frames[0]) and np.array_equal(out, frames[1])
                and line["record"]["edit"].endswith("to the left"),
                "rotation_change: the capture pair and a left turn")
    elif edit_type == "composition":
        require(out.shape == (size, size, 3) and out.std() > 1.0,
                "composition: a canvas frame that is not flat")
    else:
        mask = line["mask"] > 0
        require(out.shape == img.shape and np.array_equal(out[~mask], img[~mask])
                and np.abs(out[mask].astype(np.int32) - img[mask]).mean() > 1.0,
                "visual_reference: the target's bytes outside the mask, changed inside")
    k1_want = ANYDOOR_K1 if edit_type == "visual_reference" else {}
    require(dict(k1) == k1_want and launches["flash_nomax"] == sum(k1_want.values()),
            f"{edit_type} launched K1 {dict(k1)}, want {k1_want}")
    require(sum(tally.values()) == launches["group_norm"]
            and (launches["group_norm"] > 0) == (edit_type in ("composition",
                                                              "visual_reference",
                                                              "visual_bbox")),
            f"{edit_type}: K2 launched {launches['group_norm']} times, all tallied")
    # the executor left its grounding memo on `tb.ground`, holding this
    # record's groundings: profile the pipeline on the grounder under it
    fresh = dataclasses.replace(tb, ground=getattr(tb.ground, "_real", tb.ground))
    pipeline = get_pipeline(edit_type)
    busy = device_busy_ms(lambda: pipeline(fresh, InstructionRecord.from_json(fields), img,
                                           np.random.default_rng(0)))
    nums = {"record_s": seconds, "peak_gib": peak, "busy_ms": busy,
            "busy_share": busy / (seconds * 1e3)}
    print(f"{edit_type} record through FactoryExecutor (gates open): {seconds:.3f} s, device "
          f"busy {busy:.1f} ms ({nums['busy_share'] * 100:.1f} %), peak {peak:.2f} GiB; "
          f"launches {launches}; K1 by shape {dict(k1)}; K2 at {len(tally)} shapes", flush=True)
    return nums, launches, dict(k1), tally


def anydoor_unet_inputs(zoo, dev):
    """One AnyDoor denoiser call's inputs at batch 2 (CFG): seeded latents,
    t = 500, a seeded DINOv2-width context through the projection (cond and
    zeros) and a seeded 4-channel hint at 8x the latent size."""
    import torch

    c = zoo.cfg
    hw = c.canvas.edit_size // c.canvas.latent_down
    n_tok = (c.dino_cfg.img_size // c.dino_cfg.patch) ** 2 + 1
    g = torch.Generator(device=dev).manual_seed(29)
    _, _, proj, _ = zoo._anydoor_core()
    with torch.inference_mode():
        ctx1 = proj(torch.randn(1, n_tok, c.dino_cfg.dim, generator=g, device=dev))
    return (torch.randn(2, hw, hw, 4, generator=g, device=dev), torch.full((2,), 500, device=dev),
            torch.cat([ctx1, torch.zeros_like(ctx1)]).to(torch.bfloat16),
            torch.rand(2, hw * 8, hw * 8, 4, generator=g, device=dev))


def visual_phase(dev):
    """On `visual_toolbox`: one record of each of VISUAL_TYPES through
    `FactoryExecutor` (`visual_record`), then the AnyDoor UNet + ControlNet
    call at batch 2 in ms (CUDA events) beside `sdxl_bound_ms`. Returns
    ({path: (launches, K2 tally)}, {path: K1 tally}, numbers)."""
    import collections

    import torch
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    t0 = time.perf_counter()
    zoo, tb, img = visual_toolbox(dev)
    torch.cuda.synchronize()
    nums = {"build_s": time.perf_counter() - t0}
    paths, k1s = {}, {}
    for et in VISUAL_TYPES:
        path = ("anydoor" if et == "visual_reference" else "rotation" if et == "rotation_change"
                else "composition" if et == "composition" else "visual_condition")
        n, launches, k1, tally = visual_record(dev, tb, img, et, zoo.cfg.canvas.edit_size)
        nums[et] = n
        prev = paths.get(path, (collections.Counter(), collections.Counter()))
        paths[path] = (collections.Counter(prev[0]) + collections.Counter(launches),
                       collections.Counter(prev[1]) + collections.Counter(tally))
        k1s[path] = collections.Counter(k1s.get(path, {})) + collections.Counter(k1)
    for path in paths:        # keep zero counts: Counter addition drops them
        paths[path] = ({k: paths[path][0].get(k, 0) for k in ("flash_nomax", "group_norm")},
                       dict(paths[path][1]))

    unet, cn, _, _ = zoo._anydoor_core()
    x, t, ctx2, hint2 = anydoor_unet_inputs(zoo, dev)

    def call():
        res, mid = cn(x, t, ctx2, hint2)
        return unet(x, t, ctx2, controlnet_residuals=res, controlnet_mid=mid)
    with torch.inference_mode():
        out = call()
        require(out.isfinite().all() and out.shape == x.shape,
                "the AnyDoor UNet's output is finite")
        nums["unet_cn_ms"] = time_ms(call, iters=5)
    nums["unet_cn_busy_ms"] = device_busy_ms(call)
    nums["bound_ms"], nums["bound_by"], nums["tflop"] = sdxl_bound_ms([unet, cn], call)
    print(f"AnyDoor UNet + ControlNet call at batch 2 ({x.shape[1]} x {x.shape[2]} latents, "
          f"{ctx2.shape[1]} context tokens): {nums['unet_cn_ms']:.3f} ms (device busy "
          f"{nums['unet_cn_busy_ms']:.3f} ms) against a bound of {nums['bound_ms']:.3f} ms "
          f"({nums['bound_by']}: {nums['tflop']:.3f} TFLOP); build {nums['build_s']:.2f} s",
          flush=True)
    del tb, zoo, unet, cn, call
    return paths, k1s, nums



# ---- slice 5: instruction generation on Llama-3-8B, the VILA and GOT-OCR2 gates

# the instruction bench's workload (`tools/bench_torch_instructions.py`, the
# twin of `tools/bench_instructions.py`): captions from a subject x scene
# grid, byte-fallback tokens capped at a 1,024-token prompt bucket, 96 new
# tokens, batch 8
INSTR_SUBJECTS = ["a dog", "two children", "a red bus", "an old clock", "a bowl of fruit",
                  "a cyclist", "a wooden bench", "a tall giraffe"]
INSTR_SCENES = ["on a beach", "in a busy street", "near a lake", "inside a kitchen",
                "at a train station", "under a tree", "on a snowy hill", "beside a brick wall"]
INSTR_PROMPT, INSTR_NEW, INSTR_BATCH = 1024, 96, 8
# Llama-3-8B's last logits after prefill(32 tokens) + one decode step
# against the full causal forward over the 33 tokens, both bf16 on the card
# (relative L2): the two run the block GEMMs at other row counts, so their
# bf16 roundings differ, grown through 32 blocks; an H100 measured 1.63e-2.
# The fp32 8B from the same seed against the bf16 one on prefill's last
# logits: bf16 rounding of the weights and activations through 32 blocks;
# an H100 measured 1.98e-2. The limits leave room for other GEMM tilings,
# not for a wrong cache slot or mask (a lost position moves the logits by
# their own scale).
LLAMA_KV_REL_L2 = 0.05
LLAMA_FP32_REL_L2 = 0.05


def instruction_captions(n: int) -> list[str]:
    return [f"{INSTR_SUBJECTS[i % 8]} {INSTR_SCENES[(i // 8) % 8]}" for i in range(n)]


def byte_tokenizer(vocab: int):
    """(tokenize, detokenize): UTF-8 bytes mapped into [1, vocab - 2], the
    prompt left-cut to INSTR_PROMPT tokens (no tokenizer assets ship)."""
    tokenize = lambda s: [1 + (b % (vocab - 2)) for b in s.encode()][-INSTR_PROMPT:]
    detok = lambda ids: bytes((max(0, i - 1) % 256) for i in ids).decode("utf-8", "replace")
    return tokenize, detok


def self_check_prompts(captions) -> list[str]:
    """The explicit self-check pass: at random weights no generation parses,
    so `InstructionGenerator` skips its own; these price it (one eval prompt
    per caption, instruction_gen.py:98-174)."""
    from anyedit_tpu_torch.instructions.prompts import eval_prompt
    return [eval_prompt("replace", c, f"replace the x in {c}", c) for c in captions]


def llama_bound_ms(m, batch: int, tokens: int, context: int) -> tuple[float, str, float, float]:
    """(bound ms, "operations" or "bytes", TFLOP, GB) of one call of the
    Llama `m` (a `CausalLM`) running `tokens` new positions per row against
    `context` key slots (prefill: tokens = context = L, the full L x L grid
    the JAX module computes; a decode step: 1 token against every cache
    slot), the head at the last position. Operations: the block
    projections, 2 x their parameters x rows (int8 at 1,979 TOP/s when
    W8A8, else bf16 at 989 TFLOP/s); QK^T and PV, 4 x layers x heads x
    tokens x context x hd a row, at 989; the fp32 head, 2 x dim x vocab a
    row, at 67 TFLOP/s. Bytes: every block and head parameter read once,
    the embedding rows gathered, the bf16 KV cache's earlier slots read and
    the new ones written, the logits written; at 3.35 TB/s."""
    from anyedit_tpu_torch.ops.kernel_check import (
        HBM_BYTES_PER_S, PEAK_BF16, PEAK_FP32, PEAK_INT8,
    )
    c = m.lm_cfg
    hd = c.dim // c.heads
    blocks = m.lm_body.layers
    proj = sum(p.numel() for n, p in blocks.named_buffers() if n.endswith(".weight")) + \
        sum(p.numel() for n, p in blocks.named_parameters() if n.endswith("proj.weight"))
    rows = batch * tokens
    ops = {"proj": 2.0 * proj * rows,
           "attn": 4.0 * c.layers * batch * c.heads * tokens * context * hd,
           "head": 2.0 * batch * c.dim * c.vocab_size}
    ops_ms = (ops["proj"] / (PEAK_INT8 if c.quant else PEAK_BF16)
              + ops["attn"] / PEAK_BF16 + ops["head"] / PEAK_FP32) * 1e3
    weights = sum(t.numel() * t.element_size()
                  for t in list(blocks.parameters()) + list(blocks.buffers()))
    weights += m.lm_head.weight.numel() * 4 + c.dim * 4 + rows * c.dim * 4
    kv = 2 * c.layers * batch * c.kv_heads * context * hd * 2
    moved = weights + kv + batch * c.vocab_size * 4
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            sum(ops.values()) / 1e12, moved / 1e9)


def check_llm_reference(dev):
    """The tiny Llama in bf16 and in W8A8 (the same int8 codes and scales),
    the tiny VILA and the tiny GOT-OCR2 on the card against the same models
    in fp32 on the CPU, same weights: the Llama's causal-forward logits and
    the logits of prefill + two decode steps (the W8A8 decode's 2-row GEMMs
    pass through the padded `torch._int_mm`), VILA's yes/no logits through
    `vila_fn()`, GOT's image tokens and text logits; each within twice the
    CPU's own bf16 distance, at least one bf16 rounding (2^-8). Then the
    int8 contraction at M = 1, 8 and 16 rows on the card equals float64."""
    import torch
    from anyedit_tpu_torch.models.llama import TINY_LLAMA, Llama, quantize_llama
    from anyedit_tpu_torch.ops.quant import int8_matmul
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, tiny_zoo_config
    from anyedit_tpu_torch.weights.init import seeded_init_

    bf16, f32 = torch.bfloat16, torch.float32
    places = {"ref": (f32, "cpu"), "cpu16": (bf16, "cpu"), "card16": (bf16, dev)}

    def llama(dtype, device, quant=False):
        cfg = dataclasses.replace(TINY_LLAMA, dtype=dtype, quant=quant)
        return Llama(cfg, device=device).eval().requires_grad_(False)
    ref = seeded_init_(llama(f32, "cpu"), 0)
    qref = quantize_llama(ref)
    rng = np.random.default_rng(11)
    ids = rng.integers(1, TINY_LLAMA.vocab_size, (2, 12))
    img = rng.integers(0, 256, (48, 40, 3), np.uint8)
    tiny = tiny_zoo_config()

    def zoo_cfg(dtype):
        v, o = tiny.vila, tiny.ocr
        return dataclasses.replace(
            tiny, vila=dataclasses.replace(v, vision=dataclasses.replace(v.vision, dtype=dtype),
                                           lm=dataclasses.replace(v.lm, dtype=dtype)),
            ocr=dataclasses.replace(o, vision=dataclasses.replace(o.vision, dtype=dtype),
                                    lm=dataclasses.replace(o.lm, dtype=dtype), dtype=dtype))
    zref = ModelZoo(zoo_cfg(f32), "cpu", seed=0)

    def outputs(name):
        dtype, device = places[name]
        out = {}
        for label, src, quant in (("llama", ref, False), ("llama_w8a8", qref, True)):
            m = llama(dtype, device, quant)
            m.load_state_dict(src.state_dict())
            t = torch.from_numpy(ids).to(device)
            with torch.inference_mode():
                out[f"{label} forward"] = m(t)
                logits, caches = m.prefill(m.embed(t[:, :10]), 12)
                steps = [logits]
                for pos in (10, 11):
                    logits, caches = m.decode_step(m.embed(t[:, pos:pos + 1]), caches, pos)
                    steps.append(logits)
                out[f"{label} prefill + decode"] = torch.stack(steps, 1)
        z = ModelZoo(zoo_cfg(dtype), device, seed=0)
        z._vila().load_state_dict(zref._vila().state_dict())
        z._got().load_state_dict(zref._got().state_dict())
        out["vila logits"] = z.vila_fn().logits(img, VQA_QUESTIONS[0])
        got = z._got()
        with torch.inference_mode():
            toks = got.encode_image(z._pixels(img, z.cfg.ocr.vision.img_size))
            out["got image tokens"] = toks
            out["got text logits"] = got.lm_logits(toks, torch.from_numpy(ids[:1]).to(device))
        return {k: v.float().cpu() for k, v in out.items()}

    out = {name: outputs(name) for name in places}
    for key, r in out["ref"].items():
        d16 = float((out["cpu16"][key] - r).abs().max())
        dcard = float((out["card16"][key] - r).abs().max())
        bound = 2 * max(d16, 2.0 ** -8)
        print(f"tiny {key}: card bf16 vs CPU fp32 max diff {dcard:.3e}, CPU bf16 {d16:.3e} "
              f"(bound {bound:.3e})", flush=True)
        require(bool(torch.isfinite(out["card16"][key]).all()) and dcard <= bound,
                f"the card's bf16 {key} is within twice the CPU's bf16 distance")
    for m in (1, 8, 16):
        a = rng.integers(-127, 128, (m, 4096)).astype(np.int8)
        b = rng.integers(-127, 128, (4096, 4096)).astype(np.int8)
        got = int8_matmul(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev).t().contiguous().t())
        want = torch.from_numpy(a).double() @ torch.from_numpy(b).double()
        require(got.dtype == torch.int32 and torch.equal(got.cpu().double(), want),
                f"the int8 contraction at M = {m} (padded rows) equals float64")
    print("int8 contraction at M = 1, 8, 16 rows x 4096 x 4096 on the card: equal to "
          "float64", flush=True)


def llm_phase(dev):
    """Llama-3-8B at published widths, seeded on the card (the phase's own
    models, freed after): the KV-cache check (LLAMA_KV_REL_L2), the fp32 8B
    from the same seed against the bf16 one (LLAMA_FP32_REL_L2), prefill at
    (8, 1024) and a decode step at batch 8 against 1,120 slots in ms (CUDA
    events) beside `llama_bound_ms` (which warms the batch's shapes), one
    `InstructionGenerator` batch of INSTR_BATCH captions on the bench's
    workload with the self-check priced (seconds, device-busy share of a
    second, profiled run, peak GiB, K1 = K2 = 0); then the W8A8 8B
    (`quantize_llama`) against bf16 (cosine > 0.95) and its prefill and
    decode times. Returns (launches, numbers)."""
    import torch
    from anyedit_tpu_torch.instructions.generator import InstructionGenerator, LlamaBackend
    from anyedit_tpu_torch.models.llama import LLAMA3_8B, Llama, quantize_llama
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.ops.kernel_check import time_ms
    from anyedit_tpu_torch.weights.init import seeded_init_

    def build(cfg):
        return seeded_init_(Llama(cfg, device=dev), 0).eval().requires_grad_(False)

    def step_times(m, label):
        cache_len = INSTR_PROMPT + INSTR_NEW
        with torch.inference_mode():
            emb = m.embed(torch.ones(INSTR_BATCH, INSTR_PROMPT, dtype=torch.int64, device=dev))
            tok = m.embed(torch.ones(INSTR_BATCH, 1, dtype=torch.int64, device=dev))
            _, caches = m.prefill(emb, cache_len)
            pre_ms = time_ms(lambda: m.prefill(emb, cache_len), iters=3)
            dec_ms = time_ms(lambda: m.decode_step(tok, caches, INSTR_PROMPT), iters=20)
        pre_b = llama_bound_ms(m, INSTR_BATCH, INSTR_PROMPT, INSTR_PROMPT)
        dec_b = llama_bound_ms(m, INSTR_BATCH, 1, cache_len)
        print(f"Llama-3-8B {label}: prefill at ({INSTR_BATCH}, {INSTR_PROMPT}) {pre_ms:.3f} ms "
              f"(bound {pre_b[0]:.3f} ms, {pre_b[1]}: {pre_b[2]:.2f} TFLOP, {pre_b[3]:.2f} GB); "
              f"decode step at batch {INSTR_BATCH} over {cache_len} slots {dec_ms:.3f} ms "
              f"(bound {dec_b[0]:.3f} ms, {dec_b[1]}: {dec_b[2]:.3f} TFLOP, {dec_b[3]:.2f} GB)",
              flush=True)
        return {f"{label}_prefill_ms": pre_ms, f"{label}_prefill_bound_ms": pre_b[0],
                f"{label}_decode_ms": dec_ms, f"{label}_decode_bound_ms": dec_b[0]}

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(LLAMA3_8B)
    torch.cuda.synchronize()
    nums = {"build_s": time.perf_counter() - t0}
    v = LLAMA3_8B.vocab_size
    ids = torch.from_numpy(np.random.default_rng(12).integers(1, v, (2, 33))).to(dev)
    with torch.inference_mode():
        full = model(ids)[:, -1]
        p16, caches = model.prefill(model.embed(ids[:, :32]), 33)
        step, _ = model.decode_step(model.embed(ids[:, 32:]), caches, 32)
        nums["kv_rel_l2"] = rel(step, full)
    f32 = build(dataclasses.replace(LLAMA3_8B, dtype=torch.float32))
    with torch.inference_mode():
        p32, _ = f32.prefill(f32.embed(ids[:, :32]), 32)
        nums["fp32_rel_l2"] = rel(p16, p32)
    del f32, caches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"Llama-3-8B bf16 (built in {nums['build_s']:.2f} s): prefill + decode vs the full "
          f"forward, relative L2 {nums['kv_rel_l2']:.3e} (bound {LLAMA_KV_REL_L2}); vs the "
          f"fp32 8B from the same seed {nums['fp32_rel_l2']:.3e} (bound {LLAMA_FP32_REL_L2})",
          flush=True)
    require(bool(full.isfinite().all()) and nums["kv_rel_l2"] <= LLAMA_KV_REL_L2,
            "the KV-cache decode matches the full causal forward")
    require(nums["fp32_rel_l2"] <= LLAMA_FP32_REL_L2, "the bf16 8B tracks the fp32 8B")

    tokenize, detok = byte_tokenizer(v)
    backend = LlamaBackend(model, tokenize, detok, max_new=INSTR_NEW, batch_size=INSTR_BATCH)
    gen = InstructionGenerator(llm=backend, seed=0, n_shots=5)
    caps = instruction_captions(INSTR_BATCH)
    evals = self_check_prompts(caps)

    def batch():
        records = gen.generate("replace", caps, batch_size=INSTR_BATCH)
        return records, backend(evals)
    # timing prefill at (8, 1024) and the decode step first warms the batch
    nums.update(step_times(model, "bf16"))
    torch.cuda.reset_peak_memory_stats()
    flash_nomax.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    records, answers = batch()
    torch.cuda.synchronize()
    nums["batch_s"] = time.perf_counter() - t0
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    nums["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    require(launches == {"flash_nomax": 0, "group_norm": 0},
            f"the instruction batch launched {launches}, want K1 0 and K2 0")
    require(len(answers) == INSTR_BATCH and all(isinstance(a, str) for a in answers),
            "the self-check pass answered every caption")
    nums["busy_ms"] = device_busy_ms(batch)
    nums["busy_share"] = nums["busy_ms"] / (nums["batch_s"] * 1e3)
    nums["records_per_hour"] = INSTR_BATCH / nums["batch_s"] * 3600.0
    print(f"InstructionGenerator batch of {INSTR_BATCH} captions (5 shots, byte tokens "
          f"in a {INSTR_PROMPT}-token bucket, {INSTR_NEW} new tokens, then the self-check "
          f"pass): {nums['batch_s']:.3f} s "
          f"({nums['records_per_hour']:.1f} records/hour), device busy {nums['busy_ms']:.1f} "
          f"ms ({nums['busy_share'] * 100:.1f} %), peak {nums['peak_gib']:.2f} GiB; "
          f"{len(records)} records parsed at random weights; launches {launches}", flush=True)

    t0 = time.perf_counter()
    q = quantize_llama(model)
    torch.cuda.synchronize()
    nums["w8a8_build_s"] = time.perf_counter() - t0
    with torch.inference_mode():
        q16, _ = q.prefill(q.embed(ids[:, :32]), 32)
    nums["w8a8_cosine"] = cosine(q16, p16)
    nums.update(step_times(q, "w8a8"))
    print(f"W8A8 Llama-3-8B (quantized in {nums['w8a8_build_s']:.2f} s): prefill logits vs "
          f"bf16 cosine {nums['w8a8_cosine']:.5f}", flush=True)
    require(nums["w8a8_cosine"] > 0.95, "the W8A8 8B tracks the bf16 one (cosine > 0.95)")
    del q, model, backend, gen
    gc.collect()
    torch.cuda.empty_cache()
    return launches, nums


def vila_bound_ms(m, n_img: int, n_txt: int) -> tuple[float, str, float]:
    """(bound ms, "operations" or "bytes", TFLOP) of one VILA call: the CLIP
    tower (2 x its block parameters a token over n_img + 1 tokens, plus
    4 x layers x hidden x tokens^2 for attention), the projector, and the
    LM's prefill over n_img + n_txt tokens (2 x block parameters a token,
    the L x L attention, the fp32 head at the last token), at 989 TFLOP/s
    bf16 (67 fp32 for the projector and head); every parameter read once
    at 3.35 TB/s."""
    from anyedit_tpu_torch.ops.kernel_check import HBM_BYTES_PER_S, PEAK_BF16, PEAK_FP32
    vc, lc = m.cfg.vision, m.lm_cfg
    tower = m.model.vision_tower.vision_model.encoder.layers
    tv = n_img + 1
    ops_ms = 2.0 * sum(p.numel() for p in tower.parameters()) * tv / PEAK_BF16
    ops_ms += 4.0 * vc.layers * vc.hidden * tv * tv / PEAK_BF16
    ops_ms += 2.0 * sum(p.numel() for p in m.model.multi_modal_projector.parameters()) * \
        n_img / PEAK_FP32
    length = n_img + n_txt
    ops_ms += 2.0 * sum(p.numel() for p in m.lm_body.layers.parameters()) * length / PEAK_BF16
    ops_ms += 4.0 * lc.layers * lc.dim * length * length / PEAK_BF16
    ops_ms += 2.0 * lc.dim * lc.vocab_size / PEAK_FP32
    ops_ms *= 1e3
    moved = sum(p.numel() * p.element_size() for p in m.parameters()) \
        - m.lm_body.embed_tokens.weight.numel() * 4 + length * lc.dim * 4
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
            ops_ms * 1e-3 * PEAK_BF16 / 1e12)


def vila_record(dev, zoo, k2_per_request: int):
    """RECORD through `FactoryExecutor` with "vila" installed in place of
    "vqa" (beside "clip" and "aesthetic"), both gates, the pre-gate on the
    image size only (executor record (b)'s): the line is `success` or
    `filtered` at post, K1 1,000 and K2 one request's plus 4, the
    post-filter's vqa_yes is the answer VILA gave on the edited frame
    (each call to the judge recorded); then one VILA call on a 480x640
    image in ms (median of 3 after a warm-up) beside `vila_bound_ms`.
    Returns (launches, numbers)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord
    from anyedit_tpu_torch.filters.pre_filter import PreScores
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime.executor import ExecutorConfig, FactoryExecutor

    rec = InstructionRecord.from_json(RECORD)
    img = np.random.default_rng(7).integers(0, 256, GROUND_HW + (3,), np.uint8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tb = zoo.toolbox(slots=("clip", "aesthetic", "vila"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ask = tb.vqa_yes_no
    require(ask is zoo.vila_fn(), "the vila slot is the toolbox's VQA judge")
    asked = []

    def judge(image, question):
        asked.append((image, question, ask(image, question)))
        return asked[-1][2]
    tb.vqa_yes_no = judge
    post = {}
    with tempfile.TemporaryDirectory() as root:
        ex = FactoryExecutor(tb, ExecutorConfig(output_root=root))
        scored, default_post = ex.pre_scorer, ex.post_scorer

        def size_only(r, i):
            s = scored(r, i)
            return PreScores(width=s.width, height=s.height)
        ex.pre_scorer = size_only
        ex.post_scorer = lambda r, i, o: post.setdefault("scores", default_post(r, i, o))
        torch.cuda.synchronize()
        flash_nomax.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        ex.run([rec], lambda r: img)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
        line = json.loads((Path(root) / "ledger.jsonl").read_text().splitlines()[-1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"flash_nomax": STEPS * K1_PER_UNET_CALL,
            "group_norm": k2_per_request + K2_PER_GROUND}
    require(line["status"] in ("success", "filtered") and line["payload"].get("stage") != "pre",
            f"the VILA-gated record ended {line}")
    require(launches == want, f"the VILA-gated record launched {launches}, want {want}")
    sc = post["scores"]
    require(len(asked) == 1 and asked[0][1] == "Is the color of car close to red?"
            and sc.vqa_yes is asked[0][2],
            "the post-filter's vqa_yes is VILA's answer on the edited frame")
    m = zoo._vila()
    c = zoo.cfg.vila
    n_img = (c.vision.image_size // c.vision.patch) ** 2
    ask.logits(img, VQA_QUESTIONS[0])
    call_ms, runs = median_ms(lambda: ask.logits(img, VQA_QUESTIONS[0]))
    bound_ms, bound_by, tflop = vila_bound_ms(m, n_img, 32)
    busy = device_busy_ms(lambda: ask.logits(img, VQA_QUESTIONS[0]))
    nums = {"record_s": seconds, "build_s": build_s, "peak_gib": peak, "vila_ms": call_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "busy_share": busy / call_ms,
            "vqa_yes": bool(sc.vqa_yes), "status": line["status"]}
    print(f"color_alter record with VILA-1.5 (vicuna-7B + CLIP ViT-L/336, built in "
          f"{build_s:.2f} s) as the post-filter's VQA: {line['status']} in {seconds:.3f} s, "
          f"vqa_yes {sc.vqa_yes} (VILA's answer), peak {peak:.2f} GiB; launches {launches}; "
          f"VILA call {call_ms:.3f} ms ({', '.join(f'{t:.2f}' for t in runs)}) against a "
          f"bound of {bound_ms:.3f} ms ({bound_by}: {tflop:.3f} TFLOP), device busy "
          f"{nums['busy_share'] * 100:.1f} %", flush=True)
    return launches, nums


def ocr_record(dev, szoo, tb):
    """One more textual_change record through `synth_executor` (gates open)
    with "ocr" installed (GOT-OCR2 at published widths: SAM ViT-B at 1,024
    px, Qwen2-0.5B, 32 new tokens at most): the reader runs on the
    synthesized input and, at random weights, reads no quoted text, so the
    pipeline's gate fails closed after that first read (its `and` needs
    no second one): status `failure`, reason "OCR text mismatch", one read,
    K1 0. Then one read of a 512 px frame in ms (median of 3). The slot is
    taken off the toolbox after. Returns ((launches, K2 tally), numbers)."""
    import torch
    from anyedit_tpu_torch.core.schema import InstructionRecord

    szoo.install(tb, "ocr")
    reader, reads = tb.ocr, []
    tb.ocr = lambda image: reads.append(reader(image)) or reads[-1]
    rec = InstructionRecord.from_json(dict(SYNTH_RECORDS["textual_change"],
                                           edit_type="textual_change", id="textual_ocr"))
    img = np.random.default_rng(17).integers(0, 256, GROUND_HW + (3,), np.uint8)
    (line,), seconds, launches, tally = synth_executor(tb, [rec], img)
    tb.ocr = None
    require(line["status"] == "failure"
            and line["payload"].get("reason") == "OCR text mismatch" and len(reads) == 1,
            f"the OCR gate failed closed after one read ({line}, reads {reads})")
    require(launches["flash_nomax"] == 0 and sum(tally.values()) == launches["group_norm"],
            f"the OCR-gated textual_change launched {launches}")
    frame = np.random.default_rng(18).integers(0, 256, (512, 512, 3), np.uint8)
    read_ms, runs = median_ms(lambda: reader(frame))
    nums = {"record_s": seconds, "read_ms": read_ms, "text": reads[0]}
    print(f"textual_change record with the GOT-OCR2 gate: {line['status']} "
          f"({line['payload']['reason']}) in {seconds:.3f} s after {len(reads)} read "
          f"({reads[0][:48]!r}); a 512 px read {read_ms:.2f} ms "
          f"({', '.join(f'{t:.2f}' for t in runs)}); launches {launches}", flush=True)
    return (launches, tally), nums


# ---- slice 6a: training ---------------------------------------------------

# The AnySD reference step (`cli.py train` defaults): SD15_IP2P_UNET frozen,
# 256 px (32x32 latents), batch 16; its level-0 self-attention is K1 at
# (128, 1024, 40), 5 sites a UNet call, forward only (the backward recomputes
# through sdpa). 4 steps with a resume after 2, a checkpoint every 2, one
# validation grid of one pair at 20 steps.
TRAIN_BATCH, TRAIN_RES, TRAIN_STEPS, TRAIN_VAL_STEPS = 16, 256, 4, 20
K1_PER_TRAIN_STEP = 5
TRAIN_PATHS = {"train": "cli train, 2 steps at batch 16, 256 px (the UNet at batch 16 with "
                        "grad, the VAE encoder at batch 16 twice an iteration)",
               "train_resume": "cli train --resume to 4 steps with one validation grid (a "
                               "20-step edit: the UNet at 3 CFG rows, the VAE at batch 1)",
               "distill": "2 LCM distillation steps at batch 2, 512 px (the teacher at 3 x 2 "
                          "rows, the student and the EMA target at 2)",
               "lcm_request": "one 4-step LCM request on the student (the UNet at one row, "
                              "the VAE at batch 1)"}
# LCM distillation at 512 px (64x64 latents): the CLI's batch of 8 cut to 2
# for chip time (`tools/bench_torch_train.py --distill` runs 8). K1 30 a
# step: 10 each for the teacher at 3 x 2 rows, the student and the EMA
# target at 2.
DISTILL_BATCH, DISTILL_RES, DISTILL_STEPS = 2, 512, 2
K1_PER_DISTILL_STEP = 30
LCM_STEPS = 4
# The backward checks: K1 at the AnySD step's level 0 and the distilled
# student's levels 0 and 1 at batch 2; K2 at the AnySD step's level 0 and
# 3 and the student's level 0.
K1_GRAD_SHAPES = [(128, 1024, 40), (16, 4096, 40), (16, 1024, 80)]
K2_GRAD_SHAPES = [((16, 320, 32, 32), True), ((16, 1280, 4, 4), True),
                  ((2, 320, 64, 64), True)]
# K1's recompute backward (fp32 sdpa) against the autograd of K1's plain
# version (which rounds q and p to bf16 as the kernel does), bf16 inputs and
# gradients: the worst relative L2 over dq, dk, dv within 4 bf16 roundings
# (2^-8 each; the CPU measures 4.2e-3 at (4, 1024, 40)). K2's backward is
# the plain version's own autograd on the saved inputs, so within one.
K1_GRAD_REL_L2 = 2.0 ** -6
K2_GRAD_REL_L2 = 2.0 ** -8
# One full-width AnySD step through K1 and K2 against the same step with
# both swapped for their plain versions (plain autograd end to end): the
# adapter gradients, flattened, at cosine >= 0.99 and relative L2 <= 0.05
# (bf16 roundings of the two forwards through 16 transformer blocks). Two
# controls must fail it: the step with K1's outputs cut from autograd (what
# the wrappers returned before they had a backward) and K2 kept, and with
# K2's cut at every norm but the last.
DISCONNECT_COS, DISCONNECT_REL_L2 = 0.99, 0.05


def check_train_kernels(dev):
    """K1's and K2's backward (the Functions' recompute) at K1_GRAD_SHAPES /
    K2_GRAD_SHAPES against the plain versions' autograd, the bounds above,
    and the Functions' forward output against the plain version's, with
    `check_kernels`' bounds; each output carries a grad_fn and the backward
    launches no kernel. Returns [(kernel, tag, row)]."""
    from anyedit_tpu_torch.ops import kernel_check as kc

    rows = []
    for s in K1_GRAD_SHAPES:
        r = kc.check_flash_nomax_grad(*s, dev)
        rows.append(("flash_nomax", str(s), r))
    for s, silu in K2_GRAD_SHAPES:
        r = kc.check_group_norm_grad(s, silu, dev)
        rows.append(("group_norm", f"{s} {'silu' if silu else 'plain'}", r))
    for name, tag, r in rows:
        bound = K1_GRAD_REL_L2 if name == "flash_nomax" else K2_GRAD_REL_L2
        fwd = K1_FWD_BOUNDS if name == "flash_nomax" else K2_FWD_BOUNDS
        print(f"{'K1' if name == 'flash_nomax' else 'K2'} {name} backward {tag}: rel-L2 "
              f"{r['rel_l2']:.3e} (bound {bound:.3e}), max {r['max_abs_err']:.3e}; output "
              f"max {r['fwd_max_abs_err']:.3e} mean {r['fwd_mean_abs_err']:.3e} (bounds "
              f"{fwd[0]}, {fwd[1]}) | forward "
              f"{r['fwd_ms']:.4f} ms, backward {r['ms']:.4f} ms (both {r['fwd_bwd_ms']:.4f}), "
              f"plain backward {r['plain_ms']:.4f} ms | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bound_term']}) | library backward "
              f"{r['library_ms']:.4f} ms, both {r['library_fwd_bwd_ms']:.4f} ms "
              f"[{r['library']}]", flush=True)
        require(r["finite"] and r["rel_l2"] <= bound and r["has_grad_fn"]
                and r["launches"] == 1,
                f"{name} {tag}: the backward agrees with the plain autograd, the output "
                "has a grad_fn, one launch (the forward's)")
        require(r["fwd_finite"] and r["fwd_max_abs_err"] <= fwd[0]
                and r["fwd_mean_abs_err"] <= fwd[1],
                f"{name} {tag}: the forward under grad agrees with its plain version")
    return rows


def check_train_reference(dev):
    """The tiny AnySD loss and adapter gradients (the tiny UNet at 32x32
    latents: K1 at its 3 level-0 sites, K2 at its norms) in bf16 on the
    card against the same step in fp32 on the CPU, same weights, batch and
    draws (one sample with text and image dropped): the card within twice
    the CPU's own bf16 distance (at least 2^-8), relative for the loss,
    worst relative L2 over the gradients."""
    import torch
    from anyedit_tpu_torch.cli import _anysd_configs
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.train.anysd import AnySDTrainer

    cfg = _anysd_configs(True)[0]
    rng = np.random.default_rng(0)
    b, dc = 2, cfg.unet.context_dim
    batch = {"edited_latents": rng.standard_normal((b, 32, 32, 4)),
             "orig_latents": rng.standard_normal((b, 32, 32, 4)),
             "text_emb": rng.standard_normal((b, 16, dc)),
             "image_embed": rng.standard_normal((b, cfg.image_embed_dim))}
    draws = {"t": np.array([700, 30]), "noise": rng.standard_normal((b, 32, 32, 4)),
             "p": np.array([0.07, 0.6])}
    state, out = None, {}
    for name, dtype, device in (("ref", torch.float32, "cpu"),
                                ("cpu16", torch.bfloat16, "cpu"),
                                ("card16", torch.bfloat16, dev)):
        tr = AnySDTrainer(dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, dtype=dtype)), device=device)
        unet, adapter, _ = tr.init(seed=0)
        if state is None:
            state = (unet.state_dict(), adapter.state_dict())
        unet.load_state_dict(state[0])
        adapter.load_state_dict(state[1])
        tb = {k: torch.from_numpy(v).float().to(device) for k, v in batch.items()}
        tb["task_id"] = torch.tensor([1, 3], device=device)
        td = {k: torch.from_numpy(v).to(device) for k, v in draws.items()}
        td["noise"], td["p"] = td["noise"].float(), td["p"].float()
        flash_nomax.launches = group_norm.launches = 0
        params = list(adapter.parameters())
        loss = tr.loss_fn(adapter, unet, tb, td)
        grads = torch.autograd.grad(loss, params)
        if name == "card16":
            torch.cuda.synchronize()
            require(flash_nomax.launches == 3 and group_norm.launches > 0,
                    f"the tiny step on the card launched K1 {flash_nomax.launches} (want 3) "
                    f"and K2 {group_norm.launches} times")
        out[name] = (float(loss.detach()), [g.float().cpu() for g in grads])
    ref_loss, ref_g = out["ref"]
    err = {}
    for k in ("cpu16", "card16"):
        loss, g = out[k]
        err[k] = (abs(loss - ref_loss) / abs(ref_loss),
                  max(float((a - r).norm() / r.norm()) for a, r in zip(g, ref_g)))
        print(f"tiny AnySD step, {k} vs CPU fp32: loss rel {err[k][0]:.3e}, adapter "
              f"gradients worst rel-L2 {err[k][1]:.3e}", flush=True)
    for i, what in enumerate(("loss", "adapter gradients")):
        require(err["card16"][i] <= 2 * max(err["cpu16"][i], 2.0 ** -8),
                f"the card's bf16 {what} within twice the CPU's bf16 distance")


@contextlib.contextmanager
def counted(cls, method: str, log: list):
    """(K1, K2) launches of each call of `cls.method` inside the block."""
    import torch
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    real = getattr(cls, method)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        n1, n2 = flash_nomax.launches, group_norm.launches
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        log.append((flash_nomax.launches - n1, group_norm.launches - n2,
                    time.perf_counter() - t0))
        return result
    setattr(cls, method, call)
    try:
        yield log
    finally:
        setattr(cls, method, real)


def group_norms(module) -> int:
    from anyedit_tpu_torch.models.layers import GroupNorm
    return sum(isinstance(m, GroupNorm) for m in module.modules())


def train_phase(dev, ledger: Path, image_root: Path):
    """`cli.main(["train", ...])` at full width on seeded weights drawn on
    the card, on the executor record's success ledger (one record; the
    sampler draws with replacement): 2 steps, then `--resume` to 4 with a
    validation grid. Each step: K1 exactly 5 and K2 the UNet's 61 (counted
    around `train_step`); each loop iteration adds the VAE encoder's norms
    for the two encodes; the grid's 20-step edit K1 5 a UNet call. A finite
    loss every step, the adapter changed, the UNet's bytes unchanged; K1
    and K2 tallied by shape over each run. Then the disconnect check.
    Returns (launches by path, numbers)."""
    import io
    import torch
    from anyedit_tpu_torch import cli
    from anyedit_tpu_torch.models import layers
    from anyedit_tpu_torch.models.vae import AutoencoderKL
    from anyedit_tpu_torch.ops import attention as attn_mod
    from anyedit_tpu_torch.ops.attention import flash_nomax, flash_nomax_plain
    from anyedit_tpu_torch.ops import groupnorm as gn_mod
    from anyedit_tpu_torch.ops.groupnorm import group_norm, group_norm_plain
    from anyedit_tpu_torch.train.anysd import AnySDTrainer
    from anyedit_tpu_torch.train.checkpoint import TrainCheckpointer
    from anyedit_tpu_torch.train.inference import AnySDEditor

    vae = AutoencoderKL(cli._anysd_configs(False)[3], device="meta")
    enc_norms, dec_norms = group_norms(vae.encoder), group_norms(vae.decoder)
    held = {}
    real_init = AnySDTrainer.init

    def init(self, *args, **kwargs):
        unet, adapter, opt = real_init(self, *args, **kwargs)
        held.update(trainer=self, unet=unet, adapter=adapter,
                    unet0=[t.clone() for t in unet.state_dict().values()],
                    adapter0=[p.detach().clone() for p in adapter.parameters()])
        return unet, adapter, opt

    ckdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    base = ["train", "--ledger", str(ledger), "--image-root", str(image_root),
            "--batch-size", str(TRAIN_BATCH),
            "--resolution", str(TRAIN_RES), "--checkpoint-dir", str(ckdir),
            "--checkpoint-every", "2", "--log-every", "1", "--seed", "0", "--device", str(dev)]
    runs = {}
    AnySDTrainer.init = init
    try:
        for label, extra in (("train", ["--steps", "2", "--val-count", "0"]),
                             ("train_resume", ["--steps", str(TRAIN_STEPS), "--resume",
                                               "--val-count", "1", "--val-steps",
                                               str(TRAIN_VAL_STEPS)])):
            steps, edits, buf = [], [], io.StringIO()
            torch.cuda.synchronize()
            flash_nomax.launches = group_norm.launches = 0
            t0 = time.perf_counter()
            with counted(AnySDTrainer, "train_step", steps), \
                    counted(AnySDEditor, "edit", edits), k1_tally() as t1, k2_tally() as t2, \
                    contextlib.redirect_stdout(buf):
                rc = cli.main(base + extra)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            lines = buf.getvalue().strip().splitlines()
            for line in lines:
                print(f"  {label}: {line}", flush=True)
            require(rc == 0, f"{label} exited {rc}")
            losses = [json.loads(x)["loss"] for x in lines if x.startswith('{"step"')]
            n = len(steps)
            unet_norms = group_norms(held["unet"])
            require(n == 2 and len(losses) == 2 and all(np.isfinite(losses)),
                    f"{label}: 2 steps with finite losses ({losses})")
            require(all(s[:2] == (K1_PER_TRAIN_STEP, unet_norms) for s in steps),
                    f"{label}: K1 {K1_PER_TRAIN_STEP} and K2 {unet_norms} a train step, "
                    f"got {[s[:2] for s in steps]}")
            want_edit = [(TRAIN_VAL_STEPS * K1_PER_TRAIN_STEP,
                          TRAIN_VAL_STEPS * unet_norms + enc_norms + dec_norms)] \
                * (label == "train_resume")
            require([e[:2] for e in edits] == want_edit,
                    f"{label}: the validation edits launched {[e[:2] for e in edits]}, "
                    f"want {want_edit}")
            k1 = n * K1_PER_TRAIN_STEP + sum(e[0] for e in edits)
            k2 = n * (unet_norms + 2 * enc_norms) + sum(e[1] for e in edits)
            require(flash_nomax.launches == k1 and group_norm.launches == k2,
                    f"{label}: K1 {flash_nomax.launches} (want {k1}), K2 "
                    f"{group_norm.launches} (want {k2} = {n} x ({unet_norms} + 2 x "
                    f"{enc_norms}) + the grid's edit)")
            require(all(torch.equal(a, b) for a, b in
                        zip(held["unet0"], held["unet"].state_dict().values())),
                    f"{label}: the UNet's weights are their bytes before the run")
            moved = max(float((a - b.detach()).abs().max())
                        for a, b in zip(held["adapter0"], held["adapter"].parameters()))
            require(moved > 0, f"{label}: the adapter changed")
            runs[label] = {"k1": flash_nomax.launches, "k2": group_norm.launches,
                           "step_launches": [s[:2] for s in steps],
                           "k1_by_shape": dict(t1), "k2_by_shape": dict(t2),
                           "step_s": [s[2] for s in steps], "edit_s": [e[2] for e in edits],
                           "seconds": seconds, "losses": losses, "moved": moved}
            print(f"{label}: K1 {flash_nomax.launches}, K2 {group_norm.launches} (train steps "
                  f"(K1, K2) {[s[:2] for s in steps]}; VAE encoder {enc_norms} x 2 a step; "
                  f"grid edit {[e[:2] for e in edits]}); by shape K1 {dict(t1)}, K2 "
                  f"{len(t2)} shapes; step s {[round(s[2], 4) for s in steps]}; "
                  f"adapter moved max {moved:.3e}; {seconds:.2f} s", flush=True)
    finally:
        AnySDTrainer.init = real_init
    require(TrainCheckpointer(ckdir).all_steps() == [2, 4], "checkpoints at steps 2 and 4")
    grid = decode_png((ckdir / "val" / f"val_step_{TRAIN_STEPS}.png").read_bytes())
    require(grid.shape == (TRAIN_RES, 2 * TRAIN_RES + 2, 3), f"the grid is {grid.shape}")

    # the disconnect check, on the trained adapter and the frozen UNet
    tr, unet, adapter = held["trainer"], held["unet"], held["adapter"]
    c = tr.cfg
    g = torch.Generator(device=dev).manual_seed(9)
    hw = TRAIN_RES // 2 ** (len(vae.cfg.block_channels) - 1)
    batch = {"edited_latents": torch.randn(TRAIN_BATCH, hw, hw, 4, generator=g, device=dev),
             "orig_latents": torch.randn(TRAIN_BATCH, hw, hw, 4, generator=g, device=dev),
             "text_emb": torch.randn(TRAIN_BATCH, 77, c.unet.context_dim, generator=g,
                                     device=dev),
             "image_embed": torch.nn.functional.normalize(
                 torch.randn(TRAIN_BATCH, c.image_embed_dim, generator=g, device=dev), dim=-1),
             "task_id": torch.arange(TRAIN_BATCH, device=dev) % c.num_experts}
    draws = tr.draw(g, batch)
    draws["p"] = torch.full_like(draws["p"], 0.5)       # no dropout

    def grads():
        """(the adapter's gradients flattened, or None where the loss has no
        autograd graph at all, (K1, K2) launches)."""
        flash_nomax.launches = group_norm.launches = 0
        loss = tr.loss_fn(adapter, unet, batch, draws)
        gs = (torch.autograd.grad(loss, list(adapter.parameters()))
              if loss.requires_grad else None)
        torch.cuda.synchronize()
        return (None if gs is None else torch.cat([x.flatten().float() for x in gs]),
                (flash_nomax.launches, group_norm.launches))

    def plain_attention(q, k, v, scale=None, use_flash=None, int8=False):
        b, h, lq, d = q.shape
        if use_flash is None and attn_mod._on_k1_route(lq, k.shape[2], d):
            s = 1.0 / math.sqrt(d) if scale is None else scale
            return flash_nomax_plain(*(attn_mod._heads(t) for t in (q, k, v)), s
                                     ).reshape(b, h, lq, d)
        return attn_mod.attention(q, k, v, scale, use_flash, int8)

    with k1_tally() as t1, k2_tally() as t2:
        shipped, n_shipped = grads()
    real_attn, real_gn = layers.attention_op, layers.group_norm
    layers.attention_op, layers.group_norm = plain_attention, group_norm_plain
    try:
        plain, n_plain = grads()
    finally:
        layers.attention_op, layers.group_norm = real_attn, real_gn

    def compare(a):
        return cosine(a, plain), float((a - plain).norm() / plain.norm())
    cos, rel = compare(shipped)

    # the controls: the same step with K1's outputs cut from autograd at its
    # 5 sites (K2 kept), and with K2's cut at every norm but conv_norm_out
    # (K1 kept; cut there too, the loss has no graph and `backward` raises)
    real_k2_apply, keep = gn_mod._GroupNormFn.apply, []

    def k2_cut(x, s, b, *args):
        if keep:
            return real_k2_apply(x, s, b, *args)
        return gn_mod._group_norm_launch(x, s, b, *args).detach()
    hooks = [unet.conv_norm_out.register_forward_pre_hook(lambda m, i: keep.append(1)),
             unet.conv_norm_out.register_forward_hook(lambda m, i, o: keep.clear())]
    controls = {}
    try:
        for label, fn, cut in (
                ("K1 cut", attn_mod._RecomputeAttnFn,
                 lambda q, k, v, scale, kernel: kernel(q, k, v, scale).detach()),
                ("K2 cut but at conv_norm_out", gn_mod._GroupNormFn, k2_cut)):
            fn.apply = staticmethod(cut)
            try:
                got, n = grads()
            finally:
                del fn.apply            # the inherited `Function.apply` again
            require(got is not None and n == n_shipped,
                    f"the control with {label}: a graph, and launches {n} (want {n_shipped})")
            controls[label] = compare(got)
    finally:
        for h in hooks:
            h.remove()
    print(f"disconnect check: adapter gradients through K1 and K2 (launches {n_shipped}) "
          f"vs plain autograd (launches {n_plain}): cosine {cos:.6f}, rel-L2 {rel:.3e} "
          f"(bounds {DISCONNECT_COS}, {DISCONNECT_REL_L2}); controls: "
          + "; ".join(f"{k}: cosine {c:.6f}, rel-L2 {r:.3e}" for k, (c, r) in controls.items()),
          flush=True)
    require(n_shipped == (K1_PER_TRAIN_STEP, group_norms(unet)) and n_plain == (0, 0),
            "the shipped step went through K1 and K2, the plain one through neither")
    require(cos >= DISCONNECT_COS and rel <= DISCONNECT_REL_L2,
            "the adapter gradients through the kernels match the plain autograd")
    for label, (c, r) in controls.items():
        require(c < DISCONNECT_COS or r > DISCONNECT_REL_L2,
                f"the check tells the gradient with {label} from the right one")
    shutil.rmtree(ckdir)
    return runs, {"cos": cos, "rel": rel, "controls": controls, "k1_by_shape": dict(t1),
                  "k2_by_shape": dict(t2), "launches": n_shipped}


def distill_phase(dev):
    """`LCMDistiller` at full width (SD15_IP2P_UNET teacher seeded in fp32 on
    the card), DISTILL_BATCH at DISTILL_RES, DISTILL_STEPS steps: finite
    losses, every master leaf moved, the bf16 weights equal to the masters
    rounded, the EMA rule exact, the teacher unchanged, K1 30 a step (by
    shape), peak GiB. Then `ModelZoo(ZooConfig(lcm_steps=4)).ip2p()` with
    the student's masters loaded into its IP2P UNet serves one 512 px
    request: 4 UNet calls at one row, K1 exactly 40. K1 and K2 are tallied
    by shape over the steps and over the request."""
    import torch
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig
    from anyedit_tpu_torch.train.distill import DistillConfig, LCMDistiller
    from anyedit_tpu_torch.weights.init import seeded_init_

    torch.cuda.reset_peak_memory_stats()
    fp32 = dataclasses.replace(SD15_IP2P_UNET, dtype=torch.float32)
    teacher_sd = seeded_init_(UNet2DCondition(fp32, device=dev), 0).state_dict()
    dist = LCMDistiller(DistillConfig(unet=SD15_IP2P_UNET), device=dev)
    teacher, student, ema, opt = dist.init(teacher_sd)
    del teacher_sd
    t0 = [p.detach().clone() for p in teacher.parameters()]
    m0 = {k: v.clone() for k, v in student.masters.items()}
    g = torch.Generator(device=dev).manual_seed(3)
    zoo_cfg = ZooConfig(lcm_steps=LCM_STEPS)
    hw = DISTILL_RES // zoo_cfg.canvas.latent_down
    dc = SD15_IP2P_UNET.context_dim
    batch = {"edited_latents": torch.randn(DISTILL_BATCH, hw, hw, 4, generator=g, device=dev),
             "orig_latents": torch.randn(DISTILL_BATCH, hw, hw, 4, generator=g, device=dev),
             "text_emb": torch.randn(DISTILL_BATCH, 77, dc, generator=g, device=dev),
             "uncond_emb": torch.randn(DISTILL_BATCH, 77, dc, generator=g, device=dev)}
    losses, log, tallies = [], [], []
    for _ in range(DISTILL_STEPS):
        draws = dist.draw(g, batch)
        e_prev = {k: v.clone() for k, v in ema.masters.items()}
        with counted(LCMDistiller, "distill_step", log), k1_tally() as t1, \
                k2_tally() as t2:
            student, ema, opt, loss = dist.distill_step(student, ema, opt, teacher, batch,
                                                        draws)
        tallies.append((dict(t1), dict(t2)))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = sum(int((student.masters[k] != m0[k]).sum()) for k in m0)
    total = sum(v.numel() for v in m0.values())
    rounded = all(torch.equal(p.detach(), student.masters[k].to(p.dtype))
                  for k, p in student.unet.named_parameters())
    d = dist.cfg.ema_decay
    ema_exact = all(torch.equal(ema.masters[k], d * e_prev[k] + (1.0 - d) * student.masters[k])
                    for k in e_prev)
    teacher_same = all(torch.equal(a, b.detach()) for a, b in zip(t0, teacher.parameters()))
    print(f"distill: losses {losses}; step s {[round(x[2], 4) for x in log]}; launches a step "
          f"{[x[:2] for x in log]}, K1 by shape {tallies[-1][0]}; master elements moved {changed} of "
          f"{total}; bf16 weights = masters rounded {rounded}; EMA rule exact {ema_exact}; "
          f"teacher unchanged {teacher_same}; peak {peak:.2f} GiB", flush=True)
    require(all(np.isfinite(losses)), "finite distillation losses")
    require(changed >= 0.9 * total, "the student's fp32 masters moved")
    require(rounded and ema_exact and teacher_same,
            "bf16 weights = masters rounded, EMA exact, teacher unchanged")
    require(all(x[0] == K1_PER_DISTILL_STEP for x in log),
            f"K1 {K1_PER_DISTILL_STEP} a distillation step")
    masters = student.masters
    del teacher, student, ema, opt, t0, m0, e_prev
    gc.collect()
    torch.cuda.empty_cache()

    zoo = ModelZoo(zoo_cfg, dev, seed=0)
    unet = zoo._ip2p_core()[0]
    unet.load_state_dict(masters)
    del masters
    rows = []
    hook = unet.register_forward_pre_hook(lambda m, a: rows.append(a[0].shape[0]))
    img = np.random.default_rng(4).integers(0, 256, (DISTILL_RES, DISTILL_RES, 3), np.uint8)
    edit = zoo.ip2p()
    edit(img, "make it snowy", None, seed=1)          # warm-up
    rows.clear()
    torch.cuda.synchronize()
    flash_nomax.launches = group_norm.launches = 0
    t1 = time.perf_counter()
    with k1_tally() as lcm_k1, k2_tally() as lcm_k2:
        out = edit(img, "make it snowy", None, seed=0)
        torch.cuda.synchronize()
    lcm_s = time.perf_counter() - t1
    hook.remove()
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    print(f"LCM request on the student ({LCM_STEPS} steps): {lcm_s:.3f} s, UNet rows {rows}, "
          f"launches {launches}", flush=True)
    require(out.shape == img.shape and out.dtype == np.uint8, "the LCM edit's output")
    require(rows == [1] * LCM_STEPS and launches["flash_nomax"] == K1_PER_UNET_CALL * LCM_STEPS,
            f"{LCM_STEPS} UNet calls at one row, K1 {K1_PER_UNET_CALL * LCM_STEPS}")
    del zoo, unet
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": [x[2] for x in log], "step_launches":
            [x[:2] for x in log], "k1_by_shape": tallies[-1][0],
            "k2_by_shape": tallies[-1][1], "peak_gib": peak,
            "k1_run": sum((collections.Counter(t) for t, _ in tallies), collections.Counter()),
            "k2_run": sum((collections.Counter(t) for _, t in tallies), collections.Counter()),
            "lcm_s": lcm_s, "lcm_launches": launches, "lcm_k1": dict(lcm_k1),
            "lcm_k2": dict(lcm_k2)}

# ---- slice 7a: the factory's command line ---------------------------------------

CLI_RECORDS = [
    {"edit": "make it look like a warm sunset", "input": "a red square on a blue wall",
     "output": "a red square on a blue wall at sunset", "edit_type": "tone_transfer",
     "image_file": "tone.png"},
    {"edit": "turn the square green", "edited object": "square",
     "input": "a red square on a blue wall", "output": "a green square on a blue wall",
     "edit_type": "color_alter", "image_file": "color.png"},
    {"edit": "remove the square", "edited object": "square",
     "input": "a red square on a blue wall", "output": "a blue wall",
     "edit_type": "remove", "image_file": "remove.png"},
    {"edit": "a red square on a blue wall", "input": "a red square on a blue wall",
     "output": "a red square on a blue wall", "edit_type": "visual_depth",
     "image_file": "depth.png"},
]
# the slots a tone_transfer run builds (ground, inpaint, ip2p, the gate
# scorers), with the layout each is written in for the round trip
CLI_PATH = ("cli run: tone_transfer, color_alter, remove and visual_depth records in one chunk "
            "(ground batch 8, the gates off)")
CLI_ROUND_TRIP = ("gdino", "sam", "lama", "unet_ip2p", "vae", "clip_text", "clip_vision",
                  "clip_text_proj", "aesthetic")


def cli_tokenizer_assets(d: Path) -> None:
    """A small WordPiece `vocab.txt` and CLIP merges (`clip_merges.txt`): a
    weights dir needs tokenizer assets, as in the JAX zoo."""
    d.mkdir(parents=True, exist_ok=True)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ","]
    words += [chr(c) for c in range(97, 123)] + ["##" + chr(c) for c in range(97, 123)]
    words += ["a", "red", "square", "on", "blue", "wall", "green", "the", "make", "it"]
    (d / "vocab.txt").write_text("\n".join(words) + "\n")
    merges = ["s q", "r e", "e d</w>", "a r", "sq u", "squ ar", "squar e</w>", "b l", "bl u",
              "blu e</w>", "w a", "wa l", "wal l</w>"]
    (d / "clip_merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")


def cli_images(root: Path) -> None:
    """Seeded 480x640 PNGs: a red square on a blue wall with noise."""
    from anyedit_tpu_torch.core.png import write_png
    rng = np.random.default_rng(71)
    root.mkdir(parents=True, exist_ok=True)
    for rec in CLI_RECORDS:
        img = np.zeros((480, 640, 3), np.float32)
        img[...] = (40, 70, 190)
        img[140:340, 220:420] = (200, 30, 30)
        img += rng.normal(0, 12, img.shape)
        write_png(root / rec["image_file"], np.clip(img, 0, 255).astype(np.uint8))


def cli_main(argv) -> tuple[int, str]:
    """`cli.main(argv)` with its standard output captured: (code, output)."""
    import io

    from anyedit_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def cli_write_records(path: Path, recs) -> Path:
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return path


@contextlib.contextmanager
def executor_timed(timing: dict, profiled: bool = False):
    """`FactoryExecutor.run` timed on the host clock around a device
    synchronise; `profiled`: under `torch.profiler` recording the device's
    events only, with their seconds as "busy_s". As `timed_rows` takes them,
    the time comes from a run without the profiler (whose per-launch cost
    lengthens a host-bound run) and the busy seconds from another run of
    the same work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anyedit_tpu_torch.runtime.executor import FactoryExecutor

    real = FactoryExecutor.run

    def run(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) if profiled \
                else contextlib.nullcontext() as prof:
            out = real(self, *args, **kwargs)
            torch.cuda.synchronize()
        timing["run_s"] = time.perf_counter() - t0
        if profiled:
            us = 0.0
            for e in prof.key_averages():
                t = getattr(e, "self_device_time_total", None)
                t = e.self_cuda_time_total if t is None else t
                if e.device_type == DeviceType.CUDA and t > 0:
                    us += t
            timing["busy_s"] = us / 1e6
        return out
    FactoryExecutor.run = run
    try:
        yield timing
    finally:
        FactoryExecutor.run = real


@contextlib.contextmanager
def unets_built(log: list):
    """Every UNet2DCondition constructed inside the block (its config)."""
    from anyedit_tpu_torch.models.unet_sd import UNet2DCondition
    real = UNet2DCondition.__init__

    def init(self, cfg, *args, **kwargs):
        log.append(cfg)
        real(self, cfg, *args, **kwargs)
    UNet2DCondition.__init__ = init
    try:
        yield log
    finally:
        UNet2DCondition.__init__ = real


def cli_official_sources(dev, src: Path) -> dict:
    """The seeded state dicts of CLI_ROUND_TRIP's slots (`ModelZoo()` on
    the card, seed 0: the tensors a seeded `run` draws), written under the
    official names: {slot: path}."""
    import torch

    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig
    from anyedit_tpu_torch.weights import bootstrap
    from anyedit_tpu_torch.weights.files import write_safetensors

    zoo = ModelZoo(ZooConfig(), dev, seed=0)
    c = zoo.cfg
    get = {"gdino": zoo._gdino, "sam": zoo._sam, "lama": zoo._lama,
           "unet_ip2p": lambda: zoo._ip2p_core()[0], "vae": zoo._vae,
           "clip_text": lambda: zoo._text_model("clip_text", c.text),
           "clip_vision": lambda: zoo._vision("clip_vision", c.vision),
           "clip_text_proj": zoo._text_proj, "aesthetic": zoo._aesthetic_mlp}
    paths = {}
    src.mkdir(parents=True, exist_ok=True)
    for name in CLI_ROUND_TRIP:
        m = get[name]()
        sd = {k: v.detach().cpu() for k, v in m.state_dict().items()}
        hint = ({"vision_encoder.x"} if name == "sam"          # the HF mirror's layout
                else {"generator." + next(iter(sd))} if name == "lama" else set(sd))
        off = bootstrap.official_state(bootstrap.plan_for(name, m, hint), sd)
        if name == "aesthetic":
            paths[name] = src / "sac+logos+ava1-l14-linearMSE.pth"
            torch.save(off, paths[name])
        elif name == "unet_ip2p":
            paths[name] = d = src / "unet"
            keys = list(off)
            shards = {f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors": part
                      for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:]))}
            for fname, part in shards.items():
                write_safetensors(d / fname, {k: off[k] for k in part})
            (d / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps(
                {"weight_map": {k: f for f, part in shards.items() for k in part}}))
        else:
            paths[name] = src / f"{name}.safetensors"
            write_safetensors(paths[name], off)
    del zoo, get
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---- slice 7b: `distill` on the command line and the fast mode it feeds -------

# `distill` at full width on the round trip's converted weights: 2 steps at
# batch 2 and 512 px (the JAX defaults' batch of 8 cut for chip time), one
# held-out eval pair. K1: 30 a step (the teacher at 3 x 2 rows, the student
# and the EMA target at 2), then the teacher's 50-step eval edit at 3 rows
# and the student's 4 steps at one row, 10 a UNet call: 600.
DISTILL_CLI_STEPS, DISTILL_CLI_DDIM = 2, 50
DISTILL_CLI_K1 = (DISTILL_CLI_STEPS * K1_PER_DISTILL_STEP
                  + (DISTILL_CLI_DDIM + LCM_STEPS) * K1_PER_UNET_CALL)
# the `quality` keys of the JAX command's readout (anyedit_tpu/cli.py:615-625)
DISTILL_QUALITY_KEYS = {"pairs", "teacher_steps", "student_steps",
                        "latent_l1_teacher_vs_student", "pixel_l1_teacher_vs_student",
                        "pixel_l1_teacher_vs_orig", "eval_dirs", "next"}
CLI_PATHS = {"cli": CLI_PATH,
             "cli_distill": "cli distill: 2 steps at batch 2, 512 px (the teacher at 3 x 2 rows, "
                            "the student and the EMA target at 2, the VAE encoder at batch 2), "
                            "then one eval pair (the teacher's 50-step edit at 3 rows, the "
                            "student's 4 steps at one, the VAE at batch 1)",
             "cli_lcm": "cli run --lcm-steps 4: the tone_transfer record on the distilled "
                        "student (4 UNet calls at one row)"}


def cli_fast_mode(dev, root: Path, wdir: Path, base: list, ledger: Path, image_root: Path,
                  fallback: tuple):
    """Phase 28's `distill` -> `run --lcm-steps` -> `eval` chain and `convert
    --plan` (see the module docstring). `wdir` holds the round trip's
    converted slots; `fallback` is the train phase's ungated (ledger, image
    root), taken when the run's ledger has fewer than two trainable
    successes. Returns ({path: {kernel: launches}}, {path: K1 tally},
    {path: K2 tally}, numbers)."""
    import torch

    import anyedit_tpu_torch.diffusion.ip2p as ip2p_mod
    import anyedit_tpu_torch.train.distill as distill_mod
    from anyedit_tpu_torch.models.unet_sd import SD15_IP2P_UNET, UNet2DCondition
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm
    from anyedit_tpu_torch.runtime import zoo as zoo_mod
    from anyedit_tpu_torch.train.data import examples_from_ledger
    from anyedit_tpu_torch.weights.bootstrap import REGISTRY
    from anyedit_tpu_torch.weights.files import read_safetensors

    launches, k1, k2, nums = {}, {}, {}, {}
    n_ex = len(examples_from_ledger(ledger, image_root))
    if n_ex < 2:
        ledger, image_root = fallback
        n_ex = len(examples_from_ledger(ledger, image_root))
    ck = root / "distill_ckpt"
    steps, teacher_calls, student_calls = [], [], []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_nomax.launches = group_norm.launches = 0
    with k1_tally() as k1t, k2_tally() as k2t, \
            counted(distill_mod.LCMDistiller, "distill_step", steps), \
            counted(ip2p_mod, "ip2p_edit", teacher_calls), \
            counted(distill_mod, "lcm_edit", student_calls):
        t0 = time.perf_counter()
        rc, text = cli_main(["distill", "--ledger", str(ledger), "--image-root", str(image_root),
                             "--weights-dir", str(wdir), "--require-weights",
                             "--steps", str(DISTILL_CLI_STEPS), "--batch-size", "2",
                             "--resolution", "512", "--ddim-steps", str(DISTILL_CLI_DDIM),
                             "--lcm-steps", str(LCM_STEPS), "--eval-count", "1",
                             "--checkpoint-dir", str(ck), "--log-every", "1",
                             "--device", "cuda"])
        torch.cuda.synchronize()
        nums["distill_command_s"] = time.perf_counter() - t0
    launches["cli_distill"] = {"flash_nomax": flash_nomax.launches,
                               "group_norm": group_norm.launches}
    k1["cli_distill"], k2["cli_distill"] = dict(k1t), dict(k2t)
    nums["distill_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [json.loads(x)["loss"] for x in text.splitlines() if x.startswith('{"step"')]
    report = json.loads(text[text.rindex("\n{") + 1:])
    q = report.get("quality", {})
    nums.update(distill_losses=losses, distill_step_s=[x[2] for x in steps],
                teacher_eval_s=[x[2] for x in teacher_calls],
                student_eval_s=[x[2] for x in student_calls], quality=q)
    print(f"cli distill on {n_ex} trainable examples ({ledger.name} under {image_root.name}): rc "
          f"{rc}, losses {losses}, step s {[round(x, 4) for x in nums['distill_step_s']]}, "
          f"launches {launches['cli_distill']} (a step {[x[:2] for x in steps]}), K1 by shape "
          f"{k1['cli_distill']}; eval: the teacher's {DISTILL_CLI_DDIM}-step edit "
          f"{[round(x[2], 4) for x in teacher_calls]} s (K1 {[x[0] for x in teacher_calls]}), the "
          f"student's {LCM_STEPS} steps {[round(x[2], 4) for x in student_calls]} s (K1 "
          f"{[x[0] for x in student_calls]}); quality {q}; the command "
          f"{nums['distill_command_s']:.2f} s, peak {nums['distill_peak_gib']:.2f} GiB",
          flush=True)
    require(rc == 0 and len(losses) == DISTILL_CLI_STEPS and all(map(math.isfinite, losses)),
            "distill exits 0 with finite losses")
    require(set(q) == DISTILL_QUALITY_KEYS and q["pairs"] == 1,
            "the quality readout has the JAX command's keys")
    require(launches["cli_distill"]["flash_nomax"] == DISTILL_CLI_K1
            and sum(k1t.values()) == DISTILL_CLI_K1,
            f"K1 exactly {DISTILL_CLI_K1} in the distill command")
    require([x[0] for x in steps] == [K1_PER_DISTILL_STEP] * DISTILL_CLI_STEPS
            and [x[0] for x in teacher_calls] == [DISTILL_CLI_DDIM * K1_PER_UNET_CALL]
            and [x[0] for x in student_calls] == [LCM_STEPS * K1_PER_UNET_CALL],
            "K1 30 a step, 500 in the teacher's eval edit, 40 in the student's")
    student_path = wdir / "unet_ip2p_lcm.safetensors"
    require(report["student_checkpoint"] == str(student_path) and student_path.exists(),
            "the student is written to <weights-dir>/unet_ip2p_lcm.safetensors")
    student = read_safetensors(student_path)
    teacher = read_safetensors(wdir / "unet_ip2p.safetensors")
    keys = set(UNet2DCondition(SD15_IP2P_UNET, device="meta").state_dict())
    finite = all(bool(torch.isfinite(v).all()) for v in student.values())
    differs = any(not torch.equal(v.float(), teacher[k].float()) for k, v in student.items())
    require(set(student) == keys and finite and differs,
            "the student holds every UNet key, finite, and differs from the teacher")
    del student, teacher
    for name in ("eval_teacher", "eval_student"):
        require(len((ck / name / "ledger.jsonl").read_text().splitlines()) == 1
                and len(list((ck / name / "edited_img").glob("*.png"))) == 1,
                f"{name} holds one ledger line and its PNG")
    gc.collect()
    torch.cuda.empty_cache()

    # the fast mode on the command line: the tone_transfer record on the student
    timing, reads = {}, []
    real_read = zoo_mod.read_safetensors

    def read(path):
        reads.append(Path(path))
        return real_read(path)
    zoo_mod.read_safetensors = read
    flash_nomax.launches = group_norm.launches = 0
    try:
        with k1_tally() as lk1, k2_tally() as lk2, executor_timed(timing):
            rc, _ = cli_main(base + ["--output", str(root / "rt_lcm"), "--weights", str(wdir),
                                     "--require-weights", "--lcm-steps", str(LCM_STEPS)])
    finally:
        zoo_mod.read_safetensors = real_read
    launches["cli_lcm"] = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    k1["cli_lcm"], k2["cli_lcm"] = dict(lk1), dict(lk2)
    nums["lcm_record_s"] = timing["run_s"]
    led = [json.loads(x) for x in (root / "rt_lcm" / "ledger.jsonl").read_text().splitlines()]
    print(f"cli run --lcm-steps {LCM_STEPS} of the tone_transfer record: rc {rc}, status "
          f"{[e['status'] for e in led]}, executor {timing['run_s']:.3f} s, launches "
          f"{launches['cli_lcm']}, K1 by shape {k1['cli_lcm']}; the student file read "
          f"{student_path in reads}", flush=True)
    require(rc == 0 and [e["status"] for e in led] == ["success"],
            "run --lcm-steps: the tone_transfer record succeeds")
    require(student_path in reads, "run --lcm-steps loads unet_ip2p_lcm.safetensors")
    require(launches["cli_lcm"]["flash_nomax"] == LCM_STEPS * K1_PER_UNET_CALL,
            f"K1 exactly {LCM_STEPS * K1_PER_UNET_CALL} in run --lcm-steps {LCM_STEPS}")
    gc.collect()
    torch.cuda.empty_cache()

    for name in ("eval_teacher", "eval_student"):
        t0 = time.perf_counter()
        rc, text = cli_main(["eval", "--run-dir", str(ck / name), "--output",
                             str(root / f"{name}.json"), "--device", "cuda"])
        nums[f"{name}_s"] = time.perf_counter() - t0
        table = json.loads(text.strip().splitlines()[-1])
        print(f"cli eval --run-dir {name} ({nums[f'{name}_s']:.3f} s): {table}", flush=True)
        require(rc == 0 and table["overall"]["count"] == 1, f"eval scores {name}")
    gc.collect()
    torch.cuda.empty_cache()

    rc, text = cli_main(["convert", "--plan", str(root / "downloads"), "--weights-dir",
                         str(root / "planned")])
    lines = [x for x in text.splitlines() if "convert --model" in x]
    print(f"cli convert --plan: {len(lines)} convert lines, e.g. {lines[0]}", flush=True)
    require(rc == 0 and len(lines) == len(REGISTRY)
            and all(x.startswith("python -m anyedit_tpu_torch convert ") and ".safetensors" in x
                    for x in lines),
            "convert --plan names the port's command and a .safetensors output on every line")
    return launches, k1, k2, nums


def cli_phase(dev, fallback: tuple):
    """Phase 28 (see the module docstring); `fallback`: `cli_fast_mode`'s.
    Returns ({path: {kernel: launches}}, {path: {K1 shape: launches}},
    {path: K2 tally}, numbers) for the paths of CLI_PATHS."""
    import torch

    from anyedit_tpu_torch.core.png import read_png
    from anyedit_tpu_torch.ops.attention import flash_nomax
    from anyedit_tpu_torch.ops.groupnorm import group_norm

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    imgs, out = root / "img", root / "run"
    cli_images(imgs)
    recs = cli_write_records(root / "records.jsonl", CLI_RECORDS)
    nums, timing, built = {}, {}, []
    flash_nomax.launches = group_norm.launches = 0
    with k1_tally() as k1t, k2_tally() as k2t, executor_timed(timing), unets_built(built):
        t0 = time.perf_counter()
        rc, text = cli_main(["run", "--instruction-json", str(recs), "--image-root", str(imgs),
                             "--output", str(out), "--ground-batch", "8", "--no-filters",
                             "--device", "cuda"])
        nums["command_s"] = time.perf_counter() - t0
    launches = {"flash_nomax": flash_nomax.launches, "group_norm": group_norm.launches}
    require(rc == 0, "run exits 0")
    report = json.loads(text)
    ledger = [json.loads(x) for x in (out / "ledger.jsonl").read_text().splitlines()]
    status = {e["record"]["edit_type"]: e["status"] for e in ledger}
    print(f"cli run: statuses {status}; report counts {report['counts']}; launches {launches}; "
          f"UNets built {len(built)}", flush=True)
    require(set(status) == {r["edit_type"] for r in CLI_RECORDS}
            and set(status.values()) <= {"success", "failure", "filtered"},
            "every record of the run has a status in the ledger")
    tone = next(e for e in ledger if e["record"]["edit_type"] == "tone_transfer")
    require(tone["status"] == "success", "the tone_transfer record succeeds with the gates off")
    edited = read_png(tone["payload"]["edited_file"])
    require(edited.shape == (480, 640, 3), "the edited PNG is on disk at the input's size")
    require(launches["flash_nomax"] > 0 and launches["group_norm"] > 0,
            "the run launched K1 and K2")
    require(len(built) == 1, "the run built the IP2P UNet once")
    gc.collect()
    torch.cuda.empty_cache()
    # the same records again, under the profiler: the device's busy seconds
    profiled = {}
    with executor_timed(profiled, profiled=True):
        rc, _ = cli_main(["run", "--instruction-json", str(recs), "--image-root", str(imgs),
                          "--output", str(root / "run_profiled"), "--ground-batch", "8",
                          "--no-filters", "--device", "cuda"])
    require(rc == 0, "the profiled run exits 0")
    n = len(CLI_RECORDS)
    nums.update(run_s=timing["run_s"], busy_s=profiled["busy_s"],
                profiled_run_s=profiled["run_s"], s_per_record=timing["run_s"] / n,
                busy_share=profiled["busy_s"] / timing["run_s"],
                stages_ms={k: v["mean_ms"] for k, v in report["stages"].items()})
    print(f"cli run: executor {timing['run_s']:.3f} s for {n} records "
          f"({nums['s_per_record']:.3f} s a record), device busy {profiled['busy_s']:.3f} s "
          f"({nums['busy_share'] * 100:.1f} %; the profiled run took {profiled['run_s']:.3f} s); "
          f"the command {nums['command_s']:.3f} s with its model builds; stage means (ms, "
          f"host) {nums['stages_ms']}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the repair: a run of only remove records builds no UNet
    built.clear()
    only_remove = cli_write_records(root / "remove.jsonl",
                                    [r for r in CLI_RECORDS if r["edit_type"] == "remove"])
    with unets_built(built):
        rc, _ = cli_main(["run", "--instruction-json", str(only_remove), "--image-root",
                          str(imgs), "--output", str(root / "run_remove"), "--no-filters",
                          "--device", "cuda"])
    require(rc == 0 and not built, "a run of only remove records builds no UNet")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rc, text = cli_main(["eval", "--run-dir", str(out), "--image-root", str(imgs),
                         "--output", str(root / "eval.json"), "--device", "cuda"])
    nums["eval_s"] = time.perf_counter() - t0
    ev = json.loads((root / "eval.json").read_text())
    n_ok = sum(e["status"] == "success" for e in ledger)
    pair = ev["pairs"][0]
    require(rc == 0 and ev["overall"]["count"] == n_ok and 0 <= pair["l1"] <= 1
            and -1 <= pair["ssim"] <= 1 and all(math.isfinite(pair[k]) for k in
                                                ("clip_out", "dir_clip", "dino_sim")),
            "eval scores every success with finite metrics")
    rc, _ = cli_main(["export", "--ledger", str(out / "ledger.jsonl"), "--output",
                      str(root / "export")])
    exported = sorted(p.name for p in (root / "export").iterdir())
    succ = json.loads((root / "export" / f"edit_success_0_{n}.json").read_text())
    require(rc == 0 and len(exported) == 3 and len(succ) == n_ok,
            "export writes the three reference JSONs")
    print(f"cli eval {nums['eval_s']:.3f} s (with its CLIP-L and DINOv2-G builds): overall "
          f"{ev['overall']}; export {exported}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the checkpoint round trip
    tok, wdir = root / "tok", root / "weights"
    cli_tokenizer_assets(tok)
    tone_only = cli_write_records(root / "tone.jsonl", CLI_RECORDS[:1])
    base = ["run", "--instruction-json", str(tone_only), "--image-root", str(imgs),
            "--no-filters", "--device", "cuda"]
    warm, warm_b = {}, {}
    with executor_timed(warm):
        rc, _ = cli_main(base + ["--output", str(root / "rt_memory"), "--weights", str(tok)])
    require(rc == 0, "the seeded run with tokenizer assets exits 0")
    nums["tone_warm_s"] = warm["run_s"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sources = cli_official_sources(dev, root / "official")
    shutil.copytree(tok, wdir)
    for name, path in sources.items():
        rc, _ = cli_main(["convert", "--model", name, "--src", str(path), "--weights-dir",
                          str(wdir)])
        require(rc == 0 and (wdir / f"{name}.safetensors").exists(), f"convert {name}")
    nums["write_convert_s"] = time.perf_counter() - t0
    with executor_timed(warm_b, profiled=True):      # the same record: its busy seconds
        rc, _ = cli_main(base + ["--output", str(root / "rt_files"), "--weights", str(wdir),
                                 "--require-weights"])
    nums["tone_warm_busy_share"] = warm_b["busy_s"] / warm["run_s"]
    print(f"cli run of the tone_transfer record alone: executor {warm['run_s']:.3f} s, device "
          f"busy {warm_b['busy_s']:.3f} s ({nums['tone_warm_busy_share'] * 100:.1f} %; the "
          f"profiled run took {warm_b['run_s']:.3f} s)", flush=True)
    a = (root / "rt_memory" / "edited_img" / "tone.png").read_bytes()
    b = (root / "rt_files" / "edited_img" / "tone.png").read_bytes()
    require(rc == 0 and a == b, "the converted weights give the seeded run's PNG bytes")
    gc.collect()
    torch.cuda.empty_cache()
    (wdir / "gdino.safetensors").rename(root / "gdino.safetensors.away")
    try:
        cli_main(base + ["--output", str(root / "rt_missing"), "--weights", str(wdir),
                         "--require-weights"])
        raised = False
    except FileNotFoundError:
        raised = True
    require(raised, "a missing slot file raises under --require-weights")
    print(f"cli round trip: {len(sources)} slots written under the official names and "
          f"converted in {nums['write_convert_s']:.2f} s; the edited PNG equal byte for byte "
          f"({len(a)} bytes); a missing gdino.safetensors raises", flush=True)
    (root / "gdino.safetensors.away").rename(wdir / "gdino.safetensors")
    gc.collect()
    torch.cuda.empty_cache()

    fast_launches, fast_k1, fast_k2, fast_nums = cli_fast_mode(
        dev, root, wdir, base, out / "ledger.jsonl", imgs, fallback)
    nums.update(fast_nums)
    shutil.rmtree(root)
    gc.collect()
    torch.cuda.empty_cache()
    return ({"cli": launches, **fast_launches}, {"cli": dict(k1t), **fast_k1},
            {"cli": dict(k2t), **fast_k2}, nums)


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
        k1, k2, k3, k4 = check_kernels(dev)
        slice_rows = check_chunk_kernels(dev)

    with phase("int8"):
        check_int8(dev)

    with phase("reference"):
        check_reference(dev)
        check_grounding_reference(dev)

    with phase("scorer reference"):
        check_scorer_reference(dev)

    with phase("inpaint reference"):
        check_inpaint_reference(dev)

    with phase("ultraedit reference"):
        check_ultraedit_reference(dev)

    with phase("synth reference"):
        check_synth_reference(dev)

    with phase("sdxl reference"):
        check_sdxl_reference(dev)

    with phase("visual reference"):
        check_visual_reference(dev)

    with phase("llm reference"):
        check_llm_reference(dev)

    with phase("lama"):
        lama_err, lama_ms = check_lama(dev)

    from anyedit_tpu_torch.runtime.zoo import ModelZoo, ZooConfig
    # box_threshold 0.0: the random detector keeps boxes for the grounding
    # phases; the IP2P slot does not read it
    zoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    with phase("slice"):
        launches, seconds, step_ms = serve_slice(dev, zoo, "bf16")
        print(f"{card_line}: {np.mean(seconds):.3f} s per request, "
              f"{step_ms:.3f} ms per UNet step", flush=True)

    with phase("k3 path"):
        k3_launches, _, _, _ = k3_path(dev, zoo)

    qzoo = ModelZoo(ZooConfig(quant_ip2p=True), dev, seed=0)
    with phase("w8a8 slice"):
        q_launches, q_seconds, q_step_ms = serve_slice(dev, qzoo, "W8A8")
        x, t, ctx = unet_inputs(zoo, dev)
        with torch.inference_mode():
            cos = cosine(qzoo._ip2p_core()[0](x, t, ctx), zoo._ip2p_core()[0](x, t, ctx))
        print(f"{card_line}: W8A8 {np.mean(q_seconds):.3f} s per request, "
              f"{q_step_ms:.3f} ms per UNet step; bf16 {np.mean(seconds):.3f} s, "
              f"{step_ms:.3f} ms; W8A8 vs bf16 UNet call cosine {cos:.5f}", flush=True)
        require(cos > 0.95, "the W8A8 UNet call tracks the bf16 one (cosine > 0.95)")

    with phase("k4 path"):
        k4_launches, _, _ = k4_path(dev, qzoo)
    del qzoo
    torch.cuda.empty_cache()

    with phase("grounding"):
        g_launches, g_ms = grounding(dev, zoo)
        print(f"{card_line}: ground() {g_ms['ground_ms']:.1f} ms", flush=True)

    with phase("color_alter record"):
        k2_per_request, rest = divmod(launches["group_norm"], len(REQUESTS))
        require(rest == 0, "every slice request launched K2 equally often")
        r_launches, r_seconds = color_alter_record(dev, zoo, k2_per_request)
        print(f"{card_line}: {r_seconds['record']:.3f} s per color_alter record", flush=True)

    with phase("scorers"):
        s_ms = scorers(dev, zoo)
        print(f"{card_line}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in s_ms.items()),
              flush=True)

    keep_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ledger_"))
    with phase("executor record"):
        e_launches, e_timing = executor_record(dev, zoo, k2_per_request, keep_root)
        print(f"{card_line}: {e_timing['record_s']:.3f} s per gated executor record",
              flush=True)

    with phase("vila"):
        vila_launches, vl = vila_record(dev, zoo, k2_per_request)
        print(f"{card_line}: color_alter with VILA as the VQA judge {vl['record_s']:.3f} s a "
              f"record; VILA {vl['vila_ms']:.3f} ms a call (bound {vl['bound_ms']:.3f} ms)",
              flush=True)

    with phase("slice 3 records"):
        s3_seconds, sd_s, sd_launches = slice3_records(dev, zoo)
        print(f"{card_line}: background_change {s3_seconds['background_change']:.3f} s "
              f"(SD inpainter {sd_s[0]:.3f} s; warm {sd_s[1]:.3f} s), style_change "
              f"{s3_seconds['style_change']:.3f} s", flush=True)

    with phase("geometry records"):
        geo_launches, geo_tally, geo_seconds = geometry_records(dev, zoo)
        print(f"{card_line}: " + ", ".join(f"{k} {v:.3f} s" for k, v in geo_seconds.items()),
              flush=True)
    del zoo
    torch.cuda.empty_cache()

    with phase("chunk"):
        # the production config: box_threshold 0.25
        ch = chunk(dev, ModelZoo(ZooConfig(), dev, seed=0))
        sec, peak = ch["seconds"], ch["peak"]
        print(f"{card_line}: chunk {sec['chunk']:.3f} s a record (peak "
              f"{peak['chunk']:.2f} GiB), per record {sec['per_record']:.3f} s "
              f"(peak {peak['per_record']:.2f} GiB), bucket of 4 edits {sec['bucket']:.3f} s "
              f"a record (peak {peak['bucket']:.2f} GiB); batched edits within a mean of "
              f"{ch['edit_dist']:.3f} levels of their per-record edits", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # UltraEdit on a zoo of its own (box_threshold 0.0, so the random
    # detector keeps boxes), freed after the phase
    uzoo = ModelZoo(ZooConfig(box_threshold=0.0), dev, seed=0)
    with phase("ultraedit"):
        u_launches, u = ultraedit(dev, uzoo)
        print(f"{card_line}: appearance_alter through UltraEdit {u['record_s']:.3f} s a record "
              f"(edit {u['edit_s']:.3f} s), MMDiT {u['mmdit_ms']:.3f} ms a call, conditioning "
              f"{u['cond_ms']:.2f} ms, peak {u['peak_gib']:.2f} GiB", flush=True)
        ultraedit_mmdit(dev, uzoo, u.pop("args"))
    del uzoo
    gc.collect()
    torch.cuda.empty_cache()

    # the caption-pair synthesizers on a zoo of their own (MasaCtrl and P2P
    # on one SD1.5 UNet; Flux with T5-XXL), freed before the W8A8 Flux
    from anyedit_tpu_torch.edits.types import Toolbox
    szoo = ModelZoo(ZooConfig(), dev, seed=0)
    stb = Toolbox()
    with phase("masactrl / p2p"):
        for slot in ("masactrl", "p2p_pair"):
            szoo.install(stb, slot)
        synth_paths, sy = masactrl_p2p(dev, szoo, stb)
        print(f"{card_line}: action_change {sy['action_change']['record_s']:.3f} s, "
              f"implicit_change {sy['implicit_change']['record_s']:.3f} s a record "
              f"(peak {max(v['peak_gib'] for k, v in sy.items() if k.endswith('change')):.2f} "
              f"GiB)", flush=True)

    with phase("flux"):
        szoo.install(stb, "flux_pair")
        synth_paths["flux"], fx, fargs, fout = flux_phase(dev, szoo, stb)
        synth_paths["ocr"], ocr_nums = ocr_record(dev, szoo, stb)
        del stb, szoo
        gc.collect()
        torch.cuda.empty_cache()
        f_cos, f_qms, f_qpeak = flux_w8a8(dev, fargs, fout)
        print(f"{card_line}: textual_change {fx['record_s']:.3f} s a record (peak "
              f"{fx['peak_gib']:.2f} GiB), Flux {fx['flux_ms']:.3f} ms a call at batch 1 "
              f"(bound {fx['bound_ms']:.3f} ms), W8A8 {f_qms:.3f} ms, cosine {f_cos:.5f} "
              f"(build peak {f_qpeak:.2f} GiB); OCR-gated textual_change "
              f"{ocr_nums['record_s']:.3f} s, {ocr_nums['read_ms']:.2f} ms a read", flush=True)
        synth_rows = synth_k2_rows(dev, {p: t for p, (_, t) in synth_paths.items()})

    # the SDXL refine stack on a zoo of its own (freed before the W8A8 UNet)
    with phase("sdxl"):
        sdxl_paths, sx, sargs, sout = sdxl_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        s_cos, s_qms = sdxl_w8a8(dev, sargs, sout)
        del sargs, sout
        print(f"{card_line}: implicit_change (all four stages) {sx['implicit_s']:.3f} s, "
              f"material_transfer {sx['material_s']:.3f} s a record; SDXL UNet at batch 2 "
              f"{sx['unet_ms']:.3f} ms (bound {sx['bound_ms']:.3f} ms), with ControlNet + "
              f"IP-Adapter {sx['unet_cn_ip_ms']:.3f} ms (bound {sx['cn_ip_bound_ms']:.3f} ms), "
              f"W8A8 {s_qms:.3f} ms, cosine {s_cos:.5f}; peak {sx['peak_gib']:.2f} GiB",
              flush=True)
        held = {key for *_, key in slice_rows if key[1] is not None}
        held |= {key for *_, key in synth_rows}
        sdxl_rows, sdxl_seen = new_k2_rows(dev, {p: t for p, (_, t) in sdxl_paths.items()},
                                           held)
    gc.collect()
    torch.cuda.empty_cache()

    # the visual conditions, rotation, composition and AnyDoor on a zoo of
    # their own (freed after)
    with phase("visual"):
        visual_paths, visual_k1, vx = visual_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{card_line}: " + ", ".join(
            f"{et} {vx[et]['record_s']:.3f} s (busy {vx[et]['busy_share'] * 100:.1f} %, peak "
            f"{vx[et]['peak_gib']:.2f} GiB)" for et in VISUAL_TYPES)
            + f"; AnyDoor UNet + ControlNet at batch 2 {vx['unet_cn_ms']:.3f} ms (bound "
            f"{vx['bound_ms']:.3f} ms)", flush=True)
        held |= {key for *_, key in sdxl_rows}
        visual_rows, visual_seen = new_k2_rows(
            dev, {p: t for p, (_, t) in visual_paths.items() if t}, held)
    gc.collect()
    torch.cuda.empty_cache()

    # Llama-3-8B instruction generation on models of its own (freed after)
    with phase("llm"):
        llm_launches, lx = llm_phase(dev)
        print(f"{card_line}: {lx['batch_s']:.3f} s per batch of {INSTR_BATCH} instruction "
              f"records with the self-check ({lx['records_per_hour']:.1f} records/hour, busy "
              f"{lx['busy_share'] * 100:.1f} %); bf16 prefill {lx['bf16_prefill_ms']:.2f} ms "
              f"(bound {lx['bf16_prefill_bound_ms']:.2f}), decode {lx['bf16_decode_ms']:.3f} ms "
              f"a step (bound {lx['bf16_decode_bound_ms']:.3f}); W8A8 prefill "
              f"{lx['w8a8_prefill_ms']:.2f} ms (bound {lx['w8a8_prefill_bound_ms']:.2f}), "
              f"decode {lx['w8a8_decode_ms']:.3f} ms (bound {lx['w8a8_decode_bound_ms']:.3f}); "
              f"peak {lx['peak_gib']:.2f} GiB", flush=True)

    # AnySD training and LCM distillation (slice 6a), on models of their own
    with phase("train kernels"):
        grad_rows = check_train_kernels(dev)
    gc.collect()
    torch.cuda.empty_cache()

    with phase("train reference"):
        check_train_reference(dev)

    with phase("train"):
        train_runs, disconnect = train_phase(dev, keep_root / "ungated" / "ledger.jsonl",
                                             keep_root / "images")
        step_s = [x for r in train_runs.values() for x in r["step_s"]]
        print(f"{card_line}: AnySD step at batch {TRAIN_BATCH}, {TRAIN_RES} px: median "
              f"{np.median(step_s) * 1e3:.1f} ms a train step (host clock, encode and loading "
              f"outside), {TRAIN_BATCH / np.median(step_s):.1f} samples/s; validation edit "
              f"{train_runs['train_resume']['edit_s'][0]:.3f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    with phase("distill"):
        dx = distill_phase(dev)
        print(f"{card_line}: distillation step at batch {DISTILL_BATCH}, {DISTILL_RES} px "
              f"{np.median(dx['step_s']) * 1e3:.1f} ms, peak {dx['peak_gib']:.2f} GiB; LCM "
              f"request ({LCM_STEPS} steps) {dx['lcm_s']:.3f} s", flush=True)

    # K1 and K2 at every shape the training paths launched them that no
    # earlier row holds: the AnySD step at batch 16 and its VAE encodes, the
    # validation grid's edit, the LCM request at one row
    k1_paths = {p: r["k1_by_shape"] for p, r in train_runs.items()}
    k1_paths.update(distill=dict(dx["k1_run"]), lcm_request=dx["lcm_k1"])
    k2_paths = {p: r["k2_by_shape"] for p, r in train_runs.items()}
    k2_paths.update(distill=dict(dx["k2_run"]), lcm_request=dx["lcm_k2"])
    with phase("train shapes"):
        train_k1_rows = new_k1_rows(dev, k1_paths, set(K1_SHAPES) | {s for s, _ in SLICE_K1})
        held |= {key for *_, key in visual_rows}
        train_k2_rows, train_seen = new_k2_rows(dev, k2_paths, held)

    # the factory's command line (slice 7a), on zoos of its own
    with phase("cli"):
        cli_launches, cli_k1, cli_k2, cx = cli_phase(
            dev, (keep_root / "ungated" / "ledger.jsonl", keep_root / "images"))
        shutil.rmtree(keep_root)
        print(f"{card_line}: run over {len(CLI_RECORDS)} records {cx['s_per_record']:.3f} s a "
              f"record (busy {cx['busy_share'] * 100:.1f} %), the tone_transfer record alone "
              f"{cx['tone_warm_s']:.3f} s (busy "
              f"{cx['tone_warm_busy_share'] * 100:.1f} %), eval {cx['eval_s']:.3f} s; distill "
              f"step at batch 2, 512 px {np.median(cx['distill_step_s']) * 1e3:.1f} ms, the "
              f"eval's teacher edit ({DISTILL_CLI_DDIM} steps) {cx['teacher_eval_s'][0]:.3f} s "
              f"and student edit ({LCM_STEPS} steps) {cx['student_eval_s'][0]:.3f} s, the "
              f"command {cx['distill_command_s']:.2f} s, peak {cx['distill_peak_gib']:.2f} GiB; "
              f"run --lcm-steps {LCM_STEPS} {cx['lcm_record_s']:.3f} s a record against "
              f"{cx['tone_warm_s']:.3f} s at 100 steps", flush=True)
        cli_k1_rows = new_k1_rows(dev, cli_k1, set(K1_SHAPES) | {s for s, _ in SLICE_K1}
                                  | {s for *_, s in train_k1_rows})
        held |= {key for *_, key in train_k2_rows}
        cli_k2_rows, cli_seen = new_k2_rows(dev, cli_k2, held)

    def entry(name, source, replaces, launches, rows):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for _, r in rows),
                "ms": rows[0][1]["ms"], "plain_ms": rows[0][1]["plain_ms"],
                "bound_ms": rows[0][1]["bound_ms"], "bound_by": rows[0][1]["bound_by"],
                "bound_term": rows[0][1]["bound_term"],
                "library_ms": rows[0][1]["library_ms"],
                "library": rows[0][1]["library"],
                "library_kernel": rows[0][1].get("library_kernel"), "shape": rows[0][0],
                "device_ms": rows[0][1].get("device_ms"),
                "library_device_ms": rows[0][1].get("library_device_ms"),
                "kernel_device_ms": rows[0][1].get("kernel_device_ms")}
    kernels = [
        entry("flash_nomax", "anyedit_tpu_torch/csrc/flash_nomax.cu",
              "anyedit_tpu/ops/attention.py:153", launches["flash_nomax"], k1),
        entry("group_norm", "anyedit_tpu_torch/csrc/group_norm.cu",
              "anyedit_tpu/ops/groupnorm.py:160", launches["group_norm"], k2),
        entry("flash_attention", "anyedit_tpu_torch/csrc/flash_attention.cu",
              "anyedit_tpu/ops/attention.py:85", k3_launches, k3),
        entry("flash_int8", "anyedit_tpu_torch/csrc/flash_int8.cu",
              "anyedit_tpu/ops/attention.py:237", k4_launches, k4),
    ]
    for row in kernels[:2]:
        row["launches_w8a8_slice"] = q_launches[row["name"]]
        row["launches_ground"] = g_launches[row["name"]]
        row["launches_color_alter"] = r_launches[row["name"]]
        row["launches_executor_record"] = e_launches[row["name"]]
        row["launches_chunk"] = ch["launches"]["chunk"][row["name"]]
        row["launches_bucket"] = ch["launches"]["bucket"][row["name"]]
        row["launches_vila"] = vila_launches[row["name"]]
        row["launches_llm"] = llm_launches[row["name"]]
    # K1 runs at no shape on the geometry, UltraEdit and caption-pair paths:
    # 0 launches
    kernels[0]["launches_geometry"] = geo_launches["flash_nomax"]
    kernels[0]["launches_ultraedit"] = u_launches["flash_nomax"]
    for path, (launches_p, _) in list(synth_paths.items()) + list(sdxl_paths.items()):
        kernels[0][f"launches_{path}"] = launches_p["flash_nomax"]
    for path, (launches_p, _) in visual_paths.items():
        for row in kernels[:2]:
            row[f"launches_{path}"] = launches_p[row["name"]]
    # this slice's shapes, each its own row, with the kernel's launches in
    # the run of the path that gives it that shape (at that shape, for
    # K2_TALLY_PATHS)
    path_launches = {"sd": sd_launches, **ch["launches"],
                     **{p: launches_p for p, (launches_p, _) in sdxl_paths.items()}}
    tallied = k2_rows_launches({"geometry": geo_tally, "ultraedit": u["k2_tally"]})
    sources = {k["name"]: (k["source"], k["replaces"]) for k in kernels}
    k2_by_key, k1_by_shape = {}, {}
    for name, tag, r, path, key in slice_rows:
        if path in K2_TALLY_PATHS:
            row = entry(name, *sources[name], tallied[key + (path,)], [(tag, r)])
            if path == "geometry":
                row["launches_ultraedit"] = tallied.get(key + ("ultraedit",), 0)
        elif path == "anydoor":           # K1 at its shape: the tally's
            row = entry(name, *sources[name], visual_k1["anydoor"].get(key[0], 0), [(tag, r)])
        else:
            row = entry(name, *sources[name], path_launches[path][name], [(tag, r)])
        if path == "sdxl_implicit":
            row["launches_sdxl_material"] = sdxl_paths["sdxl_material"][0][name]
            row["launches_anydoor"] = visual_k1["anydoor"].get(key[0], 0)
        row["path"] = PATHS[path]
        kernels.append(row)
        if name == "group_norm":
            k2_by_key[key] = row
        else:
            k1_by_shape[key[0]] = row
    # K2 at the caption-pair and refine paths' shapes, each row with the
    # launches at its shape in the first path that gives it, and in the
    # others; a shape an earlier row holds gains the refine paths' launches
    path_names = {**{p: d for p, (_, d) in SYNTH_PATHS.items()},
                  **{p: d for p, (_, d) in SDXL_PATHS.items()}, **VISUAL_PATHS}
    for tag, r, path, per_path, key in synth_rows + sdxl_rows + visual_rows:
        row = entry("group_norm", *sources["group_norm"], per_path[path], [(tag, r)])
        row.update({f"launches_{p}": n for p, n in per_path.items() if p != path})
        row["path"] = path_names[path]
        kernels.append(row)
        k2_by_key[key] = row
    for key, per_path in list(sdxl_seen.items()) + list(visual_seen.items()):
        k2_by_key[key].update({f"launches_{p}": n for p, n in per_path.items()})
    # the training paths' new shapes, each row with the launches at its
    # shape in the first path that gives it, and in the others; a shape an
    # earlier row holds gains the training paths' launches
    for name, new_rows in (("flash_nomax", train_k1_rows), ("group_norm", train_k2_rows)):
        for tag, r, path, per_path, key in new_rows:
            row = entry(name, *sources[name], per_path[path], [(tag, r)])
            row.update({f"launches_{p}": n for p, n in per_path.items() if p != path})
            row["path"] = TRAIN_PATHS[path]
            kernels.append(row)
            (k2_by_key if name == "group_norm" else k1_by_shape)[key] = row
    for key, per_path in train_seen.items():
        k2_by_key[key].update({f"launches_{p}": n for p, n in per_path.items()})
    for path, tally in k1_paths.items():
        for shape, n in tally.items():
            if shape in k1_by_shape:
                k1_by_shape[shape][f"launches_{path}"] = n
    # the backward rows: the Function's recompute backward at the training
    # shapes; `ms` is the backward alone, `fwd_ms` the kernel's forward,
    # launches the kernel's forward launches at that shape in one step (the
    # disconnect check's AnySD step, the last distillation step), by tally
    k1_step = {**disconnect["k1_by_shape"], **dx["k1_by_shape"]}
    k2_step = {**disconnect["k2_by_shape"], **dx["k2_by_shape"]}
    grad_launches = {str(sh): k1_step.get(sh, 0) for sh in K1_GRAD_SHAPES}
    grad_launches.update({f"{sh} {'silu' if silu else 'plain'}":
                          k2_step.get((sh, silu, "torch.bfloat16"), 0)
                          for sh, silu in K2_GRAD_SHAPES})
    for name, tag, r in grad_rows:
        row = entry(name, *sources[name], grad_launches[tag], [(tag, r)])
        row.update({"pass": "backward: autograd of the plain version on the saved inputs "
                            "(sdpa for K1, group_norm_plain for K2), no kernel",
                    "fwd_ms": r["fwd_ms"], "fwd_bwd_ms": r["fwd_bwd_ms"],
                    "library_fwd_bwd_ms": r["library_fwd_bwd_ms"], "rel_l2": r["rel_l2"],
                    "path": "distillation step (batch 2, 512 px: the student with grad, the "
                            "EMA target without)" if tag.startswith(("(16, 4096", "(16, 1024",
                                                                      "(2, "))
                    else "AnySD train step (batch 16, 256 px)"})
        kernels.append(row)
    for i, row in enumerate(kernels[:2]):
        row["launches_train_step"] = train_runs["train"]["step_launches"][-1][i]
        row["launches_train"] = train_runs["train"]["k1" if row["name"] == "flash_nomax"
                                                    else "k2"]
        row["launches_train_resume"] = train_runs["train_resume"][
            "k1" if row["name"] == "flash_nomax" else "k2"]
        row["launches_distill_step"] = dx["step_launches"][-1][
            0 if row["name"] == "flash_nomax" else 1]
        row["launches_lcm_request"] = dx["lcm_launches"][row["name"]]
    for name, new_rows in (("flash_nomax", cli_k1_rows), ("group_norm", cli_k2_rows)):
        for tag, r, path, per_path, key in new_rows:
            row = entry(name, *sources[name], per_path[path], [(tag, r)])
            row.update({f"launches_{p}": n for p, n in per_path.items() if p != path})
            row["path"] = CLI_PATHS[path]
            kernels.append(row)
            (k2_by_key if name == "group_norm" else k1_by_shape)[key] = row
    for key, per_path in cli_seen.items():
        k2_by_key[key].update({f"launches_{p}": n for p, n in per_path.items()})
    for path, tally in cli_k1.items():
        for shape, n in tally.items():
            if shape in k1_by_shape:
                k1_by_shape[shape][f"launches_{path}"] = n
    for row in kernels[:2]:
        for path, counts in cli_launches.items():
            row[f"launches_{path}"] = counts[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
