"""Instruction-generation throughput of the PyTorch port on one NVIDIA GPU:
the twin of `tools/bench_instructions.py`, on the same workload.

    python3 tools/bench_torch_instructions.py [n_captions] [--int8] [--shots N]

Drives `InstructionGenerator` end to end (the few-shot prompt, greedy decode
on the port's Llama through the batched, bucketed `LlamaBackend`, the parse,
the self-check) at the Llama-3-8B shape: n captions (default 128) from the
subject x scene grid, 5 shots (`--shots`), byte-fallback tokens (no
tokenizer assets ship) with the prompt capped at a 1,024-token bucket, 96
new tokens, batch 8. Random weights emit junk that does not parse, so the
generator skips its own self-check pass; the bench then prices it
explicitly (one eval prompt per caption), as the JAX bench does. One
warm-up batch first.

Weights are fabricated on the card at the model's shapes and dtypes, as the
JAX bench's `fabricate_params` draws them: int8 codes U{-127..127} with
unit scales, vectors at one, matrices N(0, 0.02); no fp32 8B is made.
bf16 by default; `--int8` builds the W8A8 decoder (`LlamaConfig.quant`).

Prints one JSON line: the JAX bench's fields (records/hour, wall, gen and
self-check seconds, the random-weight acceptance and yes rates) and the
card's name and power limit, the prefill ms at (8, 1,024) and the decode
ms a step at batch 8 against 1,120 cache slots, each beside
`chip_smoke.llama_bound_ms`, the device-busy share of one profiled batch
and the peak GiB allocated. Needs CUDA; exits 1 without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402  (the repo root, just put on the path)
    INSTR_BATCH, INSTR_NEW, INSTR_PROMPT, byte_tokenizer, card, device_busy_ms,
    instruction_captions, llama_bound_ms, self_check_prompts,
)


def fabricate(cfg, dev):
    """A Llama of `cfg` on `dev` with fabricated values: int8 codes
    U{-127..127}, every vector (norms, scales) at one, every matrix
    N(0, 0.02), drawn from seed 0 on the device."""
    import torch
    from anyedit_tpu_torch.models.llama import Llama

    m = Llama(cfg, device="meta").to_empty(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for t in list(m.parameters()) + list(m.buffers()):
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev,
                                      dtype=torch.int16))
            elif t.dim() <= 1:
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=g)
    return m.eval().requires_grad_(False)


def main() -> int:
    import torch
    from anyedit_tpu_torch.instructions.generator import InstructionGenerator, LlamaBackend
    from anyedit_tpu_torch.models.llama import LLAMA3_8B
    from anyedit_tpu_torch.ops.kernel_check import time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("n", nargs="?", type=int, default=128)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--shots", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_instructions: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(LLAMA3_8B, quant=args.int8)
    torch.cuda.reset_peak_memory_stats()
    model = fabricate(cfg, dev)
    tokenize, detok = byte_tokenizer(cfg.vocab_size)
    backend = LlamaBackend(model, tokenize, detok, max_new=INSTR_NEW, batch_size=INSTR_BATCH)
    gen = InstructionGenerator(llm=backend, seed=0, n_shots=args.shots)
    captions = instruction_captions(args.n)
    evals = self_check_prompts(captions)

    t0 = time.perf_counter()
    gen.generate("replace", captions[:INSTR_BATCH], batch_size=INSTR_BATCH)
    backend(evals[:INSTR_BATCH])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0

    t0 = time.perf_counter()
    records = gen.generate("replace", captions, batch_size=INSTR_BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    answers = backend(evals)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # real weights: the generator ran its own self-check; do not charge twice
    dt = t1 - t0 if records and len(records) >= len(captions) // 2 else t2 - t0
    batches = -(-args.n // INSTR_BATCH)
    busy_ms = device_busy_ms(lambda: (
        gen.generate("replace", captions[:INSTR_BATCH], batch_size=INSTR_BATCH),
        backend(evals[:INSTR_BATCH])))

    cache_len = INSTR_PROMPT + INSTR_NEW
    with torch.inference_mode():
        emb = model.embed(torch.ones(INSTR_BATCH, INSTR_PROMPT, dtype=torch.int64, device=dev))
        tok = model.embed(torch.ones(INSTR_BATCH, 1, dtype=torch.int64, device=dev))
        _, caches = model.prefill(emb, cache_len)
        prefill_ms = time_ms(lambda: model.prefill(emb, cache_len), iters=3)
        decode_ms = time_ms(lambda: model.decode_step(tok, caches, INSTR_PROMPT), iters=20)
    pre_b = llama_bound_ms(model, INSTR_BATCH, INSTR_PROMPT, INSTR_PROMPT)
    dec_b = llama_bound_ms(model, INSTR_BATCH, 1, cache_len)
    name = "Llama-3-8B W8A8" if args.int8 else "Llama-3-8B bf16"
    print(json.dumps({
        "metric": "instruction records/hour/chip (%s, %d-tok prompt bucket, %d new tokens, "
                  "batch %d, greedy + self-check)" % (name, INSTR_PROMPT, INSTR_NEW,
                                                      INSTR_BATCH),
        "value": args.n / dt * 3600.0,
        "unit": "records/hour/chip",
        "captions": args.n,
        "shots": args.shots,
        "wall_s": dt,
        "gen_s": t1 - t0,
        "selfcheck_s": t2 - t1,
        "warmup_s": warm,
        "accept_rate_randweights": len(records) / args.n,
        "yes_rate_selfcheck": sum(a.strip().lower().startswith("yes")
                                  for a in answers) / args.n,
        "card": card(),
        "batch_s": dt / batches,
        "prefill_ms": prefill_ms, "prefill_bound_ms": pre_b[0], "prefill_bound_by": pre_b[1],
        "decode_ms": decode_ms, "decode_bound_ms": dec_b[0], "decode_bound_by": dec_b[1],
        "busy_share": busy_ms / (dt / batches * 1e3),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "note": "acceptance rate is noise at random weights; throughput prices the full "
                "gen + self-check decode budget per caption",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
