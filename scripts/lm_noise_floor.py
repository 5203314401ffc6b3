#!/usr/bin/env python3
"""How far apart the bfloat16 prefill logits of correct attention
implementations land at qwen2.5-32b's full width, by depth.

    python3 scripts/lm_noise_floor.py      # from the repository root; one CUDA card

Builds arm F's model of ``chip_smoke.py`` (16 layers, bfloat16, random
weights, seed 0) and, for depths 1, 2, 4, 8 and 16 (the first layers of
it) and its first three requests (prompts of 2048, 1536 and 1024
tokens), runs the prefill with four attentions: kernel B6, its plain
version (fp32 softmax), ``chip_smoke.attention_reference`` (float64) and
``scaled_dot_product_attention`` (the library's, used here only). Prints
one JSON line per (depth, prompt) with the max and RMS distance of each
pair over the 152,064 logits and each one's greedy token. This is the
noise floor that F2 of ``chip_smoke.py`` is set against. Imports nothing
of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DEPTHS = (1, 2, 4, 8, 16)
PAIRS = (("kernel", "plain"), ("plain", "f64"), ("kernel", "f64"),
         ("sdpa", "plain"), ("sdpa", "f64"))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("lm_noise_floor: no CUDA device visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q, k, v, *, causal=True, sm_scale=None, kv_len=None):
        return sdpa(q, k, v, is_causal=causal, scale=sm_scale,
                    enable_gqa=True)

    real = fa.flash_attention
    impls = {"kernel": real, "plain": fa.flash_attention_plain,
             "f64": cs.attention_reference, "sdpa": library}
    cfg16, params = cs.lm_model(cs.LM_LAYERS, "bfloat16", 0, dev)
    reqs = cs.lm_requests(cs.LM_PROMPTS, cfg16.vocab_size, cs.LM_MAX_NEW)
    for depth in DEPTHS:
        cfg = cfg16.with_(num_layers=depth)
        p = dict(params, layers=params["layers"][:depth])
        prefill = lm.make_prefill_step(cfg, cs.LM_MAX_LEN)
        for r in reqs[:3]:
            tokens = torch.as_tensor(r.prompt[None].astype(np.int64),
                                     device=dev)
            out = {}
            for name, fn in impls.items():
                fa.flash_attention = fn
                try:
                    out[name], _ = prefill(p, {"tokens": tokens})
                finally:
                    fa.flash_attention = real
            row = {"layers": depth, "prompt": len(r.prompt),
                   "logit_rms": float(out["plain"].pow(2).mean().sqrt()),
                   "argmax": {n: int(o.argmax()) for n, o in out.items()}}
            for a, b in PAIRS:
                d = (out[a] - out[b]).abs()
                row[f"{a}-{b}"] = {"max": float(d.max()),
                                   "rms": float(d.pow(2).mean().sqrt())}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
