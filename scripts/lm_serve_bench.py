#!/usr/bin/env python3
"""Arm F's LM serving walls and kernel B6's times without a window or a
softcap, for the ``repro_torch`` package under ``--src``, on one CUDA card.

    python3 scripts/lm_serve_bench.py                     # this checkout
    python3 scripts/lm_serve_bench.py --src OTHER/src --tag parent

Run from the repository root; two trees compared on one card are run in
turns in one call (parent, change, change, parent). Arm F is
``chip_smoke.py``'s, built by its helpers: qwen2.5-32b at full width, 16
of its 64 layers, bfloat16, random weights (seed 0), 8 requests (prompts
256-2,048 tokens, 32 new tokens each) on 4 slots. It is served cold, then
``WARM_RUNS`` times warm (each wall synchronized), then once under the
profiler (``chip_smoke.profile_run``: device busy share and host
launches) over the whole fleet and over its first wave (the first 4
requests), as ``chip_smoke.py`` profiles it. B6 is timed by
``chip_smoke.time_ms`` at arm F's shapes: the bfloat16 and float32 causal
prefill of q [1, 40, 2048, 128], k/v [1, 8, 2048, 128]; the decode of q
[4, 40, 1, 128] over a cache [4, 8, 2084, 128] with kv_len 2,049, whole
(split and combine kernels) and its split kernel alone. Prints the card
as ``nvidia-smi`` names it and one JSON line. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WARM_RUNS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # its helpers; it puts ROOT/src on sys.path

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("lm_serve_bench: no CUDA device visible", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    out = {"tag": args.tag, "package": str(Path(repro_torch.__file__).parent),
           "card": smi}

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda shape, dt: torch.randn(shape, generator=gen, device=dev,
                                        dtype=torch.float32).to(dt)
    times = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q = rnd((1, 40, 2048, 128), dt)
        k, v = rnd((1, 8, 2048, 128), dt), rnd((1, 8, 2048, 128), dt)
        times[f"prefill_{tag}_us"] = 1e3 * cs.time_ms(
            lambda q=q, k=k, v=v: fa.flash_attention(q, k, v, causal=True))
        q = rnd((cs.LM_SLOTS, 40, 1, 128), dt)
        k, v = (rnd((cs.LM_SLOTS, 8, cs.LM_MAX_LEN, 128), dt)
                for _ in range(2))
        times[f"decode_{tag}_us"] = 1e3 * cs.time_ms(
            lambda q=q, k=k, v=v: fa.flash_attention(
                q, k, v, causal=False, kv_len=2049))
        splits, split_len = fa.decode_split_plan(
            cs.LM_MAX_LEN, cs.LM_SLOTS * 8, fa._decode_target_ctas(0))
        times[f"decode_split_alone_{tag}_us"] = 1e3 * cs.time_ms(
            lambda q=q, k=k, v=v: fa.decode_partials(
                q, k, v, kv_len=2049, splits=splits, split_len=split_len))
    out["b6"] = times

    cfg, params = cs.lm_model(cs.LM_LAYERS, "bfloat16", 0, dev)
    fleet = lambda prompts=cs.LM_PROMPTS: cs.lm_requests(
        prompts, cfg.vocab_size, cs.LM_MAX_NEW)
    serve = lambda reqs: cs.serve_lm(cfg, params, reqs, cs.LM_SLOTS,
                                     cs.LM_MAX_LEN, dev)
    _, out["cold_wall_s"], _ = serve(fleet())
    warm = []
    for _ in range(WARM_RUNS):
        st_w, wall, rec = serve(fleet())
        prefill_s = sum(rec["prefill_s"])
        warm.append({"wall_s": wall, "prefill_s": prefill_s,
                     "decode_s_per_tick": (wall - prefill_s) / st_w["ticks"],
                     "ticks": st_w["ticks"]})
    out["warm"] = warm
    keep = ("profiled_wall_us", "device_busy_us", "device_busy_share",
            "host_cuda_launch_kernel")
    for name, prompts in (("profile_fleet", cs.LM_PROMPTS),
                          ("profile_first_wave",
                           cs.LM_PROMPTS[:cs.LM_SLOTS])):
        prof = cs.profile_run(lambda prompts=prompts: serve(fleet(prompts)))
        out[name] = {key: prof[key] for key in keep}
    out["script_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
