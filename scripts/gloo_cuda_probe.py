#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors as they are, on one card.

    python3 scripts/gloo_cuda_probe.py     # from the repository root

Starts two gloo ranks with the ``spawn`` method on card 0 (the layout of
``chip_smoke.py``'s phase P2) and runs each collective the port's
process-group layer (``repro_torch.parallel.dist``) uses on CUDA tensors
handed to ``torch.distributed`` directly: broadcast, all-reduce SUM and
MAX, all-gather of float32 and bool, and a paired send / receive. Each is
reported as "ok" (the values are right), "wrong values" or the error it
raised, or "aborted the process" (then the rank's exit code is
negative). Prints the card as ``nvidia-smi`` names it and one JSON
line.
Imports nothing of JAX.
"""
from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import subprocess
import sys
import tempfile
from pathlib import Path


def _probe(fn) -> str:
    try:
        return "ok" if fn() else "wrong values"
    except Exception as e:  # the probe records what each op raises
        return f"raised {type(e).__name__}: {str(e)[:160]}"


def rank_main(rank: int, world: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    other = 1 - rank

    def bcast():
        t = torch.full((5,), float(rank + 1), device=dev)
        dist.broadcast(t, src=0)
        return bool((t == 1.0).all())

    def reduce(op, want):
        t = torch.full((5,), float(rank + 1), device=dev)
        dist.all_reduce(t, op=op)
        return bool((t == want).all())

    def gather(dtype):
        t = torch.full((3,), rank, device=dev).to(dtype)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return all(bool((p == torch.full((3,), r, device=dev).to(dtype)
                         ).all()) for r, p in enumerate(parts))

    def sendrecv():
        t = torch.full((5,), float(rank + 1), device=dev)
        got = torch.zeros_like(t)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, other),
            dist.P2POp(dist.irecv, got, other)])
        for w in works:
            w.wait()
        torch.cuda.synchronize()
        return bool((got == float(other + 1)).all())

    res = {}
    for name, fn in (
            ("broadcast", bcast),
            ("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM, 3.0)),
            ("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX, 2.0)),
            ("all_gather_float32", lambda: gather(torch.float32)),
            ("all_gather_bool", lambda: gather(torch.bool)),
            ("send_recv", sendrecv)):
        # written before each op too: an op that aborts the process
        # leaves "aborted the process" on record
        res[name] = "aborted the process"
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(res))
        res[name] = _probe(fn)
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}; torch {torch.__version__}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, 2, tmp))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        stalled = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        res = {f"rank {r}": json.loads(Path(tmp, f"rank{r}.json").read_text())
               for r in range(2) if Path(tmp, f"rank{r}.json").exists()}
        codes = [p.exitcode for p in procs]
    print(json.dumps({"gloo_cuda": res, "stalled": stalled,
                      "exit_codes": codes, "card": smi}))
    return 1 if stalled or len(res) < 2 else 0


if __name__ == "__main__":
    sys.exit(main())
