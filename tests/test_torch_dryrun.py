"""The dry-run launcher (``repro_torch.launch.dryrun``, the twin of the
reference's ``repro.launch.dryrun``) on the CPU.

* The real run: the train step ``build_lm_cell`` lays out (qwen2.5-32b's
  and moonshot-v1-16b-a3b's ``REDUCED`` configs in float32, batch 4 of 16
  tokens) run for real on a (2, 2) (data, model) mesh of four gloo ranks
  (one launch, ``tests/torch_ranks.py``) under the mesh context: its loss
  and every grad within rtol 1e-5 (+ 1e-5 x the leaf's largest magnitude)
  of the one-device step's (moonshot takes MoE's expert-parallel branch
  there); its whole step, AdamW in place, runs on the laid-out moments.
  The prefill and decode cells' layouts likewise: the logits of a prefill
  and of one decode step (the KV cache split over its sequence) and the
  caches after it, within 1e-4 of one device.
* Both counts agree: rank 0's counted FLOPs of that step equal the trace
  of the same cell on meta tensors under a fake process group.
* The CLI: ``python -m repro_torch.launch.dryrun --arch qwen2.5-32b
  --shape train_4k --mesh single --set num_layers=2 --device cpu`` and one
  NeRF cell (``cicero-dvgo``), each in a subprocess: the JSON report, its
  args' bytes a rank equal to the sum of the rank's blocks, its FLOPs
  positive and, for the LM cell, at least the model FLOPs without the
  embedding's share (see :func:`test_cli_writes_an_lm_report`).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel.sharding import local_block

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("train_tiny", seq_len=16, global_batch=4, kind="train")
ARCHS = ["qwen2.5-32b", "moonshot-v1-16b-a3b"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return registry.get_reduced(arch).with_(dtype="float32")


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def cases():
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(i),
                                device="cpu")
        rng = np.random.default_rng(i)
        tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        targets = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        out[arch] = (cfg, SHAPE, _numpy(params),
                     {"tokens": tokens, "targets": targets})
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    return torch_ranks.launch(torch_ranks.dryrun_train_rank, 4,
                              tmp_path_factory.mktemp("dryrun_ranks"), cases)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(float(np.abs(want).max()),
                                              1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_laid_out_train_step_matches_one_device(arch, cases, ranks):
    """Loss and every grad on every rank against the one-device step on the
    same values; the whole laid-out step (AdamW in place) ran and moved
    every param that has a gradient."""
    cfg, _, params, batch = cases[arch]
    loss, _, grads = lm.loss_and_grads(_tensors(params), _tensors(batch),
                                       cfg)
    want_grads = [g.numpy() for g in tree_flatten(grads)[0]]
    before = [np.asarray(t) for t in tree_flatten(_tensors(params))[0]]
    for rank in ranks:
        res = rank[arch]
        np.testing.assert_allclose(res["loss"], float(loss), rtol=1e-5)
        assert len(res["grads"]) == len(want_grads)
        for got, want in zip(res["grads"], want_grads):
            _close(got, want)
        for after, old, g in zip(res["params_after"], before, want_grads):
            assert (after != old).any() == bool((g != 0).any())
    assert ranks[0][arch]["strategy"] == dryrun._strategy(cfg, SHAPE, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_laid_out_prefill_and_decode_match_one_device(arch, cases, ranks):
    """The prefill and decode cells' layouts run for real: the prefill's
    logits, one decode step's (B6's operator on each rank's block; the KV
    cache split over its sequence, the new row written by the rank that
    holds it) and the caches after it, on every rank, against one
    device."""
    cfg, _, params, batch = cases[arch]
    p = _tensors(params)
    tokens = torch.from_numpy(batch["tokens"]).long()
    cache_len = tokens.shape[1] + 8
    logits, caches = lm.make_prefill_step(cfg, cache_len)(p, {"tokens":
                                                              tokens})
    for rank in ranks:
        got = rank[arch]["serve"]
        np.testing.assert_allclose(got["prefill"], logits.numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert np.array_equal(got["token"],
                              logits.argmax(-1)[:, None].numpy())
    one = [type(c)(c.k.clone(), c.v.clone()) for c in caches]
    d_logits, one = lm.make_decode_step(cfg)(
        p, one, torch.from_numpy(ranks[0][arch]["serve"]["token"]),
        tokens.shape[1])
    want = torch_ranks._leaves(one)
    for rank in ranks:
        got = rank[arch]["serve"]
        np.testing.assert_allclose(got["decode"], d_logits.numpy(),
                                   atol=1e-4, rtol=1e-4)
        assert len(got["caches"]) == len(want)
        for g, w in zip(got["caches"], want):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=1e-5)
        assert "Shard(dim=2)" in got["cache_placements"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_counted_flops_equal_the_fake_trace(arch, cases, ranks):
    """Rank 0's FLOPs of the real step equal the meta trace's of the same
    cell on a fake (2, 2) mesh; so do its collective counts."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = cases[arch][0]
    with dryrun.fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        res = dryrun.trace_cell(dryrun.build_lm_cell(cfg, SHAPE, mesh), mesh)
    real = ranks[0][arch]["counts"]
    assert res["counts"]["flops"] > 0
    assert res["counts"]["flops"] == real["flops"]
    assert res["counts"]["coll_counts"] == real["coll_counts"]


def _cli(tmp_path, *args):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--mesh", "single", "--device", "cpu",
                        "--out", str(out)], capture_output=True, text=True,
                       env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert " × " in r.stdout and "flops/dev=" in r.stdout
    return json.loads(out.read_text())


def _rank0_bytes(tree, shardings) -> int:
    if isinstance(tree, dict):
        return sum(_rank0_bytes(v, shardings[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_rank0_bytes(v, s) for v, s in zip(tree, shardings))
    if not isinstance(tree, torch.Tensor) or shardings is None:
        return 0
    local, _ = local_block(shardings, tuple(tree.shape))
    return int(np.prod(local)) * tree.element_size()


def test_cli_writes_an_lm_report(tmp_path):
    """qwen2.5-32b x train_4k at 2 layers on the (16, 16) mesh: its args'
    bytes are the sum of rank 0's blocks of the params, the moments and
    the batch under the config's strategy; positive FLOPs; the model FLOPs
    the reference's formula and the useful fraction their ratio."""
    d = _cli(tmp_path, "--arch", "qwen2.5-32b", "--shape", "train_4k",
             "--set", "num_layers=2")
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import analysis

    cfg = registry.get("qwen2.5-32b").with_(num_layers=2)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        cell = dryrun.build_lm_cell(cfg, SHAPES["train_4k"], mesh)
        want = sum(_rank0_bytes(a, s) for a, s in zip(cell.args,
                                                        cell.in_sh))
    assert d["arg_bytes"] == want
    assert d["alias_bytes"] == want - _rank0_bytes(cell.args[2],
                                                   cell.in_sh[2])
    assert d["flops"] > 0 and d["bytes_accessed"] > 0
    mflops = analysis.model_flops(cfg, SHAPES["train_4k"])
    assert d["model_flops_global"] == mflops
    assert d["useful_flops_fraction"] == mflops / (d["flops"] * 256)
    # 6 N T counts the embedding's V x D params as a matmul, which the
    # program runs as a gather: at 2 layers that share is a fifth of N, so
    # the fraction passes 1 (1.21 here); without it the formula is a lower
    # bound of what the ranks run, the remat's recompute on top
    embed = cfg.vocab_size * cfg.d_model
    tokens = SHAPES["train_4k"].tokens_per_step
    assert 0 < 6.0 * (cfg.active_param_count() - embed) * tokens \
        <= d["flops"] * 256
    assert d["num_devices"] == 256 and d["mesh"] == "single"


def test_cli_writes_a_nerf_report(tmp_path):
    """cicero-dvgo x render_800: the 800 x 800 rays over every axis, its
    tables of 4,096 rows and more over ``model``; args' bytes the sum of
    rank 0's blocks; positive FLOPs; no model FLOPs (the reference counts
    none for a NeRF)."""
    d = _cli(tmp_path, "--arch", "cicero-dvgo")
    from repro_torch.launch.mesh import make_production_mesh

    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        cell = dryrun.build_nerf_cell("cicero-dvgo", mesh)
        want = sum(_rank0_bytes(a, s) for a, s in zip(cell.args,
                                                        cell.in_sh))
    assert d["arg_bytes"] == want
    assert d["shape"] == "render_800" and d["flops"] > 0
    assert d["model_flops_global"] == 0.0
    assert d["output_bytes"] == (800 * 800 // 256) * 4 * 4


def test_cells_and_strategy_rule():
    """The reference's rule: the config's strategy or ``default_strategy``,
    ``fsdp`` serving as ``tp``; decode shards the cache's sequence from
    2^19 tokens."""
    qwen = registry.get("qwen2.5-32b")
    assert dryrun._strategy(qwen, SHAPES["train_4k"], None) == \
        qwen.sharding_strategy
    for shape in ("prefill_32k", "decode_32k"):
        want = ("tp" if qwen.sharding_strategy == "fsdp"
                else qwen.sharding_strategy)
        assert dryrun._strategy(qwen, SHAPES[shape], None) == want
    llama = registry.get("llama4-maverick-400b-a17b")
    assert dryrun._strategy(llama, SHAPES["train_4k"], None) == "tp+fsdp"
    assert dryrun._strategy(llama, SHAPES["train_4k"],
                            {"sharding_strategy": "tp"}) == "tp"
    assert dryrun.default_out("a", "s", "single") == \
        dryrun.RUNS / "single" / "a__s.json"
    assert dryrun._overrides(["num_layers=2", "capacity_factor=1.5",
                              "moe_dispatch=streaming"]) == {
        "num_layers": 2, "capacity_factor": 1.5,
        "moe_dispatch": "streaming"}
