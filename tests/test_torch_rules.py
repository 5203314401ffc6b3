"""The rules of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package; entry points run on the CUDA card unless
the caller asks for the CPU, and raise without a card; ``chip_smoke.py``
fails (and prints no result) where there is no card or no repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import api, convert
from repro_torch.configs import registry
from repro_torch.core.config import RenderConfig, ShardConfig
from repro_torch.kernels import flash_attention, fused_nerf_mlp, \
    gather_trilerp, streaming_pipeline
from repro_torch.launch import mesh
from repro_torch.models import lm
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [
    ROOT / "scripts" / f"{name}.py" for name in (
        "lm_noise_floor", "gloo_cuda_probe", "lm_serve_bench",
        "steady_tick_bench")]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "repro"), (path, mod)


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(res=16, grid_res=16, window=2, num_samples=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.make_renderer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy({"table": np.zeros((8, 4), np.float32)})
    ren = api.make_renderer(cfg, device="cpu")
    assert ren.params["table"].device.type == "cpu"
    assert api.make_renderer(cfg.replace(device="cpu")).device.type == "cpu"


def test_mesh_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch,
                                                         tmp_path):
    """The launch meshes and a sharded renderer raise without a card unless
    given the CPU; on the CPU the meshes need a process group of enough
    ranks and the sharded renderer runs there (its engine needs the
    process group, see ``tests/test_torch_shard.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(res=16, grid_res=16, window=2, num_samples=8,
                       num_slots=2, shard=ShardConfig(num_devices=2))
    for make in (mesh.make_smoke_mesh, mesh.make_production_mesh,
                 lambda **kw: api.make_renderer(cfg, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert api.make_renderer(cfg, device="cpu").device.type == "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert mesh.make_smoke_mesh(device="cpu").device_type == "cpu"
        with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
            mesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_lm_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_reduced("qwen2.5-32b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    params = lm.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    tree = {"embed": np.zeros((cfg.vocab_size, cfg.d_model), np.float32),
            "blocks": ({},), "final_norm": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(cfg, tree)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, num_slots=1, max_len=8)
    eng = ServeEngine(cfg, params, num_slots=1, max_len=8, device="cpu")
    assert eng.caches[0].k.device.type == "cpu"


def test_training_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from repro_torch.nerf import models, rays, scenes, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, _ = models.make_model("dvgo", grid_res=8, channels=4,
                                 mlp_hidden=8, num_samples=4)
    scene, gen = scenes.make_scene("lego"), torch.Generator()
    cam, pose = rays.Camera.square(4), rays.orbit_pose(0.3)
    gt = lambda c2w: (torch.zeros(4, 4, 3), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.fit_field(model, scene, gen, steps=1, batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_images(model, gt, cam, [pose], gen, steps=1,
                           rays_per_batch=4)
    params = train.fit_field(model, scene, gen, steps=1, batch=8,
                             device="cpu")
    assert params["table"].device.type == "cpu"
    _, losses = train.train_images(model, gt, cam, [pose], gen, steps=1,
                                   rays_per_batch=4, device="cpu")
    assert len(losses) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator draws on cpu"):
        train.fit_field(model, scene, gen, steps=1, batch=8)


def test_lm_training_entry_points_need_a_card_or_an_explicit_cpu(
        monkeypatch, tmp_path):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_reduced("minitron-4b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=1)
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, dcfg, tcfg)
    zeros = lambda: {"embed": np.zeros((cfg.vocab_size, cfg.d_model),
                                       np.float32),
                     "blocks": ({},), "final_norm": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_opt_state_from_numpy(cfg, {"m": zeros(), "v": zeros()})
    opt = convert.lm_opt_state_from_numpy(cfg.with_(dtype="bfloat16"),
                                          {"m": zeros(), "v": zeros()},
                                          device="cpu")
    assert opt["m"]["embed"].dtype == torch.float32  # moments stay float32
    trainer = Trainer(cfg, dcfg, tcfg, device="cpu")
    params, opt = trainer.init_state(0)
    assert params["embed"].device.type == opt["v"]["embed"].device.type \
        == "cpu"
    # the train step runs where its params are
    _, _, metrics = lm.make_train_step(cfg)(
        params, opt, {k: torch.zeros((1, 8), dtype=torch.int32)
                      for k in ("tokens", "targets")}, 0)
    assert metrics["loss"].device.type == "cpu"


def test_mesh_trainer_needs_a_card_or_an_explicit_cpu(monkeypatch,
                                                      tmp_path):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = registry.get_reduced("minitron-4b")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=1)
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path / "ck"))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        m = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                       mesh_dim_names=("data", "model"))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, dcfg, tcfg, mesh=m)
        t = Trainer(cfg, dcfg, tcfg, mesh=m, device="cpu")
        assert t.device.type == "cpu" and t._pshard is not None
    finally:
        dist.destroy_process_group()


def test_dryrun_needs_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    """The dry-run lays its cells onto a mesh of the card's device type: its
    CLI and ``run_cell`` raise without a card unless given ``--device cpu``
    / ``device="cpu"``, and run there."""
    from repro_torch.launch import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "cell.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "cicero-dvgo", "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("qwen2.5-32b", "train_4k", "single")
    assert not out.exists()
    dryrun.main(["--arch", "cicero-dvgo", "--out", str(out), "--device",
                 "cpu"])
    assert "device=cpu" in out.read_text()


def test_analysis_needs_a_card_or_an_explicit_cpu(monkeypatch, tmp_path):
    """The checker's program and launch passes run on the card: its CLI
    raises without one unless given ``--device cpu`` (no quiet fallback),
    and runs there; the AST pass alone needs no device."""
    from repro_torch.analysis import cli, launch_pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "analysis.json"
    for skip in ([], ["--skip-pass", "program"], ["--skip-pass", "launch"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--root", str(ROOT), "--json", str(out),
                      "--skip-pass", "ast", *skip])
    assert not out.exists()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        launch_pass.recorded_launches("cpu")
    assert cli.main(["--root", str(ROOT), "--json", str(out), "--skip-pass",
                     "program", "--skip-pass", "launch"]) == 0
    assert cli.main(["--root", str(ROOT), "--skip-pass", "ast",
                     "--skip-pass", "program", "--device", "cpu"]) == 0
    assert "device" not in out.read_text()  # the AST-only run's summary


def test_kernels_are_not_built_at_import():
    for kernel in (gather_trilerp.KERNEL, gather_trilerp.KERNEL_PER_SEG,
                   fused_nerf_mlp.KERNEL, streaming_pipeline.KERNEL,
                   streaming_pipeline.KERNEL_PER_SEG, flash_attention.KERNEL):
        assert kernel._lib is None


def test_chip_smoke_fails_without_card_or_repository(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                              capture_output=True, text=True, timeout=120,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
