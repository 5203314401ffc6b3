"""Slice 18 of the port: the reference's elastic checkpoint re-lay
(``checkpoint.load(shardings=...)``) onto DTensor placements, and the
Trainer's mesh branch, on the CPU.

The reference's mesh Trainer computes its params' and moments' shardings
(``default_strategy``, ``apply_strategy``, the strict guard) and never
applies them: it trains as its one-device Trainer does. So does the
port's: its losses equal the one-device Trainer's bit for bit. Each rank
of a mesh Trainer runs every step; the mesh's first rank writes each
checkpoint, once. Two gloo ranks (``tests/torch_ranks.py``) in one
launch: the re-lay of a one-device Trainer's checkpoint on a (2, 1) and a
(1, 2) (data, model) mesh, then the mesh Trainer."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import torch_ranks
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.common import P
from repro_torch.parallel import sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

# minitron-4b's layout (its strategy: fsdp) at widths where the FSDP rule
# (dims of 256 and up) shards the embedding, the head and the FFN
CFG = registry.get_reduced("minitron-4b").with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=256,
    vocab_size=512, dtype="float32")
DCFG = DataConfig(vocab_size=512, seq_len=16, global_batch=4)
TCFG = dict(ckpt_every=2, keep_ckpts=3, base_lr=1e-3, warmup=2,
            total_steps=20)
STEPS, FAULT_AT, RESUME_STEPS = 6, 3, 2
LAYOUTS = [("data", (2, 1), "fsdp"), ("model", (1, 2), "tp")]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_elastic_checkpoint_reshard(tmp_path, world_of_one):
    """The reference's ``test_elastic_checkpoint_reshard`` on one device:
    a checkpoint restores under a sharding, whole and with the placements
    asked for; a bfloat16 leaf comes back bit for bit."""
    state = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
             "h": torch.randn(4, 6, generator=torch.Generator().manual_seed(
                 0)).to(torch.bfloat16)}
    ckpt.save(tmp_path / "ck", 1, state)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1),
                      mesh_dim_names=("data", "model"))
    sh = {"w": sharding.named_sharding(mesh, P("data", None), (8, 4)),
          "h": sharding.named_sharding(mesh, P(None, "model"), (4, 6))}
    out, _ = ckpt.load(tmp_path / "ck", state, shardings=sh)
    for k in state:
        assert torch.equal(out[k].full_tensor(), state[k])
        assert out[k].dtype == state[k].dtype
        assert tuple(out[k].placements) == sh[k].placements
    assert sh["w"].spec == P("data", None)


def _counting_saves(monkeypatch) -> list:
    saves, real = [], ckpt.save

    def counted(ckpt_dir, step, *args, **kw):
        saves.append(step)
        return real(ckpt_dir, step, *args, **kw)

    monkeypatch.setattr(ckpt, "save", counted)
    return saves


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The one-device CPU Trainer: ``STEPS`` steps with the fault, then a
    fresh Trainer resuming; its checkpoints are the re-lay's source."""
    mp = pytest.MonkeyPatch()
    saves = _counting_saves(mp)
    root = tmp_path_factory.mktemp("one_device")
    armed = [True]

    def fault(step):
        if step == FAULT_AT and armed[0]:
            armed[0] = False
            raise RuntimeError(f"injected fault at step {FAULT_AT}")

    tcfg = TrainerConfig(ckpt_dir=str(root / "ck"), **TCFG)
    try:
        t = Trainer(CFG, DCFG, tcfg, fault_hook=fault, device="cpu")
        run = t.run(STEPS, resume=False)
        resumed = Trainer(CFG, DCFG, tcfg, device="cpu").run(RESUME_STEPS,
                                                             resume=True)
    finally:
        mp.undo()
    return {"run": run, "resumed": resumed, "saves": saves,
            "src": str(root / "ck"), "trainer": t}


@pytest.fixture(scope="module")
def two_ranks(one_device, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    return torch_ranks.launch(
        torch_ranks.relay_and_train_rank, 2, out,
        (CFG, one_device["src"], LAYOUTS),
        (CFG, DCFG, TCFG, str(out), STEPS, FAULT_AT, RESUME_STEPS))


@pytest.mark.parametrize("layout", [name for name, _, _ in LAYOUTS])
def test_relay_blocks_are_the_one_device_load(two_ranks, layout):
    """Each rank's block of every leaf equals its slice of the one-device
    load, ``full_tensor()`` equals the whole, the placements are the ones
    asked for, and the blocks tile every sharded leaf."""
    sharded = 0
    for r, out in enumerate(two_ranks):
        rows = out["relay"][layout]
        for key, row in rows.items():
            assert row["local_equal"] and row["full_equal"], (r, key)
            assert row["placements"] == row["requested"], (r, key)
        sharded += sum("Shard" in repr(row["requested"])
                       for row in rows.values())
    assert sharded > 0
    for key in two_ranks[0]["relay"][layout]:
        rows = [out["relay"][layout][key] for out in two_ranks]
        if rows[0]["local_shape"] != rows[1]["local_shape"] \
                or rows[0]["offset"] != rows[1]["offset"]:
            dim = [i for i, (a, b) in enumerate(zip(rows[0]["offset"],
                                                    rows[1]["offset"]))
                   if a != b]
            assert len(dim) == 1 and rows[0]["offset"][dim[0]] == 0
            assert rows[1]["offset"][dim[0]] == \
                rows[0]["local_shape"][dim[0]]


def test_relay_shards_the_fsdp_leaves():
    """Under the config's strategy (fsdp) the embedding is split over the
    (data, model) axes: on a (2, 1) mesh, rows over data."""
    meta_embed = torch.empty((512, 64), device="meta")

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 1)

    spec = sharding.apply_strategy({"e": P("model", None)},
                                   {"e": meta_embed}, "fsdp")["e"]
    assert spec == P(("pod", "data", "model"), None)
    assert sharding.placements(
        sharding.named_sharding(Mesh(), spec, (512, 64)).spec, Mesh()) == (
        sharding.placements(P(("data", "model"), None), Mesh()))


def test_mesh_trainer_placements_are_strict(two_ranks):
    for out in two_ranks:
        assert out["train"]["pshard_is_strict"]
        assert out["train"]["oshard_is_strict"]
        assert out["train"]["sharded_leaves"] > 0


def test_mesh_trainer_trains_as_one_device(two_ranks, one_device):
    """Bit-equal losses, the same restart from the same checkpoint, the
    same resume."""
    run, resumed = one_device["run"], one_device["resumed"]
    events = [m for m in one_device["trainer"].metrics
              if m.get("event") == "restart"]
    for out in two_ranks:
        t = out["train"]
        assert t["losses"] == run["losses"]
        assert (t["restarts"], t["final_step"]) == (1, STEPS)
        assert [e["step"] for e in t["events"]] == \
            [e["step"] for e in events] == [2]
        assert t["resumed_losses"] == resumed["losses"]
        assert t["resumed_final_step"] == STEPS + RESUME_STEPS


def test_mesh_trainer_writes_each_checkpoint_once(two_ranks, one_device):
    """The mesh's first rank saves at every save step the one-device
    Trainer saves at; the other saves nothing; the directory holds the
    kept steps and no half-written one."""
    rank0, rank1 = (out["train"] for out in two_ranks)
    # the run's saves (its end saves again), then the resumed Trainer's
    assert rank0["saves"] == one_device["saves"] == [2, 4, 6, 6, 8, 8]
    assert rank1["saves"] == []
    assert rank0["listing"] == rank1["listing"] == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_trainer_without_a_mesh_is_unchanged(tmp_path):
    t = Trainer(CFG, DCFG, TrainerConfig(ckpt_dir=str(tmp_path / "ck"),
                                         **TCFG), device="cpu")
    assert t.mesh is None and t._pshard is None and t._oshard is None
    assert t._writer and t._ranks == 1
