"""The port's data pipeline, checkpoints and Trainer: the token streams
bit-equal to the reference's, checkpoints exact for float32 and bfloat16
leaves, the reference's own Trainer tests (``tests/test_trainer.py``) on
the port, and a 20-step Trainer run of each package from the same initial
params.

The two Trainers agree to rtol 1e-5 over 20 steps (measured: the largest
per-step loss gap is 2.2e-7 relative, the float32 grads' summation order;
AdamW's ``m / sqrt(v)`` can amplify such a gap where a moment is tiny,
so the bound is an order above it). Resume on the CPU is bit-equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.data import pipeline as j_pipeline
from repro.models import lm as j_lm
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator, make_batch
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
            dtype="float32")
CFG = ModelConfig(**TINY)
DCFG = DataConfig(vocab_size=64, seq_len=32, global_batch=8)
TRAINER_LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tcfg(path, **kw):
    kw = dict(dict(ckpt_every=10, base_lr=1e-3, warmup=2, total_steps=40),
              **kw)
    return TrainerConfig(ckpt_dir=str(path), **kw)


@pytest.mark.parametrize("stubs", [{}, dict(enc_seq_len=6, d_model=16),
                                   dict(num_image_tokens=5, d_model=16)],
                         ids=["tokens", "frame-stub", "image-stub"])
def test_make_batch_is_bit_equal_to_the_reference(stubs):
    for seed in (0, 1234, 99):
        for b, s in ((8, 32), (5, 17), (3, 2)):
            kw = dict(vocab_size=97, seq_len=s, global_batch=b, seed=seed,
                      **stubs)
            for step in (0, 1, 7, 1000):
                got = make_batch(DataConfig(**kw), step)
                want = j_pipeline.make_batch(j_pipeline.DataConfig(**kw),
                                             step)
                assert set(got) == set(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])


def test_data_iterator_resumes_the_stream():
    it = DataIterator(DCFG)
    for _ in range(3):
        next(it)
    state = it.state()
    assert state == 3
    x = next(it)
    it2 = DataIterator(DCFG)
    it2.restore(state)
    np.testing.assert_array_equal(next(it2)["tokens"], x["tokens"])
    np.testing.assert_array_equal(x["targets"], make_batch(DCFG, 3)["targets"])


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=gen),
                       "layers": [{"b": torch.randn(5, generator=gen)
                                   .to(torch.bfloat16)},
                                  {"b": torch.randn(5, generator=gen)
                                   .to(torch.bfloat16)}]},
            "opt": {"m": torch.randn(8, 4, generator=gen)}}


def _flat(tree):
    return list(ckpt._flatten(tree))


def test_checkpoint_round_trip_is_exact_for_float32_and_bfloat16(tmp_path):
    state = _state(0)
    # bfloat16 patterns numpy cannot hold as floats: NaN payloads, -0, inf
    state["params"]["layers"][0]["b"][:3] = torch.tensor(
        [-0.0, float("inf"), float("nan")]).to(torch.bfloat16)
    path = ckpt.save(tmp_path, 5, state, meta={"data_step": 9})
    assert path.name == "step_00000005" and (path / "state.npz").exists()
    meta = json.loads((path / "meta.json").read_text())
    assert meta["step"] == 5 and meta["data_step"] == 9
    assert ckpt.latest_step(tmp_path) == 5
    template = _state(1)
    template["opt"]["m"] = template["opt"]["m"].double()
    out, meta = ckpt.load(tmp_path, template)
    assert meta["data_step"] == 9
    assert out["opt"]["m"].dtype == torch.float64  # the template's dtype
    assert torch.equal(out["opt"]["m"], state["opt"]["m"].double())
    assert isinstance(out["params"]["layers"], list)
    for (ka, a), (kb, b) in zip(_flat(out["params"]), _flat(state["params"])):
        assert ka == kb and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_publish_is_atomic_and_keeps_the_newest(tmp_path):
    ckpt.save(tmp_path, 10, _state(0))
    # a save that died before its rename leaves only a tmp dir behind
    stale = tmp_path / ".tmp_step_00000020"
    stale.mkdir()
    (stale / "state.npz").write_bytes(b"torn")
    assert ckpt.latest_step(tmp_path) == 10
    out, _ = ckpt.load(tmp_path, _state(1))
    assert torch.equal(out["params"]["w"], _state(0)["params"]["w"])
    ckpt.save(tmp_path, 20, _state(2), keep=2)  # replaces the stale tmp
    assert not stale.exists() and ckpt.latest_step(tmp_path) == 20
    for step in (30, 40):
        ckpt.save(tmp_path, step, _state(step), keep=2)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000030", "step_00000040"]
    out, meta = ckpt.load(tmp_path, _state(1), step=30)
    assert meta["step"] == 30
    assert torch.equal(out["params"]["w"], _state(30)["params"]["w"])
    with pytest.raises(FileNotFoundError):
        ckpt.load(tmp_path / "none", _state(0))


def test_loss_decreases(tmp_path):
    t = Trainer(CFG, DCFG, _tcfg(tmp_path / "ck", ckpt_every=100,
                                 base_lr=3e-3, warmup=5, total_steps=60),
                device="cpu")
    out = t.run(steps=60, resume=False)
    first = float(np.mean(out["losses"][:5]))
    last = float(np.mean(out["losses"][-5:]))
    assert last < first - 0.2, (first, last)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """Train 20; vs train 10 -> a fresh Trainer resumes -> 10 more: the
    same losses and params, bit for bit."""
    r1 = Trainer(CFG, DCFG, _tcfg(tmp_path / "a"), device="cpu").run(
        steps=20, resume=False)
    Trainer(CFG, DCFG, _tcfg(tmp_path / "b"), device="cpu").run(
        steps=10, resume=False)
    r3 = Trainer(CFG, DCFG, _tcfg(tmp_path / "b"), device="cpu").run(
        steps=10, resume=True)
    assert r3["final_step"] == r1["final_step"] == 20
    assert r3["losses"] == r1["losses"][10:]
    assert torch.equal(r3["params"]["head"], r1["params"]["head"])
    assert torch.equal(r3["opt"]["v"]["embed"], r1["opt"]["v"]["embed"])


def test_fault_injection_restarts_from_checkpoint(tmp_path):
    boom = {"armed": True}

    def fault(step):
        if step == 15 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    metrics = tmp_path / "metrics.jsonl"
    t = Trainer(CFG, DCFG, _tcfg(tmp_path / "ck",
                                 metrics_path=str(metrics)),
                fault_hook=fault, device="cpu")
    out = t.run(steps=25, resume=False)
    assert out["restarts"] == 1
    assert out["final_step"] == 25
    restarts = [m for m in t.metrics if m.get("event") == "restart"]
    assert len(restarts) == 1 and restarts[0]["step"] == 10
    assert "injected node failure" in restarts[0]["error"]
    logged = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert logged == t.metrics
    # the replayed steps 10..14 train as they did before the fault
    clean = Trainer(CFG, DCFG, _tcfg(tmp_path / "clean"),
                    device="cpu").run(steps=25, resume=False)
    assert out["losses"][15:] == clean["losses"][10:]


def test_fault_before_any_checkpoint_starts_over(tmp_path):
    boom = {"armed": True}

    def fault(step):
        if step == 3 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected")

    t = Trainer(CFG, DCFG, _tcfg(tmp_path / "ck"), fault_hook=fault,
                device="cpu")
    out = t.run(steps=6, resume=False)
    assert out["restarts"] == 1 and out["final_step"] == 6
    assert out["losses"][:3] == out["losses"][3:6]


class _FromReferenceInit(Trainer):
    """Starts from the reference's initial params (converted), not the
    port's own draw."""

    np_params = None

    def init_state(self, seed: int = 0):
        params = convert.lm_params_from_numpy(self.cfg, self.np_params,
                                              device=self.device)
        return params, adamw_init(params)


def test_trainer_matches_the_reference_trainer(tmp_path):
    j_cfg = JModelConfig(**TINY)
    kw = dict(ckpt_every=10, base_lr=1e-3, warmup=2, total_steps=40)
    j_out = JTrainer(j_cfg, j_pipeline.DataConfig(64, 32, 8),
                     JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **kw)).run(
        steps=20, resume=False)
    _FromReferenceInit.np_params = jax.tree.map(
        np.asarray, j_lm.init_params(j_cfg, jax.random.key(0)))
    t_out = _FromReferenceInit(CFG, DCFG, _tcfg(tmp_path / "t", **kw),
                               device="cpu").run(steps=20, resume=False)
    assert t_out["final_step"] == j_out["final_step"] == 20
    np.testing.assert_allclose(t_out["losses"], j_out["losses"],
                               rtol=TRAINER_LOSS_RTOL)
