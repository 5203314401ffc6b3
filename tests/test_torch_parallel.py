"""Slice 17 of the port, the reference's ``parallel/`` collectives and
launch meshes on ``torch.distributed``: gradient compression bit for bit
against the JAX package, ``compressed_psum``, sequence-sharded decode
attention and gpipe over gloo ranks on the CPU (``tests/torch_ranks.py``,
a ``FileStore`` in ``tmp_path``, a deadline per launch), and the
production meshes under torch's fake process group in a subprocess."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import torch_ranks
from repro.parallel import compression as j_comp
from repro.parallel import decode_attention as j_decode
from repro.parallel import pipeline as j_pipeline
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import mesh as t_mesh
from repro_torch.parallel import compression as t_comp

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(atol=2e-5, rtol=1e-5)


def _grads(seed: int, steps: int) -> list:
    """Per step a float32 tree with an odd leaf, a scaled one and a tiny
    one (where int8's scale floor of 1e-8 binds)."""
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(37, 19)).astype(np.float32),
             "b": (3.0 * rng.normal(size=(7,))).astype(np.float32),
             "tiny": (1e-9 * rng.normal(size=(5,))).astype(np.float32)}
            for _ in range(steps)]


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_compression_matches_reference_bit_for_bit(mode):
    """Five error-feedback steps: payloads, scales and residuals bit-equal
    to JAX's (both round half to even); ``wire_bytes`` equal."""
    grads = _grads(0, 5)
    j_ef = j_comp.make_ef_state({k: jnp.asarray(v)
                                 for k, v in grads[0].items()})
    t_ef = t_comp.make_ef_state({k: torch.as_tensor(v)
                                 for k, v in grads[0].items()})
    for g in grads:
        jq, js, j_ef = j_comp.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, j_ef, mode)
        tq, ts, t_ef = t_comp.compress_with_feedback(
            {k: torch.as_tensor(v) for k, v in g.items()}, t_ef, mode)
        for k in g:
            assert str(tq[k].dtype).split(".")[-1] == str(jq[k].dtype)
            np.testing.assert_array_equal(tq[k].float().numpy(),
                                          np.asarray(jq[k], np.float32))
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(t_ef[k].numpy(),
                                          np.asarray(j_ef[k]))
    assert t_comp.wire_bytes(tq, mode) == j_comp.wire_bytes(jq, mode)
    with pytest.raises(ValueError):
        t_comp.quantize(torch.zeros(3), "fp8")


def test_quantize_rounds_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], dtype=torch.float32)
    q, s = t_comp.quantize(g, "int8")
    jq, js = j_comp.quantize(jnp.asarray(g.numpy()), "int8")
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2] == np.asarray(jq).tolist()


@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_compressed_psum_two_ranks(tmp_path, mode):
    """Every rank gets the mean of the two ranks' dequantized payloads,
    bit for bit, each step, and its own residuals; the payloads are JAX's
    (``dequantize(quantize(g + ef))``)."""
    grads = [_grads(1, 3), _grads(2, 3)]
    outs = torch_ranks.launch(torch_ranks.compressed_psum_rank, 2, tmp_path,
                              grads, mode, 3)
    j_ef = [j_comp.make_ef_state({k: jnp.asarray(v)
                                  for k, v in grads[r][0].items()})
            for r in range(2)]
    for step in range(3):
        deqs = []
        for r in range(2):
            q, s, j_ef[r] = j_comp.compress_with_feedback(
                {k: jnp.asarray(v) for k, v in grads[r][step].items()},
                j_ef[r], mode)
            deqs.append({k: np.asarray(j_comp.dequantize(q[k], s[k]))
                         for k in q})
            for k in q:
                np.testing.assert_array_equal(
                    outs[r]["steps"][step]["deq"][k], deqs[r][k])
        for k in deqs[0]:
            want = (deqs[0][k] + deqs[1][k]) / np.float32(2.0)
            for r in range(2):
                np.testing.assert_array_equal(
                    outs[r]["steps"][step]["mean"][k], want)


@pytest.mark.parametrize("index", [31, 32, 40, 63])
def test_sharded_decode_attention_two_ranks(tmp_path, index):
    """The reference test's shapes (B 2, H 8, KV 4, S 64, D 32), the cache
    split 32 rows per rank: against JAX's ``sharded_decode_attention`` on a
    (1, 1) mesh and against B6's plain decode (partials + combine) on the
    whole cache."""
    b, h, kv, s, d = 2, 8, 4, 64, 32
    rng = np.random.default_rng(index)
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    scale = d**-0.5
    outs = torch_ranks.launch(torch_ranks.decode_attention_rank, 2, tmp_path,
                              q, k, v, index, scale)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want = np.asarray(j_decode.sharded_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(index, jnp.int32), mesh=mesh, seq_axis="model",
        sm_scale=scale))
    assert want.shape == (b, 1, h * d)
    parts = t_fa.decode_partials_plain(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        kv_len=index + 1, splits=4, split_len=16, sm_scale=scale)
    plain = t_fa.decode_combine_plain(*parts, torch.float32).reshape(
        b, 1, h * d).numpy()
    for got in outs:
        assert got.shape == (b, 1, h * d)
        np.testing.assert_allclose(got, want, **F32_TOL)
        np.testing.assert_allclose(got, plain, **F32_TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("microbatches", [2, 4, 8])
def test_pipelined_forward_four_ranks(tmp_path, microbatches):
    """gpipe over 4 stages of 2 layers each against JAX's
    ``reference_forward`` (the reference's ``tests/test_pipeline_parallel
    .py``: L 8, D 16, B 8), atol 1e-5, on every rank."""
    num_layers, width, batch = 8, 16, 8
    rng = np.random.default_rng(microbatches)
    params = {"w": (0.3 * rng.normal(size=(num_layers, width, width))
                    ).astype(np.float32),
              "b": (0.01 * rng.normal(size=(num_layers, width))
                    ).astype(np.float32)}
    x = rng.normal(size=(batch, width)).astype(np.float32)
    outs = torch_ranks.launch(torch_ranks.pipeline_rank, 4, tmp_path,
                              params, x, microbatches)
    want = np.asarray(j_pipeline.reference_forward(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    for got in outs:
        assert np.abs(got - want).max() < 1e-5


_FAKE_MESH = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size={world})
m = make_production_mesh(multi_pod={multi_pod}, device="cpu")
print(tuple(m.shape), m.mesh_dim_names)
"""


def _fake_mesh(world: int, multi_pod: bool) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_FAKE_MESH.format(
            world=world, multi_pod=multi_pod))],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


@pytest.mark.parametrize("multi_pod,world,want", [
    (False, 256, "(16, 16) ('data', 'model')"),
    (True, 512, "(2, 16, 16) ('pod', 'data', 'model')")])
def test_production_mesh_shapes(multi_pod, world, want):
    r = _fake_mesh(world, multi_pod)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == want


def test_production_mesh_refuses_too_few_ranks():
    r = _fake_mesh(16, True)
    assert r.returncode != 0
    assert "mesh (2, 16, 16) needs 512 ranks, have 16" in r.stderr


def test_smoke_mesh_is_world_by_one(tmp_path):
    with pytest.raises(RuntimeError, match="no process group"):
        t_mesh.make_smoke_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    try:
        m = t_mesh.make_smoke_mesh(device="cpu")
        assert tuple(m.shape) == (1, 1)
        assert m.mesh_dim_names == ("data", "model")
        assert m.device_type == "cpu"
    finally:
        dist.destroy_process_group()
