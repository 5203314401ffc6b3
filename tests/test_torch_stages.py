"""Fault C8's repair: gpipe stages that hold their own layers. The
reference shards the stacked params over the pipeline axis
(``in_specs=(P(axis), P())``), so stage p holds ``L / P`` layers; the
port's ``pipelined_forward`` now takes only the stage's ``[L / P, ...]``
block of each stacked leaf. Two gloo ranks on the CPU
(``tests/torch_ranks.py``; the four-rank case is
``tests/test_torch_parallel.py``'s), and one stage in this process."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import torch_ranks
from repro.parallel import pipeline as j_pipeline
from repro_torch.parallel import pipeline as t_pipeline

NUM_LAYERS, WIDTH, BATCH = 8, 16, 8


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": (0.3 * rng.normal(size=(NUM_LAYERS, WIDTH, WIDTH))
                    ).astype(np.float32),
              "b": (0.01 * rng.normal(size=(NUM_LAYERS, WIDTH))
                    ).astype(np.float32)}
    return params, rng.normal(size=(BATCH, WIDTH)).astype(np.float32)


def _jax_reference(params, x):
    return np.asarray(j_pipeline.reference_forward(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))


@pytest.fixture(scope="module")
def two_stages(tmp_path_factory):
    params, x = _inputs(2)
    outs = torch_ranks.launch(torch_ranks.pipeline_rank, 2,
                              tmp_path_factory.mktemp("stages"), params, x,
                              [1, 2, 4])
    return params, x, outs


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_two_stages_match_reference(two_stages, microbatches):
    """Within 1e-5 of JAX's ``reference_forward`` on both ranks."""
    params, x, outs = two_stages
    want = _jax_reference(params, x)
    for out in outs:
        assert np.abs(out["out"][microbatches] - want).max() < 1e-5


def test_each_of_two_stages_holds_half_the_layers(two_stages):
    """Each stage's leaves are ``[L / 2, ...]``, in storage of half the
    stacked leaf's bytes."""
    params, _, outs = two_stages
    for out in outs:
        assert out["held"] == {
            k: ((NUM_LAYERS // 2,) + v.shape[1:], v.nbytes // 2)
            for k, v in params.items()}


@pytest.fixture
def one_stage(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store1"), 1), rank=0, world_size=1)
    yield DeviceMesh("cpu", [0], mesh_dim_names=("pod",))
    dist.destroy_process_group()


def test_one_stage_is_bit_equal_at_one_microbatch(one_stage):
    params, x = _inputs(3)
    tree = {k: torch.as_tensor(v) for k, v in params.items()}
    block = t_pipeline.stage_block(tree, one_stage)
    assert all(block[k].shape == tree[k].shape for k in tree)
    got = t_pipeline.pipelined_forward(torch_ranks._tanh_layer, block,
                                       torch.as_tensor(x), mesh=one_stage,
                                       num_microbatches=1)
    want = t_pipeline.reference_forward(torch_ranks._tanh_layer, tree,
                                        torch.as_tensor(x))
    assert torch.equal(got, want)
    assert np.abs(got.numpy() - _jax_reference(params, x)).max() < 1e-5


def test_stage_leaves_must_agree(one_stage):
    params, x = _inputs(4)
    tree = {"w": torch.as_tensor(params["w"]),
            "b": torch.as_tensor(params["b"][:4])}
    with pytest.raises(ValueError, match="must all hold"):
        t_pipeline.pipelined_forward(torch_ranks._tanh_layer, tree,
                                     torch.as_tensor(x), mesh=one_stage,
                                     num_microbatches=2)
