"""The ``utils`` leftovers and ``RenderConfig.fingerprint`` against the
reference: the tree helpers against ``repro.utils`` on the same numpy
leaves, the formatting helpers, ``fold_seed``'s stability across processes
and the fingerprint's coverage guard."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as ref_utils
from repro_torch import utils
from repro_torch.core import config as cfg_mod
from repro_torch.core.config import RenderConfig, ShardConfig
from repro_torch.nerf.rays import Camera

ROOT = Path(__file__).resolve().parents[1]


def _trees():
    rng = np.random.default_rng(0)
    leaves = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.integers(0, 9, size=(5,)).astype(np.int32),
                    (rng.normal(size=(2, 2, 2)).astype(np.float16),)],
              "c": {"d": np.zeros((0, 7), np.float32)}}
    to_jax = lambda t: {"a": jnp.asarray(t["a"]),
                        "b": [jnp.asarray(t["b"][0]),
                              (jnp.asarray(t["b"][1][0]),)],
                        "c": {"d": jnp.asarray(t["c"]["d"])}}
    to_torch = lambda t: {"a": torch.from_numpy(t["a"]),
                          "b": [torch.from_numpy(t["b"][0]),
                                (torch.from_numpy(t["b"][1][0]),)],
                          "c": {"d": torch.from_numpy(t["c"]["d"])}}
    return leaves, to_jax, to_torch


@pytest.mark.parametrize("fn", ["tree_bytes", "tree_count", "tree_finite"])
def test_tree_helpers_match_the_reference(fn):
    leaves, to_jax, to_torch = _trees()
    assert getattr(utils, fn)(to_torch(leaves)) == \
        getattr(ref_utils, fn)(to_jax(leaves))
    leaves["b"][1][0][0, 0, 0] = np.nan
    assert getattr(utils, fn)(to_torch(leaves)) == \
        getattr(ref_utils, fn)(to_jax(leaves))


@pytest.mark.parametrize("n", [0, 999.994, 1234.5, 12_345_678, -5e9, 3e15,
                               7.2e17])
def test_human_count_and_bytes_match_the_reference(n):
    assert utils.human_count(n) == ref_utils.human_count(n)
    assert utils.human_bytes(n) == ref_utils.human_bytes(n)


@pytest.mark.parametrize("size", [1, 3, 7, 10])
def test_chunked_matches_the_reference(size):
    seq = list(range(9))
    assert list(utils.chunked(seq, size)) == \
        list(ref_utils.chunked(seq, size))
    assert list(utils.chunked("abcdefg", size)) == \
        list(ref_utils.chunked("abcdefg", size))


def test_fold_seed_is_stable_across_processes():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.utils import fold_seed, named_generators; "
            "import torch; "
            "g = named_generators(7, ['init', 'data'])['data']; "
            "print(fold_seed(7, 'scene', 'lego'), fold_seed(0), "
            "torch.rand(2, generator=g).tolist())")
    outs = []
    for hashseed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed)
        outs.append(subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
            capture_output=True, text=True, timeout=120).stdout)
    assert outs[0] == outs[1] and outs[0].strip()


def test_fold_seed_and_named_generators_separate_names():
    seeds = {utils.fold_seed(0, n) for n in ("a", "b", "ab")}
    assert len(seeds) == 3
    assert utils.fold_seed(0, "a", "b") != utils.fold_seed(0, "ab")
    assert utils.fold_seed(1, "a") != utils.fold_seed(0, "a")
    assert all(0 <= s < 2**63 for s in seeds)
    gens = utils.named_generators(3, ["x", "y"])
    draws = {n: torch.rand(4, generator=g) for n, g in gens.items()}
    assert not torch.equal(draws["x"], draws["y"])
    again = utils.named_generators(3, ["x"])["x"]
    assert torch.equal(torch.rand(4, generator=again), draws["x"])


# ---------------------------------------------------------------------------
# RenderConfig.fingerprint
# ---------------------------------------------------------------------------

# one other valid value per field, each alone on the streaming base
_OTHER = dict(
    scene="chair", camera=Camera.square(32), res=32, window=8, num_slots=2,
    phi_deg=4.0, hole_cap=256, mode="temporal", engine="host",
    ray_chunk=2048, pool_holes=False, pool_bucket=256, pool_min_bucket=64,
    pool_safety=1.5, pool_ewma_alpha=0.5, adaptive_sampling=True,
    adaptive_var_threshold=0.001, coarse_factor=2,
    mvoxel_layout="bank_interleaved", fused_tick=True,
    shard=ShardConfig(num_devices=2), model_kind="ngp",
    backend="reference", grid_res=32, channels=8, decoder="mlp",
    num_samples=16, stream_capacity=256, scene_cache_bytes=1,
    device="cpu")
_BASE = RenderConfig(backend="streaming")


def test_every_field_has_a_mutation():
    assert set(_OTHER) == {f.name for f in dataclasses.fields(RenderConfig)}


@pytest.mark.parametrize("field", sorted(_OTHER))
def test_fingerprint_changes_with_every_field(field):
    other = _BASE.replace(**{field: _OTHER[field]})
    assert getattr(other, field) != getattr(_BASE, field)
    assert other.fingerprint() != _BASE.fingerprint()


def test_fingerprint_is_equal_for_equal_configs_and_stable():
    a = RenderConfig(res=16, window=2, device="cpu")
    b = RenderConfig(res=16, window=2, device="cpu")
    assert a is not b and a.fingerprint() == b.fingerprint()
    # the camera resolved from res is the camera given explicitly
    assert a.fingerprint() == a.replace(
        camera=Camera.square(16)).fingerprint()
    import hashlib

    assert a.fingerprint() == hashlib.sha1(
        repr(a.resolved()).encode()).hexdigest()[:12]
    assert len(a.fingerprint()) == 12
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.core.config import RenderConfig; "
            "print(RenderConfig(res=16, window=2, device='cpu')"
            ".fingerprint())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONHASHSEED="5"),
                         check=True, capture_output=True, text=True,
                         timeout=120).stdout.strip()
    assert out == a.fingerprint()


def test_fingerprint_coverage_refuses_an_escaped_field(monkeypatch):
    cfg_mod.verify_fingerprint_coverage()  # the shipped config is covered

    @dataclasses.dataclass(frozen=True)
    class Escaping(RenderConfig):
        secret: int = dataclasses.field(default=0, repr=False)

    monkeypatch.setattr(cfg_mod, "RenderConfig", Escaping)
    with pytest.raises(RuntimeError, match="secret"):
        cfg_mod.verify_fingerprint_coverage()
    # an escaped field changes nothing in the fingerprint: the guard's case
    assert Escaping(secret=1).fingerprint() == Escaping().fingerprint()
    monkeypatch.setattr(cfg_mod, "_NON_COMPILE_FIELDS",
                        frozenset({"secret"}))
    cfg_mod.verify_fingerprint_coverage()  # allowlisted with a reason
