"""Slice 18 of the port: the reference's sharding spec trees and
strategies (``repro.models.*_specs``, ``repro.models.common``'s
``resolve_spec`` / ``guard_spec``, ``repro.parallel.sharding``), and the
port's twin of ``NamedSharding``: a spec laid onto a ``DeviceMesh`` as
DTensor placements.

The reference stacks a period's layers on a leading ``num_periods`` axis
(``P(None, *spec)``); the port holds one dict per layer. So its trees are
compared through the mapping ``convert._lm_tree`` uses: the port's layer
``p * period + i`` is the reference's pattern entry ``i`` with its leading
entry dropped. Every spec is compared value for value through JAX's own
``PartitionSpec`` equality and entry by entry. Each rank's block under a
placement is compared with JAX's ``NamedSharding(...).devices_indices_map``
computed in a subprocess over 8 forced CPU devices; the port's side runs
in a subprocess under torch's fake process group, one rank at a time."""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as j_registry
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.parallel import sharding as j_sharding
from repro_torch.configs import registry as t_registry
from repro_torch.models import common as t_common
from repro_torch.models import lm as t_lm
from repro_torch.models.common import P
from repro_torch.optim.adamw import tree_flatten
from repro_torch.parallel import sharding as t_sharding

ROOT = Path(__file__).resolve().parents[1]
ARCHS = t_registry.list_archs()
WIDTHS = ["reduced", "published"]


@pytest.fixture(autouse=True)
def _strategy_reset():
    """Every test leaves both packages' strategy as it found it."""
    before = (t_common.get_strategy(), j_common.get_strategy())
    yield
    t_common.set_strategy(before[0])
    j_common.set_strategy(before[1])


def _configs(arch: str, width: str):
    if width == "reduced":
        return t_registry.get_reduced(arch), j_registry.get_reduced(arch)
    return t_registry.get(arch), j_registry.get(arch)


def _per_layer(period_tree, cfg) -> list:
    """The reference's stacked pattern (a tuple of ``period`` trees whose
    specs lead with the stack entry) as the port's one tree per layer."""
    drop = lambda s: JP(*tuple(s)[1:])
    return [jax.tree.map(drop, period_tree[i],
                         is_leaf=lambda x: isinstance(x, JP))
            for _ in range(cfg.num_periods) for i in range(cfg.period)]


def _as_port_layout(tree: dict, cfg) -> dict:
    """The reference's LM tree in the port's layout (``convert._lm_tree``)."""
    out = {"embed": tree["embed"], "layers": _per_layer(tree["blocks"], cfg),
           "final_norm": tree["final_norm"]}
    if "head" in tree:
        out["head"] = tree["head"]
    if "encoder" in tree:
        out["encoder"] = {
            "layers": _per_layer(tree["encoder"]["blocks"],
                                 j_lm._encoder_cfg(cfg)),
            "final_norm": tree["encoder"]["final_norm"]}
    return out


def _same_specs(port, ref, path: str = "") -> int:
    """Asserts the trees hold equal specs at equal places; their count.
    Specs compare as JAX compares them (its ``PartitionSpec`` stores a
    one-axis tuple as the axis name) and entry by entry."""
    if isinstance(port, P):
        assert isinstance(ref, JP), (path, ref)
        assert JP(*port) == ref and tuple(JP(*port)) == tuple(ref), \
            (path, port, ref)
        return 1
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, set(port), set(ref))
        return sum(_same_specs(port[k], ref[k], f"{path}/{k}")
                   for k in port)
    assert isinstance(port, (list, tuple)) and len(port) == len(ref), path
    return sum(_same_specs(a, b, f"{path}/{i}")
               for i, (a, b) in enumerate(zip(port, ref)))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, width):
    """``param_specs``, ``opt_specs`` and ``cache_specs(shard_seq)``."""
    t_cfg, j_cfg = _configs(arch, width)
    n = _same_specs(t_lm.param_specs(t_cfg),
                    _as_port_layout(j_lm.param_specs(j_cfg), j_cfg))
    assert n == len(tree_flatten(t_lm.param_shapes(t_cfg))[0])
    j_opt = j_lm.opt_specs(j_cfg)
    _same_specs(t_lm.opt_specs(t_cfg),
                {k: _as_port_layout(j_opt[k], j_cfg) for k in ("m", "v")})
    for shard_seq in (False, True):
        _same_specs(t_lm.cache_specs(t_cfg, shard_seq=shard_seq),
                    _per_layer(j_lm.cache_specs(j_cfg, shard_seq=shard_seq),
                               j_cfg))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_strategies_match_reference(arch, width):
    """``apply_strategy`` under each strategy, the port on its meta shapes,
    the reference on its ``eval_shape`` shapes; ``default_strategy``; and
    the meta shapes and dtypes against ``eval_shape``'s, layer by layer."""
    t_cfg, j_cfg = _configs(arch, width)
    t_shapes = t_lm.param_shapes(t_cfg)
    j_shapes = jax.eval_shape(lambda: j_lm.init_params(j_cfg,
                                                       jax.random.key(0)))
    for strategy in ("tp", "tp+fsdp", "fsdp"):
        _same_specs(
            t_sharding.apply_strategy(t_lm.param_specs(t_cfg), t_shapes,
                                      strategy),
            _as_port_layout(j_sharding.apply_strategy(
                j_lm.param_specs(j_cfg), j_shapes, strategy), j_cfg))
    assert t_sharding.default_strategy(t_cfg) == \
        j_sharding.default_strategy(j_cfg)
    # each stacked leaf's shape without its leading num_periods axis
    whole = lambda a: (tuple(a.shape), str(a.dtype))
    layer = lambda a: (tuple(a.shape[1:]), str(a.dtype))
    got = _port_shapes(t_shapes)
    for k in ("embed", "head", "final_norm"):
        if k in got:
            assert got[k] == jax.tree.map(whole, j_shapes[k])
    assert got["layers"] == _per_layer_shapes(j_shapes["blocks"], j_cfg,
                                              layer)
    if "encoder" in got:
        assert got["encoder"]["layers"] == _per_layer_shapes(
            j_shapes["encoder"]["blocks"], j_lm._encoder_cfg(j_cfg), layer)


def _per_layer_shapes(period_tree, cfg, layer) -> list:
    return [jax.tree.map(layer, period_tree[i])
            for _ in range(cfg.num_periods) for i in range(cfg.period)]


def _port_shapes(tree):
    if isinstance(tree, dict):
        return {k: _port_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_shapes(v) for v in tree]
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_shapes_are_init_params(arch):
    """``param_shapes`` (meta, no memory) against ``init_params`` on the
    CPU: the same tree, shapes and dtypes."""
    import torch

    cfg = t_registry.get_reduced(arch)
    meta = t_lm.param_shapes(cfg)
    real = t_lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    m_leaves, m_def = tree_flatten(meta)
    r_leaves, r_def = tree_flatten(real)
    assert all(t.device.type == "meta" for t in m_leaves)
    assert [(t.shape, t.dtype) for t in m_leaves] == \
        [(t.shape, t.dtype) for t in r_leaves]


class FakeMesh:
    """The reference test's stand-in mesh: names and sizes only."""

    def __init__(self, names, sizes):
        self.axis_names, self.axis_sizes = names, sizes


def test_resolve_and_guard_spec():
    """The reference's ``test_resolve_and_guard_spec``, ported."""
    m = FakeMesh(("data", "model"), (4, 4))
    assert t_common.resolve_spec(P(("pod", "data"), "model"),
                                 m.axis_names) == P(("data",), "model")
    # strict drops non-divisible; permissive keeps
    assert t_common.guard_spec(P("model"), (14,), m, strict=True) == P(None)
    assert t_common.guard_spec(P("model"), (14,), m, strict=False) == \
        P("model")
    assert t_common.guard_spec(P("data"), (1,), m) == P(None)


def test_fsdp_strategy_adds_data_axis():
    """The reference's ``test_fsdp_strategy_adds_data_axis``, ported."""
    import torch

    specs = {"w": P(None, "model")}
    shapes = {"w": torch.empty((4096, 1024), dtype=torch.bfloat16,
                               device="meta")}
    out = t_sharding.apply_strategy(specs, shapes, "tp+fsdp")
    assert out["w"] == P(("pod", "data"), "model")
    specs2 = {"w": P(("pod", "data"), None)}
    assert t_sharding.apply_strategy(specs2, shapes, "tp+fsdp")["w"] == \
        specs2["w"]
    with pytest.raises(ValueError):
        t_sharding.apply_strategy(specs, shapes, "zero")


MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"),
                                          (2, 16, 16)),
          (("data", "model"), (4, 4))]


def _leaf_pairs(port, ref, shapes) -> list:
    """(port spec, reference spec, shape) at each leaf, walking the trees
    together by key."""
    if isinstance(port, P):
        return [(port, ref, tuple(shapes.shape))]
    keys = port if isinstance(port, dict) else range(len(port))
    return [x for k in keys for x in _leaf_pairs(port[k], ref[k], shapes[k])]


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_and_guard_match_reference_on_arch_specs(arch):
    """Every param spec of the arch at published widths, under each
    strategy's tree and each global strategy: ``resolve_spec`` and
    ``guard_spec`` (strict and permissive) on the production meshes and a
    small one equal the reference's, on the same shapes."""
    t_cfg, j_cfg = _configs(arch, "published")
    t_shapes = t_lm.param_shapes(t_cfg)
    j_shapes = jax.eval_shape(lambda: j_lm.init_params(j_cfg,
                                                       jax.random.key(0)))
    # the cache specs need no shapes to resolve
    for shard_seq in (False, True):
        t_cache = t_lm.cache_specs(t_cfg, shard_seq=shard_seq)
        j_cache = _per_layer(j_lm.cache_specs(j_cfg, shard_seq=shard_seq),
                             j_cfg)
        for global_strategy in ("tp", "fsdp"):
            t_common.set_strategy(global_strategy)
            j_common.set_strategy(global_strategy)
            for names, _ in MESHES:
                _same_specs(t_common.resolve_tree(t_cache, names),
                            jax.tree.map(
                                lambda s: j_common.resolve_spec(s, names),
                                j_cache,
                                is_leaf=lambda x: isinstance(x, JP)))
    for tree_strategy in ("tp", "fsdp"):
        t_specs = t_sharding.apply_strategy(t_lm.param_specs(t_cfg),
                                            t_shapes, tree_strategy)
        j_specs = _as_port_layout(j_sharding.apply_strategy(
            j_lm.param_specs(j_cfg), j_shapes, tree_strategy), j_cfg)
        pairs = _leaf_pairs(t_specs, j_specs, t_shapes)
        assert len(pairs) == len(tree_flatten(t_shapes)[0])
        for global_strategy in ("tp", "fsdp"):
            t_common.set_strategy(global_strategy)
            j_common.set_strategy(global_strategy)
            for names, sizes in MESHES:
                m = FakeMesh(names, sizes)
                for t_spec, j_spec, shape in pairs:
                    assert JP(*t_common.resolve_spec(t_spec, names)) == \
                        j_common.resolve_spec(j_spec, names)
                    for strict in (False, True):
                        got = t_common.guard_spec(t_spec, shape, m, strict)
                        want = j_common.guard_spec(j_spec, shape, m, strict)
                        assert JP(*got) == want and \
                            tuple(JP(*got)) == tuple(want), (shape, got, want)


def test_strategy_state_and_shard():
    assert t_common.get_strategy() == "tp"
    t_common.set_strategy("fsdp")
    assert t_common.get_strategy() == "fsdp"
    assert t_common.resolve_spec(P(("pod", "data"), "model"),
                                 ("data", "model")) == \
        P(("data", "model"), None)
    with pytest.raises(AssertionError):
        t_common.set_strategy("zero")
    import torch

    x = torch.ones(3)
    assert t_common.current_mesh() is None
    assert t_common.shard(x, P("model")) is x


def test_spec_is_a_tuple_that_survives_pickle():
    spec = P(("pod", "data"), None, "model")
    assert spec == (("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is P
    assert repr(P("model")) == "P('model',)"


# ---------------------------------------------------------------------------
# placements against JAX's devices_indices_map
# ---------------------------------------------------------------------------

# (mesh, spec, shape, strict): single axes, multi-axis tuples, an axis the
# mesh lacks, a size-1 dim, strict drops, and permissive dims one axis does
# not divide (GSPMD's padded tiles)
PLACEMENT_CASES = {
    "model_rows": ("2x4", ("model", None), (8, 3), True),
    "data_cols": ("2x4", (None, "data"), (3, 4), True),
    "pod_data_model": ("2x4", (("pod", "data"), "model"), (8, 8), True),
    "all_axes_rows": ("2x4", (("pod", "data", "model"), None), (16, 2),
                      True),
    "data_model_1d": ("2x4", (("data", "model"),), (8,), True),
    "missing_axis": ("2x4", ("pod", None), (4, 4), True),
    "size_one_dim": ("2x4", ("data", None), (1, 4), True),
    "strict_drops": ("2x4", ("model",), (6,), True),
    "permissive_uneven": ("2x4", ("model", None), (10, 3), False),
    "permissive_short": ("2x4", (None, "model"), (2, 5), False),
    "cube_kv_cache": ("2x2x2", (("pod", "data"), None, "model", None),
                      (4, 2, 8, 4), True),
    "cube_all_axes": ("2x2x2", (("pod", "data", "model"),), (16,), True),
    "cube_pod_only": ("2x2x2", ("pod", "model", None), (4, 5, 2), False),
    "cube_fsdp_cols": ("2x2x2", (None, ("pod", "data")), (3, 8), True),
}
MESH_SHAPES = {"2x4": (("data", "model"), (2, 4)),
               "2x2x2": (("pod", "data", "model"), (2, 2, 2))}

_JAX_SIDE = """
import json, itertools
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax._src.op_shardings import get_num_ways_dim_sharded
from repro.models.common import guard_spec
cases, meshes = json.loads({payload!r})
def spec(entries):
    return P(*[tuple(e) if isinstance(e, list) else e for e in entries])
def padded(s, shape):
    # GSPMD's tiles: ceil(n / k) long, the last ones short or empty
    hlo = s._to_xla_hlo_sharding(len(shape))
    if hlo.is_replicated():
        return {{d.id: [[0, n] for n in shape] for d in s._device_assignment}}
    parts, reps = get_num_ways_dim_sharded(hlo)
    axes = []
    for n, k in zip(shape, parts):
        c = -(-n // k)
        axes.append([[min(i * c, n), min((i + 1) * c, n)] for i in range(k)])
    devs = iter(hlo.tile_assignment_devices())
    out = {{}}
    for idx in itertools.product(*axes):
        for _ in range(reps):
            out[next(devs)] = [list(b) for b in idx]
    return out
res = {{}}
for name, (mesh_key, entries, shape, strict) in cases.items():
    names, sizes = meshes[mesh_key]
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(sizes), tuple(names))
    g = guard_spec(spec(entries), tuple(shape), mesh, strict=strict)
    s = NamedSharding(mesh, g)
    blocks = padded(s, shape)
    try:
        exact = s.devices_indices_map(tuple(shape))
        exact = {{d.id: [[sl.start or 0, n if sl.stop is None else sl.stop]
                        for sl, n in zip(idx, shape)]
                 for d, idx in exact.items()}}
        assert exact == blocks, (name, exact, blocks)
        mapped = True
    except ValueError:
        mapped = False  # JAX maps no dim its axes do not divide
    res[name] = {{"spec": [list(e) if isinstance(e, tuple) else e
                          for e in g],
                  "blocks": {{str(d): b for d, b in blocks.items()}},
                  "mapped": mapped}}
print(json.dumps(res))
"""

_PORT_SIDE = """
import json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models.common import P
from repro_torch.parallel import sharding
cases, meshes = json.loads({payload!r})
res = {{name: {{"blocks": {{}}}} for name in cases}}
for rank in range(8):
    for mesh_key, (names, sizes) in meshes.items():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(sizes),
                          mesh_dim_names=tuple(names))
        for name, (key, entries, shape, strict) in cases.items():
            if key != mesh_key:
                continue
            spec = P(*[tuple(e) if isinstance(e, list) else e
                       for e in entries])
            ns = sharding.named_sharding(mesh, spec, tuple(shape), strict)
            local, offset = sharding.local_block(ns, shape)
            res[name]["blocks"][str(rank)] = [[o, o + n] for o, n in
                                              zip(offset, local)]
            res[name]["spec"] = [list(e) if isinstance(e, tuple) else e
                                 for e in ns.spec]
            res[name]["placements"] = [repr(p) for p in ns.placements]
        dist.destroy_process_group()
print(json.dumps(res))
"""


def _start(code: str, env: dict) -> subprocess.Popen:
    payload = json.dumps([PLACEMENT_CASES, MESH_SHAPES])
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code.format(payload=payload))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env))


@pytest.fixture(scope="module")
def both_sides():
    """Both subprocesses at once: JAX on 8 forced CPU devices, the port
    under the fake process group."""
    procs = [_start(_JAX_SIDE, {
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}),
        _start(_PORT_SIDE, {})]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.mark.parametrize("case", sorted(PLACEMENT_CASES))
def test_placements_give_jax_blocks(both_sides, case):
    """Each rank's block (offset and shape) equals the one JAX gives device
    ``rank`` (the meshes list devices and ranks in the same order), and the
    guarded specs agree. A dim one axis does not divide, kept only when
    not strict, has no ``devices_indices_map`` in JAX; its blocks are held
    against GSPMD's padded tiles of JAX's own tile assignment."""
    j_res, t_res = (side[case] for side in both_sides)
    spec = lambda entries: JP(*[tuple(e) if isinstance(e, list) else e
                                for e in entries])
    assert spec(t_res["spec"]) == spec(j_res["spec"])
    assert t_res["blocks"] == j_res["blocks"]
    uneven = case.startswith("permissive") or case == "cube_pod_only"
    assert j_res["mapped"] != uneven


def test_placements_name_mesh_dims(both_sides):
    t_res = both_sides[1]
    assert t_res["pod_data_model"]["placements"] == [
        "Shard(dim=0)", "Shard(dim=1)"]
    assert t_res["cube_kv_cache"]["placements"] == [
        "Shard(dim=0)", "Shard(dim=0)", "Shard(dim=2)"]
    assert t_res["missing_axis"]["placements"] == ["Replicate()"] * 2
    assert t_res["strict_drops"]["placements"] == ["Replicate()"] * 2


class _Mesh:
    """Names and shape, as ``placements`` reads a ``DeviceMesh``."""

    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 2, 2)


def test_placements_refuse_what_dtensor_cannot_lay_out():
    with pytest.raises(ValueError, match="in mesh order"):
        t_sharding.placements(P(("model", "data")), _Mesh())
    with pytest.raises(ValueError, match="shards two dims"):
        t_sharding.placements(P("data", "data"), _Mesh())
    with pytest.raises(ValueError, match="do not divide"):
        t_sharding.named_sharding(_Mesh(), P(("pod", "data")), (6,),
                                  strict=False)
