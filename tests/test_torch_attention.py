"""The port's flash attention (B6): its plain version and ``ops.mha``
against the JAX package's Pallas kernel (interpret mode on the CPU) and
``ops.mha``, on the same numpy inputs; decode-shaped calls against
``attn_decode``'s masked einsum; and the wrapper's device rule (CPU tensors
-> plain version, CUDA -> kernel, else raise).

The causal mask is top-left (``qpos >= kpos`` from 0), as the Pallas
kernel's; ``sq != sk`` is held against that kernel, not against the
bottom-right oracle ``ref.attention_ref``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as j_ops
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops

# the reference's own attention tolerances (tests/test_kernels.py)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, h, kvh, sq, sk, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, kvh, sk, d)).astype(dtype)
    v = rng.standard_normal((b, kvh, sk, d)).astype(dtype)
    return q, k, v


def _close(got: torch.Tensor, want, **tol):
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("b,h,kvh,s,d,causal", [
    (2, 4, 2, 256, 64, True),
    (1, 8, 8, 128, 32, True),
    (2, 4, 1, 192, 64, True),
    (1, 2, 2, 128, 64, False),
    (1, 10, 2, 128, 32, True),  # GQA group 5, as qwen2.5-32b's 40/8
])
def test_mha_matches_pallas(b, h, kvh, s, d, causal):
    q, k, v = _qkv(s + h, b, h, kvh, s, s, d)
    want = j_ops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=64, block_k=64, interpret=True)
    got = t_ops.mha(torch.as_tensor(q), torch.as_tensor(k),
                    torch.as_tensor(v), causal=causal, block_q=64,
                    block_k=64)
    _close(got, want)
    plain = t_fa.flash_attention_plain(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), causal=causal)
    _close(plain, want)


@pytest.mark.parametrize("s,causal", [(100, False), (100, True), (70, False)])
def test_mha_padded_kv_masked(s, causal):
    """Sequences that are no block multiple: ops.mha pads and passes
    kv_len, and the padded rows never enter the softmax."""
    q, k, v = _qkv(s, 1, 2, 2, s, s, 32)
    want = j_ops.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=64, block_k=64, interpret=True)
    got = t_ops.mha(torch.as_tensor(q), torch.as_tensor(k),
                    torch.as_tensor(v), causal=causal, block_q=64,
                    block_k=64)
    _close(got, want)


@pytest.mark.parametrize("sq,sk,kv_len", [(64, 128, None), (128, 64, None),
                                          (64, 128, 100)])
def test_causal_is_top_left_as_the_pallas_kernel(sq, sk, kv_len):
    q, k, v = _qkv(sq + sk, 1, 4, 2, sq, sk, 32)
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, block_q=64,
                                block_k=64, kv_len=kv_len, interpret=True)
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=True,
                               kv_len=kv_len)
    _close(got, want)
    # row 0 sees key 0 only: top-left, not the oracle's bottom-right
    np.testing.assert_allclose(got[0, :, 0].numpy(),
                               v[0, :, 0].repeat(2, axis=0), **TOL)


def _decode_einsum(q, kc, vc, index):
    """``attn_decode``'s attention (src/repro/models/attention.py:235-256):
    the group's queries against the cache, keys <= index valid."""
    b, h, _, d = q.shape
    kvh = kc.shape[1]
    qg = jnp.asarray(q).reshape(b, kvh, h // kvh, d)
    s = jnp.einsum("bkgd,bkld->bkgl", qg, jnp.asarray(kc)) * d**-0.5
    valid = jnp.arange(kc.shape[2])[None, :] <= index
    s = jnp.where(valid[:, None, None, :], s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    o = jnp.einsum("bkgl,bkld->bkgd", p, jnp.asarray(vc))
    return o.reshape(b, h, 1, d)


@pytest.mark.parametrize("b,h,kvh,sk,d,index", [
    (2, 10, 2, 128, 64, 76),  # group 5
    (3, 4, 2, 64, 128, 0),  # only the first key
    (1, 8, 1, 96, 64, 95),  # group 8, the whole cache
])
def test_decode_matches_attn_decode_einsum(b, h, kvh, sk, d, index):
    q, k, v = _qkv(index + sk, b, h, kvh, 1, sk, d)
    want = _decode_einsum(q, k, v, index)
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=False,
                               kv_len=index + 1)
    _close(got, want)
    if sk % 32 == 0:  # and the Pallas kernel itself, at block_q = 1
        pallas = j_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
            block_q=1, block_k=32, kv_len=index + 1, interpret=True)
        _close(got, pallas)


def test_bf16_plain_matches_pallas():
    q, k, v = _qkv(5, 1, 10, 2, 64, 64, 64)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = j_fa.flash_attention(bf(q), bf(k), bf(v), causal=True, block_q=32,
                                block_k=32, interpret=True)
    tb = lambda a: torch.as_tensor(a).to(torch.bfloat16)
    got = t_fa.flash_attention(tb(q), tb(k), tb(v), causal=True)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want.astype(jnp.float32)), atol=3e-2, rtol=3e-2)


def test_wrapper_device_rule_and_kernel_limits():
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 4, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="no kernel"):
        t_fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    # what a CUDA tensor meets before any launch (no build happens)
    q32, k32, v32 = (t[..., :32].contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="head_dim 32"):
        t_fa._launch_kernel(q32, k32, v32, causal=True, sm_scale=None,
                            kv_len=None)
    with pytest.raises(TypeError, match="dtype"):
        t_fa._launch_kernel(q.half(), k.half(), v.half(), causal=True,
                            sm_scale=None, kv_len=None)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="kv_len"):
            t_fa.flash_attention(q, k, v, kv_len=bad)
    with pytest.raises(ValueError, match="GQA"):
        t_fa.flash_attention(q[:, :3], k, v)
    assert t_fa.KERNEL.launches == 0 and t_fa.KERNEL._lib is None


# arm F's first decode tick: 4 slots x 8 KV heads over a 2,084-row cache
ARM_F_SK, ARM_F_BKVH = 2084, 32


@pytest.mark.parametrize("bkvh", [1, ARM_F_BKVH])
@pytest.mark.parametrize("sk", [1, 63, 64, 65, ARM_F_SK])
def test_decode_split_plan_covers_the_cache_once(sk, bkvh):
    target = 2 * t_fa.H100_SMS
    splits, split_len = t_fa.decode_split_plan(sk, bkvh, target)
    ranges = [range(s * split_len, min((s + 1) * split_len, sk))
              for s in range(splits)]
    assert ranges[0].start == 0
    assert sorted(key for r in ranges for key in r) == list(range(sk))
    assert all(len(r) > 0 for r in ranges)
    assert split_len % t_fa.DECODE_TILE == 0
    # the target is met unless the ranges are already one tile long
    assert splits * bkvh >= target or split_len == t_fa.DECODE_TILE


def test_decode_split_plan_reaches_the_target_at_arm_f():
    splits, split_len = t_fa.decode_split_plan(ARM_F_SK, ARM_F_BKVH)
    assert splits * ARM_F_BKVH >= 2 * t_fa.H100_SMS
    # the same grid at every kv_len of the run: the plan reads Sk only
    assert (splits, split_len) == (11, 192)


@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 129, 200])
def test_decode_partials_and_combine_match_attn_decode(kv_len):
    """The split-KV decode's plain versions (the arithmetic its two
    kernels do): per-range partials merged by log-sum-exp equal one
    softmax over the valid keys, ranges past kv_len included."""
    b, h, kvh, sk, d = 2, 10, 2, 200, 64
    q, k, v = _qkv(kv_len, b, h, kvh, 1, sk, d)
    splits, split_len = t_fa.decode_split_plan(sk, b * kvh, 32)
    assert splits == 4  # ranges of 64; kv_len 1 leaves three empty
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    m, l, o = t_fa.decode_partials_plain(tq, tk, tv, kv_len=kv_len,
                                         splits=splits, split_len=split_len)
    empty = [s for s in range(splits) if s * split_len >= kv_len]
    assert bool((m[:, :, empty] == t_fa.NEG_INF).all())
    assert bool((l[:, :, empty] == 0).all() and (o[:, :, empty] == 0).all())
    got = t_fa.decode_combine_plain(m, l, o, torch.float32)
    _close(got, _decode_einsum(q, k, v, kv_len - 1))
    _close(got, t_fa.flash_attention_plain(tq, tk, tv, causal=False,
                                           kv_len=kv_len))
