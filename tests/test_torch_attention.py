"""The port's attention (``kernels.ref.attention_ref``,
``kernels.flash_attention.flash_attention_plain``, ``kernels.ops``,
``models.modules.chunked_attention``) against the JAX package on NumPy
inputs from a seed, and the port's ``ops.xnor_gemm`` /
``ops.binary_conv2d`` bit-exact against the JAX ops.

The attention cases are those of ``tests/test_kernels_attention.py``
(GQA/MQA/MHA, causal and full, a block sweep, Sq = 1 decode, bf16,
logits x 30), each held at that file's tolerance against both JAX
oracles: ``attention_ref`` and the Pallas kernel run in interpret mode
(``ops.flash_attention(backend="pallas", interpret=True)``), computed
once per case.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here ``backend="cuda"`` takes its plain
version because the tensors lie on the CPU."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as R_OPS  # noqa: E402
from repro.kernels.ref import attention_ref as r_attention_ref  # noqa: E402
from repro.models import modules as R_M  # noqa: E402
from repro_torch.kernels import flash_attention_cuda, launch_counts  # noqa: E402
from repro_torch.kernels import ops as T_OPS  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models import modules as T_M  # noqa: E402

# name: (b, h, hkv, sq, sk, d, dtype, causal, q_blk, k_blk, tol, logit x)
CASES = {
    **{f"prefill-{b}-{h}-{hkv}-{s}-{d}-{'causal' if c else 'full'}":
       (b, h, hkv, s, s, d, "float32", c, 64, 64, 2e-5, 1.0)
       for b, h, hkv, s, d in ((1, 1, 1, 128, 32), (2, 4, 2, 256, 64),
                               (1, 8, 1, 128, 128), (2, 6, 6, 64, 64))
       for c in (True, False)},
    **{f"sweep-{qb}-{kb}": (2, 4, 2, 256, 256, 64, "float32", True, qb, kb,
                            2e-5, 1.0)
       for qb, kb in ((32, 32), (64, 128), (128, 64))},
    "decode-sq1": (2, 4, 2, 1, 512, 64, "float32", True, 1, 128, 2e-5, 1.0),
    "bf16": (1, 2, 1, 128, 128, 64, "bfloat16", True, 64, 64, 2e-2, 1.0),
    "logits-x30": (1, 1, 1, 128, 128, 32, "float32", True, 32, 32, 5e-5,
                   30.0),
}
_JAX: dict = {}


def _inputs(name):
    b, h, hkv, sq, sk, d, dt, *_, scale_up = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((b, h, sq, d), dtype=np.float32) * scale_up
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    return q, k, v, dt


def _jax_outputs(name):
    """(JAX attention_ref, JAX Pallas interpret) for a case, once."""
    if name not in _JAX:
        q, k, v, dt = _inputs(name)
        causal, qb, kb = CASES[name][7:10]
        jq, jk, jv = (jnp.asarray(x).astype(dt) for x in (q, k, v))
        ref = np.asarray(r_attention_ref(jq, jk, jv, causal=causal),
                         np.float32)
        pal = np.asarray(R_OPS.flash_attention(
            jq, jk, jv, causal=causal, backend="pallas", interpret=True,
            q_blk=qb, k_blk=kb).astype(jnp.float32))
        _JAX[name] = ref, pal
    return _JAX[name]


def _port(fn_name, name):
    q, k, v, dt = _inputs(name)
    causal, qb, kb = CASES[name][7:10]
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dt))
                  for x in (q, k, v))
    fns = {
        "attention_ref": lambda: attention_ref(tq, tk, tv, causal=causal),
        "flash_attention_plain": lambda: flash_attention_plain(
            tq, tk, tv, causal=causal, q_blk=qb, k_blk=kb),
        "ops_ref": lambda: T_OPS.flash_attention(
            tq, tk, tv, causal=causal, backend="ref", q_blk=qb, k_blk=kb),
        "ops_cuda_on_cpu": lambda: T_OPS.flash_attention(
            tq, tk, tv, causal=causal, backend="cuda", q_blk=qb, k_blk=kb),
    }
    out = fns[fn_name]()
    want_dtype = torch.float32 if fn_name == "attention_ref" else tq.dtype
    assert out.dtype == want_dtype and tuple(out.shape) == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("fn_name", ["attention_ref", "flash_attention_plain",
                                     "ops_ref", "ops_cuda_on_cpu"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_matches_jax(name, fn_name):
    tol = CASES[name][10]
    before = launch_counts()["flash_attention_cuda"]
    got = _port(fn_name, name)
    assert launch_counts()["flash_attention_cuda"] == before  # CPU: no kernel
    assert np.isfinite(got).all()
    ref, pal = _jax_outputs(name)
    np.testing.assert_allclose(ref, got, atol=tol, rtol=tol)
    np.testing.assert_allclose(pal, got, atol=tol, rtol=tol)


# (b, sq, sk, h, hkv, d, causal, q_chunk, kv_chunk, kv_offset)
CHUNKED = {
    "ragged-causal": (2, 37, 37, 4, 2, 16, True, 8, 16, 0),
    "ragged-full": (2, 19, 23, 4, 4, 16, False, 8, 8, 0),
    "suffix-offset": (2, 5, 29, 6, 2, 32, True, 4, 8, 24),
    "offset-3": (1, 20, 20, 4, 1, 16, True, 8, 4, 3),
    "one-chunk": (2, 17, 17, 2, 2, 64, True, 64, 64, 0),
}


@pytest.mark.parametrize("name", sorted(CHUNKED))
def test_chunked_attention_matches_jax(name):
    b, sq, sk, h, hkv, d, causal, qc, kc, off = CHUNKED[name]
    rng = np.random.default_rng(100 + sorted(CHUNKED).index(name))
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    v = rng.standard_normal((b, sk, hkv, d), dtype=np.float32)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, kv_offset=off)
    want = np.asarray(R_M.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    for fn in (T_M.chunked_attention, T_M.chunked_attention_plain):
        got = fn(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), **kw)
        assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
        np.testing.assert_allclose(want, got.numpy(), atol=1e-5, rtol=1e-5)


def _words(rng, *shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("backend", ["ref", "variant"])
@pytest.mark.parametrize("aspects", [("X",), ("Y", "Z"), ("X", "Y", "Z")])
def test_xnor_ops_bit_exact_vs_jax(backend, aspects):
    rng = np.random.default_rng(len(aspects) * 7 + len(backend))
    a, w = _words(rng, 2, 37, 5), _words(rng, 21, 5)
    want = np.asarray(R_OPS.xnor_gemm(
        jnp.asarray(a), jnp.asarray(w), k_true=150, aspects=aspects,
        backend=backend))
    got = T_OPS.xnor_gemm(torch.from_numpy(a), torch.from_numpy(w),
                          k_true=150, aspects=aspects, backend=backend)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    x, cw = _words(rng, 2, 6, 5, 3), _words(rng, 40, 27)
    want = np.asarray(R_OPS.binary_conv2d(
        jnp.asarray(x), jnp.asarray(cw), k_true=80, aspects=aspects,
        backend=backend))
    for be in (backend, "cuda"):   # "cuda" on CPU tensors: the plain GEMM
        got = T_OPS.binary_conv2d(torch.from_numpy(x), torch.from_numpy(cw),
                                  k_true=80, aspects=aspects, backend=be)
        assert got.shape == (2, 6, 5, 40)
        assert np.array_equal(got.numpy(), want)


def test_ops_refuse_what_the_reference_refuses():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 2, 96, 32), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1, 96, 32), dtype=np.float32))
    # Sq = 96 is not a multiple of q_blk = 64, in both packages
    with pytest.raises(ValueError, match="multiples"):
        R_OPS.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                              jnp.asarray(k.numpy()), backend="pallas",
                              interpret=True, q_blk=64, k_blk=32)
    with pytest.raises(ValueError, match="multiples"):
        T_OPS.flash_attention(q, k, k, backend="cuda", q_blk=64, k_blk=32)
    # the plain tier takes any length, as the reference's does
    assert T_OPS.flash_attention(q, k, k, backend="ref", q_blk=64).shape == \
        q.shape
    with pytest.raises(ValueError, match='"cuda"'):
        T_OPS.flash_attention(q, k, k, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        T_OPS.flash_attention(q, k, k, backend="variant")
    a, w = torch.zeros((1, 4, 2), dtype=torch.int32), torch.zeros(
        (3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match='"cuda"'):
        T_OPS.xnor_gemm(a, w, k_true=64, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        T_OPS.xnor_gemm(a, w, k_true=64, backend="xla")
    # 3 query heads do not share 2 kv heads; a shape mismatch raises
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :1].expand(1, 3, 96, 32), k.expand(
            1, 2, 96, 32), k.expand(1, 2, 96, 32))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, k[..., :16], k[..., :16])
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_cuda(q.to("meta"), k.to("meta"), k.to("meta"))


def test_plain_kernel_semantics_beyond_the_reference():
    """What the kernel's plain version defines on its own: a query that
    sees no key gets a zero row, an explicit kv_offset moves the causal
    diagonal, and strided (B,S,H,D) views give the contiguous result."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 32), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 4, 32), dtype=np.float32))
    out = flash_attention_plain(q, k, k, causal=True)     # offset 4 - 8
    assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
    want = attention_ref(q[:, :, 4:], k, k, causal=True)
    torch.testing.assert_close(out[:, :, 4:], want, atol=1e-6, rtol=1e-6)
    shifted = flash_attention_plain(q[:, :, :4], k, k, kv_offset=1, q_blk=2,
                                    k_blk=2)
    full = flash_attention_plain(q[:, :, :4], k, k, causal=False)
    torch.testing.assert_close(shifted[:, :, 3], full[:, :, 3])
    bshd = q.transpose(1, 2).contiguous()
    got = flash_attention_cuda(bshd.transpose(1, 2), k, k, kv_offset=7)
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, k, kv_offset=7))
