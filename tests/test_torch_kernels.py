"""The port's attention kernels against the JAX reference.

On a host without a card, the port's wrappers take their plain PyTorch
versions (the tensors lie on the CPU); these are held against
``repro.kernels.ref`` and against the Pallas kernels run by the Pallas
interpreter, on the shapes of ``tests/test_kernels.py`` and with its
tolerances (float32 2e-5: the two frameworks sum in another order;
bfloat16 2e-2: one bf16 rounding of the probabilities).  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(a: np.ndarray, dtype_name: str = "float32"):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize(
    "b,h,kv,s,hd",
    [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128), (2, 2, 2, 64, 32)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_ref(b, h, kv, s, hd, dtype):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    out = ops.flash_attention(tq, tk, tv)
    assert out.dtype == tq.dtype and out.shape == (b, h, s, hd)
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention_ref(jq, jk, jv)), **_tol(dtype))


@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 8, 2, 256, 64), (2, 2, 2, 64, 32)])
def test_flash_plain_matches_pallas_interpreter(b, h, kv, s, hd):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    want = jops.flash_attention(jq, jk, jv, use_pallas=True, block_q=64, block_k=64)
    np.testing.assert_allclose(_np(ops.flash_attention(tq, tk, tv)), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_lengths_mask_matches_pallas_and_alone():
    """The padded-batch model: a short request padded to the batch's length
    gives what it gives alone, and what the Pallas kernel gives."""
    rng = np.random.default_rng(1)
    b, h, s, hd = 3, 4, 128, 64
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, h, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, h, s, hd)))
    lens = [128, 70, 17]
    out = ops.flash_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    want = jops.flash_attention(
        jq, jk, jv, jnp.array(lens, jnp.int32), use_pallas=True, block_q=64, block_k=64
    )
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)
    for i, L in enumerate(lens):
        alone = ops.flash_attention(tq[i : i + 1, :, :L], tk[i : i + 1, :, :L], tv[i : i + 1, :, :L])
        np.testing.assert_allclose(_np(out[i, :, :L]), _np(alone[0]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_plain_sliding_window(window):
    rng = np.random.default_rng(2)
    b, h, s, hd = 1, 2, 128, 32
    jq, tq = _pair(rng.normal(size=(b, h, s, hd)))
    jk, tk = _pair(rng.normal(size=(b, h, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, h, s, hd)))
    out = ops.flash_attention(tq, tk, tv, window=window)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, window=window)), rtol=2e-5, atol=2e-5
    )
    want = jops.flash_attention(jq, jk, jv, window=window, use_pallas=True, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_noncausal():
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng.normal(size=(1, 2, 64, 32)))
    jk, tk = _pair(rng.normal(size=(1, 2, 64, 32)))
    jv, tv = _pair(rng.normal(size=(1, 2, 64, 32)))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    want = jops.flash_attention(jq, jk, jv, causal=False, use_pallas=True, block_q=32, block_k=32)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_plain_fully_masked_rows_are_zero():
    """lengths == 0 without causality masks every key: zeros, not NaN."""
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng.normal(size=(2, 2, 48, 32)))
    jk, tk = _pair(rng.normal(size=(2, 2, 48, 32)))
    jv, tv = _pair(rng.normal(size=(2, 2, 48, 32)))
    lens = [0, 20]
    out = ops.flash_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32), causal=False)
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all()
    want = jref.flash_attention_ref(jq, jk, jv, causal=False, lengths=jnp.array(lens, jnp.int32))
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("b,h,kv,s,hd", [(2, 8, 2, 512, 64), (1, 4, 4, 256, 128), (4, 8, 1, 1024, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_ref(b, h, kv, s, hd, dtype):
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng.normal(size=(b, h, hd)), dtype)
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    valid = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid))
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


@pytest.mark.parametrize("s,block_k", [(300, 256), (96, 64), (7, 256), (130, 128)])
def test_decode_plain_matches_pallas_any_cache_length(s, block_k):
    rng = np.random.default_rng(9)
    b, h, kv, hd = 2, 4, 2, 64
    jq, tq = _pair(rng.normal(size=(b, h, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    valid = rng.integers(1, s + 1, size=(b,)).astype(np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True, block_k=block_k)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_plain_empty_rows():
    rng = np.random.default_rng(10)
    b, h, kv, s, hd = 3, 4, 2, 128, 64
    jq, tq = _pair(rng.normal(size=(b, h, hd)))
    jk, tk = _pair(rng.normal(size=(b, kv, s, hd)))
    jv, tv = _pair(rng.normal(size=(b, kv, s, hd)))
    valid = np.array([0, 77, 0], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(valid))
    assert torch.isfinite(out).all()
    assert (out[0] == 0).all() and (out[2] == 0).all()
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(valid), use_pallas=True, block_k=64)
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-5, atol=2e-5)


def test_decode_plain_matches_flash_last_row():
    rng = np.random.default_rng(5)
    b, h, s, hd = 1, 4, 128, 64
    _, tq = _pair(rng.normal(size=(b, h, s, hd)))
    _, tk = _pair(rng.normal(size=(b, h, s, hd)))
    _, tv = _pair(rng.normal(size=(b, h, s, hd)))
    full = ops.flash_attention(tq, tk, tv)
    dec = ops.decode_attention(tq[:, :, -1].contiguous(), tk, tv, torch.tensor([s], dtype=torch.int32))
    np.testing.assert_allclose(_np(full[:, :, -1]), _np(dec), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------- the wrappers
def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.normal(size=(1, 2, 16, 32)).astype(np.float32))
    qd = torch.from_numpy(rng.normal(size=(1, 2, 32)).astype(np.float32))
    ops.reset_launch_counts()
    a = ops.flash_attention(q, q, q, window=4)
    d = ops.decode_attention(qd, q, q, torch.tensor([9], dtype=torch.int32))
    torch.testing.assert_close(a, ref.flash_attention_ref(q, q, q, window=4), rtol=0, atol=0)
    torch.testing.assert_close(
        d, ref.decode_attention_ref(qd, q, q, torch.tensor([9], dtype=torch.int32)), rtol=0, atol=0
    )
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0}


def test_other_devices_raise():
    q = torch.empty((1, 2, 16, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        ops.decode_attention(q[:, :, 0], q, q, torch.empty((1,), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize(
    "case,err",
    [
        ("hd48", ValueError),
        ("float16", TypeError),
        ("kv_shape", ValueError),
        ("heads", ValueError),
        ("lengths_dtype", ValueError),
        ("inner_stride", ValueError),
    ],
)
def test_flash_checks_reject_what_the_kernel_does_not_take(case, err):
    q = torch.zeros((2, 4, 16, 64))
    k = torch.zeros((2, 2, 16, 64))
    lengths = None
    if case == "hd48":
        q, k = torch.zeros((2, 4, 16, 48)), torch.zeros((2, 2, 16, 48))
    elif case == "float16":
        q, k = q.half(), k.half()
    elif case == "kv_shape":
        k = torch.zeros((2, 2, 15, 64))
    elif case == "heads":
        k = torch.zeros((2, 3, 16, 64))
    elif case == "lengths_dtype":
        lengths = torch.zeros((2,), dtype=torch.int64)
    elif case == "inner_stride":
        q = torch.zeros((2, 4, 64, 16)).transpose(2, 3)
    with pytest.raises(err):
        fa_mod.check_inputs(q, k, k, lengths)


def test_flash_checks_accept_strided_views():
    """The model passes (B, S, H, hd) projections as (B, H, S, hd) views."""
    x = torch.zeros((2, 16, 4, 64)).transpose(1, 2)
    fa_mod.check_inputs(x, x, x, torch.zeros((2,), dtype=torch.int32))


@pytest.mark.parametrize(
    "case", ["dtype", "noncontig", "valid_dtype", "cache_shape", "hd48", "unaligned"]
)
def test_decode_checks_reject_what_the_kernel_does_not_take(case):
    q = torch.zeros((2, 4, 64))
    kc = torch.zeros((2, 2, 32, 64))
    valid = torch.zeros((2,), dtype=torch.int32)
    if case == "dtype":
        q = q.double()
    elif case == "noncontig":
        kc = torch.zeros((2, 2, 64, 32)).transpose(2, 3)
    elif case == "valid_dtype":
        valid = valid.long()
    elif case == "cache_shape":
        kc = torch.zeros((2, 2, 32, 32))
    elif case == "hd48":
        q, kc = torch.zeros((2, 4, 48)), torch.zeros((2, 2, 32, 48))
    elif case == "unaligned":  # contiguous, but 4 bytes past a 16-byte boundary
        kc = torch.zeros(2 * 2 * 32 * 64 + 1)[1:].view(2, 2, 32, 64)
    with pytest.raises((ValueError, TypeError)):
        dec_mod.check_inputs(q, kc, kc, valid)


def test_build_command_targets_hopper(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    for name in _build.KERNELS:
        out = _build.library_path(name)
        cmd = _build.nvcc_command(name, out)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-shared", "-O3", "-fPIC"} <= set(cmd)
        assert cmd[-1].endswith(f"csrc/{name}.cu")
        assert out.parent.name == "repro_torch_kernels" and out.parent.parent.name == "build"
        assert _build.library_path(name) == out  # keyed by content: stable
    assert _build.library_path("flash_attention") != _build.library_path("decode_attention")
