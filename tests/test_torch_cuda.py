"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports no JAX, so it also runs on a card's host that
has none: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: float32 1e-4 for attention (the kernel sums in another order
than the plain version's matrix products) and 1e-5 for RMSNorm and the
gates (one sum per row in another order), bfloat16 2e-2 (one bf16 rounding
of the probabilities or the output); the gating's expert ids must be equal.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import moe_gating as gating_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda tests/test_torch_cuda.py` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32
    return torch.device("cuda")


def _randn(gen, shape, dev, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,dtype,window,lengths",
    [
        (8, 12, 12, 256, 64, torch.float32, 0, None),  # the prefill path's largest batch
        (8, 56, 8, 256, 128, torch.float32, 0, None),  # Arctic's, GQA 7:1
        (2, 8, 2, 256, 64, torch.float32, 0, None),  # GQA 4:1
        (2, 4, 4, 256, 64, torch.bfloat16, 0, None),
        (2, 4, 2, 300, 128, torch.float32, 0, None),  # ragged S, hd 128
        (4, 4, 4, 256, 64, torch.float32, 0, [256, 70, 17, 1]),
        (2, 4, 4, 256, 32, torch.float32, 64, None),  # sliding window
        (8, 12, 12, 32, 64, torch.float32, 0, None),  # the smallest bucket: 32-row query tiles
        (3, 4, 2, 1, 64, torch.float32, 0, None),  # S = 1
        (2, 14, 2, 256, 128, torch.float32, 96, [256, 131]),  # GQA 7:1, hd 128, lengths and a window
        (2, 14, 2, 256, 128, torch.bfloat16, 0, None),  # bf16 at hd 128, GQA 7:1
    ],
)
def test_flash_kernel_matches_plain(cuda_device, b, h, kv, s, hd, dtype, window, lengths):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    v = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fa_mod.launches
    out = ops.flash_attention(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, lengths=lens, window=window)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_kernel_takes_strided_views_and_empty_rows(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = _randn(g, (3, 3, 96, 4, 64), cuda_device)  # (3, B, S, H, hd) like a q/k/v projection
    q, k, v = (t.transpose(1, 2) for t in x)  # (B, H, S, hd) views
    lens = torch.tensor([0, 50, 96], dtype=torch.int32, device=cuda_device)
    out = ops.flash_attention(q, k, v, lens, causal=False)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    want = ref.flash_attention_ref(q, k, v, lengths=lens, causal=False)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,valid,dtype",
    [
        (8, 12, 12, 256, 64, None, torch.float32),  # the decode path's shape
        (8, 56, 8, 256, 128, None, torch.float32),  # Arctic's: GQA 7:1, one head per pass
        (4, 12, 12, 300, 64, None, torch.float32),  # ragged S
        (4, 12, 12, 256, 64, [0, 77, 0, 256], torch.float32),  # empty rows
        (2, 8, 2, 512, 64, None, torch.bfloat16),  # GQA 4:1
        (2, 6, 2, 130, 128, None, torch.float32),  # GQA 3:1, hd 128
        (3, 4, 2, 7, 32, [7, 0, 3], torch.float32),  # GQA 2:1, hd 32, S < one tile
        (8, 8, 8, 256, 64, [0, 256, 1, 255, 64, 65, 0, 256], torch.float32),  # g 1, split edges
        (8, 16, 8, 256, 128, [0, 256, 31, 33, 96, 97, 128, 200], torch.float32),  # g 2
        (8, 32, 8, 256, 128, [256, 0, 5, 64, 250, 129, 1, 256], torch.float32),  # g 4
        (8, 56, 8, 256, 128, [0, 256, 7, 64, 65, 128, 191, 1], torch.float32),  # g 7 (Arctic)
        (4, 32, 4, 256, 64, [256, 0, 100, 17], torch.float32),  # g 8
        (2, 56, 8, 300, 128, [300, 0], torch.float32),  # g 7, ragged S, two rows: many splits
        (2, 16, 2, 7, 64, [7, 0], torch.float32),  # S = 7, g 8
        (1, 8, 1, 512, 128, [20], torch.float32),  # g 8, a cache shorter than one split
        (8, 56, 8, 256, 128, None, torch.bfloat16),  # g 7 in bf16
        (2, 4, 4, 1000, 128, [1000, 999], torch.float32),  # g 1 at hd 128: fewer tile slots, many steps
    ],
)
def test_decode_kernel_matches_plain(cuda_device, b, h, kv, s, hd, valid, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = _randn(g, (b, h, hd), cuda_device, dtype)
    kc = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    vc = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    if valid is None:
        vl = torch.randint(1, s + 1, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    else:
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    out = ops.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    assert torch.isfinite(out).all()
    want = ref.decode_attention_ref(q, kc, vc, vl)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    if valid is not None:
        assert (out[torch.tensor(valid, device=cuda_device) == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,valid,cache_dtype,softcap",
    [
        (8, 32, 2, 256, 128, [0, 256, 31, 33, 96, 97, 128, 200], torch.float32, 0.0),  # g 16 (GLM-4)
        (4, 48, 1, 256, 128, [256, 0, 77, 255], torch.float32, 0.0),  # g 48 (Granite's MQA)
        (8, 32, 2, 300, 128, [300, 0, 1, 299, 33, 64, 150, 0], torch.bfloat16, 0.0),  # f32 q, bf16 cache
        (8, 12, 12, 256, 64, None, torch.bfloat16, 0.0),  # f32 q, bf16 cache, g 1
        (3, 4, 2, 7, 32, [7, 0, 3], torch.bfloat16, 0.0),  # f32 q, bf16 cache, S < one tile
        (2, 8, 2, 256, 64, [256, 40], torch.float32, 2.0),  # softcap
        (8, 32, 2, 256, 128, [256, 0, 5, 64, 250, 129, 1, 256], torch.bfloat16, 2.0),  # softcap, bf16 cache
    ],
)
def test_decode_kernel_groups_cache_types_and_softcap(cuda_device, b, h, kv, s, hd, valid,
                                                       cache_dtype, softcap):
    """Groups of 16 and 48 query heads (several passes of the 8-head
    instantiation), float32 queries over a bfloat16 cache (read as stored,
    computed in float32), and the softcap instantiations."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = _randn(g, (b, h, hd), cuda_device)
    kc = _randn(g, (b, kv, s, hd), cuda_device, cache_dtype)
    vc = _randn(g, (b, kv, s, hd), cuda_device, cache_dtype)
    if valid is None:
        vl = torch.full((b,), s, dtype=torch.int32, device=cuda_device)
    else:
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    out = ops.decode_attention(q, kc, vc, vl, softcap=softcap)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    want = ref.decode_attention_ref(q, kc, vc, vl, softcap=softcap)
    tol = 2e-2 if cache_dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    assert (out[vl == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,dtype,softcap,lengths",
    [
        (2, 32, 2, 256, 128, torch.float32, 0.0, None),  # GQA 16:1 (GLM-4)
        (2, 8, 2, 256, 64, torch.float32, 2.0, [256, 100]),  # softcap
        (4, 4, 4, 32, 64, torch.float32, 2.0, None),  # softcap, the smallest bucket
        (2, 8, 2, 256, 128, torch.bfloat16, 2.0, None),  # softcap in bf16
    ],
)
def test_flash_kernel_gqa16_and_softcap(cuda_device, b, h, kv, s, hd, dtype, softcap, lengths):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    v = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fa_mod.launches
    out = ops.flash_attention(q, k, v, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, lengths=lens, softcap=softcap)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cache_dtype", [("glm4_9b", torch.float32), ("glm4_9b", torch.bfloat16),
                                              ("arctic_480b", torch.bfloat16)])
def test_decode_step_on_the_card_matches_the_cpu(cuda_device, arch, cache_dtype):
    """Model.decode_step at .reduced() on the card (the decode kernel, with
    pos a device tensor) against the same weights on the CPU, four steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).reduced()
    card, cpu = Model(cfg, device=cuda_device), Model(cfg, device="cpu")
    params = card.init(torch.Generator(device=cuda_device).manual_seed(8))
    cpu_params = _tree_to(params, "cpu")
    c_card = card.init_cache(2, 8, dtype=cache_dtype)
    c_cpu = cpu.init_cache(2, 8, dtype=cache_dtype)
    before = dec_mod.launches
    with torch.no_grad():
        for i in range(4):
            tok = torch.full((2, 1), 3 + i)
            got, c_card = card.decode_step(params, tok.to(cuda_device), c_card,
                                           torch.tensor(i, device=cuda_device))
            want, c_cpu = cpu.decode_step(cpu_params, tok, c_cpu, i)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert dec_mod.launches == before + 4 * cfg.n_layers
    tol = 2**-7 if cache_dtype == torch.bfloat16 else 1e-4
    for a, b in zip(c_card, c_cpu):
        torch.testing.assert_close(a["kv"]["k"].cpu().float(), b["kv"]["k"].float(), rtol=tol, atol=1e-4)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,kv,s", [(8, 8, 256), (8, 12, 256), (1, 1, 4096), (2, 8, 300), (2, 2, 32)])
def test_decode_kernel_merges_any_number_of_tiles(cuda_device, b, kv, s):
    """From one 32-key tile (no merge) to 128 of them, every cache slot valid."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = _randn(g, (b, 2 * kv, 64), cuda_device)
    kc = _randn(g, (b, kv, s, 64), cuda_device)
    vc = _randn(g, (b, kv, s, 64), cuda_device)
    vl = torch.full((b,), s, dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    out = ops.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    torch.testing.assert_close(out, ref.decode_attention_ref(q, kc, vc, vl), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,d,dtype",
    [
        (2048, 7168, torch.float32),  # Arctic's prefill batch (8, 256)
        (2048, 7168, torch.bfloat16),
        (300, 7168, torch.float32),  # ragged T
        (64, 896, torch.float32),
        (7, 1024, torch.float32),
        (5, 30, torch.float32),  # d not a multiple of 4: scalar loads
    ],
)
def test_rmsnorm_kernel_matches_plain(cuda_device, t, d, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = _randn(g, (t, d), cuda_device, dtype) * 3
    scale = _randn(g, (d,), cuda_device)
    before = rms_mod.launches
    out = ops.rmsnorm(x, scale, eps=1e-5)
    torch.cuda.synchronize()
    assert rms_mod.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.rmsnorm_ref(x, scale, 1e-5).float(), rtol=tol, atol=tol)


def _tie_logits(dev):
    logits = torch.zeros((6, 16), device=dev)
    logits[1] = 3.0
    logits[2, [3, 9, 12]] = 5.0
    logits[3, [15, 0]] = 2.0
    logits[4] = torch.arange(16, device=dev) % 4
    logits[5, ::2] = -1.0
    return logits


def _neg_inf_logits(gen, dev):
    logits = _randn(gen, (4, 16), dev)
    logits[0, 1:] = -float("inf")  # one finite logit: fifteen zero probabilities, tied
    logits[1, ::2] = -float("inf")
    logits[2, :14] = -float("inf")
    logits[3, [3, 7]] = -float("inf")
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize(
    "t,e,k,case",
    [
        (2048, 128, 2, ""),
        (256, 16, 4, ""),
        (256, 8, 1, ""),
        (6, 16, 4, "ties"),
        (1, 128, 2, ""),  # T ragged against the rows of a block
        (7, 128, 2, ""),
        (33, 128, 2, ""),
        (64, 3, 2, ""),  # the scalar layout
        (64, 130, 4, ""),
        (2048, 256, 2, ""),  # two float4 a lane
        (64, 8, 8, ""),  # k == E
        (64, 3, 3, ""),
        (2048, 128, 2, "bf16"),
        (33, 130, 2, "bf16"),
        (4, 16, 4, "-inf"),
        (64, 128, 2, "unaligned"),  # rows off 16 bytes: the scalar layout
    ],
)
def test_moe_gating_kernel_matches_plain(cuda_device, t, e, k, case):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    if case == "ties":
        logits = _tie_logits(cuda_device)
    elif case == "-inf":
        logits = _neg_inf_logits(g, cuda_device)
    elif case == "unaligned":
        logits = torch.empty(t * e + 1, device=cuda_device)[1:].view(t, e)
        logits.copy_(_randn(g, (t, e), cuda_device) * 2)
    else:
        dtype = torch.bfloat16 if case == "bf16" else torch.float32
        logits = _randn(g, (t, e), cuda_device, dtype) * 2
    before = gating_mod.launches
    gates, ids = ops.moe_gating(logits, k)
    torch.cuda.synchronize()
    assert gating_mod.launches == before + 1
    assert gates.dtype == torch.float32 and ids.dtype == torch.int32 and ids.shape == (t, k)
    wg, wi = ref.moe_gating_ref(logits, k)
    assert torch.equal(ids, wi)
    torch.testing.assert_close(gates, wg, rtol=1e-5, atol=1e-5)
    if case == "ties":
        assert ids[:3].tolist() == [[0, 1, 2, 3], [0, 1, 2, 3], [3, 9, 12, 0]]
    if case == "-inf":  # zero probabilities tie: they go in index order
        assert ids[0].tolist() == [0, 1, 2, 3] and ids[2, 2:].tolist() == [0, 1]


@pytest.mark.cuda
def test_kernel_wrappers_reject_mixed_devices(cuda_device):
    q = torch.zeros((1, 2, 16, 64), device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, q, q, torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.decode_attention(q[:, :, 0].contiguous(), q, q, torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rmsnorm(q[0, 0], torch.ones(64))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,dtype,softcap,lengths",
    [
        (4, 4, 4, 8, 16, F32, 0.0, None),  # the engine-smoke toy's smallest bucket
        (4, 4, 4, 24, 16, F32, 0.0, [24, 9, 1, 17]),  # a ragged bucket, lengths
        (4, 4, 4, 32, 16, F32, 0.0, None),
        (2, 4, 4, 16, 16, BF16, 0.0, None),
        (4, 4, 4, 32, 16, BF16, 0.0, [32, 5, 0, 31]),
        (2, 8, 2, 300, 16, F32, 0.0, None),  # 64-row tiles, GQA 4:1, ragged S
        (2, 4, 4, 32, 16, F32, 2.0, None),  # softcap
        (2, 8, 2, 256, 192, F32, 0.0, None),  # Nemotron-4-340B's head size
        (2, 8, 2, 256, 192, BF16, 0.0, [256, 77]),
        (2, 96, 8, 64, 192, F32, 0.0, None),  # Nemotron's GQA 12:1
        (2, 4, 4, 24, 192, F32, 0.0, None),  # the smallest bucket's tile
        (2, 4, 4, 32, 192, BF16, 0.0, None),
        (2, 4, 2, 300, 192, F32, 0.0, [300, 131]),  # ragged S
        (2, 8, 2, 256, 192, F32, 2.0, [256, 100]),  # softcap
        (2, 8, 2, 256, 192, BF16, 2.0, None),
    ],
)
def test_flash_kernel_head_dims_16_and_192(cuda_device, b, h, kv, s, hd, dtype, softcap, lengths):
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    v = _randn(g, (b, kv, s, hd), cuda_device, dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fa_mod.launches
    out = ops.flash_attention(q, k, v, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and torch.isfinite(out).all()
    want = ref.flash_attention_ref(q, k, v, lengths=lens, softcap=softcap)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,valid,q_dtype,cache_dtype,softcap",
    [
        (4, 4, 4, 32, 16, None, F32, F32, 0.0),  # the toy's head size, g 1: half-warps per key
        (3, 8, 2, 7, 16, [7, 0, 3], F32, F32, 0.0),  # g 4, S < one tile, odd key counts
        (4, 4, 4, 300, 16, [300, 1, 0, 33], BF16, BF16, 0.0),
        (8, 16, 2, 256, 16, [0, 256, 31, 33, 96, 97, 128, 200], F32, BF16, 0.0),  # g 8
        (2, 8, 8, 1000, 16, [1000, 999], F32, F32, 0.0),  # many steps of 8 slots
        (2, 4, 4, 64, 16, [64, 13], F32, F32, 2.0),  # softcap
        (2, 96, 8, 256, 192, [256, 77], F32, F32, 0.0),  # Nemotron's group of 12: two passes
        (2, 96, 8, 256, 192, [256, 0], F32, BF16, 0.0),
        (2, 96, 8, 256, 192, [255, 31], BF16, BF16, 0.0),
        (2, 8, 8, 1000, 192, [1000, 3], F32, F32, 0.0),  # g 1 at hd 192: 3 tile slots
        (1, 8, 1, 512, 192, [20], F32, F32, 0.0),  # a cache shorter than one split
        (8, 16, 8, 256, 192, [0, 256, 31, 33, 96, 97, 128, 200], F32, F32, 0.0),  # g 2
        (2, 8, 2, 256, 192, [256, 40], F32, F32, 2.0),  # softcap
        (2, 8, 2, 256, 192, [256, 40], F32, BF16, 2.0),
    ],
)
def test_decode_kernel_head_dims_16_and_192(cuda_device, b, h, kv, s, hd, valid, q_dtype,
                                             cache_dtype, softcap):
    g = torch.Generator(device=cuda_device).manual_seed(10)
    q = _randn(g, (b, h, hd), cuda_device, q_dtype)
    kc = _randn(g, (b, kv, s, hd), cuda_device, cache_dtype)
    vc = _randn(g, (b, kv, s, hd), cuda_device, cache_dtype)
    if valid is None:
        vl = torch.randint(1, s + 1, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    else:
        vl = torch.tensor(valid, dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    out = ops.decode_attention(q, kc, vc, vl, softcap=softcap)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    assert out.dtype == q_dtype and torch.isfinite(out).all()
    want = ref.decode_attention_ref(q, kc, vc, vl, softcap=softcap)
    tol = 2e-2 if cache_dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert (out[vl == 0] == 0).all()


def _kernel_call(op, dev):
    """A call of one kernel's wrapper on small inputs, and the tensors it
    reads (floating point: those that could require grad)."""
    g = torch.Generator(device=dev).manual_seed(11)
    if op == "flash_attention":
        q, k, v = (_randn(g, (1, 2, 16, 64), dev) for _ in range(3))
        return (lambda: fa_mod.flash_attention_cuda(q, k, v)), (q, k, v), fa_mod
    if op == "decode_attention":
        q = _randn(g, (1, 2, 64), dev)
        kc, vc = (_randn(g, (1, 2, 16, 64), dev) for _ in range(2))
        vl = torch.tensor([16], dtype=torch.int32, device=dev)
        return (lambda: dec_mod.decode_attention_cuda(q, kc, vc, vl)), (q, kc, vc), dec_mod
    if op == "rmsnorm":
        x, scale = _randn(g, (4, 64), dev), _randn(g, (64,), dev)
        return (lambda: rms_mod.rmsnorm_cuda(x, scale)), (x, scale), rms_mod
    logits = _randn(g, (4, 16), dev)
    return (lambda: gating_mod.moe_gating_cuda(logits, 2)), (logits,), gating_mod


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention", "decode_attention", "rmsnorm", "moe_gating"])
def test_kernels_refuse_inputs_that_require_grad(cuda_device, op):
    """No kernel has a backward yet: with grad mode on, an input that
    requires grad makes the launch raise (each input in turn), where the
    output would otherwise carry no graph.  Under no_grad it launches."""
    call, inputs, mod = _kernel_call(op, cuda_device)
    for t in inputs:
        t.requires_grad_(True)
        before = mod.launches
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert mod.launches == before
        with torch.no_grad():
            call()
        assert mod.launches == before + 1
        t.requires_grad_(False)
    call()  # grad mode on, nothing requires grad: the serving paths' case


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b", "internvl2_1b", "musicgen_large"])
def test_zoo_model_on_the_card_matches_the_cpu(cuda_device, arch):
    """The SSM, recurrent and frontend models at .reduced() on the card
    against the same weights on the CPU: the forward over 80 positions
    (Hymba's 64-token window cuts keys in the flash kernel) and 70 decode
    steps (its 64-slot ring wraps), logits to 1e-3; MusicGen on frame
    embeddings.  Every attention layer launches the flash kernel once a
    forward and the decode kernel once a step; xLSTM launches neither."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).reduced()
    card, cpu = Model(cfg, device=cuda_device), Model(cfg, device="cpu")
    params = card.init(torch.Generator(device=cuda_device).manual_seed(12))
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(12)
    if cfg.frontend == "audio":
        inputs = torch.from_numpy(rng.normal(size=(2, 80, 512)).astype(np.float32))
        batch = {"frontend_embeds": inputs}
    else:
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 80)))
        batch = {"tokens": inputs}
        if cfg.frontend == "vision":
            batch["frontend_embeds"] = torch.from_numpy(
                rng.normal(size=(2, cfg.n_frontend_tokens, 1024)).astype(np.float32))
    attn_layers = cfg.n_layers if cfg.uses_attention else 0
    before = (fa_mod.launches, dec_mod.launches)
    with torch.no_grad():
        got = card.logits(params, {k: v.to(cuda_device) for k, v in batch.items()})
        want = cpu.logits(cpu_params, batch)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
        c_card, c_cpu = card.init_cache(2, 128), cpu.init_cache(2, 128)
        for i in range(70):
            x = inputs[:, i : i + 1]
            got, c_card = card.decode_step(params, x.to(cuda_device), c_card, i)
            want, c_cpu = cpu.decode_step(cpu_params, x, c_cpu, i)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert (fa_mod.launches, dec_mod.launches) == (before[0] + attn_layers, before[1] + 70 * attn_layers)


@pytest.mark.cuda
def test_xlstm_token_path_refuses_head_size_512(cuda_device):
    """The token path's executor prices decode attention at d_model /
    n_heads: 512 for xLSTM-1.3B, which the decode kernel does not take.  On
    the card that is a clear ValueError at the executor's warm-up step, not
    a quiet turn to the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import DecodeTorchExecutor

    full = get_config("xlstm_1_3b")
    cfg = full.reduced(d_model=full.d_model, n_heads=full.n_heads, n_kv_heads=full.n_kv_heads)
    assert cfg.d_model // cfg.n_heads == 512
    before = dec_mod.launches
    with pytest.raises(ValueError, match="head_dim 512 not supported"):
        DecodeTorchExecutor(cfg, max_batch=2, max_cache=16, device=cuda_device)
    assert dec_mod.launches == before
