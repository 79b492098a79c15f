"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports no JAX, so it also runs on a card's host that
has none: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: float32 1e-4 for attention (the kernel sums in another order
than the plain version's matrix products) and 1e-5 for RMSNorm and the
gates (one sum per row in another order), bfloat16 2e-2 (one bf16 rounding
of the probabilities or the output); the gating's expert ids must be equal.
"""

import dataclasses
import gc
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
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


def _config(arch, cut):
    """``arch`` at .reduced() where ``cut`` is None, else at its published
    widths with ``cut``'s fields replaced ({} for none)."""
    cfg = get_config(arch)
    return cfg.reduced() if cut is None else dataclasses.replace(cfg, **cut)


def _full(*values):
    """A case at a model's published widths (``values`` as the test takes
    them), marked slow: it takes up to tens of GB of the card, and the CPU's
    side of it minutes."""
    return pytest.param(*values, marks=pytest.mark.slow)


LENGTHS8 = [256, 70, 17, 1, 200, 128, 64, 33]  # a full row, short ones, one of a single key


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
        (8, 12, 12, 256, 64, torch.bfloat16, 0, None),  # the prefill path's largest batch in bf16
        (2, 12, 12, 300, 64, torch.float32, 0, None),  # ragged S at hd 64
        (8, 12, 12, 256, 64, torch.float32, 0, LENGTHS8),
        (2, 12, 12, 256, 64, torch.float32, 64, None),  # a window at hd 64
        (2, 56, 8, 8, 128, torch.float32, 0, None),  # Arctic's decode ≡ forward prompt
        (8, 14, 2, 256, 64, torch.float32, 0, None),  # InternVL2-1B, GQA 7:1
        (2, 14, 2, 320, 64, torch.float32, 0, None),  # its image prefix and tokens
        (8, 32, 32, 256, 64, torch.bfloat16, 0, None),  # MusicGen-large, in bf16
        (8, 48, 8, 256, 128, torch.float32, 0, None),  # DBRX, GQA 6:1
        (8, 8, 8, 256, 32, torch.float32, 0, LENGTHS8),  # the wgmma route at hd 32
        (8, 8, 2, 130, 32, torch.bfloat16, 40, None),
        (8, 14, 2, 256, 64, torch.bfloat16, 100, LENGTHS8),  # wgmma at GQA 7:1, a window
        (2, 48, 1, 256, 128, torch.bfloat16, 0, [256, 100]),  # GQA 48:1: rows a block does not divide
        (2, 48, 1, 256, 128, torch.float32, 0, [256, 100]),
        (2, 32, 2, 1, 128, torch.bfloat16, 0, None),  # S = 1 at GQA 16:1
        (8, 12, 12, 32, 64, torch.bfloat16, 0, None),  # the smallest bucket in bf16
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
        (8, 12, 12, 300, 64, None, torch.float32),  # ragged S at the decode path's batch
        (8, 12, 12, 256, 64, [0, 77, 0, 256, 5, 0, 1, 128], torch.float32),
        (4, 48, 1, 4096, 128, None, torch.float32),  # Granite-34B's g 48 over 4,096 slots
        (8, 48, 8, 256, 128, None, torch.float32),  # DBRX, g 6
        (8, 32, 2, 4096, 128, None, torch.bfloat16),  # GLM-4-9B's g 16 in bf16
        (2, 32, 2, 7, 128, [7, 3], torch.float32),  # g 16, S < one tile
        (2, 32, 2, 8, 128, [1, 8], torch.float32),  # GLM-4-9B's decode ≡ forward steps
        (1, 32, 2, 256, 128, [256], torch.float32),  # its timed step at B 1
        (8, 25, 5, 1024, 64, [1024, 0, 1, 1023, 512, 64, 65, 1000], torch.float32),  # Hymba's ring, g 5
        (8, 14, 2, 256, 64, None, torch.float32),  # InternVL2-1B, g 7
        (8, 32, 32, 256, 64, None, torch.bfloat16),  # MusicGen-large, g 1 in bf16
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
        (4, 48, 1, 4096, 128, [4096, 0, 1000, 4095], torch.bfloat16, 0.0),  # g 48 over a bf16 cache
        (8, 32, 2, 4096, 128, [4096, 0, 1, 4095, 2048, 33, 1000, 3000], torch.bfloat16, 0.0),  # GLM-4-9B's
        (8, 32, 2, 32768, 128, [32768, 0, 1, 32767, 16384, 33, 1000, 30000], torch.bfloat16, 0.0),
        (8, 25, 5, 1024, 64, None, torch.bfloat16, 0.0),  # Hymba's full 1024-slot ring, g 5
        (8, 14, 2, 256, 64, [256, 0, 5, 64, 250, 129, 1, 256], torch.bfloat16, 0.0),  # InternVL2, g 7
    ],
)
def test_decode_kernel_groups_cache_types_and_softcap(cuda_device, b, h, kv, s, hd, valid,
                                                       cache_dtype, softcap):
    """Groups of 16 and 48 query heads (the tensor-core route: one and
    three M tiles), float32 queries over a bfloat16 cache (read as stored,
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
    # Float32 queries: both sides compute in float32 on the same cache values.
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    assert (out[vl == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,dtype,softcap,lengths",
    [
        (2, 32, 2, 256, 128, torch.float32, 0.0, None),  # GQA 16:1 (GLM-4)
        (2, 8, 2, 256, 64, torch.float32, 2.0, [256, 100]),  # softcap
        (4, 4, 4, 32, 64, torch.float32, 2.0, None),  # softcap, the smallest bucket
        (2, 8, 2, 256, 128, torch.bfloat16, 2.0, None),  # softcap in bf16
        (2, 32, 2, 8, 128, torch.float32, 0.0, None),  # GLM-4-9B's decode ≡ forward prompt
        (8, 32, 2, 256, 128, torch.bfloat16, 2.0, None),  # GQA 16:1 with a softcap in bf16
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
@pytest.mark.parametrize("arch,cut,cache_dtype", [
    ("glm4_9b", None, torch.float32), ("glm4_9b", None, torch.bfloat16), ("arctic_480b", None, torch.bfloat16),
    # GLM-4-9B's layer at d 4096, 32 query heads on 2 KV heads of 128: a reduced config has none of it
    _full("glm4_9b", {"n_layers": 1, "vocab_size": 512}, torch.float32),
    _full("glm4_9b", {"n_layers": 1, "vocab_size": 512}, torch.bfloat16),
])
def test_decode_step_on_the_card_matches_the_cpu(cuda_device, arch, cut, cache_dtype):
    """Model.decode_step on the card (the decode kernel, with pos a device
    tensor) against the same weights on the CPU, four steps: logits and
    both caches."""
    from repro_torch.models import Model

    cfg = _config(arch, cut)
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
        for name in ("k", "v"):
            torch.testing.assert_close(a["kv"][name].cpu().float(), b["kv"][name].float(), rtol=tol, atol=1e-4)


def _tree_to(tree, device):
    """A copy of a parameter tree on ``device``, apart from the original even
    where it is on the same device."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


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
        (2048, 1600, torch.float32),  # Hymba-1.5B's (8, 256) batch
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
        (4, 4, 4, 16, 16, F32, 0.0, None),  # the toy's buckets
        (2, 4, 4, 24, 16, BF16, 0.0, None),
        (8, 12, 4, 256, 16, F32, 0.0, LENGTHS8),
        (2, 8, 2, 300, 16, BF16, 0.0, None),
        (8, 16, 4, 256, 16, BF16, 0.0, LENGTHS8),  # GQA 4:1 in bf16
        (8, 96, 8, 256, 192, F32, 0.0, None),  # Nemotron-4-340B's (8, 256) batch
        (8, 96, 8, 256, 192, BF16, 0.0, None),
        (2, 96, 8, 8, 192, F32, 0.0, None),  # its decode ≡ forward prompt
        (2, 8, 2, 300, 192, F32, 0.0, [300, 131]),
        (4, 4, 4, 32, 192, BF16, 0.0, None),
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
        (8, 96, 8, 256, 192, None, F32, F32, 0.0),  # Nemotron-4-340B's batch
        (8, 96, 8, 256, 192, [256, 0, 5, 64, 250, 129, 1, 256], F32, BF16, 0.0),
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
    tol = 2e-2 if q_dtype == BF16 else 1e-4  # float32 queries compute in float32 over either cache
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
@pytest.mark.parametrize("op", ["decode_attention"])
def test_kernels_refuse_inputs_that_require_grad(cuda_device, op):
    """The decode kernel has no backward (no training path reaches it): with
    grad mode on, an input that requires grad makes the launch raise (each
    input in turn), where the output would otherwise carry no graph.  Under
    no_grad it launches.  (Flash attention, RMSNorm and the gates carry a
    graph through ``ops``: test_flash_rmsnorm_and_gating_carry_a_graph_on_the_card.)"""
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
@pytest.mark.parametrize("arch,cut", [(a, None) for a in ("hymba_1_5b", "xlstm_1_3b", "internvl2_1b",
                                                          "musicgen_large", "orloj_gpt", "glm4_9b", "arctic_480b")] + [
    # Arctic's layer at d 7168 with 8 of its experts (4 GB a device): routing at its width
    _full("arctic_480b", {"n_layers": 1, "n_experts": 8, "vocab_size": 512}),
    # InternVL2-1B's layer and its 256-patch prefix, the prefix projected in float32
    _full("internvl2_1b", {"n_layers": 1, "vocab_size": 512, "dtype": "float32"}),
])
def test_zoo_model_on_the_card_matches_the_cpu(cuda_device, monkeypatch, arch, cut):
    """The SSM, recurrent and frontend models, two dense ones and the MoE
    one on the card against the same weights on the CPU:
    the forward over 80 positions
    (Hymba's 64-token window cuts keys in the flash kernel) and 70 decode
    steps (its 64-slot ring wraps), logits to 1e-3; MusicGen on frame
    embeddings; the forward's expert ids equal.  Every attention layer
    launches the flash kernel once a forward and the decode kernel once a
    step; xLSTM launches neither."""
    import numpy as np

    from repro_torch.models import Model

    cfg = _config(arch, cut)
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
    routes, gating = [], ops.moe_gating

    def routing(logits, top_k):
        gates, ids = gating(logits, top_k)
        routes.append(ids.cpu())
        return gates, ids

    monkeypatch.setattr(ops, "moe_gating", routing)
    before = (fa_mod.launches, dec_mod.launches)
    with torch.no_grad():
        got = card.logits(params, {k: v.to(cuda_device) for k, v in batch.items()})
        want = cpu.logits(cpu_params, batch)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
        assert len(routes) == (2 * cfg.n_layers if cfg.is_moe else 0)
        for a, b in zip(routes[: len(routes) // 2], routes[len(routes) // 2 :]):
            assert torch.equal(a, b)
        c_card, c_cpu = card.init_cache(2, 128), cpu.init_cache(2, 128)
        for i in range(70):
            x = inputs[:, i : i + 1]
            got, c_card = card.decode_step(params, x.to(cuda_device), c_card, i)
            want, c_cpu = cpu.decode_step(cpu_params, x, c_cpu, i)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert (fa_mod.launches, dec_mod.launches) == (before[0] + attn_layers, before[1] + 70 * attn_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2_1b", "musicgen_large"])
def test_a_bf16_frontend_projection_on_the_card_matches_the_cpu(cuda_device, arch):
    """The frontend's embeddings projected in bfloat16 (``cfg.dtype``) at
    the published widths, on the card and on the CPU: within one bf16 step
    (the card's and the CPU's product may round a sum to either side)."""
    import numpy as np

    from repro_torch.models import Model

    cfg = _config(arch, {"n_layers": 1, "vocab_size": 512})
    card, cpu = Model(cfg, device=cuda_device), Model(cfg, device="cpu")
    params = card.init(torch.Generator(device=cuda_device).manual_seed(1))
    embeds = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 256, card.frontend_dim)).astype(np.float32))
    with torch.no_grad():
        got = card._project_frontend(params, embeds.to(cuda_device))
        want = cpu._project_frontend(_tree_to(params, "cpu"), embeds)
    assert got.dtype == want.dtype == BF16
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2**-7, atol=1e-4)


def _held_kernel_calls(monkeypatch) -> list[str]:
    """Wraps the ops wrappers of the five forward kernels so that each call
    that runs (not one recorded into a graph's capture) is held, as it
    returns, against the plain version on its own inputs: attention and the
    scan to 1e-4, RMSNorm and the gates to 1e-5 (the ids equal), a bf16
    output to 2e-2.  A decode cache is written before its step's call, so
    the plain version reads what the kernel read.  Returns the names of the
    calls held, in order."""
    held = []

    def plain(name, args, kw):
        if name == "flash_attention":
            q, k, v, *rest = args
            return ref.flash_attention_ref(q, k, v, lengths=rest[0] if rest else kw.pop("lengths", None), **kw)
        if name == "rmsnorm":
            x, scale = args
            return ref.rmsnorm_ref(x.reshape(-1, x.shape[-1]), scale, kw.get("eps", 1e-6)).reshape(x.shape)
        if name == "selective_scan":
            y, h = ref.selective_scan_ref(*args)
            return y, (h if kw.get("last_state") else None)
        return getattr(ref, f"{name}_ref")(*args, **kw)

    def holding(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if args[0].is_cuda and torch.cuda.is_current_stream_capturing():
                return out
            want = plain(name, args, dict(kw))
            if name == "moe_gating":
                assert torch.equal(out[1], want[1])
                out_want = [(out[0], want[0])]
            elif name == "selective_scan":
                out_want = [(a, b) for a, b in zip(out, want) if b is not None]
            else:
                out_want = [(out, want)]
            for a, b in out_want:
                tol = 2e-2 if a.dtype == BF16 else 1e-5 if name in ("rmsnorm", "moe_gating") else 1e-4
                torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
            held.append(name)
            return out
        return call

    for name in ("flash_attention", "decode_attention", "rmsnorm", "moe_gating", "selective_scan"):
        monkeypatch.setattr(ops, name, holding(name, getattr(ops, name)))
    return held


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut,rows,prompt", [(a, None, 2, 8) for a in (
    "orloj_gpt", "glm4_9b", "arctic_480b", "nemotron_4_340b", "hymba_1_5b", "xlstm_1_3b", "internvl2_1b",
    "musicgen_large")] + [
    # Each model at its published widths, to the depth the card holds in float32:
    _full("orloj_gpt", {}, 2, 8),
    _full("glm4_9b", {}, 2, 8),  # all 40 layers (37.6 GB): the error over a served forward's depth
    _full("arctic_480b", {"n_layers": 1}, 2, 8),  # 128 experts at d 7168 (56.3 GB)
    _full("nemotron_4_340b", {"n_layers": 1}, 2, 8),  # head size 192 at d 18432, vocab 256000 (51.6 GB)
    _full("hymba_1_5b", {}, 2, 16),
    _full("hymba_1_5b", {"n_layers": 2}, 1, 1100),  # past the wrap of its 1024-slot ring
    _full("xlstm_1_3b", {}, 2, 8),
    _full("internvl2_1b", {}, 2, 8),
    _full("musicgen_large", {}, 2, 8),  # a bf16 stack 48 layers deep
])
def test_decode_on_the_card_equals_the_forward(cuda_device, monkeypatch, freed, arch, cut, rows, prompt):
    """``prompt`` positions of ``rows`` rows through ``Model.logits``, and
    the same inputs one at a time through ``decode_step`` over a cache of
    the logits' type: the logits within 1e-3, or 5e-2 of the largest
    where the stack computes in bf16.  An MoE forward routes the 16 tokens
    against one capacity and a step its 2 against another, so a row is held
    only before the first assignment the forward drops.  Every kernel call
    of both paths is held against its plain version on its own inputs, and
    a model with attention launches both attention kernels."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.models import Model
    from repro_torch.models.moe import capacity

    cfg = _config(arch, cut)
    model = Model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(14))
    rng = np.random.default_rng(14)
    if cfg.frontend == "audio":
        inputs = torch.from_numpy(rng.normal(size=(rows, prompt, 512)).astype(np.float32)).to(cuda_device)
        batch = {"frontend_embeds": inputs}
    else:
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(rows, prompt))).to(cuda_device)
        batch = {"tokens": inputs}
        if cfg.frontend == "vision":  # an empty image prefix: a decode step reads tokens
            batch["frontend_embeds"] = torch.zeros((rows, 0, 1024), device=cuda_device)
    held = _held_kernel_calls(monkeypatch)
    routes, gating = [], ops.moe_gating

    def routing(logits, top_k):
        gates, ids = gating(logits, top_k)
        routes.append(ids)
        return gates, ids

    monkeypatch.setattr(ops, "moe_gating", routing)
    with torch.no_grad():
        full = model.logits(params, batch)
        n_forward = len(routes)
        cache = model.init_cache(rows, prompt, dtype=full.dtype)
        steps = torch.stack([model.decode_step(params, inputs[:, i : i + 1], cache, i)[0][:, 0]
                             for i in range(prompt)], 1)
    keep = torch.ones((rows, prompt), dtype=torch.bool)
    for ids in routes[:n_forward]:
        flat = ids.reshape(-1).long().cpu()
        onehot = F.one_hot(flat, cfg.n_experts)
        drop = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0] >= capacity(
            rows * prompt, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        keep &= drop.reshape(rows, prompt, cfg.top_k).any(-1).cumsum(1) == 0
    assert keep.any() and steps.shape == full.shape and torch.isfinite(steps).all()
    err = (steps.float() - full.float()).abs()[keep.to(cuda_device)].max().item()
    assert err <= (5e-2 * max(1.0, full.float().abs().max().item()) if full.dtype == BF16 else 1e-3), err
    attention = {"flash_attention", "decode_attention"} <= set(held)
    assert attention == cfg.uses_attention, held


@pytest.mark.cuda
def test_xlstm_token_path_runs_at_head_size_512(cuda_device):
    """The token path's executor prices decode attention at d_model /
    n_heads: 512 for xLSTM-1.3B (4 query heads on 4 KV heads, float32 queries
    and cache).  The executor warms up on the card, the decode kernel
    launches, and its output matches the plain version's."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import DecodeTorchExecutor

    full = get_config("xlstm_1_3b")
    cfg = full.reduced(d_model=full.d_model, n_heads=full.n_heads, n_kv_heads=full.n_kv_heads)
    assert cfg.d_model // cfg.n_heads == 512
    before = dec_mod.launches
    dec = DecodeTorchExecutor(cfg, max_batch=4, max_cache=80, device=cuda_device)
    assert dec_mod.launches == before + 1
    dec._valid = torch.tensor([80, 0, 33, 1], dtype=torch.int32, device=cuda_device)
    for _ in range(3):
        dec._decode_once()
    assert dec_mod.launches == before + 4
    q = _randn(torch.Generator(device=cuda_device).manual_seed(13), (4, 4, 512), cuda_device)
    out = ops.decode_attention(q, dec._kc, dec._vc, dec._valid)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, dec._kc, dec._vc, dec._valid)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    assert (out[dec._valid == 0] == 0).all() and (dec._valid > 0).sum() == 3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,valid", [(8, 4, 4, 256, None), (2, 4, 4, 1000, [1000, 3]),
                                            (3, 1, 1, 40, [40, 0, 17]), (3, 4, 4, 1000, [1000, 0, 3])])
def test_decode_kernel_head_size_512(cuda_device, b, h, kv, s, valid):
    """Head size 512 at a group of 1 in float32 (the wide route: several
    warps a block, each with its own ring of 2-key stages, the cache split
    along S over a cluster); empty rows give 0."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    q = _randn(g, (b, h, 512), cuda_device)
    kc, vc = (_randn(g, (b, kv, s, 512), cuda_device) for _ in range(2))
    vl = (torch.randint(1, s + 1, (b,), generator=g, device=cuda_device, dtype=torch.int32)
          if valid is None else torch.tensor(valid, dtype=torch.int32, device=cuda_device))
    out = ops.decode_attention(q, kc, vc, vl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref.decode_attention_ref(q, kc, vc, vl), rtol=1e-4, atol=1e-4)
    assert (out[vl == 0] == 0).all()
    for bad in (_randn(g, (b, 2 * kv, 512), cuda_device), q.bfloat16()):  # a group of 2; bf16
        with pytest.raises((ValueError, TypeError), match="head_dim 512 is taken only|types must"):
            ops.decode_attention(bad, kc, vc, vl)


# Every (query heads, KV heads, head size) of the archs' decode steps, with
# each (query, cache) type pair and softcap the kernel takes at it: head
# size 512 only float32 / float32 without softcap.
ARCH_DECODE_CASES = [
    (h, kv, hd, qt, ct, cap)
    for h, kv, hd in sorted({(c.n_heads, c.n_kv_heads, c.resolved_head_dim)
                             for c in map(get_config, ARCHS) if c.resolved_head_dim in dec_mod.HEAD_DIMS})
    for qt, ct in dec_mod.PAIRS
    for cap in (0.0, 2.0)
    if hd != dec_mod.WIDE_HEAD_DIM or (qt, ct, cap) == (F32, F32, 0.0)
]


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,hd,q_dtype,cache_dtype,softcap", ARCH_DECODE_CASES)
def test_decode_kernel_at_every_arch_group(cuda_device, h, kv, hd, q_dtype, cache_dtype, softcap):
    """The groups of ``ARCHS`` (1, 5, 6, 7, 12, 16, 48) and head size 512,
    each on its route, over a ragged cache of 300 slots with an empty row."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    b, s = 3, 300
    q = _randn(g, (b, h, hd), cuda_device, q_dtype)
    kc, vc = (_randn(g, (b, kv, s, hd), cuda_device, cache_dtype) for _ in range(2))
    vl = torch.tensor([300, 0, 97], dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    out = ops.decode_attention(q, kc, vc, vl, softcap=softcap)
    torch.cuda.synchronize()
    assert dec_mod.launches == before + 1
    assert out.dtype == q_dtype and torch.isfinite(out).all() and (out[1] == 0).all()
    want = ref.decode_attention_ref(q, kc, vc, vl, softcap=softcap)
    tol = 2e-2 if q_dtype == BF16 else 1e-4  # float32 queries compute in float32 over either cache
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,hd,cache_dtype", [
    (8, 32, 2, 4096, 128, BF16),  # GLM-4-9B's g 16 over its bf16 cache: tensor cores, a 4-stage ring
    (4, 48, 1, 4096, 128, F32),  # Granite's g 48: three M tiles
    (8, 4, 4, 256, 512, F32),  # xLSTM's head size 512: the wide route
    (8, 12, 12, 256, 64, F32),  # orloj_gpt's step: the SIMT route
])
def test_decode_kernel_gives_the_same_bits_on_two_calls_and_in_a_graph(cuda_device, b, h, kv, s, hd,
                                                                         cache_dtype):
    """No atomics and merges in a fixed order: two calls give the same bits,
    and a CUDA graph's replay of the call gives the eager call's."""
    g = torch.Generator(device=cuda_device).manual_seed(24)
    q = _randn(g, (b, h, hd), cuda_device)
    kc, vc = (_randn(g, (b, kv, s, hd), cuda_device, cache_dtype) for _ in range(2))
    vl = torch.randint(0, s + 1, (b,), generator=g, device=cuda_device, dtype=torch.int32)
    first, second = (dec_mod.decode_attention_cuda(q, kc, vc, vl) for _ in range(2))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        dec_mod.decode_attention_cuda(q, kc, vc, vl)  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dec_mod.decode_attention_cuda(q, kc, vc, vl)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)


# ------------------------------------------------ the flash forward's routes
def _flash_route_cases():
    """Every route of the forward's plan at every head size and type: the
    wgmma route at one and two consumer warpgroups where they fit, and
    the mma_sync route at 2 and 4 warps where the plan takes it, which is
    where each route is built (a pure function of the shapes: no card is
    asked)."""
    cases = []
    for dtype, hd in itertools.product((F32, BF16), fa_mod.HEAD_DIMS):
        if fa_mod.mma_sync_faster(hd, dtype):
            cases += [("mma_sync", warps, dtype, hd) for warps in (2, 4)]
            continue
        for wgs in (1, 2):
            if fa_mod.wgmma_plan(2, 16, 2, 150, hd, dtype, 132, warpgroups=wgs) is not None:
                cases.append(("wgmma", wgs, dtype, hd))
    return cases


def _route_plan(route, warps, dtype, hd, b, h, kv, s):
    if route == "wgmma":
        return fa_mod.wgmma_plan(b, h, kv, s, hd, dtype, 132, warpgroups=warps)
    return fa_mod.mma_sync_plan(h, kv, 32 if warps == 2 else 256, hd)


def _lse_ref(q, k, lengths, causal, window):
    """Each row's log-sum-exp of its scaled, masked scores in float64; -inf
    where no key is valid."""
    b, h, s, hd = q.shape
    kr = k.double().repeat_interleave(h // k.shape[1], dim=1)
    scores = torch.einsum("bhsd,bhtd->bhst", q.double(), kr) / hd**0.5
    i, j = torch.arange(s, device=q.device)[:, None], torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    mask = mask[None, None] & (j < lengths[:, None, None, None].to(q.device))
    return torch.logsumexp(torch.where(mask, scores, -torch.inf), dim=-1).float()


@pytest.mark.cuda
@pytest.mark.parametrize("route,warps,dtype,hd", _flash_route_cases())
def test_flash_kernel_each_route_matches_plain(cuda_device, monkeypatch, route, warps, dtype, hd):
    """Each route the plan can take, forced, at a group of 8 with S off every
    tile, lengths (one row short), a window and causal masks: the output
    against the plain version and the LSE against float64 sums."""
    b, h, kv, s, window = 2, 16, 2, 150, 40
    plan = _route_plan(route, warps, dtype, hd, b, h, kv, s)
    monkeypatch.setattr(fa_mod, "flash_plan", lambda *args: plan)
    g = torch.Generator(device=cuda_device).manual_seed(31)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k, v = (_randn(g, (b, kv, s, hd), cuda_device, dtype) for _ in range(2))
    lens = torch.tensor([s, 37], dtype=torch.int32, device=cuda_device)
    for win in (0, window):
        out, lse = fa_mod.flash_attention_cuda(q, k, v, lens, window=win, return_lse=True)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, lengths=lens, window=win)
        tol = 2e-2 if dtype == BF16 else 1e-4
        torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(lse, _lse_ref(q.float(), k.float(), lens, True, win), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal,dtype", [(1, True, F32), (77, True, F32), (77, False, BF16), (300, True, BF16)])
def test_flash_wgmma_group_of_16_strided_views_and_empty_rows(cuda_device, s, causal, dtype):
    """The wgmma route at a group of 16 (GLM-4-9B's, heads 16 x 8 positions a
    block) on transposed views of a (B, S, H, hd) projection, S = 1 and S
    off the tile, a row with no valid key (zeros, LSE -inf)."""
    g = torch.Generator(device=cuda_device).manual_seed(32)
    b, h, kv, hd = 3, 32, 2, 128
    assert fa_mod.flash_plan(b, h, kv, s, hd, dtype, 0, 132).route == "wgmma"
    q = _randn(g, (b, s, h, hd), cuda_device, dtype).transpose(1, 2)
    k, v = (_randn(g, (b, s, kv, hd), cuda_device, dtype).transpose(1, 2) for _ in range(2))
    lens = torch.tensor([0, s, (s + 1) // 2], dtype=torch.int32, device=cuda_device)
    out, lse = fa_mod.flash_attention_cuda(q, k, v, lens, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and (out[0] == 0).all() and (lse[0] == -torch.inf).all()
    want = ref.flash_attention_ref(q, k, v, lengths=lens, causal=causal)
    tol = 2e-2 if dtype == BF16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse[1:], _lse_ref(q.float(), k.float(), lens, causal, 0)[1:], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,hd,dtype", [
    (2, 32, 2, 1024, 128, F32),  # GLM-4-9B's training forward: wgmma, two warpgroups
    (8, 96, 8, 256, 192, F32),  # Nemotron-4-340B
    (8, 32, 32, 256, 64, BF16),  # MusicGen-large in bf16
    (8, 12, 12, 32, 64, F32),  # the smallest bucket
    (8, 12, 12, 256, 64, F32),  # the prefill path's largest batch
])
def test_flash_forward_gives_the_same_bits_on_two_calls_and_in_a_graph(cuda_device, b, h, kv, s, hd, dtype):
    """No atomics: two calls give the same bits, with and without the LSE
    output.  A CUDA graph captured over
    the inputs, replayed after they are rewritten with new values, gives an
    eager call's bits on the new values: the tensor maps encoded at capture
    point at the buffers, not at their contents."""
    g = torch.Generator(device=cuda_device).manual_seed(33)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k, v = (_randn(g, (b, kv, s, hd), cuda_device, dtype) for _ in range(2))
    first, second = (fa_mod.flash_attention_cuda(q, k, v, return_lse=True) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa_mod.flash_attention_cuda(q, k, v), fa_mod.flash_attention_cuda(q, k, v))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fa_mod.flash_attention_cuda(q, k, v, return_lse=True)  # warm-up on the capture's stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fa_mod.flash_attention_cuda(q, k, v, return_lse=True)
    for t in (q, k, v):
        t.copy_(_randn(g, t.shape, cuda_device, dtype))
    graph.replay()
    eager = fa_mod.flash_attention_cuda(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(replayed, eager))
    assert not torch.equal(replayed[0], first[0])


# ------------------------------------------------------------- backwards
def _grad_close(got, want, tol):
    """Within ``tol`` relative and ``tol`` times the largest |want| (at least
    1) absolute: a gradient sums the same products in other orders."""
    scale = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


def _grads(fn, inputs, douts):
    """Outputs of ``fn`` on copies of ``inputs`` and the inputs' gradients
    for the outputs' gradients ``douts``."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o, d in zip(outs, douts) if d is not None],
                            [d for d in douts if d is not None])
    return outs, [t.grad for t in ins]


FLASH_BWD_CASES = [
    # b, h, kv, s, hd, dtype, window, softcap, lengths, causal
    (8, 12, 12, 256, 64, torch.float32, 0, 0.0, None, True),  # full-width orloj_gpt's step
    (2, 32, 2, 256, 128, torch.float32, 0, 0.0, None, True),  # GLM-4's GQA 16:1
    (2, 32, 2, 1024, 128, torch.float32, 0, 0.0, None, True),  # GLM-4's training step
    (2, 4, 4, 24, 16, torch.float32, 0, 0.0, [24, 9], True),  # head size 16, lengths
    (2, 8, 2, 300, 192, torch.float32, 0, 0.0, [300, 0], True),  # 192, ragged S, an empty row
    (2, 4, 2, 256, 64, torch.float32, 64, 0.0, None, True),  # Hymba's window, shorter than S
    (2, 8, 2, 256, 64, torch.float32, 0, 2.0, [256, 100], True),  # softcap
    (2, 4, 4, 64, 32, torch.float32, 0, 0.0, [64, 10], False),  # full attention
    (3, 4, 2, 1, 64, torch.float32, 0, 0.0, None, True),  # S = 1
    (2, 4, 4, 256, 64, torch.bfloat16, 0, 0.0, None, True),
    (2, 14, 2, 256, 128, torch.bfloat16, 96, 0.0, [256, 131], True),
    (2, 56, 8, 256, 128, torch.float32, 0, 0.0, None, True),  # Arctic's group of 7: 7 splits
    (2, 32, 2, 1000, 128, torch.float32, 0, 0.0, [1000, 0], True),  # group 16, S off the tile, empty row
    (2, 8, 2, 256, 192, torch.float32, 96, 0.0, None, True),  # group 4 at 192 (dV, then dK), window
    (2, 32, 2, 512, 128, torch.bfloat16, 0, 0.0, None, True),  # a bf16 group of 16, split
    (2, 4, 2, 96, 64, torch.float32, 64, 0.0, None, True),  # the reduced Hymba's window of 64 over 96
    (1, 25, 5, 1100, 64, torch.float32, 1024, 0.0, None, True),  # Hymba-1.5B's window of 1024
    (4, 4, 4, 24, 16, torch.float32, 0, 0.0, [24, 9, 1, 0], True),
    (2, 14, 2, 256, 128, torch.float32, 96, 2.0, None, True),  # a softcap and a window
    (8, 12, 12, 256, 64, torch.bfloat16, 0, 0.0, None, True),  # full-width orloj_gpt's step in bf16
    (2, 8, 2, 256, 192, torch.bfloat16, 0, 0.0, None, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kv,s,hd,dtype,window,softcap,lengths,causal", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_autograd_through_plain(cuda_device, b, h, kv, s, hd, dtype,
                                                              window, softcap, lengths, causal):
    """dq, dk, dv through ``ops.flash_attention``'s autograd formula (the
    forward with its LSE, then the backward kernel) against autograd through
    the plain version, on the same inputs and output gradient: float32 to
    1e-4, bf16 to 2e-2 (relative, and of the largest gradient); the LSE
    against the plain log-sum-exp (-inf for a row with no valid key)."""
    g = torch.Generator(device=cuda_device).manual_seed(20)
    q = _randn(g, (b, h, s, hd), cuda_device, dtype)
    k, v = (_randn(g, (b, kv, s, hd), cuda_device, dtype) for _ in range(2))
    dout = _randn(g, (b, h, s, hd), cuda_device, dtype)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (fa_mod.launches, fa_mod.backward_launches)
    (out,), got = _grads(lambda *t: ops.flash_attention(*t, lens, **kw), (q, k, v), (dout,))
    torch.cuda.synchronize()
    assert (fa_mod.launches, fa_mod.backward_launches) == (before[0] + 1, before[1] + 1)
    (want_out,), want = _grads(lambda *t: ref.flash_attention_ref(*t, lengths=lens, **kw), (q, k, v),
                               (dout,))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    _grad_close(out, want_out, tol)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype and a.shape == w.shape and torch.isfinite(a).all(), name
        _grad_close(a, w, tol)
    _, lse = fa_mod.flash_attention_cuda(q, k, v, lens, return_lse=True, **kw)
    i, j = torch.arange(s, device=cuda_device)[:, None], torch.arange(s, device=cuda_device)[None]
    mask = torch.ones((s, s), dtype=torch.bool, device=cuda_device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    mask = mask[None].expand(b, s, s)
    if lens is not None:
        mask = mask & (j[None] < lens[:, None, None])
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float().repeat_interleave(h // kv, 1)) / hd**0.5
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    want_lse = torch.where(mask[:, None], scores, -torch.inf).logsumexp(-1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4 if dtype == torch.float32 else 2e-2)
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        assert (got[0][row] == 0).all() and torch.isinf(lse[row]).all()


RMSNORM_BWD_CASES = [(2048, 4096, torch.float32), (2048, 1600, torch.float32), (300, 7168, torch.float32),
                     (7, 1024, torch.float32), (33, 130, torch.float32), (1, 64, torch.float32),
                     (256, 4096, torch.bfloat16),
                     (2048, 7168, torch.float32),  # Arctic's width: 8 vectors a thread
                     (33, 130, torch.bfloat16),  # single columns in bf16
                     (4, rms_mod.MAX_BACKWARD_D, torch.float32),  # the widest: the rereading kernel
                     (192, 256, torch.float32),  # the reduced Hymba's training rows
                     (1, 4096, torch.float32), (2048, 4096, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,dtype", RMSNORM_BWD_CASES)
def test_rmsnorm_backward_kernel_matches_autograd_through_plain(cuda_device, t, d, dtype):
    """dx and dscale through ``ops.rmsnorm`` (eps 1e-5, the models') against
    autograd through the plain version: dx to 1e-5 in float32 (one row sum
    in another order), dscale to 1e-4 (a column sum over T rows in another
    order), bf16 to 2e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    x = _randn(g, (t, d), cuda_device, dtype) * 3
    scale = _randn(g, (d,), cuda_device)
    dy = _randn(g, (t, d), cuda_device, dtype)
    before = (rms_mod.launches, rms_mod.backward_launches)
    (out,), (dx, dscale) = _grads(lambda a, w: ops.rmsnorm(a, w, eps=1e-5), (x, scale), (dy,))
    torch.cuda.synchronize()
    assert (rms_mod.launches, rms_mod.backward_launches) == (before[0] + 1, before[1] + 1)
    (_,), (want_dx, want_ds) = _grads(lambda a, w: ref.rmsnorm_ref(a, w, 1e-5), (x, scale), (dy,))
    bf16 = dtype == torch.bfloat16
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    _grad_close(dx, want_dx, 2e-2 if bf16 else 1e-5)
    _grad_close(dscale, want_ds, 2e-2 if bf16 else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention_bwd", "rmsnorm_bwd"])
def test_backward_kernels_give_bit_identical_gradients_on_two_calls(cuda_device, kernel):
    """No atomics and sums in a fixed order: the same inputs give the same
    bits, at GLM-4-9B's training shapes (flash (2,32->2,1024,128) float32,
    whose dK/dV go through split partials; RMSNorm (2048, 4096))."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    if kernel == "flash_attention_bwd":
        q = _randn(g, (2, 32, 1024, 128), cuda_device)
        k, v = (_randn(g, (2, 2, 1024, 128), cuda_device) for _ in range(2))
        dout = _randn(g, (2, 32, 1024, 128), cuda_device)
        out, lse = fa_mod.flash_attention_cuda(q, k, v, return_lse=True)
        first, second = (fa_mod.flash_attention_backward_cuda(q, k, v, out, dout, lse) for _ in range(2))
    else:
        x, dy = (_randn(g, (2048, 4096), cuda_device) for _ in range(2))
        scale = _randn(g, (4096,), cuda_device)
        first, second = (rms_mod.rmsnorm_backward_cuda(x, scale, dy, eps=1e-5) for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k,case", [(2048, 128, 2, "randn"), (256, 16, 4, "randn"), (64, 3, 2, "randn"),
                                        (64, 130, 4, "randn"), (2048, 256, 2, "randn"), (64, 8, 8, "randn"),
                                        (6, 16, 4, "ties"), (4, 16, 4, "-inf"), (512, 128, 2, "bf16"),
                                        (192, 16, 2, "randn"),  # the reduced Arctic's 16 experts
                                        (6, 16, 4, "tie_logits")])
def test_moe_gating_backward_kernel_matches_autograd_through_plain(cuda_device, t, e, k, case):
    """The logits' gradient through ``ops.moe_gating``'s gates against
    autograd through the plain version's gates, to 1e-5 of the largest
    (2e-2 over bf16 logits); the ids take no gradient and are equal."""
    g = torch.Generator(device=cuda_device).manual_seed(22)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    logits = (_randn(g, (t, e), cuda_device) * 2).to(dtype)
    if case == "ties":
        logits[1] = 3.0
        logits[2, [3, 9, 12]] = 5.0
    if case == "-inf":
        logits[0, 1:] = -torch.inf
        logits[1, ::2] = -torch.inf
    if case == "tie_logits":  # the forward test's ties: a row all equal, three equal maxima, ...
        logits = _tie_logits(cuda_device)
    dgates = _randn(g, (t, k), cuda_device)
    before = (gating_mod.launches, gating_mod.backward_launches)
    (gates, ids), (got,) = _grads(lambda x: ops.moe_gating(x, k), (logits,), (dgates, None))
    torch.cuda.synchronize()
    assert (gating_mod.launches, gating_mod.backward_launches) == (before[0] + 1, before[1] + 1)
    assert not ids.requires_grad
    (wg, wi), (want,) = _grads(lambda x: ref.moe_gating_ref(x, k), (logits,), (dgates, None))
    assert torch.equal(ids, wi)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _grad_close(got, want, 2e-2 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_moe_gating_backward_gives_the_same_bits_on_two_calls_and_in_a_graph(cuda_device):
    """Arctic's (2048, 128) k 2: shuffle sums in a fixed order, no atomics."""
    g = torch.Generator(device=cuda_device).manual_seed(25)
    logits = _randn(g, (2048, 128), cuda_device) * 2
    _, ids = gating_mod.moe_gating_cuda(logits, 2)
    dgates = _randn(g, (2048, 2), cuda_device)
    first, second = (gating_mod.moe_gating_backward_cuda(logits, ids, dgates) for _ in range(2))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gating_mod.moe_gating_backward_cuda(logits, ids, dgates)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = gating_mod.moe_gating_backward_cuda(logits, ids, dgates)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_moe_gating_backward_kernel_takes_rows_off_16_bytes(cuda_device, dtype):
    """Logits that start off a 16-byte boundary take the scalar layout; the
    gradient still holds autograd's through the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(26)
    t, e, k = 64, 128, 2
    logits = (_randn(g, (t * e + 1,), cuda_device) * 2).to(dtype)[1:].view(t, e)
    assert logits.data_ptr() % 16 != 0
    _, ids = gating_mod.moe_gating_cuda(logits, k)
    dgates = _randn(g, (t, k), cuda_device)
    got = gating_mod.moe_gating_backward_cuda(logits, ids, dgates)
    (_, wi), (want,) = _grads(lambda x: ref.moe_gating_ref(x, k), (logits,), (dgates, None))
    assert torch.equal(ids, wi)
    _grad_close(got, want, 2e-2 if dtype == BF16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention", "rmsnorm", "moe_gating"])
def test_flash_rmsnorm_and_gating_carry_a_graph_on_the_card(cuda_device, op):
    """Through ``ops``, inputs that require grad give an output with a graph
    whose backward launches the backward kernel once; under no_grad the
    forward alone launches, as on the serving path.  The raw launchers
    still refuse such inputs."""
    raw, inputs, mod = _kernel_call(op, cuda_device)
    route = {
        "flash_attention": lambda q, k, v: ops.flash_attention(q, k, v),
        "rmsnorm": lambda x, w: ops.rmsnorm(x, w),
        "moe_gating": lambda x: ops.moe_gating(x, 2)[0],
    }[op]
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    before = (mod.launches, mod.backward_launches)
    out = route(*ins)
    assert out.requires_grad and out.grad_fn is not None
    out.sum().backward()
    torch.cuda.synchronize()
    assert (mod.launches, mod.backward_launches) == (before[0] + 1, before[1] + 1)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in ins)
    with torch.no_grad():
        route(*ins)
    assert (mod.launches, mod.backward_launches) == (before[0] + 2, before[1] + 1)
    for t in inputs:
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        raw()


def train_step_card_and_cpu(cfg, tokens, labels, lr: float = 1e-3):
    """One train step of the same weights (drawn on the card from seed 4)
    and batch on the card and on the CPU.  The card's is the replay of a
    ``launch.train.TrainProgram``'s graph: the program's first call steps
    eagerly and captures, the state is put back to the drawn weights and
    fresh moments in place, and the second call replays the captured step
    on it.  The CPU's is ``launch.train.make_train_step``.  The gradients
    for the comparison are taken first, by ``torch.autograd.grad`` of the
    same loss.  Returns each side's (loss, gradient leaves, parameters
    after the step) and the launches of the card's replay."""
    from repro_torch.launch.train import TrainProgram, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves

    drawn = Model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(4))
    side, counts = {}, {}
    for dev in ("cuda", "cpu"):
        model = Model(cfg, device=dev)
        params = _tree_to(drawn, dev)  # the update is in place: each side its own copy
        for t in leaves(params):
            t.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tokens).to(dev), "labels": torch.from_numpy(labels).to(dev)}
        grads = torch.autograd.grad(model.loss(params, batch), leaves(params), allow_unused=True,
                                    materialize_grads=True)
        opt = AdamWConfig(lr=lr, total_steps=10, warmup_steps=1)
        opt_state = adamw_init(params)
        if dev == "cuda":
            program = TrainProgram(model, opt, params, opt_state, tuple(tokens.shape))
            program(params, opt_state, batch)
            with torch.no_grad():
                for t, t0 in zip(leaves(params), leaves(drawn), strict=True):
                    t.copy_(t0)
                for t in leaves(opt_state["m"]) + leaves(opt_state["v"]) + [opt_state["step"]]:
                    t.zero_()
            ops.reset_launch_counts()
            _, _, loss = program(params, opt_state, batch)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert program.graph is not None
        else:
            params, _, loss = make_train_step(model, opt)(params, opt_state, batch)
        side[dev] = (float(loss), [g.cpu() for g in grads], [t.detach().cpu() for t in leaves(params)])
    return side["cuda"], side["cpu"], counts


def train_step_errors(card, cpu, lr: float) -> dict:
    """How far the card's train step lies from the CPU's, and whether within
    tolerance (``ok``): the loss to 1e-4 relative; the global gradient norm
    to 1e-4 relative; every gradient leaf to 1e-3 of its largest |g| (at
    least 1) (float32 on both sides, the kernels summing in other orders);
    the parameters after the step, which moves each by lr·(g/(|g|+eps) +
    wd·p): to 1e-5 relative where the CPU's |g| is above 1e-2 of its leaf's
    largest (the step's sign is settled there), and within 2·lr elsewhere."""
    (l1, g1, p1), (l2, g2, p2) = card, cpu
    n1, n2 = (float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))) for gs in (g1, g2))
    grad_err = max(((a - b).abs().max() / max(1.0, b.abs().max().item())).item()
                   for a, b in zip(g1, g2, strict=True))
    settled_err, loose_err = 0.0, 0.0
    for a, b, g in zip(p1, p2, g2, strict=True):
        settled = g.abs() > 1e-2 * g.abs().max()
        d = (a - b).abs()
        if settled.any():
            settled_err = max(settled_err, (d[settled] / (1 + b.abs()[settled])).max().item())
        loose_err = max(loose_err, d.max().item())
    ok = (abs(l1 - l2) <= 1e-4 * abs(l2) and abs(n1 - n2) <= 1e-4 * abs(n2) and grad_err <= 1e-3
          and settled_err <= 1e-5 and loose_err <= 2 * lr + 1e-6)
    return {"loss": (l1, l2), "grad_norm": (n1, n2), "grad_err": grad_err, "settled_err": settled_err,
            "loose_err": loose_err, "ok": ok}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["glm4_9b", "arctic_480b", "hymba_1_5b", "orloj_gpt"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """GLM-4 (RMSNorm, GQA), Arctic with 16 experts (the gates' backward),
    Hymba (its window of 64 shorter than the 96 positions), orloj_gpt
    (layernorm): one train step on the card, through the backward kernels,
    replayed from the train program's graph, against the CPU's."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced(**({"n_experts": 16} if arch == "arctic_480b" else {}))
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 96))
    labels = rng.integers(0, cfg.vocab_size, size=(2, 96))
    labels[0, :5] = -1
    card, cpu, counts = train_step_card_and_cpu(cfg, tokens, labels, 1e-3)
    need = ("flash_attention_bwd",) + (("rmsnorm_bwd",) if cfg.norm == "rmsnorm" else ()) + (
        ("moe_gating_bwd",) if cfg.is_moe else ())
    for name in need:
        assert counts[name] > 0, name
    errors = train_step_errors(card, cpu, 1e-3)
    assert errors["ok"], errors


def _op_args(name, dev):
    """Small inputs of operator ``name``, the floating-point ones of the
    three differentiable forwards requiring grad."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = (_randn(g, (2, 4, 32, 64), dev) for _ in range(3))
    lengths = torch.tensor([32, 17], dtype=torch.int32, device=dev)
    x, scale = _randn(g, (3, 5, 64), dev), _randn(g, (64,), dev)
    logits = _randn(g, (8, 16), dev)
    if name == "flash_attention":
        return tuple(t.requires_grad_(True) for t in (q, k, v)) + (lengths, True, 0, 0.0, True)
    if name == "flash_attention_bwd":
        out, lse = torch.ops.repro_torch.flash_attention(q, k, v, lengths, True, 0, 0.0, True)
        return (q, k, v, out, _randn(g, out.shape, dev), lse, lengths, True, 0, 0.0)
    if name == "decode_attention":
        kc, vc = (_randn(g, (2, 4, 32, 64), dev) for _ in range(2))
        return (q[:, :, 0].contiguous(), kc, vc, lengths, 0.0)
    if name == "rmsnorm":
        return (x.requires_grad_(True), scale.requires_grad_(True), 1e-5)
    if name == "rmsnorm_bwd":
        return (x, scale, _randn(g, x.shape, dev), 1e-5)
    if name == "moe_gating":
        return (logits.requires_grad_(True), 2)
    gates, ids = torch.ops.repro_torch.moe_gating(logits, 2)
    return (logits, ids, _randn(g, gates.shape, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "decode_attention", "rmsnorm",
                                  "rmsnorm_bwd", "moe_gating", "moe_gating_bwd"])
def test_operators_pass_opcheck(cuda_device, name):
    """``torch.library.opcheck`` on each kernel's operator: its schema, its
    autograd registration, its fake implementation against the CUDA one,
    and its use under ``aot_autograd`` with dynamic shapes."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name).default, _op_args(name, cuda_device))


# ------------------------------------------------ the executors' graphs
GRAPH_ECFG_SHAPES = ((1, 32), (4, 64))


@pytest.fixture
def freed():
    """After the test, a collection frees what its engines and models hold
    in reference cycles, their executors' CUDA graphs among it, while no
    capture runs: a graph freed by a collection in the middle of a later
    capture invalidates that capture, and ``launch.train.TrainProgram``
    keeps the collector on while it captures (ROADMAP.md, queue C)."""
    yield
    gc.collect()


def _graph_engine(arch, dev, cut=None):
    from repro_torch.serving.engine import EngineConfig, TorchServingEngine

    ecfg = EngineConfig(buckets=(32, 64), batch_sizes=(1, 4), profile_reps=1)
    return TorchServingEngine(_config(arch, cut), ecfg, seed=3, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cut", [(a, None) for a in ("orloj_gpt", "arctic_480b", "hymba_1_5b")] + [
    # The served graphs at published widths: the whole orloj_gpt and Hymba-1.5B, one Arctic layer (56.3 GB)
    _full("orloj_gpt", {}), _full("arctic_480b", {"n_layers": 1}), _full("hymba_1_5b", {}),
])
def test_replayed_logits_equal_eager_ones(cuda_device, freed, arch, cut):
    """Each served shape is a captured graph: its replay's logits equal an
    eager ``model.logits`` call on the same tokens bit for bit (the same
    kernels on the same inputs), twice a shape with other tokens."""
    import numpy as np

    engine = _graph_engine(arch, cuda_device, cut)
    ex = engine.executor
    rng = np.random.default_rng(5)
    for shape in GRAPH_ECFG_SHAPES * 2:
        tokens = rng.integers(1, engine.model.cfg.vocab_size, size=shape)
        ex._run(tokens)
        assert ex._shapes[shape][1].graph is not None
        with torch.no_grad():
            want = engine.model.logits(engine.params, {"tokens": torch.from_numpy(tokens).to(cuda_device)})
        torch.cuda.synchronize()
        assert torch.equal(ex.last_logits, want), (ex.last_logits - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernels", [("orloj_gpt", ("flash_attention",)),
                                          ("arctic_480b", ("flash_attention", "rmsnorm", "moe_gating")),
                                          ("hymba_1_5b", ("flash_attention", "rmsnorm", "selective_scan"))])
def test_serving_on_the_card_accounts_for_every_request(cuda_device, freed, arch, kernels):
    """The engine profiles Eq. 3 on the card and serves 24 requests under
    Orloj: every request is accounted for, no parameter requires grad (the
    kernels refuse such inputs under grad mode), and the served graphs
    launch the kernels of the model's prefill path."""
    from repro_torch.launch.serve import length_sampler, make_scheduler
    from repro_torch.optim.adamw import leaves

    engine = _graph_engine(arch, cuda_device)
    assert not any(t.requires_grad for t in leaves(engine.params))
    lm = engine.profile_latency_model()
    reqs, hist = engine.make_requests(24, lm, length_sampler=length_sampler, seed=0)
    ops.reset_launch_counts()
    res = engine.serve(reqs, make_scheduler("orloj", lm, hist, engine.cfg.batch_sizes))
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    assert res.n_total == 24 and res.conserved and res.n_batches > 0
    assert all(counts[name] > 0 for name in kernels), counts


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["orloj_gpt", "arctic_480b", "hymba_1_5b", "xlstm_1_3b"])
def test_token_serving_on_the_card_serves_every_token(cuda_device, freed, arch):
    """Sixteen token requests through continuous batching on the decode
    kernel's graph, under scheduler SLOs far above the requests' own: every
    request is accounted for and every output token served."""
    from repro_torch.core.tokensched import LengthAwareTokenScheduler, TokenSchedConfig

    engine = _graph_engine(arch, cuda_device)
    dec = engine.decode_executor(max_batch=8, max_cache=256)
    reqs = engine.make_token_requests(16, dec, seed=0)
    step_ms = dec.calibrate()
    sched = LengthAwareTokenScheduler(TokenSchedConfig(max_batch=8, ttft_slo_ms=1e9, tpot_slo_ms=1e9,
                                                       d0=step_ms, d1=0.0))
    ops.reset_launch_counts()
    res = engine.serve_tokens(reqs, sched, dec)
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    assert res.n_total == 16 and res.conserved
    assert all(r.tokens_done == r.out_tokens for r in reqs)
    assert counts["decode_attention"] > 0, counts


@pytest.mark.cuda
def test_served_launch_counts_equal_the_eager_counts(cuda_device):
    """Launches counted over served batches (each shape's eager warm-up, its
    capture, its replays) equal those of the same forwards run eagerly."""
    import numpy as np

    engine = _graph_engine("orloj_gpt", cuda_device)
    calls = [np.ones(s, np.int32) for s in ((1, 32), (3, 64), (1, 32), (4, 64), (2, 32))]
    ops.reset_launch_counts()
    for tokens in calls:
        engine.executor._run(tokens)
    served = ops.launch_counts()
    ops.reset_launch_counts()
    seen = set()
    with torch.no_grad():
        for tokens in calls:
            k = engine.executor.padded_batch_size(tokens.shape[0])
            batch = {"tokens": torch.ones((k, tokens.shape[1]), dtype=torch.long, device=cuda_device)}
            for _ in range(1 if (k, tokens.shape[1]) in seen else 2):  # the warm-up, then the run
                engine.model.logits(engine.params, batch)
            seen.add((k, tokens.shape[1]))
    assert served == ops.launch_counts() and served["flash_attention"] > 0
    ops.reset_launch_counts()


@pytest.mark.cuda
def test_decode_graph_matches_the_eager_step(cuda_device):
    """The decode executor's graph against its body run eagerly, from one
    seed: five steps with a full slot (the ring quirk's write at 0), an
    empty one and two partial ones, equal bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import DecodeTorchExecutor

    cfg = get_config("orloj_gpt")
    graphed, eager = (DecodeTorchExecutor(cfg, max_batch=4, max_cache=64, seed=9, device=cuda_device)
                      for _ in range(2))
    assert graphed._program.graph is not None
    for dec in (graphed, eager):
        dec._valid = torch.tensor([64, 0, 5, 1], dtype=torch.int32, device=cuda_device)
    before = dec_mod.launches
    for _ in range(5):
        graphed._decode_once()
        eager._draw()
        with torch.no_grad():
            out = eager._step()
        torch.cuda.synchronize()
        for a, b in ((graphed.last_out, out), (graphed._kc, eager._kc), (graphed._vc, eager._vc),
                     (graphed._valid, eager._valid)):
            assert torch.equal(a, b)
    assert dec_mod.launches == before + 10
    assert graphed._valid.tolist() == [64, 0, 10, 6]


@pytest.mark.cuda
def test_a_forward_that_syncs_raises_at_capture(cuda_device):
    """A forward that reads a value back to the host (``.item()``) cannot be
    captured: the executor raises at the shape's first use and runs nothing
    eagerly in its place, and the capture adds no launch."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.engine import EngineConfig, TorchExecutor

    class Syncing(Model):
        def logits(self, params, batch):
            batch["tokens"].sum().item()
            return super().logits(params, batch)

    cfg = get_config("orloj_gpt").reduced()
    model = Syncing(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    ex = TorchExecutor(model, params, EngineConfig(buckets=(32,), batch_sizes=(1,)))
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError):
        ex._run(np.ones((1, 32), np.int32))
    assert (1, 32) not in ex._warm
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers  # the warm-up's alone
    ops.reset_launch_counts()


# ------------------------------------------------ the training step's graph
def _train_state(model, dev, seed=6):
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves

    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    for p in leaves(params):
        p.requires_grad_(True)
    return params, adamw_init(params)


def _train_batches(cfg, dev, n, b=2, s=64):
    import numpy as np

    rng = np.random.default_rng(8)
    out = []
    for _ in range(n):
        tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s))).to(dev)
                          for _ in range(2))
        labels[0, :4] = -1
        out.append({"tokens": tokens, "labels": labels})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_graphed_train_loop_equals_the_eager_loop(cuda_device, remat):
    """Four steps of a ``TrainProgram`` (step 1 eager, then three replays of
    its graph) and of ``make_train_step`` from the same weights and batches
    at a reduced GLM-4, with and without recomputation: the losses and the
    final parameters bit-identical (the same deterministic kernels on the
    same states), or else within T3's tolerances (loss 1e-4 relative, a
    parameter 2·lr), the largest |Δ| printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainProgram, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import leaves

    cfg = get_config("glm4_9b").reduced(remat=remat)
    model = Model(cfg, device=cuda_device)
    opt = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    batches = _train_batches(cfg, cuda_device, 4)
    (p1, s1), (p2, s2) = _train_state(model, cuda_device), _train_state(model, cuda_device)
    program, eager = TrainProgram(model, opt, p1, s1, (2, 64)), make_train_step(model, opt)
    l1, l2 = [], []
    for batch in batches:
        p1, s1, loss = program(p1, s1, batch)
        l1.append(float(loss))
        p2, s2, loss = eager(p2, s2, batch)
        l2.append(float(loss))
    assert program.graph is not None and int(s1["step"]) == int(s2["step"]) == 4
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(l1, l2))
    d_param = max((a - b).abs().max().item() for a, b in zip(leaves(p1), leaves(p2), strict=True))
    print(f"remat={remat}: losses {l1} vs {l2}: max relative |Δ| {d_loss:.3e}, parameters max |Δ| {d_param:.3e}")
    assert d_loss <= 1e-4 and d_param <= 2 * opt.lr
    assert l1[-1] != l1[0]


@pytest.mark.cuda
def test_training_on_the_card_lowers_the_loss(cuda_device):
    """``launch.train.train``, the CLI's body, on the card (step 1 eager,
    then replays of the step's graph) over 30 steps of a reduced orloj_gpt:
    every loss finite, the last five below the first five."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    losses = train(get_config("orloj_gpt").reduced(), steps=30, batch=4, seq=64, device=cuda_device)
    assert len(losses) == 30 and all(torch.isfinite(torch.tensor(losses)))
    assert sum(losses[-5:]) < sum(losses[:5]), losses


@pytest.mark.cuda
def test_replayed_train_step_launches_equal_the_eager_step(cuda_device):
    """The launches counted over a replay of the train step equal those of
    the program's eager first step: the capture's counts are taken back and
    added again at each replay."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainProgram
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig

    cfg = get_config("glm4_9b").reduced(remat=True)
    model = Model(cfg, device=cuda_device)
    params, state = _train_state(model, cuda_device)
    program = TrainProgram(model, AdamWConfig(lr=1e-3, total_steps=3, warmup_steps=1), params, state, (2, 64))
    batches = _train_batches(cfg, cuda_device, 2)
    ops.reset_launch_counts()
    program(params, state, batches[0])
    eager = ops.launch_counts()
    ops.reset_launch_counts()
    program(params, state, batches[1])
    torch.cuda.synchronize()
    replayed = ops.launch_counts()
    assert program.graph is not None and replayed == eager
    assert replayed["flash_attention"] == 2 * replayed["flash_attention_bwd"] == 2 * cfg.n_layers
    assert replayed["rmsnorm_bwd"] > 0
    ops.reset_launch_counts()


@pytest.mark.cuda
def test_a_train_step_that_syncs_raises_at_capture(cuda_device):
    """A loss that reads a value back to the host (``.item()``) cannot be
    captured: the program's first call takes its eager step, then raises at
    the capture, which adds no launch; a second call raises again, so no
    step runs eagerly in the graph's place."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainProgram
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig

    class Syncing(Model):
        def loss(self, params, batch):
            batch["labels"].max().item()
            return super().loss(params, batch)

    cfg = get_config("orloj_gpt").reduced()
    model = Syncing(cfg, device=cuda_device)
    params, state = _train_state(model, cuda_device)
    program = TrainProgram(model, AdamWConfig(), params, state, (2, 64))
    batch = _train_batches(cfg, cuda_device, 1)[0]
    for steps in (1, 2):
        ops.reset_launch_counts()
        with pytest.raises(RuntimeError):
            program(params, state, batch)
        assert program.graph is None and int(state["step"]) == steps
        counts = ops.launch_counts()
        assert counts["flash_attention"] == counts["flash_attention_bwd"] == cfg.n_layers  # the eager step's
    ops.reset_launch_counts()


# ----------------------------------------------------- the float32 GEMM
def _tf32_one_pass(x):
    """x rounded to TF32 (one pass's operands): to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm_errors(x, w, y, cols: int = 1 << 14) -> tuple[float, float, float]:
    """The kernel's, cuBLAS float32's and one TF32 pass's largest error
    against the float64 product, each over the largest |product|; the
    float64 products ``cols`` columns at a time (Nemotron's head is 18.9 GB
    in float32)."""
    f32 = x @ w
    x64, x_one = x.double(), _tf32_one_pass(x).double()
    scale, errs = 0.0, [0.0, 0.0, 0.0]
    for j in range(0, w.shape[1], cols):
        part = w[:, j : j + cols]
        want = x64 @ part.double()
        one = x_one @ _tf32_one_pass(part).double()
        scale = max(scale, want.abs().max().item())
        for i, got in enumerate((y[:, j : j + cols], f32[:, j : j + cols], one)):
            errs[i] = max(errs[i], (got.double() - want).abs().max().item())
    return tuple(e / scale for e in errs)


# GLM-4-9B's weight products (K, N): q and o, k and v, gate and up, down,
# the head; then Arctic's (d 7168, MLP 4864), Hymba-1.5B's (d 1600, MLP 5504)
# and Nemotron-4-340B's (q and o, k and v, the relu2 MLP's up and down, the
# head), each of whose weights takes 0.1-19 GB.
GEMM_GLM4 = [(4096, 4096), (4096, 256), (4096, 13696), (13696, 4096), (4096, 151552)]
GEMM_OTHER = [(7168, 7168), (7168, 4864), (4864, 7168), (1600, 1600), (1600, 5504), (5504, 1600)] + [
    _full(18432, n) for n in (18432, 1536, 73728, 256000)] + [_full(73728, 18432)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", GEMM_GLM4 + GEMM_OTHER)
@pytest.mark.parametrize("m", [1, 8, 32, 37, 64, 128, 256, 2048])
def test_gemm_kernel_matches_the_float64_product(cuda_device, m, k, n):
    """The split-TF32 kernel within 4x cuBLAS float32's error of the float64
    product and at least 100x under one TF32 pass's, at GLM-4-9B's products
    (and Arctic's and Hymba's widths) for M = 1 to 2048, through
    ``ops.matmul`` (one launch)."""
    from repro_torch.kernels import gemm as gemm_mod

    g = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = _randn(g, (m, k), cuda_device)
    w = _randn(g, (k, n), cuda_device) / k**0.5
    before = gemm_mod.launches
    y = ops.matmul(x, w)
    torch.cuda.synchronize()
    assert gemm_mod.launches == before + 1 and y.shape == (m, n) and y.dtype == torch.float32
    err, err_f32, err_one = gemm_errors(x, w, y)
    print(f"({m},{k})x({k},{n}): kernel {err:.3e}, cuBLAS f32 {err_f32:.3e}, one TF32 pass {err_one:.3e}")
    assert err <= 4 * err_f32 and 100 * err <= err_one


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(32, 4096, 256), (128, 4096, 13696), (37, 13696, 4096), (1, 4096, 4096),
                                   (300, 4096, 4096)])
def test_gemm_gives_the_same_bits_on_two_calls_and_in_a_graph(cuda_device, m, k, n):
    """Split and unsplit plans: two calls equal bit for bit (the split-K
    partials are added in split order), and a CUDA graph of the call,
    replayed over rewritten inputs, equals an eager call on them."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as gemm_mod

    g = torch.Generator(device=cuda_device).manual_seed(11)
    x = _randn(g, (m, k), cuda_device)
    w = _randn(g, (k, n), cuda_device)
    plan = gemm_mod.gemm_plan(m, n, k, _build.sm_count(cuda_device))
    a, b = gemm_mod.gemm_cuda(x, w), gemm_mod.gemm_cuda(x, w)
    assert torch.equal(a, b), plan
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gemm_mod.gemm_cuda(x, w)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gemm_mod.gemm_cuda(x, w)
    for seed in (12, 13):
        x.copy_(_randn(torch.Generator(device=cuda_device).manual_seed(seed), (m, k), cuda_device))
        graph.replay()
        eager = gemm_mod.gemm_cuda(x, w)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), plan


@pytest.mark.cuda
def test_gemm_launcher_refuses_what_it_does_not_take(cuda_device):
    """The wrapper's checks (shapes, types, rows off 16 bytes, a gradient)
    and the C launcher's (a plan that does not fit the kernel's layout)
    raise; ``ops.matmul`` routes bf16, gradients, unaligned rows and a
    transposed weight to the plain product and launches nothing."""
    import dataclasses

    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as gemm_mod

    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = _randn(g, (64, 512), cuda_device)
    w = _randn(g, (512, 256), cuda_device)
    for bad_x, bad_w, err in ((x[:, :510], w[:510], ValueError),  # K off a multiple of 4
                              (x, w[:, :254], ValueError),  # N off a multiple of 4
                              (x.bfloat16(), w.bfloat16(), TypeError),
                              (x.view(-1)[1:1 + 64 * 508].view(64, 508), w[:508], ValueError),  # off 16 bytes
                              (x.t(), w[:64], ValueError),  # K not contiguous
                              (x, w.cpu(), ValueError)):
        with pytest.raises(err):
            gemm_mod.gemm_cuda(bad_x, bad_w)
    with pytest.raises(RuntimeError, match="requires grad"):
        gemm_mod.gemm_cuda(x.clone().requires_grad_(True), w)
    plan = gemm_mod.gemm_plan(64, 256, 512, _build.sm_count(cuda_device))
    for bad in (dataclasses.replace(plan, stages=9, shared_bytes=gemm_mod.shared_bytes(plan.tokens, 9)),
                dataclasses.replace(plan, shared_bytes=plan.shared_bytes + 16),
                dataclasses.replace(plan, tokens=48),
                dataclasses.replace(plan, warpgroups=1),
                dataclasses.replace(plan, splits=plan.splits + 4),  # splits left without a K tile
                dataclasses.replace(plan, splits=1, tiles_per_split=1)):  # K not covered
        with pytest.raises(RuntimeError, match="launch failed"):
            gemm_mod.gemm_cuda(x, w, bad)
    before = gemm_mod.launches
    for a, b in ((x.bfloat16(), w.bfloat16()), (x, w.clone().requires_grad_(True)),
                 (_randn(g, (4, 50), cuda_device), _randn(g, (50, 8), cuda_device)),
                 (x[:, :256], _randn(g, (256, 256), cuda_device).t())):  # a transposed table
        out = ops.matmul(a, b)
        torch.testing.assert_close(out.float(), (a @ b).float(), rtol=0, atol=0)
    assert gemm_mod.launches == before


@pytest.mark.cuda
def test_a_captured_glm4_9b_forward_launches_281_gemms(cuda_device):
    """GLM-4-9B at full width and depth, one served shape captured as the
    executor captures it: the graph's launches hold 7 x 40 + 1 = 281 GEMM
    launches, every weight product of the forward, and its logits equal an
    eager forward's bit for bit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import gemm as gemm_mod
    from repro_torch.models import Model
    from repro_torch.serving.engine import EngineConfig, TorchExecutor

    cfg = get_config("glm4_9b")
    model = Model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    ex = TorchExecutor(model, params, EngineConfig(buckets=(32,), batch_sizes=(1,)))
    tokens = np.arange(1, 33, dtype=np.int32)[None]
    ex._run(tokens)
    launches = ex._shapes[(1, 32)][1].launches
    assert gemm_mod.weight_products(cfg) == 281 and launches["gemm"] == 281, launches
    with torch.no_grad():
        want = model.logits(params, {"tokens": torch.from_numpy(tokens).long().to(cuda_device)})
    assert torch.equal(ex.last_logits, want)
    del ex, params, model
    torch.cuda.empty_cache()


# ---------------------------------------- placement on the card's host
@pytest.fixture
def debug_mesh(cuda_device):
    """The 1-device debug mesh: an NCCL group of one, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_fake_world, make_debug_mesh

    destroy_fake_world()
    yield make_debug_mesh()
    dist.destroy_process_group()


def _loss_and_grads(model, params, batch):
    from repro_torch.optim.adamw import leaves

    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True, materialize_grads=True)
    loss = loss.detach()
    return float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss), grads


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernels", [
    ("glm4_9b", ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")),
    ("arctic_480b", ("moe_gating", "moe_gating_bwd", "flash_attention_bwd")),
])
def test_dtensor_train_step_on_the_card_equals_the_plain_one(debug_mesh, arch, kernels):
    """Parameters in DTensors by ``param_specs`` on the debug mesh (their
    shards alias the plain tensors): one step's loss and gradient norm
    within 1e-4 relative of the plain tensors', each gradient leaf within
    1e-3 of its largest, with the kernels and their backwards launched
    under DTensor."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import Model
    from repro_torch.models.sharding import input_batch_specs, param_specs, place
    from repro_torch.optim.adamw import leaves

    cfg = get_config(arch).reduced(**({"n_experts": 16} if arch == "arctic_480b" else {}))
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(4))
    for t in leaves(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 96))).cuda() for k in ("tokens", "labels")}
    l1, g1 = _loss_and_grads(model, params, batch)
    dparams = place(params, debug_mesh, param_specs(cfg, params, debug_mesh))
    dbatch = place(batch, debug_mesh, input_batch_specs(cfg, debug_mesh, batch, 2))
    ops.reset_launch_counts()
    with implicit_replication():
        l2, g2 = _loss_and_grads(model, dparams, dbatch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    g2 = [g.full_tensor() for g in g2]
    n1, n2 = (float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in gs))) for gs in (g1, g2))
    assert abs(l1 - l2) <= 1e-4 * abs(l1) and abs(n1 - n2) <= 1e-4 * abs(n1)
    for a, b in zip(g1, g2, strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-3 * max(1.0, a.abs().max().item()))
    assert all(counts[name] > 0 for name in kernels), counts


@pytest.mark.cuda
def test_dtensor_decode_steps_on_the_card_equal_the_plain_ones(debug_mesh):
    """Six decode steps of a reduced GLM-4-9B with its parameters placed by
    ``param_specs`` and its cache by ``cache_specs``: the logits within 1e-4
    of the largest of the plain tensors', the decode kernel launched under
    DTensor."""
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import Model
    from repro_torch.models.sharding import cache_specs, input_batch_specs, param_specs, place

    cfg = get_config("glm4_9b").reduced()
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(5))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 6))).cuda()
    with torch.no_grad():
        cache = model.init_cache(2, cache_len=64)
        plain = [model.decode_step(params, toks[:, i : i + 1], cache, i)[0] for i in range(6)]
        dparams = place(params, debug_mesh, param_specs(cfg, params, debug_mesh))
        cache = model.init_cache(2, cache_len=64)
        dcache = place(cache, debug_mesh, cache_specs(cfg, debug_mesh, cache, 2, seq_shard=False))
        ops.reset_launch_counts()
        got = []
        with implicit_replication():
            for i in range(6):
                tok = place({"t": toks[:, i : i + 1]}, debug_mesh,
                            input_batch_specs(cfg, debug_mesh, {"t": toks[:, i : i + 1]}, 2))["t"]
                got.append(model.decode_step(dparams, tok, dcache, i)[0].full_tensor())
        torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] > 0
    for a, b in zip(plain, got):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4 * a.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape", [("glm4_9b", "train_4k"), ("arctic_480b", "decode_32k"),
                                        ("nemotron_4_340b", "prefill_32k")])
def test_dry_run_lowers_on_the_production_mesh_under_the_card_hosts_torch(cuda_device, arch, shape):
    """The dry-run on the 16x16 production mesh over a fake process group
    (the shards are meta tensors: nothing runs on the card) under the card
    host's PyTorch, whose DTensor differs from the CPU host's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import destroy_fake_world

    try:
        r = dryrun.run_one(arch, shape, False, save=False)
    finally:
        destroy_fake_world()
    assert r.ok, r.error
