"""Hymba at its published widths in the port (``models/hymba.py``'s options
through the blocks and the model), on the CPU:
its configuration's defaults reproduce the reference's narrow block bit for
bit; at a tiny size with every option on (meta tokens, a global layer, a
shared K/V pair, a window shorter than the prompts, a Mamba twice as wide,
tied embeddings) its forward matches the benchmark's plain reference
(``orloj_bench/reference/hymba.py``) on seeded weights, and a prefill that
fills the decode cache followed by decode steps matches that forward; the
flash route's prefix mask, the selective scan's plain version and the
decode executor's prefix-plus-ring cache.  The kernels' cases on the card
are in ``tests/test_torch_cuda.py``."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import HymbaConfig, Model, ssm  # noqa: E402

TINY_FILE = CHECKOUT / "orloj_bench" / "tests" / "tiny" / "tiny_hymba.json"


def _tiny():
    from orloj_bench import harness
    from orloj_bench.weights import make_weights, port_params

    cfg = json.loads(TINY_FILE.read_text())
    w = make_weights(cfg, 2**31 + 17, "cpu")
    return cfg, w, Model(harness.model_config(cfg), device="cpu"), port_params(cfg, w)


def test_the_defaults_are_the_narrow_block_bit_for_bit():
    narrow = get_config("hymba_1_5b").reduced()
    wide = HymbaConfig(**dataclasses.asdict(narrow))
    a, b = Model(narrow, device="cpu"), Model(wide, device="cpu")
    params = a.init(torch.Generator().manual_seed(3))
    tokens = torch.randint(0, narrow.vocab_size, (2, 80), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(a.logits(params, {"tokens": tokens}), b.logits(params, {"tokens": tokens}))
        ca, cb = a.init_cache(2, 96, torch.float32), b.init_cache(2, 96, torch.float32)
        for i in range(70):
            la, ca = a.decode_step(params, tokens[:, i : i + 1], ca, i)
            lb, cb = b.decode_step(params, tokens[:, i : i + 1], cb, i)
            assert torch.equal(la, lb), i


def test_the_published_layers_and_pairs():
    from orloj_bench import harness, traffic

    cfg = harness.model_config(traffic.load("configs", "hymba_1_5b"))
    assert isinstance(cfg, HymbaConfig) and cfg.ssm_inner == 3200 and cfg.dt_rank == 100
    src = cfg.kv_sources()
    assert [i for i in range(32) if cfg.window(i) == 0] == [0, 15, 31]
    pairs = [(s, i) for i, s in enumerate(src) if s != i]
    assert pairs == [(i, i + 1) for i in range(1, 14, 2)] + [(i, i + 1) for i in range(16, 29, 2)]
    assert sum(s == i for i, s in enumerate(src)) == 18
    assert cfg.tie_embeddings and cfg.n_meta_tokens == 128


@pytest.mark.parametrize("seq", [1, 9, 31])
def test_tiny_forward_matches_the_plain_reference(seq):
    from orloj_bench import harness, reference

    cfg, w, model, params = _tiny()
    tokens = torch.randint(1, cfg["vocab_size"], (2, seq), generator=torch.Generator().manual_seed(seq))
    with torch.no_grad():
        got = model.logits(params, {"tokens": tokens})
    for b in range(2):
        r = harness.readings(reference.logits(cfg, w, tokens[b]), got[b])
        assert r["logit_err"] < 1e-5 and r["top_gap"] == 0.0, r


def test_prefill_then_decode_matches_the_reference_forward():
    """The cache a prefill leaves (the meta tokens' slots, each windowed
    layer's ring, the shared pair's one cache, the Mamba states), then 24
    decode steps past the ring's length: every step's logits against the
    plain reference's forward over the whole sequence."""
    from orloj_bench import harness, reference

    cfg, w, model, params = _tiny()
    p = cfg["n_meta_tokens"]
    tokens = torch.randint(1, cfg["vocab_size"], (2, 36), generator=torch.Generator().manual_seed(8))
    want = [reference.logits(cfg, w, tokens[b]) for b in range(2)]
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": tokens[:, :12]}, 64, torch.float32)
        slots = [c["kv"]["k"].shape[2] for c in cache]
        assert slots == [p + cfg["sliding_window"]] * 2 + [64, p + cfg["sliding_window"]]
        assert cache[1]["kv"] is cache[0]["kv"] and cache[3]["kv"] is not cache[0]["kv"]
        for b in range(2):
            assert harness.readings(want[b][11:12], last[b])["logit_err"] < 1e-5
        for j in range(12, 36):
            out, cache = model.decode_step(params, tokens[:, j : j + 1], cache, p + j)
            for b in range(2):
                r = harness.readings(want[b][j : j + 1], out[b])
                assert r["logit_err"] < 1e-5 and r["top_gap"] == 0.0, (j, r)


def test_remat_is_refused_where_layers_share_kv():
    cfg, _, model, params = _tiny()
    remat = Model(dataclasses.replace(model.cfg, remat=True), device="cpu")
    tokens = torch.ones((1, 5), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        remat.loss(params, {"tokens": tokens, "labels": tokens})
    with torch.no_grad():  # no gradient, no recomputation
        assert torch.equal(remat.logits(params, {"tokens": tokens}),
                           model.logits(params, {"tokens": tokens}))


def test_prefill_keeps_the_meta_slots_and_the_rings_last_positions():
    cfg, _, model, params = _tiny()
    p, win = cfg["n_meta_tokens"], cfg["sliding_window"]
    tokens = torch.randint(1, cfg["vocab_size"], (1, 13), generator=torch.Generator().manual_seed(2))
    shared: dict = {}
    with torch.no_grad():
        model._stack(params, {"tokens": tokens}, [], shared)
        _, cache = model.prefill(params, {"tokens": tokens}, 64, torch.float32)
    assert sorted(shared) == [0, 2, 3]
    k = shared[0]["k"][0].transpose(0, 1)  # layer 0's K, (KV, P + S, hd)
    ring = cache[0]["kv"]["k"][0]
    assert torch.equal(ring[:, :p], k[:, :p])
    for pos in range(p + 13 - win, p + 13):  # the window's positions, each in its ring slot
        assert torch.equal(ring[:, p + (pos - p) % win], k[:, pos])
    assert torch.equal(cache[2]["kv"]["k"][0, :, : p + 13], shared[2]["k"][0].transpose(0, 1))


@pytest.mark.parametrize("window,prefix", [(4, 0), (4, 3), (6, 8), (0, 3)])
def test_the_flash_prefix_mask(window, prefix):
    g = torch.Generator().manual_seed(window + prefix)
    q = torch.randn(2, 4, 13, 16, generator=g)
    k, v = torch.randn(2, 2, 13, 16, generator=g), torch.randn(2, 2, 13, 16, generator=g)
    lengths = torch.tensor([13, 9], dtype=torch.int32)
    got = ops.flash_attention(q, k, v, lengths, window=window, prefix=prefix)
    i, j = torch.arange(13)[:, None], torch.arange(13)[None, :]
    seen = j <= i
    if window:
        seen &= (j > i - window) | (j < prefix)
    for b, n in enumerate(lengths.tolist()):
        kk, vv = k[b].repeat_interleave(2, 0), v[b].repeat_interleave(2, 0)
        s = torch.einsum("hqd,hkd->hqk", q[b], kk) / 4.0
        m = seen & (j < n)
        probs = torch.softmax(s.masked_fill(~m, -math.inf), -1).nan_to_num(0.0)  # no key: 0
        want = torch.einsum("hqk,hkd->hqd", probs, vv)
        torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-5)
    pairs = ops.flash_pairs(13, True, window, lengths.numpy(), prefix)
    assert pairs.tolist() == [int((seen & (j < n)).sum()) for n in lengths.tolist()]


def test_the_scans_plain_version_is_the_models_doubling_scan():
    """``ref.selective_scan_ref`` (one position at a time, what the card's
    kernel is held to) against the model's torch route on the CPU: y and
    the last state."""
    g = torch.Generator().manual_seed(5)
    params = ssm.init_mamba(g, 24, 16, dt_rank=5, inner=48)
    params["dt_bias"] = params["dt_bias"] - 3.0
    x = torch.randn(2, 40, 24, generator=g)
    state: dict = {}
    with torch.no_grad():
        want = ssm.mamba_apply(params, x, chunk=16, state=state)
        xb = x @ params["in_x"]
        xc = torch.nn.functional.silu(ssm._causal_conv(xb, params["conv"]))
        dt = ssm._mamba_dt(params, xc)
        y, h = ops.selective_scan(xc, dt, xc @ params["w_b"], xc @ params["w_c"], x @ params["in_z"],
                                  params["a_log"], params["d_skip"], last_state=True)
    torch.testing.assert_close(y @ params["out"], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, state["h"], rtol=1e-5, atol=1e-6)
    assert torch.equal(state["conv"], xb[:, -3:])


def test_the_card_scans_backward_differentiates_the_torch_scan():
    """``ssm._CardScan`` (the kernel's forward, here its plain version on
    the CPU) against the torch scan it recomputes in its backward: y, the
    last state and the gradient of every input."""
    inputs = _scan_inputs(2, 40, 24, "cpu", seed=3)
    weight = torch.randn(2, 40, 24, generator=torch.Generator().manual_seed(4))
    grads = []
    for run in (lambda *t: ssm._CardScan.apply(16, True, *t), lambda *t: ssm._scan_torch(*t, chunk=16)):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        y, h = run(*leaves)
        (y * weight).sum().backward()
        grads.append((y.detach(), h.detach(), [t.grad for t in leaves]))
    (y1, h1, g1), (y2, h2, g2) = grads
    torch.testing.assert_close(y1, y2, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h1, h2, rtol=1e-5, atol=1e-6)
    assert not h1.requires_grad
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)  # the same recomputation


def test_the_decode_executor_keeps_the_meta_slots_in_front_of_the_ring():
    from repro_torch.serving.engine import DecodeTorchExecutor

    cfg = HymbaConfig(**dataclasses.asdict(get_config("hymba_1_5b").reduced()) | {
        "n_meta_tokens": 5, "kv_share": True})
    ex = DecodeTorchExecutor(cfg, max_batch=2, max_cache=8, device="cpu")
    assert ex._kc.shape[2] == 5 + 8 and len(ex._queries) == 2
    meta = ex._kc[:, :, :5].clone()
    ex._valid = torch.tensor([3, 0], dtype=torch.int32)
    for step in range(10):  # the ring wraps; the meta slots stay
        ex._decode_once()
        assert torch.equal(ex._kc[:, :, :5], meta)
    valid = torch.tensor([8 + 5, 0], dtype=torch.int32)
    want = torch.cat([ref.decode_attention_ref(q, ex._kc, ex._vc, valid) for q in ex._queries], 1)
    assert torch.equal(ex.last_out, want)
    assert torch.equal(ex.last_out[1], torch.zeros_like(ex.last_out[1]))


def test_a_narrow_config_keeps_the_decode_executors_layout():
    from repro_torch.serving.engine import DecodeTorchExecutor

    ex = DecodeTorchExecutor(get_config("hymba_1_5b").reduced(), max_batch=2, max_cache=8,
                             device="cpu")
    assert ex.prefix == 0 and ex._kc.shape[2] == 8 and ex._queries == [ex._q]


def test_the_tied_head_is_no_gemm_product(monkeypatch):
    """The tied table's transpose is a weight the GEMM kernel cannot address
    (its rows are strided), so the head takes the plain product and never
    reaches ``ops.matmul``; every product that does has a weight the kernel
    addresses."""
    from repro_torch.kernels import gemm

    cfg, _, model, params = _tiny()
    seen = []
    real = ops.matmul
    monkeypatch.setattr(ops, "matmul", lambda x, w: seen.append(w) or real(x, w))
    with torch.no_grad():
        logits = model.logits(params, {"tokens": torch.ones((1, 5), dtype=torch.int64)})
    assert logits.shape == (1, 5, cfg["vocab_size"])
    assert all(gemm.tma_rows(gemm.weight_2d(w)) for w in seen)
    assert (cfg["d_model"], cfg["vocab_size"]) not in [tuple(w.shape) for w in seen]
    assert len(seen) == 4 * 12 + 3 * 2  # 12 a layer, k and v on the three that compute them


def test_the_mamba_state_is_the_scans_last():
    g = torch.Generator().manual_seed(6)
    params = ssm.init_mamba(g, 16, 16, inner=32)
    x = torch.randn(1, 2, 16, generator=g)
    state: dict = {}
    with torch.no_grad():
        ssm.mamba_apply(params, x, state=state)
    assert state["h"].shape == (1, 32, 16)
    assert torch.equal(state["conv"][:, 0], torch.zeros(1, 32))  # two positions for three rows
    np.testing.assert_array_equal(state["conv"][:, 1:].numpy(), (x @ params["in_x"]).numpy())


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest -m cuda tests/test_torch_hymba.py` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full float32
    return torch.device("cuda")


def _scan_inputs(b, s, e, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, z = n(b, s, e), n(b, s, e)
    dt = torch.nn.functional.softplus(n(b, s, e) * 0.5 - 4.0)
    a_log = torch.log(torch.arange(1, 17, dtype=torch.float32, device=dev)) + 0.1 * n(e, 16)
    return x, dt, n(b, s, 16), n(b, s, 16), z, a_log, 1.0 + 0.1 * n(e)


def _torch_scan(x, dt, bm, cm, z, a_log, d_skip):
    """The model's torch route: the decays and drives, the doubling scan in
    chunks of 256, then C, D and the gate."""
    a = torch.exp(-torch.exp(a_log) * dt[..., None])
    drive = (dt * x)[..., None] * bm[:, :, None, :]
    h = ssm._mamba_scan(a, drive, torch.zeros_like(a[:, 0]), 256)
    y = (torch.einsum("bsen,bsn->bse", h, cm) + x * d_skip) * torch.nn.functional.silu(z)
    return y, h[:, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,e", [(1, 1, 64), (2, 37, 96), (3, 300, 200), (8, 65, 3200), (1, 2176, 3200),
                                   (4, 2176, 3200),  # Hymba-1.5B's largest served batch
                                   (8, 384, 3200), (8, 256, 1600)])  # its smallest bucket; the narrow preset
def test_selective_scan_kernel_matches_the_torch_scan(cuda_device, b, s, e):
    from repro_torch.kernels import selective_scan as scan_mod

    inputs = _scan_inputs(b, s, e, cuda_device)
    before = scan_mod.launches
    y, h = ops.selective_scan(*inputs, last_state=True)
    y2, none = ops.selective_scan(*inputs)
    torch.cuda.synchronize()
    assert scan_mod.launches == before + 2 and none is None
    assert torch.equal(y, y2)  # a fixed order: the same bits on two calls
    want_y, want_h = _torch_scan(*inputs)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_mamba_on_the_card_always_takes_the_kernel(cuda_device):
    """The route follows the device alone: a CUDA forward launches the scan
    kernel with and without a gradient, its gradients match the CPU's, and
    what the kernel does not take (bfloat16) is refused, not sent to the
    torch scan."""
    from repro_torch.kernels import selective_scan as scan_mod

    g = torch.Generator().manual_seed(7)
    params = ssm.init_mamba(g, 32, 16, dt_rank=4, inner=64)
    x = torch.randn(2, 50, 32, generator=g)
    grads = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in params.items()}
        xd = x.detach().clone().to(dev).requires_grad_(True)
        before = scan_mod.launches
        ssm.mamba_apply(p, xd, chunk=16).square().sum().backward()
        assert scan_mod.launches == before + (dev != "cpu")
        grads[str(dev)] = [t.grad.cpu() for t in (xd, p["in_x"], p["a_log"], p["w_dt_hi"])]
    for a, b in zip(grads["cpu"], grads["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    on_card = {k: v.to(cuda_device, torch.bfloat16) for k, v in params.items()}
    with torch.no_grad(), pytest.raises(TypeError):
        ssm.mamba_apply(on_card, x.to(cuda_device, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,kv,s,hd,dtype,window,prefix,lengths",
    [
        (2, 25, 5, 300, 64, torch.float32, 64, 0, None),
        (2, 25, 5, 300, 64, torch.float32, 64, 128, None),
        (1, 25, 5, 1300, 64, torch.float32, 1024, 128, None),  # Hymba's window and meta tokens
        (2, 25, 5, 600, 64, torch.float32, 100, 128, [600, 333]),
        (2, 8, 2, 200, 64, torch.bfloat16, 48, 16, None),
        (1, 4, 2, 160, 192, torch.float32, 32, 40, None),  # the mma.sync route
        (2, 4, 4, 90, 16, torch.float32, 8, 3, [90, 41]),
        (8, 25, 5, 256, 64, torch.float32, 1024, 0, None),  # Hymba's batch inside its window
        (1, 25, 5, 2048, 64, torch.float32, 1024, 0, None),  # past its window
        (1, 25, 5, 1100, 64, torch.float32, 1024, 0, [1100]),
        (4, 25, 5, 2176, 64, torch.float32, 1024, 128, None),  # Hymba-1.5B's largest served batch
        (2, 25, 5, 1300, 64, torch.float32, 1024, 128, [1300, 700]),
        (2, 24, 2, 77, 192, torch.bfloat16, 30, 0, [77, 40]),  # head size 192, group of 12, a window
    ],
)
def test_flash_prefix_matches_plain(cuda_device, b, h, kv, s, hd, dtype, window, prefix, lengths):
    from repro_torch.kernels import flash_attention as fa_mod

    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd)))
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = fa_mod.launches
    out = ops.flash_attention(q, k, v, lens, window=window, prefix=prefix)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, lengths=lens, window=window, prefix=prefix)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def _tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return [_tree_to(v, device) for v in tree]


@pytest.mark.cuda
def test_tiny_hymba_on_the_card_matches_the_cpu(cuda_device):
    """Every option on, a Mamba on the scan kernel (state 16): the forward
    over prompts past the window and a prefill then 20 decode steps,
    against the CPU on the same weights; a forward launches the scan and
    the flash kernel once a layer."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import selective_scan as scan_mod

    cfg, _, cpu, params = _tiny()
    card = Model(cpu.cfg, device=cuda_device)
    on_card = _tree_to(params, cuda_device)
    tokens = torch.randint(1, cfg["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(9))
    before = (scan_mod.launches, fa_mod.launches)
    with torch.no_grad():
        got = card.logits(on_card, {"tokens": tokens.to(cuda_device)})
        torch.cuda.synchronize()
        assert (scan_mod.launches, fa_mod.launches) == (before[0] + 4, before[1] + 4)
        torch.testing.assert_close(got.cpu(), cpu.logits(params, {"tokens": tokens}), rtol=1e-4, atol=1e-4)
        _, c_card = card.prefill(on_card, {"tokens": tokens[:, :12].to(cuda_device)}, 64, torch.float32)
        _, c_cpu = cpu.prefill(params, {"tokens": tokens[:, :12]}, 64, torch.float32)
        for j in range(12, 32):
            x = tokens[:, j : j + 1]
            a, c_card = card.decode_step(on_card, x.to(cuda_device), c_card, cfg["n_meta_tokens"] + j)
            b, c_cpu = cpu.decode_step(params, x, c_cpu, cfg["n_meta_tokens"] + j)
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_a_served_hymba_graph_counts_a_scan_a_layer_and_the_familys_products(cuda_device):
    """The benchmark's readers rest on these counts: each captured (k,
    bucket) graph of the tiny Hymba replays one scan a layer and one GEMM
    launch a product the family lists (none for the tied head, none for k
    and v on the layer that reuses them), and its replay equals an eager
    forward bit for bit."""
    import numpy as np

    from orloj_bench import families, harness
    from orloj_bench.weights import make_weights, port_params
    from repro_torch.serving.engine import EngineConfig, TorchServingEngine

    cfg = json.loads(TINY_FILE.read_text())
    w = make_weights(cfg, 5, cuda_device)
    ecfg = EngineConfig(buckets=(16, 32), batch_sizes=(1, 4), profile_reps=1)
    engine = TorchServingEngine(harness.model_config(cfg), ecfg, seed=5, device=cuda_device,
                                params=port_params(cfg, w))
    ex = engine.executor
    rng = np.random.default_rng(5)
    for shape in ((1, 16), (4, 32)):
        tokens = rng.integers(1, cfg["vocab_size"], size=shape)
        ex._run(tokens)
        program = ex._shapes[shape][1]
        assert program.launches["selective_scan"] == cfg["n_layers"]
        assert program.launches["gemm"] == len(families.of(cfg).gemm_products(cfg, *shape))
        with torch.no_grad():
            want = engine.model.logits(engine.params, {"tokens": torch.from_numpy(tokens).to(cuda_device)})
        torch.cuda.synchronize()
        assert torch.equal(ex.last_logits, want)


@pytest.mark.parametrize("b,s", [(1, 1), (1, 384), (1, 2176), (4, 2176), (8, 2176), (3, 300), (8, 33)])
def test_the_scan_plan_cuts_s_into_runs_of_whole_tiles(b, s):
    from repro_torch.kernels.selective_scan import MIN_RUN, STEPS, scan_plan

    run_len, chunks = scan_plan(b, s, 3200, 132)
    assert run_len % STEPS == 0 and chunks == -(-s // run_len) and (chunks - 1) * run_len < s
    assert chunks == 1 or run_len >= MIN_RUN
    assert chunks * b * 50 <= 4 * 132 + b * 50 * 2  # about four blocks an SM, not more


def test_runs_folded_by_their_summed_decay_are_the_sequential_scan():
    """The kernel's cut of S, emulated: each run but the last scanned from
    h = 0 (its last state, its Σ Δ), each run then scanned from the state
    folded over the runs before it, exp(A·Σ Δ)·h_in + h_last; y and the
    last state against the sequential scan."""
    x, dt, bm, cm, z, a_log, d_skip = _scan_inputs(2, 70, 8, "cpu", seed=4)
    want_y, want_h = ref.selective_scan_ref(x, dt, bm, cm, z, a_log, d_skip)
    a = -torch.exp(a_log)

    def scan(h, lo, hi):
        ys = []
        for t in range(lo, hi):
            h = torch.exp(a * dt[:, t, :, None]) * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None]
            ys.append((h * cm[:, t, None]).sum(-1) + d_skip * x[:, t])
        return h, torch.stack(ys, 1)

    runs = [(0, 32), (32, 64), (64, 70)]
    folded, h_in, ys = [], torch.zeros(2, 8, 16), []
    for lo, hi in runs[:-1]:
        h_last, _ = scan(torch.zeros(2, 8, 16), lo, hi)
        folded.append((h_last, dt[:, lo:hi].sum(1)))
    for c, (lo, hi) in enumerate(runs):
        h = torch.zeros(2, 8, 16)
        for h_last, s in folded[:c]:
            h = torch.exp(a * s[..., None]) * h + h_last
        h, y = scan(h, lo, hi)
        ys.append(y)
    y = torch.cat(ys, 1) * torch.nn.functional.silu(z)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-6)
