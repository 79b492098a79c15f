"""The host side of the backward kernels, on the CPU: the plans that
``flash_attention.py`` and ``rmsnorm.py`` hand to the CUDA launchers, and the
order in which the flash backward adds a split GQA group's dK/dV partials.

The plans are pure functions of the shapes (and of the multiprocessor
count, 132 on the H100), so they are checked here for every arch of
``configs.ARCHS`` at its training shapes.  The summation scheme is checked
in plain torch: per-head gradients of the plain version, added in the
kernel's order, equal the plain gradients of the shared K and V."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

SMS = 132
# (rows, seq) of each training shape: the production grid's, the training
# steps T1 (orloj_gpt (8, 256)) and T2 (GLM-4-9B (2, 1024)), and one row of 4096.
TRAIN_SHAPES = [(SHAPES["train_4k"].global_batch, SHAPES["train_4k"].seq_len), (8, 256), (2, 1024), (1, 4096)]
ATTENTION_ARCHS = [a for a in ARCHS if get_config(a).resolved_head_dim in fa.HEAD_DIMS]


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_flash_backward_splits_divide_the_group_and_size_the_scratch(arch):
    cfg = get_config(arch)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    group = h // kv
    for b, s in TRAIN_SHAPES:
        splits = fa.backward_splits(b, h, kv, s, hd, SMS)
        blocks = b * kv * -(-s // fa.KEY_ROWS[hd])
        assert group % splits == 0
        if group == 1 or blocks >= 2 * SMS:
            assert splits == 1
        else:  # the fewest blocks a group that reach two a multiprocessor, or one head a block
            assert blocks * splits >= 2 * SMS or splits == group
            assert all(blocks * d < 2 * SMS for d in _divisors(group) if d < splits)
        shape = fa.backward_scratch_shape(b, h, kv, s, hd, splits)
        nbytes = 4 * int(np.prod(shape))
        if splits == 1:
            assert shape == (0,) and nbytes == 0
        else:
            assert shape == (2, splits, b, kv, s, hd)
            assert nbytes == 2 * splits * b * kv * s * hd * 4


def test_flash_backward_plan_at_the_documented_shapes():
    """PERF.md's numbers: GLM-4-9B's T2 step splits its group of 16 into one
    head a block (32 → 512 dK/dV blocks) with 67,108,864 bytes of partials;
    orloj_gpt's MHA and the production train_4k shape take one split."""
    assert fa.backward_splits(2, 32, 2, 1024, 128, SMS) == 16
    assert 4 * np.prod(fa.backward_scratch_shape(2, 32, 2, 1024, 128, 16)) == 67_108_864
    assert fa.backward_splits(2, 56, 8, 256, 128, SMS) == 7  # Arctic: 32 blocks, a group of 7
    assert fa.backward_splits(8, 12, 12, 256, 64, SMS) == 1
    assert fa.backward_splits(256, 32, 2, 4096, 128, SMS) == 1
    assert fa.backward_splits(2, 32, 2, 1024, 128, 32) == 2  # the count follows the card


@pytest.mark.parametrize("group,kv", [(16, 1), (7, 2)])
def test_split_partials_added_in_order_equal_the_plain_gradients(group, kv):
    """For every split count the planner may pick (a divisor of the group):
    each split adds its heads' dK/dV in head order into a float32 partial,
    then the partials are added in split order, as the kernels do; that
    equals autograd's dK/dV through the plain version with shared K/V."""
    rng = np.random.default_rng(20)
    b, s, hd = 2, 24, 16
    h = group * kv
    q, dout = (torch.from_numpy(rng.standard_normal((b, h, s, hd), dtype=np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, kv, s, hd), dtype=np.float32)) for _ in range(2))
    lengths = torch.tensor([s, 17], dtype=torch.int32)

    def grads(kk, vv):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, kk, vv))
        ref.flash_attention_ref(qq, kk, vv, lengths=lengths).backward(dout)
        return kk.grad, vv.grad

    want_dk, want_dv = grads(k, v)
    # One query head a KV copy: the gradient each query head gives its KV head.
    head_dk, head_dv = grads(k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))
    for splits in _divisors(group):
        per = group // splits
        for head_grad, want in ((head_dk, want_dk), (head_dv, want_dv)):
            by_head = head_grad.reshape(b, kv, group, s, hd)
            partial = torch.zeros((splits, b, kv, s, hd))
            for sp, j in itertools.product(range(splits), range(per)):
                partial[sp] += by_head[:, :, sp * per + j]
            got = partial[0].clone()
            for sp in range(1, splits):
                got += partial[sp]
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _rmsnorm_widths() -> list[int]:
    widths = {get_config(a).d_model for a in ARCHS}
    widths |= {1, 3, 4, 8, 64, 127, 130, 1024, 1600, 4096, 7168, 8192, 8196, 16384, 16388, 32768,
               32772, rms.MAX_BACKWARD_D}
    return sorted(widths)


@pytest.mark.parametrize("element_size", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_backward_plan_covers_every_width_it_takes(element_size, aligned):
    for d, t in itertools.product(_rmsnorm_widths(), (1, 33, 2048, 256 * 4096)):
        p = rms.backward_plan(t, d, element_size, aligned, SMS)
        vec = 16 // element_size
        assert p.vec == (vec if aligned and d % vec == 0 else 1)
        assert 1 <= p.blocks <= 2 * SMS
        if p.vpt == 0:  # the rereading kernel: its shared memory holds a d-wide partial
            assert (p.team, p.teams) == (256, 1) and p.blocks == min(t, 2 * SMS)
            assert 256 * min(32, 8 * p.vec) < d <= rms.MAX_BACKWARD_D  # wider than 256 threads hold
            continue
        assert p.vpt in (1, 2, 4, 8) and p.vpt * p.vec <= 32  # x, dy and dscale in registers
        assert p.team % 32 == 0 and 32 <= p.team <= 256
        assert 1 <= p.teams <= 8 and p.team * p.teams <= (512 if p.vpt * p.vec <= 16 else 256)
        assert p.team * p.vpt * p.vec >= d  # the row lies in the team's registers
        assert p.team - 32 < -(-d // (p.vec * p.vpt))  # no idle warp
        assert p.blocks == min(-(-t // p.teams), 2 * SMS)
        smaller = p.vpt // 2
        if smaller:  # the fewest vectors a thread that keep the team within 256 threads
            assert 32 * -(-d // (p.vec * smaller * 32)) > 256


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rmsnorm_backward_plan_at_each_arch_width(arch):
    """Each arch's width at the T2 step's rows (2048), with 16-byte vectors
    in float32 and in bf16: held in registers up to 8192 columns (256 threads
    of 32); Nemotron-4-340B's 18432 takes the rereading kernel."""
    d = get_config(arch).d_model
    for element_size in (4, 2):
        p = rms.backward_plan(2048, d, element_size, True, SMS)
        assert p.vec == (16 // element_size if d % (16 // element_size) == 0 else 1)
        if d <= 8192:
            assert p.vpt > 0 and p.team * p.vpt * p.vec >= d
        else:
            assert p.vpt == 0 and arch == "nemotron_4_340b"


def test_rmsnorm_backward_plan_at_the_documented_shape():
    """PERF.md's numbers at GLM-4-9B's (2048, 4096) float32: two teams of 256
    threads a block, 4 float4 vectors a thread, 264 partial rows."""
    assert rms.backward_plan(2048, 4096, 4, True, SMS) == rms.BackwardPlan(4, 4, 256, 2, 264)
    assert rms.backward_plan(2048, 4096, 2, True, SMS) == rms.BackwardPlan(8, 2, 256, 2, 264)
    assert rms.backward_plan(4, rms.MAX_BACKWARD_D, 4, True, SMS).vpt == 0
