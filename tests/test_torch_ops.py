"""The kernels as ``torch.library`` operators, on the CPU.

Each operator's fake implementation gives the outputs' shapes and types of
its plain version (the backwards': autograd through the plain forward);
and each DTensor sharding rule's local result is the plain version applied
shard by shard.  For the rules, inputs are DTensors with meta shards on a
fake (data 2, model 4) mesh, this process being rank 5 at (1, 1): the
operator's output placements are the rule's, and the plain version on
rank 5's slices of seeded inputs equals rank 5's slice of the plain
version on the whole inputs (a ``Partial`` output: the shards' sum equals
the whole).  The CUDA implementations are held against the plain versions
on the card (``test_torch_cuda.py``, with ``torch.library.opcheck``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import destroy_fake_world, make_fake_mesh  # noqa: E402
from repro_torch.models import sharding as sh  # noqa: E402

R = Replicate()
OPS = torch.ops.repro_torch


@pytest.fixture
def mesh():
    m = make_fake_mesh((2, 4), ("data", "model"), rank=5)
    assert tuple(m.get_coordinate()) == (1, 1)
    yield m
    destroy_fake_world()


def _rand(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _plain_grads(fn, inputs, douts):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    return torch.autograd.grad([o for o, _ in pairs], ins, [d for _, d in pairs])


def _cases(rng):
    """(name, the operator's arguments, the plain version's outputs) on CPU
    tensors."""
    q, k, v = _rand(rng, (2, 4, 16, 32)), _rand(rng, (2, 2, 16, 32)), _rand(rng, (2, 2, 16, 32))
    lengths = torch.tensor([16, 9], dtype=torch.int32)
    out = ref.flash_attention_ref(q, k, v, lengths=lengths)
    dout = _rand(rng, out.shape)
    dq, dk, dv = _plain_grads(lambda a, b, c: ref.flash_attention_ref(a, b, c, lengths=lengths),
                              (q, k, v), (dout,))
    lse = torch.zeros((2, 4, 16))
    qd, kc, vc = _rand(rng, (2, 4, 32)), _rand(rng, (2, 2, 16, 32)), _rand(rng, (2, 2, 16, 32))
    vl = torch.tensor([16, 5], dtype=torch.int32)
    x, scale = _rand(rng, (3, 5, 32), torch.bfloat16), _rand(rng, (32,))
    dy = _rand(rng, x.shape, torch.bfloat16)
    dx, dscale = _plain_grads(lambda a, w: ref.rmsnorm_ref(a.reshape(-1, 32), w, 1e-5).reshape(a.shape),
                              (x, scale), (dy,))
    logits = _rand(rng, (6, 16))
    gates, ids = ref.moe_gating_ref(logits, 3)
    dgates = _rand(rng, gates.shape)
    (dlogits,) = _plain_grads(lambda a: ref.moe_gating_ref(a, 3), (logits,), (dgates, None))
    return [
        ("flash_attention", (q, k, v, lengths, True, 0, 0.0, True), (out, lse)),
        ("flash_attention_bwd", (q, k, v, out, dout, lse, lengths, True, 0, 0.0), (dq, dk, dv)),
        ("decode_attention", (qd, kc.bfloat16(), vc.bfloat16(), vl, 0.0),
         (ref.decode_attention_ref(qd, kc.bfloat16(), vc.bfloat16(), vl),)),
        ("rmsnorm", (x, scale, 1e-5), (ref.rmsnorm_ref(x.reshape(-1, 32), scale, 1e-5).reshape(x.shape),)),
        ("rmsnorm_bwd", (x, scale, dy, 1e-5), (dx, dscale)),
        ("moe_gating", (logits, 3), (gates, ids)),
        ("moe_gating_bwd", (logits, ids, dgates), (dlogits,)),
    ]


@pytest.mark.parametrize("i", range(7))
def test_fake_implementations_give_the_plain_shapes_and_types(i):
    name, args, plain = _cases(np.random.default_rng(0))[i]
    meta = [_meta(a) if isinstance(a, torch.Tensor) else a for a in args]
    got = getattr(OPS, name)(*meta)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(plain)
    for g, p in zip(got, plain):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(p.shape), p.dtype), name
    if name == "flash_attention":  # without its LSE (no_grad): (B, H, 0)
        _, lse = OPS.flash_attention(*meta[:-1], False)
        assert tuple(lse.shape) == (2, 4, 0)


def _dt(t, mesh, placements):
    """``t`` as a DTensor of meta shards placed so."""
    shape, _ = sh._local_slices(tuple(t.shape), mesh, placements)
    return DTensor.from_local(torch.empty(shape, dtype=t.dtype, device="meta"), mesh, placements,
                              run_check=False, shape=t.shape, stride=t.stride())


def _mine(t, mesh, placements):
    """This rank's slice of ``t`` under ``placements``."""
    _, slices = sh._local_slices(tuple(t.shape), mesh, placements)
    return t[tuple(slices)]


S0, S1 = Shard(0), Shard(1)
BH = [S0, S1]  # batch over data, heads over model
ROWS = [S0, R]


def _check_rule(mesh, op, args, in_pl, out_pl, plain):
    """The operator on DTensors placed by ``in_pl`` gives outputs placed by
    ``out_pl`` at their local shapes, and ``plain`` on this rank's slices
    equals this rank's slice of ``plain`` on the whole."""
    dargs = [_dt(a, mesh, p) if p is not None else a for a, p in zip(args, in_pl)]
    got = op(*dargs)
    got = got if isinstance(got, tuple) else (got,)
    whole = plain(*args)
    whole = whole if isinstance(whole, tuple) else (whole,)
    mine = plain(*[_mine(a, mesh, p) if p is not None else a for a, p in zip(args, in_pl)])
    mine = mine if isinstance(mine, tuple) else (mine,)
    for g, pl, w, m in zip(got, out_pl, whole, mine):
        assert tuple(g.placements) == tuple(pl)
        assert tuple(g.to_local().shape) == tuple(m.shape)
        if any(isinstance(p, Partial) for p in pl):
            continue  # checked by the caller: the shards' sum
        torch.testing.assert_close(m, _mine(w, mesh, pl), rtol=1e-5, atol=1e-5)


def test_attention_rules_shard_the_batch_and_the_heads(mesh):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, (4, 8, 16, 32)), _rand(rng, (4, 4, 16, 32)), _rand(rng, (4, 4, 16, 32))
    lengths = torch.tensor([16, 9, 1, 12], dtype=torch.int32)

    def flash(a, b, c, n):
        return ref.flash_attention_ref(a, b, c, lengths=n)

    _check_rule(mesh, lambda a, b, c, n: ops.flash_attention(a, b, c, n), (q, k, v, lengths),
                [BH, BH, BH, ROWS], [BH], flash)
    out = flash(q, k, v, lengths)
    dout = _rand(rng, out.shape)

    def flash_bwd(a, b, c, o, do, lse, n):
        return _plain_grads(lambda x, y, z: flash(x, y, z, n), (a, b, c), (do,))

    lse = torch.zeros((4, 8, 16))
    _check_rule(mesh, lambda *t: OPS.flash_attention_bwd(*t, True, 0, 0.0),
                (q, k, v, out, dout, lse, lengths), [BH] * 6 + [ROWS], [BH] * 3, flash_bwd)
    qd = _rand(rng, (4, 8, 32))
    kc, vc = _rand(rng, (4, 4, 16, 32)), _rand(rng, (4, 4, 16, 32))
    vl = torch.tensor([16, 5, 0, 3], dtype=torch.int32)
    _check_rule(mesh, lambda a, b, c, n: ops.decode_attention(a, b, c, n), (qd, kc, vc, vl),
                [BH, BH, BH, ROWS], [BH], ref.decode_attention_ref)


def test_attention_rule_keeps_gqa_heads_together(mesh):
    """Two KV heads do not divide the four ``model`` shards: a query shard
    would lose its KV heads, so the heads are not sharded (here nothing
    over ``model`` is: the batch of 2 does not divide it either)."""
    rng = np.random.default_rng(2)
    q, k = _rand(rng, (2, 8, 16, 32)), _rand(rng, (2, 2, 16, 32))
    out = ops.flash_attention(_dt(q, mesh, BH), _dt(k, mesh, ROWS), _dt(k, mesh, ROWS))
    assert tuple(out.placements) == (S0, R)


def test_row_rules_follow_their_input(mesh):
    """RMSNorm (of any rank) and the gates shard the rows their input is
    sharded over, and no more; RMSNorm's backward gives the scale's
    gradient as a partial sum over the row shards."""
    rng = np.random.default_rng(3)
    x, scale = _rand(rng, (4, 6, 32)), _rand(rng, (32,))

    def norm(a, w):
        return ref.rmsnorm_ref(a.reshape(-1, 32), w, 1e-5).reshape(a.shape)

    _check_rule(mesh, lambda a, w: ops.rmsnorm(a, w, eps=1e-5), (x, scale), [ROWS, [R, R]], [ROWS],
                norm)
    dy = _rand(rng, x.shape)

    def norm_bwd(a, w, d):
        return _plain_grads(norm, (a, w), (d,))

    _check_rule(mesh, lambda *t: OPS.rmsnorm_bwd(*t, 1e-5), (x, scale, dy),
                [ROWS, [R, R], ROWS], [ROWS, [Partial(), R]], norm_bwd)
    halves = [norm_bwd(x[i:i + 2], scale, dy[i:i + 2])[1] for i in (0, 2)]
    torch.testing.assert_close(halves[0] + halves[1], norm_bwd(x, scale, dy)[1], rtol=1e-5, atol=1e-5)
    logits = _rand(rng, (8, 16))
    _check_rule(mesh, lambda a: ops.moe_gating(a, 3), (logits,), [ROWS], [ROWS, ROWS],
                lambda a: ref.moe_gating_ref(a, 3))
    gates, ids = ref.moe_gating_ref(logits, 3)
    dgates = _rand(rng, gates.shape)

    def gating_bwd(a, i, d):
        return _plain_grads(lambda t: ref.moe_gating_ref(t, 3), (a,), (d, None))

    _check_rule(mesh, OPS.moe_gating_bwd, (logits, ids, dgates), [ROWS] * 3, [ROWS], gating_bwd)
    # A row-sharded input stays so; a replicated one is not sliced over model.
    y = ops.rmsnorm(_dt(x, mesh, [R, R]), _dt(scale, mesh, [R, R]), eps=1e-5)
    assert tuple(y.placements) == (R, R)
