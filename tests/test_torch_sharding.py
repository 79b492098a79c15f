"""The port's sharding rules against the reference's, leaf by leaf, and
their placement as DTensors, on the CPU.

The reference's specs come from ``jax.eval_shape`` of its ``Model.init``
and ``init_cache`` and its ``param_specs``/``cache_specs``/
``input_batch_specs``, given a stand-in mesh that has only a ``shape``
mapping (no devices); the port's come from its own rules over its own
trees (meta tensors of the same shapes), on the same stand-in.  The port
keeps a per-layer list where the reference scans a stacked unit, so layer
i's spec is the reference's for its unit entry without the leading
``None``; the port's KV caches are (B, KV, S, hd) where the reference's
are (B, S, KV, hd), so their specs are the reference's permuted.

Placement runs on fake process groups (no devices, no communication):
``to_placements`` for tuple axes, and ``place`` giving each rank its own
slice of a tensor with data and an empty meta shard of a tensor without.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import for_shape as jfor_shape  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch.dryrun import input_specs as jinput_specs  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, for_shape, get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    destroy_fake_world,
    make_fake_mesh,
    make_production_mesh,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import sharding as sh  # noqa: E402
from repro_torch.models.convert import scan_unit  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
}


def _mesh(name):
    return types.SimpleNamespace(shape=MESHES[name])


@pytest.fixture
def fake_world():
    yield
    destroy_fake_world()


def _path(p) -> str:
    return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in p)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {_path(p): tuple(s) for p, s in flat}


def _port_flat(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, (*prefix, str(k))))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, (*prefix, str(i))))
        return out
    return {"/".join(prefix): tuple(tree)}


@functools.cache
def _ref_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(JaxModel(cfg).init, jax.random.PRNGKey(0))


@functools.cache
def _port_params(arch):
    return dryrun.param_shapes(Model(get_config(arch), device="cpu"))


def _compare(port: dict, ref: dict, cfg, cache: bool = False) -> None:
    """Each of the port's specs equals the reference's for the same leaf,
    and every reference leaf has a counterpart.  A leaf of the layer stack
    (``blocks/i/...``, or a cache's ``i/...``) is layer i, which the
    reference keeps at its unit entry ``i % unit`` behind a scanned axis;
    with ``cache``, a KV spec is the reference's permuted from (B, S, KV,
    hd) to (B, KV, S, hd)."""
    unit = scan_unit(cfg)
    hit = set()
    for key, spec in port.items():
        parts = key.split("/")
        at = 0 if cache else (1 if parts[0] == "blocks" else None)
        scanned = at is not None and bool(unit)
        if scanned:
            parts[at] = str(int(parts[at]) % unit)
        rkey = "/".join(parts)
        want = ref[rkey]
        if scanned:
            assert want[0] is None, (rkey, want)
            want = want[1:]
        want = tuple(want) + (None,) * (len(spec) - len(want))
        if cache and parts[-1] in ("k", "v"):
            want = (want[0], want[2], want[1], want[3])
        assert spec == want, (key, spec, want)
        hit.add(rkey)
    assert hit == set(ref), set(ref) ^ hit


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    """Every parameter leaf's spec at full width, with and without the
    serving-time expert FFN axis."""
    cfg = get_config(arch)
    for ff_axis in (None, "data"):
        want = _ref_flat(jsh.param_specs(jget_config(arch), _ref_params(arch), _mesh(mesh),
                                         moe_ff_axis=ff_axis))
        got = _port_flat(sh.param_specs(cfg, _port_params(arch), _mesh(mesh), moe_ff_axis=ff_axis))
        _compare(got, want, cfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    """The batch specs of every shape's inputs, and the decode caches' at
    both decode shapes, with the cache sequence-sharded over ``data`` and
    ``model`` and not: the KV caches' the reference's permuted to (B, KV,
    S, hd)."""
    for name, shape in SHAPES.items():
        cfg = for_shape(get_config(arch), shape)
        jcfg = jfor_shape(jget_config(arch), JSHAPES[name])
        jins = jinput_specs(jcfg, JSHAPES[name], JaxModel(jcfg))
        ins = dryrun.input_specs(cfg, shape, Model(cfg, device="cpu"))
        b = shape.global_batch
        if shape.kind != "decode":
            want = _ref_flat(jsh.input_batch_specs(jcfg, _mesh(mesh), jins["batch"], b))
            got = _port_flat(sh.input_batch_specs(cfg, _mesh(mesh), ins["batch"], b))
            assert got == want, name
            continue
        want = _ref_flat(jsh.input_batch_specs(jcfg, _mesh(mesh), {"t": jins["tokens"]}, b))
        assert _port_flat(sh.input_batch_specs(cfg, _mesh(mesh), {"t": ins["tokens"]}, b)) == want
        for seq_shard, axis in ((False, "data"), (True, "data"), (True, "model")):
            want = _ref_flat(jsh.cache_specs(jcfg, _mesh(mesh), jins["cache"], b, seq_shard, axis))
            got = _port_flat(sh.cache_specs(cfg, _mesh(mesh), ins["cache"], b, seq_shard, axis))
            _compare(got, want, cfg, cache=True)


def test_kv_cache_spec_is_the_reference_permuted():
    """GLM-4-9B's ``long_500k`` cache, sequence-sharded: the reference
    shards its (B, S, KV, hd) cache's axis 1, the port its (B, KV, S, hd)
    cache's axis 2; batch-sharded at ``decode_32k``, the KV heads (2 of
    them) do not divide ``model`` and only the batch is sharded."""
    mesh = _mesh("16x16")
    cfg = for_shape(get_config("glm4_9b"), SHAPES["long_500k"])
    cache = dryrun.input_specs(cfg, SHAPES["long_500k"], Model(cfg, device="cpu"))["cache"]
    assert tuple(cache[0]["kv"]["k"].shape) == (1, 2, 8192, 128)
    spec = sh.cache_specs(cfg, mesh, cache, 1, seq_shard=True)[0]["kv"]["k"]
    assert spec == sh.Spec(None, None, "data", None)
    jcfg = jfor_shape(jget_config("glm4_9b"), JSHAPES["long_500k"])
    jcache = jinput_specs(jcfg, JSHAPES["long_500k"], JaxModel(jcfg))["cache"]
    assert tuple(jsh.cache_specs(jcfg, mesh, jcache, 1, True)[0]["kv"]["k"]) == (
        None, None, "data", None, None)  # the scanned axis, then (B, S, KV, hd)
    spec = sh.cache_specs(cfg, _mesh("2x16x16"), cache, 128, seq_shard=False)[0]["kv"]["k"]
    assert spec == sh.Spec(("pod", "data"), None, None, None)


def test_to_placements_maps_tuple_axes_in_mesh_order(fake_world):
    mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
    assert sh.to_placements(mesh, sh.Spec(("pod", "data"), None, "model")) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements(mesh, sh.Spec(None, "data")) == [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        sh.to_placements(mesh, sh.Spec(("data", "pod")))


def test_place_gives_each_rank_its_own_shard(fake_world):
    """Rank 5 of a (pod 2, data 2, model 2) mesh sits at (1, 0, 1): a tensor
    with data gives it its slice, a meta tensor an empty meta shard of the
    local shape; both carry the global shape."""
    mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu", rank=5)
    assert tuple(mesh.get_coordinate()) == (1, 0, 1)
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    tree = {"a": full, "b": [torch.empty((8, 6, 4), device="meta")]}
    specs = {"a": sh.Spec(("pod", "data"), "model"), "b": [sh.Spec("model", None, "data")]}
    out = sh.place(tree, mesh, specs)
    a, b = out["a"], out["b"][0]
    assert isinstance(a, DTensor) and a.shape == (8, 6)
    assert a.placements == (Shard(0), Shard(0), Shard(1))
    torch.testing.assert_close(a.to_local(), full[4:6, 3:6])  # pod·2 + data = 2 of 4 row blocks
    assert b.to_local().device.type == "meta" and tuple(b.to_local().shape) == (4, 6, 2)
    assert b.shape == (8, 6, 4)


def test_production_meshes(fake_world):
    for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi)
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
        assert mesh.device_type == "cuda"


def test_train_iterator_places_batches_as_the_reference(fake_world):
    """The corpus's batches on a (2, 4) mesh: the reference's batch spec
    (rows over ``data``), rank 6 (data 1) holding rows 4..7 of the batch
    the reference's iterator yields."""
    mesh = make_fake_mesh((2, 4), ("data", "model"), device_type="cpu", rank=6)
    kw = dict(vocab_size=64, seq_len=16, batch_size=8)
    got = next(tpipe.make_train_iterator(tpipe.DataConfig(**kw), mesh=mesh))
    want = next(jpipe.make_train_iterator(jpipe.DataConfig(**kw)))
    spec = jsh.input_batch_specs(None, _mesh("2x4"), {"tokens": want["tokens"]}, 8)["tokens"]
    for k in ("tokens", "labels"):
        assert got[k].placements == tuple(sh.to_placements(mesh, sh.Spec(*spec)))
        assert got[k].shape == (8, 16)
        np.testing.assert_array_equal(got[k].to_local().numpy(), np.asarray(want[k])[4:8])


def test_restore_checkpoint_places_leaves_by_the_reference_specs(tmp_path, fake_world):
    """A checkpoint of plain tensors restores onto a (2, 4) mesh: every
    leaf's placements are the reference's spec for it, and rank 3 (data 0,
    model 3) holds its slice of the saved values."""
    cfg = get_config("glm4_9b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path, 3, params, cfg)
    mesh = make_fake_mesh((2, 4), ("data", "model"), device_type="cpu", rank=3)
    specs = sh.param_specs(cfg, params, mesh)
    got = restore_checkpoint(tmp_path, 3, params, cfg, shardings=specs, mesh=mesh)
    jcfg = jget_config("glm4_9b").reduced()
    want_specs = _ref_flat(jsh.param_specs(jcfg, jax.eval_shape(JaxModel(jcfg).init,
                                                                jax.random.PRNGKey(0)),
                                           _mesh("2x4")))
    _compare(_port_flat(specs), want_specs, cfg)
    flat_got, flat_want = {}, {}

    def walk(t, w, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], w[k], (*path, k))
        elif isinstance(t, list):
            for i, (a, b) in enumerate(zip(t, w)):
                walk(a, b, (*path, str(i)))
        else:
            flat_got[path], flat_want[path] = t, w

    walk(got, params)
    assert flat_got
    for path, t in flat_got.items():
        spec = _port_flat(specs)["/".join(path)]
        assert t.placements == tuple(sh.to_placements(mesh, sh.Spec(*spec)))
        _, slices = sh._local_slices(tuple(t.shape), mesh, list(t.placements))
        torch.testing.assert_close(t.to_local(), flat_want[path][tuple(slices)], rtol=0, atol=0)


# (arch, overrides of its .reduced()): GLM-4 with 2 KV heads (heads sharded
# over model) and with 1 (the head size sharded instead), Arctic with 4
# experts (its dispatch's partial sums), Hymba, OLMo (a tied embedding),
# xLSTM (the mLSTM's chunks and cell shard by shard).
GLOO_ARCHS = {"glm4_9b": ("glm4_9b", {}), "glm4_9b_mqa": ("glm4_9b", {"n_kv_heads": 1}),
              "arctic_480b": ("arctic_480b", {"n_experts": 4}), "hymba_1_5b": ("hymba_1_5b", {}),
              "olmo_1b": ("olmo_1b", {}), "xlstm_1_3b": ("xlstm_1_3b", {})}


def _gloo_rank(rank: int, port: int, results) -> None:
    """One of four CPU processes (a gloo group, a (data 2, model 2) mesh):
    each arch's loss, gradients and five decode steps (cache batch-sharded,
    then sequence-sharded) on DTensors placed by the port's specs, against
    the same on plain tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.optim.adamw import leaves

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for key, (arch, over) in GLOO_ARCHS.items():
        cfg = get_config(arch).reduced(**over)
        model = Model(cfg, device="cpu")
        params = model.init(torch.Generator().manual_seed(4))
        for t in leaves(params):
            t.requires_grad_(True)
        rng = np.random.default_rng(4)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 32)))
                 for k in ("tokens", "labels")}
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves(params))
        dparams = sh.place(params, mesh, sh.param_specs(cfg, params, mesh))
        dbatch = sh.place(batch, mesh, sh.input_batch_specs(cfg, mesh, batch, 4))
        with implicit_replication():
            dloss = model.loss(dparams, dbatch)
            dgrads = [g.full_tensor() for g in torch.autograd.grad(dloss, leaves(dparams))]
        grad_err = max(((a - b).abs().max() / a.abs().max().clamp_min(1)).item()
                       for a, b in zip(grads, dgrads))
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 5)))
        decode_err = 0.0
        with torch.no_grad():
            for seq_shard in (False, True):
                cache = model.init_cache(4, 8)
                want = [model.decode_step(params, toks[:, i:i + 1], cache, i)[0] for i in range(5)]
                cache = model.init_cache(4, 8)
                dcache = sh.place(cache, mesh, sh.cache_specs(cfg, mesh, cache, 4, seq_shard))
                with implicit_replication():
                    for i in range(5):
                        tok = {"t": toks[:, i:i + 1]}
                        tok = sh.place(tok, mesh, sh.input_batch_specs(cfg, mesh, tok, 4))["t"]
                        got = model.decode_step(dparams, tok, dcache, i)[0].full_tensor()
                        decode_err = max(decode_err, ((got - want[i]).abs().max()
                                                      / want[i].abs().max()).item())
        out[key] = (loss.item(), dloss.detach().full_tensor().item(), grad_err, decode_err)
    if rank == 0:
        results.put(out)
    dist.destroy_process_group()


def test_dtensor_steps_match_plain_across_four_processes():
    """Four CPU processes hold one (2, 2) mesh for real (a gloo group): the
    vocabulary-sharded embedding and loss, the MoE dispatch's partial sums,
    the head-sharded projections and the cache writes (into the shard that
    holds the slot, for a sequence-sharded cache) give the plain tensors'
    loss to 1e-6 relative, every gradient to 1e-6 of its leaf's largest and
    the decode logits to 1e-4 of the largest (float32 sums in other
    orders)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    mp.start_processes(_gloo_rank, args=(port, results), nprocs=4, start_method="spawn")
    got = results.get()
    assert set(got) == set(GLOO_ARCHS)
    for arch, (loss, dloss, grad_err, decode_err) in got.items():
        assert abs(loss - dloss) <= 1e-6 * abs(loss), arch
        assert grad_err <= 1e-6 and decode_err <= 1e-4, (arch, grad_err, decode_err)
