"""The port's dry-run on the CPU: steps on DTensors whose shards are meta
tensors, on fake process groups (no devices, no communication).

The reference's lowering cases (``test_sharding_lowering.py``: train for
five archs, decode for three, reduced, on a (2, 4) mesh) run through
:func:`repro_torch.launch.dryrun.dry_run` and must come out ``ok`` with
FLOPs above 0; ``input_specs`` covers every (arch × shape) as the
reference's does; the collective bytes of a column- then row-parallel
product are checked by hand; and on a (1, 1) mesh the per-device FLOPs
equal ``FlopCounterMode`` over the same step on plain meta tensors.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, InputShape, for_shape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import destroy_fake_world, make_fake_mesh  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.sharding import Spec, place  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

SMOKE = {"train": InputShape("smoke_train", "train", 64, 4),
         "prefill": InputShape("smoke_prefill", "prefill", 64, 4),
         "decode": InputShape("smoke_decode", "decode", 64, 4)}


@pytest.fixture
def fake_world():
    yield
    destroy_fake_world()


def _ok(res):
    assert res.ok, res.error
    assert res.flops > 0
    mem = res.per_device_memory
    assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"] > 0
    assert res.fits and res.flops_corrected == res.flops and not res.scanned


@pytest.mark.parametrize("arch", ["glm4_9b", "dbrx_132b", "hymba_1_5b", "xlstm_1_3b", "internvl2_1b"])
def test_train_on_a_2x4_mesh(arch, fake_world):
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    res, _ = dryrun.dry_run(get_config(arch).reduced(), SMOKE["train"], mesh, arch=arch)
    _ok(res)
    assert res.mesh == "2x4" and res.collective_bytes


@pytest.mark.parametrize("arch", ["glm4_9b", "arctic_480b", "musicgen_large"])
def test_decode_on_a_2x4_mesh(arch, fake_world):
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    res, _ = dryrun.dry_run(get_config(arch).reduced(), SMOKE["decode"], mesh, arch=arch)
    _ok(res)


def test_input_specs_cover_all_combinations():
    """Every (arch × shape) yields well-formed meta stand-ins."""
    for arch in ARCHS:
        for shape in SHAPES.values():
            cfg = for_shape(get_config(arch), shape)
            ins = dryrun.input_specs(cfg, shape, Model(cfg, device="cpu"))
            if shape.kind in ("train", "prefill"):
                batch = ins["batch"]
                total = 0
                if "tokens" in batch:
                    assert batch["tokens"].dtype == torch.int32
                    total += batch["tokens"].shape[1]
                if "frontend_embeds" in batch:
                    fe = batch["frontend_embeds"]
                    assert fe.shape[0] == shape.global_batch
                    total = total + fe.shape[1] if cfg.frontend == "vision" else fe.shape[1]
                assert total == shape.seq_len, (arch, shape.name)
                if shape.kind == "train":
                    assert tuple(batch["labels"].shape) == (shape.global_batch, shape.seq_len)
                assert all(t.device.type == "meta" for t in batch.values())
            else:
                assert ins["pos"].shape == ()
                assert len(ins["cache"]) == cfg.n_layers
                for layer in ins["cache"]:
                    if "kv" in layer:
                        s = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
                        assert tuple(layer["kv"]["k"].shape[::2]) == (shape.global_batch, s)
                        assert layer["kv"]["k"].dtype == torch.bfloat16


def test_collective_bytes_of_a_column_then_row_parallel_product(fake_world):
    """x (8, 16) rows over ``data``; w1 (16, 32) columns over ``model``; w2
    (32, 16) rows over ``model``.  Each card computes (4, 16) @ (16, 8) and
    (4, 8) @ (8, 16), a partial sum that one all-reduce over ``model`` of
    its (4, 16) float32 result completes: 256 bytes, 2048 FLOPs."""
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    shapes = {"x": (8, 16), "w1": (16, 32), "w2": (32, 16)}
    t = place({k: torch.empty(v, device="meta") for k, v in shapes.items()}, mesh,
              {"x": Spec("data", None), "w1": Spec(None, "model"), "w2": Spec("model", None)})
    with dryrun.DeviceCounter(t) as c:
        y = (t["x"] @ t["w1"]) @ t["w2"]
        y = y.redistribute(mesh, [Shard(0), Replicate()])
    assert c.collective_bytes == {"all-reduce": 4 * 16 * 4}
    assert c.flops == 2 * 4 * 16 * 8 + 2 * 4 * 8 * 16
    assert tuple(y.to_local().shape) == (4, 16)
    assert [k for k, *_ in c.collectives] == ["all-reduce"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_on_one_device_equal_the_flop_counter(kind, fake_world):
    """On a (1, 1) mesh a card does the whole step: the dry-run's FLOPs
    equal ``FlopCounterMode`` over the same step on plain meta tensors (the
    attention kernels counted by their own formulas)."""
    cfg = get_config("glm4_9b").reduced()
    shape = SMOKE[kind]
    res, _ = dryrun.dry_run(cfg, shape, make_fake_mesh((1, 1), ("data", "model")))
    _ok(res)
    model = Model(cfg, device="cpu")
    params = dryrun.param_shapes(model)
    ins = dryrun.input_specs(cfg, shape, model)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            for p in leaves(params):
                p.requires_grad_(True)
            make_train_step(model, AdamWConfig())(params, adamw_init(params), ins["batch"])
        elif kind == "prefill":
            with torch.no_grad():
                model.prefill(params, ins["batch"], cache_len=shape.seq_len)
        else:
            with torch.no_grad():
                model.decode_step(params, ins["tokens"], ins["cache"], ins["pos"])
    counts = fc.get_flop_counts()["Global"]
    assert res.flops == fc.get_total_flops()
    attention = "flash_attention" if kind != "decode" else "decode_attention"
    assert counts[getattr(torch.ops.repro_torch, attention)] > 0


def test_cli_writes_one_result_per_combination(tmp_path, monkeypatch, fake_world, capsys):
    """``main`` on one arch and shape over the 16×16 production mesh."""
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    got = dryrun.main(["--arch", "olmo_1b", "--shape", "long_500k", "--mesh", "single",
                       "--keep-collectives"])
    assert len(got) == 1 and got[0].ok and got[0].mesh == "16x16"
    saved = json.loads((tmp_path / "olmo_1b_long_500k_16x16.json").read_text())
    assert saved["ok"] and saved["flops"] == got[0].flops
    assert (tmp_path / "olmo_1b_long_500k_16x16.collectives.txt").exists()
    assert "1/1 dry-runs OK" in capsys.readouterr().out
