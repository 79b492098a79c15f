"""The port's checkpoints against the JAX reference's, on the CPU: the same
``step_%08d.npz`` files with the same ``§``-joined keys and the reference's
stacked layout, so that each package restores the other's files bit for
bit.  Three layer stacks: unrolled (orloj_gpt), GLM-4's scanned stack (units
of one block) and xLSTM's scanned units of ``slstm_every`` blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.convert import from_numpy, scan_unit, to_numpy  # noqa: E402

STACKS = {
    "unrolled": lambda: get_config("orloj_gpt").reduced(),
    "glm4 scanned": lambda: get_config("glm4_9b").reduced(scan_layers=True, n_layers=3),
    "xlstm units": lambda: get_config("xlstm_1_3b").reduced(scan_layers=True, n_layers=4),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _port_params(cfg, seed):
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(seed))


def test_the_stacks_are_what_their_names_say():
    assert [scan_unit(STACKS[k]()) for k in STACKS] == [0, 1, 2]


@pytest.mark.parametrize("stack", list(STACKS))
def test_a_jax_checkpoint_restores_bit_equal_into_the_port(tmp_path, stack):
    cfg = STACKS[stack]()
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(3))
    jck.save_checkpoint(tmp_path, 7, jparams)
    like = _port_params(cfg, 0)
    got = tck.restore_checkpoint(tmp_path, 7, like, cfg)
    want = from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    pairs = list(zip(_leaves(got), _leaves(want), strict=True))
    assert len(pairs) > 5
    for (path, g), (_, w) in pairs:
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert len(got["blocks"]) == cfg.n_layers


@pytest.mark.parametrize("stack", list(STACKS))
def test_a_port_checkpoint_restores_bit_equal_through_the_reference(tmp_path, stack):
    cfg = STACKS[stack]()
    params = _port_params(cfg, 4)
    path = tck.save_checkpoint(tmp_path, 12, params, cfg)
    assert path.name == "step_00000012.npz" and (tmp_path / "treedef.json").exists()
    with np.load(path) as data:
        keys = set(data.files)
    unit = scan_unit(cfg)
    if unit:  # the reference's stacked layout: (n_units, ...) under blocks§i
        assert np.load(path)["blocks§0§norm1§scale"].shape == (cfg.n_layers // unit, cfg.d_model)
        assert f"blocks§{unit}§norm1§scale" not in keys
    else:
        assert f"blocks§{cfg.n_layers - 1}§norm1§scale" in keys
    like = jax.eval_shape(lambda: JaxModel(cfg).init(jax.random.PRNGKey(0)))
    got = jax.tree.map(np.asarray, jck.restore_checkpoint(tmp_path, 12, like))
    want = to_numpy(params, cfg)
    for (p, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), p
    # and back into the port, unchanged
    back = tck.restore_checkpoint(tmp_path, 12, _port_params(cfg, 5), cfg)
    for (p, g), (_, w) in zip(_leaves(back), _leaves(params), strict=True):
        assert torch.equal(g, w), p


def test_restore_raises_on_a_shape_mismatch_and_a_missing_key(tmp_path):
    cfg = STACKS["unrolled"]()
    tck.save_checkpoint(tmp_path, 1, _port_params(cfg, 6), cfg)
    wider = cfg.reduced(d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="shape mismatch for blocks§0§mlp§w_up"):
        tck.restore_checkpoint(tmp_path, 1, _port_params(wider, 6), wider)
    deeper = cfg.reduced(n_layers=cfg.n_layers + 1)
    with pytest.raises(KeyError, match=f"blocks§{cfg.n_layers}§"):
        tck.restore_checkpoint(tmp_path, 1, _port_params(deeper, 6), deeper)


def test_latest_step(tmp_path):
    assert tck.latest_step(tmp_path) is None
    cfg = STACKS["unrolled"]()
    params = _port_params(cfg, 8)
    for step in (3, 120, 45):
        tck.save_checkpoint(tmp_path, step, params, cfg)
    (tmp_path / "step_notanumber.npz").write_bytes(b"")
    assert tck.latest_step(tmp_path) == 120 == jck.latest_step(tmp_path)


def test_to_numpy_inverts_from_numpy():
    cfg = STACKS["xlstm units"]()
    ref = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(9)))
    back = to_numpy(from_numpy(ref, cfg, device="cpu"), cfg)
    pairs = list(zip(_leaves(back), _leaves(ref), strict=True))
    assert pairs and all(np.array_equal(a, b) and a.dtype == b.dtype for (_, a), (_, b) in pairs)
