"""Checkpoints: the port's format, its exchange with the reference, and
crash-and-resume through the train CLI, on the CPU.

The port writes the reference's format (one ``.npy`` a leaf named by its
path joined with ``__``, a ``meta.json``, an atomic rename), so float32
checkpoints cross between the packages in both directions.  A bfloat16
leaf is written as the reference writes it (2-byte raw, ``"bfloat16"`` in
``meta.json``); the port reads it back by that dtype.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.distributed import step as jstep
from repro.models import Model as JModel
from repro.models.config import smoke_variant as jsmoke
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.distributed import step as pstep
from repro_torch.launch import train
from repro_torch.models import Model, layers, smoke_variant
from repro_torch.models.convert import train_state_from_jax

jax.config.update("jax_platform_name", "cpu")


def _leaves(tree):
    return dict(layers.flatten_tree(tree, is_leaf=lambda x: not isinstance(
        x, dict)))


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn(3, 5, generator=gen),
            "b": {"w": torch.randn(4, 2, generator=gen).bfloat16(),
                  "s": torch.tensor(7, dtype=torch.int32)}}


def test_round_trip_keeps_values_and_dtypes(tmp_path):
    tree = _tree()
    path = ckpt.save(tree, str(tmp_path), 3)
    assert os.path.basename(path) == "step-00000003"
    assert sorted(os.listdir(path)) == ["a.npy", "b__s.npy", "b__w.npy",
                                        "meta.json"]
    got, step = ckpt.restore(tree, str(tmp_path), device="cpu")
    assert step == 3
    for name, x in _leaves(tree).items():
        y = _leaves(got)[name]
        assert y.dtype == x.dtype and torch.equal(y, x), name


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """The same bf16 values give the same file as the reference's save
    (2-byte raw), and ``meta.json`` names their dtype; the port restores
    the reference's file as bfloat16."""
    x = torch.randn(6, 3, generator=torch.Generator().manual_seed(1))
    ckpt.save({"w": x.bfloat16()}, str(tmp_path / "port"), 1)
    jckpt.save({"w": jnp.asarray(x.numpy(), jnp.bfloat16)},
               str(tmp_path / "ref"), 1)
    files = [tmp_path / d / "step-00000001" for d in ("port", "ref")]
    assert (files[0] / "w.npy").read_bytes() == \
        (files[1] / "w.npy").read_bytes()
    metas = [json.loads((f / "meta.json").read_text()) for f in files]
    assert metas[0] == metas[1]
    assert metas[0]["leaves"] == [{"name": "w", "shape": [6, 3],
                                   "dtype": "bfloat16"}]
    got, _ = ckpt.restore({"w": None}, str(tmp_path / "ref"), device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], x.bfloat16())


def test_retain_and_latest_step(tmp_path):
    for step in (1, 5, 9, 12):
        ckpt.save({"a": torch.zeros(1)}, str(tmp_path), step)
    assert ckpt.latest_step(str(tmp_path)) == 12
    ckpt.retain(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step-00000009",
                                            "step-00000012"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"a": None}, str(tmp_path / "none"), device="cpu")


def test_async_checkpointer_writes_a_snapshot(tmp_path):
    """The tree is copied when ``save`` returns: an in-place update right
    after (as the optimizer makes) does not reach the file."""
    tree = _tree()
    want = {k: v.clone() for k, v in _leaves(tree).items()}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(tree, 4)
    tree["a"].add_(1.0)
    tree["b"]["w"].zero_()
    saver.save(tree, 5)
    saver.save(tree, 6)
    saver.close()
    assert sorted(os.listdir(tmp_path)) == ["step-00000005",
                                            "step-00000006"]
    got, _ = ckpt.restore(tree, str(tmp_path), step=5, device="cpu")
    assert torch.equal(got["a"], want["a"] + 1.0)
    first = ckpt.save(want, str(tmp_path / "sync"), 4)
    assert os.path.isdir(first)


def _ref_state(arch, compress):
    jm = JModel(jsmoke(jget_config(arch)))
    cfg = jstep.TrainStepConfig(compress_grads=compress,
                                param_dtype="float32")
    return jm, cfg, jstep.init_train_state(jm, jax.random.PRNGKey(0), cfg)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "ef"])
def test_float32_checkpoints_cross_between_the_packages(tmp_path, compress):
    """A float32 train state saved by the reference restores into the port
    (through ``train_state_specs``), and one saved by the port restores
    into the reference (through its own), equal leaf for leaf."""
    arch = "rwkv6-1.6b"
    jm, jcfg, jstate = _ref_state(arch, compress)
    cfg = smoke_variant(get_config(arch))
    pcfg = pstep.TrainStepConfig(compress_grads=compress,
                                 param_dtype="float32")
    specs = pstep.train_state_specs(Model(cfg, device="cpu"), pcfg)
    jckpt.save(jstate, str(tmp_path / "ref"), 7)
    got, step = ckpt.restore(specs, str(tmp_path / "ref"), device="cpu")
    assert step == 7
    want = _leaves(jax.tree_util.tree_map(np.asarray, jstate))
    assert _leaves(got).keys() == want.keys()
    for name, t in _leaves(got).items():
        assert t.dtype == _leaves(specs)[name].dtype, name
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
    state = train_state_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                             jstate), "cpu")
    ckpt.save(state, str(tmp_path / "port"), 8)
    back, step = jckpt.restore(jstep.train_state_specs(jm, jcfg),
                               str(tmp_path / "port"))
    assert step == 8
    for name, x in _leaves(jax.tree_util.tree_map(np.asarray, back)).items():
        np.testing.assert_array_equal(x, want[name], err_msg=name)


def test_train_state_specs_allocate_nothing_and_match_init():
    cfg = smoke_variant(get_config("olmoe-1b-7b"))
    model = Model(cfg, device="cpu")
    step_cfg = pstep.TrainStepConfig(compress_grads=True)
    specs = _leaves(pstep.train_state_specs(model, step_cfg))
    state = _leaves(pstep.init_train_state(model, 0, step_cfg))
    assert specs.keys() == state.keys()
    for name, t in state.items():
        assert specs[name].device.type == "meta"
        assert (specs[name].shape, specs[name].dtype) == (t.shape, t.dtype)


def test_crash_and_resume_reproduce_the_uninterrupted_losses(tmp_path,
                                                             monkeypatch):
    """The train CLI with a checkpoint every 2 steps, crashed in step 3:
    the run leaves step 2's checkpoint (no final one); run again, it
    resumes there, and its losses equal an uninterrupted run's."""
    argv = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--steps", "5", "--batch", "2", "--seq", "16", "--ckpt-every",
            "2"]
    whole = train.main(argv)
    make = train.make_train_step

    def crashing(model, step_cfg):
        step = make(model, step_cfg)

        def run(state, batch):
            if int(state["step"]) == 3:
                raise RuntimeError("injected crash")
            return step(state, batch)
        return run
    monkeypatch.setattr(train, "make_train_step", crashing)
    run_dir = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="injected crash"):
        train.main(argv + ["--ckpt-dir", run_dir])
    assert ckpt.latest_step(run_dir) == 2
    monkeypatch.setattr(train, "make_train_step", make)
    resumed = train.main(argv + ["--ckpt-dir", run_dir])
    assert resumed == whole[2:]
    assert ckpt.latest_step(run_dir) == 5
