"""The port's checkpoints (``repro_torch.train.checkpoints``): the twins of
``tests/test_checkpoint.py``'s roundtrip, async-save-and-gc, corruption
and partial-save tests, checkpoints crossing between the two packages in
both directions (equal manifests, every leaf bit-equal), and where the
port departs from the JAX manager: a failed background save raises from
``wait``, a bfloat16 leaf raises, a restore onto a mesh raises."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.train.checkpoints import CheckpointManager as JaxManager
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch import configs as tcfg
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import tree_items
from repro_torch.sharding import PartitionSpec, Sharding
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.step import from_jax_state, init_train_state


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 6), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.tensor(3.5)},
            "e": [torch.ones((2, 2)), torch.zeros((3,))]}


def _leaves(tree):
    return [np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                       else v) for v in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(7, t, metadata={"note": "x"})
    step, out = mgr.restore(template=t)
    assert step == 7
    for a, b in zip(_leaves(t), _leaves(out)):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert mgr.metadata() == {"note": "x"}
    step, dev = mgr.restore(template=t, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in
               jax.tree.leaves(dev, is_leaf=lambda x: isinstance(
                   x, torch.Tensor)))
    for a, b in zip(_leaves(t), _leaves(dev)):
        np.testing.assert_array_equal(a, b)


def test_async_save_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s), block=False)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    step, out = mgr.restore(template=_tree())
    assert step == 4
    for a, b in zip(_leaves(_tree(4)), _leaves(out)):
        np.testing.assert_array_equal(a, b)


def test_save_copies_the_state_before_returning(tmp_path):
    """The step after a background save updates the state in place; the
    checkpoint holds the state as it was when ``save`` was called."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    want = [a.copy() for a in _leaves(t)]
    mgr.save(1, t, block=False)
    t["a"].add_(1.0)
    mgr.wait()
    _, out = mgr.restore(template=t)
    np.testing.assert_array_equal(_leaves(out)[0], want[0])


def test_corruption_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    path = mgr._path(1)
    victim = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(path, victim))
    np.save(os.path.join(path, victim), arr + 1)
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(template=_tree())


def test_partial_save_never_commits(tmp_path):
    """A crash mid-save (simulated: stray .tmp dir) must be invisible."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    os.makedirs(mgr._path(2, tmp=True))      # simulated dead tmp
    assert mgr.latest_step() == 1
    mgr.save(2, _tree(2))                    # overwrites the stray tmp
    assert mgr.latest_step() == 2


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failed_background_save_raises_from_wait(tmp_path):
    """The JAX manager never records a writer error (ROADMAP queue C): its
    ``wait`` returns after a failed background save.  The port's raises
    it once, and the failed step is not committed.  (The reference's
    writer thread dies with the error unhandled: the warning that pytest
    raises for it is expected here.)"""
    bad_meta = {"not json": object()}
    jmgr = JaxManager(str(tmp_path / "jax"))
    jmgr.save(1, {"a": np.zeros(3, np.float32)}, metadata=bad_meta,
              block=False)
    jmgr.wait()                              # silent in the reference
    assert jmgr.latest_step() is None
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, _tree(), metadata=bad_meta, block=False)
    with pytest.raises(TypeError, match="JSON serializable"):
        mgr.wait()
    mgr.wait()                               # raised once
    assert mgr.latest_step() is None
    mgr.save(2, _tree(), block=False)
    mgr.wait()
    assert mgr.latest_step() == 2


def test_refusals(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert mgr.latest_step() is None
    mgr.save(1, _tree())
    # onto a mesh of one rank every leaf is its own block
    one = Sharding(make_local_mesh(device="cpu"), PartitionSpec())
    step, got = mgr.restore(shardings=jax.tree.map(
        lambda _: one, _tree(),
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert step == 1
    for g, w in zip(_leaves(got), _leaves(_tree())):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def _manifest(mgr, step):
    with open(os.path.join(mgr._path(step), "MANIFEST.json")) as f:
        return json.load(f)


def _files(mgr, step):
    path = mgr._path(step)
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def test_train_state_checkpoints_cross_both_packages(tmp_path):
    """A JAX train state and the port's copy of it write the same
    manifest and the same bytes; each package restores the other's
    checkpoint into its own state leaf for leaf."""
    arch = "granite-moe-3b-a800m"
    jstate = jax.device_get(jax_init_train_state(
        jcfg.get_smoke_config(arch), jax.random.PRNGKey(2)))
    tstate = from_jax_state(jstate, device="cpu")
    jmgr = JaxManager(str(tmp_path / "jax"))
    tmgr = CheckpointManager(str(tmp_path / "port"))
    meta = {"arch": arch, "seq": 16}
    jmgr.save(5, jstate, metadata=meta)
    tmgr.save(5, tstate, metadata=meta)
    assert _manifest(jmgr, 5) == _manifest(tmgr, 5)
    assert _files(jmgr, 5) == _files(tmgr, 5)
    leaves = _manifest(tmgr, 5)["leaves"]
    assert leaves["opt/step"]["dtype"] == "int32"
    assert leaves["data_step"]["dtype"] == "int32"

    # the JAX checkpoint into the port's state, and back
    port_template = init_train_state(tcfg.get_smoke_config(arch),
                                     torch.Generator().manual_seed(9),
                                     device="cpu")
    step, host = CheckpointManager(str(tmp_path / "jax")).restore(
        template=port_template)
    assert step == 5
    restored = from_jax_state(host, device="cpu")
    for (pa, a), (pb, b) in zip(tree_items(restored), tree_items(tstate)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa
    step, back = JaxManager(str(tmp_path / "port")).restore(
        template=jstate)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert JaxManager(str(tmp_path / "port")).metadata() == meta
