"""The port's checkpoint store (``checkpoint/store.py``); mirrors
``test_checkpoint.py``, and holds its on-disk layout to the reference's:
a checkpoint written by either store reads back bit for bit in the other
(numpy trees here; the model's parameter and optimizer trees in
``test_torch_train.py``)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import CheckpointStore, resize_chunks


def tree():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.int32)}}


def test_save_restore_roundtrip(tmp_path):
    st = CheckpointStore(tmp_path)
    t = tree()
    st.save(3, {"params": t}, async_=False)
    out = st.restore(3, {"params": t})["params"]
    np.testing.assert_array_equal(out["a"], t["a"])
    np.testing.assert_array_equal(out["b"]["c"], t["b"]["c"])
    assert st.manifest(3) == {"step": 3, "flip": 1}


def test_async_save_then_wait(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save(1, {"params": tree()}, async_=True)
    st.wait()
    assert st.latest_step() == 1


def test_atomic_no_partial_checkpoints(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save(1, {"params": tree()}, async_=False)
    # a stale tmp dir (simulated crash) is never listed
    (tmp_path / ".tmp_step_00000002").mkdir()
    assert st.list_steps() == [1]


def test_gc_keeps_last_k(tmp_path):
    st = CheckpointStore(tmp_path, keep=2)
    for s in range(5):
        st.save(s, {"params": tree()}, async_=False)
    assert st.list_steps() == [3, 4]


def test_exactly_once_gate(tmp_path):
    """The flip-bit contract at cluster scale: a restarted step whose
    effects are already persisted is a retransmission -> skipped."""
    st = CheckpointStore(tmp_path)
    assert not st.already_applied(0)
    st.save(4, {"params": tree()}, async_=False)
    assert st.already_applied(4)
    assert st.already_applied(2)
    assert not st.already_applied(5)


def test_corrupt_flip_detected(tmp_path):
    st = CheckpointStore(tmp_path)
    st.save(4, {"params": tree()}, async_=False)
    man = tmp_path / "step_00000004" / "manifest.json"
    man.write_text(json.dumps({"step": 4, "flip": 1}))  # wrong parity
    assert not st.already_applied(4)


def test_elastic_resize_chunks():
    full = np.arange(32, dtype=np.float32)
    chunks8 = list(np.split(full, 8))
    chunks4 = resize_chunks(chunks8, 4)
    assert len(chunks4) == 4
    np.testing.assert_array_equal(np.concatenate(chunks4), full)
    chunks16 = resize_chunks(chunks4, 16)
    np.testing.assert_array_equal(np.concatenate(chunks16), full)
    with pytest.raises(ValueError):
        resize_chunks(chunks4, 5)


def test_tensor_trees_keep_dtype_and_layout(tmp_path):
    """Tensor trees with tuples and bf16 leaves: bf16 is stored as fp32
    (exact) under the reference's key paths, and restores as bf16."""
    t = {"groups": ({"s0": {"w": torch.randn(3, 4).bfloat16()}},),
         "norm": torch.randn(4)}
    st = CheckpointStore(tmp_path)
    st.save(2, {"params": t}, async_=False)
    with np.load(tmp_path / "step_00000002" / "params.npz") as z:
        assert sorted(z.files) == ["groups/0/s0/w", "norm"]
        assert z["groups/0/s0/w"].dtype == np.float32
    out = st.restore(2, {"params": t})["params"]
    assert isinstance(out["groups"], tuple)
    assert out["groups"][0]["s0"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["groups"][0]["s0"]["w"], t["groups"][0]["s0"]["w"])
    assert torch.equal(out["norm"], t["norm"])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    from repro.checkpoint.store import CheckpointStore as JStore
    t = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": ({"c": np.ones(4, np.int32)},)}
    (CheckpointStore if writer == "port" else JStore)(tmp_path).save(
        6, {"opt": t}, async_=False)
    reader = JStore if writer == "port" else CheckpointStore
    out = reader(tmp_path).restore(6, {"opt": t})["opt"]
    np.testing.assert_array_equal(out["a"], t["a"])
    np.testing.assert_array_equal(out["b"][0]["c"], t["b"][0]["c"])
    assert reader(tmp_path).already_applied(6)
