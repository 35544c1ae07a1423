"""The port's checkpoint manager, case for case with the reference's
``tests/test_checkpoint.py`` (its elastic re-shard case waits for the LM
sharding), and the training CLI's checkpoints: resume, the CSV header, and
its refusals. Trees are nested dicts of tensors; bfloat16 and int8 leaves
round-trip bit for bit.
"""
import contextlib
import io
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.session import SessionError
from repro_torch.launch import train

CLI = ["--smoke", "--device", "cpu", "--seq-len", "32", "--global-batch", "4",
       "--log-every", "1", "--ckpt-every", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads; one thread
    keeps this file from oversubscribing the cores that the suite's
    parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(r.normal(size=(8, 4)).astype(np.float32)),
                   "b": torch.from_numpy(r.normal(size=(4,)).astype(np.float32))},
        "opt": {"m": {"w": torch.zeros(8, 4), "b": torch.zeros(4)},
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    t["params"]["h"] = torch.randn(3, 5).to(torch.bfloat16)
    t["opt"]["q"] = {"q": torch.tensor([-127, 0, 5, 127], dtype=torch.int8),
                     "scale": torch.tensor([0.5])}
    mgr.save(10, t)
    step, t2 = mgr.restore_latest(_zeros_like(t))
    assert step == 10
    for a, b in zip(_leaves(t), _leaves(t2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save_async(5, t)
    t["params"]["w"].add_(1.0)  # the host copy was taken before save_async returned
    mgr.wait()
    assert mgr.available_steps() == [5]
    assert torch.equal(mgr.restore(5, _zeros_like(t))["params"]["w"], _tree()["params"]["w"])


def test_keep_policy_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.available_steps() == [3, 4]
    assert (tmp_path / "LATEST").read_text() == "step_00000004"


def test_corruption_falls_back_to_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(seed=1))
    mgr.save(2, _tree(seed=2))
    (tmp_path / "step_00000002" / "shard_0.npz").write_bytes(b"garbage")
    step, t2 = mgr.restore_latest(_zeros_like(_tree()))
    assert step == 1  # silently skipped the damaged checkpoint
    assert torch.equal(t2["params"]["w"], _tree(seed=1)["params"]["w"])


def test_no_partial_checkpoint_visible(tmp_path):
    """A crash mid-write leaves only a .tmp dir, which restore ignores."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    fake = tmp_path / "step_00000099.tmp"
    fake.mkdir()
    (fake / "shard_0.npz").write_bytes(b"partial")
    assert mgr.available_steps() == [1]


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises((ValueError, KeyError)):
        mgr.restore(1, {"w": torch.zeros(5)})


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train.main(argv) == 0
    return out.getvalue()


def _saved(directory, step):
    """Every leaf of a checkpoint as stored (bfloat16 as its bits)."""
    with np.load(directory / f"step_{step:08d}" / "shard_0.npz") as z:
        return {k: z[k] for k in z.files}


def test_cli_prints_the_header_and_resumes(tmp_path):
    """A 6-step run saves at 3 and 6; a second call to 8 steps resumes at
    step 6 and runs steps 6 and 7."""
    first = _run(CLI + ["--steps", "6", "--ckpt-dir", str(tmp_path)])
    lines = first.splitlines()
    assert lines[0] == "step,loss,grad_norm,lr,step_time_s"
    assert [int(line.split(",")[0]) for line in lines[1:]] == list(range(6))
    assert CheckpointManager(str(tmp_path)).available_steps() == [3, 6]
    second = _run(CLI + ["--steps", "8", "--ckpt-dir", str(tmp_path)])
    assert second.splitlines()[0] == "# resumed from step 6"
    assert [int(line.split(",")[0]) for line in second.splitlines()[2:]] == [6, 7]


def _step_lines(text):
    """The CSV lines of the logged steps, each without its time field. A
    run may also print a `# straggler events: ...` line last (a logged
    step that took over twice the running mean, as the step after an
    asynchronous save can on a loaded host); that is no step line."""
    return [line.rsplit(",", 1)[0] for line in text.splitlines() if line[:1].isdigit()]


def test_cli_resume_is_bit_for_bit(tmp_path):
    """An uninterrupted 8-step run against the same run restarted from its
    step-6 checkpoint (the step-8 one removed, as after a crash): the
    restarted run's steps 6 and 7 print the same lines and its final
    checkpoint holds the same bits in every leaf."""
    run = tmp_path / "run"
    whole = _run(CLI + ["--steps", "8", "--ckpt-dir", str(run)])
    want = _saved(run, 8)
    shutil.rmtree(run / "step_00000008")
    again = _run(CLI + ["--steps", "8", "--ckpt-dir", str(run)])
    assert again.splitlines()[0] == "# resumed from step 6"
    steps = _step_lines(again)
    assert [int(line.split(",")[0]) for line in steps] == [6, 7]
    assert steps == _step_lines(whole)[-2:]
    got = _saved(run, 8)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_cli_refuses_shards_and_a_missing_gpu():
    with pytest.raises(ValueError, match="sharding"):
        train.main(["--smoke", "--device", "cpu", "--data-shards", "2"])
    with pytest.raises(ValueError, match="sharding"):
        train.main(["--smoke", "--device", "cpu", "--model-shards", "2"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(SessionError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
