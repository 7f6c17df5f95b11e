"""Training-state checkpoints and `--resume` of the port (utils/checkpoint.py,
cli/train.py) on the CPU.

`CheckpointManager` round-trips the trainable parameters, the AdamW state,
the global step and a generator's state, keeps the newest `max_to_keep`
files, and raises a failed background save in `wait()`. The training CLI
refuses a resume directory without its `format.json` marker and
`--ckpt_every_steps` without `--resume`. A run stopped right after a
mid-epoch step checkpoint and started again in-process ends with
parameters and optimizer state bit for bit those of an uninterrupted run:
clip stage 2 at `test-tiny`, and blip with MED dropout (stage 2 and stage
1), whose noise the saved generator state replays. The same through
`python -m spn4cir_tpu_torch.cli.train` killed by SIGKILL is marked slow,
as the JAX package's tests/test_resume_kill.py is.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from spn4cir_tpu_torch.cli.train import resume_manager, train_main
from spn4cir_tpu_torch.train.stage2 import TrainState
from spn4cir_tpu_torch.utils import checkpoint as ck
from tests.fixtures import make_cirr
from tests.torch_fixtures import synthetic_tokenizer, write_merges_file

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")
ARGV = ["--dataset", "cirr", "--clip-model-name", "test-tiny", "--device",
        "cpu", "--batch-size", "4", "--num-epochs", "2", "--learning-rate",
        "1e-3", "--seed", "0", "--validation-frequency", "99", "--resume",
        "--ckpt_every_steps", "2"]
STEPS_PER_EPOCH = 3                     # 13 triplets / batch 4, drop_last


class _Stop(Exception):
    """Stands in for a kill right after a checkpoint is committed."""


@pytest.fixture(scope="module")
def tok():
    return synthetic_tokenizer()


@pytest.fixture(scope="module")
def cirr_root(tmp_path_factory):
    return make_cirr(str(tmp_path_factory.mktemp("resume") / "cirr_dataset"),
                     n_images=16, n_train=13, extended=False)


def _linear_run(seed):
    model = torch.nn.Linear(4, 3)
    model.weight.requires_grad_(False)      # a frozen parameter
    opt = torch.optim.AdamW([model.bias], lr=1e-2)
    state = TrainState(optimizer=opt, learning_rate=1e-2)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(2):
        opt.zero_grad()
        model(torch.randn(5, 4, generator=gen)).square().sum().backward()
        opt.step()
        state.step += 1
    return model, state, gen


def test_manager_round_trips_model_optimizer_step_and_generator(tmp_path):
    model, state, gen = _linear_run(0)
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, ck.train_state(model, state, gen))
    bias = model.bias.detach().clone()
    model.bias.data.add_(1.0)               # the saved copy is a snapshot
    mgr.wait()
    other, ostate, ogen = _linear_run(1)
    saved, step = mgr.restore(None)
    assert step == 7 and set(saved["params"]) == {"bias"}
    ck.load_train_state(saved, other, ostate)
    ogen.set_state(saved["dropout_rng"])
    assert torch.equal(other.bias, bias)
    assert ostate.step == 2
    for a, b in zip(ostate.optimizer.state_dict()["state"].values(),
                    state.optimizer.state_dict()["state"].values()):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    assert torch.equal(torch.rand(4, generator=ogen),
                       torch.rand(4, generator=gen))
    # a checkpoint of other parameters is refused
    model.weight.requires_grad_(True)
    with pytest.raises(ValueError, match="trainable"):
        ck.load_train_state(saved, model, state)


def test_max_to_keep_latest_step_and_empty_restore(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore("template") == ("template", 0)
    for step in (3, 1, 6, 4):
        mgr.save(step, {"step": step, "x": torch.full((2,), float(step))})
    mgr.wait()
    assert mgr.steps() == [4, 6] and mgr.latest_step() == 6
    assert sorted(os.listdir(mgr.directory)) == ["4.pt", "6.pt"]
    saved, step = mgr.restore(None, step=4)
    assert step == 4 and torch.equal(saved["x"], torch.full((2,), 4.0))


def test_a_failed_save_raises_in_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, {"fn": lambda: None})     # cannot be pickled
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()                              # the error is raised once


def test_resume_dir_without_marker_is_refused(tmp_path):
    out = str(tmp_path / "run")
    mgr = resume_manager(out, 3)
    marker = os.path.join(out, "resume", "format.json")
    with open(marker) as f:
        assert json.load(f) == {"keys": "global_step", "steps_per_epoch": 3}
    mgr.save(2, {"step": 2})
    mgr.wait()
    resume_manager(out, 3)                  # marked: accepted
    os.remove(marker)
    with pytest.raises(SystemExit, match="format.json"):
        resume_manager(out, 3)


def test_ckpt_every_steps_goes_with_resume(tok, cirr_root, tmp_path):
    argv = [a for a in ARGV if a != "--resume"] + [
        "--data_path", cirr_root, "--output_path", str(tmp_path / "run")]
    with pytest.raises(SystemExit, match="--resume"):
        train_main("clip", argv, tokenizer=tok)


def _stopped_at(monkeypatch, stop_at):
    """Make the manager's save raise `_Stop` once `<stop_at>.pt` is
    committed."""
    real = ck.CheckpointManager.save

    def save(self, step, state):
        real(self, step, state)
        if step == stop_at:
            self.wait()
            raise _Stop
    monkeypatch.setattr(ck.CheckpointManager, "save", save)


def _final(out, step):
    saved, at = ck.CheckpointManager(os.path.join(out, "resume")).restore(
        None)
    assert at == step, at
    return saved


def _assert_states_equal(a, b):
    assert a["step"] == b["step"]
    assert a["params"].keys() == b["params"].keys()
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    for i, sa in a["optimizer"]["state"].items():
        for key, value in sa.items():
            assert torch.equal(value, b["optimizer"]["state"][i][key]), (
                i, key)


@pytest.mark.parametrize("name,extra", [
    ("clip", []),
    ("blip", ["--dropout", "0.1"]),
    ("blip", ["--dropout", "0.1", "--wo_bank"]),
])
def test_stopped_and_resumed_run_equals_an_uninterrupted_one(
        name, extra, tok, cirr_root, tmp_path, monkeypatch, capsys):
    """Stopped right after the step-2 checkpoint (epoch 0, step 2 of 3),
    then run again: it resumes there and ends where an uninterrupted run
    ends, bit for bit. The uninterrupted run also writes a profiler
    trace."""
    kw = {"tokenizer": tok} if name == "clip" else {}
    base = ARGV + extra + ["--data_path", cirr_root]
    whole = str(tmp_path / "whole")
    prof = str(tmp_path / "prof")
    train_main(name, base + ["--output_path", whole, "--profile_dir", prof],
               log_every=0, **kw)
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(prof))

    part = str(tmp_path / "part")
    with monkeypatch.context() as m:
        _stopped_at(m, 2)
        with pytest.raises(_Stop):
            train_main(name, base + ["--output_path", part], log_every=0,
                       **kw)
    assert ck.CheckpointManager(os.path.join(part, "resume")).steps() == [2]
    capsys.readouterr()
    train_main(name, base + ["--output_path", part], log_every=0, **kw)
    assert "resumed from epoch 0 step 2" in capsys.readouterr().out
    last = 2 * STEPS_PER_EPOCH
    a, b = _final(whole, last), _final(part, last)
    assert a["step"] == last
    _assert_states_equal(a, b)
    if "--dropout" in extra:
        assert b["dropout_rng"] is not None


@pytest.mark.slow
def test_sigkill_mid_epoch_resumes_to_identical_state(cirr_root, tmp_path):
    """`python -m spn4cir_tpu_torch.cli.train` killed by SIGKILL once its
    step-2 checkpoint lands, then started again with the same flags: its
    last checkpoint equals an uninterrupted run's."""
    env = dict(os.environ, SPN4CIR_BPE_VOCAB=write_merges_file(
        str(tmp_path / "merges.txt.gz")))
    # validation every epoch keeps the killed run busy past its first save
    argv = [a if a != "99" else "1" for a in ARGV] + [
        "--data_path", cirr_root, "--num-epochs", "3"]

    def start(out):
        return subprocess.Popen(
            [sys.executable, "-m", "spn4cir_tpu_torch.cli.train", "clip",
             *argv, "--output_path", out], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish(proc):
        text, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, text[-3000:]
        return text

    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    finish(start(whole))
    proc = start(part)
    first = os.path.join(part, "resume", "2.pt")
    deadline = time.time() + 600
    try:
        while not os.path.exists(first):
            assert proc.poll() is None, proc.stdout.read()[-2000:]
            assert time.time() < deadline, "no step-2 checkpoint"
            time.sleep(0.01)
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait()
    assert proc.returncode == -signal.SIGKILL
    assert "resumed from epoch 0 step 2" in finish(start(part))
    last = 3 * STEPS_PER_EPOCH
    _assert_states_equal(_final(whole, last), _final(part, last))
