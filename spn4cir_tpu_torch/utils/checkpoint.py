"""Checkpoints of the PyTorch port: best-model saves and full training
state for resume.

Counterpart of `spn4cir_tpu/utils/checkpoint.py`. `save_model` /
`load_model` (parity target: `clip4cir/utils.py:53-67`, schema
`{epoch, state_dict}` -> `<output>/best.pt`): one `torch.save` of the state
dict (the port's parameter names are the reference's), the epoch and the
extra metadata.

`CheckpointManager` (the JAX package's orbax manager): the full training
state under a directory, one file per global step (`<step>.pt`), the
newest `max_to_keep` kept. A save copies the state to the host, then
writes it on a background thread, a temporary file first and then an
atomic `os.replace`, so a process killed at any point leaves every
`<step>.pt` whole; the next save, `wait()` or `restore()` waits for it and
raises its error, if any. `train_state` / `load_train_state` are what the
training CLI saves: the trainable parameters, the optimizer state, the
global step, and the state of the dropout generator (the JAX package
derives dropout keys statelessly by `fold_in(seed, step)`; the port draws
from a stateful `torch.Generator`, so a resumed run replays the same noise
only from its saved state).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional, Tuple

import torch
from torch import nn


def save_model(path: str, model: nn.Module, epoch: int = 0,
               extra: Optional[dict] = None) -> None:
    """Best-checkpoint save: {'epoch', 'state_dict', 'extra'} on the CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": epoch, "state_dict": state, "extra": extra or {}},
               path)


def load_model(path: str, model: nn.Module) -> Tuple[nn.Module, dict]:
    """Load a `save_model` file into `model` (in place, onto its device);
    returns (model, {'epoch': ..., **extra})."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(obj["state_dict"])
    return model, {"epoch": obj["epoch"], **obj["extra"]}


def _to_host(obj: Any) -> Any:
    """A copy of `obj` (nested dicts, lists and tuples of tensors and
    plain values) whose tensors are detached CPU copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    """Full training state, keyed by global step, for preemption resume."""

    _FILE = re.compile(r"^(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> list:
        """The steps of the committed checkpoints, ascending."""
        return sorted(int(m.group(1)) for m in
                      map(self._FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Copy `state` to the host now; write it as `<step>.pt` on a
        background thread."""
        self.wait()
        host = _to_host(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host),
            name=f"checkpoint-{step}", daemon=False)
        self._thread.start()

    def _write(self, step: int, host: Any) -> None:
        tmp = os.path.join(self.directory, f".{step}.pt.tmp")
        try:
            torch.save(host, tmp)
            os.replace(tmp, self._path(step))
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        except Exception as e:  # raised in the caller by wait()
            self._error = e

    def wait(self) -> None:
        """Wait for the save in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from error

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """(the state saved at `step`, default the latest, as CPU tensors;
        step), or (template, 0) when there is none."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return template, 0
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True), step


def train_state(backbone: nn.Module, state, generator:
                Optional[torch.Generator] = None) -> dict:
    """What a resume needs of a run: the trainable parameters, the
    optimizer state, the global step (`state.step`, optimizer steps taken)
    and the dropout generator's state (None without one)."""
    return {
        "params": {name: p for name, p in backbone.named_parameters()
                   if p.requires_grad},
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "dropout_rng": None if generator is None else generator.get_state(),
    }


def load_train_state(saved: dict, backbone: nn.Module, state) -> None:
    """Put a `train_state` back: the parameters into `backbone` in place
    (every trainable one must be there), the optimizer state and step into
    `state`. The dropout state is the caller's to set on its generator."""
    params = dict(backbone.named_parameters())
    trainable = {n for n, p in params.items() if p.requires_grad}
    differ = sorted(set(saved["params"]) ^ trainable)
    if differ:
        raise ValueError("the checkpoint's parameters are not this run's "
                         f"trainable ones: {differ[:4]}")
    with torch.no_grad():
        for name, value in saved["params"].items():
            params[name].copy_(value)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
