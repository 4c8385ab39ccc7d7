"""Checkpoint and resume for long-running optimizations.

Counterpart of ``diffdrr_tpu/checkpoint.py`` (an orbax facade there): step-
indexed checkpoints of a state of tensors, numbers and optimizer
``state_dict``s, written with ``torch.save`` and read with ``torch.load``.

  * Writes are atomic: each checkpoint goes to a temporary file in its
    directory and is renamed into place (``os.replace``), so a reader or a
    resumed run never sees half a checkpoint.
  * ``CheckpointManager`` keeps the newest ``max_to_keep`` checkpoints and
    deletes older ones after each save.
  * Saves are synchronous; ``wait`` and ``close`` exist for the JAX
    package's interface and have nothing to wait for.
  * A restore maps every tensor to the device and dtype of the matching
    tensor in ``like``; optimizer state is restored by the optimizer's own
    ``load_state_dict``, which moves it to its parameters' device.

orbax restores a sharded array onto a device mesh; with one process per
device the ranks of a mesh hold replicated state, so one rank restores and
broadcasts it (the reconstruction CLI's ``--mesh`` does so from rank 0).
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]


def _to_cpu(state: Any) -> Any:
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_cpu(v) for v in state)
    return state


def _like(state: Any, like: Any) -> Any:
    """``state`` with each tensor moved to the device and dtype of ``like``'s."""
    if isinstance(like, torch.Tensor) and isinstance(state, torch.Tensor):
        return state.to(device=like.device, dtype=like.dtype)
    if isinstance(like, dict) and isinstance(state, dict):
        return {k: _like(v, like[k]) if k in like else v for k, v in state.items()}
    if isinstance(like, (list, tuple)) and isinstance(state, (list, tuple)):
        return type(state)(_like(v, w) for v, w in zip(state, like))
    return state


def save_pytree(path: str, state: Any) -> None:
    """One-shot atomic save of ``state`` (tensors moved to the CPU) to ``path``."""
    path = os.path.abspath(os.fspath(path))
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".pt", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Load a state saved by :func:`save_pytree`, matched to ``like`` if given."""
    state = torch.load(os.fspath(path), map_location="cpu", weights_only=True)
    return state if like is None else _like(state, like)


class CheckpointManager:
    """Step-indexed checkpoints with retention, for resumable optimizations.

    >>> mgr = CheckpointManager(workdir, max_to_keep=3)
    >>> start, state = mgr.latest(like=state) or (0, state)   # resume
    >>> for step in range(start, n_steps):
    ...     state = update(state)
    ...     mgr.maybe_save(step + 1, state, every=50)
    >>> mgr.close()
    """

    _NAME = re.compile(r"^step_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, not {max_to_keep}")
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first."""
        steps = (self._NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, state: Any) -> None:
        save_pytree(self._path(step), state)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def maybe_save(self, step: int, state: Any, every: int) -> bool:
        """Save iff ``step`` is a multiple of ``every`` (and every > 0)."""
        if every > 0 and step % every == 0:
            self.save(step, state)
            return True
        return False

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Optional[Any] = None) -> Any:
        return load_pytree(self._path(step), like)

    def latest(self, like: Optional[Any] = None) -> Optional[Tuple[int, Any]]:
        """(step, state) of the newest checkpoint, or None if none exist."""
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
