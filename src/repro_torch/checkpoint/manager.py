"""Checkpoint manager: the twin of ``repro.checkpoint.manager`` — keep-K
retention, resume from the newest verified checkpoint, async snapshots
and the preemption flush.

``async_save`` snapshots the state to host memory (a CPU copy of every
tensor, taken before it returns, so the in-place train step can go on)
and writes it to disk on a worker thread.

The train step updates the state in place, so a flush in the middle of
one would save it half applied: a SIGTERM that arrives inside ``held()``
(the loops hold each step) is flushed when the block ends.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import signal
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import store
from repro_torch.obs.flight import flight


def _host_snapshot(tree: Any) -> Dict[str, Any]:
    """The flat {path: CPU copy} of `tree`, in the store's paths."""
    return {k: (v.detach().to("cpu", copy=True)
                if isinstance(v, torch.Tensor) else v)
            for k, v in store._flatten(tree).items()}


class CheckpointManager:
    def __init__(self, dirpath: str, keep: int = 3, injector: Any = None):
        self.dir = dirpath
        self.keep = keep
        # optional faults.FaultInjector: when a "ckpt.save"/"corrupt"
        # fault is due, the freshly written shard is byte-flipped so the
        # verified-restore path gets exercised end to end
        self.injector = injector
        self._thread: Optional[threading.Thread] = None
        self._get_state: Optional[Callable[[], Tuple[int, Any]]] = None
        self._held = 0
        self._pending = False

    def _maybe_corrupt(self, path: str) -> None:
        if self.injector is None:
            return
        for f in self.injector.poll("ckpt.save"):
            if f.kind == "corrupt":
                from repro_torch.faults.chaos import corrupt_checkpoint
                corrupt_checkpoint(path, seed=int(f.arg))

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        path = store.save(self.dir, step, tree, meta)
        self._maybe_corrupt(path)
        flight.record("ckpt.save", step=step, path=path, mode="sync")
        self._gc()
        return path

    def async_save(self, step: int, tree: Any,
                   meta: Optional[Dict] = None) -> None:
        """Snapshot to host now; write on a background thread."""
        self.wait()
        host_tree = _host_snapshot(tree)

        def work():
            path = store.save(self.dir, step, host_tree, meta)
            self._maybe_corrupt(path)
            flight.record("ckpt.save", step=step, path=path, mode="async")
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = store.list_steps(self.dir)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def latest_valid_step(self) -> Optional[int]:
        for s in reversed(store.list_steps(self.dir)):
            if store.verify(os.path.join(self.dir, f"step_{s:08d}")):
                return s
        return None

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any, Dict]]:
        """(step, tree, meta) from the newest checkpoint that restores
        with clean checksums (walking back past corrupt entries; the
        tensors of `like` are written in place), or None if there is
        nothing to restore."""
        try:
            got = store.restore_latest_verified(self.dir, like)
        except FileNotFoundError:
            flight.record("ckpt.restore", outcome="none")
            return None
        flight.record("ckpt.restore", outcome="ok", step=got[0])
        return got

    # -- preemption ---------------------------------------------------------

    def install_preemption_flush(self, get_state: Callable[[], Tuple[int, Any]]
                                 ) -> None:
        """On SIGTERM, synchronously flush a final checkpoint of
        `get_state()` (step, tree) and exit; inside ``held()`` the flush
        waits for the block's end."""
        def handler(signum, frame):
            if self._held:
                self._pending = True
            else:
                self._flush()
        self._get_state = get_state
        signal.signal(signal.SIGTERM, handler)

    def _flush(self) -> None:
        self.wait()
        step, tree = self._get_state()
        store.save(self.dir, step, tree, {"preempted": True})
        raise SystemExit(143)

    @contextlib.contextmanager
    def held(self):
        """Hold the preemption flush for the block (a train step); one
        requested meanwhile runs when it ends without an error."""
        self._held += 1
        try:
            yield
        finally:
            self._held -= 1
        if not self._held and self._pending:
            self._pending = False
            self._flush()
