"""Checkpoints written off the step path (port of the `"thread"` backend of
`torch_tts_tpu/train/async_checkpoint.py`).

A save is split into a snapshot and a write. The snapshot copies every
tensor of the state to the host on the calling thread before `save`
returns: the port's `AdamW` updates parameters and moments in place, so a
writer reading the live tensors would race the next step. One background
thread then writes the snapshot in the format of `train/checkpoint.py`
(`ckpt_<step>.pt`, `tmp` + `os.replace`, keep-last-N), so resume and
averaging read it unchanged. `wait()` joins every pending write and
re-raises a writer's error; the trainer calls it at the end of `train()`
and before raising on a window of non-finite steps.

The `"orbax"` backend (multi-host sharded saves) is not ported and
raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Optional

from torch_tts_tpu_torch.train import checkpoint as sync_ckpt

logger = logging.getLogger(__name__)


class AsyncCheckpointer:
    """Snapshot now, write in the background. `last_copy_s`,
    `last_write_s` and `last_bytes` describe the latest save (the write's
    once it has finished)."""

    def __init__(self, backend: str = "thread"):
        if backend == "orbax":
            raise NotImplementedError("the orbax checkpoint backend is not ported")
        if backend != "thread":
            raise ValueError(f"unknown async checkpoint backend: {backend}")
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.last_copy_s = self.last_write_s = 0.0
        self.last_bytes = 0

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, name="ckpt-writer", daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                model_dir, step, tree, keep = item
                t0 = time.perf_counter()
                path = sync_ckpt.checkpoint_path(model_dir, step)
                sync_ckpt._write(path, tree)
                self.last_write_s = time.perf_counter() - t0
                self.last_bytes = os.path.getsize(path)
                logger.info("Saved checkpoint (async): %s", path)
                sync_ckpt.remove_old_checkpoints(model_dir, keep=keep)
            except Exception as e:  # raised again by the next save() or wait()
                logger.exception("async checkpoint write failed")
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self, what: str):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(what) from err

    def save(self, model_dir: str, step: int, state, keep: int = 3) -> None:
        """Copy `state` to the host now; write it in the background."""
        self._raise_pending("previous async checkpoint failed")
        os.makedirs(model_dir, exist_ok=True)
        t0 = time.perf_counter()
        tree = sync_ckpt.state_tree(state, copy=True)
        self.last_copy_s = time.perf_counter() - t0
        self._ensure_worker()
        self._q.put((model_dir, step, tree, keep))

    def wait(self) -> None:
        """Block until every pending save is on disk."""
        self._q.join()
        self._raise_pending("async checkpoint failed")

    def close(self) -> None:
        self.wait()
        if self._worker is not None and self._worker.is_alive():
            self._q.put(None)
            self._worker.join(timeout=30)
            self._worker = None
