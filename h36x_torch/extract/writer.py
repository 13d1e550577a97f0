"""Background IO: a bounded-queue writer thread (counterpart of
h36x/extract/writer.py). Keeps shard serialization off the extraction hot
loop; a callable executor, so shard writes and progress writes drain in
submission order, and a worker failure re-raises at the next submit or
wait instead of dying silently."""

from __future__ import annotations

import queue
import threading
from typing import Callable

from h36x_torch.utils.profiling import span


class AsyncWriter:
    def __init__(self, max_queue: int = 100):
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._err = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.submitted = 0

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, args, kwargs = item
                if self._err is None:
                    try:
                        with span("h36x.store.write"):
                            fn(*args, **kwargs)
                    except BaseException as e:
                        self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        if self._err is not None:
            raise RuntimeError("async writer failed") from self._err
        self._q.put((fn, args, kwargs))
        self.submitted += 1

    def wait(self) -> None:
        """Block until every submitted task has finished; raise on failure."""
        self._q.join()
        if self._err is not None:
            raise RuntimeError(
                f"async writer failed ({self.submitted} tasks submitted)"
            ) from self._err

    def stop(self) -> None:
        # the sentinel and the join run even when wait() raises an earlier
        # task's failure, or the thread would stay blocked on get() forever
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
