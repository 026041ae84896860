"""Host-side pipelining (``psld_tpu/utils/pipeline.py::prefetch_iter``)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


class _Done:
    pass


_DONE = _Done()


def prefetch_iter(items: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``items`` on a background thread, staying up to ``depth``
    elements ahead of the consumer.

    The training loops' use: the loader's decode, augment and stack for
    the next batches run while the device works on the current step.
    One producer thread walks the iterator in order, so the batches and
    the loader's random draws are those of the plain loop. An exception
    of the producer is raised at the consumer's ``next()``; closing the
    returned generator (or dropping it) stops the producer.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for x in items:
                if not _put((None, x)):
                    return
        except BaseException as e:  # raised at the consumer
            _put((e, None))
            return
        _put((None, _DONE))

    t = threading.Thread(target=producer, name="psld-prefetch", daemon=True)

    def gen():
        t.start()
        try:
            while True:
                err, x = q.get()
                if err is not None:
                    raise err
                if x is _DONE:
                    return
                yield x
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    return gen()
