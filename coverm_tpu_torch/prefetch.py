"""Cancellable background prefetch over an iterator.

The streaming paths overlap host decode with device compute by running
the producer on a thread (the analogue of the reference's
mapper|sort|scan subprocess overlap, SURVEY.md §2.3).  A bare daemon
thread is unsafe here: the producer calls into native code (ctypes ->
libcovermio / zlib), and if the consumer raises (e.g. BamSortingError,
bam_generator.rs-style sortedness check) the interpreter may finalise
while the daemon thread is mid-native-call.  CPython then terminates
the thread via pthread_exit inside the GIL acquisition, whose forced
unwind rips through the C/C++ frames without handlers -> glibc aborts
with "FATAL: exception not rethrown".  ``prefetch_iter`` instead shuts
the producer down cooperatively: every queue operation carries a stop
event, and the consumer's ``finally`` sets it, drains, and joins.
"""

from __future__ import annotations

import queue
import threading

_POLL_S = 0.1


def prefetch_iter(source, maxsize: int = 1):
    """Yield items of ``source`` produced on a background thread.

    Exceptions raised by ``source`` are re-raised in the consumer.  On
    early exit (consumer break/raise), the producer is signalled and
    joined before control leaves the generator, so no thread is left
    inside native code at interpreter shutdown.
    """
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in source:
                if not _put((item, None)):
                    return
                if stop.is_set():
                    return
            _put((None, None))  # sentinel: normal end
        except BaseException as e:  # surface in the consumer
            _put((None, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item, err = q.get()
            if err is not None:
                raise err
            if item is None:
                return
            yield item
    finally:
        stop.set()
        # unblock a producer stuck in q.put, then wait for it to leave
        # any native frame before the interpreter can finalise
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=_POLL_S)
