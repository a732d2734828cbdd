"""``reader`` (counterpart of ``paddle_tpu/reader``): the reader
decorators, composable generators feeding ``batch`` and ``io.DataLoader``.
Pure Python: the port keeps its own copy. ``buffered`` and
``xmap_readers`` run worker threads and raise a reader's or mapper's
error in the consumer; ``multiprocess_reader`` chains the readers, as in
the JAX package (worker processes are ``io.DataLoader``'s)."""
from __future__ import annotations

import itertools
import random

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    all_data = tuple(reader())

    def cached():
        yield from all_data

    return cached


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    def chained():
        yield from itertools.chain(*[r() for r in readers])

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """check_alignment=True (default) raises ComposeNotAligned when readers
    have different lengths (reference semantics); False truncates to the
    shortest silently."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
        else:
            _sentinel = object()
            for outputs in itertools.zip_longest(*rs, fillvalue=_sentinel):
                if any(o is _sentinel for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(o) for o in outputs), ())

    return composed


def buffered(reader, size):
    """Read ahead into a bounded queue on a background thread. Reader
    exceptions are re-raised in the consumer, never swallowed."""
    import queue
    import threading

    end = object()

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
                q.put(end)
            except BaseException as exc:  # noqa: BLE001 — relayed, not hidden
                q.put(exc)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                break
            if isinstance(e, BaseException):
                raise e
            yield e

    return buffered_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i >= n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (the reference uses
    threads here too — the heavy multiprocess path is io.DataLoader)."""
    import queue
    import threading

    end = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            try:
                for i, d in enumerate(reader()):
                    in_q.put((i, d))
                for _ in range(process_num):
                    in_q.put(end)
            except BaseException as exc:  # noqa: BLE001 — relayed below
                out_q.put(exc)

        results = {}

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is end:
                        out_q.put(end)
                        return
                    i, d = item
                    out_q.put((i, mapper(d)))
            except BaseException as exc:  # noqa: BLE001 — relayed below
                out_q.put(exc)

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        finished = 0
        next_i = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, BaseException):
                raise item
            if not order:
                yield item[1]
                continue
            results[item[0]] = item[1]
            while next_i in results:
                yield results.pop(next_i)
                next_i += 1
        if order:
            while next_i in results:
                yield results.pop(next_i)
                next_i += 1

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """The readers chained, one after another."""
    return chain(*readers)
