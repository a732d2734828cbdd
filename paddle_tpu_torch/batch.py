"""``batch`` (counterpart of ``paddle_tpu/batch.py``): wrap a sample
reader into a batched reader."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer")

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
