import pyarrow as pa


def chunk_to_view(mm, off, nbytes):
    if off + nbytes > mm.size:
        return None
    return pa.py_buffer(memoryview(mm)[off:off + nbytes])
