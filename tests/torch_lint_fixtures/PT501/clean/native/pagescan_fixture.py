import pyarrow as pa


def chunk_to_view(mm, off, nbytes, region_len):
    if nbytes > region_len:
        return None
    if off + nbytes > mm.size:
        return None
    return pa.py_buffer(memoryview(mm)[off:off + nbytes])
