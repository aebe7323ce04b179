def fill(desc, buf):
    desc.out = buf.ctypes.data
    desc.chunk = buf.ctypes.data
    desc.chunk_len = buf.nbytes
