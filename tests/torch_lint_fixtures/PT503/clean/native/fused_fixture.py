def fill(desc, buf):
    desc.out = buf.ctypes.data
    desc.out_cap = buf.nbytes
    desc.chunk = buf.ctypes.data
    desc.chunk_len = buf.nbytes
