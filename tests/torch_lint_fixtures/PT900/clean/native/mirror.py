import ctypes


class DemoColStruct(ctypes.Structure):
    """Field-for-field mirror of ``struct DemoCol`` (kernel.cpp)."""

    _fields_ = [
        ('chunk', ctypes.c_void_p),
        ('chunk_len', ctypes.c_uint64),
        ('out', ctypes.c_void_p),
        ('out_cap', ctypes.c_uint64),
        ('mode', ctypes.c_int32),
        ('status', ctypes.c_int32),
    ]


def register(lib):
    lib.demo_read.restype = ctypes.c_longlong
    lib.demo_read.argtypes = [ctypes.POINTER(DemoColStruct), ctypes.c_int]
    lib.demo_write.restype = ctypes.c_int
    lib.demo_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_uint64]
