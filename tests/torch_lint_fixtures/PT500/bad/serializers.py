import numpy as np


def returns_view(buf):
    return np.frombuffer(buf, np.uint8)
