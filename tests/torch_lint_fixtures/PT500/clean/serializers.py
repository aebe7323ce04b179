import numpy as np


def copies(buf):
    return np.frombuffer(buf, np.uint8).copy()
