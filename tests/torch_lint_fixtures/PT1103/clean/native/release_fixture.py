"""Clean twin: the release sits in a ``finally``, dominating every exit."""

import mmap


def copy_header(fd, n):
    mm = mmap.mmap(fd, n)
    try:
        return mm.read(64)
    finally:
        mm.close()
