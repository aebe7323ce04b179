"""A manually-released borrow whose releaser is reachable on only some
paths: the empty-read branch (and any exception) leaks the mapping."""

import mmap


def copy_header(fd, n):
    mm = mmap.mmap(fd, n)
    head = mm.read(64)
    if head:
        mm.close()
    return head
