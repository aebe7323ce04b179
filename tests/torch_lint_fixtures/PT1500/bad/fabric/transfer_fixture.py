"""Bad fixture: fabric socket ops with no timeout arming or deadline budget."""

import socket


def fetch_from_peer(endpoint, request):
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    # PT1500: connect with no settimeout and no deadline — a dead peer
    # blocks this thread until the kernel gives up
    sock.connect(endpoint)
    # PT1500: unbounded sends/recvs with no end-to-end budget either
    sock.sendall(request)
    return sock.recv(65536)


def accept_loop(listener, handle):
    while True:
        # PT1500: an un-armed accept cannot notice a stop request
        conn, _addr = listener.accept()
        handle(conn)


def drain(sock, n):
    parts = []
    while n > 0:
        # PT1500: timeout armed nowhere; slow-but-not-stalled peers stack
        part = sock.recv(min(4096, n))
        if not part:
            break
        parts.append(part)
        n -= len(part)
    return b''.join(parts)
